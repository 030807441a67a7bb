"""Run one cell of the benchmark once and print its result line.

    python3 shark_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It needs `torch.cuda.device_count()` cards
of the cell's `chips`, and exits with 1, printing no result, without them.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, and with `--trace 1` a
`breakdown`; `checks`, last, holds each number the comparison with the
reference compared, beside its limit, which standard error's last lines
repeat.  The kernels the program builds go to `shark_bench/_cache/` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "_cache"
# top-level module names the run must not have loaded: the JAX package
# (`repro`; the port `repro_torch` is another name) and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["REPRO_TORCH_KERNEL_DIR"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from shark_bench import bench

    cell = bench.load_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"shark_bench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda:0", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"shark_bench: the run loaded {bad}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak"]}
    if args.trace:
        device.update(busy_s=out.get("busy_s", 0.0),
                      window_s=out.get("window_s", 0.0))
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
