"""Phases of `chip_smoke.py` alone, run from the checkout given, to
compare two commits of the port on one card in turns.

    python3 scripts/phase_ab.py ROOT [--phase train] [--rows N]

ROOT is a checkout (or `git archive`) holding `chip_smoke.py` and
`src/repro_torch`; its kernels build into its own build directory.
`--phase` takes a comma-separated list of `chip_smoke.phase_<name>`
functions, run in that order: `train` (phase 3: a logistic and a k-means
fit over `--rows` `points` rows, the default), `sql` (phase 2, over
`--rows` `lineitem` rows; the script's own run takes 6,000,000), or one
of those that take no rows, such as `kernels_lm`, `dense` (phase 9) or
`dryrun` (phase 14).
Run each checkout in its own process, alternating (A, B, B, A), and
compare their lines within one call.  Needs a CUDA device and `nvcc`.
"""

from __future__ import annotations

import argparse
import inspect
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--phase", default="train")
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("phase_ab needs a CUDA device")
    print(chip_smoke.card_line(), flush=True)
    print(f"root {root}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
    device = torch.device("cuda")
    for name in args.phase.split(","):
        phase = getattr(chip_smoke, f"phase_{name}")
        if "rows" in inspect.signature(phase).parameters:
            phase(torch, device, args.rows, args.seed)
        else:
            phase(torch, device, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
