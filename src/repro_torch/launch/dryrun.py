"""The dry run: every (architecture x input-shape) cell counted on the
meta device, with no byte allocated and nothing launched.  The
counterpart of the reference's `launch/dryrun.py`, which lowers and
compiles each cell over a TPU pod mesh.

Each cell's program is the port's own: the model, AdamW state, batch and
caches stand in on the meta device (`launch/specs.py`), and the cell's
function runs on them under a cost counter (`launch/cost.py`), which
counts what it dispatches: FLOPs by dtype, HBM bytes, collective bytes,
the two LM kernels' calls by their formulas, and the memory the card
would hold.  The record has the reference's keys; `mesh` is "h100",
`chips` 1, and `fits` says whether `peak_bytes` fits the card's memory,
`cost.H100.hbm_bytes` (the bytes torch reports as an H100 80GB HBM3's
total memory; the CUDA context's own memory and the caching allocator's
slack are not counted).
`lower_s` is the time to build the cell's stand-ins and `compile_s` the
time of the counted run.  The reference's pod meshes (`--multi-pod`)
and the perf knobs that shard the sequence over them (`seq_shard`,
`seq_res`) have no counterpart: the port places every tensor whole
where it computes it (ROADMAP A.7).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    python -m repro_torch.launch.dryrun --arch phi3.5-moe-42b-a6.6b \\
        --shape train_4k --perf moe_ep
    python -m repro_torch.launch.dryrun --all [--jobs 4]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Tuple

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
MESH_NAME = "h100"
# expert parallelism's layout on one card: four slots along `model`, the
# layout `chip_smoke.py` runs on the card (phase 13)
EP_MESH = (1, 4)
NO_POD = ("the port has no pod mesh: it places every tensor whole where "
          "it computes it, on one card (ROADMAP A.7: parallel/sharding.py "
          "and the pod meshes are left out)")

PERF_OVERRIDES = {
    "scores_bf16": {"attn_scores_dtype": "bf16"},
    "moe_ep": {"moe_impl": "ep_shardmap"},
    "kv_int8": {"kv_cache_quant": True},
    "flash": {"attn_impl": "flash"},
    "attn_remat": {"attn_chunk_remat": True},
}
# the reference's knobs that shard the sequence over a pod mesh
POD_ONLY = ("seq_shard", "seq_res")


def cell_list() -> List[Tuple[str, str]]:
    """Every architecture x `SHAPES`, `long_500k` only where the config
    is sub-quadratic: 32 cells."""
    from ..configs import ARCH_NAMES, SHAPES, get_config
    cells = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((arch, shape.name))
    return cells


def perf_config(cfg, perf: str):
    """cfg with the comma-separated perf knobs of `perf` applied."""
    over = {}
    for k in filter(None, (p.strip() for p in perf.split(","))):
        if k in POD_ONLY:
            raise ValueError(f"perf knob {k!r} shards the sequence over a "
                             f"pod mesh; {NO_POD}")
        if k not in PERF_OVERRIDES:
            raise ValueError(f"unknown perf knob {k!r}; known: "
                             f"{sorted(PERF_OVERRIDES)}")
        over.update(PERF_OVERRIDES[k])
    return dataclasses.replace(cfg, **over)


def dry_run(cfg, shape, microbatches: int = 1,
            max_seq: Optional[int] = None, device="meta") -> dict:
    """One cell of `cfg` at `shape` (a `ShapeConfig`), counted on
    `device`: the record's `roofline`, `memory`, `program` and
    `cost_analysis_raw`, plus `lower_s` and `compile_s`.  A config with
    `moe_impl="ep_shardmap"` runs over `EP_MESH`'s slots."""
    from ..parallel import set_mesh
    from .cost import analyze
    from .mesh import make_debug_mesh
    from .specs import build_cell

    t0 = time.perf_counter()
    fn, args = build_cell(cfg, shape, microbatches=microbatches,
                          device=device, max_seq=max_seq)
    t_build = time.perf_counter() - t0
    ep = cfg.family == "moe" and cfg.moe_impl == "ep_shardmap"
    mesh = (set_mesh(make_debug_mesh(*EP_MESH, device=device)) if ep
            else contextlib.nullcontext())
    with mesh:
        _, record = analyze(fn, *args)
    return {"lower_s": t_build,
            "compile_s": time.perf_counter() - t0 - t_build, **record}


def cell_record(arch: str, shape_name: str, microbatches: int = 1,
                variant: str = "baseline", perf: str = "") -> dict:
    """The record of one cell, the reference's keys plus `fits`."""
    from ..configs import SHAPES, get_config
    from .cost import H100

    cfg = perf_config(get_config(arch), perf)
    analysis = dry_run(cfg, SHAPES[shape_name], microbatches)
    return {"arch": arch, "shape": shape_name, "mesh": MESH_NAME,
            "variant": variant, "chips": 1, "microbatches": microbatches,
            "device": "meta", **analysis,
            "fits": analysis["memory"]["peak_bytes"] <= H100.hbm_bytes}


def run_cell(arch: str, shape_name: str, out_dir: Optional[str] = RESULTS_DIR,
             microbatches: int = 1, variant: str = "baseline",
             perf: str = "") -> dict:
    """Dry-run one cell, print its summary and write its record to
    `{out_dir}/{arch}__{shape}__h100__{variant}.json` (none with
    `out_dir=None`); returns the record."""
    record = cell_record(arch, shape_name, microbatches, variant, perf)
    rl, mem = record["roofline"], record["memory"]
    print(f"[{arch} x {shape_name} x {MESH_NAME}] build="
          f"{record['lower_s']:.1f}s count={record['compile_s']:.1f}s")
    print("  memory:", json.dumps(mem), "fits:", record["fits"])
    print("  cost: flops=%.3e bytes=%.3e wire=%.3e" % (
        rl["flops"], rl["hbm_bytes"], rl["wire_bytes"]))
    print("  kernel calls:", json.dumps(record["program"]["kernel_calls"]))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{MESH_NAME}__{variant}.json"
        with open(os.path.join(out_dir, fname.replace("/", "_")), "w") as f:
            json.dump(record, f, indent=1)
    return record


def _cell_job(arch: str, shape: str, out_dir: str, perf: str,
              variant: str) -> Optional[str]:
    """A worker's cell: None, or the traceback of its failure."""
    try:
        run_cell(arch, shape, out_dir, variant=variant, perf=perf)
    except Exception:
        return traceback.format_exc()
    return None


def orchestrate(jobs: int, out_dir: str, perf: str = "",
                variant: str = "baseline") -> int:
    """Dry-run every cell of `cell_list()` on `jobs` worker processes,
    each written anew: a record already in out_dir is counted again."""
    work = cell_list()
    print(f"{len(work)} cells to run", flush=True)
    ctx = multiprocessing.get_context("spawn")
    failures = []
    with ProcessPoolExecutor(max(1, jobs), mp_context=ctx) as pool:
        futures = [(cell, pool.submit(_cell_job, *cell, out_dir, perf,
                                      variant)) for cell in work]
        for cell, fut in futures:
            err = fut.result()
            print(f"--- {cell} {'OK' if err is None else 'FAIL'} ---",
                  flush=True)
            if err is not None:
                print(err, flush=True)
                failures.append(cell)
    if failures:
        print("FAILED CELLS:", failures)
        return 1
    print("ALL CELLS PASSED")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count a cell's program on the meta device: no byte "
                    "is allocated and no kernel launched, so no card is "
                    "needed.")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: " + NO_POD)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--perf", default="",
                    help="comma-separated perf knobs: "
                         + ", ".join(PERF_OVERRIDES))
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error(f"--multi-pod: {NO_POD}")
    variant = args.variant
    if args.perf and variant == "baseline":
        variant = args.perf.replace(",", "+")
    if args.all:
        sys.exit(orchestrate(args.jobs, args.out, args.perf, variant))
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    try:
        run_cell(args.arch, args.shape, args.out, args.microbatches,
                 variant, args.perf)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
