"""The controls of the comparison that decides `correct`: the numbers a
cell compares, read with the reference put in the program's place in a
lower precision (float8, `reference/fp8.py`), and, where the kind has them,
with a planted fault (a training cell: half of each batch left out, the
loss the mean over the rest).  Each kind's `controls` (`kinds/<kind>.py`)
computes them through the same comparison a run makes.  Each must read
above the cell's limits; PERF.md gives the readings the limits were set
from.  The benchmark's runs never run this.

    python3 shark_bench/control.py --workload <cell> --seeds 11,12,13

prints one JSON line a seed.  It needs a card, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=30,
                    help="a serving kind: the batches a run serves, whose "
                         "sampled requests the control reads")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from shark_bench import bench
    cell = bench.load_cell(ROOT, args.workload)
    kind = bench.kind_of(cell)
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = kind.controls(cell, seed, device, batches=args.batches)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "controls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
