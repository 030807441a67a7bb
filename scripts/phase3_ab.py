"""Phase 3 of `chip_smoke.py` alone (a logistic and a k-means fit over 10M
`points` rows), run from the checkout given, to compare two commits of
the port on one card in turns.

    python3 scripts/phase3_ab.py ROOT [--rows N]

ROOT is a checkout (or `git archive`) holding `chip_smoke.py` and
`src/repro_torch`; its kernels build into its own build directory.  Run
each checkout in its own process, alternating (A, B, B, A), and compare
the `phase 3: logistic` lines' medians within one call.  Needs a CUDA
device and `nvcc`.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("phase3_ab needs a CUDA device")
    print(chip_smoke.card_line(), flush=True)
    print(f"root {root}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
    chip_smoke.phase_train(torch, torch.device("cuda"), args.rows, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
