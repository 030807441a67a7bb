#!/usr/bin/env python3
"""How far the gradients through kernels 11 and 12 stray from the plain
routes, over seeds, and how far they stray when the forward is wrong.

    python3 scripts/grad_bounds.py [--seeds 12-19] [--device cpu]

For Qwen2.5-3B at full width cut to `chip_smoke.GRAD_LAYERS` layers, in
float32 (`chip_smoke.grad_gaps`, the measurement behind phase 12c's
bounds), for each seed and each `attn_impl`: the loss's relative gap,
the worst gradient's gap relative to its largest entry, and the worst
gap in norm.  Then, on the first seed, the same with kernel 11's
log-sum-exp shifted by log 2, 2^-7 and 2^-10 (the forward's output left
as it is): what a wrong forward reads, to set the bounds between.
`--device cpu` rehearses it on the smoke configuration.  Each line of
output is one JSON object; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHIFTS = (math.log(2.0), 2.0 ** -7, 2.0 ** -10)


def seeds(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def shifted_lse(ops, shift: float):
    """`ops.flash_attention_fwd` with its log-sum-exp output plus
    `shift`; returns the original, to put back."""
    real = ops.flash_attention_fwd

    def fwd(q, k, v, causal=True, return_lse=False):
        out = real(q, k, v, causal, return_lse)
        return (out[0], out[1] + shift) if return_lse else out
    ops.flash_attention_fwd = fwd
    return real


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=seeds, default=seeds("12-19"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            print("grad_bounds: needs a CUDA device (or --device cpu)",
                  file=sys.stderr)
            return 1
        from repro_torch.kernels import _build
        _build.build_all()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    cfg = get_config("qwen2.5-3b" if cuda else "qwen2.5-3b-smoke")
    for seed in args.seeds:
        for impl in ("blockwise", "flash"):
            g = chip_smoke.grad_gaps(torch, device, seed, cfg, impl)
            print(json.dumps({"arch": cfg.name, "seed": seed, "impl": impl,
                              "lse_shift": 0.0, **g}), flush=True)
    for shift in SHIFTS:
        real = shifted_lse(ops, shift)
        try:
            for impl in ("blockwise", "flash"):
                g = chip_smoke.grad_gaps(torch, device, args.seeds[0], cfg,
                                         impl)
                print(json.dumps({"arch": cfg.name, "seed": args.seeds[0],
                                  "impl": impl, "lse_shift": shift, **g}),
                      flush=True)
        finally:
            ops.flash_attention_fwd = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
