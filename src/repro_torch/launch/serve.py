"""Batched serving from the command line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b-smoke \
        --batch 4 --prompt-len 32 --new-tokens 32 [--device cpu]

It runs on the card unless `--device cpu` is given, and raises without
one.  The port runs the `dense` family (phi3-medium-14b, yi-9b,
qwen2.5-3b, starcoder2-15b), the `ssm` family (mamba2-370m), the
`hybrid` family (zamba2-7b), the `moe` family (deepseek-v2-lite-16b,
phi3.5-moe-42b-a6.6b), the `vlm` family (llama-3.2-vision-11b) and the
`encdec` family (whisper-base), and their `-smoke` variants (`--arch
yi-9b-smoke --device cpu` or `--arch whisper-base-smoke --device cpu`
serves on the CPU); weights are random, drawn from seed 0, as the
reference's CLI draws them.  A vlm model's stub image embeddings and an
encdec model's stub frames are float32 N(0, 1), drawn after the prompts
from the same numpy generator, as the reference's CLI draws them.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config
    from ..models import lm
    from ..serving import ServeEngine

    cfg = get_config(args.arch)
    device = lm.resolve_device(args.device)
    model = lm.build_model(cfg, device,
                           torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = rng.normal(
            size=(args.batch, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            size=(args.batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    eng = ServeEngine(cfg, model,
                      max_seq=args.prompt_len + args.new_tokens,
                      temperature=args.temperature)
    t0 = time.time()
    out = eng.generate(prompts, args.new_tokens, extra or None)
    dt = time.time() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"generated {out.shape} on {device} in {dt:.2f}s ({tok_s:.1f} "
          f"tok/s incl. prefill)")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
