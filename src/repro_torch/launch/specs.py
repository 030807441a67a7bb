"""Stand-ins for every (architecture x input-shape) dry-run cell on the
meta device: the counterpart of the reference's `launch/specs.py`.

A meta tensor has a shape, a dtype and strides and no data, so the
cell's model, optimizer state, batch and caches cost no memory however
large they are; the cell's function then runs on them under a cost
counter (`launch/cost.py`) and dispatches what it would on the card.
`device="cpu"` builds the same cell with data (the tests count a smoke
cell both ways).

The reference also returns PartitionSpec trees, which place each
tensor over a pod mesh through GSPMD (`parallel/sharding.py`, `zero1_specs`,
`cache_pspecs`).  The port has no counterpart of them (ROADMAP A.7): it
places every tensor whole where it computes it, and a cell is one card's
program.  The batch is the reference's: int32 tokens (and labels), and
a vlm or encdec cell's bfloat16 `image_embeds` or `frames`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import lm
from ..training import AdamWConfig, init_opt_state, make_train_step


def param_shapes(cfg: ModelConfig, device="meta") -> lm.LM:
    """The cell's model: `lm.build_model` on `device` (on meta, nothing
    drawn)."""
    return lm.build_model(cfg, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta"
                ) -> Dict[str, torch.Tensor]:
    """Zero stand-ins for one cell's model inputs, the reference's names
    and dtypes: tokens (and labels) (B, S) int32, or a decode cell's
    token (B, 1); a vlm or encdec cell's bfloat16 frontend output."""
    b, s = shape.global_batch, shape.seq_len

    def zeros(*dims, dtype=torch.int32):
        return torch.zeros(dims, dtype=dtype, device=device)

    if shape.kind == "train":
        out = {"tokens": zeros(b, s), "labels": zeros(b, s)}
    elif shape.kind == "prefill":
        out = {"tokens": zeros(b, s)}
    elif shape.kind == "decode":
        out = {"token": zeros(b, 1)}
    else:
        raise ValueError(shape.kind)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["image_embeds"] = zeros(b, cfg.n_frontend_tokens, cfg.d_model,
                                    dtype=torch.bfloat16)
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frames"] = zeros(b, cfg.enc_seq, cfg.d_model,
                              dtype=torch.bfloat16)
    return out


def cache_shapes(cfg: ModelConfig, model: lm.LM, b: int, max_seq: int,
                 prefill_len: int = 64):
    """The caches of b sequences at `max_seq`, as `lm.prefill_fn` of a
    prompt of `prefill_len` tokens (at most max_seq) makes them on the
    model's device (so they can never drift from what prefill
    produces)."""
    dev = model.embed.tok.device
    batch = input_specs(cfg, ShapeConfig(
        "tmp", "prefill", min(prefill_len, max_seq), b), dev)
    _, caches = lm.prefill_fn(cfg, model, batch, max_seq)
    return caches


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               opt: Optional[AdamWConfig] = None, microbatches: int = 1,
               device="meta", max_seq: Optional[int] = None):
    """(fn, args) of one cell, to run as fn(*args):

    train   -> train_step(model, opt_state, batch), one AdamW step
               (`training.make_train_step`)
    prefill -> prefill(model, batch), caches at `max_seq` (default
               seq_len, as in the reference)
    decode  -> decode(model, token, caches, cur_len), one token at
               cur_len = seq_len - 1 against caches of seq_len rows;
               cur_len is a Python int (`decode_fn` indexes with it), so
               the arguments hold 4 bytes fewer than the reference's,
               whose cur_len is an int32 scalar
    """
    model = param_shapes(cfg, device)
    if shape.kind == "train":
        opt_state = init_opt_state(dict(model.named_parameters()))
        fn = make_train_step(cfg, opt or AdamWConfig(), microbatches)
        return fn, (model, opt_state, input_specs(cfg, shape, device))
    if shape.kind == "prefill":
        seq = shape.seq_len if max_seq is None else max_seq

        def prefill(model, batch):
            return lm.prefill_fn(cfg, model, batch, seq)
        return prefill, (model, input_specs(cfg, shape, device))
    caches = cache_shapes(cfg, model, shape.global_batch, shape.seq_len)

    def decode(model, token, caches, cur_len):
        return lm.decode_fn(cfg, model, token, caches, cur_len)
    return decode, (model, input_specs(cfg, shape, device)["token"], caches,
                    shape.seq_len - 1)
