"""The control's arithmetic: the reference with every matrix product's
operands, and attention's q, k, v and probabilities, rounded to float8
(e4m3) before use, the products summed in float32: the precision below
the bfloat16 the configurations state.  Weights are scaled a tensor at a
time, activations a row at a time, so that each one's largest magnitude
maps to e4m3's largest finite value (448), as float8 recipes scale them.
The rounding passes gradients through unchanged (straight-through), so the
control also trains.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class FP8:
    @staticmethod
    def act(x: torch.Tensor) -> torch.Tensor:
        return _round(x, x.detach().abs().amax(dim=-1, keepdim=True))

    @staticmethod
    def weight(w: torch.Tensor) -> torch.Tensor:
        return _round(w, w.detach().abs().amax())
