"""The benchmark's frozen measures: the card's peaks, the work formulas of
the LM kernels and of a model step, and the arithmetic that turns a
device trace into busy time, idle gaps and the operations that took most.

Copied, so that the program can change without moving the yardstick:
- `PEAK_FLOPS`, `PEAK_BYTES_PER_S`: `repro_torch/launch/cost.py`'s `H100`
  (NVIDIA's H100 SXM data sheet, dense bf16 on the tensor cores, HBM3);
- `flash_cost`, `ssd_cost`, `SSD_TILE`: `launch/cost.py` as of this
  benchmark's first version; `ssd_bwd_cost`: `launch/cost.py` as of the
  hand-written SSD backward (kernel 12b);
- `union`, `gaps`, `top_ops`: the arithmetic of `chip_smoke.traced()`
  (its busy time is the union of the device's kernel and copy spans).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .spec import Spec, family, head_params, matmul_params

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3
SSD_TILE = 64


def flash_cost(b, h, s, hd, itemsize, kv=None, t=None, causal=None):
    """(bytes, flops) of attention: q and k, v (kv heads, default h; t
    rows, default s) read and o written once; two hd-long dot products
    per (row, col) pair of each query head, col <= row where causal (by
    default: when t is None), every col of t otherwise."""
    kv = h if kv is None else kv
    causal = t is None if causal is None else causal
    t = s if t is None else t
    pairs = (min(s, t) * (min(s, t) + 1) / 2 + max(s - t, 0) * t
             if causal else float(s) * t)
    return ((2.0 * h * s + 2.0 * kv * t) * b * hd * itemsize,
            4.0 * b * h * hd * pairs)


def ssd_cost(b, s, h, p, n, itemsize, groups: int = 1):
    """(bytes, flops) of the SSD scan with 64-row tiles: x, B, C (x's
    dtype; `groups` B and C a row) and dt read once, y (x's dtype) and the
    float32 final state written once, a and d read; per row and head the
    causal halves of C B^T and M x, C . state and the state update."""
    nbytes = (2.0 * b * s * h * p + 2.0 * b * s * groups * n) * itemsize \
        + 4.0 * b * s * h + 4.0 * b * h * p * n + 8.0 * h
    flops = 2.0 * b * s * h * (SSD_TILE / 2 * (n + p) + 2.0 * n * p)
    return nbytes, flops


def ssd_bwd_cost(b, s, h, p, n, itemsize, groups: int = 1):
    """(bytes, flops) of the SSD scan's backward with 64-row tiles: x, dy
    and dx (x's dtype), B, C, dB and dC (`groups` a row), dt and ddt, and
    the float32 dstate each moved once, a and d read, da and dD written;
    per row and head the causal halves of C B^T, dy x^T, dG B, dG^T C and
    M^T dy, and five N x P products (the rebuilt state, B dh^T, x dh,
    dy h and dh's update)."""
    nbytes = (3.0 * b * s * h * p + 4.0 * b * s * groups * n) * itemsize \
        + 8.0 * b * s * h + 4.0 * b * h * p * n + 16.0 * h
    flops = 2.0 * b * s * h * (SSD_TILE / 2 * (3.0 * n + 2.0 * p)
                               + 5.0 * n * p)
    return nbytes, flops


def bound_s(cost: Tuple[float, float]) -> float:
    """The least time of work of (bytes, flops) on the card."""
    nbytes, flops = cost
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


# ---------------------------------------------------------------------------
# A model's work, from the configuration's shapes
# ---------------------------------------------------------------------------

def mixer_cost(spec: Spec, b: int, s: int) -> Tuple[float, float]:
    """(bytes, flops) of one layer's sequence mixer in a forward over a
    batch of b sequences of s tokens, as the configuration's family gives
    it (`families/<family>.py`)."""
    return family(spec).mixer_cost(spec, b, s)


def forward_flops(spec: Spec, b: int, s: int, head_rows: int) -> float:
    """Model FLOPs of a forward over b x s tokens: 2 per matrix weight and
    token in the layers, the head over `head_rows` rows, the family's
    further FLOPs a token and layer (Mamba2's convolution), and each
    layer's mixer."""
    tokens = b * s
    layer_weights = matmul_params(spec) - head_params(spec)
    return (2.0 * layer_weights * tokens
            + 2.0 * head_params(spec) * head_rows
            + family(spec).flops_per_token(spec) * spec.n_layers * tokens
            + spec.n_layers * mixer_cost(spec, b, s)[1])


def train_flops(spec: Spec, b: int, s: int) -> float:
    """Model FLOPs of a training step: the forward with the head at every
    position, and its backward at twice the forward's."""
    return 3.0 * forward_flops(spec, b, s, head_rows=b * s)


def prefill_flops(spec: Spec, b: int, s: int) -> float:
    """Model FLOPs of a prefill: the head at each sequence's last
    position only, as a prefill needs."""
    return forward_flops(spec, b, s, head_rows=b)


# ---------------------------------------------------------------------------
# Trace arithmetic
# ---------------------------------------------------------------------------

Span = Tuple[float, float]


def union(spans: Sequence[Span]) -> float:
    """The length of the union of [start, end) spans."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def gaps(spans: Sequence[Span]) -> List[Span]:
    """The idle intervals between the spans' union, in time order."""
    out, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def top_ops(ops: Sequence[Tuple[str, float, float]], n: int = 10
            ) -> List[List]:
    """[[name, seconds], ...]: the n names whose spans (start, end in
    microseconds) add up to most time."""
    total: Dict[str, float] = {}
    for name, a, b in ops:
        total[name] = total.get(name, 0.0) + (b - a)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in top]
