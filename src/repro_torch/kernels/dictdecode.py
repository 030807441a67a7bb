"""Dictionary, bit-pack and run-length decode (paper §3.2), and dictionary
decode fused into the filter + aggregate scan.

  * `dict_decode(codes, dictionary)` -> `dictionary[codes]`, with jnp's
    indexing rule for codes outside [0, d): a negative code counts from
    the end, then the index clamps to [0, d - 1];
  * `bitpack_decode(words, bit_width, bias, n)` -> the first n int32 lanes
    of `32 // bit_width` lanes per uint32 word (low lane first), plus the
    int32 `bias`.  Words arrive as int32 bits (or int64 values): torch has
    no CPU `>>` for uint32;
  * `rle_decode(run_values, run_ends, n)` -> position i takes
    `run_values[min(#{ends <= i}, r - 1)]`, run_ends cumulative exclusive;
  * `fused_decode_scan(codes, dictionary, agg_col, lo, hi)` is `colscan`
    with the filter value of row i taken as `dictionary[codes[i]]`; a code
    outside [0, len(dictionary)) — the pad code d of the TPU kernel — reads
    NaN and so fails both bounds.

On CUDA tensors the wrappers launch `csrc/decode.cu` (the first three;
they replace repro/kernels/dictdecode.py:dict_decode, bitpack_decode and
rle_decode, each one pass bound by its bytes, see the note in the source)
and `csrc/scan.cu` with its DictGather policy (fused_decode_scan, which
replaces repro/kernels/dictdecode.py:fused_decode_scan: the int32 codes
stream from HBM, the dictionary stays in L1, and the decoded filter column
never exists).  On CPU tensors they run the `*_plain` versions.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import check_cuda_operand, count_launch, grid_blocks, on_cpu
from .colscan import colscan_plain, launch_scan

LAUNCHES = {"fused_decode_scan": 0, "dict_decode": 0, "bitpack_decode": 0,
            "rle_decode": 0}
KERNEL_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)
MAX_BIT_WIDTH = 16          # compression.BITPACK_MAX_BITS
SMEM_BYTES = 48 * 1024      # static shared memory a block may stage

_OP_DICT, _OP_BITPACK, _OP_RLE = 0, 1, 2


# ---------------------------------------------------------------- plain


def dict_decode_plain(codes: torch.Tensor, dictionary: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    d = dictionary.shape[0]
    c = codes.to(torch.int64)
    c = torch.where(c < 0, c + d, c).clamp(0, d - 1)
    return dictionary[c]


def bitpack_decode_plain(words: torch.Tensor, bit_width: int, bias: int,
                         n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): int32 lanes."""
    per_word = 32 // bit_width
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(per_word, device=words.device,
                          dtype=torch.int64) * bit_width
    lanes = (w[:, None] >> shifts[None, :]) & ((1 << bit_width) - 1)
    return (lanes.reshape(-1)[:n] + int(bias)).to(torch.int32)


def rle_decode_plain(run_values: torch.Tensor, run_ends: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    pos = torch.arange(n, device=run_ends.device, dtype=run_ends.dtype)
    idx = torch.searchsorted(run_ends, pos, right=True)
    return run_values[idx.clamp(max=run_values.shape[0] - 1)]


def fused_decode_scan_plain(codes: torch.Tensor, dictionary: torch.Tensor,
                            agg_col: torch.Tensor, lo, hi) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    d = dictionary.shape[0]
    padded = torch.cat([dictionary.to(torch.float64),
                        torch.full((1,), float("nan"), dtype=torch.float64,
                                   device=dictionary.device)])
    c = codes.to(torch.int64)
    c = torch.where((c >= 0) & (c < d), c, torch.full_like(c, d))
    return colscan_plain(padded[c], agg_col, lo, hi)


# ---------------------------------------------------------------- kernels


def _check_table(t: torch.Tensor, name: str) -> None:
    check_cuda_operand(t, name)
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} must be int32, int64, float32 or float64, "
                        f"got {t.dtype}")
    if t.shape[0] < 1:
        raise ValueError(f"{name} is empty")


def _check_int32(t: torch.Tensor, name: str) -> None:
    check_cuda_operand(t, name)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")


def _launch_decode(name: str, op: int, idx: torch.Tensor, table, bit_width,
                   bias, use_smem: bool, out: torch.Tensor, n: int) -> None:
    rc = _build.kernel_fn("decode")(
        op, idx.data_ptr(),
        table.data_ptr() if table is not None else None,
        _build.dtype_code(table) if table is not None else 0,
        int(table.shape[0]) if table is not None else 0,
        int(bit_width), int(bias), int(use_smem), out.data_ptr(), int(n),
        grid_blocks(n), _build.stream_handle(out.device))
    _build.check_launch(name, rc)
    count_launch(LAUNCHES, name)


def dict_decode(codes: torch.Tensor, dictionary: torch.Tensor
                ) -> torch.Tensor:
    if on_cpu(codes, dictionary):
        return dict_decode_plain(codes, dictionary)
    _check_int32(codes, "codes")
    _check_table(dictionary, "dictionary")
    n = int(codes.shape[0])
    out = torch.empty(n, dtype=dictionary.dtype, device=codes.device)
    if n == 0:
        return out
    d = int(dictionary.shape[0])
    # stage the dictionary in shared memory when it fits and is small
    # beside the rows one block decodes (4 per thread, grid_blocks)
    rows_per_block = -(-n // grid_blocks(n))
    use_smem = (d * dictionary.element_size() <= SMEM_BYTES
                and d <= rows_per_block)
    _launch_decode("dict_decode", _OP_DICT, codes, dictionary, 0, 0,
                   use_smem, out, n)
    return out


def bitpack_decode(words: torch.Tensor, bit_width: int, bias: int,
                   n: int) -> torch.Tensor:
    if on_cpu(words):
        return bitpack_decode_plain(words, bit_width, bias, n)
    _check_int32(words, "words")
    if not 1 <= int(bit_width) <= MAX_BIT_WIDTH:
        raise ValueError(f"bitpack_decode takes bit widths 1..{MAX_BIT_WIDTH}"
                         f", got {bit_width}")
    per_word = 32 // int(bit_width)
    if int(n) < 0 or int(n) > words.shape[0] * per_word:
        raise ValueError(f"{n} lanes do not fit in {words.shape[0]} words "
                         f"of {per_word} lanes")
    if not -2 ** 31 <= int(bias) < 2 ** 31:
        raise ValueError(f"bias {bias} is not an int32")
    out = torch.empty(int(n), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    _launch_decode("bitpack_decode", _OP_BITPACK, words, None, bit_width,
                   bias, False, out, int(n))
    return out


def rle_decode(run_values: torch.Tensor, run_ends: torch.Tensor,
               n: int) -> torch.Tensor:
    if on_cpu(run_values, run_ends):
        return rle_decode_plain(run_values, run_ends, n)
    _check_table(run_values, "run_values")
    _check_int32(run_ends, "run_ends")
    if run_ends.shape[0] != run_values.shape[0]:
        raise ValueError(f"{run_values.shape[0]} run values but "
                         f"{run_ends.shape[0]} run ends")
    out = torch.empty(int(n), dtype=run_values.dtype,
                      device=run_values.device)
    if n == 0:
        return out
    _launch_decode("rle_decode", _OP_RLE, run_ends, run_values, 0, 0, False,
                   out, int(n))
    return out


def fused_decode_scan(codes: torch.Tensor, dictionary: torch.Tensor,
                      agg_col: torch.Tensor, lo, hi) -> torch.Tensor:
    if on_cpu(codes, dictionary, agg_col):
        return fused_decode_scan_plain(codes, dictionary, agg_col, lo, hi)
    n = int(codes.shape[0])
    check_cuda_operand(codes, "codes")
    check_cuda_operand(dictionary, "dictionary")
    check_cuda_operand(agg_col, "agg_col", n)
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    out = launch_scan("fused_decode_scan", dictionary, codes, agg_col, n,
                      lo, hi)
    count_launch(LAUNCHES, "fused_decode_scan")
    return out
