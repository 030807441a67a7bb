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

The three decodes run on the training path once per encoded block and
step, thousands of times a fit, where the host's cost per call is most of
the call: a call checks only what the C side cannot (dtypes, ranks,
contiguity, one device), makes one allocation and one ctypes call of
seven arguments (input, table, output, n, table length, the plan word
`decode_plan` computed once per size, the stream), as groupby_sum's.
decode.cu validates what it can and returns an error code, which raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ._common import check_cuda_operand, count_launch, grid_blocks, on_cpu
from .colscan import colscan_plain, launch_scan

LAUNCHES = {"fused_decode_scan": 0, "dict_decode": 0, "bitpack_decode": 0,
            "rle_decode": 0}
KERNEL_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)
# decode.cu's dtype codes of a table (dictionary, run values) and its output
_TABLE_CODES = {t: i for i, t in enumerate(KERNEL_DTYPES)}
MAX_BIT_WIDTH = 16          # compression.BITPACK_MAX_BITS
SMEM_BYTES = 48 * 1024      # static shared memory a block may stage
# rows a dict_decode thread decodes over its grid-stride loop: two 4-code
# steps, of one, two and four the least device time at phase 3's 156,250
# codes on an H100 (scripts/kernel_probe.py decode); bitpack_decode and
# rle_decode, one row a thread a step, keep grid_blocks(n)'s 4
ROWS_PER_THREAD = 8

_OP_DICT, _OP_BITPACK, _OP_RLE = 0, 1, 2


class DecodePlan(NamedTuple):
    blocks: int        # grid of the launch: a function of n only
    staged: bool       # dict_decode stages the dictionary in shared memory

    def word(self, op: int, dtype_code: int = 0, bit_width: int = 0,
             bias: int = 0) -> int:
        """decode.cu's 64-bit plan word: op bits 0-1, table dtype 2-3,
        staging bit 4, bit width 5-10, blocks 11-22, the int32 bias as
        bits 32-63."""
        return (op | dtype_code << 2 | int(self.staged) << 4
                | bit_width << 5 | self.blocks << 11
                | (int(bias) & 0xFFFFFFFF) << 32)


@functools.lru_cache(maxsize=4096)
def decode_plan(n: int, d: int, itemsize: int) -> DecodePlan:
    """The launch of a decode of n rows from a table of d values of
    `itemsize` bytes: blocks for ROWS_PER_THREAD rows a thread (a function
    of n only), and the dictionary staged in shared memory when it fits in
    SMEM_BYTES and has no more values than the rows one block decodes
    (otherwise staging would read more than the gather does)."""
    blocks = grid_blocks(n, ROWS_PER_THREAD)
    rows_per_block = -(-int(n) // blocks)
    staged = 0 < d * itemsize <= SMEM_BYTES and d <= rows_per_block
    return DecodePlan(blocks, staged)


@functools.lru_cache(maxsize=4096)
def _word(op: int, n: int, d: int, dtype: torch.dtype, bit_width: int = 0,
          bias: int = 0) -> int:
    """The plan word of one call, computed once per size and dtype."""
    plan = (decode_plan(n, d, dtype.itemsize) if op == _OP_DICT
            else DecodePlan(grid_blocks(n), False))
    return plan.word(op, _TABLE_CODES[dtype], bit_width, bias)


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
    if t.dtype not in _TABLE_CODES:
        raise TypeError(f"{name} must be int32, int64, float32 or float64, "
                        f"got {t.dtype}")


def _check_int32(t: torch.Tensor, name: str) -> None:
    check_cuda_operand(t, name)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")


def _launch_decode(name: str, idx: torch.Tensor, table, out: torch.Tensor,
                   n: int, table_len: int, word: int) -> None:
    """One call of decode.cu's entry point; its error code raises."""
    rc = _build.kernel_fn("decode")(
        idx.data_ptr(), table.data_ptr() if table is not None else None,
        out.data_ptr(), n, table_len, word, _build.stream_handle(out.device))
    if rc:
        _build.check_launch(name, rc)
    count_launch(LAUNCHES, name)


def _check_dict(codes: torch.Tensor, dictionary: torch.Tensor) -> None:
    """What decode.cu cannot see: dtypes, ranks, contiguity, one device."""
    if codes.dtype != torch.int32 or dictionary.dtype not in _TABLE_CODES:
        raise TypeError(f"dict_decode takes int32 codes and an int32, int64, "
                        f"float32 or float64 dictionary; got {codes.dtype}, "
                        f"{dictionary.dtype}")
    if codes.dim() != 1 or dictionary.dim() != 1 \
            or not (codes.is_contiguous() and dictionary.is_contiguous()):
        raise ValueError("codes and dictionary must be 1-D and contiguous")
    if codes.get_device() != dictionary.get_device():
        raise ValueError(f"dict_decode operands on two devices: "
                         f"{codes.device}, {dictionary.device}")


def dict_decode(codes: torch.Tensor, dictionary: torch.Tensor
                ) -> torch.Tensor:
    # the card's test first: cheaper than on_cpu on this per-block path
    # (on_cpu raises on a CPU / CUDA mix)
    if not (codes.is_cuda and dictionary.is_cuda) \
            and on_cpu(codes, dictionary):
        return dict_decode_plain(codes, dictionary)
    _check_dict(codes, dictionary)
    dtype = dictionary.dtype
    n, d = codes.shape[0], dictionary.shape[0]
    out = torch.empty(n, dtype=dtype, device=codes.device)
    if n:     # an empty dictionary is decode.cu's to refuse
        _launch_decode("dict_decode", codes, dictionary, out, n, d,
                       _word(_OP_DICT, n, d, dtype))
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
    if n:
        _launch_decode("bitpack_decode", words, None, out, int(n),
                       words.shape[0],
                       _word(_OP_BITPACK, int(n), 0, torch.int32,
                             int(bit_width), int(bias)))
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
    if n:
        r = run_values.shape[0]
        _launch_decode("rle_decode", run_ends, run_values, out, int(n), r,
                       _word(_OP_RLE, int(n), r, run_values.dtype))
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
