"""Dictionary, bit-pack and run-length decode (paper §3.2), and dictionary
decode fused into the filter + aggregate scan.

  * `dict_decode(codes, dictionary)` -> `dictionary[codes]`, with jnp's
    indexing rule for codes outside [0, d): a negative code counts from
    the end, then the index clamps to [0, d - 1];
  * `bitpack_decode(words, bit_width, bias, n)` -> the first n int32 lanes
    of `32 // bit_width` lanes per uint32 word (low lane first), plus the
    int32 `bias`.  Words arrive as int32 bits (or int64 values): torch has
    no CPU `>>` for uint32.  It is the one-column case of
    `bitpack_decode_into(blocks, dests, n)`, which decodes any number of
    bit-packed blocks of n rows (`BitpackBlock`: words,
    width, an int64 bias, the block's original integer dtype) into
    strided destinations of one dtype — the columns of a train step's
    feature matrix — each value `(lane + bias)` in int64, cast to the
    block's dtype, then to the destination's, as `decode_torch(enc).to(dt)`
    gives it;
  * `rle_decode(run_values, run_ends, n)` -> position i takes
    `run_values[min(#{ends <= i}, r - 1)]`, run_ends cumulative exclusive
    (any non-decreasing int32 ends: zero-length runs and n past the last
    end included).  It is the one-column case of
    `rle_decode_into(run_values, run_ends, n, dst, orig_dtype)`, which
    writes the n values into a strided (n,) destination of int32, int64,
    float32 or float64 — a column of a train step's feature matrix — each
    run value cast to the block's original dtype (`orig_dtype`, default
    the values' own), then to the destination's, as
    `decode_torch(enc).to(dt)` gives it;
  * `fused_decode_scan(codes, dictionary, agg_col, lo, hi)` is `colscan`
    with the filter value of row i taken as `dictionary[codes[i]]`; a code
    outside [0, len(dictionary)) — the pad code d of the TPU kernel — reads
    NaN and so fails both bounds.

On CUDA tensors the wrappers launch `csrc/decode.cu` (the first three;
they replace repro/kernels/dictdecode.py:dict_decode, bitpack_decode and
rle_decode, each one pass bound by its bytes, see the note in the source;
a `bitpack_decode_into` call is one launch per MAX_BITPACK_COLUMNS
blocks, their descriptors passed by value in the kernel's parameters; an
`rle_decode_into` call one launch, tiles of RLE_TILE positions a block
with their runs staged in shared memory)
and `csrc/scan.cu` with its Dict source (fused_decode_scan, which
replaces repro/kernels/dictdecode.py:fused_decode_scan: the int32 codes
stream from HBM, the dictionary is staged in shared memory when it fits,
and the decoded filter column never exists; one launch through
`colscan.launch_scan`).  On CPU tensors they run the `*_plain` versions.

The decodes run on the training path once per encoded block and step
(bit-pack once per partition and step), thousands of times a fit, where
the host's cost per call is most of the call: a call checks only what the
C side cannot (dtypes, ranks, contiguity, one device, sizes), makes at
most one allocation and one ctypes call of plain arguments (dict and RLE:
input, table, output, n, table length, the plan word `decode_plan` (RLE:
`rle_word`, which adds the destination's dtype and stride and the
original dtype) computed once per size, the stream, as groupby_sum's;
bit-pack: the
packed descriptors, their count, n, its plan word, the stream).
decode.cu validates what it can and returns an error code, which raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
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
MAX_BITPACK_COLUMNS = 32    # descriptors in one launch's parameters
BITPACK_TILE_ROWS = 128     # rows of every column a block decodes at once
BITPACK_MAX_BLOCKS = 2112   # 16 blocks on each of the H100's 132 SMs
MAX_BITPACK_ROWS = 2 ** 31 - 1   # the kernel's row indices are 32-bit
# a bit-packed block's original integer dtype (decode.cu's enum OrigType)
BITPACK_ORIG_CODES = {t: i for i, t in enumerate(
    (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
     torch.uint32, torch.int64, torch.uint64))}
SMEM_BYTES = 48 * 1024      # static shared memory a block may stage
# rows a dict_decode thread decodes over its grid-stride loop: two 4-code
# steps, of one, two and four the least device time at phase 3's 156,250
# codes on an H100 (scripts/kernel_probe.py decode); bit-pack and RLE
# take tiles (BITPACK_TILE_ROWS, RLE_TILE)
ROWS_PER_THREAD = 8
# positions (and staged runs) of an RLE tile, 4 a thread: 1,024 took the
# least device time at phase 3's column on an H100, 2,048 more
# (scripts/kernel_probe.py rle)
RLE_TILE = 1024
RLE_MAX_BLOCKS = 2112       # 16 blocks on each of the H100's 132 SMs
# the conversion of a run value: its original integer dtype's code
# (BITPACK_ORIG_CODES); int64's keeps the value, as floats are kept
RLE_KEEP = BITPACK_ORIG_CODES[torch.int64]

_OP_DICT, _OP_BITPACK, _OP_RLE = 0, 1, 2


class DecodePlan(NamedTuple):
    blocks: int        # grid of the launch: a function of n only
    staged: bool       # dict_decode stages the dictionary in shared memory

    def word(self, op: int, dtype_code: int = 0) -> int:
        """decode.cu's 64-bit plan word: op bits 0-1, the table's dtype
        (bit-pack: the output's) 2-3, staging bit 4, blocks 11-22."""
        return op | dtype_code << 2 | int(self.staged) << 4 \
            | self.blocks << 11


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
def bitpack_plan(n: int) -> DecodePlan:
    """The grid of a bit-pack launch: a block a tile of BITPACK_TILE_ROWS
    rows (of every column), at most BITPACK_MAX_BLOCKS blocks, which then
    walk further tiles."""
    return DecodePlan(max(1, min(BITPACK_MAX_BLOCKS,
                                 -(-int(n) // BITPACK_TILE_ROWS))), False)


@functools.lru_cache(maxsize=4096)
def rle_plan(n: int) -> DecodePlan:
    """The grid of an RLE launch: a block a tile of RLE_TILE positions, at
    most RLE_MAX_BLOCKS blocks, which then walk further tiles."""
    return DecodePlan(max(1, min(RLE_MAX_BLOCKS, -(-int(n) // RLE_TILE))),
                      False)


@functools.lru_cache(maxsize=4096)
def rle_word(n: int, dtype: torch.dtype, out_dtype: torch.dtype,
             odt: int = RLE_KEEP, stride: int = 1) -> int:
    """decode.cu's plan word of an RLE call: rle_plan(n)'s, the values'
    dtype, and bits 23-24 the destination's dtype, 25-27 the original
    dtype's code, 32-62 the destination's element stride."""
    return (rle_plan(n).word(_OP_RLE, _TABLE_CODES[dtype])
            | _TABLE_CODES[out_dtype] << 23 | odt << 25 | stride << 32)


@functools.lru_cache(maxsize=4096)
def _word(op: int, n: int, d: int, dtype: torch.dtype) -> int:
    """The plan word of one call, computed once per size and dtype (d: the
    table's length)."""
    if op == _OP_DICT:
        plan = decode_plan(n, d, dtype.itemsize)
    elif op == _OP_BITPACK:
        plan = bitpack_plan(n)
    else:
        return rle_word(n, dtype, dtype)
    return plan.word(op, _TABLE_CODES[dtype])


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


class BitpackBlock(NamedTuple):
    """One bit-packed block to decode: its words (int32 bits; int64 values
    on the CPU), bit width, int64 bias and original integer dtype."""
    words: torch.Tensor
    bit_width: int
    bias: int
    dtype: torch.dtype


def bitpack_decode_into_plain(blocks: Sequence[BitpackBlock],
                              dests: Sequence[torch.Tensor], n: int) -> None:
    """Plain PyTorch version of the batched kernel (any device): per block,
    the int32 lanes, the int64 bias, the cast to its dtype, and one
    cast-and-place copy into its destination."""
    for b, dst in zip(blocks, dests):
        lanes = bitpack_decode_plain(b.words, b.bit_width, 0, n)
        dst.copy_((lanes.to(torch.int64) + int(b.bias)).to(b.dtype))


def rle_decode_plain(run_values: torch.Tensor, run_ends: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    pos = torch.arange(n, device=run_ends.device, dtype=run_ends.dtype)
    idx = torch.searchsorted(run_ends, pos, right=True)
    return run_values[idx.clamp(max=run_values.shape[0] - 1)]


def rle_decode_into_plain(run_values: torch.Tensor, run_ends: torch.Tensor,
                          n: int, dst: torch.Tensor,
                          orig_dtype: torch.dtype = None) -> None:
    """Plain PyTorch version of the `into` kernel (any device): the values,
    the cast to the original dtype, one cast-and-place copy."""
    v = rle_decode_plain(run_values, run_ends, n)
    dst.copy_(v if orig_dtype is None else v.to(orig_dtype))


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
    if not -2 ** 31 <= int(bias) < 2 ** 31:
        raise ValueError(f"bias {bias} is not an int32")
    out = torch.empty(int(n), dtype=torch.int32, device=words.device)
    bitpack_decode_into([BitpackBlock(words, int(bit_width), int(bias),
                                      torch.int32)], [out], int(n))
    return out


def pack_bitpack_descriptors(blocks: Sequence[BitpackBlock],
                             dests: Sequence[torch.Tensor]) -> np.ndarray:
    """decode.cu's BitpackDesc of each block of one launch (at most
    MAX_BITPACK_COLUMNS), as a row of four int64: the words' address, the
    destination's address, the bias, and the destination's element stride
    (bits 0-31), the bit width (32-39) and the original dtype's code
    (40-47)."""
    if not 1 <= len(blocks) <= MAX_BITPACK_COLUMNS:
        raise ValueError(f"one bit-pack launch takes 1..{MAX_BITPACK_COLUMNS}"
                         f" descriptors, got {len(blocks)}")
    flat = []
    for b, dst in zip(blocks, dests):
        flat += (b.words.data_ptr(), dst.data_ptr(), b.bias,
                 dst.stride(0) | b.bit_width << 32
                 | BITPACK_ORIG_CODES[b.dtype] << 40)
    return np.array(flat, dtype=np.int64).reshape(-1, 4)


def _check_bitpack(blocks: Sequence[BitpackBlock],
                   dests: Sequence[torch.Tensor], n: int) -> torch.dtype:
    """What decode.cu cannot see: counts, dtypes, ranks, sizes, one
    device; returns the destinations' dtype.  Each block's checks are a
    few attribute reads: this runs once a partition and step."""
    if len(blocks) != len(dests) or not blocks:
        raise ValueError(f"bitpack_decode_into takes one or more blocks with "
                         f"one destination each, got {len(blocks)} and "
                         f"{len(dests)}")
    out_dtype = dests[0].dtype
    if out_dtype not in _TABLE_CODES:
        raise TypeError(f"bit-pack destinations must be int32, int64, "
                        f"float32 or float64, got {out_dtype}")
    device = dests[0].get_device()
    for b, dst in zip(blocks, dests):
        words, width = b.words, b.bit_width
        if words.dtype != torch.int32:
            raise TypeError(f"words must be int32, got {words.dtype}")
        if words.dim() != 1 or not words.is_contiguous():
            raise ValueError("words must be 1-D and contiguous")
        if not 1 <= width <= MAX_BIT_WIDTH:
            raise ValueError(f"bitpack_decode takes bit widths "
                             f"1..{MAX_BIT_WIDTH}, got {width}")
        if not 0 <= n <= min(MAX_BITPACK_ROWS,
                             words.shape[0] * (32 // width)):
            raise ValueError(f"{n} lanes do not fit in {words.shape[0]} "
                             f"words of {32 // width} lanes")
        if b.dtype not in BITPACK_ORIG_CODES:
            raise TypeError(f"bit-packed blocks decode to an integer dtype, "
                            f"got {b.dtype}")
        if not -2 ** 63 <= b.bias < 2 ** 63:
            raise ValueError(f"bias {b.bias} is not an int64")
        if dst.dtype != out_dtype or dst.dim() != 1 or dst.shape[0] != n \
                or not 1 <= dst.stride(0) < 2 ** 31:
            raise ValueError(f"each destination must be a ({n},) {out_dtype}"
                             f" vector of positive stride, got "
                             f"{tuple(dst.shape)} {dst.dtype}")
        if words.get_device() != device or dst.get_device() != device:
            raise ValueError(f"bitpack_decode_into operands on two devices: "
                             f"{words.device}, {dst.device}")
    return out_dtype


def bitpack_decode_into(blocks: Sequence[BitpackBlock],
                        dests: Sequence[torch.Tensor], n: int) -> None:
    """Decode each block's n rows into its destination (a strided (n,)
    view, all of one dtype): on the card one launch per MAX_BITPACK_COLUMNS
    blocks, each counted."""
    n = int(n)
    # the card's test first: cheaper than on_cpu on this per-step path
    # (_check_bitpack checks one device; on_cpu raises on a CPU mix)
    if not (all(d.is_cuda for d in dests)
            and all(b.words.is_cuda for b in blocks)) \
            and on_cpu(*(b.words for b in blocks), *dests):
        bitpack_decode_into_plain(blocks, dests, n)
        return
    out_dtype = _check_bitpack(blocks, dests, n)
    if n == 0:
        return
    word = _word(_OP_BITPACK, n, 0, out_dtype)
    stream = _build.stream_handle(dests[0].device)
    for i in range(0, len(blocks), MAX_BITPACK_COLUMNS):
        part = slice(i, i + MAX_BITPACK_COLUMNS)
        descs = pack_bitpack_descriptors(blocks[part], dests[part])
        rc = _build.kernel_fn("bitpack")(descs.ctypes.data, len(descs), n,
                                         word, stream)
        if rc:
            _build.check_launch("bitpack_decode", rc)
        count_launch(LAUNCHES, "bitpack_decode")


def rle_decode(run_values: torch.Tensor, run_ends: torch.Tensor,
               n: int) -> torch.Tensor:
    if on_cpu(run_values, run_ends):
        return rle_decode_plain(run_values, run_ends, n)
    out = torch.empty(int(n), dtype=run_values.dtype,
                      device=run_values.device)
    rle_decode_into(run_values, run_ends, n, out)
    return out


def rle_odt(values_dtype: torch.dtype, orig_dtype: torch.dtype) -> int:
    """decode.cu's code of the cast an RLE value takes before the
    destination's: integer values to their original integer dtype; any
    other original dtype (a float, bool) holds the values exactly, so they
    keep them."""
    if orig_dtype is None or values_dtype.is_floating_point:
        return RLE_KEEP
    return BITPACK_ORIG_CODES.get(orig_dtype, RLE_KEEP)


def _check_rle(run_values: torch.Tensor, run_ends: torch.Tensor, n: int,
               dst: torch.Tensor) -> None:
    """What decode.cu cannot see: dtypes, ranks, contiguity, sizes, the
    destination's stride, one device."""
    _check_table(run_values, "run_values")
    _check_int32(run_ends, "run_ends")
    if run_ends.shape[0] != run_values.shape[0]:
        raise ValueError(f"{run_values.shape[0]} run values but "
                         f"{run_ends.shape[0]} run ends")
    if dst.dtype not in _TABLE_CODES or dst.dim() != 1 \
            or dst.shape[0] != n or not 1 <= dst.stride(0) < 2 ** 31:
        raise ValueError(f"the destination must be a ({n},) int32, int64, "
                         f"float32 or float64 vector of positive stride, got "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if not n < 2 ** 31:
        raise ValueError(f"rle_decode takes fewer than 2**31 positions, got "
                         f"{n}")
    if not (run_values.get_device() == run_ends.get_device()
            == dst.get_device()):
        raise ValueError(f"rle_decode operands on two devices: "
                         f"{run_values.device}, {run_ends.device}, "
                         f"{dst.device}")


def rle_decode_into(run_values: torch.Tensor, run_ends: torch.Tensor, n: int,
                    dst: torch.Tensor, orig_dtype: torch.dtype = None) -> None:
    """Decode n positions into `dst` (a strided (n,) view of int32, int64,
    float32 or float64): on the card one launch, counted as rle_decode."""
    n = int(n)
    # the card's test first: cheaper than on_cpu on this per-step path
    if not (dst.is_cuda and run_values.is_cuda and run_ends.is_cuda) \
            and on_cpu(run_values, run_ends, dst):
        rle_decode_into_plain(run_values, run_ends, n, dst, orig_dtype)
        return
    _check_rle(run_values, run_ends, n, dst)
    if n:     # no runs is decode.cu's to refuse
        r = run_values.shape[0]
        _launch_decode("rle_decode", run_ends, run_values, dst, n, r,
                       rle_word(n, run_values.dtype, dst.dtype,
                                rle_odt(run_values.dtype, orig_dtype),
                                dst.stride(0)))


def fused_decode_scan(codes: torch.Tensor, dictionary: torch.Tensor,
                      agg_col: torch.Tensor, lo, hi) -> torch.Tensor:
    # the card's test first: cheaper than on_cpu on this per-partition path
    if not (codes.is_cuda and dictionary.is_cuda and agg_col.is_cuda) \
            and on_cpu(codes, dictionary, agg_col):
        return fused_decode_scan_plain(codes, dictionary, agg_col, lo, hi)
    out = launch_scan("fused_decode_scan", codes, dictionary, agg_col, lo, hi)
    count_launch(LAUNCHES, "fused_decode_scan")
    return out
