"""CPU-efficient columnar compression schemes (paper §3.2–3.3).

Shark compresses each column *per partition*, choosing the scheme from local
metadata collected during the load task — no global coordination — so the
load phase keeps maximum parallelism.  We reproduce the three schemes the
paper names (dictionary encoding, run-length encoding, bit packing) plus the
PLAIN fallback, and the local per-partition selection heuristic.

Encoding happens host-side at load (numpy) and is byte-identical to the
JAX reference's.  `decode_np` is the host decode; `decode_torch` decodes
onto a torch device from the block's memoized device streams, through the
decode kernels on the GPU.  On the GPU, compression is a *bandwidth*
optimization: a kernel that reads codes instead of values (the fused
dictionary-decode scan) moves fewer HBM bytes by the compression ratio.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class Encoding(enum.Enum):
    PLAIN = "plain"
    DICT = "dict"        # code stream + value dictionary
    RLE = "rle"          # (run value, run length) streams
    BITPACK = "bitpack"  # ints packed to minimal bit width in uint32 words
    FOR = "for"          # frame of reference: (value - bias) in a narrow uint lane


# ---------------------------------------------------------------------------
# Selection heuristic (paper: "the loading task will compress a column using
# dictionary encoding if its number of distinct values is below a threshold";
# each task decides locally, per partition).
# ---------------------------------------------------------------------------

DICT_DISTINCT_THRESHOLD = 4096
RLE_MIN_AVG_RUN = 4.0
BITPACK_MAX_BITS = 16


# Bumped after every decode memo is set or released, so a reader that
# sums the memos' bytes (the server's MemoryManager, on every block put)
# can keep its last sum until a memo changes.
DECODE_MEMO_CHANGES = [0]


@dataclasses.dataclass
class Encoded:
    encoding: Encoding
    # PLAIN: data; DICT: codes + dictionary; RLE: values + lengths; BITPACK:
    # words + bit width + original length + bias.
    data: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    dictionary: Optional[np.ndarray] = None
    run_values: Optional[np.ndarray] = None
    run_lengths: Optional[np.ndarray] = None
    words: Optional[np.ndarray] = None
    bit_width: int = 0
    bias: int = 0
    n: int = 0
    orig_dtype: Optional[np.dtype] = None
    # Memoized decode: a query typically touches the same block several
    # times (scan predicate, then projection, then aggregation argument);
    # the first decode_np caches here and later calls are free.  The
    # MemoryManager calls drop_decoded() under cache pressure — the cache
    # is pure derived state, so dropping it is always safe.
    _decoded: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    decode_count: int = dataclasses.field(default=0, repr=False, compare=False)
    # (distinct values, int32 group id per row) of the decoded values
    # (`ColumnBlock.group_space`): host state derived from the decode memo,
    # dropped with it and, like it, outside `nbytes`.
    _group_space: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    # True once `recompress` returned this block unchanged: it is its own
    # recompression (the choice is a function of the block alone), so the
    # storage tier's WARM pass need not decode it again to learn that.
    _settled: bool = dataclasses.field(default=False, repr=False,
                                       compare=False)
    # Device residency of kernel operands: torch copies of this block's
    # arrays on the session's device, keyed by (what, device) and filled by
    # ColumnBlock.device_array.  Like the decode memo it is derived state
    # outside `nbytes`; drop_device() releases it when the block's encoding
    # changes or the block leaves memory (the decode-memo rung leaves it).
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)
    # True once the block's partition went cold (`Partition.release_columns`):
    # a cached scan batch may still read the block, but its device copies
    # are made for the call and never memoized, so the card keeps nothing
    # of a cold partition.
    _cold: bool = dataclasses.field(default=False, repr=False, compare=False)

    @property
    def nbytes(self) -> int:
        total = 0
        for a in (self.data, self.codes, self.dictionary, self.run_values,
                  self.run_lengths, self.words):
            if a is not None:
                total += a.nbytes
        return total

    @property
    def decoded_nbytes(self) -> int:
        """Bytes currently held by the memoized decode cache."""
        return self._decoded.nbytes if self._decoded is not None else 0

    def drop_decoded(self) -> int:
        """Release the memoized host decoded array (and the group space
        derived from it); returns bytes freed.  The device memo stays (see
        drop_device)."""
        freed = self.decoded_nbytes
        self._decoded = None
        self._group_space = None
        if freed:
            DECODE_MEMO_CHANGES[0] += 1
        return freed

    def drop_device(self) -> None:
        """Release the memoized device copies of this block's streams."""
        self._device.clear()


def _avg_run_length(values: np.ndarray) -> float:
    if len(values) == 0:
        return 0.0
    changes = int(np.count_nonzero(values[1:] != values[:-1])) + 1
    return len(values) / changes


def choose_encoding(values: np.ndarray) -> Encoding:
    """Local, per-partition scheme selection from column metadata."""
    if values.size == 0:
        return Encoding.PLAIN
    if _avg_run_length(values) >= RLE_MIN_AVG_RUN:
        return Encoding.RLE
    if np.issubdtype(values.dtype, np.integer):
        lo, hi = int(values.min()), int(values.max())
        span = hi - lo
        if span >= 0 and span < (1 << BITPACK_MAX_BITS):
            return Encoding.BITPACK
    distinct = len(np.unique(values[: 65536]))  # sample-bounded, like a load task would
    if distinct <= DICT_DISTINCT_THRESHOLD:
        return Encoding.DICT
    return Encoding.PLAIN


def _for_lane_dtype(span: int) -> Optional[np.dtype]:
    """Narrowest unsigned lane that holds codes in [0, span]."""
    if span < (1 << 8):
        return np.dtype(np.uint8)
    if span < (1 << 16):
        return np.dtype(np.uint16)
    if span < (1 << 32):
        return np.dtype(np.uint32)
    return None


def choose_recompression(values: np.ndarray,
                         ndv: Optional[int] = None) -> Encoding:
    """Adaptive scheme selection for the storage tier's WARM transition
    (DESIGN.md §12): unlike the load-time `choose_encoding`, this ranks
    candidate schemes by *projected encoded size* so a pressure-driven
    recompression only ever shrinks the block.  Signals are the same
    piggybacked statistics the store already keeps: run length (RLE),
    value span (frame-of-reference / bit packing), and NDV (dictionary).
    """
    n = len(values)
    if n == 0:
        return Encoding.PLAIN
    itemsize = values.dtype.itemsize
    sizes = {Encoding.PLAIN: n * itemsize}
    changes = int(np.count_nonzero(values[1:] != values[:-1])) + 1
    if n / changes >= RLE_MIN_AVG_RUN:
        sizes[Encoding.RLE] = changes * (itemsize + 4)
    if np.issubdtype(values.dtype, np.integer):
        span = int(values.max()) - int(values.min())
        lane = _for_lane_dtype(span)
        if lane is not None:
            sizes[Encoding.FOR] = n * lane.itemsize
        if 0 <= span < (1 << BITPACK_MAX_BITS):
            width = max(1, span.bit_length())
            sizes[Encoding.BITPACK] = -(-n // (32 // width)) * 4
    if ndv is None:
        ndv = len(np.unique(values[: 65536]))
    if ndv <= DICT_DISTINCT_THRESHOLD:
        sizes[Encoding.DICT] = n * 4 + ndv * itemsize
    # ties break toward schemes the engine can execute on directly without
    # widening (run-level RLE scans, FOR/DICT code-bound predicates) —
    # BITPACK must be unpacked before any compare
    pref = {Encoding.RLE: 0, Encoding.FOR: 1, Encoding.DICT: 2,
            Encoding.BITPACK: 3, Encoding.PLAIN: 4}
    return min(sizes, key=lambda e: (sizes[e], pref[e]))


def recompress(enc: Encoded) -> Encoded:
    """Re-encode a block with the adaptively chosen scheme.  Returns a NEW
    Encoded strictly smaller than the input, or the input unchanged when no
    candidate wins.  Never changes decoded content (round-trip property,
    tests/test_storage_property.py)."""
    values = decode_np(enc)
    ndv = len(enc.dictionary) if enc.dictionary is not None else None
    target = choose_recompression(values, ndv=ndv)
    if target == enc.encoding:
        return enc
    out = encode(values, target)
    return out if out.nbytes < enc.nbytes else enc


# ---------------------------------------------------------------------------
# Encoders (host side, run inside data-loading tasks)
# ---------------------------------------------------------------------------

def encode(values: np.ndarray, encoding: Optional[Encoding] = None) -> Encoded:
    if encoding is None:
        encoding = choose_encoding(values)
    n = len(values)
    if encoding == Encoding.PLAIN:
        return Encoded(Encoding.PLAIN, data=values, n=n, orig_dtype=values.dtype)
    if encoding == Encoding.DICT:
        dictionary, codes = np.unique(values, return_inverse=True)
        return Encoded(Encoding.DICT, codes=codes.astype(np.int32),
                       dictionary=dictionary, n=n, orig_dtype=values.dtype)
    if encoding == Encoding.RLE:
        if n == 0:
            return Encoded(Encoding.RLE, run_values=values,
                           run_lengths=np.zeros(0, np.int32), n=0,
                           orig_dtype=values.dtype)
        boundaries = np.flatnonzero(values[1:] != values[:-1]) + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [n]])
        return Encoded(Encoding.RLE, run_values=values[starts],
                       run_lengths=(ends - starts).astype(np.int32), n=n,
                       orig_dtype=values.dtype)
    if encoding == Encoding.FOR:
        assert np.issubdtype(values.dtype, np.integer), "frame-of-reference needs ints"
        lo = int(values.min()) if n else 0
        span = (int(values.max()) - lo) if n else 0
        lane = _for_lane_dtype(span)
        assert lane is not None, f"span {span} too wide for frame-of-reference"
        codes = (values.astype(np.int64) - lo).astype(lane)
        return Encoded(Encoding.FOR, codes=codes, bias=lo, n=n,
                       orig_dtype=values.dtype)
    if encoding == Encoding.BITPACK:
        assert np.issubdtype(values.dtype, np.integer), "bitpack needs ints"
        lo = int(values.min()) if n else 0
        shifted = (values.astype(np.int64) - lo).astype(np.uint32)
        span = int(shifted.max()) if n else 0
        width = max(1, int(span).bit_length())
        per_word = 32 // width
        n_words = -(-n // per_word) if n else 0
        padded = np.zeros(n_words * per_word, np.uint32)
        padded[:n] = shifted
        lanes = padded.reshape(n_words, per_word)
        shifts = (np.arange(per_word, dtype=np.uint32) * width)
        words = np.bitwise_or.reduce(lanes << shifts[None, :], axis=1)
        return Encoded(Encoding.BITPACK, words=words.astype(np.uint32),
                       bit_width=width, bias=lo, n=n, orig_dtype=values.dtype)
    raise ValueError(encoding)


# ---------------------------------------------------------------------------
# Decoders — host numpy (memoized ground truth) and torch (device).
# ---------------------------------------------------------------------------

def decode_np(enc: Encoded) -> np.ndarray:
    """Host-side decode (ground truth), memoized on the Encoded.

    PLAIN blocks return the stored array directly (no copy, nothing to
    cache); every other scheme materializes once and caches the result on
    the block until `drop_decoded()` releases it."""
    if enc.encoding == Encoding.PLAIN:
        return enc.data
    if enc._decoded is not None:
        return enc._decoded
    enc.decode_count += 1
    # encoded-pipeline promise (DESIGN.md §15): paths that claim to hand
    # encoded blocks straight to the device must never reach this point — the
    # counters make the claim assertable (expr.DECODE_COUNTERS).
    from .expr import DECODE_COUNTERS
    DECODE_COUNTERS["numeric_blocks"] += 1
    DECODE_COUNTERS["numeric_rows"] += int(enc.n)
    if enc.encoding == Encoding.DICT:
        out = enc.dictionary[enc.codes]
    elif enc.encoding == Encoding.FOR:
        out = (enc.codes.astype(np.int64) + enc.bias).astype(enc.orig_dtype)
    elif enc.encoding == Encoding.RLE:
        out = np.repeat(enc.run_values, enc.run_lengths)
    elif enc.encoding == Encoding.BITPACK:
        width, per_word = enc.bit_width, 32 // enc.bit_width
        shifts = (np.arange(per_word, dtype=np.uint32) * width)
        lanes = (enc.words[:, None] >> shifts[None, :]) & np.uint32((1 << width) - 1)
        flat = lanes.reshape(-1)[: enc.n].astype(np.int64) + enc.bias
        out = flat.astype(enc.orig_dtype)
    else:
        raise ValueError(enc.encoding)
    enc._decoded = out
    DECODE_MEMO_CHANGES[0] += 1
    return out


_KERNEL_DTYPES = ("int32", "int64", "float32", "float64")


def _stream(enc: Encoded, what: str) -> np.ndarray:
    """Encoded stream `what` of `enc` as the device decoders take it: uint32
    words as int32 bits (torch has no CPU `>>` for uint32), wider unsigned
    codes as int64, dictionaries and run values in a dtype the kernels read
    (narrower numbers widen exactly to int64 / float64), run lengths as
    their int32 cumulative ends."""
    if what == "data":
        return enc.data
    if what == "codes":
        c = enc.codes
        return c.astype(np.int64) if c.dtype.kind == "u" and c.itemsize > 1 \
            else c
    if what == "words":
        return enc.words.view(np.int32)
    if what in ("dictionary", "run_values"):
        v = getattr(enc, what)
        if v.dtype.name in _KERNEL_DTYPES:
            return v
        return v.astype(np.float64 if v.dtype.kind == "f" else np.int64)
    if what == "run_ends":
        return np.cumsum(enc.run_lengths, dtype=np.int64).astype(np.int32)
    raise ValueError(what)


def device_stream(enc: Encoded, what: str, device):
    """Encoded stream `what` ("data", "codes", "dictionary", "words",
    "run_values" or "run_ends") as a torch tensor on
    `device`, copied there once and memoized on the block (`enc._device`;
    a block of a cold partition memoizes nothing), so every later decode
    reads it from device memory.  On the CPU the
    tensor shares the numpy array's memory where the dtype allows."""
    import torch
    key = (what, str(device))
    t = enc._device.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(_stream(enc, what))).to(
            device)
        if not enc._cold:
            enc._device[key] = t
    return t


def decode_torch(enc: Encoded, device="cpu"):
    """Decode onto a torch device (output length = enc.n), in the block's
    original dtype: the device twin of `decode_np`.  It reads the block's
    memoized device streams and never the host decode, so
    `expr.DECODE_COUNTERS` stay still.  DICT, BITPACK and RLE blocks go
    through the `dict_decode`, `bitpack_decode` and `rle_decode` kernels on
    a CUDA device (their plain versions on the CPU; bit-pack through
    `bitpack_decode_into`, one launch); FOR is `codes + bias` and PLAIN the
    stored array."""
    import torch

    from ..kernels import ops

    out_dtype = torch.from_numpy(np.zeros(0, enc.orig_dtype)).dtype

    def s(what):
        return device_stream(enc, what, device)

    if enc.encoding == Encoding.PLAIN:
        return s("data")
    if enc.n == 0:
        return torch.empty(0, dtype=out_dtype, device=device)
    if enc.encoding == Encoding.DICT:
        return ops.dict_decode(s("codes"), s("dictionary")).to(out_dtype)
    if enc.encoding == Encoding.FOR:
        return (s("codes").to(torch.int64) + int(enc.bias)).to(out_dtype)
    if enc.encoding == Encoding.RLE:
        return ops.rle_decode(s("run_values"), s("run_ends"),
                              enc.n).to(out_dtype)
    if enc.encoding == Encoding.BITPACK:
        # one launch: each lane plus the int64 bias (which may not fit in
        # int32), cast to the original dtype, as decode_np does; the
        # kernel writes int32 or int64, so a narrower or unsigned block
        # takes the exact int64 values and a cast
        block = bitpack_block(enc, device)
        if out_dtype not in (torch.int32, torch.int64):
            block = block._replace(dtype=torch.int64)
        out = torch.empty(enc.n, dtype=block.dtype, device=device)
        ops.bitpack_decode_into([block], [out], enc.n)
        return out.to(out_dtype)
    raise ValueError(enc.encoding)


def rle_decode_into(enc: Encoded, dst, device) -> None:
    """An RLE block decoded into `dst` (a strided (n,) view of int32,
    int64, float32 or float64 on `device`): the values of
    `dst.copy_(decode_torch(enc, device))`, in one `rle_decode` launch on a
    CUDA device, each run value cast to the block's original dtype, then
    to dst's."""
    import torch

    from ..kernels import ops
    ops.rle_decode_into(device_stream(enc, "run_values", device),
                        device_stream(enc, "run_ends", device), enc.n, dst,
                        torch.from_numpy(np.zeros(0, enc.orig_dtype)).dtype)


def bitpack_block(enc: Encoded, device):
    """A BITPACK block as the bit-pack kernel's operand
    (`dictdecode.BitpackBlock`), its words read from device memory."""
    import torch

    from ..kernels.dictdecode import BitpackBlock
    return BitpackBlock(device_stream(enc, "words", device),
                        int(enc.bit_width), int(enc.bias),
                        torch.from_numpy(np.zeros(0, enc.orig_dtype)).dtype)


def compression_ratio(enc: Encoded) -> float:
    raw = enc.n * (np.dtype(enc.orig_dtype).itemsize if enc.orig_dtype else 4)
    return raw / max(enc.nbytes, 1)
