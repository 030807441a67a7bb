"""The torch port's columnar compression against the JAX reference's.

Encodings must be byte-identical (so both engines scan the same blocks),
the adaptive recompression and load-time scheme choice must agree, and
`decode_torch` must reproduce `decode_np` exactly, on inputs made from a
seed with numpy.
"""

import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro_torch.core import compression as tc

ARRAY_FIELDS = ("data", "codes", "dictionary", "run_values", "run_lengths",
                "words")
SCALAR_FIELDS = ("bit_width", "bias", "n", "orig_dtype")


def _values(kind: str, dtype, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "runs":
        return np.repeat(rng.integers(-5, 5, 100), 10).astype(dtype)
    if kind == "narrow":
        return rng.integers(-100, 100, 1000).astype(dtype)
    if kind == "wide":
        return rng.integers(-2 ** 30, 2 ** 30, 1000).astype(dtype)
    return rng.integers(0, 1, 0).astype(dtype)            # empty


def assert_same_encoding(a, b) -> None:
    assert a.encoding.value == b.encoding.value
    for f in ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            assert x.tobytes() == y.tobytes(), f
    for f in SCALAR_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


ENCODINGS = ["plain", "dict", "rle", "bitpack", "for"]


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["runs", "narrow"])
def test_int_encodings_byte_identical(encoding, dtype, kind):
    v = _values(kind, dtype, seed=len(encoding))
    a = jc.encode(v, jc.Encoding(encoding))
    b = tc.encode(v, tc.Encoding(encoding))
    assert_same_encoding(a, b)
    np.testing.assert_array_equal(tc.decode_np(b), v)
    got = tc.decode_torch(b)
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(got.numpy(), jc.decode_np(a))


@pytest.mark.parametrize("encoding", ["plain", "dict", "rle"])
def test_float_encodings_byte_identical(encoding):
    v = np.round(np.random.default_rng(1).normal(size=500), 2)
    a = jc.encode(v, jc.Encoding(encoding))
    b = tc.encode(v, tc.Encoding(encoding))
    assert_same_encoding(a, b)
    np.testing.assert_array_equal(tc.decode_torch(b).numpy(), v)


@pytest.mark.parametrize("kind", ["runs", "narrow", "wide", "empty"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_scheme_choice_matches(kind, dtype):
    v = _values(kind, dtype, seed=7)
    assert tc.choose_encoding(v).value == jc.choose_encoding(v).value
    assert_same_encoding(jc.encode(v), tc.encode(v))
    if len(v):
        assert (tc.choose_recompression(v).value
                == jc.choose_recompression(v).value)
        a = jc.recompress(jc.encode(v))
        b = tc.recompress(tc.encode(v))
        assert_same_encoding(a, b)


def test_device_memo_dropped_with_decode_cache():
    from repro_torch.core.columnar import make_block
    from repro_torch.core.types import DType, Field
    v = np.repeat(np.arange(40, dtype=np.int64), 3)[::-1].copy()
    blk = make_block(Field("x", DType.INT64), v, tc.Encoding.DICT)
    codes = blk.device_array("codes", "cpu")
    assert blk.device_array("codes", "cpu") is codes       # memoized
    np.testing.assert_array_equal(
        blk.device_array("dictionary", "cpu")[codes.long()].numpy(), v)
    np.testing.assert_array_equal(blk.device_array("values", "cpu").numpy(),
                                  v)
    before = blk.nbytes
    blk.drop_decoded()
    assert blk.enc._device == {} and blk.nbytes == before
