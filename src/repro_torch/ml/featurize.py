"""Encoded feature pipelines (paper §4.1 Listing 1; DESIGN.md §15.1).

`table_rdd_to_features` turns a SQL result RDD — or a lazy `SharkFrame`
directly — into a `FeatureRDD`: a narrow map on the same lineage graph
whose partitions are NOT dense matrices but pass-through references to the
source's encoded column blocks.  Training consumes them by decoding each
block on the session's device, from streams copied there once and
memoized on the block (`compression.decode_torch`: the `dict_decode` and
`rle_decode` kernels on the GPU, and one `bitpack_decode` launch for all
of a partition's BITPACK blocks), writing each into its column of the
feature matrix there and running the train step — so the host never
materializes a feature column on the encoded path.  That claim is
assertable: `expr.DECODE_COUNTERS["numeric_blocks"]` stays untouched
(decode_np is never reached).

Why it matters: a cached FeatureRDD partition is byte-accounted at its
ENCODED size, so the working set that fits in cache is the compressed
one — the same in-memory-columnar economics the SQL engine gets, now for
the ML tier.

Dtype policy: feature matrices default to float32 with a `dtype=` escape
hatch (e.g. `np.float64` for the differential parity tests).  Labels are
never silently pushed through float32: the label column keeps its source
dtype end to end (an int64 label stays int64, exact), and the train step
casts it to the compute dtype.

`as_features_rdd` is the dispatch helper the estimators use to accept a
SharkFrame, a TableRDD + column names, or an already-featurized RDD.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batch import PartitionBatch
from ..core.compression import (Encoding, bitpack_block, decode_torch,
                                rle_decode_into)
from ..core.expr import ColumnVal, to_tensor, torch_dtype
from ..core.frame import SharkFrame
from ..core.rdd import OneToOneDependency, RDD, TaskContext
from ..kernels import ops
from ..kernels.train_grad import stable_sigmoid


class FeatureRDD(RDD):
    """Feature partitions that stay encoded.

    compute() selects the feature/label ColumnVals from the parent batch
    WITHOUT touching `.arr`: block-backed columns ride through still
    encoded, so caching this RDD stores (and byte-accounts) compressed
    blocks, and the train step decodes them on the device.

    A user `map_rows` callable is a host-side black box, so that variant
    falls back to the legacy dense layout ('features' matrix + 'label'),
    materialized once at featurization time.
    """

    def __init__(self, parent: RDD, feature_cols: Sequence[str],
                 label_col: Optional[str] = None,
                 map_rows: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 dtype=np.float32):
        self.feature_cols = list(feature_cols)
        self.label_col = label_col
        self.map_rows = map_rows
        self.dtype = np.dtype(dtype)
        super().__init__(parent.ctx, parent.num_partitions,
                         [OneToOneDependency(parent)])

    def compute(self, split: int, tc: TaskContext) -> PartitionBatch:
        batch = self.deps[0].parent.iterator(split, tc)
        for c in self.feature_cols:
            if batch.col(c).is_string:
                raise ValueError(
                    f"feature column {c!r} is a string column; encode it "
                    f"numerically (e.g. dictionary codes via SQL) first")
        if self.map_rows is not None:
            x = np.stack(
                [np.asarray(batch.col(c).arr).astype(self.dtype)
                 for c in self.feature_cols], axis=1) \
                if self.feature_cols else \
                np.zeros((batch.num_rows, 0), self.dtype)
            x = np.asarray(self.map_rows(x), dtype=self.dtype)
            out = {"features": ColumnVal(x)}
            if self.label_col is not None:
                # source dtype preserved: int64 labels stay int64 exactly
                out["label"] = ColumnVal(
                    np.asarray(batch.col(self.label_col).arr))
            return PartitionBatch(out)
        needed = list(self.feature_cols)
        if self.label_col is not None and self.label_col not in needed:
            needed.append(self.label_col)
        return PartitionBatch({c: batch.col(c) for c in needed})


def table_rdd_to_features(rdd, feature_cols: Sequence[str],
                          label_col: Optional[str] = None,
                          map_rows: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                          dtype=np.float32) -> RDD:
    """FeatureRDD over a TableRDD or lazy SharkFrame (compiled via
    `.to_rdd()`, same lineage graph) — the paper's ML pipeline step (2),
    as a narrow map whose partitions stay encoded (module docstring)."""
    if isinstance(rdd, SharkFrame):
        # the frame validates eagerly (FrameBindError naming the column)
        # instead of a raw KeyError inside a partition task
        return rdd.to_features(feature_cols, label_col, map_rows,
                               dtype=dtype)
    return FeatureRDD(rdd, feature_cols, label_col, map_rows, dtype)


def as_features_rdd(data, feature_cols: Optional[Sequence[str]] = None,
                    label_col: Optional[str] = None,
                    map_rows: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                    dtype=np.float32) -> RDD:
    """Normalize an estimator's input to a features RDD.

    * SharkFrame -> featurized via `table_rdd_to_features` (feature_cols
      defaults to every column except `label_col`);
    * RDD with `feature_cols` given -> featurized likewise;
    * RDD without `feature_cols` -> assumed already featurized (a
      FeatureRDD, or legacy partitions carrying 'features' / 'label'),
      returned as-is.
    """
    if isinstance(data, SharkFrame):
        cols = (list(feature_cols) if feature_cols is not None
                else [c for c in data.columns if c != label_col])
        return table_rdd_to_features(data, cols, label_col, map_rows, dtype)
    if feature_cols is not None:
        return table_rdd_to_features(data, feature_cols, label_col,
                                     map_rows, dtype)
    return data


# -- encoded block -> device decode recipes (DESIGN.md §15.1) ------------
#
# A recipe is (signature, args): the signature keys the step cache
# (encoding scheme + the ints the decode needs), the args are what the
# step decodes — the encoded block itself, whose streams live in device
# memory after the first step, or a dense tensor on the device.

def column_recipe(v: ColumnVal, device) -> Tuple[tuple, tuple]:
    """Recipe handing one column to the train step, decoded on `device`.
    Materialized columns degrade to a dense hand-off of whatever array
    already exists, copied to the device."""
    if (not v.materialized) and v.block is not None and v.sdict is None:
        enc = v.block.enc
        e = enc.encoding
        if e == Encoding.PLAIN:
            return ("plain",), (enc,)
        if e == Encoding.DICT:
            return ("dict",), (enc,)
        if e == Encoding.FOR:
            return ("for", str(np.dtype(enc.orig_dtype))), (enc,)
        if e == Encoding.RLE:
            return ("rle", int(enc.n)), (enc,)
        if e == Encoding.BITPACK:
            return (("bitpack", int(enc.bit_width), int(enc.n),
                     str(np.dtype(enc.orig_dtype))), (enc,))
    return ("dense",), (to_tensor(np.asarray(v.arr), device),)


def _decode_on_device(sig: tuple, args, device) -> torch.Tensor:
    """One column of the step on `device`: dense tensors as they are,
    encoded blocks through `compression.decode_torch`."""
    if sig[0] in ("dense", "mat"):
        return args[0]
    return decode_torch(args[0], device)


def _rows(sig: tuple, args) -> int:
    return int(args[0].shape[0]) if sig[0] == "dense" else int(args[0].n)


def _assemble(sigs: tuple, col_args, label_sig, label_args, dt, dev):
    """(x (n, d), y (n,) or None) in `dt` on `dev`, in one allocation.  One
    `bitpack_decode_into` call writes every BITPACK block, features and
    label, straight into its column, and one `rle_decode_into` call each
    RLE block; every other column is decoded as `decode_torch` does and
    placed with one cast-and-copy.  The values are those of
    `decode_torch(enc).to(dt)` stacked."""
    n, d = _rows(sigs[0], col_args[0]), len(sigs)
    buf = torch.empty(n * (d + (label_sig is not None)), dtype=dt,
                      device=dev)
    x = buf[:n * d].view(n, d)
    y = buf[n * d:] if label_sig is not None else None
    targets = [(s, a, x[:, j]) for j, (s, a) in enumerate(zip(sigs,
                                                               col_args))]
    if y is not None:
        targets.append((label_sig, label_args, y))
    packed = [(bitpack_block(a[0], dev), dst) for s, a, dst in targets
              if s[0] == "bitpack"]
    if packed:
        blocks, dests = zip(*packed)
        ops.bitpack_decode_into(blocks, dests, n)
    for s, a, dst in targets:
        if s[0] == "rle":
            rle_decode_into(a[0], dst, dev)
        elif s[0] != "bitpack":
            dst.copy_(_decode_on_device(s, a, dev))
    return x, y


def partition_recipes(batch: PartitionBatch,
                      feature_cols: Optional[Sequence[str]],
                      label_col: Optional[str], device):
    """(sigs, col_args, label_sig, label_args) for one feature partition.

    Legacy dense partitions ('features' matrix) get the single ("mat",)
    recipe — already-materialized, handed through as one 2-D tensor."""
    if "features" in batch.cols:
        x = to_tensor(np.asarray(batch.col("features").arr), device)
        sigs, col_args = (("mat",),), ((x,),)
        if "label" in batch.cols:
            lsig, largs = column_recipe(batch.col("label"), device)
        else:
            lsig, largs = None, ()
        return sigs, col_args, lsig, largs
    sigs, col_args = [], []
    for c in feature_cols or []:
        s, a = column_recipe(batch.col(c), device)
        sigs.append(s)
        col_args.append(a)
    if label_col is not None:
        lsig, largs = column_recipe(batch.col(label_col), device)
    else:
        lsig, largs = None, ()
    return tuple(sigs), tuple(col_args), lsig, largs


# -- fused assemble+train step cache -------------------------------------

_FUSED_CACHE: dict = {}


def fused_train_step(kind: str, sigs: tuple, label_sig, dtype) -> Callable:
    """One step function per (estimator kind, partition signature): decode
    every encoded column on the device of `params` into the feature
    matrix (`_assemble`: one call for all BITPACK blocks), and run the
    train step there — the host never sees a decoded column.

    kinds: "logistic" / "linear" -> summed gradient (d,);
           "kmeans"              -> (per-centroid sums, counts, objective);
           "assemble"            -> (x, y) on the device, for the
                                    `train_grad` kernel route.
    """
    key = (kind, sigs, label_sig, str(np.dtype(dtype)))
    fn = _FUSED_CACHE.get(key)
    if fn is not None:
        return fn
    dt = torch_dtype(dtype)
    dense_mat = bool(sigs) and sigs[0][0] == "mat"

    def step(params, col_args, label_args):
        dev = params.device
        if sigs and not dense_mat:
            x, y = _assemble(sigs, col_args, label_sig, label_args, dt, dev)
        else:
            x = (_decode_on_device(sigs[0], col_args[0], dev).to(dt)
                 if dense_mat else torch.zeros((0, 0), dtype=dt, device=dev))
            y = (_decode_on_device(label_sig, label_args, dev).to(dt)
                 if label_sig is not None else None)
        if kind == "assemble":
            return x, y
        if kind in ("logistic", "linear"):
            # products and sums in torch's own reductions rather than a
            # BLAS call, whose split of a sum can follow the threads it
            # finds free: the step gives the same bits on every run, so a
            # model recovered from lineage equals the failure-free one
            z = torch.sum(x * params.to(dt), dim=1)
            r = (stable_sigmoid(z) if kind == "logistic" else z) - y
            return torch.sum(x * r[:, None], dim=0)
        if kind == "kmeans":
            c = params.to(dt)
            x2 = torch.sum(x * x, dim=1, keepdim=True)
            c2 = torch.sum(c * c, dim=1)
            d2 = x2 - 2.0 * (x @ c.T) + c2[None, :]
            assign = torch.argmin(d2, dim=1)
            obj = torch.sum(torch.min(d2, dim=1).values)
            onehot = torch.nn.functional.one_hot(assign, c.shape[0]).to(dt)
            return onehot.T @ x, torch.sum(onehot, dim=0), obj
        raise ValueError(kind)

    _FUSED_CACHE[key] = step
    return step


def partition_xy_host(batch: PartitionBatch,
                      feature_cols: Optional[Sequence[str]],
                      label_col: Optional[str], dtype=np.float32):
    """Host-materialized (x, y) — the numpy-oracle route and the loss
    helpers.  Decodes through decode_np (counters bump: this is exactly
    the path the encoded pipeline avoids)."""
    if "features" in batch.cols:
        x = np.asarray(batch.col("features").arr).astype(dtype)
        y = (np.asarray(batch.col("label").arr)
             if "label" in batch.cols else None)
        return x, y
    cols = [np.asarray(batch.col(c).arr).astype(dtype)
            for c in feature_cols or []]
    x = (np.stack(cols, axis=1) if cols
         else np.zeros((batch.num_rows, 0), dtype))
    y = (np.asarray(batch.col(label_col).arr)
         if label_col is not None else None)
    return x, y
