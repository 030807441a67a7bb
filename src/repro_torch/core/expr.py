"""Expression AST and compiler (paper §5, "Bytecode Compilation of Expression
Evaluators").

Hive interprets operator trees row-by-row; the paper reports that when data is
served from the memory store, the majority of CPU cycles go to interpreting
these evaluators, and proposes compiling them to JVM bytecode.  Our analogue
lowers the AST once per segment into one torch function over whole column
tensors on the session's device — the evaluator is compiled to vector
operations and shared by every partition with the same layout.

String semantics: STRING columns are dictionary codes + a partition-local
sorted dictionary.  Because `np.unique` dictionaries are sorted, code order
is lexicographic order, so string comparisons compile to *integer* compares
against a code bound resolved host-side per partition — the evaluator never
touches string bytes on device.  String functions (SUBSTR, LOWER, ...) are
evaluated once on the (small) dictionary and the codes are remapped — the
classic columnar trick, and the reason dictionary encoding is "virtually free
CPU-wise" (§3.2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .types import DType, Schema, common_dtype

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


class Expr:
    def columns(self) -> List[str]:
        out: List[str] = []
        self._collect(out)
        return out

    def _collect(self, out: List[str]) -> None:
        for child in self.children():
            child._collect(out)

    def children(self) -> Sequence["Expr"]:
        return ()

    # sugar
    def __add__(self, o): return BinOp("+", self, _lit(o))
    def __sub__(self, o): return BinOp("-", self, _lit(o))
    def __mul__(self, o): return BinOp("*", self, _lit(o))
    def __truediv__(self, o): return BinOp("/", self, _lit(o))
    def __mod__(self, o): return BinOp("%", self, _lit(o))
    def __eq__(self, o): return Cmp("=", self, _lit(o))   # type: ignore[override]
    def __ne__(self, o): return Cmp("!=", self, _lit(o))  # type: ignore[override]
    def __lt__(self, o): return Cmp("<", self, _lit(o))
    def __le__(self, o): return Cmp("<=", self, _lit(o))
    def __gt__(self, o): return Cmp(">", self, _lit(o))
    def __ge__(self, o): return Cmp(">=", self, _lit(o))
    def __and__(self, o): return And(self, o)
    def __or__(self, o): return Or(self, o)
    def __invert__(self): return Not(self)
    def __hash__(self):  # Exprs used as dict keys in planners
        return id(self)

    def alias(self, name: str) -> "Aliased":
        """Name this expression in a SharkFrame select/agg list."""
        return Aliased(name, self)


def _lit(v) -> "Expr":
    return v if isinstance(v, Expr) else Lit(v)


@dataclasses.dataclass(eq=False)
class Aliased:
    """An (output name, expression) pair produced by `Expr.alias()`.

    Not an Expr itself: it is only meaningful in a SharkFrame select/agg
    list (or a GROUP BY key), where the name becomes the output column."""
    name: str
    expr: "Expr"

    def __repr__(self): return f"{self.expr} AS {self.name}"


@dataclasses.dataclass(eq=False)
class Col(Expr):
    name: str

    def _collect(self, out: List[str]) -> None:
        out.append(self.name)

    def __repr__(self): return self.name


@dataclasses.dataclass(eq=False)
class Lit(Expr):
    value: Any

    def __repr__(self): return repr(self.value)


@dataclasses.dataclass(eq=False)
class BinOp(Expr):
    op: str  # + - * / %
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)
    def __repr__(self): return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(eq=False)
class Cmp(Expr):
    op: str  # = != < <= > >=
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)
    def __repr__(self): return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(eq=False)
class And(Expr):
    left: Expr
    right: Expr
    def children(self): return (self.left, self.right)
    def __repr__(self): return f"({self.left} AND {self.right})"


@dataclasses.dataclass(eq=False)
class Or(Expr):
    left: Expr
    right: Expr
    def children(self): return (self.left, self.right)
    def __repr__(self): return f"({self.left} OR {self.right})"


@dataclasses.dataclass(eq=False)
class Not(Expr):
    child: Expr
    def children(self): return (self.child,)
    def __repr__(self): return f"(NOT {self.child})"


@dataclasses.dataclass(eq=False)
class Func(Expr):
    """Scalar function call.  Numeric: ABS, FLOOR, CEIL, SQRT, LOG, EXP.
    String (dictionary-evaluated): SUBSTR, LOWER, UPPER, LENGTH."""
    name: str
    args: Tuple[Expr, ...]

    def children(self): return self.args
    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(eq=False)
class InList(Expr):
    child: Expr
    values: Tuple[Any, ...]
    def children(self): return (self.child,)
    def __repr__(self): return f"({self.child} IN {self.values})"


@dataclasses.dataclass(eq=False)
class Between(Expr):
    child: Expr
    lo: Any
    hi: Any
    def children(self): return (self.child,)
    def __repr__(self): return f"({self.child} BETWEEN {self.lo} AND {self.hi})"


STRING_FUNCS = {"SUBSTR", "LOWER", "UPPER", "CONCAT"}
NUMERIC_FUNCS = {"ABS", "FLOOR", "CEIL", "SQRT", "LOG", "EXP", "LENGTH", "YEAR"}


def infer_dtype(e: Expr, schema: Schema) -> DType:
    if isinstance(e, Col):
        return schema.dtype(e.name)
    if isinstance(e, Lit):
        v = e.value
        if isinstance(v, bool):
            return DType.BOOL
        if isinstance(v, (int, np.integer)):
            return DType.INT64
        if isinstance(v, (float, np.floating)):
            return DType.FLOAT64
        return DType.STRING
    if isinstance(e, BinOp):
        lt, rt = infer_dtype(e.left, schema), infer_dtype(e.right, schema)
        if e.op == "/":
            return DType.FLOAT64
        return common_dtype(lt, rt)
    if isinstance(e, (Cmp, And, Or, Not, InList, Between)):
        return DType.BOOL
    if isinstance(e, Func):
        if e.name in STRING_FUNCS:
            return DType.STRING
        if e.name == "LENGTH" or e.name == "YEAR":
            return DType.INT32
        return DType.FLOAT64
    raise TypeError(type(e))


# ---------------------------------------------------------------------------
# Evaluation context: per-partition columns as (array, optional string dict)
# ---------------------------------------------------------------------------


# Materialization counters.  The dictionary-preserving exchange
# (DESIGN.md §11) promises that shuffle/join/group paths never decode
# string columns to raw values; every ColumnVal.decoded() of a string
# column bumps string_cols/string_rows, so tests and
# benchmarks/shuffle_bench.py can assert the promise (counter delta == 0
# across execute()).  The encoded feature pipeline (DESIGN.md §15) makes
# the same promise for numeric blocks: compression.decode_np bumps
# numeric_blocks/numeric_rows on every host-side materialization of a
# non-PLAIN block (memo misses only), so the encoded FeatureRDD train
# path can assert it hands DICT/FOR/BITPACK/RLE arrays to the device
# without a single host decode.  Plain dict mutation under the GIL — diagnostic
# counters, not exact statistics.
DECODE_COUNTERS = {"string_cols": 0, "string_rows": 0,
                   "numeric_blocks": 0, "numeric_rows": 0}


def reset_decode_counters() -> None:
    DECODE_COUNTERS["string_cols"] = 0
    DECODE_COUNTERS["string_rows"] = 0
    DECODE_COUNTERS["numeric_blocks"] = 0
    DECODE_COUNTERS["numeric_rows"] = 0


def string_decode_events() -> int:
    return DECODE_COUNTERS["string_cols"]


def numeric_decode_events() -> int:
    return DECODE_COUNTERS["numeric_blocks"]


class ColumnVal:
    """Evaluated column value: either numeric array, or (codes, dictionary).

    May be *block-backed* (the scan path): `block` references the columnar
    store's ColumnBlock and `arr` materializes lazily through the memoized
    decode on first access — the compiled pipeline-segment executor reads
    dictionary codes straight off the block and may never touch `arr` for a
    filter-only column."""

    __slots__ = ("_arr", "sdict", "sorted_dict", "block")

    def __init__(self, arr: Any = None, sdict: Optional[np.ndarray] = None,
                 sorted_dict: bool = True, block: Any = None):
        if arr is None and block is None:
            raise ValueError("ColumnVal needs an array or a backing block")
        self._arr = arr
        self.sdict = sdict          # sorted str dict when string-typed
        self.sorted_dict = sorted_dict  # codes order-preserving w.r.t. strings?
        self.block = block          # columnar.ColumnBlock backing (scan path)

    @property
    def arr(self) -> Any:
        """numpy array (codes for strings); decodes lazily when block-backed."""
        if self._arr is None:
            self._arr = self.block.values()
        return self._arr

    @property
    def materialized(self) -> bool:
        return self._arr is not None

    @property
    def is_string(self) -> bool:
        return self.sdict is not None

    def decoded(self) -> np.ndarray:
        if self.sdict is None:
            return np.asarray(self.arr)
        arr = np.asarray(self.arr)
        DECODE_COUNTERS["string_cols"] += 1
        DECODE_COUNTERS["string_rows"] += int(arr.shape[0]) if arr.ndim else 1
        return self.sdict[arr]

    def __repr__(self):
        backing = "lazy" if self._arr is None else "materialized"
        return f"ColumnVal({backing}, string={self.is_string})"


class Evaluator:
    """Compiles/evaluates an Expr against a partition context.

    `xp` is numpy: the semantic oracle the torch lowering below is held
    against.  Dictionary lookups for string literals happen host-side (they
    depend only on the partition's dictionary, not on row data).
    """

    def __init__(self, ctx: Dict[str, ColumnVal], xp=np):
        self.ctx = ctx
        self.xp = xp

    def eval(self, e: Expr) -> ColumnVal:
        xp = self.xp
        if isinstance(e, Col):
            if e.name not in self.ctx:
                raise KeyError(f"unbound column {e.name!r}")
            return self.ctx[e.name]
        if isinstance(e, Lit):
            return ColumnVal(e.value)
        if isinstance(e, BinOp):
            l, r = self.eval(e.left), self.eval(e.right)
            a, b = l.arr, r.arr
            if e.op == "+": out = a + b
            elif e.op == "-": out = a - b
            elif e.op == "*": out = a * b
            elif e.op == "/":
                out = xp.asarray(a, dtype=np.float64) / b if not np.isscalar(a) else a / xp.asarray(b, dtype=np.float64)
            elif e.op == "%": out = a % b
            else: raise ValueError(e.op)
            return ColumnVal(out)
        if isinstance(e, Cmp):
            return self._cmp(e)
        if isinstance(e, And):
            return ColumnVal(self.eval(e.left).arr & self.eval(e.right).arr)
        if isinstance(e, Or):
            return ColumnVal(self.eval(e.left).arr | self.eval(e.right).arr)
        if isinstance(e, Not):
            # logical_not, NOT `~`: Python scalar bools invert bitwise
            # (~True == -2), which hypothesis caught on degenerate predicates
            return ColumnVal(xp.logical_not(self.eval(e.child).arr))
        if isinstance(e, InList):
            c = self.eval(e.child)
            if c.is_string:
                mask = None
                for v in e.values:
                    m = self._string_eq(c, str(v))
                    mask = m if mask is None else (mask | m)
                return ColumnVal(mask)
            mask = None
            for v in e.values:
                m = c.arr == v
                mask = m if mask is None else (mask | m)
            return ColumnVal(mask)
        if isinstance(e, Between):
            c = self.eval(e.child)
            if c.is_string:
                lo = self._string_bound(c, str(e.lo), "ge")
                hi = self._string_bound(c, str(e.hi), "le")
                return ColumnVal(lo & hi)
            return ColumnVal((c.arr >= e.lo) & (c.arr <= e.hi))
        if isinstance(e, Func):
            return self._func(e)
        raise TypeError(type(e))

    # -- string machinery ---------------------------------------------------

    def _string_eq(self, c: ColumnVal, v: str):
        assert c.sdict is not None
        if c.sorted_dict:
            i = int(np.searchsorted(c.sdict, v))
            if i < len(c.sdict) and c.sdict[i] == v:
                return c.arr == i
            return self.xp.zeros_like(c.arr, dtype=bool)
        hits = np.flatnonzero(c.sdict == v)
        if len(hits) == 0:
            return self.xp.zeros_like(c.arr, dtype=bool)
        mask = None
        for i in hits.tolist():
            m = c.arr == i
            mask = m if mask is None else (mask | m)
        return mask

    def _string_bound(self, c: ColumnVal, v: str, kind: str):
        """Order comparison against a literal via the sorted dictionary."""
        assert c.sdict is not None
        if not c.sorted_dict:
            # re-sort: map codes through rank of dict
            order = np.argsort(c.sdict)
            rank = np.empty(len(c.sdict), np.int32)
            rank[order] = np.arange(len(c.sdict), dtype=np.int32)
            codes = self.xp.asarray(rank)[c.arr]
            sdict = c.sdict[order]
            c = ColumnVal(codes, sdict, True)
        lo_i = int(np.searchsorted(c.sdict, v, side="left"))
        ri = int(np.searchsorted(c.sdict, v, side="right"))
        if kind == "lt": return c.arr < lo_i
        if kind == "le": return c.arr < ri
        if kind == "gt": return c.arr >= ri
        if kind == "ge": return c.arr >= lo_i
        raise ValueError(kind)

    def _cmp(self, e: Cmp) -> ColumnVal:
        l, r = self.eval(e.left), self.eval(e.right)
        # string vs literal
        if l.is_string and not r.is_string and isinstance(r.arr, str):
            v = r.arr
            if e.op == "=": return ColumnVal(self._string_eq(l, v))
            if e.op == "!=": return ColumnVal(~self._string_eq(l, v))
            kind = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge"}[e.op]
            return ColumnVal(self._string_bound(l, v, kind))
        if r.is_string and not l.is_string and isinstance(l.arr, str):
            flip = {"=": "=", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
            return self._cmp(Cmp(flip[e.op], e.right, e.left))
        if l.is_string and r.is_string:
            # decode both (host path only) — rare in our workloads
            a, b = l.decoded(), r.decoded()
        else:
            a, b = l.arr, r.arr
        if e.op == "=": return ColumnVal(a == b)
        if e.op == "!=": return ColumnVal(a != b)
        if e.op == "<": return ColumnVal(a < b)
        if e.op == "<=": return ColumnVal(a <= b)
        if e.op == ">": return ColumnVal(a > b)
        if e.op == ">=": return ColumnVal(a >= b)
        raise ValueError(e.op)

    def _func(self, e: Func) -> ColumnVal:
        xp = self.xp
        if e.name in STRING_FUNCS:
            c = self.eval(e.args[0])
            assert c.is_string, f"{e.name} needs a string column"
            d = c.sdict
            if e.name == "SUBSTR":
                start = int(_const(e.args[1])) - 1  # SQL is 1-based
                ln = int(_const(e.args[2]))
                nd = np.array([s[start:start + ln] for s in d])
            elif e.name == "LOWER":
                nd = np.char.lower(d)
            elif e.name == "UPPER":
                nd = np.char.upper(d)
            else:
                raise NotImplementedError(e.name)
            # transformed dictionary is generally neither unique nor sorted
            return ColumnVal(c.arr, nd, sorted_dict=False)
        if e.name == "LENGTH":
            c = self.eval(e.args[0])
            assert c.is_string
            lens = np.char.str_len(c.sdict).astype(np.int32)
            return ColumnVal(xp.asarray(lens)[c.arr])
        c = self.eval(e.args[0])
        a = c.arr
        if e.name == "ABS": return ColumnVal(xp.abs(a))
        if e.name == "SQRT": return ColumnVal(xp.sqrt(a))
        if e.name == "LOG": return ColumnVal(xp.log(a))
        if e.name == "EXP": return ColumnVal(xp.exp(a))
        if e.name == "FLOOR": return ColumnVal(xp.floor(a))
        if e.name == "CEIL": return ColumnVal(xp.ceil(a))
        if e.name == "YEAR":
            # DATE is days-since-epoch; approximate Hive YEAR()
            return ColumnVal((a // 365.2425 + 1970).astype(np.int32) if xp is np
                             else (a // 365.2425 + 1970).astype(np.int32))
        raise NotImplementedError(e.name)


def _const(e: Expr):
    assert isinstance(e, Lit), f"expected literal, got {e}"
    return e.value


def evaluate(e: Expr, ctx: Dict[str, ColumnVal], xp=np) -> ColumnVal:
    return Evaluator(ctx, xp).eval(e)


# ---------------------------------------------------------------------------
# Expression compiler (paper §5): `compile_expr(e)` lowers an Expr tree into
# ONE columnar torch function.  Per partition, the host resolves every
# dictionary-dependent constant (string-literal code bounds, numeric-dict
# bounds, LENGTH tables) into a flat `consts` tuple; the function is pure
# tensor math over (column tensors, consts) on the session's device and is
# therefore shared across partitions.
#
# `evaluate(..., xp=)` above remains the semantic oracle: the lowering must
# agree with it bit-for-bit on ints/bools/strings and to rounding on floats
# (tests/test_compile_expr_property.py).  Anything the lowering cannot
# express (string-transforming Funcs, unsorted dictionaries, string-vs-
# string column compares) raises ExprCompileError and the segment executor
# falls back to the numpy evaluator for that partition — recorded per
# partition in ExecMetrics.
# ---------------------------------------------------------------------------


class ExprCompileError(Exception):
    """The expression cannot be lowered to the columnar torch form."""


_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    ("bool", "bool"), ("uint8", "uint8"), ("int8", "int8"),
    ("int16", "int16"), ("int32", "int32"), ("int64", "int64"),
    ("float16", "float16"), ("float32", "float32"),
    ("float64", "float64"))}


def torch_dtype(dt):
    """The torch dtype of a numpy dtype (numeric and bool only)."""
    import torch
    name = _TORCH_DTYPES.get(np.dtype(dt))
    if name is None:
        raise ExprCompileError(f"no torch dtype for {np.dtype(dt)}")
    return getattr(torch, name)


def to_tensor(arr, device):
    """numpy -> torch on `device` (shares memory on the CPU).  Unsigned
    lanes wider than a byte widen to int64: PyTorch's CPU kernels do not
    compare uint16/uint32."""
    import torch
    a = np.asarray(arr)
    if a.dtype.kind == "u" and a.dtype.itemsize > 1:
        a = a.astype(np.int64)
    torch_dtype(a.dtype)          # raises ExprCompileError on str/object
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class TorchOps:
    """The array namespace (`xp`) the lowered closures call, over torch
    tensors on one device, with numpy's result dtypes where torch's
    differ: a Python float constant becomes a 0-d float64 tensor (torch
    would compute int-column-vs-float-literal in float32), and SQRT / LOG /
    EXP / FLOOR / CEIL / YEAR of integers compute in float64."""

    def __init__(self, device):
        self.device = device

    def lit(self, v):
        import torch
        if isinstance(v, (float, np.floating)):
            return torch.tensor(float(v), dtype=torch.float64,
                                device=self.device)
        return v

    def asarray(self, a, dtype=None):
        import torch
        td = torch_dtype(dtype) if dtype is not None else None
        if isinstance(a, torch.Tensor):
            return a.to(td) if td is not None else a
        return torch.as_tensor(a, dtype=td, device=self.device)

    def _float(self, a):
        import torch
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a
        return self.asarray(a, dtype=np.float64)

    def take(self, table, idx):
        return self.asarray(table)[idx.long()]

    def abs(self, a):
        import torch
        return torch.abs(self.asarray(a))

    def sqrt(self, a):
        import torch
        return torch.sqrt(self._float(a))

    def log(self, a):
        import torch
        return torch.log(self._float(a))

    def exp(self, a):
        import torch
        return torch.exp(self._float(a))

    def floor(self, a):
        import torch
        return torch.floor(self._float(a))

    def ceil(self, a):
        import torch
        return torch.ceil(self._float(a))

    def year(self, a):
        import torch
        return (torch.floor(self._float(a) / 365.2425) + 1970).to(
            torch.int32)

    def logical_not(self, a):
        import torch
        return torch.logical_not(self.asarray(a))


def literal_compare_columns(*exprs: Expr) -> set:
    """Columns appearing ONLY as the direct child of a literal comparison
    (Cmp vs Lit, Between, InList) across all given trees: their predicates
    can run in dictionary-code space without ever decoding the column."""
    compare_pos: set = set()
    value_pos: set = set()

    def walk(n: Expr) -> None:
        if isinstance(n, Cmp):
            if isinstance(n.left, Col) and isinstance(n.right, Lit):
                compare_pos.add(n.left.name)
                return
            if isinstance(n.right, Col) and isinstance(n.left, Lit):
                compare_pos.add(n.right.name)
                return
        if isinstance(n, (Between, InList)) and isinstance(n.child, Col):
            compare_pos.add(n.child.name)
            return
        if isinstance(n, Col):
            value_pos.add(n.name)
            return
        for ch in n.children():
            walk(ch)

    for e in exprs:
        walk(e)
    return compare_pos - value_pos


@dataclasses.dataclass
class _Low:
    """One lowered subtree: fn(env, consts, xp) -> array, plus a tag saying
    what space the result lives in: ("num",) for plain value arrays,
    ("str", col) / ("ndict", col) for dictionary codes of `col`, and
    ("for", col) for frame-of-reference codes (value - bias) of `col`."""
    fn: Callable
    tag: Tuple


_FLIP_CMP = {"=": "=", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


class _Lowering:
    def __init__(self, kinds: Dict[str, str]):
        self.kinds = kinds
        self.extractors: List[Callable] = []

    def _const_idx(self, f: Callable) -> int:
        self.extractors.append(f)
        return len(self.extractors) - 1

    def _bound_idx(self, name: str, kind: str, value, side: str) -> int:
        """Per-partition bound of `value` in the column's code space: a
        searchsorted index into the sorted dictionary (string dict / numeric
        DICT dict), or for frame-of-reference codes the identity-map bound
        `ceil(v) - bias` (left) / `floor(v) + 1 - bias` (right) — FOR codes
        are order-preserving integers, so the same `code >= left-bound`
        compare semantics apply without any dictionary."""
        if kind == "str":
            value = str(value)
        if kind == "for":
            if isinstance(value, str):
                raise ExprCompileError("numeric column vs string literal")
            v = float(value)
            if not math.isfinite(v):
                raise ExprCompileError("non-finite literal vs FOR codes")
            offs = math.ceil(v) if side == "left" else math.floor(v) + 1

            def extract(ctx, name=name, offs=offs):
                fs = ctx[name].block.frame_space()
                if fs is None:   # block recompressed since kinds_for()
                    raise ExprCompileError("FOR frame gone (recompressed)")
                return np.int64(offs - int(fs[1]))

            return self._const_idx(extract)

        def extract(ctx, name=name, kind=kind, value=value, side=side):
            if kind == "str":
                d = ctx[name].sdict
            else:
                cs = ctx[name].block.code_space()
                if cs is None:   # block recompressed since kinds_for()
                    raise ExprCompileError("dict codes gone (recompressed)")
                d = cs[1]
            return np.int64(np.searchsorted(d, value, side=side))

        return self._const_idx(extract)

    @staticmethod
    def _need_num(low: _Low) -> None:
        if low.tag[0] != "num":
            raise ExprCompileError(
                f"dictionary-coded value used in a value position: {low.tag}")

    # -- dictionary-space comparisons ---------------------------------------

    def _dict_cmp(self, op: str, tag: Tuple, value) -> _Low:
        kind, name = tag
        if kind == "str" and not isinstance(value, str):
            raise ExprCompileError("string column vs non-string literal")
        if kind in ("ndict", "for") and isinstance(value, str):
            raise ExprCompileError("numeric column vs string literal")
        lo = self._bound_idx(name, kind, value, "left")
        ri = self._bound_idx(name, kind, value, "right")

        def fn(env, c, xp, name=name, lo=lo, ri=ri, op=op):
            a = env[name]
            if op == "=":
                return (a >= c[lo]) & (a < c[ri])
            if op == "!=":
                return ~((a >= c[lo]) & (a < c[ri]))
            if op == "<":
                return a < c[lo]
            if op == "<=":
                return a < c[ri]
            if op == ">":
                return a >= c[ri]
            if op == ">=":
                return a >= c[lo]
            raise ValueError(op)

        return _Low(fn, ("num",))

    # -- recursive lowering ---------------------------------------------------

    def lower(self, e: Expr) -> _Low:
        if isinstance(e, Col):
            name = e.name
            kind = self.kinds[name]
            fn = lambda env, c, xp, name=name: env[name]
            if kind == "str":
                return _Low(fn, ("str", name))
            if kind == "ndict":
                return _Low(fn, ("ndict", name))
            if kind == "for":
                return _Low(fn, ("for", name))
            return _Low(fn, ("num",))
        if isinstance(e, Lit):
            v = e.value
            if isinstance(v, str):
                raise ExprCompileError("bare string literal")
            return _Low(lambda env, c, xp, v=v: xp.lit(v), ("num",))
        if isinstance(e, BinOp):
            l, r = self.lower(e.left), self.lower(e.right)
            self._need_num(l)
            self._need_num(r)
            op = e.op

            def fn(env, c, xp, l=l, r=r, op=op):
                a, b = l.fn(env, c, xp), r.fn(env, c, xp)
                if op == "+":
                    return a + b
                if op == "-":
                    return a - b
                if op == "*":
                    return a * b
                if op == "/":
                    return (xp.asarray(a, dtype=np.float64) / b
                            if not np.isscalar(a)
                            else a / xp.asarray(b, dtype=np.float64))
                if op == "%":
                    return a % b
                raise ValueError(op)

            return _Low(fn, ("num",))
        if isinstance(e, Cmp):
            # dictionary-space forms first: the literal child must not be
            # lowered (string literals only exist as host-resolved bounds)
            if isinstance(e.right, Lit):
                l = self.lower(e.left)
                if l.tag[0] in ("str", "ndict", "for"):
                    return self._dict_cmp(e.op, l.tag, e.right.value)
            if isinstance(e.left, Lit):
                r = self.lower(e.right)
                if r.tag[0] in ("str", "ndict", "for"):
                    return self._dict_cmp(_FLIP_CMP[e.op], r.tag,
                                          e.left.value)
            l, r = self.lower(e.left), self.lower(e.right)
            self._need_num(l)
            self._need_num(r)
            op = e.op

            def fn(env, c, xp, l=l, r=r, op=op):
                a, b = l.fn(env, c, xp), r.fn(env, c, xp)
                if op == "=":
                    return a == b
                if op == "!=":
                    return a != b
                if op == "<":
                    return a < b
                if op == "<=":
                    return a <= b
                if op == ">":
                    return a > b
                return a >= b

            return _Low(fn, ("num",))
        if isinstance(e, And):
            l, r = self.lower(e.left), self.lower(e.right)
            self._need_num(l)
            self._need_num(r)
            return _Low(lambda env, c, xp, l=l, r=r:
                        l.fn(env, c, xp) & r.fn(env, c, xp), ("num",))
        if isinstance(e, Or):
            l, r = self.lower(e.left), self.lower(e.right)
            self._need_num(l)
            self._need_num(r)
            return _Low(lambda env, c, xp, l=l, r=r:
                        l.fn(env, c, xp) | r.fn(env, c, xp), ("num",))
        if isinstance(e, Not):
            ch = self.lower(e.child)
            self._need_num(ch)
            return _Low(lambda env, c, xp, ch=ch:
                        xp.logical_not(ch.fn(env, c, xp)), ("num",))
        if isinstance(e, InList):
            ch = self.lower(e.child)
            if ch.tag[0] in ("str", "ndict", "for"):
                parts = [self._dict_cmp("=", ch.tag, v) for v in e.values]

                def fn(env, c, xp, parts=parts):
                    mask = None
                    for p in parts:
                        m = p.fn(env, c, xp)
                        mask = m if mask is None else (mask | m)
                    return mask

                return _Low(fn, ("num",))
            self._need_num(ch)
            values = tuple(e.values)
            if any(isinstance(v, str) for v in values):
                raise ExprCompileError("string IN-list on numeric value")

            def fn(env, c, xp, ch=ch, values=values):
                a = ch.fn(env, c, xp)
                mask = None
                for v in values:
                    m = a == xp.lit(v)
                    mask = m if mask is None else (mask | m)
                return mask

            return _Low(fn, ("num",))
        if isinstance(e, Between):
            ch = self.lower(e.child)
            if ch.tag[0] in ("str", "ndict", "for"):
                kind, name = ch.tag
                lo = self._bound_idx(name, kind, e.lo, "left")
                ri = self._bound_idx(name, kind, e.hi, "right")
                return _Low(lambda env, c, xp, name=name, lo=lo, ri=ri:
                            (env[name] >= c[lo]) & (env[name] < c[ri]),
                            ("num",))
            self._need_num(ch)
            lo, hi = e.lo, e.hi
            if isinstance(lo, str) or isinstance(hi, str):
                raise ExprCompileError("string BETWEEN on numeric value")
            return _Low(lambda env, c, xp, ch=ch, lo=lo, hi=hi:
                        (lambda a: (a >= xp.lit(lo)) & (a <= xp.lit(hi)))(
                            ch.fn(env, c, xp)),
                        ("num",))
        if isinstance(e, Func):
            if e.name in STRING_FUNCS:
                raise ExprCompileError(
                    f"string function {e.name} (dictionary transform)")
            if e.name == "LENGTH":
                ch = self.lower(e.args[0])
                if ch.tag[0] != "str":
                    raise ExprCompileError("LENGTH of non-string")
                name = ch.tag[1]

                def extract(ctx, name=name):
                    return np.char.str_len(ctx[name].sdict).astype(np.int32)

                li = self._const_idx(extract)
                return _Low(lambda env, c, xp, name=name, li=li:
                            xp.take(c[li], env[name]), ("num",))
            ch = self.lower(e.args[0])
            self._need_num(ch)
            fname = e.name

            def fn(env, c, xp, ch=ch, fname=fname):
                a = ch.fn(env, c, xp)
                if fname == "ABS":
                    return xp.abs(a)
                if fname == "SQRT":
                    return xp.sqrt(a)
                if fname == "LOG":
                    return xp.log(a)
                if fname == "EXP":
                    return xp.exp(a)
                if fname == "FLOOR":
                    return xp.floor(a)
                if fname == "CEIL":
                    return xp.ceil(a)
                if fname == "YEAR":
                    return xp.year(a)
                raise ExprCompileError(fname)

            return _Low(fn, ("num",))
        raise ExprCompileError(f"cannot lower {type(e).__name__}")


@dataclasses.dataclass
class _ExprPlan:
    fn: Callable
    extractors: List[Callable]
    out_str_cols: List[Optional[str]]   # per output: codes of this str col


# Compiled plans are shared process-wide, keyed by (expression structure,
# partition layout signature): two queries with the same predicate shape
# reuse one lowered function instead of lowering the tree again.
_PLAN_CACHE: Dict[Tuple, _ExprPlan] = {}
_PLAN_CACHE_MAX = 512


def _plan_cache_get(key: Tuple) -> Optional[_ExprPlan]:
    return _PLAN_CACHE.get(key)


def _plan_cache_put(key: Tuple, plan: _ExprPlan) -> None:
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.clear()     # crude but bounded; plans rebuild on demand
    _PLAN_CACHE[key] = plan


class CompiledExprSet:
    """Several expressions (a segment's predicate plus its computed
    projections) lowered through ONE shared lowering into ONE torch
    function returning all outputs — the whole segment is a single
    function of the partition's column tensors.

    Lowering is cached per *signature* — the tuple of (column, space)
    choices, which can differ between partitions because compression is
    chosen per partition (§3.2) — so every partition with the same layout
    reuses one compiled function."""

    def __init__(self, exprs: Sequence[Expr], compressed_domain: bool = True,
                 device="cpu"):
        self.exprs = list(exprs)
        self.compressed_domain = compressed_domain
        self.device = device
        for e in self.exprs:
            if not _structurally_compilable(e):
                raise ExprCompileError("string-transforming function in tree")
        cols: set = set()
        for e in self.exprs:
            cols.update(e.columns())
        self.cols = sorted(cols)
        self.code_candidates = literal_compare_columns(*self.exprs)
        # structural identity for the cross-query plan cache: reprs carry
        # operators, column names, and literal values
        self._key = tuple(repr(e) for e in self.exprs)
        self._plans: Dict[Tuple, _ExprPlan] = {}

    # -- per-partition layout --------------------------------------------------

    def kinds_for(self, ctx: Dict[str, ColumnVal]) -> Dict[str, str]:
        kinds: Dict[str, str] = {}
        for name in self.cols:
            if name not in ctx:
                raise ExprCompileError(f"unbound column {name!r}")
            v = ctx[name]
            if v.is_string:
                if not v.sorted_dict:
                    raise ExprCompileError("unsorted string dictionary")
                kinds[name] = "str"
            elif (name in self.code_candidates and v.block is not None
                    and v.block.code_space() is not None):
                kinds[name] = "ndict"
            elif (self.compressed_domain and name in self.code_candidates
                    and v.block is not None
                    and v.block.frame_space() is not None):
                # frame-of-reference codes: range predicates run on the
                # narrow (value - bias) lane without widening (§12)
                kinds[name] = "for"
            else:
                kinds[name] = "vals"
        return kinds

    def _plan_for(self, kinds: Dict[str, str]) -> _ExprPlan:
        sig = tuple((n, kinds[n]) for n in self.cols)
        plan = self._plans.get(sig)
        if plan is not None:
            return plan
        cache_key = (self._key, sig)
        plan = _plan_cache_get(cache_key)
        if plan is not None:
            self._plans[sig] = plan
            return plan
        lowering = _Lowering(kinds)
        lows: List[_Low] = []
        out_str_cols: List[Optional[str]] = []
        for e in self.exprs:
            low = lowering.lower(e)
            if low.tag[0] == "str":
                out_str_cols.append(low.tag[1])
            elif low.tag[0] == "ndict":
                # bare numeric-dict column as an output: decode fused at
                # the boundary (dictionary gather inside the lowered fn)
                name = low.tag[1]

                def _dict_of(ctx, name=name):
                    cs = ctx[name].block.code_space()
                    if cs is None:   # recompressed since kinds_for()
                        raise ExprCompileError("dict codes gone")
                    return cs[1]

                di = lowering._const_idx(_dict_of)
                inner = low
                low = _Low(lambda env, c, xp, inner=inner, di=di:
                           xp.take(c[di], inner.fn(env, c, xp)), ("num",))
                out_str_cols.append(None)
            elif low.tag[0] == "for":
                # bare FOR column as an output: un-bias fused at the
                # boundary (add the frame base in the original dtype)
                name = low.tag[1]

                def _bias_of(ctx, name=name):
                    blk = ctx[name].block
                    fs = blk.frame_space()
                    if fs is None:   # recompressed since kinds_for()
                        raise ExprCompileError("FOR frame gone")
                    return np.asarray(fs[1], dtype=blk.enc.orig_dtype)

                bi = lowering._const_idx(_bias_of)
                inner = low
                low = _Low(lambda env, c, xp, inner=inner, bi=bi:
                           inner.fn(env, c, xp).to(c[bi].dtype) + c[bi],
                           ("num",))
                out_str_cols.append(None)
            else:
                out_str_cols.append(None)
            lows.append(low)

        def run(env, consts, xp, lows=tuple(lows)):
            return tuple(low.fn(env, consts, xp) for low in lows)

        plan = _ExprPlan(run, lowering.extractors, out_str_cols)
        self._plans[sig] = plan
        _plan_cache_put(cache_key, plan)
        return plan

    # -- execution -------------------------------------------------------------

    def __call__(self, ctx: Dict[str, ColumnVal]) -> List[ColumnVal]:
        import torch
        kinds = self.kinds_for(ctx)
        plan = self._plan_for(kinds)
        dev = self.device
        env = {}
        for n in self.cols:
            v = ctx[n]
            if kinds[n] == "ndict":
                cs = v.block.code_space()
                if cs is None:   # recompressed between kinds_for and here
                    raise ExprCompileError("dict codes gone (recompressed)")
                env[n] = v.block.device_array("codes", dev)
            elif kinds[n] == "for":
                fs = v.block.frame_space()
                if fs is None:   # recompressed between kinds_for and here
                    raise ExprCompileError("FOR frame gone (recompressed)")
                env[n] = to_tensor(fs[0], dev)
            elif v.block is not None and not v.materialized:
                # block-backed: the device copy is memoized on the block
                if np.asarray(v.block.values()).dtype.kind not in "biuf":
                    raise ExprCompileError("non-numeric column values")
                env[n] = v.block.device_array("values", dev)
            else:
                env[n] = to_tensor(v.arr, dev)
        consts = tuple(to_tensor(f(ctx), dev) for f in plan.extractors)
        try:
            outs = plan.fn(env, consts, TorchOps(dev))
        except (RuntimeError, TypeError) as exc:
            # e.g. integer % 0, which numpy answers and torch refuses: the
            # partition falls back to the evaluate() oracle
            raise ExprCompileError(f"torch lowering failed: {exc}") from exc
        inputs = [t.data_ptr() for t in env.values()]
        results: List[ColumnVal] = []
        for out, str_col in zip(outs, plan.out_str_cols):
            if isinstance(out, torch.Tensor):
                if out.device.type == "cpu" and out.data_ptr() in inputs:
                    out = out.clone()   # never alias the column store
                arr = out.cpu().numpy()
            else:
                arr = np.asarray(out)
            if str_col is not None:
                src = ctx[str_col]
                results.append(ColumnVal(arr, src.sdict, src.sorted_dict))
            else:
                results.append(ColumnVal(arr))
        return results


class CompiledExpr(CompiledExprSet):
    """`compile_expr(e)`: a one-expression CompiledExprSet returning the
    single ColumnVal directly."""

    def __init__(self, expr: Expr, compressed_domain: bool = True):
        super().__init__([expr], compressed_domain=compressed_domain)
        self.expr = expr

    def __call__(self, ctx: Dict[str, ColumnVal]) -> ColumnVal:
        return super().__call__(ctx)[0]


def _structurally_compilable(e: Expr) -> bool:
    if isinstance(e, Func) and e.name in STRING_FUNCS:
        return False
    return all(_structurally_compilable(ch) for ch in e.children())


def compile_expr(e: Expr) -> CompiledExpr:
    """Compile an expression to a columnar torch function.  Raises
    ExprCompileError eagerly for trees the lowering can never express
    (string-transforming functions); partition-layout-dependent failures
    surface at call time instead and the caller falls back to evaluate()."""
    return CompiledExpr(e)


# ---------------------------------------------------------------------------
# Predicate normalization helpers used by map pruning and pushdown
# ---------------------------------------------------------------------------


def rewrite_expr(e: Expr, fn: Callable[[Expr], Optional[Expr]]) -> Expr:
    """Generic top-down expression rewrite: `fn(node)` returns a replacement
    subtree (recursion stops there) or None to keep the node, in which case
    it is shallow-copied and its children rewritten.  The single walker for
    every rewriter (predicate pushdown substitution, HAVING resolution, ...)
    so Expr attribute conventions live in one place."""
    out = fn(e)
    if out is not None:
        return out
    import copy
    c = copy.copy(e)
    for attr in ("left", "right"):
        if hasattr(c, attr):
            setattr(c, attr, rewrite_expr(getattr(c, attr), fn))
    if hasattr(c, "child") and isinstance(getattr(c, "child"), Expr):
        c.child = rewrite_expr(c.child, fn)
    if hasattr(c, "args"):
        c.args = tuple(rewrite_expr(x, fn) for x in c.args)
    return c


def split_conjuncts(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    if isinstance(e, And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def conjoin(exprs: Sequence[Expr]) -> Optional[Expr]:
    out: Optional[Expr] = None
    for e in exprs:
        out = e if out is None else And(out, e)
    return out
