"""Helpers for the torch port's twins of the reference's tests.

A twin runs one test body on both packages: `JAX` (the reference, `repro`)
and `TORCH` (the port, `repro_torch`, every session, server and context on
`device="cpu"`).  `twin(body, ...)` runs `body` once per package: a body
whose first parameter is `pk` gets the package, any other reads it from
`P` (`P.SharkSession`, `P.m("core.pde").PDEConfig`), and every query answer
it collects (`ExecResult.to_numpy`), every error it expects (`raises`) and
every `note(...)` it makes is recorded.  The body asserts the reference
test's own assertions, for both packages; then the port's return value
and records must equal the reference's (`assert_same`): integers, booleans
and strings exactly, floats to rtol 1e-12 (or the caller's looser
tolerance), answers as row multisets (the port's radix kernel buckets
differently from the reference's host partitioner).  A body that returns
`observed(locals())` is compared on the plain-data locals both packages
hold.  `twin_given` is the deterministic twin of a Hypothesis property:
its derandomized examples are drawn once, with the reference's classes,
and translated to the port's (`translate`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import importlib
from typing import Any

import numpy as np

RTOL = 1e-12


class Pkg:
    """One package under test: `pk.mod("core.pde")` imports
    `<root>.core.pde`; `pk.X` finds X in `<root>.core`;
    `pk.session(**kw)` / `pk.server(**kw)` / `pk.fleet(**kw)` build a
    session, a server or a fleet (on the CPU for the port); `pk.mesh(n)` a
    MeshContext of n device slots."""

    def __init__(self, name: str, root: str, device_kw: dict):
        self.name = name
        self.root = root
        self.device_kw = device_kw

    def __repr__(self) -> str:
        return self.name

    def mod(self, path: str):
        return importlib.import_module(f"{self.root}.{path}")

    def __getattr__(self, attr: str) -> Any:
        if attr.startswith("__"):
            raise AttributeError(attr)
        return getattr(self.mod("core"), attr)

    def session(self, **kw):
        return self.SharkSession(**self.device_kw, **kw)

    def server(self, **kw):
        return self.mod("server").SharkServer(**self.device_kw, **kw)

    def mesh(self, n: int = 1, **kw):
        """A MeshContext of n device slots: the reference's first n XLA
        devices (it must have n), the port's n CPU slots."""
        mod = self.mod("cluster")
        if self is TORCH:
            import torch
            return mod.MeshContext(devices=[torch.device("cpu")] * n, **kw)
        mesh = mod.MeshContext(max_devices=n, **kw)
        assert len(mesh.devices) == n, (len(mesh.devices), n)
        return mesh

    def fleet(self, **kw):
        """A SharkFleet (its replicas on the CPU for the port)."""
        return self.mod("cluster").SharkFleet(**self.device_kw, **kw)

    def schema(self, **types: str):
        """Schema.of(name=DType.<types[name]>) in this package."""
        return self.Schema.of(**{c: getattr(self.DType, t)
                                 for c, t in types.items()})


JAX = Pkg("jax", "repro", {})
TORCH = Pkg("torch", "repro_torch", {"device": "cpu"})
PKGS = (JAX, TORCH)


class _View:
    """A module of the current package; its `SharkSession`,
    `SharkServer` and `SharkFleet` compute on the CPU for the port."""

    def __init__(self, pk: Pkg, path: str):
        object.__setattr__(self, "_pk", pk)
        object.__setattr__(self, "_mod", pk.mod(path))

    def __setattr__(self, attr: str, value) -> None:
        # monkeypatching a view patches the module
        setattr(self._mod, attr, value)

    def __getattr__(self, attr: str) -> Any:
        if attr == "SharkSession" and self._pk is TORCH:
            return self._pk.session
        if attr == "SharkServer" and self._pk is TORCH:
            return self._pk.server
        if attr == "SharkFleet" and self._pk is TORCH:
            return self._pk.fleet
        if attr == "SharkContext" and self._pk is TORCH:
            return lambda *a, **kw: self._mod.SharkContext(
                *a, **self._pk.device_kw, **kw)
        return getattr(self._mod, attr)


class _Current:
    """`P`: the package a twin body runs on.  `P.X` is `<root>.core.X`,
    `P.m("core.pde").X` is `<root>.core.pde.X`, `P.mesh(n)` the package's
    `pk.mesh(n)`."""

    pkg: Pkg = JAX

    def m(self, path: str) -> _View:
        return _View(self.pkg, path)

    def mesh(self, n: int = 1, **kw):
        return self.pkg.mesh(n, **kw)

    def __getattr__(self, attr: str) -> Any:
        if attr.startswith("__"):
            raise AttributeError(attr)
        return getattr(self.m("core"), attr)


P = _Current()


class PerPkg(dict):
    """A fixture's value for each package: {"jax": ..., "torch": ...}."""


def per_pkg(make, *deps):
    """Build `make(*deps)` once under each package (for fixtures); a
    `PerPkg` dependency passes its own package's value."""
    out = PerPkg()
    for pk in PKGS:
        P.pkg = pk
        out[pk.name] = make(*(d[pk.name] if isinstance(d, PerPkg) else d
                              for d in deps))
    return out


SKIP_LOCALS = frozenset({"t0", "t1", "elapsed", "start", "end", "dt"})


def _comparable(v):
    """v as plain data both packages can be compared on, or `_NO`."""
    if isinstance(v, (bool, int, float, str, np.generic)):
        return v
    if isinstance(v, np.ndarray):
        return v if v.dtype.kind != "O" else _NO
    if hasattr(v, "__array__") and hasattr(v, "shape") and hasattr(
            v, "dtype"):            # a jax array or a torch tensor
        try:
            return np.asarray(v.cpu() if hasattr(v, "cpu") else v)
        except (TypeError, RuntimeError):
            return _NO
    if isinstance(getattr(v, "cols", None), dict):    # a PartitionBatch
        return _comparable({k: c for k, c in v.cols.items()})
    if hasattr(v, "decoded") and hasattr(v, "sdict"):   # a ColumnVal
        return _comparable(v.decoded() if v.sdict is not None else v.arr)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        try:
            return _comparable(dataclasses.asdict(v))
        except TypeError:
            return _NO
    if type(v).__module__.endswith((".resilience", ".faults")) and callable(
            getattr(v, "stats", None)):     # health, breakers: their counts
        try:
            return _comparable(v.stats())
        except TypeError:
            return _NO
    if isinstance(v, (list, tuple)):
        out = [_comparable(x) for x in v]
        return _NO if any(x is _NO for x in out) else out
    if isinstance(v, dict) and all(isinstance(k, str) for k in v):
        out = {k: _comparable(x) for k, x in v.items()}
        return _NO if any(x is _NO for x in out.values()) else out
    if isinstance(v, dict):
        try:
            return _comparable(sorted(v.items()))
        except TypeError:
            return _NO
    return _NO


_NO = object()


class Observed(dict):
    """A body's plain-data locals (`observed(locals())`): compared on the
    names both packages hold as plain data."""


def observed(local_vars: dict, skip=()) -> Observed:
    out = Observed()
    for k, v in local_vars.items():
        if k.startswith("_") or k in SKIP_LOCALS or k in skip:
            continue
        c = _comparable(v)
        if c is not _NO:
            out[k] = c
    return out


_ERRORS: list = []


@contextlib.contextmanager
def raises(*args, **kw):
    """`pytest.raises` that also records the error's type and message, so a
    twin holds the port's errors to the reference's."""
    import pytest
    with pytest.raises(*args, **kw) as info:
        yield info
    # a message may name its own package's module
    _ERRORS.append((info.type.__name__,
                    str(info.value).replace("repro_torch.", "repro.")))


def note(**observations) -> None:
    """Record observations of a helper the body calls: compared with the
    reference's, in order, like the body's answers."""
    _NOTES.append(observations)


_NOTES: list = []


def both(body, *args, **kw):
    """(body(JAX, ...), body(TORCH, ...))."""
    return tuple(body(pk, *args, **kw) for pk in PKGS)


def _run_recorded(pk: Pkg, body, args, kw):
    """body(*args, **kw) with `P` on `pk`; (its return value, every
    `ExecResult.to_numpy()` it produced, in order)."""
    cls = pk.mod("core.physical").ExecResult
    log: list = []
    orig = cls.to_numpy

    def to_numpy(self, *a, **k):
        out = orig(self, *a, **k)
        log.append({c: np.array(v, copy=True) for c, v in out.items()})
        return out

    pick = [(v[pk.name] if isinstance(v, PerPkg) else v) for v in args]
    pkw = {k: (v[pk.name] if isinstance(v, PerPkg) else v)
           for k, v in kw.items()}
    P.pkg = pk
    cls.to_numpy = to_numpy
    del _ERRORS[:]
    del _NOTES[:]
    try:
        out = body(*pick, **pkw)
        if _ERRORS:
            log.append({"errors": list(_ERRORS)})
        log.extend({"note": n} for n in _NOTES)
        return out, log
    finally:
        cls.to_numpy = orig


def twin(body, *args, rtol: float = RTOL, rows: bool = False,
         record: bool = True, **kw):
    """Run `body` on both packages and hold the port's observation to the
    reference's (`rows=True`: dicts of columns compared as row multisets).
    A body that takes a `pk` first argument gets the package; any other
    body reads it from `P`, and every query answer it collects is compared
    too, in order, as row multisets (`record=False`: only what it
    returns, where answers may rightly differ, as under ORDER BY ... LIMIT
    with ties).  Returns the port's observation."""
    import inspect
    params = list(inspect.signature(body).parameters)
    if params[:1] == ["pk"]:
        want, got = both(body, *args, **kw)
        assert_same(got, want, rtol=rtol, rows=rows)
        return got
    (want, want_log), (got, got_log) = (
        _run_recorded(pk, body, args, kw) for pk in PKGS)
    if not record:
        want_log = got_log = []
    want, got = _common(want, got)
    assert want is not None or want_log, \
        "the twin compared nothing: return what the body observed"
    assert_same(got, want, rtol=rtol, rows=rows)
    assert len(got_log) == len(want_log), (len(got_log), len(want_log))
    for i, (g, w) in enumerate(zip(got_log, want_log)):
        assert_same(g, w, rtol=rtol, rows=not ({"errors", "note"} & set(w)),
                    where=f"answer {i}")
    return got


def _common(want, got):
    """Two `Observed` cut to the names both hold as plain data."""
    if isinstance(want, Observed) and isinstance(got, Observed):
        common = sorted(set(want) & set(got))
        return ({k: want[k] for k in common} or None,
                {k: got[k] for k in common} or None)
    return want, got


def translate(obj):
    """A reference object (an expression tree, a plan node, an enum) as the
    same-named object of the port, field by field."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(translate(o) for o in obj)
    if isinstance(obj, dict):
        return {k: translate(v) for k, v in obj.items()}
    mod = type(obj).__module__
    if not mod.startswith("repro."):
        return obj
    cls = getattr(importlib.import_module("repro_torch" + mod[len("repro"):]),
                  type(obj).__name__)
    if isinstance(obj, enum.Enum):
        return cls(obj.value)
    assert dataclasses.is_dataclass(obj), type(obj)
    return cls(**{f.name: translate(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init})


def twin_given(strategies, body, *fixtures, max_examples: int,
               rtol: float = RTOL, rows: bool = False, **settings_kw):
    """A deterministic twin of a Hypothesis property: `strategies()`, built
    with the reference's classes, draws `max_examples` derandomized
    examples (the same on every run); each drives `body(*fixtures,
    *example)` on the reference and, translated (`translate`), on the
    port, whose observations must equal the reference's."""
    from hypothesis import given, settings, strategies as st
    P.pkg = JAX
    seen: list = []

    @settings(max_examples=max_examples, deadline=None, derandomize=True,
              database=None, **settings_kw)
    @given(st.tuples(*strategies()))
    def run(example):
        obs = []
        try:
            for pk, ex in ((JAX, example), (TORCH, translate(example))):
                P.pkg = pk
                fx = [(f[pk.name] if isinstance(f, PerPkg) else f)
                      for f in fixtures]
                obs.append(body(*fx, *ex))
        finally:
            P.pkg = JAX     # the next draw builds reference objects
        w, g = _common(*obs)
        assert w is not None, "the twin compared nothing"
        assert_same(g, w, rtol=rtol, rows=rows, where=f"example {len(seen)}")
        seen.append(1)

    run()
    assert seen


def _is_columns(x) -> bool:
    return (isinstance(x, dict) and x
            and all(isinstance(v, np.ndarray) for v in x.values()))


def assert_same_rows(got, want, rtol: float = RTOL) -> None:
    """Equal multisets of rows of two {column: array} dicts."""
    assert sorted(got) == sorted(want)
    names = sorted(want)
    cols_w = [np.asarray(want[c]) for c in names]
    cols_g = [np.asarray(got[c]) for c in names]
    assert all(g.shape == w.shape for g, w in zip(cols_g, cols_w)), names
    ow = np.lexsort(cols_w[::-1]) if cols_w and len(cols_w[0]) else []
    og = np.lexsort(cols_g[::-1]) if cols_g and len(cols_g[0]) else []
    for name, g, w in zip(names, cols_g, cols_w):
        _same_array(g[og], w[ow], rtol, name)


def _same_array(g, w, rtol, where) -> None:
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (where, g.shape, w.shape)
    if w.dtype.kind == "f" or g.dtype.kind == "f":
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=rtol,
                                   atol=rtol, err_msg=str(where))
    else:
        np.testing.assert_array_equal(g, w, err_msg=str(where))


def assert_same(got, want, rtol: float = RTOL, rows: bool = False,
                where: str = "") -> None:
    """Recursive equality of two observations (dicts, lists, tuples,
    arrays, numbers, strings): integers and strings exactly, floats to
    `rtol`; with `rows`, dicts of column arrays as row multisets."""
    if rows and _is_columns(want):
        assert _is_columns(got), (where, type(got))
        assert_same_rows(got, want, rtol)
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (where, sorted(got) if isinstance(got, dict) else got,
             sorted(want))
        for k in want:
            assert_same(got[k], want[k], rtol, rows, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, rtol, rows, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        _same_array(got, want, rtol, where)
    elif isinstance(want, float) or isinstance(got, float):
        np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                                   atol=rtol, err_msg=where)
    else:
        assert got == want, (where, got, want)
