"""A model configuration file as the benchmark reads it: the published
widths (`configs/<name>.json`, keys as the source's config.json names them)
in one shape that the weights, the reference and the work formulas share.

What differs between model families lives in two files found by the
configuration's `family`, as kinds and per-layer readers are (`found`).
`families/<family>.py` imports nothing of the program and holds:
- `fields(c)`: the configuration's keys as the Spec's shared fields
  (`n_layers`, `d_model`, `vocab`, `tied`, `eps`) and `sizes`, the
  family's own widths in a form it defines;
- `leaves(spec)`: the layers' leaves in draw order, after the shared
  embedding, head and final norm; `INITS` ({init: ("normal" | "uniform",
  value from that sample)}) for any `init` of its own;
- `mixer_cost(spec, b, s)`: one layer's sequence mixer, (bytes, flops) of
  a forward over b x s; `flops_per_token(spec)`: a layer's further FLOPs a
  token; `kernels(spec, b, s)`: {kernel: (calls, (bytes, flops) a call)}
  of one pass over b x s, for the per-layer readers' rooflines;
- `program(spec)`: the program's configuration as plain keyword values,
  nested ones as dicts (`port.py` builds them).
`reference/<family>.py` holds the family's plain float32 block,
`block(spec, prec, P, i, x)`.  Here is only what every family shares.

Nothing here imports the program: the adapter (`port.py`) turns a `Spec`
into the program's own configuration.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, List, Tuple

HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def found(bench_dir: Path, folder: str, name: str) -> ModuleType:
    """The module `bench_dir/folder/<name>.py`, loaded once."""
    path = Path(bench_dir) / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: the benchmark has no "
                                f"{name!r} under {folder}/")
    mod_name = (f"shark_bench_{folder}_"
                + name.replace(".", "_").replace("-", "_"))
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_name] = mod       # dataclasses look their module up
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Spec:
    name: str
    family: str                 # families/<family>.py reads the rest
    n_layers: int
    d_model: int
    vocab: int                  # rows of the embedding (padded, as run)
    tied: bool
    eps: float
    sizes: Any                  # the family's own widths, in its own form
    bench_dir: Path = dataclasses.field(default=HERE, compare=False,
                                        repr=False)


def family(spec: Spec) -> ModuleType:
    """`families/<family>.py` of the spec's benchmark."""
    return found(spec.bench_dir, "families", spec.family)


def reference(spec: Spec) -> ModuleType:
    """`reference/<family>.py`: the family's plain float32 block."""
    return found(spec.bench_dir, "reference", spec.family)


def load_spec(path: Path, bench_dir: Path = HERE) -> Spec:
    """The Spec of one configuration file, read by its family's
    `fields` in `bench_dir/families/`."""
    c = json.loads(Path(path).read_text())
    fam = found(bench_dir, "families", c["family"])
    return Spec(name=c["name"], family=c["family"], bench_dir=bench_dir,
                **fam.fields(c))


# ---------------------------------------------------------------------------
# Leaves: every parameter, by the name the model's state uses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: str                  # "bfloat16" | "float32"
    init: str                   # how weights.py draws it
    std: float = 0.0
    matmul: bool = False        # a weight of a matrix product (model FLOPs)


def mat(name: str, i: int, o: int, std: float = None) -> Leaf:
    """A matrix of y = x @ w, w of shape (in, out), in bfloat16, drawn
    N(0, std^2) (by default std = in^-1/2)."""
    return Leaf(name, (i, o), "bfloat16", "normal",
                std if std is not None else i ** -0.5, True)


def vec(name: str, n: int, init: str, dtype: str = "float32",
        std: float = 0.0) -> Leaf:
    return Leaf(name, (n,), dtype, init, std)


def leaves(spec: Spec) -> List[Leaf]:
    """Every parameter of the model in the order the weights are drawn:
    the embedding, the untied head, the final norm, then the family's
    layers.  Matrices and biases in bfloat16, norms in float32."""
    d = spec.d_model
    out = [Leaf("embed.tok", (spec.vocab, d), "bfloat16", "normal", 0.02,
                spec.tied)]
    if not spec.tied:
        out.append(mat("lm_head", d, spec.vocab))
    out.append(vec("final_norm.w", d, "norm"))
    return out + family(spec).leaves(spec)


def n_params(spec: Spec) -> int:
    return sum(math.prod(leaf.shape) for leaf in leaves(spec))


def matmul_params(spec: Spec) -> int:
    """Weights that take part in a matrix product for every token: the
    layers' matrices and the head (the tied embedding counts as the head;
    an untied embedding is a lookup)."""
    return sum(math.prod(leaf.shape) for leaf in leaves(spec)
               if leaf.matmul)


def head_params(spec: Spec) -> int:
    return spec.d_model * spec.vocab
