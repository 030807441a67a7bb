"""The one module of the benchmark that imports the program (`repro_torch`):
the system under test, driven through its own entry points.

- `model_config`: the program's configuration, from the settings the
  configuration's family gives (`families/<family>.py`'s `program`);
- `model`: the program's model of a configuration, given the benchmark's
  weights (`weights.load`);
- `pipeline`: the corpus loaded into a `SharkSession` and the SQL-fed
  `TokenPipeline` over it;
- `trainer`: `training.make_train_step` and `init_opt_state`;
- `engine`: `serving.ServeEngine`; `first_logits` keeps the logits its
  prefill returns, from which it chooses each batch's first tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import List

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.core import DType, Schema, SharkSession
from repro_torch.data import TokenPipeline
from repro_torch.models import lm
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.serving import ServeEngine
from repro_torch.serving import engine as _engine
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

from . import weights
from .spec import Spec, family


# the program's classes of the nested configurations a family's
# `program(spec)` gives as dicts
NESTED = {"ssm": SSMConfig, "moe": MoEConfig, "mla": MLAConfig}


def model_config(spec: Spec) -> ModelConfig:
    """The program's configuration of the published widths: the keyword
    values of the family's `program(spec)` that `ModelConfig` declares; its
    run-time options are the program's defaults.  A value it does not
    declare is left out, and named on standard error: the program then
    departs from the configuration there."""
    declared = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = family(spec).program(spec)
    for k in sorted(set(kw) - declared):
        print(f"shark_bench: the program's ModelConfig declares no {k!r}; "
              f"{spec.name}'s {k}={kw[k]!r} is left out", file=sys.stderr,
              flush=True)
    return ModelConfig(**{k: NESTED[k](**v) if k in NESTED else v
                          for k, v in kw.items() if k in declared})


def model(spec: Spec, seed: int, device, cfg: ModelConfig = None):
    """The program's model with the benchmark's weights from `seed`.  It is
    built where it runs, and its own draws are overwritten: on the meta
    device `torch.randn` imports `torch._dynamo`, about 10 s of set-up."""
    m = lm.build_model(cfg or model_config(spec), device,
                       torch.Generator(device=device).manual_seed(0))
    weights.load(spec, seed, dict(m.named_parameters()))
    return m


def pipeline(cols: dict, partitions: int, sql_filter: str, seq: int,
             batch: int, seed: int, device):
    """(session, pipeline): the corpus columns in a session's memory store,
    selected by `sql_filter`."""
    sess = SharkSession(num_workers=4, max_threads=4, device=device)
    schema = Schema.of(doc=DType.INT64, pos=DType.INT32, tok=DType.INT32,
                       quality=DType.FLOAT32)
    sess.create_table("corpus", schema, cols, num_partitions=partitions)
    return sess, TokenPipeline(sess, "corpus", seq, batch,
                               sql_filter=sql_filter, seed=seed)


def trainer(cfg: ModelConfig, m, opt: dict):
    """(train_step, opt_state): the program's AdamW step and its state."""
    fields = {f.name for f in dataclasses.fields(AdamWConfig)}
    step = make_train_step(cfg, AdamWConfig(
        **{k: v for k, v in opt.items() if k in fields}))
    return step, init_opt_state(dict(m.named_parameters()))


def engine(cfg: ModelConfig, m, max_seq: int) -> ServeEngine:
    return ServeEngine(cfg, m, max_seq=max_seq)


@contextlib.contextmanager
def first_logits(store: List[torch.Tensor]):
    """While open, each prefill the serving engine runs appends to `store`
    the last position's logits it returned, (B, V) float32 on the device:
    the tensor itself, not a copy, so the timed path does no more work."""
    inner = _engine.lm.prefill_fn

    def prefill_fn(*args, **kw):
        logits, caches = inner(*args, **kw)
        store.append(logits[:, -1])
        return logits, caches
    _engine.lm.prefill_fn = prefill_fn
    try:
        yield store
    finally:
        _engine.lm.prefill_fn = inner
