"""The one module of the benchmark that imports the program (`repro_torch`):
the system under test, driven through its own entry points.

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
from typing import List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import DType, Schema, SharkSession
from repro_torch.data import TokenPipeline
from repro_torch.models import lm
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.serving import ServeEngine
from repro_torch.serving import engine as _engine
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

from . import weights
from .spec import Spec


def model_config(spec: Spec) -> ModelConfig:
    """The program's configuration of the published widths; its run-time
    options are the program's defaults."""
    if spec.family == "dense":
        return ModelConfig(
            name=spec.name, family="dense", n_layers=spec.n_layers,
            d_model=spec.d_model, n_heads=spec.n_heads,
            n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff, vocab=spec.vocab,
            head_dim=spec.head_dim, norm="rms", mlp="swiglu",
            qkv_bias=spec.qkv_bias, rope_theta=spec.rope_theta,
            tie_embeddings=spec.tied)
    return ModelConfig(
        name=spec.name, family="ssm", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=spec.vocab, norm="rms", rope_theta=0.0,
        tie_embeddings=spec.tied,
        ssm=SSMConfig(d_state=spec.d_state, expand=spec.expand,
                      headdim=spec.headdim, ngroups=spec.ngroups,
                      d_conv=spec.d_conv, chunk=spec.chunk),
        sub_quadratic=True)


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
