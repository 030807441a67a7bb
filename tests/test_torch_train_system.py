"""The port's training system end to end, on the CPU: the twin of
tests/test_system.py's `test_sql_to_training_pipeline` (the SQL engine
selects the corpus, the same engine feeds the model, the loss falls), the
twin of tests/test_elastic.py (a checkpoint the reference wrote after 3
steps restores into the port and trains on), and the training CLI with
a simulated preemption.

test_elastic.py's mesh resize (4 x 2 -> 2 x 2 -> 4 x 2 host devices) is
twinned on CPU slots in tests/test_torch_elastic.py.  This twin keeps the
rest: the reference trains 3 steps and checkpoints with its CheckpointManager;
the port restores that directory (`restore_checkpoint`, then
`convert.params_from_jax` and `convert.opt_state_from_jax`), takes step 4
on the same batch, and its loss equals the reference's own step 4 from
the same checkpoint: to 1e-4 on float32 weights, to 3e-2 on bf16 ones
(the reference run op by op, as tests/test_torch_lm.py holds bf16).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import init_opt_state as jinit_opt_state
from repro.training import make_train_step as jmake_train_step
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import SharkSession
from repro_torch.data import TokenPipeline, synthetic_corpus
from repro_torch.models import convert, lm
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step)


def test_sql_to_training_pipeline():
    """SQL-selected corpus feeds LM training; loss decreases (the
    reference test's body on the port, its parameters carried over)."""
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    cfg = get_config("mamba2-370m-smoke")
    synthetic_corpus(sess, "corpus", cfg.vocab, n_docs=40, mean_doc_len=128)
    pipe = TokenPipeline(sess, "corpus", 32, 8, sql_filter="quality > 0.2")
    params, _ = jlm.init_params(jget_config("mamba2-370m-smoke"),
                                jax.random.PRNGKey(0))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    lm.build_model(cfg, "cpu"))
    opt_state = init_opt_state(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, AdamWConfig(lr=5e-3))
    losses = []
    for s in range(10):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
        model, opt_state, m = step_fn(model, opt_state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    sess.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_and_trains_on(dtype, tmp_path):
    name = "qwen2.5-3b-smoke"
    jcfg, cfg = jget_config(name), get_config(name)
    rng = np.random.default_rng(0)
    toks, labels = (rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
                    for _ in range(2))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jstep = jmake_train_step(jcfg, JAdamWConfig(lr=1e-3))
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    opt = jinit_opt_state(params)
    fa = jax.jit(jstep)
    for _ in range(3):
        params, opt, _ = fa(params, opt, batch=jb)
    mgr = JCheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"params": params, "opt": opt})
    # the reference's own step 4 from its checkpoint
    restored, man = mgr.restore_latest({"params": params, "opt": opt})
    ctx = jax.disable_jit() if dtype == "bfloat16" else \
        contextlib.nullcontext()
    with ctx:
        _, o2, m2 = jstep(restored["params"], restored["opt"], jb)
    assert int(o2["step"]) == 4

    tree, manifest = restore_checkpoint(str(tmp_path))
    assert manifest["step"] == 3
    model = convert.params_from_jax(tree["params"], cfg,
                                    lm.build_model(cfg, "cpu"))
    assert model.embed.tok.dtype == getattr(torch, dtype)
    opt_state = convert.opt_state_from_jax(tree["opt"], cfg)
    assert int(opt_state["step"]) == 3
    assert opt_state["step"].dtype == torch.int32
    assert set(opt_state["master"]) == {n for n, _ in
                                        model.named_parameters()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    model, opt_state, m = step(model, opt_state, tb)
    assert int(opt_state["step"]) == 4
    tol = 1e-4 if dtype == "float32" else 3e-2
    got, want = float(m["loss"]), float(m2["loss"])
    assert abs(got - want) / abs(want) < tol, (got, want)
    # and on: two more steps, finite
    for _ in range(2):
        model, opt_state, m = step(model, opt_state, tb)
        assert np.isfinite(float(m["loss"]))
    assert int(opt_state["step"]) == 6


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --device cpu` with a simulated
    preemption: finite losses, checkpoints in the reference's layout with
    the pipeline's manifest, the final one at --steps."""
    import json
    import os

    from repro_torch.launch import train
    ck = tmp_path / "ck"
    losses = train.main(["--arch", "qwen2.5-3b-smoke", "--device", "cpu",
                         "--steps", "6", "--seq-len", "16", "--batch", "2",
                         "--ckpt-dir", str(ck), "--ckpt-every", "2",
                         "--simulate-preemption", "4", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "SIMULATED PREEMPTION at step 4" in out
    assert all(np.isfinite(losses)) and len(losses) == 6 + 4 - 2
    steps = sorted(os.listdir(ck))
    assert steps[-1] == "step_00000006" and len(steps) <= 2
    with open(ck / "step_00000006" / "manifest.json") as f:
        man = json.load(f)
    assert man["pipeline"]["step"] == 6
    assert man["leaves"]["params/embed.tok"]["dtype"] == "bfloat16"
    assert man["leaves"]["opt/step"]["dtype"] == "int32"
