"""The port's LM examples (`examples_torch/serve_lm.py`, `train_lm.py`,
`pde_moe_training.py`), each run in a subprocess with `--device cpu`.

- `serve_lm` prints its (8, 48) generation;
- `train_lm` with `--steps 20 --ckpt-every 5 --simulate-preemption 10`
  (the example's own arguments save only every 100 steps, so a
  preemption at step 10 would find no checkpoint) replays from step 10
  and writes its final checkpoint at step 20;
- `pde_moe_training` beside the reference's `examples/pde_moe_training.py`,
  on the reference's weights (`lm.init_params` at key 0, carried into the
  port's `lm.build_model` by `models/convert.params_from_jax` in the
  subprocess, as the other twins carry them): the same capacity factor
  at every printed step (4.0, then 2.0 from step 10), the same number of
  step variants, and the step-0 loss within rel 1e-3 (bf16; both print
  6.3366 on this seed).
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from test_torch_examples import REPO, run_example

PHI = "phi3.5-moe-42b-a6.6b-smoke"

_WITH_REFERENCE_WEIGHTS = r"""
import sys, runpy
import numpy as np, torch
from repro_torch.models import convert, lm
leaves = np.load(sys.argv[1])
tree = {}
for key in leaves.files:
    node = tree
    *path, leaf = key.split("/")
    for part in path:
        node = node.setdefault(part, {})
    node[leaf] = leaves[key]
build = lm.build_model


def build_model(cfg, device=None, generator=None):
    model = build(cfg, device, generator)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    model = convert.params_from_jax(tree, cfg, model)
    for n, p in model.named_parameters():
        p.data = p.data.to(dtypes[n])
    return model


lm.build_model = build_model
sys.argv = [sys.argv[2]] + sys.argv[3:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def test_serve_lm_example_generates():
    out = run_example("repro_torch", "serve_lm", "--device", "cpu")
    assert re.search(r"^generated \(8, 48\) on cpu in ", out, re.M), out


def test_train_lm_example_resumes_and_checkpoints(tmp_path):
    ck = tmp_path / "ck"
    out = run_example("repro_torch", "train_lm", "--device", "cpu",
                      "--steps", "20", "--ckpt-every", "5",
                      "--simulate-preemption", "10", "--ckpt-dir", str(ck))
    assert "SIMULATED PREEMPTION at step 10" in out, out
    assert re.search(r"^done; final checkpoint at 20$", out, re.M), out
    with open(ck / "step_00000020" / "manifest.json") as f:
        man = json.load(f)
    assert man["step"] == 20 and man["pipeline"]["step"] == 20


def _steps(out: str) -> list:
    return [(int(s), float(loss), float(cf), int(n)) for s, loss, cf, n in
            re.findall(r"^step +(\d+) loss ([0-9.]+) cf=([0-9.]+) "
                       r"\w+=(\d+)$", out, re.M)]


def test_pde_moe_training_example_matches_reference(tmp_path):
    params, _ = jlm.init_params(jget_config(PHI), jax.random.PRNGKey(0))
    leaves = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
              for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    weights = tmp_path / "weights.npz"
    np.savez(weights, **leaves)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", _WITH_REFERENCE_WEIGHTS, str(weights),
         os.path.join(REPO, "examples_torch", "pde_moe_training.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    port, ref = _steps(run.stdout), _steps(run_example("repro",
                                                       "pde_moe_training"))
    assert [s[0] for s in port] == list(range(0, 30, 5))
    assert [(s, cf, n) for s, _, cf, n in port] == \
        [(s, cf, n) for s, _, cf, n in ref]
    assert [cf for _, _, cf, _ in port[:3]] == [4.0, 4.0, 2.0]
    assert abs(port[0][1] - ref[0][1]) / ref[0][1] < 1e-3
    last = run.stdout.strip().splitlines()[-1]
    assert last == f"done; the step cache held {port[-1][3]} capacity " \
                   f"variants"
