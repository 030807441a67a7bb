"""Expert parallelism (`moe_impl="ep_shardmap"`, `models/moe.moe_apply_ep`)
against the JAX reference's `moe_apply_ep`, on CPU slots.

The reference's EP needs a mesh of 8 host devices, so it runs once for
the module in a subprocess under
`XLA_FLAGS=--xla_force_host_platform_device_count=8` (with the repo-root
conftest's `enable_x64` alias) and writes numpy; the port runs on
`[cpu] * 8` slots (`launch.mesh.make_debug_mesh(..., device="cpu")`).
Tolerances, relative to the reference tensor's largest magnitude:

- the layer (both MoE smoke configs' experts, `n_shared` 0 and 2, float32,
  meshes (2, 4), (1, 4) and (4, 2), capacity 4.0 and 1.0, where slots
  drop): y and the gradients of a seeded weighted sum with respect to x
  and every weight to 1e-5; `expert_load` exactly equal,
  `frac_dropped` and `router_entropy` exactly 0 on both sides;
- the model (both smoke configs with `moe_impl="ep_shardmap"` under a
  (2, 4) mesh, float32): prefill logits, the loss and every parameter's
  gradient to 1e-4;
- the twin of tests/test_perf_variants.py's
  `test_moe_ep_matches_gspmd_subprocess`: the port's EP against its
  `moe_apply` in bf16 on the reference test's configuration and seed, to
  its 1e-2;
- every fallback (no mesh, no `model` axis, S or E not divisible by the
  `model` axis) is `moe_apply` bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import convert, lm
from repro_torch.models import moe as tmoe
from repro_torch.parallel import make_mesh, set_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHI = "phi3.5-moe-42b-a6.6b-smoke"
DS = "deepseek-v2-lite-16b-smoke"
MESHES = ((2, 4), (1, 4), (4, 2))
CAPACITIES = (4.0, 1.0)
B, S, MAXS = 4, 16, 24
LAYER_CASES = [(arch, mesh, cf) for arch in (PHI, DS) for mesh in MESHES
               for cf in CAPACITIES]


def case_name(arch, mesh, cf) -> str:
    return f"{arch.split('-')[0]}.{mesh[0]}x{mesh[1]}.{cf:g}"


def layer_inputs(arch, mesh, cf):
    """The layer's config, and x and the weights of the summed output,
    (B, S, D) float32 from a seed of the case."""
    cfg = dataclasses.replace(jget_config(arch).moe, capacity_factor=cf)
    seed = LAYER_CASES.index((arch, mesh, cf))
    rng = np.random.default_rng(100 + seed)
    d = jget_config(arch).d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    w = rng.normal(size=(B, S, d)).astype(np.float32)
    return cfg, x, w


def model_batch(arch):
    rng = np.random.default_rng(7)
    vocab = jget_config(arch).vocab
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def ep_config(cfg):
    return dataclasses.replace(cfg, moe_impl="ep_shardmap")


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
import test_torch_moe_ep as t
from repro.configs import get_config
from repro.launch.mesh import make_debug_mesh
from repro.models import lm, moe
from repro.parallel.compat import set_mesh

assert len(jax.devices()) == 8, jax.devices()
f32 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def flat(prefix, tree, dump):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) for k in path)
        dump[f"{prefix}/{key}"] = np.asarray(leaf)


dump = {}
for arch, mesh, cf in t.LAYER_CASES:
    name = t.case_name(arch, mesh, cf)
    cfg, x, w = t.layer_inputs(arch, mesh, cf)
    p = f32(moe.moe_init(jax.random.PRNGKey(3), x.shape[-1], cfg)[0])
    x, w = jnp.asarray(x), jnp.asarray(w)
    with set_mesh(make_debug_mesh(*mesh)):
        y, st = jax.jit(lambda p, x: moe.moe_apply_ep(
            p, x, cfg, return_stats=True))(p, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(
            moe.moe_apply_ep(p, x, cfg) * w), argnums=(0, 1)))(p, x)
    dump[name + "/y"] = np.asarray(y)
    for k, v in st.items():
        dump[f"{name}/{k}"] = np.asarray(v)
    dump[name + "/grad/x"] = np.asarray(gx)
    flat(name + "/grad", gp, dump)
for arch in (t.PHI, t.DS):
    cfg = t.ep_config(get_config(arch))
    params = f32(lm.init_params(cfg, jax.random.PRNGKey(0))[0])
    batch = {k: jnp.asarray(v) for k, v in t.model_batch(arch).items()}
    with set_mesh(make_debug_mesh(2, 4)):
        logits, _ = jax.jit(lambda p, b: lm.prefill_fn(cfg, p, b, t.MAXS))(
            params, {"tokens": batch["tokens"]})
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: lm.loss_fn(cfg, p, batch)))(params)
    dump[arch + "/logits"] = np.asarray(logits)
    dump[arch + "/loss"] = np.asarray(loss)
    flat(arch + "/grad", g, dump)
np.savez(sys.argv[1], **dump)
print("REFERENCE_OK")
"""


def _unflatten(dump, prefix):
    tree = {}
    for key in dump.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = dump[key]
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(out), REPO],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0 and "REFERENCE_OK" in run.stdout, \
        run.stdout + run.stderr
    return np.load(out)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _layer(d, cfg, dtype=jnp.float32, key=3):
    params = jax.tree.map(lambda a: a.astype(dtype),
                          jmoe.moe_init(jax.random.PRNGKey(key), d, cfg)[0])
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    p = tmoe.MoE(d, cfg, tdtype, "cpu")
    p.load_state_dict({k: convert.to_torch(np.asarray(v))
                       for k, v in params.items()}, strict=True)
    return p


def _cpu_mesh(data, model):
    return make_debug_mesh(data, model, device="cpu")


@pytest.mark.parametrize("arch,mesh,cf", LAYER_CASES,
                         ids=[case_name(*c) for c in LAYER_CASES])
def test_ep_layer_matches_reference(reference, arch, mesh, cf):
    name = case_name(arch, mesh, cf)
    cfg, x, w = layer_inputs(arch, mesh, cf)
    p = _layer(x.shape[-1], cfg)
    for q in p.parameters():
        q.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with set_mesh(_cpu_mesh(*mesh)):
        y, st = tmoe.moe_apply_ep(p, xt, cfg, return_stats=True)
    assert y.shape == xt.shape and y.dtype == torch.float32
    assert _rel(y, reference[name + "/y"]) < 1e-5
    np.testing.assert_array_equal(st["expert_load"].numpy(),
                                  reference[name + "/expert_load"])
    for k in ("frac_dropped", "router_entropy"):
        assert float(st[k]) == 0.0 == float(reference[f"{name}/{k}"])
    names = [n for n, _ in p.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                [xt, *p.parameters()])
    assert _rel(grads[0], reference[name + "/grad/x"]) < 1e-5
    for n, g in zip(names, grads[1:]):
        assert _rel(g, reference[f"{name}/grad/{n}"]) < 1e-5, n
    if cf == 1.0:
        # slots drop here: EP is not moe_apply's function
        assert _rel(y, tmoe.moe_apply(p, xt, cfg).detach()) > 1e-3


@pytest.mark.parametrize("arch", [PHI, DS])
def test_ep_prefill_matches_reference(reference, arch):
    cfg = ep_config(get_config(arch))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jlm.init_params(ep_config(jget_config(arch)),
                                          jax.random.PRNGKey(0))[0])
    model = convert.params_from_jax(params, cfg, lm.build_model(cfg, "cpu"))
    toks = torch.from_numpy(model_batch(arch)["tokens"])
    with set_mesh(_cpu_mesh(2, 4)):
        logits, _ = lm.prefill_fn(cfg, model, {"tokens": toks}, MAXS)
    assert _rel(logits, reference[arch + "/logits"]) < 1e-4


@pytest.mark.parametrize("arch", [PHI, DS])
def test_ep_loss_and_gradients_match_reference(reference, arch):
    cfg = ep_config(get_config(arch))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jlm.init_params(ep_config(jget_config(arch)),
                                          jax.random.PRNGKey(0))[0])
    model = convert.params_from_jax(params, cfg, lm.build_model(cfg, "cpu"))
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in model_batch(arch).items()}
    with set_mesh(_cpu_mesh(2, 4)):
        loss = lm.loss_fn(cfg, model, batch)
    # the backward runs after the mesh has exited: remat's recomputation
    # re-enters the forward's mesh
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert _rel(loss, reference[arch + "/loss"]) < 1e-4
    want = convert.state_from_jax(_unflatten(reference, arch + "/grad"), cfg)
    for (n, _), g in zip(model.named_parameters(), grads):
        assert _rel(g, want[n]) < 1e-4, n


def test_ep_matches_moe_apply_bf16():
    """Twin of tests/test_perf_variants.py's
    `test_moe_ep_matches_gspmd_subprocess`: its configuration, seed and
    bound, on 8 CPU slots."""
    cfg = tmoe.MoEConfig(num_experts=8, top_k=2, d_expert=32,
                         capacity_factor=4.0)
    p = _layer(64, cfg, jnp.bfloat16, key=0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 16, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    with set_mesh(_cpu_mesh(2, 4)):
        y1 = tmoe.moe_apply(p, x, cfg)
        y2 = tmoe.moe_apply_ep(p, x, cfg)
    assert y2.dtype == torch.bfloat16
    rel = float((y1.float() - y2.float()).abs().max())
    assert rel < 1e-2, rel


FALLBACKS = {
    "no_mesh": (None, S),
    "no_model_axis": (lambda: make_mesh((8,), ("data",), ["cpu"] * 8), S),
    "s_not_divisible": (lambda: _cpu_mesh(2, 4), S - 1),
    "e_not_divisible": (lambda: _cpu_mesh(1, 3), S),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_are_moe_apply_bit_for_bit(case):
    make, s = FALLBACKS[case]
    cfg = dataclasses.replace(get_config(DS).moe, capacity_factor=1.0)
    p = _layer(64, cfg)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, s, 64)).astype(np.float32))
    with set_mesh(make() if make else None):
        got, got_st = tmoe.moe_apply_ep(p, x, cfg, return_stats=True)
    want, want_st = tmoe.moe_apply(p, x, cfg, return_stats=True)
    assert float(want_st["frac_dropped"]) > 0, "the case must drop"
    assert torch.equal(got, want)
    for k in want_st:
        assert torch.equal(got_st[k], want_st[k]), k


def test_batch_not_split_by_the_batch_axes_raises():
    cfg = get_config(PHI).moe
    p = _layer(64, cfg)
    with set_mesh(_cpu_mesh(4, 2)), pytest.raises(ValueError, match="batch"):
        tmoe.moe_apply_ep(p, torch.zeros((2, S, 64)), cfg)
