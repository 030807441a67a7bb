"""Twin of tests/test_elastic.py on the port: a checkpoint taken on one
mesh restores and trains on a different one.

The reference trains 3 steps on a (data=4, model=2) mesh of host devices,
checkpoints, restores, and takes step 4 on (2, 2) and again on (4, 2): the
same loss both times, within 1e-2.  The port's meshes are CPU slots
(`launch.mesh.make_debug_mesh(..., device="cpu")`).  Its AdamW updates
the restored state in place, so each mesh's step 4 starts from its own
restore.  The dense case reads no mesh (the port places no tensor by
it); the second case trains Phi-3.5-MoE's smoke variant with
`moe_impl="ep_shardmap"` at its drop-free capacity, so the experts run
over 8 slots on (4, 2) and over 4 on (2, 2), and the two steps compute
the same function.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.parallel import set_mesh
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

CASES = {
    "dense": get_config("qwen2.5-3b-smoke"),
    "moe_ep": dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b-smoke"),
                                  moe_impl="ep_shardmap"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_elastic_mesh_resize(case, tmp_path):
    cfg = CASES[case]
    if cfg.moe is not None:
        moe = cfg.moe
        assert moe.capacity_factor == moe.num_experts / moe.top_k
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))

    def fresh():
        model = lm.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
        return model, init_opt_state(dict(model.named_parameters()))

    model, opt = fresh()
    with set_mesh(make_debug_mesh(4, 2, device="cpu")):
        for _ in range(3):
            model, opt, m = step(model, opt, batch)
    assert np.isfinite(float(m["loss"]))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, {"params": dict(model.named_parameters()), "opt": opt})
    mgr.wait()

    def step4_on(data, model_axis):
        # "pod failure": a fresh process restores onto another mesh
        model, opt = fresh()
        params = dict(model.named_parameters())
        restored, man = mgr.restore_latest({"params": params, "opt": opt})
        assert man["step"] == 3
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(restored["params"][n])
        with set_mesh(make_debug_mesh(data, model_axis, device="cpu")):
            _, o, m = step(model, restored["opt"], batch)
        assert int(o["step"]) == 4
        return float(m["loss"])

    loss_b = step4_on(2, 2)
    assert np.isfinite(loss_b)
    loss_c = step4_on(4, 2)          # and scale up again
    # same step from the same checkpoint on different meshes: same loss
    assert abs(loss_b - loss_c) < 1e-2
