"""The torch port stands alone: importing it pulls in neither JAX nor any
module of the reference package, and a session computes on the GPU unless
the caller asks for the CPU — training included."""

import subprocess
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={"PYTHONPATH": SRC,
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_import_pulls_in_no_jax_and_no_reference():
    out = _run(
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.ref, repro_torch.ml\n"
        "import repro_torch.kernels.train_grad\n"
        "import repro_torch.kernels.topk_similarity\n"
        "import repro_torch.kernels.dictdecode\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssd_scan\n"
        "import repro_torch.models, repro_torch.models.lm\n"
        "import repro_torch.models.convert, repro_torch.models.flash\n"
        "import repro_torch.configs, repro_torch.serving\n"
        "import repro_torch.configs.yi_9b, repro_torch.configs.qwen2_5_3b\n"
        "import repro_torch.configs.phi3_medium_14b\n"
        "import repro_torch.configs.starcoder2_15b\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.server, repro_torch.server.memory\n"
        "import repro_torch.core.storage\n"
        "import repro_torch.cluster, repro_torch.cluster.mesh\n"
        "import repro_torch.cluster.shard_exec, repro_torch.cluster.fleet\n"
        "import repro_torch.training, repro_torch.training.pde_moe\n"
        "import repro_torch.checkpoint, repro_torch.data\n"
        "import repro_torch.launch.train, repro_torch.launch.mesh\n"
        "import repro_torch.parallel, repro_torch.parallel.compat\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.')))\n"
        "print(bad)")
    assert out == "[]"


EXAMPLES = ("multi_tenant", "pde_moe_training", "quickstart", "serve_lm",
            "sql_ml_pipeline", "train_lm")
_LOAD_EXAMPLE = (
    "import importlib.util, sys\n"
    "def load(name):\n"
    f"    path = {str(Path(SRC).parent / 'examples_torch')!r} + '/' + name + "
    "'.py'\n"
    "    spec = importlib.util.spec_from_file_location(name, path)\n"
    "    mod = importlib.util.module_from_spec(spec)\n"
    "    spec.loader.exec_module(mod)\n"
    "    return mod\n")


def test_examples_import_no_jax_and_no_reference():
    out = _run(
        _LOAD_EXAMPLE +
        f"mods = [load(n) for n in {EXAMPLES!r}]\n"
        "assert all(callable(m.main) for m in mods)\n"
        "import repro_torch.parallel, repro_torch.launch.mesh\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.')))\n"
        "print(bad)")
    assert out == "[]"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_device_needs_a_card(name):
    """Each example of examples_torch/ run without `--device` computes on
    the card, and raises on a host without one rather than run on the
    CPU."""
    out = _run(
        _LOAD_EXAMPLE +
        "import torch\n"
        "if torch.cuda.is_available():\n"
        "    print('card')\n"
        "else:\n"
        "    try:\n"
        f"        load({name!r}).main([])\n"
        "        print('no-raise')\n"
        "    except RuntimeError as e:\n"
        "        print('raised', 'CUDA' in str(e))\n")
    if out == "card":
        pytest.skip("a CUDA device is present")
    assert out == "raised True"


def test_session_without_device_needs_a_card():
    out = _run(
        "import torch\n"
        "from repro_torch.core import SharkSession\n"
        "if torch.cuda.is_available():\n"
        "    print('card')\n"
        "else:\n"
        "    try:\n"
        "        SharkSession()\n"
        "        print('no-raise')\n"
        "    except RuntimeError:\n"
        "        print('raised')\n")
    if out == "card":
        pytest.skip("a CUDA device is present")
    assert out == "raised"


def test_server_without_device_needs_a_card():
    """`SharkServer()` with no `device=` computes on the card, and raises
    on a host without one rather than running on the CPU."""
    out = _run(
        "import threading, torch\n"
        "from repro_torch.server import SharkServer\n"
        "if torch.cuda.is_available():\n"
        "    print('card')\n"
        "else:\n"
        "    before = threading.active_count()\n"
        "    try:\n"
        "        SharkServer()\n"
        "        print('no-raise')\n"
        "    except RuntimeError:\n"
        "        print('raised', threading.active_count() - before)\n")
    if out == "card":
        pytest.skip("a CUDA device is present")
    assert out == "raised 0"


def test_model_without_device_needs_a_card():
    out = _run(
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import lm\n"
        "if torch.cuda.is_available():\n"
        "    print('card')\n"
        "else:\n"
        "    try:\n"
        "        lm.build_model(get_config('zamba2-7b-smoke'))\n"
        "        print('no-raise')\n"
        "    except RuntimeError:\n"
        "        print('raised')\n")
    if out == "card":
        pytest.skip("a CUDA device is present")
    assert out == "raised"


def test_unported_paths_raise(tmp_path):
    import torch

    from repro_torch.cluster import MeshContext
    from repro_torch.configs import get_config
    from repro_torch.core import SharkSession
    from repro_torch.models.lm import build_model
    from repro_torch.server import SharkServer
    # the storage tier is ported: spill_dir= builds a spill-mode tier
    srv = SharkServer(device="cpu", spill_dir=str(tmp_path))
    assert srv.storage.mode == "spill" and srv.memory.storage is srv.storage
    srv.shutdown()
    # the cluster tier is ported: mesh= takes a MeshContext of CPU slots
    mesh = MeshContext(devices=[torch.device("cpu")] * 2)
    sess = SharkSession(device="cpu", mesh=mesh)
    assert sess.executor.mesh is mesh
    sess.shutdown()
    srv = SharkServer(device="cpu", mesh=mesh)
    assert srv.make_executor().mesh is mesh
    srv.shutdown()
    # every LM family and option is ported: expert parallelism builds,
    # and with no mesh it is moe_apply
    import dataclasses
    assert len(build_model(get_config("yi-9b-smoke"), device="cpu").layers) \
        == 2
    moe = build_model(get_config("phi3.5-moe-42b-a6.6b-smoke"), device="cpu")
    assert len(moe.layers) == 2 and moe.layers[0].moe.w_gate.shape[0] == 8
    vlm = build_model(get_config("llama-3.2-vision-11b-smoke"), device="cpu")
    assert len(vlm.cross_layers) == 2 and len(vlm.self_layers[0]) == 1
    enc = build_model(get_config("whisper-base-smoke"), device="cpu")
    assert len(enc.encoder) == 2 and len(enc.layers) == 2
    ep = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b-smoke"),
                             moe_impl="ep_shardmap")
    from repro_torch.models import lm, moe as moe_mod
    x = torch.randn((2, 4, ep.d_model), generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    layer = build_model(ep, device="cpu").layers[0].moe
    assert torch.equal(moe_mod.moe_apply_ep(layer, x, ep.moe),
                       moe_mod.moe_apply(layer, x, ep.moe))
    assert lm.check_ported(ep) is None
    # the int8 KV cache and bf16 scores are ported: they build
    for kw in (dict(kv_cache_quant=True), dict(attn_scores_dtype="bf16")):
        cfg = dataclasses.replace(get_config("yi-9b-smoke"), **kw)
        assert build_model(cfg, device="cpu").cfg == cfg


def test_training_without_device_needs_a_card():
    """The training CLI with no `--device` trains on the card, and raises
    on a host without one rather than train on the CPU."""
    out = _run(
        "import torch\n"
        "from repro_torch.launch import train\n"
        "if torch.cuda.is_available():\n"
        "    print('card')\n"
        "else:\n"
        "    try:\n"
        "        train.main(['--steps', '1'])\n"
        "        print('no-raise')\n"
        "    except RuntimeError:\n"
        "        print('raised')\n")
    if out == "card":
        pytest.skip("a CUDA device is present")
    assert out == "raised"


def test_cpu_session_trains_on_the_cpu():
    """A device="cpu" session trains on the CPU with the CPU's routes, on
    a host with a card too: no kernel launches, no CUDA tensor."""
    import numpy as np
    import torch

    from repro_torch.core import DType, Schema, SharkSession
    from repro_torch.kernels import ops
    from repro_torch.ml import KMeans, LogisticRegression
    from repro_torch.ml import trainer

    rng = np.random.default_rng(0)
    data = {f"f{i}": rng.integers(0, 9, 20_000).astype(np.int64)
            for i in range(3)}
    data["y"] = rng.integers(0, 2, 20_000).astype(np.int64)
    sess = SharkSession(num_workers=2, max_threads=2, device="cpu")
    sess.create_table("t", Schema.of(**{c: DType.INT64 for c in data}), data,
                      num_partitions=4)
    seen = []
    orig = trainer.partition_grad

    def spy(*args, **kw):
        route, g = orig(*args, **kw)
        seen.append((args[7], route))
        return route, g

    ops.reset_launch_counts()
    trainer.partition_grad = spy
    try:
        clf = LogisticRegression(dims=3, iterations=2).fit(
            sess.table("t"), ["f0", "f1", "f2"], "y")
        KMeans(k=2, dims=3, iterations=2).fit(sess.table("t"),
                                              ["f0", "f1", "f2"], "y")
    finally:
        trainer.partition_grad = orig
        sess.shutdown()
    assert {r for _, r in seen} == {"jit"}, seen
    assert all(torch.device(dev).type == "cpu" for dev, _ in seen)
    assert clf.metrics.segment_routes() == {"jit": 8}
    assert set(ops.launch_counts().values()) == {0}
