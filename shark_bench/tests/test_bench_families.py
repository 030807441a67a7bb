"""The families as files: for Qwen2.5-3B (dense) and Mamba2-370m (ssm) the
Spec, the leaves, the work formulas and the program's configuration are
value for value, and at smoke sizes the weights drawn from the seed and
the reference's loss, gradients and logits bit for bit, what the harness
gave before the families moved into `families/` and `reference/`
(`golden_families.json`, written by that harness on the CPU).  A family
the benchmark does not have fails by naming its missing file; and the
configuration's epsilon reaches the program where its `ModelConfig`
declares `norm_eps`, and is named as left out where it does not."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil

import pytest
import torch

from conftest import BENCH, smoke_config
from shark_bench import port, spec as S, weights, yardstick
from shark_bench.reference import lm as ref_lm
from shark_bench.reference.fp8 import FP8

GOLDEN = json.loads((BENCH / "tests/golden_families.json").read_text())
SHARED = ["name", "family", "n_layers", "d_model", "vocab", "tied", "eps"]
SHAPES = [(1, 1), (3, 100), (4, 2048), (16, 2048), (2, 8192), (1, 32768)]


def digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    return hashlib.sha256(
        f"{t.dtype}{tuple(t.shape)}".encode()
        + t.view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()[:24]


def short(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:24]


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mamba2-370m"])
def test_full_size_as_before(name):
    want = GOLDEN["full"][name]
    spec = S.load_spec(BENCH / "configs" / f"{name}.json")
    got = {k: (getattr(spec, k) if k in SHARED else getattr(spec.sizes, k))
           for k in want["spec"]}
    assert got == want["spec"]
    leaves = [[l.name, list(l.shape), l.dtype, l.init, l.std, l.matmul]
              for l in S.leaves(spec)]
    assert len(leaves) == want["n_leaves"]
    assert short(leaves) == want["leaves"]
    assert short([[l.name for l in c] for c in weights.chunks(spec)]) \
        == want["chunks"]
    assert S.n_params(spec) == want["n_params"]
    assert S.matmul_params(spec) == want["matmul_params"]
    assert [[b, s, list(yardstick.mixer_cost(spec, b, s)),
             yardstick.train_flops(spec, b, s),
             yardstick.prefill_flops(spec, b, s)]
            for b, s in SHAPES] == want["work"]
    assert dataclasses.asdict(port.model_config(spec)) \
        == want["model_config"]


@pytest.mark.parametrize("name", ["qwen", "mamba"])
def test_smoke_weights_and_reference_as_before(tmp_path, name, one_thread,
                                               monkeypatch):
    want = GOLDEN["smoke"][name]
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(smoke_config(name)))
    spec = S.load_spec(p)
    assert {n: digest(v) for n, v in weights.draw_all(
        spec, 2 ** 31 + 9, "cpu").items()} == want["weights"]
    with monkeypatch.context() as m:
        m.setattr(weights, "CHUNK", 5000)
        assert {n: digest(v) for n, v in weights.draw_all(
            spec, 9, "cpu").items()} == want["weights_small_chunks"]
    g = torch.Generator().manual_seed(4)
    tok = torch.randint(0, spec.vocab, (2, 48), generator=g)
    lab = torch.randint(0, spec.vocab, (2, 48), generator=g)
    P = {n: v.requires_grad_(True) for n, v in
         weights.draw_all(spec, 5, "cpu", torch.float32).items()}
    loss = ref_lm.loss(spec, P, tok, lab)
    grads = torch.autograd.grad(loss, list(P.values()))
    assert float(loss.detach()) == want["loss"]
    assert {n: digest(gr) for n, gr in zip(P, grads)} == want["grads"]
    assert digest(ref_lm.last_logits(spec, P, tok)) == want["logits"]
    with torch.no_grad():
        assert float(ref_lm.loss(spec, P, tok, lab, FP8)) == want["fp8_loss"]
    assert digest(ref_lm.last_logits(spec, P, tok, FP8)) == want["fp8_logits"]


def test_a_family_without_its_file_is_named(tmp_path):
    c = smoke_config("qwen")
    c["family"] = "moe"
    p = tmp_path / "moe.json"
    p.write_text(json.dumps(c))
    with pytest.raises(FileNotFoundError, match=r"families/moe\.py"):
        S.load_spec(p)
    spec = S.load_spec(BENCH / "configs/qwen2.5-3b.json")
    lost = dataclasses.replace(spec, bench_dir=tmp_path)
    with pytest.raises(FileNotFoundError, match=r"families/dense\.py"):
        S.leaves(lost)


def test_a_reference_without_its_file_is_named(tmp_path):
    shutil.copytree(BENCH / "families", tmp_path / "families")
    spec = S.load_spec(BENCH / "configs/qwen2.5-3b.json", tmp_path)
    with pytest.raises(FileNotFoundError, match=r"reference/dense\.py"):
        ref_lm.last_logits(spec, {}, torch.zeros((1, 1), dtype=torch.long))


@dataclasses.dataclass(frozen=True)
class WithEps(port.ModelConfig):
    norm_eps: float = 1e-5


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mamba2-370m"])
def test_norm_eps_is_passed_where_the_program_declares_it(
        name, monkeypatch, capsys):
    spec = S.load_spec(BENCH / "configs" / f"{name}.json")
    cfg = port.model_config(spec)
    assert not hasattr(cfg, "norm_eps")
    err = capsys.readouterr().err
    told = [line for line in err.splitlines() if "norm_eps" in line]
    assert len(told) == 1 and repr(spec.eps) in told[0]
    monkeypatch.setattr(port, "ModelConfig", WithEps)
    cfg = port.model_config(spec)
    assert cfg.norm_eps == spec.eps
    assert capsys.readouterr().err == ""
    # every other setting as the program's own ModelConfig has it
    kw = dataclasses.asdict(cfg)
    del kw["norm_eps"]
    assert kw == GOLDEN["full"][name]["model_config"]
