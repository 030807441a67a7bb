"""BENCHMARK.json against its required form; the files each entry names;
that a run loads neither JAX nor the JAX package and the reference nothing
of the program; that new cells, configurations, traffic and per-layer
metrics, kinds and model families are picked up as new files; and that the
control fails the limits."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO, make_root, smoke_cell, smoke_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_form():
    m = manifest()
    assert set(m) == KEYS["top"]
    assert m["paths"] == ["shark_bench"] and 1 <= m["run_seconds"] <= 51
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    assert len(names) == len(set(names))
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert p["moves"] in e2e
        for w in p.get("workloads", []):
            assert w in cells
            assert w in e2e[p["moves"]].get("workloads", cells)
        if "roofline" in p["name"] or "mfu" in p["name"]:
            assert p["unit"] == "%"
    for w in m["workloads"]:
        assert w["chips"] in (1, 4)
        reported = [e for e in m["end_to_end"]
                    if w["name"] in e.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w["name"] in p.get("workloads", [w["name"]])
                   for p in m["per_layer"])


def test_every_name_has_its_files():
    m = manifest()
    for c in m["configs"]:
        assert (REPO / c["file"]).exists()
        assert c["file"] == f"shark_bench/configs/{c['name']}.json"
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"]
    for w in m["workloads"]:
        traffic = json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{traffic['kind']}.py").exists()
        assert json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())["limits"]
    for p in m["per_layer"]:
        assert (BENCH / "metrics" / f"{p['name']}.py").exists()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"repro", "repro_torch", "jax", "jaxlib"}, path


def test_a_run_loads_no_jax(smoke_root):
    """A whole run in a fresh process: nothing it loads has the top-level
    name jax, jaxlib, flax or repro (repro_torch is another name)."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(smoke_root)!r}, {str(REPO)!r}, "
        f"{str(REPO / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from shark_bench import bench\n"
        "from shark_bench.run import loaded_forbidden\n"
        f"root = Path({str(smoke_root)!r})\n"
        "cell = bench.load_cell(root, 'qwen2.5-3b.prefill-mix-smoke', "
        "root / 'shark_bench')\n"
        "out = bench.run(cell, 3, 0.5, True, 'cpu', time.perf_counter())\n"
        "assert out['correct']\n"
        "print(loaded_forbidden(), 'repro_torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=smoke_root)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from shark_bench import run
    for name in [m for m in sys.modules if m.split(".")[0] == "repro"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in run.loaded_forbidden()


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and shark_bench/, the
    command exits with another code than 0 and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "shark_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    res = subprocess.run(
        [sys.executable, "shark_bench/run.py", "--workload",
         "mamba2-370m.train-16x2k", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_new_files_are_picked_up(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as files, with entries in BENCHMARK.json: no file of the harness is
    edited."""
    root = make_root(tmp_path)
    b = root / "shark_bench"
    before = {p: p.read_bytes() for p in b.rglob("*.py")}
    cfg = json.loads((b / "configs/qwen-smoke.json").read_text())
    cfg.update(name="qwen-wide-smoke", intermediate_size=192)
    (b / "configs/qwen-wide-smoke.json").write_text(json.dumps(cfg))
    t = json.loads((b / "traffic/prefill-smoke.json").read_text())
    t["classes"] = [[3, 48]]
    (b / "traffic/prefill-one-smoke.json").write_text(json.dumps(t))
    (b / "workloads/qwen-wide.one-smoke.json").write_text(
        json.dumps({"limits": {"logit_gap": 0.25, "logit_rms": 0.1}}))
    (b / "metrics/batches.prefill.py").write_text(
        "def read(rec):\n    return float(len(rec.work))\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "qwen-wide-smoke", "source": "test",
                           "file": "shark_bench/configs/qwen-wide-smoke.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "qwen-wide.one-smoke",
                             "config": "qwen-wide-smoke",
                             "traffic": "prefill-one-smoke", "chips": 1,
                             "why": "test"})
    for e in man["end_to_end"]:
        if "prefill_tokens_per_s" == e["name"]:
            e["workloads"].append("qwen-wide.one-smoke")
    man["per_layer"].append({"name": "batches.prefill", "unit": "batches",
                             "better": "higher", "source": "host_clock",
                             "layer": "serving engine",
                             "moves": "prefill_tokens_per_s",
                             "workloads": ["qwen-wide.one-smoke"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = smoke_run(root, "qwen-wide.one-smoke", seconds=0.5)
    assert out["correct"] and set(out["metrics"]) == {
        "setup_s", "prefill_tokens_per_s"}
    traced = smoke_run(root, "qwen-wide.one-smoke", seconds=0.5, traced=True)
    assert traced["metrics"]["batches.prefill"]["value"] >= 1
    assert {p: p.read_bytes() for p in before} == before


KIND = '''"""A kind for the test: each step sums a vector of `n` ones."""
import torch
from shark_bench import bench


def run(cell, seed, seconds, traced, device, t_start):
    clock = bench.Clock(False, t_start)
    n = cell.traffic["n"]
    t0 = clock.now()
    sums = []
    while clock.now() - t0 < seconds:
        sums.append(float(torch.ones(n, device=device).sum()))
    window_s = clock.now() - t0
    rec = bench.Record(cell.spec, "ones", window_s, [(1, n)] * len(sums),
                       extra={"sums": len(sums)})
    return {"record": rec, "attempted": len(sums), "failed": 0, "peak": 0,
            "values": {"sum_gap": max(abs(x - n) for x in sums)},
            "e2e": {"setup_s": t0 - t_start,
                    "ones_per_s": n * len(sums) / window_s}}
'''


def test_new_kind_is_picked_up(tmp_path):
    """A traffic kind added as files (`kinds/<kind>.py`, a traffic mix of
    that kind, a cell, an end-to-end metric and a reader that reads the
    kind's own record): no file of the harness is edited."""
    root = make_root(tmp_path)
    b = root / "shark_bench"
    before = {p: p.read_bytes() for p in b.rglob("*.py")}
    (b / "kinds/ones.py").write_text(KIND)
    (b / "traffic/ones-64.json").write_text(json.dumps({"kind": "ones",
                                                        "n": 64}))
    (b / "workloads/qwen-smoke.ones-64.json").write_text(
        json.dumps({"limits": {"sum_gap": 0.0}}))
    (b / "metrics/sums.ones.py").write_text(
        "def read(rec):\n    return float(rec.extra['sums'])\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "qwen-smoke.ones-64",
                             "config": "qwen-smoke", "traffic": "ones-64",
                             "chips": 1, "why": "test"})
    for e in man["end_to_end"]:
        if e["name"] == "setup_s" and "workloads" in e:
            e["workloads"].append("qwen-smoke.ones-64")
    man["end_to_end"].append({"name": "ones_per_s", "unit": "ones/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["qwen-smoke.ones-64"]})
    man["per_layer"].append({"name": "sums.ones", "unit": "sums",
                             "better": "higher", "source": "host_clock",
                             "layer": "test", "moves": "ones_per_s",
                             "workloads": ["qwen-smoke.ones-64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out = smoke_run(root, "qwen-smoke.ones-64", seconds=0.2)
    assert out["correct"] and set(out["metrics"]) == {"setup_s",
                                                      "ones_per_s"}
    assert out["checks"] == {"sum_gap": {"value": 0.0, "limit": 0.0}}
    traced = smoke_run(root, "qwen-smoke.ones-64", seconds=0.2, traced=True)
    assert traced["metrics"]["sums.ones"]["value"] >= 1
    assert {p: p.read_bytes() for p in before} == before


FAMILY = '''"""A family for the test: the dense decoder, its configuration's
keys named as GPT-2's config.json names them, with full multi-head
attention."""
from shark_bench.families import dense

Sizes = dense.Sizes
leaves, mixer_cost, flops_per_token, kernels, program = (
    dense.leaves, dense.mixer_cost, dense.flops_per_token, dense.kernels,
    dense.program)


def fields(c):
    return dict(n_layers=c["n_layer"], d_model=c["n_embd"],
                vocab=c["vocab_size"], tied=c["tie_word_embeddings"],
                eps=c["layer_norm_epsilon"],
                sizes=Sizes(n_heads=c["n_head"], n_kv_heads=c["n_head"],
                            head_dim=c["n_embd"] // c["n_head"],
                            d_ff=c["n_inner"], qkv_bias=False,
                            rope_theta=c["rope_theta"]))
'''


def test_new_family_is_picked_up(tmp_path):
    """A model family added as files (`families/<family>.py` and
    `reference/<family>.py`), a configuration of it whose keys the harness
    has never read, a cell and its entries: a training run is correct, and
    no file of the harness is edited."""
    root = make_root(tmp_path)
    b = root / "shark_bench"
    before = {p: p.read_bytes() for p in b.rglob("*.py")}
    (b / "families/gpt.py").write_text(FAMILY)
    (b / "reference/gpt.py").write_text(
        "from shark_bench.reference.dense import block  # noqa: F401\n")
    (b / "configs/gpt-smoke.json").write_text(json.dumps({
        "name": "gpt-smoke", "family": "gpt", "n_layer": 2, "n_embd": 64,
        "n_head": 4, "n_inner": 128, "vocab_size": 256,
        "tie_word_embeddings": True, "layer_norm_epsilon": 1e-5,
        "rope_theta": 10000.0, "reduced": []}))
    (b / "workloads/gpt-smoke.train-smoke.json").write_text(json.dumps(
        {"limits": json.loads((b / "workloads/qwen2.5-3b.train-4x2k-smoke"
                                    ".json").read_text())["limits"]}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "gpt-smoke", "source": "test",
                           "file": "shark_bench/configs/gpt-smoke.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "gpt-smoke.train-smoke",
                             "config": "gpt-smoke", "traffic": "train-smoke",
                             "chips": 1, "why": "test"})
    for e in man["end_to_end"]:
        if e["name"] == "train_tokens_per_s":
            e["workloads"].append("gpt-smoke.train-smoke")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = smoke_cell(root, "gpt-smoke.train-smoke")
    assert (cell.spec.family, cell.spec.n_layers, cell.spec.sizes.n_kv_heads,
            cell.spec.tied) == ("gpt", 2, 4, True)
    out = smoke_run(root, "gpt-smoke.train-smoke")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert {p: p.read_bytes() for p in before} == before


@pytest.mark.parametrize("cell", ["qwen2.5-3b.train-4x2k-smoke",
                                  "mamba2-370m.prefill-mix-smoke"])
def test_control_fails_the_limits(smoke_root, cell):
    """The reference in float8 in the program's place reads above the
    limits (the training control on the loss, the prefill on the gap)."""
    import torch
    from conftest import smoke_cell
    from shark_bench import bench
    c = smoke_cell(smoke_root, cell)
    out = bench.kind_of(c).controls(c, 5, torch.device("cpu"), batches=12)
    fp8 = out["fp8"]
    assert any(fp8[k] > lim for k, lim in c.limits.items()), (fp8, c.limits)


def test_run_refuses_without_a_card(tmp_path):
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mamba2-370m.train-16x2k", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "needs 1 CUDA device" in res.stderr
