"""Fixtures of the benchmark's CPU tests: a checkout-like root whose
`BENCHMARK.json` holds the four cells at smoke sizes (two layers, width 64,
vocabulary 256, short sequences), with the benchmark's own files beside
them and limits sized for those widths."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# limits for the smoke widths, set as the cells' are, from readings on the
# CPU: sound runs over 12 seeds at most (loss 6.1e-5, grad_norm 2.2e-3,
# grad 3.9e-3, change 1.7e-2, logit_gap 1.8e-3, logit_rms 1.8e-2); the
# float8 control over 3 at least (loss 1.7e-4, grad_norm 2.7e-3 in Mamba2
# and 1.2e-2 in Qwen, grad 1.9e-2, change 1.1e-2, logit_gap 4.5e-3,
# logit_rms 0.14).  The change reads up to 1.7e-2 at width 64 (the k
# biases, which the rotary embedding after the bias gives a gradient of
# their own); half a batch reads 0.04 to 0.06 there, its loss 1.5e-3 and
# more; a state left unchanged reads 1
SMOKE_LIMITS = {"train": {"loss": 1.4e-4, "grad_norm": 6e-3, "grad": 0.012,
                          "change": 0.05},
                "prefill": {"logit_gap": 0.015, "logit_rms": 0.05}}


def smoke_config(name: str) -> dict:
    if name.startswith("qwen"):
        c = json.loads((BENCH / "configs/qwen2.5-3b.json").read_text())
        c.update(name="qwen-smoke", num_hidden_layers=2, hidden_size=64,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                 intermediate_size=128, vocab_size=256,
                 # the program's one epsilon, so that the reference's float32
                 # comparison with the program is exact at this size
                 rms_norm_eps=1e-5)
        return c
    c = json.loads((BENCH / "configs/mamba2-370m.json").read_text())
    c.update(name="mamba-smoke", n_layer=2, d_model=64, vocab_size=250)
    c["ssm_cfg"] = dict(c["ssm_cfg"], d_state=16, headdim=16, chunk_size=16)
    return c


def smoke_traffic(kind: str) -> dict:
    if kind == "train":
        t = json.loads((BENCH / "traffic/train-4x2k.json").read_text())
        t.update(batch=4, seq=64, trace_steps=2,
                 corpus=dict(t["corpus"], n_docs=20, mean_doc_len=256))
        return t
    t = json.loads((BENCH / "traffic/prefill-mix-16k.json").read_text())
    t.update(classes=[[4, 32], [2, 64], [1, 128]], max_seq=129,
             check_tokens=512)
    return t


# the dense cells, which BENCHMARK.json leaves out until the program runs
# Qwen2.5-3B as published (PERF.md, Open questions): rehearsed here all the
# same, since their kinds stay in the benchmark and their files stay in it
LEFT_OUT = [{"name": "qwen2.5-3b.train-4x2k", "config": "qwen2.5-3b",
             "traffic": "train-4x2k", "chips": 1, "why": "left out"},
            {"name": "qwen2.5-3b.prefill-mix", "config": "qwen2.5-3b",
             "traffic": "prefill-mix-16k", "chips": 1, "why": "left out"}]


def _kind(traffic: str) -> str:
    return "train" if "train" in traffic else "prefill"


def make_root(root: Path) -> Path:
    """root/BENCHMARK.json and root/shark_bench: the manifest's cells, and
    LEFT_OUT's, with `-smoke` appended, on smoke configurations and
    traffic; a cell left out joins the metrics of the cells of its kind."""
    b = root / "shark_bench"
    shutil.copytree(BENCH, b, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    rename = {}
    cells = []
    listed = {w["name"] for w in man["workloads"]}
    for w in man["workloads"] + [w for w in LEFT_OUT
                                 if w["name"] not in listed]:
        kind = _kind(w["traffic"])
        cfg = "qwen-smoke" if w["config"].startswith("qwen") else "mamba-smoke"
        name = rename[w["name"]] = w["name"] + "-smoke"
        (b / f"configs/{cfg}.json").write_text(json.dumps(smoke_config(cfg)))
        (b / f"traffic/{kind}-smoke.json").write_text(
            json.dumps(smoke_traffic(kind)))
        (b / f"workloads/{name}.json").write_text(
            json.dumps({"limits": SMOKE_LIMITS[kind]}))
        cells.append(dict(w, name=name, config=cfg, traffic=f"{kind}-smoke"))
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            kinds = {_kind(w) for w in m["workloads"]}
            m["workloads"] = [rename[x] for x in m["workloads"]] + [
                rename[w["name"]] for w in LEFT_OUT
                if w["name"] not in listed and _kind(w["traffic"]) in kinds]
    man["workloads"] = cells
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("smoke"))


def smoke_cell(root: Path, name: str):
    from shark_bench import bench
    return bench.load_cell(root, name, root / "shark_bench")


def smoke_run(root: Path, name: str, seed: int = 7, seconds: float = 1.0,
              traced: bool = False, device: str = "cpu") -> dict:
    import time
    from shark_bench import bench
    return bench.run(smoke_cell(root, name), seed, seconds, traced, device,
                     time.perf_counter())
