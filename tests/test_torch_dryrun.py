"""The port's dry run (`repro_torch/launch/dryrun.py`, `specs.py`,
`roofline.py`): the twin of tests/test_system.py's
test_dryrun_small_mesh_subprocess, the counts held against the
reference's compiled program on a one-device mesh, the CPU's counts
against the meta device's for every family, and the roofline report."""

import json
import os
import re

import pytest
import torch

import jax
from repro.configs import get_config as ref_config
from repro.launch import hlo_cost
from repro.launch import roofline as ref_roofline
from repro.launch.dryrun import cell_list as ref_cell_list
from repro.launch.hlo_analysis import analyze_compiled
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.launch.specs import build_cell as ref_build_cell
from repro.parallel.compat import set_mesh as ref_set_mesh
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.cost import analyze
from repro_torch.launch.specs import build_cell

TRAIN = ShapeConfig("t", "train", 64, 8)
PREFILL = ShapeConfig("p", "prefill", 64, 8)
DECODE = ShapeConfig("d", "decode", 128, 8)
# the reference's record (`analyze_compiled`) and its keys
REF_TOP = {"arch", "shape", "mesh", "variant", "chips", "microbatches",
           "lower_s", "compile_s", "roofline", "memory", "program",
           "cost_analysis_raw"}
REF_ROOFLINE = {"flops", "hbm_bytes", "wire_bytes", "compute_s", "memory_s",
                "collective_s", "dominant", "by_op", "counts"}
REF_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes"}
REF_PROGRAM = {"dot_flops", "elementwise_flops", "traffic_bytes",
               "traffic_by_scope", "wire_by_scope"}


@pytest.mark.parametrize("variant", ["one_card", "moe_ep"])
def test_dryrun_small_cells(variant):
    """Twin of test_dryrun_small_mesh_subprocess: specs + count +
    analysis of a smoke train and decode cell on the meta device.  The
    reference's mesh cases expect collectives; the port's cell is one
    card's program, so its collective bytes are expert parallelism's
    exchange alone: none for the dense model, some for the MoE model over
    `dryrun.EP_MESH`'s four meta slots."""
    if variant == "one_card":
        cfg = get_config("qwen2.5-3b-smoke")
    else:
        cfg = dryrun.perf_config(get_config("phi3.5-moe-42b-a6.6b-smoke"),
                                 "moe_ep")
    a = dryrun.dry_run(cfg, TRAIN)
    assert a["roofline"]["flops"] > 0
    if variant == "one_card":
        assert a["roofline"]["wire_bytes"] == 0
    else:
        assert a["roofline"]["wire_bytes"] > 0
        assert a["roofline"]["counts"]["all-to-all"] > 0
    d = dryrun.dry_run(cfg, DECODE)
    assert d["roofline"]["flops"] > 0 and d["roofline"]["wire_bytes"] == 0


# ----------------------------------------------------- against the reference

_REF = {}


def _reference(kind: str):
    """The reference's compiled smoke cell on a one-device mesh: its
    `analyze_compiled` record and its HLO text (cached per kind)."""
    if kind not in _REF:
        shape = {"train": TRAIN, "prefill": PREFILL}[kind]
        mesh = ref_debug_mesh(1, 1)
        fn, arg_shapes, in_sh, out_sh = ref_build_cell(
            ref_config("qwen2.5-3b-smoke"), shape, mesh)
        with ref_set_mesh(mesh):
            compiled = jax.jit(fn, in_shardings=in_sh,
                               out_shardings=out_sh).lower(
                *arg_shapes).compile()
        _REF[kind] = (analyze_compiled(compiled), compiled.as_text())
    return _REF[kind]


def _ref_dots_outside_attention(hlo: str) -> float:
    """The reference's dot FLOPs in no `attention` scope, from its own
    HLO walk with the attention scopes' lines left out, and the dots
    whose metadata XLA dropped: those are the blockwise attention's
    batched products (batch dims only, S x T outputs), which the CPU
    pipeline rewrites without an op_name."""
    def keep(line, *args):
        if hlo_cost._scope_of(line).startswith("attention"):
            return
        if " dot(" in line and "op_name" not in line:
            return
        return real(line, *args)
    real = hlo_cost._line_costs
    hlo_cost._line_costs = keep
    try:
        return hlo_cost.analyze_hlo_program(hlo).dot_flops
    finally:
        hlo_cost._line_costs = real


def _port(kind: str) -> dict:
    shape = {"train": TRAIN, "prefill": PREFILL}[kind]
    return dryrun.dry_run(get_config("qwen2.5-3b-smoke"), shape)


def _outside(rec) -> float:
    return sum(v for k, v in rec["program"]["dot_flops_by_scope"].items()
               if not k.startswith("attention"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_equal_reference(kind):
    """The cell's arguments (parameters, AdamW state, the int32 batch)
    take exactly the bytes of the reference's `memory_analysis()`."""
    ref, _ = _reference(kind)
    got = _port(kind)["memory"]
    assert got["argument_size_in_bytes"] \
        == ref["memory"]["argument_size_in_bytes"]
    assert set(got) >= REF_MEMORY


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dot_flops_outside_attention_match_reference(kind):
    """Dot FLOPs outside the attention scopes agree within 2%.  In the
    train step the port does one product more by design: each loss
    chunk runs under `torch.utils.checkpoint` (`chunked_softmax_xent`),
    so the backward recomputes the chunk's logits, 2 B S D V FLOPs that
    the reference keeps as the scan's residuals; it is taken off before
    the comparison."""
    ref, hlo = _reference(kind)
    want = _ref_dots_outside_attention(hlo)
    got = _outside(_port(kind))
    if kind == "train":
        cfg = get_config("qwen2.5-3b-smoke")
        got -= 2.0 * TRAIN.global_batch * TRAIN.seq_len * cfg.d_model \
            * cfg.vocab
    assert want > 0
    assert got == pytest.approx(want, rel=0.02)


def test_attention_scope_ratio_is_the_causal_half():
    """In the prefill the attention scopes' dot FLOPs differ from the
    reference's by the masked half alone: its blockwise attention
    computes every (row, col) pair of the S x S scores and of P V, while
    kernel 11 counts the causal pairs, S (S + 1) / 2 (`flash_cost`);
    the projections are the same products.  At S = 64 the kernel counts
    65 / 128 of the reference's score and P V products."""
    ref, hlo = _reference("prefill")
    ref_attn = ref["program"]["dot_flops"] - _ref_dots_outside_attention(hlo)
    got = _port("prefill")
    port_attn = got["program"]["dot_flops"] - _outside(got)
    cfg = get_config("qwen2.5-3b-smoke")
    b, s = PREFILL.global_batch, PREFILL.seq_len
    masked = 4.0 * b * cfg.n_heads * cfg.hd * cfg.n_layers \
        * (s * s - s * (s + 1) / 2)
    assert port_attn == ref_attn - masked
    assert 0.7 < port_attn / ref_attn < 0.8


# ---------------------------------------------------------- CPU against meta

FAMILIES = {"dense": "qwen2.5-3b-smoke", "ssm": "mamba2-370m-smoke",
            "hybrid": "zamba2-7b-smoke",
            "moe": "phi3.5-moe-42b-a6.6b-smoke",
            "moe_mla": "deepseek-v2-lite-16b-smoke",
            "vlm": "llama-3.2-vision-11b-smoke",
            "encdec": "whisper-base-smoke"}


@pytest.mark.parametrize("shape", [ShapeConfig("t", "train", 32, 2),
                                   ShapeConfig("p", "prefill", 32, 2),
                                   ShapeConfig("d", "decode", 48, 2)],
                         ids=["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cpu_counts_equal_meta_counts(family, shape):
    """The same cell counted on the CPU (the kernels' plain versions, real
    data) and on the meta device (the kernels' meta route, no data)
    dispatches the same program: equal counts, bytes, memory and kernel
    calls; and the scopes are the reference's."""
    cfg = get_config(FAMILIES[family])
    recs = {}
    for device in ("cpu", "meta"):
        torch.manual_seed(0)
        fn, args = build_cell(cfg, shape, device=device)
        _, recs[device] = analyze(fn, *args)
    for key in ("roofline", "program", "memory", "cost_analysis_raw"):
        assert recs["cpu"][key] == recs["meta"][key], key
    scopes = set(recs["meta"]["program"]["dot_flops_by_scope"])
    assert scopes <= {"attention", "moe", "mamba", "other", "attention_bwd",
                      "moe_bwd", "mamba_bwd", "backward_other"}
    if shape.kind == "train":
        assert "backward_other" in scopes


# --------------------------------------------------------------- the report

@pytest.mark.parametrize("arch,shape", ref_cell_list())
def test_model_flops_equal_reference(arch, shape):
    assert roofline.model_flops(arch, shape) \
        == ref_roofline.model_flops(arch, shape)


def test_cell_list_is_the_references():
    assert dryrun.cell_list() == ref_cell_list()
    assert len(dryrun.cell_list()) == 32


def test_cli_writes_a_record_and_the_table(tmp_path, capsys):
    """`python -m repro_torch.launch.dryrun --arch A --shape S` writes a
    record with the reference's top-level keys plus `fits`; the roofline
    report prints the h100 table from the records."""
    out = str(tmp_path / "records")
    for arch, shape in (("whisper-base", "decode_32k"),
                        ("mamba2-370m", "long_500k")):
        dryrun.main(["--arch", arch, "--shape", shape, "--out", out])
    files = sorted(os.listdir(out))
    assert files == ["mamba2-370m__long_500k__h100__baseline.json",
                     "whisper-base__decode_32k__h100__baseline.json"]
    with open(os.path.join(out, files[1])) as f:
        rec = json.load(f)
    assert set(rec) == REF_TOP | {"fits", "device"}
    assert set(rec["roofline"]) == REF_ROOFLINE
    assert set(rec["program"]) >= REF_PROGRAM | {"kernel_calls"}
    assert rec["mesh"] == "h100" and rec["chips"] == 1
    assert rec["fits"] is True and rec["device"] == "meta"
    recs = roofline.load_records(out)
    table = roofline.make_table(recs)
    lines = table.splitlines()
    assert len(lines) == 4 and lines[2].startswith("| mamba2-370m | "
                                                   "long_500k |")
    capsys.readouterr()
    roofline.main(["--dir", out])
    text = capsys.readouterr().out
    assert "### Mesh h100 (2 cells" in text
    assert "worst roofline fraction" in text
    row = roofline.enrich(rec)
    assert row["useful_ratio"] == pytest.approx(
        ref_roofline.model_flops("whisper-base", "decode_32k")
        / rec["roofline"]["flops"])
    assert row["bound_s"] == max(rec["roofline"]["compute_s"],
                                 rec["roofline"]["memory_s"])


def test_all_runs_every_listed_cell(tmp_path, monkeypatch, capsys):
    """`--all` dry-runs each cell of `cell_list()` in worker processes
    (two cheap cells here; the full list is the chip script's 14a), and
    counts a cell again where out_dir already holds its record."""
    monkeypatch.setattr(dryrun, "cell_list", lambda: [
        ("whisper-base", "decode_32k"), ("mamba2-370m", "decode_32k")])
    out = tmp_path / "records"
    out.mkdir()
    stale = out / "whisper-base__decode_32k__h100__baseline.json"
    stale.write_text(json.dumps({"stale": True}))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--jobs", "2", "--out", str(out)])
    assert e.value.code == 0
    assert len(os.listdir(out)) == 2
    assert "ALL CELLS PASSED" in capsys.readouterr().out
    rec = json.loads(stale.read_text())
    assert "stale" not in rec and rec["roofline"]["flops"] > 0


def test_pod_meshes_are_refused(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k",
                     "--multi-pod"])
    assert e.value.code == 2
    assert "no pod mesh" in capsys.readouterr().err
    for knob in ("seq_shard", "seq_res"):
        with pytest.raises(ValueError, match="no pod mesh"):
            dryrun.perf_config(get_config("qwen2.5-3b"), knob)
    with pytest.raises(ValueError, match="unknown perf knob"):
        dryrun.perf_config(get_config("qwen2.5-3b"), "nope")


def test_full_size_cell_counts_without_allocating():
    """A full-size cell is counted on meta: Qwen2.5-3B's prefill_32k
    needs about 200 GB and does not fit the card, and nothing was
    allocated on the host to find that out."""
    import resource
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.cell_record("qwen2.5-3b", "prefill_32k")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert rec["fits"] is False
    assert rec["memory"]["peak_bytes"] > 80e9
    assert rec["program"]["kernel_calls"] == {
        "flash_attention_fwd": {"tensor_core": get_config(
            "qwen2.5-3b").n_layers}}
    assert grown * 1024 < 1e9          # ru_maxrss is in KiB
    assert re.fullmatch(r"[a-z]+", rec["roofline"]["dominant"])
