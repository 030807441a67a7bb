"""The roofline report: reads the dry run's records
(`experiments/dryrun_torch/*.json`), takes each cell's three roofline
terms on one H100, the analytic model FLOPs and the useful share, and
prints the tables.  The counterpart of the reference's
`launch/roofline.py`.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--out table.md]

The terms are counts times the data sheet's peaks (`launch/cost.H100`):
a prediction of the least time, not a timing.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from ..configs import SHAPES, get_config
from .cost import H100
from .dryrun import MESH_NAME, RESULTS_DIR


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs of the whole cell: train 6 N D, prefill
    2 N D, decode 2 N B (one token a sequence); N the active parameters
    for MoE."""
    return cell_model_flops(get_config(arch), SHAPES[shape_name])


def cell_model_flops(cfg, shape) -> float:
    """`model_flops` of a config and a `ShapeConfig`."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def load_records(out_dir: str, variant: str = "baseline") -> List[Dict]:
    recs = []
    for f in sorted(os.listdir(out_dir)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(out_dir, f)) as fh:
            r = json.load(fh)
        if r.get("variant", "baseline") == variant:
            recs.append(r)
    return recs


def enrich(r: Dict) -> Dict:
    """A record's table row: the terms, the useful share of the counted
    FLOPs (`useful_ratio`), the bound (the largest term) and the share of
    it that the model FLOPs would take at the bf16 peak
    (`roofline_fraction`)."""
    rl = r["roofline"]
    mf = model_flops(r["arch"], r["shape"]) / r["chips"]
    bound = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    useful_s = mf / H100.peak("bfloat16")
    mem = r.get("memory", {})
    return {
        **{k: r[k] for k in ("arch", "shape", "mesh", "chips", "variant")},
        "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
        "collective_s": rl["collective_s"], "dominant": rl["dominant"],
        "model_flops_dev": mf, "counted_flops_dev": max(rl["flops"], 1.0),
        "useful_ratio": mf / max(rl["flops"], 1.0),
        "bound_s": bound,
        "roofline_fraction": useful_s / bound if bound > 0 else 0.0,
        "counts": rl["counts"],
        "peak_gb": mem.get("peak_bytes", 0) / 1e9,
        "fits": r.get("fits"),
    }


BOTTLENECK_HINT = {
    "compute": "more useful-FLOP share (less recomputation, bf16 products "
               "in place of float32)",
    "memory": "fuse the elementwise passes (AdamW, norms, the plain "
              "backwards) into fewer kernels",
    "collective": "overlap or shrink expert parallelism's exchange",
}


def make_table(recs: List[Dict], mesh: str = MESH_NAME) -> str:
    rows = [e for e in (enrich(r) for r in recs) if e["mesh"] == mesh]
    rows.sort(key=lambda e: (e["arch"], e["shape"]))
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| MODEL/counted flops | roofline frac | peak GB | fits |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for e in rows:
        out.append(
            f"| {e['arch']} | {e['shape']} | {e['compute_s']:.4g} "
            f"| {e['memory_s']:.4g} | {e['collective_s']:.4g} "
            f"| **{e['dominant']}** | {e['useful_ratio']:.2f} "
            f"| {e['roofline_fraction']:.3f} | {e['peak_gb']:.1f} "
            f"| {'yes' if e['fits'] else 'no'} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.variant) if os.path.isdir(
        args.dir) else []
    if not recs:
        print("no records found in", args.dir)
        return
    n = len([r for r in recs if r["mesh"] == MESH_NAME])
    sections = [f"### Mesh {MESH_NAME} ({n} cells, variant={args.variant}; "
                f"{H100.name} peaks at {H100.power_w:.0f} W, predicted, "
                f"not timed)\n\n" + make_table(recs)]
    enriched = [enrich(r) for r in recs if r["mesh"] == MESH_NAME]
    if enriched:
        worst = min(enriched, key=lambda e: e["roofline_fraction"])
        coll = max(enriched, key=lambda e: e["collective_s"]
                   / max(e["bound_s"], 1e-12))
        sections.append(
            "\n### Hillclimb candidates\n"
            f"- worst roofline fraction: {worst['arch']} x {worst['shape']} "
            f"({worst['roofline_fraction']:.4f}, {worst['dominant']}-bound)\n"
            f"- most collective-bound: {coll['arch']} x {coll['shape']} "
            f"(collective {coll['collective_s']:.4g} s)\n"
            f"- hints: " + json.dumps(BOTTLENECK_HINT))
    text = "\n\n".join(sections) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print("wrote", args.out)
    else:
        print(text)


if __name__ == "__main__":
    main()
