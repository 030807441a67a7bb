"""One run of one cell: what every kind of traffic shares.

Everything a cell is comes from files found by name: the cell's entry in
`BENCHMARK.json` (its configuration, traffic and chips), the configuration
(`configs/<config>.json`) and its family (`families/<family>.py`,
`reference/<family>.py`), the traffic mix (`traffic/<traffic>.json`, whose
`kind` names the kind), the kind (`kinds/<kind>.py`: its generator, its run,
its reference check and its controls), the cell's limits
(`workloads/<cell>.json`), and one reader a per-layer metric
(`metrics/<metric>.py`).  The program is reached only through `port.py`.

A kind's `run(cell, seed, seconds, traced, device, t_start)` returns a dict
with `record` (a `Record`), `attempted`, `failed`, `peak` (bytes), `e2e`
({end-to-end metric: value}) and `values` ({number compared: value}); `run`
below turns it into the result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from . import trace
from .spec import Spec, found, load_spec

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    spec: Spec
    traffic: dict
    limits: Dict[str, float]
    entry: dict                       # the cell's BENCHMARK.json entry
    manifest: dict                    # the whole BENCHMARK.json
    bench_dir: Path = HERE


def load_cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files under
    `bench_dir`."""
    manifest = json.loads((Path(root) / "BENCHMARK.json").read_text())
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = load_spec(bench_dir / "configs" / f"{entry['config']}.json",
                     bench_dir)
    traffic = json.loads(
        (bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads(
        (bench_dir / "workloads" / f"{name}.json").read_text())["limits"]
    return Cell(name, spec, traffic, limits, entry, manifest, bench_dir)


@dataclasses.dataclass
class Record:
    """What the per-layer readers read (`metrics/<name>.py`)."""
    spec: Spec
    kind: str                          # the traffic's kind
    window_s: float                    # the measured window
    work: List[Tuple[int, int]]        # (batch, length) of each step or
    #                                    batch completed in it
    trace: Optional[trace.Trace] = None
    traced_work: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    traced_step_s: float = 0.0         # host time a step or batch, traced
    extra: dict = dataclasses.field(default_factory=dict)  # a kind's own
    #                                    readings, such as "batch_ms"


def cell_metrics(cell: Cell, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") this cell
    reports: those that list it, and those that list no cells but move an
    end-to-end metric the cell reports."""
    mine = [m for m in cell.manifest["end_to_end"]
            if cell.name in m.get("workloads", [cell.name])]
    if section == "end_to_end":
        return mine
    moves = {m["name"] for m in mine}
    return [m for m in cell.manifest["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            and ("workloads" in m or m["moves"] in moves)]


def read_metric(name: str, rec: Record, bench_dir: Path = HERE):
    """The reader `metrics/<name>.py`'s value of the record, or None."""
    return found(bench_dir, "metrics", name).read(rec)


def kind_of(cell: Cell):
    """The module `kinds/<kind>.py` of the cell's traffic."""
    return found(cell.bench_dir, "kinds", cell.traffic["kind"])


# ---------------------------------------------------------------------------
# What the kinds share
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self, cuda: bool, t_start: float):
        self.cuda = cuda
        self.t_start = t_start

    def log(self, what: str) -> None:
        """A progress line on standard error: seconds since the start."""
        print(f"shark_bench: {self.now() - self.t_start:.3f} s: {what}",
              file=sys.stderr, flush=True)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def now(self) -> float:
        return time.perf_counter()


def peak(cuda: bool) -> int:
    return int(torch.cuda.max_memory_allocated()) if cuda else 0


def free(cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def checks(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of every number the kind compared.  Each
    needs a limit in the cell's workload file, and a limit needs its
    number: a number left unheld, or a limit that holds nothing, is an
    error, not a pass.  A value that is not a finite number reads as
    1e308, so that it fails."""
    if set(values) != set(limits):
        raise KeyError(f"numbers compared {sorted(values)} and limits "
                       f"{sorted(limits)} differ")
    return {k: {"value": (float(v) if math.isfinite(v) else 1e308),
                "limit": limits[k]} for k, v in values.items()}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """One run.  Returns {"correct", "attempted", "failed", "metrics",
    "peak", "checks"[, "breakdown", "busy_s", "window_s"]}."""
    device = torch.device(device)
    out = kind_of(cell).run(cell, seed, seconds, traced, device, t_start)
    rec = out.pop("record")
    e2e = out.pop("e2e")
    metrics = {}
    for m in cell_metrics(cell, "per_layer" if traced else "end_to_end"):
        v = (read_metric(m["name"], rec, cell.bench_dir) if traced
             else e2e.get(m["name"]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    if traced and rec.trace is not None:
        out["breakdown"] = rec.trace.breakdown()
        out["busy_s"] = rec.trace.busy_us / 1e6
        out["window_s"] = rec.trace.window_us / 1e6
    out["checks"] = checks(out.pop("values"), cell.limits)
    out["correct"] = all(c["value"] <= c["limit"]
                         for c in out["checks"].values())
    return out
