"""Kind "prefill": one closed-loop client sending batches of prompts, each
for `max_new_tokens` new tokens (greedy), to the program's serving engine.

The batch shapes cycle through the traffic file's `classes` ([batch, prompt
length] pairs); the seed draws the order within each cycle and the prompts'
token ids (uniform over the vocabulary), so every seed sends the same sizes
in another order; a window ends on a whole cycle.

The check: the engine's prefill is watched (`port.first_logits`) so that
the logits from which the timed path chose each batch's first tokens are
kept.  After the window a sample of the served requests, drawn from the
seed with one of the longest in it, up to `check_tokens` prompt tokens, is
run through the plain reference; the numbers compared are `compare`'s.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from shark_bench import bench, trace, weights
from shark_bench.reference import lm as ref_lm


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------

def shape(traffic: dict, seed: int, j: int) -> Tuple[int, int]:
    """(batch, prompt length) of the client's batch j."""
    classes = traffic["classes"]
    cycle, k = divmod(j, len(classes))
    order = np.random.default_rng([seed, cycle, 1]).permutation(len(classes))
    b, s = classes[order[k]]
    return int(b), int(s)


def prompts(traffic: dict, seed: int, j: int, vocab: int) -> np.ndarray:
    """Batch j's prompts, (batch, prompt length) int32."""
    b, s = shape(traffic, seed, j)
    rng = np.random.default_rng([seed, j, 2])
    return rng.integers(0, vocab, (b, s), dtype=np.int32)


def warm_shapes(traffic: dict) -> List[Tuple[int, int]]:
    """Each class's shape, `warm_batches` times."""
    return [tuple(c) for c in traffic["classes"]
            for _ in range(traffic["warm_batches"])]


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def run(cell, seed, seconds, traced, device, t_start) -> dict:
    from shark_bench import port
    spec, tr = cell.spec, cell.traffic
    cuda = device.type == "cuda"
    clock = bench.Clock(cuda, t_start)
    cfg = port.model_config(spec)
    model = port.model(spec, seed, device, cfg)
    eng = port.engine(cfg, model, tr["max_seq"])
    clock.log("model built")
    n_new = tr["max_new_tokens"]
    for i, (b, s) in enumerate(warm_shapes(tr)):
        rng = np.random.default_rng([seed, i, 3])
        eng.generate(rng.integers(0, spec.vocab, (b, s), dtype=np.int32),
                     n_new)
    clock.sync()
    clock.log(f"warmed {len(warm_shapes(tr))} batches")

    def send(j: int):
        """(seconds to the first token, served tokens) of batch j."""
        batch = prompts(tr, seed, j, spec.vocab)
        t = clock.now()
        with torch.profiler.record_function("shark_bench.generate"):
            out = eng.generate(batch, n_new)
        return clock.now() - t, out

    logits: List[torch.Tensor] = []   # batch j's first-token logits
    served = []                       # (j, ttft seconds, served tokens)
    j = 0
    cycle = len(tr["classes"])
    t0 = clock.now()
    setup_s = t0 - t_start
    with port.first_logits(logits):
        # whole cycles, so that every window serves each class alike
        while clock.now() - t0 < seconds or j % cycle:
            served.append((j, *send(j)))
            j += 1
    window_s = clock.now() - t0
    peak = bench.peak(cuda)
    work = [shape(tr, seed, i) for i, _, _ in served]
    rec = bench.Record(spec, "prefill", window_s, work)
    clock.log(f"window: {len(served)} batches in {window_s:.3f} s, "
              f"peak {peak}")
    if traced:
        n = tr["trace_cycles"] * cycle

        def batches():
            t = clock.now()
            for k in range(n):
                send(j + k)
            rec.traced_step_s = (clock.now() - t) / n
        rec.trace = trace.capture(batches, cuda)
        rec.traced_work = [shape(tr, seed, j + k) for k in range(n)]
        clock.log(f"traced {n} batches, {rec.traced_step_s:.3f} s a batch")
    if len(logits) != len(served):
        raise RuntimeError(f"{len(logits)} prefills watched for "
                           f"{len(served)} batches")
    kept = sample_requests(tr, seed, served)
    prog = torch.stack([logits[j][r] for j, r in kept]).float()
    tokens_out = torch.tensor([int(served[j][2][r, 0]) for j, r in kept])
    del logits, eng, model
    bench.free(cuda)

    ttfts = [t * 1e3 for _, t, out in served for _ in range(out.shape[0])]
    ref = reference(spec, tr, seed, device, kept)
    values = compare(prog, tokens_out, ref)
    clock.log(f"reference done: {len(kept)} requests, {values}")
    total = sum(b * s for b, s in work)
    return {"record": rec, "attempted": len(ttfts), "failed": 0,
            "peak": peak, "values": values,
            "e2e": {"setup_s": setup_s,
                    "prefill_tokens_per_s": total / window_s,
                    "ttft_p95_ms": p95(ttfts)}}


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values), 95))


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def sample_requests(tr: dict, seed: int, served) -> List[Tuple[int, int]]:
    """(batch j, row) of the requests the reference checks: one of the
    longest, then others drawn from the seed, up to `check_tokens` prompt
    tokens."""
    reqs = [(j, r, shape(tr, seed, j)[1])
            for j, _, out in served for r in range(out.shape[0])]
    rng = np.random.default_rng([seed, 4])
    order = list(rng.permutation(len(reqs)))
    longest = max(s for _, _, s in reqs)
    first = next(i for i in order if reqs[i][2] == longest)
    picked, total = [], 0
    for i in [first] + [i for i in order if i != first]:
        s = reqs[i][2]
        if picked and total + s > tr["check_tokens"]:
            continue
        picked.append(reqs[i][:2])
        total += s
    return picked


def reference(spec, tr: dict, seed: int, device, kept, prec=ref_lm.FP32
              ) -> torch.Tensor:
    """(len(kept), V) float32: the reference's logits at the last position
    of each kept request's prompt, a request at a time, from the weights
    drawn again from the seed; with `prec` the control's arithmetic."""
    P = weights.draw_all(spec, seed, device, torch.float32)
    rows = []
    with ref_lm.no_tf32():
        for j, r in kept:
            p = prompts(tr, seed, j, spec.vocab)[r:r + 1]
            rows.append(ref_lm.last_logits(
                spec, P, torch.from_numpy(p).to(device), prec)[0])
    del P
    bench.free(device.type == "cuda")
    return torch.stack(rows)


def compare(prog: torch.Tensor, served: torch.Tensor, ref: torch.Tensor
            ) -> Dict[str, float]:
    """The numbers that decide a prefill cell's `correct`, over the kept
    requests, given the program's first-token logits `prog` (n, V), the
    tokens it served `served` (n,) and the reference's logits `ref` (n, V):
    - logit_gap: the widest gap by which a served token's logit, under the
      reference, lies below the reference's best;
    - logit_rms: the worst request's root mean square of the program's
      logits' error over the vocabulary, over the root mean square of the
      reference's logits."""
    ref = ref.float().to(prog.device)
    served = served.to(prog.device).long()
    gap = ref.max(dim=-1).values - ref.gather(-1, served[:, None])[:, 0]
    rms = ((prog - ref).square().mean(dim=-1).sqrt()
           / ref.square().mean(dim=-1).sqrt())
    return {"logit_gap": float(gap.max()), "logit_rms": float(rms.max())}


def controls(cell, seed: int, device, batches: int = 30, **_) -> dict:
    """The numbers compared with the reference put in the program's place
    and run in float8 (`fp8`): the requests a run of `batches` batches
    would check, its served tokens the ones float8 puts first, through
    `compare` as a run's are."""
    from shark_bench.reference.fp8 import FP8
    spec, tr = cell.spec, cell.traffic
    served = [(j, 0.0, np.zeros((shape(tr, seed, j)[0], 1)))
              for j in range(batches)]
    kept = sample_requests(tr, seed, served)
    ref = reference(spec, tr, seed, device, kept)
    low = reference(spec, tr, seed, device, kept, FP8)
    return {"fp8": compare(low, low.argmax(dim=-1), ref)}
