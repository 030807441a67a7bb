"""Kind "train": a training job, closed loop.

Its batches are the program's own (`TokenPipeline.batch_at(step)` over the
corpus `corpus.draw` makes from the traffic file's `corpus` parameters,
selected by SQL); the file also fixes the batch, the sequence length, the
optimizer, how many first steps are checked and how many are traced.

Set-up builds one training step with its model and optimizer state, runs
the checked steps through the window's own call and feed, and hands the
same objects to the window.  After the window the plain reference follows
the checked steps from the same weights and batches; the numbers compared
are `gaps`.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from shark_bench import bench, corpus, trace, weights
from shark_bench.reference import adamw as ref_adamw
from shark_bench.reference import lm as ref_lm
from shark_bench.spec import leaves


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names])
    return dict(zip(names, norms.tolist()))


def run(cell, seed, seconds, traced, device, t_start) -> dict:
    from shark_bench import port
    spec, tr = cell.spec, cell.traffic
    cuda = device.type == "cuda"
    clock = bench.Clock(cuda, t_start)
    c = tr["corpus"]
    cols = corpus.draw(spec.vocab, c["n_docs"], c["mean_doc_len"], seed)
    clock.log("corpus drawn")
    sess, pipe = port.pipeline(cols, c["partitions"],
                               f"quality > {c['min_quality']}", tr["seq"],
                               tr["batch"], seed, device)
    clock.log(f"corpus of {len(pipe.stream)} tokens selected")
    cfg = port.model_config(spec)
    model = port.model(spec, seed, device, cfg)
    clock.sync()
    clock.log("model built")
    step_fn, opt = port.trainer(cfg, model, tr["optimizer"])
    clock.sync()
    clock.log("optimizer state built")
    batch_ms: List[float] = []

    def feed(step: int) -> dict:
        t = clock.now()
        with torch.profiler.record_function("shark_bench.batch"):
            b = pipe.batch_at(step)
            out = {k: torch.from_numpy(v).pin_memory().to(
                device, non_blocking=True) if cuda
                else torch.from_numpy(v) for k, v in b.items()}
        batch_ms.append((clock.now() - t) * 1e3)
        return out

    def one(step: int):
        nonlocal model, opt
        b = feed(step)
        with torch.profiler.record_function("shark_bench.step"):
            model, opt, m = step_fn(model, opt, b)
        return m

    # the first steps: warm-up, and what the reference checks
    b1 = tr["optimizer"]["b1"]
    losses, grad1, gnorm1 = [], {}, 0.0
    for k in range(tr["checked_steps"]):
        m = one(k)
        losses.append(float(m["loss"]))
        if k == 0:
            gnorm1 = float(m["grad_norm"])
            grad1 = {n: v / (1.0 - b1)
                     for n, v in _leaf_norms(opt["mu"]).items()}
    change = weights.per_leaf(
        spec, seed, device,
        lambda leaf, v: float((opt["master"][leaf.name] - v.float()).norm()))
    step = tr["checked_steps"]
    batch_ms.clear()
    clock.sync()
    clock.log(f"{step} checked steps, losses {losses}")

    # the measured window
    t0 = clock.now()
    setup_s = t0 - t_start
    window_losses, work = [], []
    while clock.now() - t0 < seconds:
        window_losses.append(one(step)["loss"])
        work.append((tr["batch"], tr["seq"]))
        step += 1
    clock.sync()
    window_s = clock.now() - t0
    peak = bench.peak(cuda)
    failed = int(sum(not math.isfinite(float(x)) for x in window_losses))
    rec = bench.Record(spec, "train", window_s, work,
                       extra={"batch_ms": list(batch_ms)})
    clock.log(f"window: {len(work)} steps in {window_s:.3f} s, peak {peak}")

    if traced:
        n = tr["trace_steps"]

        def steps():
            t = clock.now()
            for k in range(n):
                one(step + k)
            clock.sync()
            rec.traced_step_s = (clock.now() - t) / n
        rec.trace = trace.capture(steps, cuda)
        rec.traced_work = [(tr["batch"], tr["seq"])] * n
        clock.log(f"traced {n} steps, {rec.traced_step_s:.3f} s a step")

    del model, opt, step_fn, m
    sess.shutdown()
    del sess, pipe
    bench.free(cuda)

    ref = reference(spec, tr, seed, device, cols)
    clock.log(f"reference done, losses {ref['loss']}")
    prog = {"loss": losses, "grad": grad1, "grad_norm": gnorm1,
            "change": change}
    for what in ("grad", "change"):
        med = statistics.median(ref[what].values())
        worst = sorted(ref[what], key=lambda n: -abs(
            prog[what][n] - ref[what][n]) / max(ref[what][n], med))[:3]
        clock.log(f"{what}: largest gaps " + ", ".join(
            f"{n} {prog[what][n]:.6g} vs {ref[what][n]:.6g}" for n in worst))
    tokens = tr["batch"] * tr["seq"]
    return {"record": rec, "attempted": len(work), "failed": failed,
            "peak": peak, "values": gaps(prog, ref),
            "e2e": {"setup_s": setup_s,
                    "train_tokens_per_s": len(work) * tokens / window_s}}


def reference(spec, tr: dict, seed: int, device, cols, prec=ref_lm.FP32,
              rows: Optional[int] = None) -> dict:
    """The reference's first `checked_steps` steps from the same weights
    and batches: each step's loss, the first gradient's norm by leaf after
    clipping and its global norm before, and each leaf's change.  Mixed
    precision as the configuration states it: float32 master weights, the
    forward and backward computed from them rounded to each leaf's stored
    dtype (bfloat16 matrices and biases), their gradients applied to the
    masters; the arithmetic in float32.  With `prec` the control's
    arithmetic; with `rows`, only the first rows of each batch (a planted
    fault)."""
    c = tr["corpus"]
    stream = corpus.plain_stream(cols, c["min_quality"])
    P = weights.draw_all(spec, seed, device, torch.float32)
    stored = {leaf.name: weights.DTYPES[leaf.dtype]
              for leaf in leaves(spec)}
    opt = ref_adamw.AdamW(P, tr["optimizer"])
    out = {"loss": [], "grad": {}, "grad_norm": 0.0}
    with ref_lm.no_tf32():
        for k in range(tr["checked_steps"]):
            b = corpus.plain_batch(stream, tr["seq"], tr["batch"], seed, k)
            tok, lab = (torch.from_numpy(b[x][:rows]).to(device)
                        for x in ("tokens", "labels"))
            W = {n: p.to(stored[n]).float().requires_grad_(True)
                 for n, p in P.items()}
            loss = ref_lm.loss(spec, W, tok, lab, prec)
            grads = dict(zip(W, torch.autograd.grad(loss, list(W.values()))))
            del W
            out["loss"].append(float(loss.detach()))
            st = opt.step(P, grads)
            if k == 0:
                out["grad_norm"] = st["grad_norm"]
                out["grad"] = {n: v * st["clip"]
                               for n, v in _leaf_norms(grads).items()}
            del grads, loss
    with torch.no_grad():
        out["change"] = weights.per_leaf(
            spec, seed, device,
            lambda leaf, v: float((P[leaf.name] - v.float()).norm()))
    del P, opt
    bench.free(device.type == "cuda")
    return out


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers that decide a training cell's `correct`, each a gap
    between the program's reading and the reference's:
    - loss: the largest relative gap of a checked step's loss;
    - grad_norm: the first gradient's global norm before clipping;
    - grad: the worst leaf's gap of the first (clipped) gradient's norm,
      against the larger of the leaf's own norm and the median leaf's;
    - change: the same for each leaf's change over the checked steps,
      leaving out leaves whose reference gradient is under a thousandth of
      the median leaf's (they move by round-off alone)."""
    def worst(p, r, keep):
        med = statistics.median(r.values())
        return max(abs(p[n] - r[n]) / max(r[n], med, 1e-30)
                   for n in r if keep(n))
    g = ref["grad"]
    gmed = statistics.median(g.values())
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                         ref["loss"])),
        "grad_norm": abs(prog["grad_norm"] - ref["grad_norm"])
        / ref["grad_norm"],
        "grad": worst(prog["grad"], g, lambda n: True),
        "change": worst(prog["change"], ref["change"],
                        lambda n: g[n] >= 1e-3 * gmed),
    }


def controls(cell, seed: int, device, **_) -> dict:
    """The numbers compared with the reference put in the program's place
    and run in float8 (`fp8`), and with half of each batch left out, the
    loss the mean over the rest (`half_batch`)."""
    from shark_bench.reference.fp8 import FP8
    tr = cell.traffic
    c = tr["corpus"]
    cols = corpus.draw(cell.spec.vocab, c["n_docs"], c["mean_doc_len"], seed)
    ref = reference(cell.spec, tr, seed, device, cols)
    out = {}
    for name, kw in (("fp8", {"prec": FP8}),
                     ("half_batch", {"rows": tr["batch"] // 2})):
        other = reference(cell.spec, tr, seed, device, cols, **kw)
        out[name] = gaps(other, ref)
    return out
