"""End-to-end training from the command line: the reference's
`repro/launch/train.py` on the port.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2.5-3b-smoke --steps 200 --seq-len 64 --batch 16 \
        --sql-filter "quality > 0.2" [--device cpu]

It runs on the card unless `--device cpu` is given, and raises without
one.  It wires the whole stack: the Shark SQL engine selects the corpus
(a session on the same device: map pruning and the columnar store; the
filter runs on the engine's `jit` route and launches none of the
hand-written kernels 1-8, see `data/pipeline.py`), `TokenPipeline`
serves deterministic batches, the train step runs kernels 11 and 12
forward and autograd backward, and `CheckpointManager` saves asynchronously with the
pipeline's manifest (lineage); `--simulate-preemption N` proves the
restart path by restoring the latest checkpoint at step N and replaying
from the manifest's step.  Weights are random, drawn from seed 0 on the
device.

The reference parses a `--mesh` flag and never reads it; the port has
none.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sql-filter", default="quality > 0.1")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-preemption", type=int, default=0,
                    help="restore at this step, then replay from the "
                         "checkpoint")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from ..checkpoint import CheckpointManager
    from ..configs import get_config
    from ..core import SharkSession
    from ..data import TokenPipeline, synthetic_corpus
    from ..models import lm
    from ..training import AdamWConfig, init_opt_state, make_train_step

    cfg = get_config(args.arch)
    device = lm.resolve_device(args.device)
    sess = SharkSession(num_workers=4, max_threads=4, device=device)
    synthetic_corpus(sess, "corpus", cfg.vocab, n_docs=100,
                     mean_doc_len=4 * args.seq_len)
    pipe = TokenPipeline(sess, "corpus", args.seq_len, args.batch,
                         sql_filter=args.sql_filter)
    print(f"corpus: {len(pipe.stream)} tokens selected via SQL "
          f"(pruned {sess.metrics().pruned_partitions} partitions)")

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    model = lm.build_model(cfg, device,
                           torch.Generator(device=device).manual_seed(0))
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params)

    def state():
        return {"params": params, "opt": opt_state}

    def restore():
        nonlocal opt_state
        restored, manifest = mgr.restore_latest(state())
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(restored["params"][n])
        opt_state = restored["opt"]
        return manifest["step"]

    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        start_step = restore()
        print(f"resumed from checkpoint at step {start_step}")

    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr),
                              args.microbatches)
    t0 = time.time()
    step = start_step
    losses = []
    while step < args.steps:
        if args.simulate_preemption and step == args.simulate_preemption:
            print(f"SIMULATED PREEMPTION at step {step} — restarting "
                  f"from checkpoint")
            mgr.wait()
            step = restore()    # replay from the checkpointed step
            args.simulate_preemption = 0
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(step).items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/max(step-start_step+1,1)*1000:.0f} "
                  f"ms/step)")
        if step > 0 and step % args.ckpt_every == 0:
            mgr.save(step, state(), {"pipeline": pipe.manifest(step)})
        step += 1
    mgr.save(args.steps, state(), {"pipeline": pipe.manifest(args.steps)})
    mgr.wait()
    print("done; final checkpoint at", mgr.latest_step())
    sess.shutdown()
    return losses


if __name__ == "__main__":
    main()
