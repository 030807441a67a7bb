"""PDE applied to MoE training on the PyTorch port: the paper's
statistics-driven replanning (§3.1) closing the loop on expert routing.
The reference's `examples/pde_moe_training.py` on `repro_torch`, with its
seeds, sizes, steps and printed lines.

Trains a reduced phi3.5-MoE on a SQL-selected corpus; every step the router
emits per-expert load (the paper's "heavy hitters" accumulator), the
replanner keeps a lossy 1-byte-encoded history, and at stage boundaries it
re-selects the capacity factor from observed p99 load — snapping to buckets
so the set of step variants stays small.  The reference keeps one jitted
step a capacity bucket; the port keeps one train-step function a bucket.

    PYTHONPATH=src python examples_torch/pde_moe_training.py [--device cpu]

It trains on the card unless `--device cpu` is given, and raises without
one.  Weights are random, drawn from seed 0 on the device.
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core import SharkSession
from repro_torch.data import TokenPipeline, synthetic_corpus
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import embed_lookup
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.pde_moe import MoEReplanner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config("phi3.5-moe-42b-a6.6b-smoke")
    sess = SharkSession(num_workers=2, max_threads=2, device=args.device)
    device = sess.ctx.device
    synthetic_corpus(sess, "corpus", cfg.vocab, n_docs=60, mean_doc_len=256)
    pipe = TokenPipeline(sess, "corpus", seq_len=32, global_batch=8,
                         sql_filter="quality > 0.25")
    print(f"SQL-selected corpus: {len(pipe.stream)} tokens")

    model = lm.build_model(cfg, device,
                           torch.Generator(device=device).manual_seed(0))
    opt_state = init_opt_state(dict(model.named_parameters()))
    replanner = MoEReplanner(cfg.moe.num_experts, cfg.moe.top_k)
    tokens_per_step = 8 * 32

    step_fns = {}  # capacity bucket -> train step (the step variants)
    current_cf = cfg.moe.capacity_factor

    for step in range(30):
        if step % 10 == 0 and step > 0:
            plan = replanner.plan(tokens_per_step)
            if plan.capacity_factor != current_cf:
                print(f"  [PDE] step {step}: re-planning — {plan.reason}")
                current_cf = plan.capacity_factor
            else:
                print(f"  [PDE] step {step}: plan unchanged ({plan.reason})")
        if current_cf not in step_fns:
            c = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe,
                                             capacity_factor=current_cf))
            step_fns[current_cf] = make_train_step(c, AdamWConfig(lr=3e-3))
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(step).items()}
        model, opt_state, metrics = step_fns[current_cf](model, opt_state,
                                                         batch)
        # observe expert load: layer 0's router over the embedded tokens
        with torch.no_grad():
            x = embed_lookup(model.embed, batch["tokens"])
            _, stats = moe_mod.moe_apply(model.layers[0].moe, x, cfg.moe,
                                         return_stats=True)
        replanner.observe(stats["expert_load"])
        if step % 5 == 0:
            print(f"step {step:3d} loss {float(metrics['loss']):.4f} "
                  f"cf={current_cf} step_variants={len(step_fns)}")

    print(f"done; the step cache held {len(step_fns)} capacity variants")
    sess.shutdown()


if __name__ == "__main__":
    main()
