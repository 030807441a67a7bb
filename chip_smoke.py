#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Shark (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                          # the card, full size
    python3 chip_smoke.py --device cpu --rows 300000   # CPU rehearsal

Phase 0 builds the CUDA kernels from `src/repro_torch/kernels/csrc/`.
Phase 1 holds each of the twelve kernels against its plain PyTorch version
on the card, at the main paths' sizes and at ragged sizes (flash on both
of its routes: bf16 on the tensor cores, float32 and odd head dims on the
SIMT kernel; the SSD scan on both of its routes: bf16 on the tensor
cores, float32 on the SIMT kernel; top-k on both of its routes and
through its lanes entry; RLE into strided columns of every dtype), checks
that one `colscan` (over one column and over two), one
`fused_decode_scan`, one `groupby_sum`, one `segmented_merge`, one
`dict_decode`, one `train_grad`, one batched bit-pack decode of a phase-3
partition, one `rle_decode` and one `rle_decode_into` a column of x, one
`topk_similarity` and one `topk_similarity_lanes` call at phase 4's
partition, one bf16 `ssd_scan` call and one `radix_split` of 50 and of
93,750 int64 keys each put exactly one kernel on the device (the nodes
of a CUDA graph captured around the call), holds `radix_split` and
`radix_partition` bit for bit against their plain versions over n = 0 ..
93,750 x B = 1 .. 8,192, and times
each kernel, its plain version and, where one PyTorch call computes the same
function, that call, each with the host's cost (`ms`) and as a CUDA graph
(`device_ms`; flash and the SSD scan at Zamba2-7B's prefill shapes, with
`scaled_dot_product_attention` as flash's yardstick), and, beside the
calls they replaced, the batched bit-pack decode (row 7b), `rle_decode_into`
a column of x (8b) and the lanes entry of top-k (9b), `colscan` over two
distinct columns (1b), both scan kernels over 10,000,000 rows beside
their bounds, and `radix_split` at 50, 93,750 and 10,000,000 keys (rows
4, 4M, 4L), with what a shuffle's map task pays for it from host numpy
to host numpy (`call_ms`) beside the chain it replaced (`chain_ms`).
Phase 2 runs the SQL main path end to end: a `SharkSession` on the card
loads a TPC-H `lineitem` table (6,000,000 rows, scale factor 1, in 64
partitions of 93,750 rows, columns drawn from dbgen's domains with numpy
from `--seed`) and answers four filter / aggregate / group-by queries,
each checked against numpy over the generated arrays (integers exactly,
floats to rtol 1e-9), then query e: `lineitem` joined with TPC-H `orders`
(1,500,000 rows, dbgen's sparse keys, 1 to 7 lines an order, 64
partitions) and grouped by O_ORDERPRIORITY, which PDE must run as a
shuffle join at the default broadcast threshold.  Its launch counts must
show the five SQL kernels, exactly one `colscan` (query a) and one
`fused_decode_scan` (query b) launch per partition of each counted run,
and exactly one `radix_partition` launch, on its one-launch route, per
map task of every shuffle (c and d: 64 a run; e: 64 orders and 64
lineitem tasks, then one a reducer of the join); on the card it ends
with a torch.profiler trace of one warm run of each of queries a, b and
e.
Phase 3 trains in the engine (paper Listing 1, §6.5): a `points` table of
10,000,000 rows in 64 partitions of 156,250 (one node's share of the
paper's billion rows on 100 nodes), 12 feature columns that load as
BITPACK, DICT, RLE and PLAIN blocks and an int64 label; a logistic
regression and a k-means fit, 10 iterations each, checked against a numpy
replay of the same updates.  Its launches must show the three decode
kernels and `train_grad`, one bit-pack launch and one RLE launch a
partition step; it prints the device ops and port kernel launches of one
warm iteration.
Phase 4 searches: a `docs` table of 1,000,000 rows with a 64-lane float32
embedding in 64 partitions of 15,625, and `similarity_join` with and
without a filter below it, ids checked exactly against numpy.  It must
run exactly one `topk_similarity` launch, on its `fused` route over the
lanes in place, per kernel-routed partition search.  On the card, phases
3 and 4 each end with a torch.profiler trace of one warm step (a `trace`
JSON line: device busy time and idle share, device and host ops).
Phase 5 serves Zamba2-7B (arXiv:2411.15242 as the registry defines it: 81
slots, d_model 3584, 5.88 B parameters, random bf16 weights drawn on the
card from `--seed`) through `ServeEngine`: a batch of 4 prompts of 2,048
tokens with 64 new tokens each, and 1 prompt of 1,000 tokens with 16 new
tokens (prompts drawn with numpy from `--seed`).  It prints the build,
prefill and decode times, the launches of one prefill (11
`flash_attention_fwd` and 70 `ssd_scan`, all on the tensor-core routes;
a bf16 prefill launch on a SIMT route fails the run), traces of one
prefill and one decode step, and peak device memory; then, on a float32
copy of the same weights, it holds the kernels' prefill logits against
the plain versions' and one decode step against the full forward over
S + 1 tokens.  The CPU rehearsal serves the smoke variant (phases 9 and
10 too).

Phase 6 (run right after phase 2, on its tables) serves them through a
`SharkServer` on the card: `lineitem` and `orders` registered as
benchmarks/concurrent_bench.py registers its warehouse, a cache budget of
0.3 x the catalog's bytes (concurrent_bench's share: caching must churn),
4 clients of weights 1, 1, 2 and 4 (`max_concurrent_queries=4`) each
submitting queries a-e at once, in three rounds: cold (evictions and
lineage recomputes must happen), cached (every answer from the result
cache, no launch) and after `orders` is registered again with the same
rows (e must miss, a-d must hit).  Every answer is checked against numpy,
no shuffle block may outlive its query, every scan and radix launch must
take phase 2's route, a warm query a through the server (its result-cache
entry dropped) must make no host-to-device copy and keep its column's
device memos, and after `shutdown()` the card's allocated memory must be
back at its level before the phase.  It prints each round's wall, QPS,
p50 / p95 by weight and service share by weight, the memory manager's
and the scheduler's statistics, a trace of the warm query, and the
phase's wall; the `kernels` line gives kernels 1-5 their launches in the
three rounds as `server_launches`.

Phase 7 (after phase 6) runs the storage tier under a `SharkServer` on the
card, on benchmarks/spill_bench.py's workload: its `lineitem` schema and
deterministic loader behind an `ExternalSource` (every partition has
lineage), its three queries a round with thresholds of their own, its
server settings, and its budget, a quarter of the working set (the
catalog's bytes on an unlimited-budget server, which also gives the
answers).  7a: 6,000,000 rows (TPC-H SF1's lineitem count) in 64
partitions, spill mode, 3 clients x 3 rounds, one partition segment
deleted between rounds 2 and 3; 7b: 600,000 rows (spill_bench's default)
in 8 partitions, spill mode and then drop mode.  Every answer must equal
the unlimited-budget server's; 7a must spill and read segments back, and
the round after the deletion must recover it (lost segment, lineage
fault); drop mode must fault from lineage and write no segment; no
shuffle block may outlive its query; after every round no block of a
cold partition may hold a device copy; every colscan and radix launch
must keep a known route; after each server's `shutdown()` the card's
memory is back at its level before the phase and the server's own spill
directory is gone.  It prints each round's storage counters and
`device_bytes`, each server's wall, p50 / p95 a query and memory
statistics, 7b's drop / spill wall ratio, the phase's wall, and a trace of
one warm query 1 in 7a with its host-to-device copies and bytes; the
`kernels` line gives kernels 1-5 their launches in the phase as
`storage_launches`.

Phase 8 (after phase 7) runs the cluster tier on the card, on
benchmarks/scale_bench.py's workload: its `uservisits` table (`k` INT64 in
[0, 64), `x` FLOAT64 U(-100, 100), `v` FLOAT64 U(0, 10), drawn with numpy
from `--seed`; `--rows` rows in its 8 partitions), its `query_mix(48)` (36
range scans, 12 GROUP BY k) and its fixed per-replica settings, the card
as every replica's device.  8a: a `SharkFleet` of 1, 2 and 4 replicas
(least-loaded routing, 2 warm-up queries, then the storm); 8b: 2
replicas, the first alive one killed after query 12 is submitted (reroutes
must happen); 8c: a mesh session over the mix's first 12 queries on
`MeshContext()` (one slot a card) and on 4 slots sharing `cuda:0`, each
mesh dispatch holding exactly one `colscan` launch a partition or one
`radix_split` launch a slot (route one_launch), then on 4 slots a slot
killed mid group-by (a retry, 3 slots, the same rows) and a trace of one
warm group-by with its copies by kind; 8d: 2 replicas each over its own
2-slot mesh (`mesh_factory`), 12 queries (mesh dispatches must happen).
Every answer is checked against numpy (integers exactly, floats to rtol
1e-9), no shuffle block may outlive a storm or a query, and after each
fleet's or session's `shutdown()` the card's memory is back at its level
before the phase.  It prints each storm's QPS, p50 / p95, reroutes and
served counts, the 1-to-4 scaling, each mesh's wall, partitions, shipped
rows and bytes, `stats()` and launches a dispatch, and the phase's wall;
the `kernels` line gives kernels 1 and 4 their launches in the phase as
`cluster_launches`.

Phase 9 (after phase 5, whose model and caches it releases first, printing
the device memory allocated before and after) serves the dense family:
Yi-9B (arXiv:2403.04652 as the registry defines it: 48 layers, d_model
4096, 32 query heads over 4 kv heads of 128, d_ff 11008, vocab 64,000,
about 8.8 B parameters, random bf16 weights drawn on the card from
`--seed`) at full width and depth on phase 5's requests, with phase 5's
prints and checks: 48 `flash_attention_fwd` launches a prefill, every one
on the tensor-core route, k and v handed to the kernel with their 4 kv
heads; float32 kernels vs plain and decode vs the full forward within
1e-3.  Then Phi3-medium-14b (40 heads over 10), Qwen2.5-3b (16 over 2,
QKV bias, tied embeddings) and StarCoder2-15b (48 over 4, QKV bias,
LayerNorm, GELU) at full width and 2 layers (the only cut), each serving
1 x 1,000 + 8 tokens with its biases and norm parameters drawn from the
seed, checked the same way.  The `kernels` line gives kernel 11 its
phase-9 launches as `dense_launches`.  Phase 1 also holds kernel 11
against its plain version with k and v of fewer heads (GQA: Yi-9B's
prefill shape, and g = 4, 8, 12, ragged, both routes), checks that one
GQA call is one kernel, and times it at Yi-9B's shape beside its bound
and `scaled_dot_product_attention(..., enable_gqa=True)` as row `11G`
(`kernels[...]["gqa"]`).

Phase 10 (after phase 9, whose models it releases first, printing the
device memory allocated before and after) serves the moe family:
DeepSeek-V2-Lite (arXiv:2405.04434 as the registry defines it: 27 layers,
d_model 2048, MLA with 16 heads, kv_lora 512, nope 128, rope 64, v 128;
layer 0 dense with d_ff 10944, then 64 routed experts of 1408 top-6 and 2
shared; about 15.7 B random bf16 weights drawn on the card from
`--seed`) at full width and depth on phase 5's requests, at the
reference's capacity factor of 1.25, with phase 5's prints and checks
(no kernel is on its path: MLA and the experts are plain torch, as they
are plain JAX in the reference), every weight, cache and logit on the
card, per request the peak device memory and the router statistics
(`frac_dropped` summed over layers, the largest expert load over the
mean); its float32 checks run on the 1 x 1,000 request at the drop-free
capacity (E / k: decode routes dropless, and only without drops is it
the full forward's function), gated at 1e-3, with the gaps at 1.25
reported beside them.  Then Phi-3.5-MoE (GQA, 32 heads over 8 kv heads
of 128, 16 experts of 6,400 top-2) at full width and 2 of its 32 layers
on 1 x 1,000 + 8 tokens: 2 tensor-core `flash_attention_fwd` launches a
prefill, float32 kernels vs plain and decode vs full forward, drop-free,
within 1e-3.  The `kernels` line gives kernel 11 its phase-10 launches as
`moe_launches`, and the run fails if phase 10 launched no flash.

Phase 11 (after phase 10, whose models it releases first) serves the
cross-attending families, each request with its stub frontend output,
bf16 N(0, 1) drawn on the card from `--seed`, and the gates, norms and
biases drawn from the seed (the reference's zero gates would hide the
cross layers): Llama-3.2-Vision-11B (hf:meta-llama/Llama-3.2-11B-Vision
as the registry defines it: 40 layers in 8 groups of 4 dense blocks and
1 gated cross layer, d_model 4096, 32 query heads over 8 kv heads of
128, d_ff 14336, vocab 128,256, about 9.8 B random bf16 weights) whole
on phase 5's requests over 1,601 image tokens a request: 40
`flash_attention_fwd` launches a prefill, 32 causal and 8 non-causal at
T = 1,601, all on the tensor-core route, float32 checks within 1e-3 on
the 1 x 1,000 request; then Whisper-base (arXiv:2212.04356: 6 encoder
and 6 decoder blocks, d_model 512, 8 heads of 64, LayerNorm, GELU) whole
over 1,500 frames a request, on 4 x (64 + 384) and 1 x (16 + 64) tokens
(within its 448-token text context): 18 launches a prefill (6 non-causal
encoder, 6 causal self, 6 non-causal cross), float32 checks on both
requests.  Phase 5's prints and checks hold for both.  The `kernels`
line gives kernel 11 its phase-11 launches as `vlm_launches` and
`encdec_launches`, and the run fails if either model launched no flash.
Phase 1 also holds kernel 11 non-causally at S != T and ragged T on both
routes (Llama's 4 x 2,048 and 1 x 1,000 queries against 1,601 image
tokens, Whisper's 1,500 x 1,500 and 64 x 1,500, and S > T), checks that
one such call is one kernel, and times it at Llama's cross shape beside
its bound and `scaled_dot_product_attention(..., enable_gqa=True)` as
row `11X` (`kernels[...]["cross"]`, its `launches` the vlm model's
main-path flash launches, 8 of every 40 of them cross).

Phase 12 (after phase 11, whose models it releases first) trains, and
serves with A.5.3's two options.  12a: Yi-9B whole (phase 9's weights,
drawn again from the seed) on 4 x 2,048 + 8 tokens with the bf16 cache,
the int8 cache (`kv_cache_quant`) and bf16 scores (`attn_scores_dtype`):
prefill and decode step times, cache bytes and greedy tokens each; the
int8 cache's first decode step within total variation 0.05 of the bf16
cache's with the same argmax, the bf16-score loss within 0.02 of the
float32-score loss (the reference test's bounds), 48 flash launches a
prefill with either cache and none with bf16 scores (their plain route).
12c: Qwen2.5-3B and Mamba2-370m at full width and 2 layers, float32
weights (norms and biases drawn): the loss and every parameter's gradient
through kernels 11 and 12 against the plain routes, within 1e-3
(`attn_impl="blockwise"`, the exact backward) and within 2^-7
(`attn_impl="flash"`, whose backward rounds to bf16: the bound comes from
`scripts/grad_bounds.py`'s readings over seeds, PERF.md).
12b: Qwen2.5-3B whole (36 layers, d_model 2,048, 16 heads over 2 kv
heads, vocab 151,936, tied, 3.09 B random bf16 weights) trained 5 AdamW
steps of 4 x 2,048 tokens from `TokenPipeline` over a synthetic corpus in
a session on the card, selected by `quality > 0.1`: the memory reckoned
before the batch is chosen (state 16 bytes a parameter), each step's
loss, finite and falling (and a held-out batch's), the warm step time and
tokens/s, a forward and AdamW alone, peak memory, a torch.profiler trace
of one warm step, and the main path's launches (the selection and the
steps: kernel 11 in every forward and in each block's recomputation).
12d: Mamba2-370m whole (0.42 B) the same way, 8 x 2,048 a step, kernel
12.  12e: `qwen2.5-3b-smoke` on the card, checkpointed asynchronously
after 3 of 8 steps into a temporary directory, a simulated preemption,
the model and optimizer restored into fresh objects and the steps from
the manifest's step replayed: losses within rel 1e-3 of the
uninterrupted run's (no deterministic algorithms are set).  Phase 1 also
holds kernel 11's log-sum-exp output (what the backward reads) against
its plain version on both routes, times the kernel with it, and times
the plain-torch backwards of kernels 11 and 12 at the timed shapes.  The
`kernels` line gives every kernel its phase-12 launches as
`train_launches`, and the run fails if 12b launched no flash or 12d no
SSD scan.

Phase 13 (after phase 12, whose models it releases first) runs expert
parallelism (`moe_impl="ep_shardmap"`, `models/moe.moe_apply_ep`) on
Phi-3.5-MoE (hf:microsoft/Phi-3.5-MoE-instruct) at full width and 2 of
its 32 layers (2.86 B random bf16 weights, norms and biases drawn; 83.7e9
bytes whole) under `set_mesh(make_debug_mesh(1, 4))`: four slots sharing the
card, 4 of the 16 experts a slot.  13a serves phase 5's requests at
capacity 1.25 through `serve_model` (2 tensor-core flash launches a
prefill, every tensor on the card, float32 checks at the drop-free
capacity: kernels vs plain, decode vs the full forward, and EP's prefill
logits vs `moe_apply`'s, each within 1e-3), then prints each slot's
dropped share of the assignments beside `moe_apply`'s `frac_dropped` on
the same layer inputs, and the 4 x 2,048 prefill warm, busy (traced)
and at its peak memory with each `moe_impl` on the one build.  13b
trains the same model 5 AdamW steps of 4 x 2,048 tokens (lr 3e-3,
`TokenPipeline` batches of phase 12's corpus, the batch from the memory
reckoning) while `MoEReplanner` observes each step's expert load and
replans after steps 2 and 4 (one train step kept a capacity bucket), as
examples_torch/pde_moe_training.py does; then, on a float32 copy at 2
layers with kernel 11's exact backward at the drop-free capacity, the
loss and every gradient of EP against `moe_apply`'s within 1e-3 in norm.
13c runs examples_torch/quickstart.py, sql_ml_pipeline.py and
multi_tenant.py in this process on the card and on the CPU: their answer
lines must be equal, and the card runs' kernel launches are printed.
The `kernels` line gives every kernel its phase-13 launches (13a's
generate, 13b's selection and steps, 13c's card runs) as `ep_launches`,
and the run fails if phase 13 launched no flash.

Phase 14 (after phase 13, whose models it releases first) is the dry
run (`repro_torch/launch/dryrun.py`).  14a counts the 32 cells of
`dryrun.cell_list()` (10 architectures x `SHAPES`, `long_500k` for the
sub-quadratic ones) on the meta device in 8 spawned worker processes and
prints a line a cell: the predicted peak memory and whether it fits the
card's memory (`launch/cost.H100.hbm_bytes`, printed beside the card's
own `total_memory`), the three roofline terms by the data sheet's peaks
(`launch/cost.H100`), the bound, the useful share of the counted FLOPs
and the kernel calls; it fails unless kernel 11 is counted in every
train and prefill of a family with GQA layers, kernel 12 in those of the
ssm and hybrid families, and neither in a decode.  14b holds the dry run
against the card: Yi-9B whole on phase 9's 4 x 2,048 prefill (max_seq
2,112) and Qwen2.5-3B whole on one AdamW step of 4 x 2,048 tokens, each
called warm, then timed with its peak memory (`max_memory_allocated`
after `reset_peak_memory_stats`), then counted on the card
(`launch/cost.analyze`): its op count, FLOPs by dtype, elementwise
FLOPs, HBM bytes, wire bytes and kernel calls must equal the meta dry
run's, kernel 11 must launch on its tensor-core route as often as
counted, and the dry run's peak must lie within 10% of the measured one.
The warm time is printed beside the roofline's bound and model FLOPs /
989 TFLOP/s / time (reported, not gated).  Rows 11-12's bounds in phase
1 come from the same formulas (`launch/cost.flash_cost`, `ssd_cost`).
The `kernels` line gives every kernel its phase-14b launches as
`dry_launches`, and the run fails if phase 14 launched no flash.

Output: the card's name and power limit, per-phase lines, a `kernels`
JSON line, and last `{"ok": true, "device": {...}}`.  Without a CUDA
device (and without `--device cpu`), or outside a checkout of the repo,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# 64 partitions put 64 x 50 = 3,200 partial-state rows into query (c)'s
# reduce, past PDEConfig.reduce_min_compiled_rows (2048), so the merge
# takes segmented_merge; the main path is timed over REPS runs
PARTITIONS = 64
REPS = 3
SHIP_MODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                       "FOB"])
TPU_KERNELS = {
    "colscan": "src/repro/kernels/colscan.py:74",
    "fused_decode_scan": "src/repro/kernels/dictdecode.py:153",
    "groupby_sum": "src/repro/kernels/groupby_mxu.py:56",
    "radix_partition": "src/repro/kernels/radix_partition.py:107",
    "segmented_merge": "src/repro/kernels/segmented_merge.py:64",
    "dict_decode": "src/repro/kernels/dictdecode.py:41",
    "bitpack_decode": "src/repro/kernels/dictdecode.py:72",
    "rle_decode": "src/repro/kernels/dictdecode.py:98",
    "topk_similarity": "src/repro/kernels/topk_similarity.py:106",
    "train_grad": "src/repro/kernels/train_grad.py:67",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:96",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:94",
}
SOURCES = {
    "colscan": "src/repro_torch/kernels/csrc/scan.cu",
    "fused_decode_scan": "src/repro_torch/kernels/csrc/scan.cu",
    "groupby_sum": "src/repro_torch/kernels/csrc/group.cu",
    "radix_partition": "src/repro_torch/kernels/csrc/radix.cu",
    "segmented_merge": "src/repro_torch/kernels/csrc/group.cu",
    "dict_decode": "src/repro_torch/kernels/csrc/decode.cu",
    "bitpack_decode": "src/repro_torch/kernels/csrc/decode.cu",
    "rle_decode": "src/repro_torch/kernels/csrc/decode.cu",
    "topk_similarity": "src/repro_torch/kernels/csrc/topk.cu",
    "train_grad": "src/repro_torch/kernels/csrc/train.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd.cu",
}
SQL_KERNELS = ("colscan", "fused_decode_scan", "groupby_sum",
               "radix_partition", "segmented_merge")
TRAIN_KERNELS = ("dict_decode", "bitpack_decode", "rle_decode", "train_grad")
SEARCH_KERNELS = ("topk_similarity",)
LM_KERNELS = ("flash_attention_fwd", "ssd_scan")
# phase 3/4 partition sizes at full size: 10,000,000 / 64 and 1,000,000 / 64
TRAIN_ROWS, DOCS_ROWS = 156_250, 15_625
# the scan kernels' streaming line: 10,000,000 rows (160 MB of two float64
# columns, 120 MB of int32 codes and a float64 column), past the L2
LARGE_SCAN_ROWS = 10_000_000
EMB_DIM, TOP_K = 64, 100
# the shuffle's buckets on the main path: the executor's max(64, partitions)
RADIX_BUCKETS = 64
# radix_split's grid (phase 1), and its rows: query c's 50 partial-state
# keys a partition (row 4), a lineitem partition of query e (4M) and
# 10,000,000 keys past the L2 (4L)
RADIX_GRID_ROWS = (0, 1, 50, 1023, 4096, 4097, 93_750)
RADIX_GRID_BUCKETS = (1, 7, 64, 1000, 8192)
RADIX_ROWS = {"partials": 50, "medium": 93_750, "large": 10_000_000}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------- timing


class Timer:
    """Time per call of `fn()` over `reps` back-to-back calls after
    `warmup` calls: CUDA events on the card, the host clock on the CPU
    rehearsal.  It includes the host's cost per call wherever that exceeds
    the device's; `graphed` takes the device's alone."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def __call__(self, fn, reps: int = 50, warmup: int = 5) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    def graphed(self, fn, calls: int = 20, replays: int = 10):
        """Device time of one `fn()`: `calls` calls captured in one CUDA
        graph, replayed `replays` times between CUDA events, so the host's
        cost per call (allocation, ctypes) drops out.  None on the CPU."""
        torch = self.torch
        if not self.cuda:
            return None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * calls)


def traced(torch, device, label: str, fn) -> None:
    """Run `fn()` once under torch.profiler, print one JSON line and return
    it: the wall time (the profiler's own cost per op included), the
    device's busy time (the union of its kernels' and copies' spans) and
    idle share, the count of device ops (kernels and copies), the
    host-to-device copies and their bytes, the copies by kind (HtoD, DtoH,
    DtoD) with their bytes and the copy calls the host made, the device
    ops by time and the host ops by their own CPU time."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):    # the tracer's start-up,
        torch.cuda.synchronize()            # outside the window
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    kernels, host = {}, []
    for e in prof.events():
        if e.device_type.name == "CUDA":
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total
                    )[:12]:
        host.append([e.key[:60], e.count, e.self_cpu_time_total / 1e3])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    # copies the host issued, to hold the device's copy records against
    copy_calls = sum(e.count for e in prof.key_averages()
                     if e.key in ("cudaMemcpyAsync", "cudaMemcpy"))
    htod = sum(1 for e in prof.events() if e.device_type.name == "CUDA"
               and e.name.startswith("Memcpy HtoD"))
    # the copies' bytes are in the exported trace's event arguments
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    htod_bytes = sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                     if str(e.get("name", "")).startswith("Memcpy HtoD"))
    copies = {}         # kind -> [copies, bytes]
    for e in events:
        name = str(e.get("name", ""))
        if name.startswith("Memcpy ") and e.get("ph") == "X":
            c = copies.setdefault(name.split()[1], [0, 0])
            c[0] += 1
            c[1] += int(e.get("args", {}).get("bytes", 0))
    rec = {"trace": label, "wall_ms": wall, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / 1e3 / wall,
           "device_ops": len(spans), "htod_copies": htod,
           "htod_bytes": htod_bytes, "copies": copies,
           "host_copy_calls": copy_calls,
           "device_ops_ms": [[k, c, ms] for k, (c, ms) in top],
           "host_self_ms": host}
    print(json.dumps(rec), flush=True)
    return rec


def one_kernel(name: str, fn) -> None:
    """Fail unless one `fn()` call runs exactly one device kernel (the
    nodes of a CUDA graph captured around the call)."""
    from repro_torch.kernels._common import graph_nodes
    try:
        kinds = graph_nodes(fn)
    except RuntimeError as e:
        fail(str(e))
    if kinds != {"kernel": 1}:
        fail(f"one {name} call put {kinds} on the device, not one kernel")
    print(f"phase 1: one {name} call runs one kernel (the nodes of a CUDA "
          f"graph of the call: {json.dumps(kinds)})", flush=True)


def bound(nbytes: float, ops: float, dtype: str = "float32"):
    """(ms, "bytes" or "operations"): the least time of work that moves
    `nbytes` and does `ops` operations on `dtype` operands, by the H100's
    data-sheet peaks (`repro_torch.launch.cost.H100`, which the dry run
    uses too).  The table lists no float64 rate: the float32 rate outside
    the tensor cores (67 TFLOP/s), the default, is the nearest listed peak
    for the SQL kernels' scalar work."""
    from repro_torch.launch.cost import H100
    return H100.bound_ms(nbytes, ops, dtype)


# ---------------------------------------------------------------- phase 1


def scan_err(got, want) -> float:
    """Exact count / min / max, sum to rtol 1e-12; returns the largest
    absolute difference."""
    g = got.cpu().double().numpy()
    w = want.cpu().double().numpy()
    if not (g[0] == w[0] and g[2] == w[2] and g[3] == w[3]):
        fail(f"scan count/min/max differ: kernel {g} plain {w}")
    if not np.allclose(g[1], w[1], rtol=1e-12, atol=1e-9):
        fail(f"scan sum differs: kernel {g[1]!r} plain {w[1]!r}")
    return float(abs(g[1] - w[1]))


def group_err(got, want) -> float:
    """Exact counts (and min / max), sums to rtol 1e-12."""
    g = got.cpu().numpy()
    w = want.cpu().numpy()
    if not np.array_equal(g[:, 1:], w[:, 1:]):
        fail("group counts/min/max differ from the plain version")
    if not np.allclose(g[:, 0], w[:, 0], rtol=1e-12, atol=1e-9):
        fail("group sums differ from the plain version")
    return float(np.max(np.abs(g[:, 0] - w[:, 0]), initial=0.0))


def phase_kernels(torch, device, seed: int) -> dict:
    """Every kernel against its plain version, on the device, at the main
    path's sizes and ragged ones; then each timed at its main-path shape."""
    from repro_torch.kernels import colscan as kc
    from repro_torch.kernels import dictdecode as kd
    from repro_torch.kernels import groupby_mxu as kg
    from repro_torch.kernels import radix_partition as kr
    from repro_torch.kernels import segmented_merge as km

    rng = np.random.default_rng(seed)
    dev = device
    err = {k: 0.0 for k in SQL_KERNELS}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bounds = [(20000.0, 40000.0), (-np.inf, 30000.0), (50000.0, np.inf),
              (np.inf, -np.inf)]
    for n in (1, 1023, 93750, 375001):
        price = np.round(rng.uniform(900, 105000, n), 2)
        fcol = price.copy()
        fcol[::13] = np.nan                        # NaN filter values
        qty = rng.integers(1, 51, n).astype(np.int32)
        tp = t(price)
        for f, a in ((t(fcol), tp), (t(qty.astype(np.float64)), t(qty)),
                     (t(qty), tp), (tp, tp)):    # the last: one column
            for lo, hi in bounds:
                err["colscan"] = max(err["colscan"], scan_err(
                    kc.colscan(f, a, lo, hi), kc.colscan_plain(f, a, lo, hi)))
        disc = np.round(np.arange(11) * 0.01, 2)
        codes = rng.integers(0, 11, n).astype(np.int32)
        codes[::17] = 11                           # the pad code
        for lo, hi in ((0.05, 0.07), (-np.inf, np.inf), (0.02, np.inf)):
            err["fused_decode_scan"] = max(err["fused_decode_scan"], scan_err(
                kd.fused_decode_scan(t(codes), t(disc), t(price), lo, hi),
                kd.fused_decode_scan_plain(t(codes), t(disc), t(price), lo,
                                           hi)))
        for g in (7, 50, 512):
            present = rng.choice(g, size=max(1, g // 2), replace=False)
            gc = present[rng.integers(0, len(present), n)].astype(np.int32)
            for vals in (price, qty):
                err["groupby_sum"] = max(err["groupby_sum"], group_err(
                    kg.groupby_sum(t(gc), t(vals), g),
                    kg.groupby_sum_plain(t(gc), t(vals), g)))
            inv = gc.astype(np.int64)
            err["segmented_merge"] = max(err["segmented_merge"], group_err(
                km.segmented_merge(t(inv), t(price), g),
                km.segmented_merge_plain(t(inv), t(price), g)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    err["radix_partition"] = radix_grid(torch, device, t, rng, kr)
    print(f"phase 1: 5 kernels match their plain versions, max abs err "
          f"{json.dumps(err)}", flush=True)

    # timing at the shapes the main path gives each kernel
    timer = Timer(torch, device)
    n = 93750
    price = t(np.round(rng.uniform(900, 105000, n), 2))
    other = t(np.round(rng.uniform(900, 105000, n), 2))
    codes = t(rng.integers(0, 11, n).astype(np.int32))
    disc = t(np.round(np.arange(11) * 0.01, 2))
    qcodes = t(rng.integers(0, 50, n).astype(np.int32))
    m_rows, m_groups = 64 * 50, 50
    minv = t(rng.integers(0, m_groups, m_rows).astype(np.int64))
    mval = t(rng.uniform(1e7, 2e7, m_rows))
    rkeys = t(radix_keys(rng, RADIX_ROWS["partials"]))
    stacked = torch.stack([price, torch.ones_like(price)], dim=1)

    def index_add_groupby():
        torch.zeros((50, 2), dtype=torch.float64, device=dev).index_add_(
            0, qcodes, stacked)

    cases = {
        # query a filters and sums one column: the least work is one read
        "colscan": (lambda: kc.colscan(price, price, 20000.0, 40000.0),
                    lambda: kc.colscan_plain(price, price, 20000.0, 40000.0),
                    None, 8.0 * n + 32, 4.0 * n),
        "fused_decode_scan": (
            lambda: kd.fused_decode_scan(codes, disc, price, 0.05, 0.07),
            lambda: kd.fused_decode_scan_plain(codes, disc, price, 0.05,
                                               0.07),
            None, 12.0 * n + 8 * 11 + 32, 4.0 * n),
        "groupby_sum": (lambda: kg.groupby_sum(qcodes, price, 50),
                        lambda: kg.groupby_sum_plain(qcodes, price, 50),
                        index_add_groupby, 12.0 * n + 16 * 50, 2.0 * n),
        "segmented_merge": (
            lambda: km.segmented_merge(minv, mval, m_groups),
            lambda: km.segmented_merge_plain(minv, mval, m_groups),
            None, 16.0 * m_rows + 32 * m_groups, 4.0 * m_rows),
        # the shuffle's whole split of a map task's int64 keys: each key
        # read once, order and bounds written once
        "radix_partition": (
            lambda: kr.radix_split(rkeys, RADIX_BUCKETS),
            lambda: kr.radix_split_plain(rkeys, RADIX_BUCKETS),
            None, radix_bytes(RADIX_ROWS["partials"]),
            RADIX_OPS * RADIX_ROWS["partials"]),
    }
    two_columns = (lambda: kc.colscan(other, price, 20000.0, 40000.0),
                   lambda: kc.colscan_plain(other, price, 20000.0, 40000.0))
    if device.type == "cuda":
        for name in ("colscan", "fused_decode_scan", "groupby_sum",
                     "segmented_merge", "radix_partition"):
            one_kernel(name, cases[name][0])
        one_kernel("colscan (two columns)", two_columns[0])
        mkeys = t(radix_keys(rng, RADIX_ROWS["medium"]))
        one_kernel("radix_partition (93,750 keys)",
                   lambda: kr.radix_split(mkeys, RADIX_BUCKETS))
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in cases.items():
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": timer(kern),
            "device_ms": timer.graphed(kern),
            "plain_ms": timer(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lib) if lib is not None else None,
            "library_device_ms": (timer.graphed(lib) if lib is not None
                                  else None),
        }
    err_two = scan_err(two_columns[0](), two_columns[1]())
    b_ms, b_by = bound(16.0 * n + 32, 4.0 * n)
    out["colscan"]["two_columns"] = {
        "rows": n, "launches": None, "max_abs_err": err_two,
        "ms": timer(two_columns[0]),
        "device_ms": timer.graphed(two_columns[0]),
        "plain_ms": timer(two_columns[1]), "bound_ms": b_ms, "bound_by": b_by}
    out["colscan"]["large"], out["fused_decode_scan"]["large"] = \
        scan_large(t, rng, timer, kc, kd)
    for row, n in RADIX_ROWS.items():
        rec = radix_row(torch, device, timer, kr, rng, n)
        if row == "partials":
            out["radix_partition"].update(rec)
        else:
            out["radix_partition"][row] = rec
    return out


# radix_split's operations a key: the fold, the mix, the modulo and the
# rank (integer work; the bytes bound it)
RADIX_OPS = 12.0


def radix_bytes(n: int) -> float:
    """radix_split's bytes: each int64 key read once, its order entry and
    the B + 1 bounds written once."""
    return 12.0 * n + 4.0 * (RADIX_BUCKETS + 1)


def radix_keys(rng, n: int) -> np.ndarray:
    """int64 key hashes, negatives and repeats among them."""
    k = rng.integers(-2 ** 62, 2 ** 62, n)
    k[::7] = -1
    if n:
        k[3::11] = k[0]
    return k


def radix_grid(torch, device, t, rng, kr) -> float:
    """radix_split (int64 keys, and 32-bit lanes) and radix_partition (ids
    and counts, and ids alone) against their plain versions and the numpy
    oracle, bit for bit, over RADIX_GRID_ROWS x RADIX_GRID_BUCKETS; every B up to 1024 on
    the one-launch route.  Returns the largest difference (0: exact)."""
    routes0 = dict(kr.ROUTES)
    want_routes = {"one_launch": 0, "two_launch": 0}
    for n in RADIX_GRID_ROWS:
        k64 = radix_keys(rng, n)
        k32 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        k32[::5] = 12345
        lanes = t(k32.view(np.int32))
        for b in RADIX_GRID_BUCKETS:
            for k in (k64, k32.view(np.int32)):
                kt = t(k)
                got = kr.radix_split(kt, b)
                plain = kr.radix_split_plain(kt, b)
                ref = kr.radix_split_ref(k, b)
                for g, p, r, what in zip(got, plain, ref, ("order", "bounds")):
                    if not (torch.equal(g, p)
                            and np.array_equal(p.cpu().numpy(), r)):
                        fail(f"radix_split {what} differs (n={n}, B={b}, "
                             f"keys {k.dtype})")
            ids, counts = kr.radix_partition(lanes, b)
            pids, pcounts = kr.radix_partition_plain(lanes, b)
            wids, wcounts = kr.radix_partition_ref(k32, b)
            if not (torch.equal(ids, pids) and torch.equal(counts, pcounts)
                    and np.array_equal(ids.cpu().numpy(), wids)
                    and np.array_equal(counts.cpu().numpy(), wcounts)):
                fail(f"radix_partition differs (n={n}, B={b})")
            only, none = kr.radix_partition(lanes, b, with_counts=False)
            if not (none is None and torch.equal(only, pids)
                    and np.array_equal(only.cpu().numpy(), wids)):
                fail(f"radix_partition's ids alone differ (n={n}, B={b})")
            route = "one_launch" if b <= kr.ONE_LAUNCH_MAX else "two_launch"
            want_routes[route] += 4
    if device.type == "cuda":
        torch.cuda.synchronize()
        routes = {r: kr.ROUTES[r] - routes0[r] for r in want_routes}
        if routes != want_routes:
            fail(f"radix calls took routes {routes}, not {want_routes}")
    print(f"phase 1: radix_split and radix_partition (with counts and ids "
          f"alone) equal their plain versions bit for bit at n in {list(RADIX_GRID_ROWS)} x B in "
          f"{list(RADIX_GRID_BUCKETS)}", flush=True)
    return 0.0


def wall_ms(fn, reps: int) -> float:
    """Host clock per call of `fn()`, a call that ends on the host (its
    own copies back synchronize), after two warm-up calls."""
    fn()
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def radix_row(torch, device, timer, kr, rng, n: int) -> dict:
    """radix_split over n int64 keys into RADIX_BUCKETS buckets: exact
    against the plain version; device ms (graphed), the wrapper's ms, the
    plain version's; and what a shuffle's map task pays, host numpy in and
    numpy out (`call_ms`: shuffle.split_keys; `chain_ms`: the chain it
    replaced — host fold, pageable copy, ids kernel, `.cpu()`, stable
    np.argsort, np.searchsorted), timed in turns new, old, old, new; and,
    for context, torch.argsort of the ids (half the function)."""
    from repro_torch.core.shuffle import split_keys
    b = RADIX_BUCKETS
    if not timer.cuda and n > 10 ** 5:
        n = 10 ** 5                      # the CPU rehearsal's size
    k = radix_keys(rng, n)
    kt = torch.from_numpy(k).to(device)
    got, want = kr.radix_split(kt, b), kr.radix_split_plain(kt, b)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"radix_split differs from its plain version at n={n}")
    reps = 200 if n <= 50 else (30 if n <= 10 ** 5 else 3)

    def call():
        split_keys(k, b, device)

    def chain():
        keys = torch.from_numpy(kr.fold_keys_u32(k).view(np.int32)).to(device)
        ids = kr.radix_partition(keys, b, with_counts=False)[0].cpu().numpy()
        order = np.argsort(ids, kind="stable")
        np.searchsorted(ids[order], np.arange(b + 1))

    turns = [wall_ms(call, reps), wall_ms(chain, reps), wall_ms(chain, reps),
             wall_ms(call, reps)]
    lanes = torch.from_numpy(kr.fold_keys_u32(k).view(np.int32)).to(device)
    ids = kr.radix_partition(lanes, b, with_counts=False)[0]
    b_ms, b_by = bound(radix_bytes(n), RADIX_OPS * n)
    kern = lambda: kr.radix_split(kt, b)
    calls = 20 if n <= 10 ** 5 else 5
    device_ms = timer.graphed(kern, calls=calls, replays=4)
    return {
        "rows": n, "launches": None, "max_abs_err": 0.0,
        "ms": timer(kern, reps=max(10, reps), warmup=2),
        "device_ms": device_ms,
        "plain_ms": timer(lambda: kr.radix_split_plain(kt, b),
                          reps=max(3, reps // 10), warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "device_over_bound": (device_ms / b_ms if device_ms is not None
                              else None),
        "call_ms": (turns[0] + turns[3]) / 2,
        "chain_ms": (turns[1] + turns[2]) / 2, "call_turns_ms": turns,
        "argsort_device_ms": timer.graphed(
            lambda: torch.argsort(ids, stable=True), calls=calls,
            replays=4)}


def scan_large(t, rng, timer, kc, kd):
    """Both scan kernels over LARGE_SCAN_ROWS rows (two float64 columns;
    int32 codes into 11 float64 values and a float64 aggregate), where
    the bytes and not the launch bound them: device ms beside the bound."""
    n = LARGE_SCAN_ROWS
    if not timer.cuda:
        n = 10 ** 5                      # the CPU rehearsal's size
    f = t(np.round(rng.uniform(900, 105000, n), 2))
    a = t(np.round(rng.uniform(900, 105000, n), 2))
    codes = t(rng.integers(0, 11, n).astype(np.int32))
    disc = t(np.round(np.arange(11) * 0.01, 2))
    recs = []
    for kern, plain, nbytes in (
            (lambda: kc.colscan(f, a, 20000.0, 40000.0),
             lambda: kc.colscan_plain(f, a, 20000.0, 40000.0), 16.0 * n + 32),
            (lambda: kd.fused_decode_scan(codes, disc, a, 0.05, 0.07),
             lambda: kd.fused_decode_scan_plain(codes, disc, a, 0.05, 0.07),
             12.0 * n + 8 * 11 + 32)):
        b_ms, b_by = bound(nbytes, 4.0 * n)
        device_ms = timer.graphed(kern, calls=5, replays=4)
        recs.append({
            "rows": n, "max_abs_err": scan_err(kern(), plain()),
            "ms": timer(kern, reps=10, warmup=2), "device_ms": device_ms,
            "plain_ms": timer(plain, reps=3, warmup=1), "bound_ms": b_ms,
            "bound_by": b_by,
            "device_over_bound": (device_ms / b_ms if device_ms is not None
                                  else None)})
    del f, a, codes
    return recs


def pack_words(vals: np.ndarray, width: int) -> np.ndarray:
    """uint32 words of `32 // width` lanes each, low lane first."""
    per = 32 // width
    nw = -(-len(vals) // per)
    padded = np.zeros(nw * per, np.uint32)
    padded[:len(vals)] = vals
    words = np.zeros(nw, np.uint32)
    for j in range(per):
        words |= padded[j::per] << np.uint32(j * width)
    return words


def exact(name: str, got, want) -> float:
    """Decoded values, row ids and orders: equal, or the run fails."""
    if not (got.dtype == want.dtype and got.shape == want.shape
            and bool((got.cpu() == want.cpu()).all())):
        fail(f"{name} differs from its plain version")
    return 0.0


def bitpack_encs(rng, n: int, widths) -> list:
    """BITPACK blocks of n rows at the given bit widths, each using its
    full width (past one row): int64 blocks with biases outside int32
    (either sign), int32 blocks with a negative bias."""
    from repro_torch.core.compression import Encoding, encode
    encs = []
    for j, width in enumerate(widths):
        if j % 2:
            lo, dt = (-(2 ** 40) if j % 4 == 1 else 2 ** 35 + 7), np.int64
        else:
            lo, dt = -(1 << (width - 1)) - 3, np.int32
        vals = (lo + rng.integers(0, 1 << width, n)).astype(dt)
        vals[:2] = [lo + (1 << width) - 1, lo][:n]
        enc = encode(vals, Encoding.BITPACK)
        if n > 1 and (enc.bit_width != width or enc.bias != lo):
            fail(f"bitpack block of width {width} encoded as "
                 f"{enc.bit_width}, bias {enc.bias}")
        encs.append(enc)
    return encs


def phase_kernels_analytics(torch, device, seed: int) -> dict:
    """The analytics kernels (decode, top-k, gradient) against their plain
    versions on the device at ragged sizes; then each timed at the shape
    phases 3 and 4 give it."""
    from repro_torch.core.compression import (Encoding, bitpack_block,
                                              decode_torch, encode)
    from repro_torch.kernels import dictdecode as kd
    from repro_torch.kernels import topk_similarity as kt
    from repro_torch.kernels import train_grad as kg

    rng = np.random.default_rng(seed + 1)
    dev = device
    err = {k: 0.0 for k in ("dict_decode", "bitpack_decode", "rle_decode",
                            "topk_similarity", "train_grad")}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # decode: every dictionary dtype (out-of-range codes included), every
    # bit width at a lane count that is not a multiple of lanes per word,
    # single-run and many-run RLE
    for n in (1, 1023, TRAIN_ROWS + 1):
        for dt in ("int32", "int64", "float32", "float64"):
            for d in (1, 11, 4000):
                dic = t((rng.normal(size=d) * 1000).astype(dt))
                codes = t(rng.integers(-3, d + 3, n).astype(np.int32))
                exact("dict_decode", kd.dict_decode(codes, dic),
                      kd.dict_decode_plain(codes, dic))
        for width in range(1, 17):
            vals = rng.integers(0, 1 << width, n).astype(np.uint32)
            words = t(pack_words(vals, width).view(np.int32))
            got = kd.bitpack_decode(words, width, -7, n)
            exact("bitpack_decode", got,
                  kd.bitpack_decode_plain(words, width, -7, n))
            if not np.array_equal(got.cpu().numpy(),
                                  vals.astype(np.int32) - 7):
                fail(f"bitpack_decode lanes differ (width {width})")
        # RLE: one run, runs of 8, runs of 1, zero-length runs, ends short
        # of n; the vector and into a column of a row-major (n, 12) x of
        # every dtype
        zero = rng.integers(0, 3, n)
        for lens in (np.array([n]), np.full(-(-n // 8), 8), np.ones(n, int),
                     zero, np.full(max(1, n // 9), 8)):
            ends = t(np.cumsum(lens).astype(np.int32))
            runs = len(lens)
            for dt in ("int32", "int64", "float64", "float32"):
                vals = t((rng.normal(size=runs) * 100).astype(dt))
                exact("rle_decode", kd.rle_decode(vals, ends, n),
                      kd.rle_decode_plain(vals, ends, n))
                for odt in (torch.int32, torch.int64, torch.float32,
                            torch.float64):
                    col = torch.zeros((n, 12), dtype=odt, device=dev)[:, 7]
                    want = torch.zeros(n, dtype=odt, device=dev)
                    kd.rle_decode_into(vals, ends, n, col)
                    kd.rle_decode_into_plain(vals, ends, n, want)
                    exact("rle_decode_into", col, want)
    # top-k: ties (integer lanes), continuous lanes, all rows tied, tile
    # edges +-1; k = 1, 100, the fused route's limit + 1 (route `rounds`)
    # and n + 5.  Scores are summed lane by lane on both versions, so
    # scores too must match to the bit; the lanes entry over x's columns
    # matches the matrix entry
    for n in (1, 255, 256, 257, 1023, 1024, 1025, DOCS_ROWS):
        cases = (rng.integers(-3, 4, size=(n, 8)).astype(np.float64),
                 rng.normal(size=(n, EMB_DIM)).astype(np.float32),
                 np.ones((n, 6), np.float32))
        for x in cases:
            w = rng.normal(size=x.shape[1])
            xt, q = t(x), t(w)
            lanes = [xt[:, j].contiguous() for j in range(x.shape[1])]
            for k in (1, TOP_K, kt.FUSED_MAX_K + 1, n + 5):
                gs, gi = kt.topk_similarity(xt, q, k)
                ps, pi = kt.topk_similarity_plain(xt, q, k)
                exact("topk_similarity", gi, pi)
                exact("topk_similarity", gs, ps)
                ls, li = kt.topk_similarity_lanes(lanes, w, k)
                exact("topk_similarity_lanes", li, pi)
                exact("topk_similarity_lanes", ls, ps)
    # batched bit-pack: widths 1-16 and a 1-bit label into the columns of a
    # row-major x and into y, int32 and int64 blocks with biases outside
    # int32, float32 and float64 outputs: each column equal to
    # decode_torch(enc).to(dt) on the device and the plain chain on the CPU
    for n in (1, 1023, TRAIN_ROWS + 1):
        encs = bitpack_encs(rng, n, list(range(1, 17)) + [1])
        blocks = [bitpack_block(e, dev) for e in encs]
        for dt in (torch.float32, torch.float64):
            buf = torch.full((n * 17,), -1, dtype=dt, device=dev)
            dests = [buf[:n * 16].view(n, 16)[:, j] for j in range(16)] \
                + [buf[n * 16:]]
            kd.bitpack_decode_into(blocks, dests, n)
            for e, dst in zip(encs, dests):
                exact("bitpack_decode_into", dst,
                      decode_torch(e, dev).to(dt))
                exact("bitpack_decode_into", dst,
                      decode_torch(e, "cpu").to(dt))
    # gradient: both kinds, float32 and float64 x, both routes (d = 31, 32
    # and 33 either side of the register route's limit; 64, 130 and 2048
    # chunked); sums to rtol 1e-12, and the same bits on a second call
    shapes = [(n, d) for n in (1, 1023, TRAIN_ROWS)
              for d in (1, 12, 31, kg.REG_MAX_DIMS, 33, 64, 130)]
    for n, d in shapes + [(1023, 2048)]:
        for dt in ("float32", "float64"):
            x = t((rng.normal(size=(n, d)) * 2).astype(dt))
            y = t((rng.uniform(size=n) < 0.5).astype(dt))
            w = t(rng.normal(size=d).astype(dt))
            for kind in kg.KINDS:
                g = kg.train_grad(x, y, w, kind)
                if not torch.equal(g, kg.train_grad(x, y, w, kind)):
                    fail(f"train_grad {kind} ({n}, {d}, {dt}) differs "
                         f"between two calls")
                got = g.cpu().numpy()
                want = kg.train_grad_plain(x, y, w, kind).cpu().numpy()
                if not np.allclose(got, want, rtol=1e-12, atol=1e-9):
                    fail(f"train_grad {kind} ({n}, {d}, {dt}) differs: "
                         f"{np.max(np.abs(got - want))}")
                err["train_grad"] = max(err["train_grad"], float(
                    np.max(np.abs(got - want))))
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"phase 1: 5 analytics kernels match their plain versions, max "
          f"abs err {json.dumps(err)}", flush=True)

    # timing at the shapes phases 3 and 4 give each kernel
    timer = Timer(torch, device)
    n = TRAIN_ROWS
    d_vals = 4000
    codes = t(rng.integers(0, d_vals, n).astype(np.int32))
    dic = t(np.round(np.arange(d_vals) * 0.01, 2))
    width = 4
    words = t(pack_words(rng.integers(0, 16, n).astype(np.uint32),
                         width).view(np.int32))
    n_words = int(words.shape[0])
    runs = n // 8
    run_lengths = t(np.full(runs, 8, np.int64))
    run_ends = t(np.cumsum(np.full(runs, 8)).astype(np.int32))
    run_vals = t(rng.normal(size=runs))
    dims = 12
    x = t(rng.normal(size=(n, dims)).astype(np.float32))
    y = t((rng.uniform(size=n) < 0.5).astype(np.float32))
    w = t(rng.normal(size=dims).astype(np.float32))
    emb = t(rng.normal(size=(DOCS_ROWS, EMB_DIM)).astype(np.float32))
    q = t(rng.normal(size=EMB_DIM))
    q32 = q.to(torch.float32)
    log2_runs = float(np.ceil(np.log2(runs)))
    cases = {
        "dict_decode": (lambda: kd.dict_decode(codes, dic),
                        lambda: kd.dict_decode_plain(codes, dic),
                        lambda: dic[codes], 12.0 * n + 8 * d_vals, 1.0 * n),
        "bitpack_decode": (
            lambda: kd.bitpack_decode(words, width, 0, n),
            lambda: kd.bitpack_decode_plain(words, width, 0, n),
            None, 4.0 * n_words + 4.0 * n, 3.0 * n),
        "rle_decode": (
            lambda: kd.rle_decode(run_vals, run_ends, n),
            lambda: kd.rle_decode_plain(run_vals, run_ends, n),
            # output_size: the call then needs no device-to-host sync
            # (one is not allowed inside a CUDA graph capture)
            lambda: torch.repeat_interleave(run_vals, run_lengths,
                                            output_size=8 * runs),
            12.0 * runs + 8.0 * n, n * log2_runs),
        "topk_similarity": (
            lambda: kt.topk_similarity(emb, q, TOP_K),
            lambda: kt.topk_similarity_plain(emb, q, TOP_K),
            lambda: torch.topk(emb @ q32, TOP_K),
            4.0 * DOCS_ROWS * EMB_DIM + 8 * EMB_DIM + 16 * TOP_K,
            2.0 * DOCS_ROWS * EMB_DIM),
        "train_grad": (
            lambda: kg.train_grad(x, y, w, "logistic"),
            lambda: kg.train_grad_plain(x, y, w, "logistic"),
            lambda: x.T @ (torch.sigmoid(x @ w) - y),
            4.0 * n * dims + 4.0 * n + 4.0 * dims + 8.0 * dims,
            4.0 * n * dims),
    }
    # the batched bit-pack call of one phase-3 partition: its 8 BITPACK
    # features (1-4 bits) into float32 x (n, 12) and its 1-bit label into
    # y, against the per-column sequence it replaced (bitpack_decode's
    # int32 lanes, the int64 bias, the casts, the stack)
    pencs = [encode(rng.integers(0, span, n).astype(np.int64),
                    Encoding.BITPACK) for span in INT_SPANS + (2,)]
    pblocks = [bitpack_block(e, dev) for e in pencs]
    pbuf = torch.empty(n * (dims + 1), dtype=torch.float32, device=dev)
    px = pbuf[:n * dims].view(n, dims)
    pdests = [px[:, j] for j in range(len(INT_SPANS))] + [pbuf[n * dims:]]

    def per_column():
        cols = [(kd.bitpack_decode(b.words, b.bit_width, 0, n)
                 .to(torch.int64) + b.bias).to(b.dtype).to(torch.float32)
                for b in pblocks]
        return torch.stack(cols[:-1], dim=1), cols[-1]

    batched = (lambda: kd.bitpack_decode_into(pblocks, pdests, n))
    batch_bytes = sum(4.0 * b.words.shape[0] for b in pblocks) \
        + 4.0 * n * len(pblocks)
    # row 8b: the RLE column straight into a float32 column of x, beside
    # the decode-then-cast-copy it replaced
    rle_col = px[:, 10]
    rle_into = (lambda: kd.rle_decode_into(run_vals, run_ends, n, rle_col))

    def rle_copy():
        rle_col.copy_(kd.rle_decode(run_vals, run_ends, n))

    # row 9b: the search path's lanes read in place, beside the stack of
    # its 64 lanes, the copy of q to the card and the matrix call
    lanes = [emb[:, j].contiguous() for j in range(EMB_DIM)]
    w_host = q.cpu().numpy()
    lanes_call = (lambda: kt.topk_similarity_lanes(lanes, w_host, TOP_K))

    def stacked_call(q_of=lambda: torch.from_numpy(w_host).to(dev)):
        return kt.topk_similarity(torch.stack(lanes, dim=1), q_of(), TOP_K)

    if device.type == "cuda":
        one_kernel("dict_decode", cases["dict_decode"][0])
        one_kernel("train_grad", cases["train_grad"][0])
        one_kernel("batched bitpack_decode", batched)
        one_kernel("rle_decode", cases["rle_decode"][0])
        one_kernel("rle_decode_into", rle_into)
        one_kernel("topk_similarity (fused)", cases["topk_similarity"][0])
        one_kernel("topk_similarity_lanes", lanes_call)
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in cases.items():
        b_ms, b_by = bound(nbytes, ops)
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": timer(kern),
            "device_ms": timer.graphed(kern),
            "plain_ms": timer(plain, reps=10, warmup=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lib) if lib is not None else None,
            "library_device_ms": (timer.graphed(lib) if lib is not None
                                  else None),
        }
    b_ms, b_by = bound(batch_bytes, 3.0 * n * len(pblocks))
    out["bitpack_decode"]["batched"] = {
        "columns": len(pblocks), "rows": n, "launches": 0,
        "ms": timer(batched), "device_ms": timer.graphed(batched),
        "plain_ms": timer(lambda: kd.bitpack_decode_into_plain(
            pblocks, pdests, n), reps=10, warmup=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "per_column_ms": timer(per_column),
        "per_column_device_ms": timer.graphed(per_column)}
    b_ms, b_by = bound(12.0 * runs + 4.0 * n, n * log2_runs)
    out["rle_decode"]["into"] = {
        "dst": "float32 column of a row-major (n, 12) x", "rows": n,
        "launches": 0, "ms": timer(rle_into),
        "device_ms": timer.graphed(rle_into),
        "plain_ms": timer(lambda: kd.rle_decode_into_plain(
            run_vals, run_ends, n, rle_col), reps=10, warmup=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "decode_copy_ms": timer(rle_copy),
        "decode_copy_device_ms": timer.graphed(rle_copy)}
    b_ms, b_by = bound(4.0 * DOCS_ROWS * EMB_DIM + 16 * TOP_K,
                       2.0 * DOCS_ROWS * EMB_DIM)
    out["topk_similarity"]["kernel_route"] = kt.topk_plan(
        DOCS_ROWS, EMB_DIM, TOP_K, torch.float32).route
    out["topk_similarity"]["lanes"] = {
        "lanes": EMB_DIM, "rows": DOCS_ROWS, "launches": 0,
        "kernel_route": kt.topk_plan(DOCS_ROWS, EMB_DIM, TOP_K,
                                     torch.float32, lanes=True).route,
        "ms": timer(lanes_call), "device_ms": timer.graphed(lanes_call),
        "plain_ms": timer(lambda: kt.topk_similarity_plain(
            torch.stack(lanes, dim=1), q, TOP_K), reps=10, warmup=2),
        "bound_ms": b_ms, "bound_by": b_by,
        # q's copy to the card is a pageable host-to-device copy, which a
        # CUDA graph cannot capture: the graphed stack + call reads q from
        # the card
        "stacked_ms": timer(stacked_call),
        "stacked_device_ms": timer.graphed(lambda: stacked_call(lambda: q))}
    return out


# ---------------------------------------------------------------- phase 2


def lineitem(rows: int, seed: int) -> dict:
    """TPC-H lineitem columns from dbgen's domains (spec §4.2.3), with
    L_ORDERKEY from `orders`."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, rows).astype(np.int32)
    retail = np.round(rng.uniform(900.0, 2100.0, rows), 2)
    orderdate = rng.integers(8035, 10440, rows)       # 1992-01-01 .. 1998
    return {
        "L_QUANTITY": qty,
        "L_EXTENDEDPRICE": np.round(qty * retail, 2),
        "L_DISCOUNT": np.round(rng.integers(0, 11, rows) * 0.01, 2),
        "L_SHIPMODE": SHIP_MODES[rng.integers(0, len(SHIP_MODES), rows)],
        "L_SHIPDATE": (orderdate + rng.integers(1, 122, rows)).astype(
            np.int32),
    }


ORDER_PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM",
                             "4-NOT SPECIFIED", "5-LOW"])


def orders(li: dict, seed: int) -> dict:
    """TPC-H orders for the lineitem rows `li` (spec §4.2.3), which gains
    L_ORDERKEY: rows / 4 orders (1,500,000 at SF1) under dbgen's sparse
    keys (8 of every 32), 1 to 7 lines an order (their count adjusted by
    one here and there to add up to the lineitem rows), lines in key order
    as dbgen writes them; O_TOTALPRICE the order's sum of
    L_EXTENDEDPRICE * (1 - L_DISCOUNT) * (1 + tax), tax 0 to 0.08."""
    rows = len(li["L_QUANTITY"])
    rng = np.random.default_rng(seed + 1)
    count = max(1, rows // 4)
    i = np.arange(count, dtype=np.int64)
    keys = (i // 8) * 32 + (i % 8) + 1
    lines = rng.integers(1, 8, count)
    while lines.sum() != rows:
        diff = rows - int(lines.sum())
        cand = np.flatnonzero(lines < 7 if diff > 0 else lines > 1)
        pick = rng.choice(cand, size=min(abs(diff), len(cand)),
                          replace=False)
        lines[pick] += 1 if diff > 0 else -1
    li["L_ORDERKEY"] = np.repeat(keys, lines)
    tax = np.round(rng.integers(0, 9, rows) * 0.01, 2)
    charge = li["L_EXTENDEDPRICE"] * (1 - li["L_DISCOUNT"]) * (1 + tax)
    starts = np.concatenate([[0], np.cumsum(lines)[:-1]])
    return {
        "O_ORDERKEY": keys,
        "O_ORDERPRIORITY": ORDER_PRIORITIES[rng.integers(0, 5, count)],
        "O_TOTALPRICE": np.round(np.add.reduceat(charge, starts), 2),
        "O_ORDERDATE": rng.integers(8035, 10289, count).astype(np.int32),
    }


QUERIES = {
    "a": ("SELECT COUNT(*) AS c, SUM(L_EXTENDEDPRICE) AS s, "
          "MIN(L_EXTENDEDPRICE) AS mn, MAX(L_EXTENDEDPRICE) AS mx "
          "FROM lineitem WHERE L_EXTENDEDPRICE BETWEEN 20000 AND 40000"),
    "b": ("SELECT COUNT(*) AS c, SUM(L_EXTENDEDPRICE) AS s FROM lineitem "
          "WHERE L_DISCOUNT BETWEEN 0.05 AND 0.07"),
    "c": ("SELECT L_QUANTITY, SUM(L_EXTENDEDPRICE) AS rev FROM lineitem "
          "GROUP BY L_QUANTITY"),
    "d": ("SELECT L_SHIPMODE, COUNT(*) AS c, AVG(L_EXTENDEDPRICE) AS a "
          "FROM lineitem GROUP BY L_SHIPMODE"),
    "e": ("SELECT O_ORDERPRIORITY, COUNT(*) AS c, SUM(L_EXTENDEDPRICE) AS rev, "
          "SUM(O_TOTALPRICE) AS tp FROM lineitem JOIN orders "
          "ON L_ORDERKEY = O_ORDERKEY GROUP BY O_ORDERPRIORITY"),
}
EXPECTED_ROUTE = {"a": "colscan", "b": "fused_decode_scan",
                  "c": "groupby_mxu", "d": "groupby_mxu"}
# radix launches a run: one a map task — c's and d's 64 partial
# aggregates; query e's 64 orders and 64 lineitem partitions into the
# join's buckets, then a partial aggregate a reducer of the join (PDE
# bin-packs the join's buckets into reducers of about
# PDEConfig.target_reduce_bytes)
RADIX_A_RUN = {"c": PARTITIONS, "d": PARTITIONS, "e": 2 * PARTITIONS}


def expected(data: dict, od: dict) -> dict:
    p, q = data["L_EXTENDEDPRICE"], data["L_QUANTITY"]
    at = np.searchsorted(od["O_ORDERKEY"], data["L_ORDERKEY"])
    if not np.array_equal(od["O_ORDERKEY"][at], data["L_ORDERKEY"]):
        fail("a lineitem row has no order")
    prios, pinv = np.unique(od["O_ORDERPRIORITY"], return_inverse=True)
    line_prio = pinv[at]
    sel = (p >= 20000) & (p <= 40000)
    dsel = (data["L_DISCOUNT"] >= 0.05) & (data["L_DISCOUNT"] <= 0.07)
    modes, inv = np.unique(data["L_SHIPMODE"], return_inverse=True)
    qs = np.unique(q)
    cnt = np.bincount(inv)
    return {
        "a": {"c": np.array([sel.sum()]), "s": np.array([p[sel].sum()]),
              "mn": np.array([p[sel].min()]), "mx": np.array([p[sel].max()])},
        "b": {"c": np.array([dsel.sum()]), "s": np.array([p[dsel].sum()])},
        "c": {"L_QUANTITY": qs,
              "rev": np.bincount(q, weights=p)[qs]},
        "d": {"L_SHIPMODE": modes, "c": cnt,
              "a": np.bincount(inv, weights=p) / cnt},
        "e": {"O_ORDERPRIORITY": prios,
              "c": np.bincount(line_prio, minlength=len(prios)),
              "rev": np.bincount(line_prio, weights=p,
                                 minlength=len(prios)),
              "tp": np.bincount(line_prio, weights=od["O_TOTALPRICE"][at],
                                minlength=len(prios))},
    }


def check(name: str, got: dict, want: dict) -> None:
    key = next(iter(want))
    order = np.argsort(np.asarray(got[key]), kind="stable")
    for col, w in want.items():
        g = np.asarray(got[col])[order]
        if g.shape != w.shape:
            fail(f"query {name} column {col}: shape {g.shape} != {w.shape}")
        if w.dtype.kind == "f":
            ok = np.allclose(g, w, rtol=1e-9, atol=0)
        else:
            ok = np.array_equal(g, w)
        if not ok or (w.dtype.kind == "f" and not np.all(np.isfinite(g))):
            fail(f"query {name} column {col}: {g[:5]} != {w[:5]}")


def phase_sql(torch, device, rows: int, seed: int) -> dict:
    from repro_torch.core import DType, Schema, SharkSession
    from repro_torch.core.pde import PDEConfig
    from repro_torch.core.shuffle import RADIX_KERNEL_CALLS
    from repro_torch.kernels import colscan as kc, ops
    from repro_torch.kernels import radix_partition as kr

    t0 = time.perf_counter()
    data = lineitem(rows, seed)
    od = orders(data, seed)
    # the CPU rehearsal forces the kernel routes (their plain versions),
    # and scales the broadcast threshold with its rows so that query e
    # meets the card's decision; the card keeps the default
    rehearsal = device.type != "cuda"
    threshold = PDEConfig().broadcast_threshold_bytes * (
        rows / 6_000_000 if rehearsal else 1)
    cfg = PDEConfig(segment_force_kernels=rehearsal,
                    reduce_force_compiled=rehearsal,
                    broadcast_threshold_bytes=threshold)
    # speculation off: a straggler's backup splits its partition again, so
    # the split counts held below would follow task timing (ROADMAP C.8)
    sess = SharkSession(device=str(device), num_workers=8, max_threads=8,
                        default_shuffle_buckets=64, pde_config=cfg,
                        speculation=False)
    sess.create_table("lineitem", Schema.of(
        L_QUANTITY=DType.INT32, L_EXTENDEDPRICE=DType.FLOAT64,
        L_DISCOUNT=DType.FLOAT64, L_SHIPMODE=DType.STRING,
        L_SHIPDATE=DType.DATE, L_ORDERKEY=DType.INT64), data,
        num_partitions=PARTITIONS)
    sess.create_table("orders", Schema.of(
        O_ORDERKEY=DType.INT64, O_ORDERPRIORITY=DType.STRING,
        O_TOTALPRICE=DType.FLOAT64, O_ORDERDATE=DType.DATE), od,
        num_partitions=PARTITIONS)
    want = expected(data, od)
    print(f"phase 2: lineitem {rows} rows and orders "
          f"{len(od['O_ORDERKEY'])} rows in {PARTITIONS} partitions each "
          f"loaded in {time.perf_counter() - t0:.3f} s", flush=True)

    def run(name: str) -> float:
        t = time.perf_counter()
        got = sess.sql_np(QUERIES[name])
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(name, got, want[name])
        return ms

    try:
        # first run: columns move to the card once and stay there
        first = {name: run(name) for name in QUERIES}
        joins = sess.metrics().join_decisions       # query e's, run last
        boundary = sess.metrics().join_boundaries[-1]
        per_run = dict(RADIX_A_RUN, e=RADIX_A_RUN["e"] + boundary.num_reducers)
        # the main path's counted run
        ops.reset_launch_counts()
        scan_routes0 = dict(kc.ROUTES)
        radix_routes0 = dict(kr.ROUTES)
        timed = {name: [] for name in QUERIES}
        # radix launches and map-task splits of each query's runs
        radix = {name: [] for name in QUERIES}
        splits = {name: [] for name in QUERIES}
        routes = {}
        for _ in range(REPS):
            for name in QUERIES:
                before = (kr.LAUNCHES["radix_partition"],
                          RADIX_KERNEL_CALLS["count"])
                timed[name].append(run(name))
                radix[name].append(kr.LAUNCHES["radix_partition"] - before[0])
                splits[name].append(RADIX_KERNEL_CALLS["count"] - before[1])
                routes[name] = sess.metrics().segment_routes()
        launches = ops.launch_counts()
        # colscan's launches by path (row 1b reads the two-column path's)
        launches.update({f"colscan.{k}": v - scan_routes0[k]
                         for k, v in kc.ROUTES.items()})
        radix_routes = {k: v - radix_routes0[k] for k, v in kr.ROUTES.items()}
        if device.type == "cuda":
            # where a warm query's time goes, and what it launches
            for name in ("a", "b", "e"):
                ops.reset_launch_counts()
                rec = traced(torch, device, f"phase 2: one warm query {name}",
                             lambda: run(name))
                ours = {k: v for k, v in ops.launch_counts().items() if v}
                parts = PARTITIONS * (2 if name == "e" else 1)
                print(f"phase 2: one warm query {name}: "
                      f"{rec['device_ops']} device ops "
                      f"({rec['device_ops'] / parts:.2f} a map partition of "
                      f"{parts}), port kernel launches {json.dumps(ours)}",
                      flush=True)
    finally:
        sess.shutdown()
    for name in QUERIES:
        if name in EXPECTED_ROUTE and \
                routes[name].get(EXPECTED_ROUTE[name], 0) == 0:
            fail(f"query {name} took routes {routes[name]}, not "
                 f"{EXPECTED_ROUTE[name]}")
        print(f"query {name}: first {first[name]:.3f} ms, then "
              f"{', '.join(f'{m:.3f}' for m in timed[name])} ms; routes "
              f"{json.dumps(routes[name], sort_keys=True)}; map-task "
              f"splits {splits[name]}, radix launches {radix[name]}",
              flush=True)
        if splits[name] != [per_run.get(name, 0)] * REPS:
            fail(f"query {name} split {splits[name]} map tasks in its "
                 f"runs, not {per_run.get(name, 0)} each")
    print(f"phase 2: query e's join decisions {json.dumps(joins)}; "
          f"boundary {boundary.strategy}, {boundary.left_bytes:.0f} and "
          f"{boundary.right_bytes:.0f} bytes observed, "
          f"{boundary.num_reducers} reducers", flush=True)
    if not any(j.startswith("PDE shuffle-join") for j in joins):
        fail(f"query e did not take a PDE shuffle join: {joins}")
    print(f"phase 2: main-path launches {json.dumps(launches)}; radix routes "
          f"{json.dumps(radix_routes)}", flush=True)
    if device.type == "cuda":
        # queries a and b scan each partition with one launch a run
        for name in ("colscan", "fused_decode_scan"):
            if launches[name] != PARTITIONS * REPS:
                fail(f"{name} launched {launches[name]} times in {REPS} runs "
                     f"of {PARTITIONS} partitions, not once a partition")
        # query a hands the scan one tensor as filter and aggregate
        if launches["colscan.one_column"] != launches["colscan"]:
            fail(f"query a's scans read two columns: {launches}")
        # one radix launch a map task, all on the one-launch route
        for name in QUERIES:
            if radix[name] != [per_run.get(name, 0)] * REPS:
                fail(f"query {name} made {radix[name]} radix launches in "
                     f"its runs, not {per_run.get(name, 0)} each")
        if radix_routes["one_launch"] != launches["radix_partition"] or \
                launches["radix_partition"] != REPS * sum(per_run.values()):
            fail(f"radix launches {launches['radix_partition']} took routes "
                 f"{radix_routes}")
    return launches, data, od, want


# ---------------------------------------------------------------- phase 6


CLIENT_WEIGHTS = (1, 1, 2, 4)
SERVER_BUDGET_SHARE = 0.3        # benchmarks/concurrent_bench.py:179-180
ROUNDS = ("cold", "cached", "after a catalog change")


def by_weight(handles) -> dict:
    """p50 / p95 latency (ms) and the count of a round's queries by their
    client's weight."""
    out = {}
    for w in sorted(set(CLIENT_WEIGHTS)):
        lat = [h.latency_s * 1e3 for cw, _, h in handles if cw == w]
        out[str(w)] = {"queries": len(lat),
                       "p50_ms": float(np.percentile(lat, 50)),
                       "p95_ms": float(np.percentile(lat, 95))}
    return out


def phase_server(torch, device, data: dict, od: dict, want: dict) -> dict:
    """Phase 6: phase 2's tables served by a `SharkServer` to 4 weighted
    clients under a cache budget of 0.3 x the catalog's bytes, in three
    rounds (cold, every answer from the result cache, and after `orders`
    is registered again); returns kernels 1-5's launches in the rounds."""
    from repro_torch.core import DType, Schema
    from repro_torch.core.pde import PDEConfig
    from repro_torch.kernels import colscan as kc, ops
    from repro_torch.kernels import radix_partition as kr
    from repro_torch.server import SharkServer

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated(device)
    rows = len(data["L_QUANTITY"])
    rehearsal = not cuda
    cfg = PDEConfig(segment_force_kernels=rehearsal,
                    reduce_force_compiled=rehearsal,
                    broadcast_threshold_bytes=PDEConfig()
                    .broadcast_threshold_bytes * (rows / 6_000_000
                                                  if rehearsal else 1))
    srv = SharkServer(device=str(device), num_workers=8, max_threads=8,
                      default_shuffle_buckets=64, pde_config=cfg,
                      max_concurrent_queries=len(CLIENT_WEIGHTS))
    orders_schema = Schema.of(
        O_ORDERKEY=DType.INT64, O_ORDERPRIORITY=DType.STRING,
        O_TOTALPRICE=DType.FLOAT64, O_ORDERDATE=DType.DATE)
    srv.create_table("lineitem", Schema.of(
        L_QUANTITY=DType.INT32, L_EXTENDEDPRICE=DType.FLOAT64,
        L_DISCOUNT=DType.FLOAT64, L_SHIPMODE=DType.STRING,
        L_SHIPDATE=DType.DATE, L_ORDERKEY=DType.INT64), data,
        num_partitions=PARTITIONS)
    srv.create_table("orders", orders_schema, od, num_partitions=PARTITIONS)
    # the budget is the working set's share, as concurrent_bench sets it:
    # caching must churn
    catalog_bytes = sum(t.nbytes for t in srv.catalog.tables().values())
    srv.memory.budget_bytes = int(catalog_bytes * SERVER_BUDGET_SHARE)
    clients = [(w, srv.session(f"analyst{i}-w{w}", weight=w))
               for i, w in enumerate(CLIENT_WEIGHTS)]
    print(f"phase 6: SharkServer on {device}, lineitem {rows} and orders "
          f"{len(od['O_ORDERKEY'])} rows loaded in "
          f"{time.perf_counter() - t_phase:.3f} s: {catalog_bytes} catalog "
          f"bytes, cache budget {srv.memory.budget_bytes} bytes; "
          f"{len(clients)} clients of weights {list(CLIENT_WEIGHTS)}",
          flush=True)
    bm = srv.ctx.block_manager
    # every query's shuffle blocks must be gone once the server releases
    # them (`BlockManager.drop_shuffle`), concurrent queries or not
    release, leaks = srv._release_shuffles, []

    def checked_release(executor):
        release(executor)
        ids = set(executor.created_shuffles)
        with bm.lock:
            leaks.extend(k for k in bm.blocks if k[0] == "shuf"
                         and k[1] in ids)

    srv._release_shuffles = checked_release
    counters = ("evictions", "recomputes", "partition_misses", "bypasses",
                "decode_cache_drops")
    ops.reset_launch_counts()
    scan0, radix0 = dict(kc.ROUTES), dict(kr.ROUTES)

    def one_round(label: str) -> list:
        mem0 = srv.stats()["memory"]
        sched0 = srv.stats()["scheduler"]["clients"]
        launches0 = ops.launch_counts()
        t0 = time.perf_counter()
        handles = [(w, name, sess.submit(QUERIES[name]))
                   for w, sess in clients for name in QUERIES]
        for _, name, h in handles:
            check(name, h.result(timeout=600).to_numpy(), want[name])
        wall = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
        with bm.lock:
            held = [k for k in bm.blocks if k[0] == "shuf"]
        if held or leaks:
            fail(f"phase 6 round {label}: shuffle blocks held after their "
                 f"query {leaks[:3]} or after the round {held[:3]}")
        mem = srv.stats()["memory"]
        sched = srv.stats()["scheduler"]["clients"]
        service = {}
        for name, c in sched.items():
            w = str(c["weight"])
            done = c["service_s"] - sched0.get(name, {}).get("service_s", 0)
            service[w] = service.get(w, 0.0) + done
        total = sum(service.values()) or 1.0
        launched = {k: v - launches0[k] for k, v in ops.launch_counts().items()
                    if k in SQL_KERNELS}
        rec = {"round": label, "queries": len(handles), "wall_s": wall,
               "qps": len(handles) / wall, "by_weight": by_weight(handles),
               "service_share_by_weight": {w: v / total
                                           for w, v in service.items()},
               "executed": sorted(n for _, n, h in handles if not h.cached),
               "memory": {k: mem[k] - mem0[k] for k in counters},
               "launches": launched}
        print(f"phase 6: round {json.dumps(rec)}", flush=True)
        return handles, rec

    try:
        cold, rec = one_round(ROUNDS[0])
        if rec["memory"]["evictions"] == 0 or rec["memory"]["recomputes"] == 0:
            fail(f"phase 6: the cold round evicted and recomputed "
                 f"{rec['memory']}: caching did not churn")
        cached, rec = one_round(ROUNDS[1])
        if not all(h.cached for _, _, h in cached) or \
                any(rec["launches"].values()):
            fail(f"phase 6: the cached round executed {rec['executed']} "
                 f"and launched {rec['launches']}")
        # the same rows again: a new epoch for orders, so e's entry is
        # stale while a-d, which read only lineitem, still hit
        srv.create_table("orders", orders_schema, od,
                         num_partitions=PARTITIONS)
        changed, rec = one_round(ROUNDS[2])
        if not all(h.cached for _, n, h in changed if n != "e") or \
                all(h.cached for _, n, h in changed if n == "e"):
            fail(f"phase 6: after orders changed the round executed "
                 f"{rec['executed']}: e must miss and a-d hit")
        launches = {k: v for k, v in ops.launch_counts().items()
                    if k in SQL_KERNELS}
        scan_routes = {k: v - scan0[k] for k, v in kc.ROUTES.items()}
        radix_routes = {k: v - radix0[k] for k, v in kr.ROUTES.items()}
        print(f"phase 6: three rounds' launches {json.dumps(launches)}; "
              f"colscan routes {json.dumps(scan_routes)}, radix routes "
              f"{json.dumps(radix_routes)}", flush=True)
        if cuda:
            idle = [k for k, v in launches.items() if v == 0]
            if idle:
                fail(f"phase 6 never launched {idle}")
            if scan_routes["one_column"] != launches["colscan"] or \
                    radix_routes["one_launch"] != launches["radix_partition"]:
                fail(f"phase 6: kernel routes {scan_routes} {radix_routes} "
                     f"for launches {launches}")
        print(f"phase 6: memory {json.dumps(srv.stats()['memory'])}",
              flush=True)
        print(f"phase 6: scheduler "
              f"{json.dumps(srv.stats()['scheduler'])}", flush=True)
        if cuda:
            # one warm query a under the budget, its result-cache entry
            # dropped so it runs: its column's device memos are up, so no
            # stream crosses PCIe again
            table = srv.catalog.get("lineitem")
            memos = [dict(p.columns["L_EXTENDEDPRICE"].enc._device)
                     for p in table.partitions]
            srv.result_cache.invalidate_table("lineitem")
            sess = clients[0][1]
            rec = traced(torch, device, "phase 6: one warm query a through "
                         "the server under the budget",
                         lambda: check("a", sess.sql_np(QUERIES["a"]),
                                       want["a"]))
            kept = all(
                len(p.columns["L_EXTENDEDPRICE"].enc._device) == len(m)
                and all(p.columns["L_EXTENDEDPRICE"].enc._device.get(k) is t
                        for k, t in m.items())
                for p, m in zip(table.partitions, memos))
            del table, memos        # they hold the column's device copies
            if rec["htod_copies"] or not kept:
                fail(f"phase 6: the warm query a copied "
                     f"{rec['htod_copies']} times to the card (memos kept: "
                     f"{kept})")
    finally:
        srv.shutdown()
    del clients, srv, cold, cached, changed
    gc.collect()
    wall = time.perf_counter() - t_phase
    if cuda:
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated(device)
        print(f"phase 6: device memory allocated {mem_after} bytes after "
              f"shutdown ({mem_before} before the phase)", flush=True)
        if mem_after != mem_before:
            fail(f"phase 6: device memory {mem_after} after shutdown, "
                 f"{mem_before} before")
    print(f"phase 6: {wall:.3f} s of wall, load included", flush=True)
    return launches


# ---------------------------------------------------------------- phase 7

# benchmarks/spill_bench.py's workload: its lineitem schema and loader
# (:41-59), its three queries a round (:62-74), its server settings (:86-95)
# and its budget, a quarter of the working set (:147)
SPILL_SCHEMA = (("L_ORDERKEY", "INT64"), ("L_SUPPKEY", "INT64"),
                ("L_QUANTITY", "INT32"), ("L_EXTENDEDPRICE", "FLOAT64"),
                ("L_RECEIPTDATE", "INT32"))
SPILL_SERVER = dict(num_workers=4, max_threads=4, max_concurrent_queries=2,
                    default_shuffle_buckets=8)
SPILL_CLIENTS = SPILL_ROUNDS = 3
# 7a: TPC-H SF1's lineitem rows in phase 2's partitions; 7b: spill_bench's
# own default size, in its own 8 partitions
STORAGE_PARTS = {"7a": PARTITIONS, "7b": 8}


def spill_loader(n: int, seed: int):
    """spill_bench's deliberately non-free loader (generate + sort): what
    drop mode pays again on every lineage fault.  `--seed` 0 draws
    spill_bench's own rows."""
    def load() -> dict:
        rng = np.random.default_rng(2 + seed)
        return {
            "L_ORDERKEY": np.sort(rng.integers(0, n // 4, n)).astype(
                np.int64),
            "L_SUPPKEY": rng.integers(0, 10_000, n).astype(np.int64),
            "L_QUANTITY": rng.integers(1, 50, n).astype(np.int32),
            "L_EXTENDEDPRICE": rng.uniform(900, 100_000, n),
            "L_RECEIPTDATE": rng.integers(8000, 10500, n).astype(np.int32),
        }
    return load


def spill_queries(r: int) -> list:
    """A round's three queries, with thresholds of their own so rounds
    execute rather than hit the result cache."""
    t = 20_000 + 7_000 * r
    return [
        f"SELECT COUNT(*) AS c, AVG(L_EXTENDEDPRICE) AS m FROM lineitem "
        f"WHERE L_EXTENDEDPRICE BETWEEN {t} AND {t + 40_000}",
        "SELECT L_RECEIPTDATE, COUNT(*) AS c FROM lineitem "
        f"WHERE L_RECEIPTDATE < {9_000 + 100 * r} GROUP BY L_RECEIPTDATE",
        f"SELECT SUM(L_QUANTITY) AS s FROM lineitem "
        f"WHERE L_ORDERKEY < {(r + 1) * 10_000}",
    ]


def canonical(res: dict) -> tuple:
    """spill_bench's comparison form: sorted rows, floats to 6 places."""
    rows = []
    names = sorted(res)
    for tup in zip(*(np.asarray(res[n]).tolist() for n in names)):
        rows.append(tuple(round(v, 6) if isinstance(v, float) else v
                          for v in tup))
    return tuple(sorted(rows))


def cold_device_memos(srv) -> int:
    """Device memos held by blocks that are not a resident catalog
    partition's: the blocks of a partition that went cold, still held by a
    cached scan batch.  A cold partition must leave nothing on the card."""
    live = {id(b) for t in srv.catalog.tables().values()
            for p in t.partitions if p.resident
            for b in p._columns.values()}
    bm = srv.ctx.block_manager
    with bm.lock:
        held = [v.block for _, batch in bm.blocks.values()
                for v in getattr(batch, "cols", {}).values()
                if getattr(v, "block", None) is not None]
    return sum(len(b.enc._device) for b in held if id(b) not in live)


def storage_server(device, rows: int, parts: int, seed: int, cfg,
                   budget=None, mode=None):
    from repro_torch.core import DType, Schema
    from repro_torch.core.catalog import ExternalSource
    from repro_torch.server import SharkServer
    srv = SharkServer(device=str(device), cache_budget_bytes=budget,
                      default_partitions=parts, spill_mode=mode,
                      pde_config=cfg, **SPILL_SERVER)
    schema = Schema.of(**{c: getattr(DType, t) for c, t in SPILL_SCHEMA})
    srv.register_external(ExternalSource("lineitem", schema,
                                         spill_loader(rows, seed), parts))
    return srv


def storage_reference(torch, device, rows: int, parts: int, seed: int,
                      cfg, mem_before):
    """spill_bench's unlimited-budget reference: every query's answer and
    the working set (the catalog's bytes)."""
    srv = storage_server(device, rows, parts, seed, cfg)
    try:
        sess = srv.session("reference")
        answers = {q: canonical(sess.sql_np(q))
                   for r in range(SPILL_ROUNDS) for q in spill_queries(r)}
        working_set = sum(t.nbytes for t in srv.catalog.tables().values())
    finally:
        srv.shutdown()
    del srv, sess
    device_back(torch, device, "phase 7: the reference server", mem_before)
    return answers, working_set


def device_back(torch, device, label: str, mem_before) -> None:
    """Fail unless the card's allocated memory is back at `mem_before`
    (None on the CPU rehearsal)."""
    gc.collect()
    if mem_before is None:
        return
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated(device)
    if mem != mem_before:
        fail(f"{label}: device memory {mem} after shutdown, {mem_before} "
             f"before the phase")


def storage_run(torch, device, part: str, mode: str, rows: int, seed: int,
                cfg, budget: int, answers: dict, mem_before) -> dict:
    """One server of phase 7: 3 clients x 3 rounds of spill_bench's
    queries under `budget`, in `mode`; every check of the phase on it, and
    for 7a a trace of one warm query 1."""
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    label = f"phase 7{part[1]} ({mode})"
    t0 = time.perf_counter()
    srv = storage_server(device, rows, STORAGE_PARTS[part], seed, cfg,
                         budget, mode)
    storage = srv.storage
    bm = srv.ctx.block_manager
    release, leaks = srv._release_shuffles, []

    def checked_release(executor):
        release(executor)
        ids = set(executor.created_shuffles)
        with bm.lock:
            leaks.extend(k for k in bm.blocks if k[0] == "shuf"
                         and k[1] in ids)

    srv._release_shuffles = checked_release
    clients = [srv.session(f"spill-{part}-{i}")
               for i in range(SPILL_CLIENTS)]
    lat = [[] for _ in range(3)]        # ms, by query of the round
    routes, wrong, errors = {}, [], []
    rounds = []
    try:
        for r in range(SPILL_ROUNDS):
            st0 = storage.stats()
            t_round = time.perf_counter()

            def client(sess):
                try:
                    for i, q in enumerate(spill_queries(r)):
                        h = sess.submit(q)
                        res = h.result(timeout=900)
                        lat[i].append(h.latency_s * 1e3)
                        if canonical(res.to_numpy()) != answers[q]:
                            wrong.append(q)
                        for k, v in res.metrics.segment_routes().items():
                            routes[k] = routes.get(k, 0) + v
                except Exception as e:       # failed below, by the caller
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(sess,))
                       for sess in clients]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t_round
            if cuda:
                torch.cuda.synchronize()
            with bm.lock:
                held = [k for k in bm.blocks if k[0] == "shuf"]
            if held or leaks or wrong or errors:
                fail(f"{label} round {r + 1}: {errors[:3]} raised, "
                     f"{len(wrong)} wrong answers, shuffle blocks held "
                     f"after their query {leaks[:3]} or after the round "
                     f"{held[:3]}")
            cold = cold_device_memos(srv)
            st = storage.stats()
            delta = {k: st[k] - st0[k] for k in st if k != "mode"}
            rec = {"round": r + 1, "wall_s": wall,
                   "device_bytes": srv.memory.device_bytes(),
                   "cold_device_memos": cold, "storage": delta}
            print(f"{label}: {json.dumps(rec)}", flush=True)
            if cold:
                fail(f"{label} round {r + 1}: {cold} device memos of cold "
                     f"partitions' blocks")
            rounds.append(rec)
            if part == "7a" and r == 1:
                # a segment vanishes between rounds 2 and 3, as
                # tests/test_join_chaos.py deletes one
                storage.flush()
                segs = sorted(glob.glob(os.path.join(storage.dir,
                                                     "spill-*.shk")))
                if not segs:
                    fail(f"{label}: no partition segment on disk to delete")
                os.remove(segs[0])
                print(f"{label}: deleted {os.path.basename(segs[0])} of "
                      f"{len(segs)} partition segments", flush=True)
        wall = time.perf_counter() - t0
        mem = srv.stats()["memory"]
        out = {"part": part, "mode": mode, "rows": rows,
               "partitions": STORAGE_PARTS[part], "budget_bytes": budget,
               "wall_s": wall, "queries": SPILL_CLIENTS * SPILL_ROUNDS * 3,
               "p50_ms": [float(np.percentile(v, 50)) for v in lat],
               "p95_ms": [float(np.percentile(v, 95)) for v in lat],
               "memory": mem, "storage": storage.stats(),
               "segment_routes": routes}
        print(f"{label}: {json.dumps(out)}", flush=True)
        if part == "7a" and cuda:
            # one warm query 1 under the budget (its result-cache entry
            # dropped so it runs): a faulted partition copies the column
            # it reads to the card once, a resident one copies nothing
            q = spill_queries(0)[0]
            srv.result_cache.invalidate_table("lineitem")
            before = storage.stats()
            table = srv.catalog.get("lineitem")
            cold_before = sum(not p.resident for p in table.partitions)
            # resident partitions whose column is on the card already (a
            # fault-in by query 2 or 3 copied other columns only)
            on_card = sum(bool(p._columns["L_EXTENDEDPRICE"].enc._device)
                          for p in table.partitions if p.resident)
            del table
            launched0 = ops.launch_counts()
            sess = clients[0]

            def query_1():
                if canonical(sess.sql_np(q)) != answers[q]:
                    wrong.append(q)

            rec = traced(torch, device, f"{label}: one warm query 1 under "
                         "the budget", query_1)
            after = storage.stats()
            faults = sum(after[k] - before[k] for k in (
                "spill_reads", "lineage_faults")) - (
                after["shuffle_faults"] - before["shuffle_faults"])
            ours = {k: v - launched0[k]
                    for k, v in ops.launch_counts().items()
                    if v != launched0[k]}
            print(f"{label}: the traced query 1: {rec['htod_copies']} HtoD "
                  f"copies of {rec['htod_bytes']} bytes, {faults} partition "
                  f"fault-ins; before it {cold_before} of "
                  f"{STORAGE_PARTS[part]} partitions cold, {on_card} "
                  f"resident with L_EXTENDEDPRICE on the card (one copy "
                  f"of it expected a fault-in or a resident partition "
                  f"without it, none a partition with it); port kernel "
                  f"launches {json.dumps(ours)}", flush=True)
            if wrong:
                fail(f"{label}: the traced query 1 answered wrong")
        spill_dir = storage.dir
    finally:
        srv.shutdown()
    del clients, srv, storage
    device_back(torch, device, label, mem_before)
    if os.path.isdir(spill_dir):
        fail(f"{label}: the server's own spill directory {spill_dir} "
             f"outlived shutdown()")
    return dict(out, rounds=rounds)


def phase_storage(torch, device, rows: int, seed: int) -> dict:
    """Phase 7: the storage tier under a `SharkServer` on the card, on
    benchmarks/spill_bench.py's workload: 7a spills `rows` rows in 64
    partitions, a segment deleted between rounds 2 and 3; 7b runs spill
    and then drop mode over rows / 10 in 8 partitions.  Returns kernels
    1-5's launches in the phase."""
    from repro_torch.core.pde import PDEConfig
    from repro_torch.kernels import colscan as kc, ops
    from repro_torch.kernels import radix_partition as kr

    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    mem_before = None
    if cuda:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated(device)
    rehearsal = not cuda
    cfg = PDEConfig(segment_force_kernels=rehearsal,
                    reduce_force_compiled=rehearsal)
    ops.reset_launch_counts()
    scan0, radix0 = dict(kc.ROUTES), dict(kr.ROUTES)
    results = {}
    for part, n in (("7a", rows), ("7b", rows // 10)):
        t0 = time.perf_counter()
        answers, working_set = storage_reference(
            torch, device, n, STORAGE_PARTS[part], seed, cfg, mem_before)
        budget = working_set // 4
        print(f"phase {part}: lineitem {n} rows in {STORAGE_PARTS[part]} "
              f"partitions, working set {working_set} bytes, budget "
              f"{budget}; the unlimited-budget reference answered "
              f"{len(answers)} queries in {time.perf_counter() - t0:.3f} s",
              flush=True)
        for mode in (("spill",) if part == "7a" else ("spill", "drop")):
            results[part, mode] = storage_run(
                torch, device, part, mode, n, seed, cfg, budget, answers,
                mem_before)
    a, bs, bd = results["7a", "spill"], results["7b", "spill"], \
        results["7b", "drop"]
    if a["storage"]["spills"] == 0 or a["storage"]["spill_reads"] == 0:
        fail(f"phase 7a spilled {a['storage']['spills']} partitions and "
             f"read {a['storage']['spill_reads']} segments back")
    # the round after the deleted segment recovered it
    lost = a["rounds"][2]["storage"]
    if lost["spill_lost"] + lost["lineage_faults"] == 0:
        fail(f"phase 7a: the round after the deletion {lost}")
    if bd["storage"]["lineage_faults"] == 0 or bd["storage"]["spills"] or \
            bd["storage"]["spill_write_bytes"]:
        fail(f"phase 7b drop mode: {bd['storage']}")
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in SQL_KERNELS}
    scan_routes = {k: v - scan0[k] for k, v in kc.ROUTES.items()}
    radix_routes = {k: v - radix0[k] for k, v in kr.ROUTES.items()}
    print(f"phase 7: launches {json.dumps(launches)}; colscan routes "
          f"{json.dumps(scan_routes)}, radix routes "
          f"{json.dumps(radix_routes)}; 7b drop / spill wall "
          f"{bd['wall_s'] / bs['wall_s']:.4f}", flush=True)
    if cuda:
        if launches["colscan"] == 0 or scan_routes["one_column"] == 0:
            fail(f"phase 7 never scanned on colscan's one-column path: "
                 f"{launches} {scan_routes}")
        if sum(scan_routes.values()) != launches["colscan"] or \
                radix_routes["one_launch"] != launches["radix_partition"]:
            fail(f"phase 7: kernel routes {scan_routes} {radix_routes} "
                 f"for launches {launches}")
    wall = time.perf_counter() - t_phase
    if cuda:
        print(f"phase 7: device memory allocated "
              f"{torch.cuda.memory_allocated(device)} bytes after every "
              f"server's shutdown ({mem_before} before the phase)",
              flush=True)
    print(f"phase 7: {wall:.3f} s of wall, loads included", flush=True)
    return launches


# ---------------------------------------------------------------- phase 8

# benchmarks/scale_bench.py's workload: its uservisits schema (:49-58), its
# query mix (:61-72) and its fixed per-replica settings (:42-45), with the
# card as every replica's device
CLUSTER_TABLE = "uservisits"
CLUSTER_QUERIES = 48
CLUSTER_PARTS = 8
REPLICA_KW = dict(num_workers=2, max_threads=2, max_concurrent_queries=2,
                  max_queue_depth=512, enable_result_cache=False,
                  default_partitions=CLUSTER_PARTS, default_shuffle_buckets=8,
                  task_launch_overhead_s=5e-3)
# 8c and 8d run the mix's first 12 queries; the exchange ships int64 keys
# and float64 values
CLUSTER_SHORT = 12
SHIPPED_ROW_BYTES = 16


def uservisits(rows: int, seed: int) -> dict:
    """scale_bench's table; `--seed` 0 draws its own rows."""
    rng = np.random.default_rng(42 + seed)
    return {"k": rng.integers(0, 64, rows).astype(np.int64),
            "x": rng.uniform(-100.0, 100.0, rows),
            "v": rng.uniform(0.0, 10.0, rows)}


def cluster_queries(n: int) -> list:
    """scale_bench's `query_mix(n)`: a GROUP BY k every fourth query, range
    scans with a window sliding over 20 literals otherwise; (sql, window)
    pairs, window None for the group-by."""
    out = []
    for i in range(n):
        lo = -90 + 7 * (i % 20)
        if i % 4 == 3:
            out.append((f"SELECT k, SUM(v) AS s FROM {CLUSTER_TABLE} "
                        "GROUP BY k", None))
        else:
            out.append((f"SELECT COUNT(*) AS c, SUM(v) AS s, AVG(v) AS a "
                        f"FROM {CLUSTER_TABLE} WHERE x BETWEEN {lo} AND "
                        f"{lo + 55}", (lo, lo + 55)))
    return out


def cluster_expected(data: dict, queries: list) -> dict:
    """Each query's answer from numpy over the generated arrays."""
    k, x, v = data["k"], data["x"], data["v"]
    out = {}
    for q, window in queries:
        if q in out:
            continue
        if window is None:
            out[q] = {"k": np.arange(64, dtype=np.int64),
                      "s": np.bincount(k, weights=v, minlength=64)}
        else:
            m = (x >= window[0]) & (x <= window[1])
            c = int(m.sum())
            s_ = float(v[m].sum())
            out[q] = {"c": np.array([c]), "s": np.array([s_]),
                      "a": np.array([s_ / c])}
    return out


def cluster_ok(got: dict, want: dict) -> bool:
    """Integers exactly, floats to rtol 1e-9, rows in key order."""
    if sorted(got) != sorted(want):
        return False
    if "k" in want:
        order = np.argsort(got["k"], kind="stable")
        got = {c: np.asarray(a)[order] for c, a in got.items()}
    for c, w in want.items():
        g = np.asarray(got[c])
        if g.shape != w.shape:
            return False
        if w.dtype.kind in "iu":
            if g.dtype.kind not in "iu" or not np.array_equal(g, w):
                return False
        elif not np.allclose(g, w, rtol=1e-9, atol=0):
            return False
    return True


def drained(servers, label: str, timeout: float = 60.0) -> None:
    """Fail unless every server's store holds no shuffle block within
    `timeout` (a dead replica's threads drain in the background)."""
    deadline = time.monotonic() + timeout
    while True:
        held = []
        for srv in servers:
            bm = srv.ctx.block_manager
            with bm.lock:
                held.extend(k for k in bm.blocks if k[0] == "shuf")
        if not held:
            return
        if time.monotonic() > deadline:
            fail(f"{label}: shuffle blocks held after the storm {held[:3]}")
        time.sleep(0.02)


def cluster_fleet(device, data: dict, replicas: int, mesh_factory=None):
    """scale_bench's `make_fleet` on `device`, and the list every replica
    adds to the shuffle blocks of a query it finished still holds."""
    from repro_torch.cluster import SharkFleet
    from repro_torch.core import DType, Schema
    fleet = SharkFleet(num_replicas=replicas, routing="least_loaded",
                       mesh_factory=mesh_factory, device=str(device),
                       **REPLICA_KW)
    fleet.create_table(CLUSTER_TABLE, Schema.of(
        k=DType.INT64, x=DType.FLOAT64, v=DType.FLOAT64), data,
        num_partitions=CLUSTER_PARTS)
    leaks = []
    for r in fleet.replicas:
        srv = r.server

        def checked_release(executor, srv=srv, release=srv._release_shuffles):
            release(executor)
            ids = set(executor.created_shuffles)
            bm = srv.ctx.block_manager
            with bm.lock:
                leaks.extend(k for k in bm.blocks if k[0] == "shuf"
                             and k[1] in ids)

        srv._release_shuffles = checked_release
    return fleet, leaks


def cluster_storm(fleet, queries: list, want: dict, label: str,
                  kill_after: int = -1) -> dict:
    """scale_bench's `run_storm`: 2 warm-up queries, then every query
    submitted at once (`kill_after`: the first alive replica is killed
    after that query is submitted); each answer checked."""
    for q, _ in queries[:2]:
        fleet.sql(q)
    t0 = time.perf_counter()
    handles = []
    for i, (q, _) in enumerate(queries):
        handles.append((q, time.monotonic(), fleet.submit(q)))
        if i == kill_after:
            fleet.kill_replica(fleet.alive_replicas()[0].index)
    wrong, lat = 0, []
    for q, t_sub, h in handles:
        res = h.result(timeout=600)
        wrong += not cluster_ok(res.to_numpy(), want[q])
        lat.append((h._inner.finished - t_sub) * 1e3)
    wall = time.perf_counter() - t0
    rec = {"storm": label, "replicas": len(fleet.replicas),
           "queries": len(queries), "wall_s": wall,
           "qps": len(queries) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p95_ms": float(np.percentile(lat, 95)), "wrong": wrong,
           "reroutes": fleet.reroutes, "served": fleet.stats()["served"]}
    print(f"phase {label}: {json.dumps(rec)}", flush=True)
    if wrong:
        fail(f"phase {label}: {wrong} wrong answers")
    return rec


@contextlib.contextmanager
def dispatch_launches():
    """Record each mesh dispatch's kernel launches: `mesh_colscan` and
    `mesh_group_exchange` wrapped for the block, one record a call (its
    partitions, slots, attempts and the launch-count deltas across it; the
    exchange's deltas include its slots' reduce), and the host-to-device
    copies its staging made (`shard_exec._on` wrapped: copies and bytes,
    counted on the host, whatever a profiler records).  Launches outside
    the dispatches (the partial states' shuffle) are not in them."""
    from repro_torch.cluster import shard_exec
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_partition as kr
    calls = []
    names = ("mesh_colscan", "mesh_group_exchange", "_on")
    orig = {n: getattr(shard_exec, n) for n in names}
    staged = [0, 0]         # copies, bytes

    def on(arr, device):
        t = orig["_on"](arr, device)
        if device.type == "cuda":
            staged[0] += 1
            staged[1] += t.nbytes
        return t

    def wrap(name, fn):
        def call(ctx, first, *rest, **kw):
            l0, r0 = ops.launch_counts(), kr.ROUTES["one_launch"]
            s0, st0 = ctx.stats(), list(staged)
            out = fn(ctx, first, *rest, **kw)
            l1, s1 = ops.launch_counts(), ctx.stats()
            calls.append({
                "dispatch": name, "partitions": len(first),
                "slots": out[1]["devices"],
                "attempts": s1["dispatches"] - s0["dispatches"],
                "retries": s1["retries"] - s0["retries"],
                "colscan": l1["colscan"] - l0["colscan"],
                "radix_split": l1["radix_partition"]
                - l0["radix_partition"],
                "one_launch": kr.ROUTES["one_launch"] - r0,
                "groupby_sum": l1["groupby_sum"] - l0["groupby_sum"],
                "staged": [staged[0] - st0[0], staged[1] - st0[1]]})
            return out
        return call

    for n, fn in orig.items():
        setattr(shard_exec, n, on if n == "_on" else wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in orig.items():
            setattr(shard_exec, n, fn)


def dispatch_rule(calls: list, label: str, cuda: bool) -> None:
    """On the card, one `colscan` launch a placed partition per colscan
    dispatch; per exchange, one `radix_split` launch a slot on route
    one_launch and one `groupby_sum` a slot, its received rows reduced
    where they lie (the CPU rehearsal runs the plain versions: no
    launch)."""
    if not calls:
        fail(f"{label}: no mesh dispatch")
    for c in calls if cuda else ():
        if c["dispatch"] == "mesh_colscan":
            ok = (c["colscan"] == c["partitions"]
                  and c["radix_split"] == c["groupby_sum"] == 0)
        else:
            ok = (c["radix_split"] == c["one_launch"] == c["groupby_sum"]
                  == c["slots"] and c["colscan"] == 0)
        if not ok:
            fail(f"{label}: a mesh dispatch launched {c}")


def mesh_run(torch, device, data: dict, queries: list, want: dict, mesh,
             label: str, mem_before, trace: bool = False) -> dict:
    """8c on one mesh: a mesh session runs `queries`, each answer checked,
    every dispatch's launches held to the rule; on 4 slots the one-shot
    device killer of tests/test_cluster.py on the group-by, and traces of
    two warm group-bys.  With `mesh` None the single-host session runs the
    same queries, for comparison."""
    from repro_torch.cluster import DeviceLost
    from repro_torch.core import DType, Schema, SharkSession
    cuda = device.type == "cuda"
    sess = SharkSession(num_workers=2, default_partitions=CLUSTER_PARTS,
                        mesh=mesh, device=str(device))
    sess.create_table(CLUSTER_TABLE, Schema.of(
        k=DType.INT64, x=DType.FLOAT64, v=DType.FLOAT64), data,
        num_partitions=CLUSTER_PARTS)
    bm = sess.ctx.block_manager
    wrong = parts = shipped = 0
    try:
        with dispatch_launches() as calls:
            # warm-up: a range scan and a group-by (the columns' first
            # copies, the allocator's first blocks of each size)
            for q, _ in (queries[0], queries[3]):
                sess.sql_np(q)
                sess.release_shuffles()
            del calls[:]
            t0 = time.perf_counter()
            by_kind = {"scan": [], "group_by": []}     # ms a query
            for q, window in queries:
                t_q = time.perf_counter()
                wrong += not cluster_ok(sess.sql_np(q), want[q])
                by_kind["scan" if window else "group_by"].append(
                    (time.perf_counter() - t_q) * 1e3)
                m = sess.metrics()
                parts += m.mesh_partitions
                shipped += m.mesh_shipped_rows
                sess.release_shuffles()
                with bm.lock:
                    held = [k for k in bm.blocks if k[0] == "shuf"]
                if held:
                    fail(f"{label}: shuffle blocks held after a query "
                         f"{held[:3]}")
            wall = time.perf_counter() - t0
        if mesh is not None:
            dispatch_rule(calls, label, cuda)
        per = {}
        for c in calls:
            r = per.setdefault(c["dispatch"], {"dispatches": 0, "colscan": 0,
                                               "radix_split": 0,
                                               "groupby_sum": 0,
                                               "staged_bytes": 0})
            r["dispatches"] += 1
            for k in ("colscan", "radix_split", "groupby_sum"):
                r[k] += c[k]
            r["staged_bytes"] += c["staged"][1]
        slots = mesh.devices if mesh is not None else []
        rec = {"mesh": label, "slots": [str(d) for d in slots],
               "queries": len(queries), "wall_s": wall,
               "median_ms": {k: float(np.median(v))
                             for k, v in by_kind.items()},
               "mesh_partitions": parts, "shipped_rows": shipped,
               "shipped_bytes": shipped * SHIPPED_ROW_BYTES,
               "wrong": wrong,
               "stats": mesh.stats() if mesh is not None else None,
               "launches": per}
        print(f"phase {label}: {json.dumps(rec)}", flush=True)
        want_parts = len(queries) * CLUSTER_PARTS if mesh is not None else 0
        if wrong or parts != want_parts:
            fail(f"{label}: {wrong} wrong answers, {parts} mesh partitions")
        if len(slots) > 1 and shipped == 0:
            fail(f"{label}: the exchange shipped no row across slots")
        if len(slots) == 4:
            q = queries[3][0]                   # the group-by
            fired = []

            def killer(ctx, ordinal):
                if not fired:
                    fired.append(ordinal)
                    victim = ctx.alive_slots()[-1]
                    ctx.kill_device(victim)
                    raise DeviceLost(victim)

            mesh.on_dispatch = killer
            with dispatch_launches() as kcalls:
                got = sess.sql_np(q)
            mesh.on_dispatch = None
            sess.release_shuffles()
            m = sess.metrics()
            dispatch_rule(kcalls, label, cuda)
            kill = {"retries": mesh.retries, "mesh_retries": m.mesh_retries,
                    "mesh_devices": m.mesh_devices,
                    "right": cluster_ok(got, want[q]), "launches": kcalls}
            print(f"phase {label}: a slot killed mid group-by "
                  f"{json.dumps(kill)}", flush=True)
            if not (mesh.retries >= 1 and m.mesh_retries >= 1
                    and m.mesh_devices == 3 and kill["right"]):
                fail(f"{label}: the device-loss recompute {kill}")
            mesh.revive_all()
            rec["kill"] = kill
        if trace and cuda:
            # two traced windows of the same warm group-by: the profiler
            # has dropped device records at times, so each window's copy
            # records are held against the copy calls the host made in it
            q = queries[3][0]
            rec["traces"] = []
            for i in range(2):
                with dispatch_launches() as tcalls:
                    t = traced(torch, device, f"phase {label}: warm "
                               f"group-by {i + 1} of 2 on the mesh",
                               lambda: sess.sql_np(q))
                sess.release_shuffles()
                dispatch_rule(tcalls, label, cuda)
                in_trace = {k: sum(c for name, c, _ in t["device_ops_ms"]
                                   if k in name)
                            for k in ("one_launch_kernel", "group_reduce")}
                records = sum(c for c, _ in t["copies"].values())
                print(f"phase {label}: traced group-by {i + 1}: busy "
                      f"{t['device_busy_ms']:.4f} ms of "
                      f"{t['wall_ms']:.3f}, idle "
                      f"{t['device_idle_share']:.4f}, copies "
                      f"{json.dumps(t['copies'])}: {records} records of "
                      f"{t['host_copy_calls']} copy calls the host made; "
                      f"staged by the dispatch (counted on the host) "
                      f"{tcalls[0]['staged'][0]} HtoD copies of "
                      f"{tcalls[0]['staged'][1]} bytes; "
                      f"launches in the dispatch: radix_split "
                      f"{tcalls[0]['radix_split']}, groupby_sum "
                      f"{tcalls[0]['groupby_sum']}; kernels in the trace "
                      f"{json.dumps(in_trace)} (the partial states' "
                      f"shuffle and merge included)", flush=True)
                rec["traces"].append(t)
    finally:
        sess.shutdown()
    del sess, bm
    device_back(torch, device, f"phase {label}", mem_before)
    return rec


def phase_cluster(torch, device, rows: int, seed: int) -> dict:
    """Phase 8: the cluster tier on benchmarks/scale_bench.py's workload.
    8a a fleet of 1, 2 and 4 replicas, 8b a replica killed mid-storm, 8c a
    mesh session on one slot and on 4 slots sharing the card (and a slot
    killed mid group-by) beside the single-host session on the same table,
    8d 2 replicas each over a 2-slot mesh.  Returns kernels 1, 3 and 4's
    launches in the phase."""
    from repro_torch.cluster import MeshContext
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    mem_before = None
    if cuda:
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated(device)
    data = uservisits(rows, seed)
    queries = cluster_queries(CLUSTER_QUERIES)
    want = cluster_expected(data, queries)
    print(f"phase 8: {CLUSTER_TABLE} {rows} rows in {CLUSTER_PARTS} "
          f"partitions ({sum(a.nbytes for a in data.values())} bytes), "
          f"{len(queries)} queries ({sum(w is None for _, w in queries)} "
          f"GROUP BY k); replica settings {json.dumps(REPLICA_KW)} "
          f"(task_launch_overhead_s is scale_bench's emulated per-task "
          f"launch overhead)", flush=True)
    ops.reset_launch_counts()

    def shut(fleet, leaks, label):
        drained([r.server for r in fleet.replicas], f"phase {label}")
        if leaks:
            fail(f"phase {label}: shuffle blocks held after their query "
                 f"{leaks[:3]}")
        fleet.shutdown()
        device_back(torch, device, f"phase {label}", mem_before)

    sweep = {}
    for n in (1, 2, 4):
        t0 = time.perf_counter()
        fleet, leaks = cluster_fleet(device, data, n)
        load = time.perf_counter() - t0
        try:
            sweep[n] = cluster_storm(fleet, queries, want, f"8a ({n})")
            sweep[n]["load_s"] = load
        finally:
            shut(fleet, leaks, f"8a ({n})")
    scaling = sweep[4]["qps"] / sweep[1]["qps"]
    print(f"phase 8a: QPS 1 / 2 / 4 replicas {sweep[1]['qps']:.4f} / "
          f"{sweep[2]['qps']:.4f} / {sweep[4]['qps']:.4f}, scaling 1 to 4 "
          f"{scaling:.4f}", flush=True)

    fleet, leaks = cluster_fleet(device, data, 2)
    try:
        chaos = cluster_storm(fleet, queries, want, "8b (chaos)",
                              kill_after=len(queries) // 4)
    finally:
        shut(fleet, leaks, "8b")
    if chaos["reroutes"] == 0:
        fail("phase 8b: the kill rerouted no query")

    short = queries[:CLUSTER_SHORT]
    card = torch.device("cuda", 0) if cuda else torch.device("cpu")
    one = MeshContext() if cuda else MeshContext(devices=[card])
    meshes = {"8c (1 slot)": mesh_run(torch, device, data, short, want, one,
                                      "8c (1 slot)", mem_before),
              "8c (4 slots)": mesh_run(
                  torch, device, data, short, want,
                  MeshContext(devices=[card] * 4), "8c (4 slots)",
                  mem_before, trace=True)}
    host = mesh_run(torch, device, data, short, want, None,
                    "8c (single host)", mem_before)
    w1, w4 = (meshes[k]["wall_s"] for k in meshes)
    print(f"phase 8c: {len(short)} queries on the mesh: 1 slot {w1:.4f} s, "
          f"4 slots sharing {card} {w4:.4f} s ({w4 / w1:.4f}x); the "
          f"single-host session {host['wall_s']:.4f} s; median ms "
          f"(scan, group-by): 1 slot "
          f"{json.dumps(meshes['8c (1 slot)']['median_ms'])}, 4 slots "
          f"{json.dumps(meshes['8c (4 slots)']['median_ms'])}, single "
          f"host {json.dumps(host['median_ms'])}; "
          f"torch.cuda.device_count() "
          f"{torch.cuda.device_count() if cuda else 0}", flush=True)

    composed_meshes = {}

    def factory(i):
        composed_meshes[i] = MeshContext(devices=[card] * 2)
        return composed_meshes[i]

    fleet, leaks = cluster_fleet(device, data, 2, mesh_factory=factory)
    try:
        composed = cluster_storm(fleet, short, want, "8d (composed)")
    finally:
        shut(fleet, leaks, "8d")
    composed["dispatch"] = {i: m.stats() for i, m in composed_meshes.items()}
    dispatches = sum(s["dispatches"] for s in composed["dispatch"].values())
    print(f"phase 8d: mesh dispatches in the replicas "
          f"{json.dumps(composed['dispatch'])}", flush=True)
    if dispatches == 0:
        fail("phase 8d: no replica dispatched through its mesh")

    launches = {k: v for k, v in ops.launch_counts().items()
                if k in ("colscan", "groupby_sum", "radix_partition")}
    wall = time.perf_counter() - t_phase
    print(f"phase 8: launches {json.dumps(launches)}; {wall:.3f} s of wall, "
          f"loads included", flush=True)
    if cuda and 0 in launches.values():
        fail(f"phase 8 never launched {launches}")
    return launches


# ---------------------------------------------------------------- phase 3

# spans of the 8 small-range int features: BITPACK blocks of 1 to 4 bits
INT_SPANS = (2, 3, 4, 6, 8, 11, 14, 16)
FEATURES = ([f"b{i}" for i in range(len(INT_SPANS))]
            + ["d0", "d1", "r0", "p0"])
LR_ITERS, KM_ITERS, KM_K = 10, 10, 10


def points(rows: int, seed: int) -> dict:
    """12 features and a label: 8 small-range ints (BITPACK), 2 floats on a
    cent grid with 4000 distinct values (DICT), 1 clustered float with runs
    of 8 (RLE), 1 continuous float (PLAIN); the int64 label is a noisy
    linear function of them (BITPACK, 1 bit)."""
    rng = np.random.default_rng(seed + 3)
    data = {f"b{i}": rng.integers(0, s, rows).astype(np.int64)
            for i, s in enumerate(INT_SPANS)}
    for c in ("d0", "d1"):
        data[c] = np.round(rng.integers(0, 4000, rows) * 0.01, 2)
    data["r0"] = np.repeat(np.round(rng.normal(size=rows // 8 + 1), 3),
                           8)[:rows]
    data["p0"] = rng.normal(size=rows)
    x = np.stack([data[c] for c in FEATURES], axis=1)
    x = (x - x.mean(0)) / x.std(0)
    z = x @ rng.normal(size=x.shape[1]) + rng.normal(scale=0.5, size=rows)
    data["label"] = (z > 0).astype(np.int64)
    return data


def replay_logreg(x32: np.ndarray, y: np.ndarray, edges, w: np.ndarray,
                  lr: float, iters: int) -> np.ndarray:
    """The estimator's updates in numpy: per partition the float64 gradient
    of the float32 features (the train_grad route), cast to float32; the
    float32 partials summed; w float32."""
    for _ in range(iters):
        gs = []
        for a, b in zip(edges[:-1], edges[1:]):
            xp = x32[a:b].astype(np.float64)
            z = xp @ w.astype(np.float64)
            e = np.exp(-np.abs(z))
            p = np.where(z >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
            gs.append((xp.T @ (p - y[a:b])).astype(np.float32))
        g = np.sum(gs, axis=0)
        w = w - lr * (g / len(y)).astype(w.dtype)
    return w


def replay_kmeans(x32: np.ndarray, edges, c: np.ndarray, iters: int):
    """The estimator's k-means steps in numpy, float32 as the port's."""
    objs = []
    for _ in range(iters):
        sums, counts, obj = [], [], 0.0
        for a, b in zip(edges[:-1], edges[1:]):
            x = x32[a:b]
            d2 = ((x * x).sum(1, keepdims=True) - 2.0 * (x @ c.T)
                  + (c * c).sum(1)[None, :])
            assign = np.argmin(d2, axis=1)
            obj += float(np.min(d2, axis=1).sum())
            onehot = np.eye(c.shape[0], dtype=np.float32)[assign]
            sums.append(onehot.T @ x)
            counts.append(onehot.sum(0))
        s, n = np.sum(sums, axis=0), np.sum(counts, axis=0)
        objs.append(obj)
        c = c.copy()
        nz = n > 0
        c[nz] = (s[nz] / n[nz, None]).astype(np.float32)
    return c, objs


def phase_train(torch, device, rows: int, seed: int) -> dict:
    from repro_torch.core import DType, Schema, SharkSession
    from repro_torch.core.expr import DECODE_COUNTERS
    from repro_torch.kernels import ops
    from repro_torch.ml import KMeans, LogisticRegression

    t0 = time.perf_counter()
    data = points(rows, seed)
    sess = SharkSession(device=str(device), num_workers=8, max_threads=8)
    schema = {c: DType.INT64 for c in FEATURES if c.startswith("b")}
    schema.update({c: DType.FLOAT64 for c in ("d0", "d1", "r0", "p0")})
    sess.create_table("points", Schema.of(**schema, label=DType.INT64), data,
                      num_partitions=PARTITIONS)
    encs = {}
    for part in sess.catalog.get("points").partitions:
        for c in FEATURES:
            e = part.columns[c].encoding.value
            encs[e] = encs.get(e, 0) + 1
    print(f"phase 3: points {rows} rows in {PARTITIONS} partitions loaded "
          f"in {time.perf_counter() - t0:.3f} s; feature blocks by encoding "
          f"{json.dumps(encs, sort_keys=True)}", flush=True)
    for e in ("bitpack", "dict", "rle", "plain"):
        if not encs.get(e):
            fail(f"points has no {e} feature block: {encs}")

    try:
        ops.reset_launch_counts()
        decodes = DECODE_COUNTERS["numeric_blocks"]
        t1 = time.perf_counter()
        clf = LogisticRegression(dims=len(FEATURES),
                                 iterations=LR_ITERS).fit(
            sess.table("points"), FEATURES, "label")
        km = KMeans(k=KM_K, dims=len(FEATURES), iterations=KM_ITERS).fit(
            sess.table("points"), FEATURES, "label")
        if device.type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        decoded = DECODE_COUNTERS["numeric_blocks"] - decodes
        if device.type == "cuda":
            # where a warm iteration's time goes, and what it launches
            from repro_torch.ml import IterativeTrainer
            feats = sess.table("points").to_features(FEATURES, "label")
            feats.cache()
            tr = IterativeTrainer(feats, "trace")
            tr.gradient_iteration(clf.w, "logistic")       # fills the cache
            for label, step in (
                    ("logistic", lambda: tr.gradient_iteration(clf.w,
                                                               "logistic")),
                    ("k-means", lambda: tr.kmeans_iteration(km.centroids))):
                ops.reset_launch_counts()
                step()
                torch.cuda.synchronize()
                ours = {k: v for k, v in ops.launch_counts().items() if v}
                rec = traced(torch, device,
                             f"phase 3: one warm {label} iteration", step)
                print(f"phase 3: one warm {label} iteration: "
                      f"{rec['device_ops']} device ops "
                      f"({rec['device_ops'] / PARTITIONS:.2f} a partition), "
                      f"port kernel launches {json.dumps(ours)}", flush=True)
    finally:
        sess.shutdown()
    print(f"phase 3: main-path launches {json.dumps(launches)}", flush=True)
    for name, est in (("logistic", clf), ("kmeans", km)):
        its = est.metrics.train_iterations
        warm = [it["seconds"] * 1e3 for it in its[1:]]
        print(f"phase 3: {name} first iteration "
              f"{its[0]['seconds'] * 1e3:.3f} ms, then "
              f"{', '.join(f'{m:.3f}' for m in warm)} ms (median "
              f"{float(np.median(warm)):.3f}); routes "
              f"{json.dumps(its[-1]['routes'], sort_keys=True)}", flush=True)
    print(f"phase 3: both fits {fit_s:.3f} s; host block decodes "
          f"{decoded}", flush=True)
    if decoded:
        fail(f"training decoded {decoded} blocks on the host")
    if device.type == "cuda":
        for it in clf.metrics.train_iterations:
            if it["routes"] != {"train_grad": PARTITIONS}:
                fail(f"logistic iteration took routes {it['routes']}")
        # one batched bit-pack launch a partition and step, one RLE
        # launch a partition step and RLE column (straight into x)
        steps = PARTITIONS * (LR_ITERS + KM_ITERS)
        if launches["bitpack_decode"] != steps:
            fail(f"bitpack_decode launched {launches['bitpack_decode']} "
                 f"times, not once a partition step ({steps})")
        rle_steps = steps * encs["rle"] // PARTITIONS
        if launches["rle_decode"] != rle_steps:
            fail(f"rle_decode launched {launches['rle_decode']} times, not "
                 f"once a partition step and RLE column ({rle_steps})")

    # the numpy replay of both fits, over the generated arrays
    x32 = np.stack([data[c] for c in FEATURES], axis=1).astype(np.float32)
    edges = np.linspace(0, rows, PARTITIONS + 1, dtype=np.int64)
    w0 = LogisticRegression(dims=len(FEATURES)).w
    w = replay_logreg(x32, data["label"], edges, w0, 0.1, LR_ITERS)
    c, objs = replay_kmeans(x32, edges,
                            KMeans(k=KM_K, dims=len(FEATURES)).centroids,
                            KM_ITERS)
    # w is float32: per-partition gradients are float64 sums taken in
    # another order than numpy's, rounded to float32, so a last-place
    # rounding can differ and carry through the updates
    if not np.allclose(clf.w, w, rtol=1e-5, atol=1e-6):
        fail(f"logistic weights differ from the numpy replay: "
             f"{np.max(np.abs(clf.w - w))}")
    # k-means runs in float32 on both sides, with float32 sums of 156,250
    # rows in another order (cuBLAS against numpy) that can also move a
    # point lying on a boundary between two centroids
    if not (np.allclose(km.centroids, c, rtol=1e-4, atol=1e-3)
            and np.allclose(km.objective_history, objs, rtol=1e-4)):
        fail(f"k-means differs from the numpy replay: centroids "
             f"{np.max(np.abs(km.centroids - c))}, objective "
             f"{km.objective_history[-1]} vs {objs[-1]}")
    if not (np.all(np.isfinite(clf.w)) and objs[-1] < objs[0]):
        fail("training did not converge")
    print(f"phase 3: weights match the numpy replay (max abs diff "
          f"{float(np.max(np.abs(clf.w - w))):.3g}), centroids "
          f"{float(np.max(np.abs(km.centroids - c))):.3g}, objective "
          f"{km.objective_history[0]:.6g} -> {km.objective_history[-1]:.6g}",
          flush=True)
    return {k: launches[k] for k in TRAIN_KERNELS}


# ---------------------------------------------------------------- phase 4

N_QUERIES = 3


def phase_search(torch, device, rows: int, seed: int) -> dict:
    from repro_torch.core import DType, Schema, SharkSession
    from repro_torch.core.functions import col
    from repro_torch.core.pde import PDEConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_similarity as tk

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 4)
    emb = rng.normal(size=(rows, EMB_DIM)).astype(np.float32)
    cat = rng.integers(0, 4, rows).astype(np.int64)
    # the CPU rehearsal forces the kernel route (its plain version) on
    # partitions below the kernel threshold
    cfg = (PDEConfig() if device.type == "cuda"
           else PDEConfig(segment_force_kernels=True,
                          segment_kernel_min_rows=256))
    sess = SharkSession(device=str(device), num_workers=8, max_threads=8,
                        pde_config=cfg)
    sess.create_table("docs", Schema.of(id=DType.INT64, cat=DType.INT64),
                      {"id": np.arange(rows, dtype=np.int64), "cat": cat,
                       "emb": emb}, num_partitions=PARTITIONS)
    scores = emb.astype(np.float64)
    print(f"phase 4: docs {rows} rows x {EMB_DIM} lanes in {PARTITIONS} "
          f"partitions loaded in {time.perf_counter() - t0:.3f} s",
          flush=True)

    routed = [0]          # kernel-routed partition searches (per run)

    def run(q, c):
        frame = sess.table("docs")
        if c is not None:
            frame = frame.filter(col("cat") == c)
        t = time.perf_counter()
        got = frame.similarity_join("emb", q, TOP_K).to_numpy()
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        routed[0] += sess.metrics().segment_routes().get(
            "topk_similarity", 0)
        s = scores @ q
        idx = np.nonzero(cat == c)[0] if c is not None else np.arange(rows)
        want = idx[np.argsort(-s[idx], kind="stable")[:TOP_K]]
        if not np.array_equal(got["id"], want):
            fail(f"similarity ids differ from numpy (filter cat={c})")
        return ms

    try:
        ops.reset_launch_counts()
        routes0 = dict(tk.ROUTES)
        for i in range(N_QUERIES):
            q = rng.normal(size=EMB_DIM)
            c = int(rng.integers(0, 4))
            before = dict(sess.metrics().segment_routes())
            times = [run(q, None) for _ in range(3)]
            routes = {k: v - before.get(k, 0)
                      for k, v in sess.metrics().segment_routes().items()
                      if v != before.get(k, 0)}
            ftimes = [run(q, c) for _ in range(3)]
            print(f"phase 4: query {i}: top {TOP_K} first {times[0]:.3f} ms, "
                  f"then {times[1]:.3f}, {times[2]:.3f} ms; with cat = {c} "
                  f"below: {ftimes[0]:.3f}, then {ftimes[1]:.3f}, "
                  f"{ftimes[2]:.3f} ms; routes "
                  f"{json.dumps(routes, sort_keys=True)}", flush=True)
            if routes.get("topk_similarity", 0) == 0:
                fail(f"similarity search took routes {routes}")
        launches = ops.launch_counts()
        searches = routed[0]
        kroutes = {k: v - routes0[k] for k, v in tk.ROUTES.items()}
        print(f"phase 4: {searches} kernel-routed partition searches, "
              f"{launches['topk_similarity']} topk_similarity launches, "
              f"routes {json.dumps(kroutes, sort_keys=True)}", flush=True)
        if device.type == "cuda" and not (
                launches["topk_similarity"] == searches
                == kroutes["lanes"] == kroutes["fused"]
                and kroutes["stacked"] == kroutes["rounds"] == 0):
            fail(f"phase 4 ran {launches['topk_similarity']} topk launches "
                 f"for {searches} kernel-routed partition searches, routes "
                 f"{kroutes}: not one fused launch on the lanes each")
        if device.type == "cuda":
            traced(torch, device, "phase 4: one warm top-100 search",
                   lambda: run(q, None))
            traced(torch, device, f"phase 4: one warm search, cat = {c}",
                   lambda: run(q, c))
    finally:
        sess.shutdown()
    print(f"phase 4: main-path launches {json.dumps(launches)}; ids match "
          f"numpy", flush=True)
    return {k: launches[k] for k in SEARCH_KERNELS}


# ---------------------------------------------------------------- LM kernels

# Zamba2-7B's prefill shapes (repro_torch/configs/registry.py): 32 heads of
# 112 in the shared attention; 64 SSD heads of P = 112, N = 64, chunk 256
LM_BATCH, LM_SEQ = 4, 2048
ATT_HEADS, ATT_HD = 32, 112
# Yi-9B's prefill attention: 32 query heads over 4 kv heads of 128
GQA_HEADS, GQA_KV, GQA_HD = 32, 4, 128
# Llama-3.2-Vision-11B's cross-attention prefill: 32 query heads over 8 kv
# heads of 128 against 1,601 image tokens (row 11X)
CROSS_HEADS, CROSS_KV, CROSS_HD, CROSS_T = 32, 8, 128, 1601
SSD_HEADS, SSD_P, SSD_N, SSD_CHUNK = 64, 112, 64, 256
BF16_STEP = 2.0 ** -7            # one bfloat16 rounding step, relative


def phase_kernels_lm(torch, device, seed: int) -> dict:
    """The flash and SSD kernels against their plain versions on the device,
    at Zamba2's prefill shapes, at Mamba2-370m's SSD head geometry, at a
    ragged S = 1000, at head dims 64 and 128 and in float32, flash with
    fewer kv heads (GQA) and non-causal at S != T (cross-attention); then
    each timed at Zamba2's prefill shape in the layout the model hands it,
    flash also at Yi-9B's (row 11G) and at Llama-3.2-Vision's cross
    shape (row 11X)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.launch.cost import flash_cost, ssd_cost
    import torch.nn.functional as F

    rng = np.random.default_rng(seed + 5)
    dev = device
    bf16, f32 = torch.bfloat16, torch.float32
    err = {k: 0.0 for k in LM_KERNELS}
    # the CPU rehearsal compares the plain versions with themselves at a
    # fraction of the heads
    cut = 1 if device.type == "cuda" else 8

    def t(a, dt=f32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dt)

    # flash: rel max err < 0.03 in bf16, < 1e-4 in float32 (the
    # reference's kernel test); bf16 takes the tensor-core route (P rounded
    # to bf16), float32 and bf16 at hd % 8 != 0 the SIMT one
    for b, h, s, hd, dt, causal in (
            (LM_BATCH, ATT_HEADS, LM_SEQ, ATT_HD, bf16, True),
            (LM_BATCH, ATT_HEADS, 1000, ATT_HD, bf16, True),
            (2, 16, LM_SEQ, 64, bf16, True),
            (2, 16, 1000, 128, bf16, True),
            (2, 16, 1000, ATT_HD, bf16, False),
            (2, 4, 1, ATT_HD, bf16, True), (2, 4, 63, 64, bf16, False),
            (2, 4, 65, 128, bf16, True), (2, 4, 300, 36 + 2, bf16, True),
            (2, 8, 1000, ATT_HD, f32, True), (2, 8, 1000, ATT_HD, f32, False),
            (1, 8, 777, 128, f32, True), (2, 4, 129, 64, f32, True)):
        h = max(1, h // cut)
        # the model's layout: (B, S, H, hd) seen as (B, H, S, hd)
        q, k, v = (t(rng.normal(size=(b, s, h, hd)), dt).transpose(1, 2)
                   for _ in range(3))
        got = kf.flash_attention_fwd(q, k, v, causal).float()
        want = kf.flash_attention_fwd_plain(q, k, v, causal).float()
        rel = float((got - want).abs().max() / want.abs().max())
        if not (np.isfinite(rel) and rel < (0.03 if dt == bf16 else 1e-4)):
            fail(f"flash ({b}, {h}, {s}, {hd}, {dt}, causal={causal}) rel "
                 f"err {rel}")
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], float(
            (got - want).abs().max()))
    # GQA (k, v with kv heads, each query head reading kv head h // g) at
    # Yi-9B's prefill shape and at the other dense configurations' groups
    # (g = 4, 8, 12), ragged S, both routes; the same tolerances
    err_gqa = 0.0
    for b, h, kv, s, hd, dt, causal in (
            (LM_BATCH, GQA_HEADS, GQA_KV, LM_SEQ, GQA_HD, bf16, True),
            (1, 40, 10, 1000, 128, bf16, True),
            (1, 16, 2, 1000, 128, bf16, True),
            (1, 48, 4, 1000, 128, bf16, False),
            (1, 16, 2, 777, 128, f32, True),
            (2, 24, 2, 300, 64, f32, False)):
        h = kv * max(1, h // kv // cut)
        q = t(rng.normal(size=(b, s, h, hd)), dt).transpose(1, 2)
        # each kv head's values offset from the others', so that a query
        # head reading a wrong kv head cannot pass
        off = np.arange(kv)[:, None]
        k = t(rng.normal(size=(b, s, kv, hd)) + 0.5 * off, dt).transpose(1, 2)
        v = t(rng.normal(size=(b, s, kv, hd)) + 3.0 * off, dt).transpose(1, 2)
        got = kf.flash_attention_fwd(q, k, v, causal).float()
        want = kf.flash_attention_fwd_plain(q, k, v, causal).float()
        rel = float((got - want).abs().max() / want.abs().max())
        if not (np.isfinite(rel) and rel < (0.03 if dt == bf16 else 1e-4)):
            fail(f"GQA flash ({b}, {h} over {kv}, {s}, {hd}, {dt}, "
                 f"causal={causal}) rel err {rel}")
        err_gqa = max(err_gqa, float((got - want).abs().max()))
    # cross-attention (non-causal, S queries against T != S keys, ragged
    # T): Llama-3.2-Vision's prefill against its 1,601 image tokens (4 x
    # 2,048 and 1 x 1,000), Whisper's encoder (S = T = 1,500, hd 64) and
    # decoder against its 1,500 frames, and S > T; both routes, the same
    # tolerances
    err_cross = 0.0
    for b, h, kv, s, tk, hd in (
            (LM_BATCH, CROSS_HEADS, CROSS_KV, LM_SEQ, CROSS_T, CROSS_HD),
            (1, CROSS_HEADS, CROSS_KV, 1000, CROSS_T, CROSS_HD),
            (LM_BATCH, 8, 8, 1500, 1500, 64),
            (LM_BATCH, 8, 8, 64, 1500, 64),
            (2, 8, 2, 700, 129, 64)):
        for dt in (bf16, f32):
            hh = kv * max(1, h // kv // cut)
            q = t(rng.normal(size=(b, s, hh, hd)), dt).transpose(1, 2)
            off = np.arange(kv)[:, None]
            k = t(rng.normal(size=(b, tk, kv, hd)) + 0.5 * off, dt) \
                .transpose(1, 2)
            v = t(rng.normal(size=(b, tk, kv, hd)) + 3.0 * off, dt) \
                .transpose(1, 2)
            route = "tensor_core" if dt == bf16 else "simt"
            before = dict(kf.ROUTES)
            got = kf.flash_attention_fwd(q, k, v, False).float()
            if device.type == "cuda" and kf.ROUTES[route] != before[route] + 1:
                fail(f"cross flash ({b}, {hh} over {kv}, {s}, {tk}, {hd}, "
                     f"{dt}) did not take route {route}")
            want = kf.flash_attention_fwd_plain(q, k, v, False).float()
            rel = float((got - want).abs().max() / want.abs().max())
            if not (np.isfinite(rel)
                    and rel < (0.03 if dt == bf16 else 1e-4)):
                fail(f"cross flash ({b}, {hh} over {kv}, S {s}, T {tk}, "
                     f"{hd}, {dt}) rel err {rel}")
            err_cross = max(err_cross, float((got - want).abs().max()))
    # the log-sum-exp output (the backward's input): at Zamba2's and
    # Qwen2.5-3B's training shapes, ragged S, non-causal at S != T, both
    # routes; abs err < 1e-3 on the bf16 route, < 1e-4 on float32, and the
    # output with it bit for bit the output without it
    err_lse = 0.0
    for b, h, kv, s, tk, hd, dt, causal in (
            (LM_BATCH, ATT_HEADS, ATT_HEADS, LM_SEQ, LM_SEQ, ATT_HD, bf16,
             True),
            (LM_BATCH, 16, 2, LM_SEQ, LM_SEQ, 128, bf16, True),
            (2, 16, 2, 1000, 1000, 128, f32, True),
            (1, 32, 8, 1000, CROSS_T, 128, bf16, False),
            (2, 8, 2, 700, 129, 64, f32, False),
            (2, 4, 4, 65, 65, 36 + 2, bf16, True)):
        hh = kv * max(1, h // kv // cut)
        q = t(rng.normal(size=(b, s, hh, hd)), dt).transpose(1, 2)
        k, v = (t(rng.normal(size=(b, tk, kv, hd)), dt).transpose(1, 2)
                for _ in range(2))
        got, lse = kf.flash_attention_fwd(q, k, v, causal, return_lse=True)
        plain, want = kf.flash_attention_fwd_plain(q, k, v, causal,
                                                   return_lse=True)
        e = float((lse - want).abs().max())
        alone = kf.flash_attention_fwd(q, k, v, causal)
        if not (lse.shape == (b, hh, s) and lse.dtype == f32
                and torch.equal(got, alone)
                and e < (1e-3 if dt == bf16 else 1e-4)):
            fail(f"flash LSE ({b}, {hh} over {kv}, S {s}, T {tk}, {hd}, "
                 f"{dt}, causal={causal}): abs err {e}, shape "
                 f"{tuple(lse.shape)}, output equal without it "
                 f"{torch.equal(got, alone)}")
        err_lse = max(err_lse, e)
    # SSD: rtol = atol = 1e-3 on y and the final state (the reference's
    # kernel test); a bf16 y is rounded once to bf16 on both sides, so two
    # values that close may still round one bf16 step apart
    for b, s, h, p, n, dt in ((LM_BATCH, LM_SEQ, SSD_HEADS, SSD_P, SSD_N,
                               bf16),
                              (1, LM_SEQ, 32, 64, 128, bf16),
                              (2, 1000, SSD_HEADS, SSD_P, SSD_N, bf16),
                              (2, 1000, 8, SSD_P, SSD_N, f32),
                              (1, 1000, 32, 64, 128, f32)):
        h = max(1, h // cut)
        x = t(rng.normal(size=(b, s, h, p)), dt)
        dtt = F.softplus(t(rng.normal(size=(b, s, h))))
        a = -torch.exp(t(rng.normal(size=h)))
        bm, cm = t(rng.normal(size=(b, s, n)), dt), t(rng.normal(size=(b, s, n)),
                                                      dt)
        d = t(rng.normal(size=h))
        before = dict(ks.ROUTES)
        y, st = ks.ssd_scan(x, dtt, a, bm, cm, SSD_CHUNK, d=d)
        route = "tensor_core" if dt == bf16 else "simt"
        if device.type == "cuda" and ks.ROUTES[route] != before[route] + 1:
            fail(f"ssd ({b}, {s}, {h}, {p}, {n}, {dt}) did not take route "
                 f"{route}: {ks.ROUTES} after {before}")
        yp, sp = ks.ssd_scan_plain(x, dtt, a, bm, cm, SSD_CHUNK, d=d)
        y, yp = y.float(), yp.float()
        rtol = 1e-3 + (BF16_STEP if dt == bf16 else 0.0)
        over_y = float(((y - yp).abs() - 1e-3 - rtol * yp.abs()).max())
        over_s = float(((st - sp).abs() - 1e-3 - 1e-3 * sp.abs()).max())
        if not (over_y <= 0 and over_s <= 0):
            fail(f"ssd ({b}, {s}, {h}, {p}, {n}, {dt}) beyond tolerance: y "
                 f"by {over_y}, state by {over_s}")
        err["ssd_scan"] = max(err["ssd_scan"], float((y - yp).abs().max()),
                              float((st - sp).abs().max()))
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"phase 1: flash (MHA, GQA and cross at S != T) and SSD kernels "
          f"match their plain versions, max abs err {json.dumps(err)}, GQA "
          f"{err_gqa}, cross {err_cross}, flash log-sum-exp {err_lse}",
          flush=True)

    timer = Timer(torch, device)
    b, s = LM_BATCH, LM_SEQ
    ah, sh = ATT_HEADS // cut, SSD_HEADS // cut
    q, k, v = (t(rng.normal(size=(b, s, ah, ATT_HD)), bf16).transpose(1, 2)
               for _ in range(3))
    di = sh * SSD_P
    # x, B, C as the in-projection's slices of the conv output
    xbc = t(rng.normal(size=(b, s, di + 2 * SSD_N)), bf16)
    x = xbc[..., :di].reshape(b, s, sh, SSD_P)
    bm, cm = xbc[..., di:di + SSD_N], xbc[..., di + SSD_N:]
    dtt = F.softplus(t(rng.normal(size=(b, s, sh))))
    a = -torch.exp(t(rng.normal(size=sh)))
    d = t(np.ones(sh))
    fb, ff = flash_cost(b, ah, s, ATT_HD, 2)
    sb, sf = ssd_cost(b, s, sh, SSD_P, SSD_N, 2)
    cases = {
        "flash_attention_fwd": (
            lambda: kf.flash_attention_fwd(q, k, v),
            lambda: kf.flash_attention_fwd_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            fb, ff),
        "ssd_scan": (
            lambda: ks.ssd_scan(x, dtt, a, bm, cm, SSD_CHUNK, d=d),
            lambda: ks.ssd_scan_plain(x, dtt, a, bm, cm, SSD_CHUNK, d=d),
            None, sb, sf),
    }
    # row 11G: Yi-9B's prefill attention, k and v with 4 kv heads
    gh = GQA_KV * max(1, GQA_HEADS // GQA_KV // cut)
    qg = t(rng.normal(size=(b, s, gh, GQA_HD)), bf16).transpose(1, 2)
    kg, vg = (t(rng.normal(size=(b, s, GQA_KV, GQA_HD)), bf16).transpose(1, 2)
              for _ in range(2))
    # the backwards, plain torch by design (the reference's are XLA), at
    # the timed shapes: kernel 11's two (`models/flash.py`) from its saved
    # output and log-sum-exp, kernel 12's the vector-Jacobian product of
    # `ssd_scan_plain` recomputed under autograd
    from repro_torch.models import flash as mflash
    from repro_torch.models import mamba2 as mm2
    qm, km, vm = (z.transpose(1, 2) for z in (q, k, v))
    om, lse = kf.flash_attention_fwd(q, k, v, True, return_lse=True)
    om = om.transpose(1, 2)
    lse = lse.transpose(1, 2).reshape(b, s, ah, 1)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    d_o = torch.randn_like(om)
    res = (qm, km, vm, pos, om, lse)
    dy = torch.randn(x.shape, device=dev, dtype=bf16)
    dstate = torch.zeros(b, sh, SSD_P, SSD_N, device=dev)
    backward = {
        "flash_exact_ms": timer(lambda: mflash._exact_bwd(1024, True, res,
                                                          d_o),
                                reps=3, warmup=1),
        "flash_flash_ms": timer(lambda: mflash._flash_bwd(1024, True, res,
                                                          d_o),
                                reps=3, warmup=1),
        "ssd_ms": timer(lambda: mm2.ssd_scan_vjp(
            x, dtt, a, bm, cm, d, SSD_CHUNK, dy, dstate), reps=2, warmup=1),
    }
    del res, om, lse, d_o, dy, dstate
    print(f"phase 1: plain-torch backwards at the timed shapes (ms): "
          f"{json.dumps(backward)}", flush=True)
    if device.type == "cuda":
        one_kernel("bf16 ssd_scan", cases["ssd_scan"][0])
        one_kernel("bf16 GQA flash_attention_fwd (32 heads over 4)",
                   lambda: kf.flash_attention_fwd(qg, kg, vg))
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in cases.items():
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": 0,
            "max_abs_err": err[name], "ms": timer(kern, reps=10, warmup=2),
            "device_ms": timer.graphed(kern, calls=5, replays=4),
            "plain_ms": timer(plain, reps=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (timer(lib, reps=10, warmup=2)
                           if lib is not None else None),
            "library_device_ms": (timer.graphed(lib, calls=5, replays=4)
                                  if lib is not None else None),
        }
    # kernel 11 with its log-sum-exp written (what training launches),
    # beside the call without it above
    lse_call = lambda: kf.flash_attention_fwd(q, k, v,  # noqa: E731
                                              return_lse=True)
    out["flash_attention_fwd"].update(
        lse_ms=timer(lse_call, reps=10, warmup=2),
        lse_device_ms=timer.graphed(lse_call, calls=5, replays=4),
        max_abs_err_lse=err_lse,
        backward_ms={"exact": backward["flash_exact_ms"],
                     "flash": backward["flash_flash_ms"]},
        backward_route="plain torch")
    out["ssd_scan"].update(backward_ms=backward["ssd_ms"],
                           backward_route="plain torch")
    # the library yardstick groups k/v itself where the installed torch
    # takes `enable_gqa`; else it is timed on k/v repeated beforehand
    sdpa_gqa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qg, kg, vg, is_causal=True, enable_gqa=True)
    try:
        sdpa_gqa()
        lib_call = "scaled_dot_product_attention(enable_gqa=True)"
    except TypeError:
        kr, vr = (x.repeat_interleave(gh // GQA_KV, dim=1) for x in (kg, vg))
        sdpa_gqa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qg, kr, vr, is_causal=True)
        lib_call = "scaled_dot_product_attention on k/v repeated beforehand"
    gb, gf = flash_cost(b, gh, s, GQA_HD, 2, GQA_KV)
    g_ms, g_by = bound(gb, gf, "bfloat16")
    gqa = {
        "row": "11G", "name": "flash_attention_fwd", "route": "cuda",
        "source": SOURCES["flash_attention_fwd"],
        "replaces": TPU_KERNELS["flash_attention_fwd"],
        "shape": [b, gh, GQA_KV, s, GQA_HD], "launches": 0,
        "max_abs_err": err_gqa,
        "ms": timer(lambda: kf.flash_attention_fwd(qg, kg, vg), reps=10,
                    warmup=2),
        "device_ms": timer.graphed(lambda: kf.flash_attention_fwd(qg, kg,
                                                                  vg),
                                   calls=5, replays=4),
        "plain_ms": timer(lambda: kf.flash_attention_fwd_plain(qg, kg, vg),
                          reps=3, warmup=1),
        "bound_ms": g_ms, "bound_by": g_by,
        "library_ms": timer(sdpa_gqa, reps=10, warmup=2),
        "library_device_ms": timer.graphed(sdpa_gqa, calls=5, replays=4),
        "library_call": lib_call,
    }
    if gqa["device_ms"] is not None:
        gqa["tflops"] = gf / (gqa["device_ms"] * 1e-3) / 1e12
        gqa["library_tflops"] = gf / (gqa["library_device_ms"] * 1e-3) / 1e12
    out["flash_attention_fwd"]["gqa"] = gqa
    print(f"phase 1: GQA flash (row 11G) {gf / 1e9:.1f} GFLOP / "
          f"{gb / 1e6:.1f} MB at {gqa['shape']}: {json.dumps(gqa)}",
          flush=True)
    # row 11X: Llama-3.2-Vision's cross-attention prefill, non-causal, 4 x
    # 2,048 queries against 1,601 image tokens of 8 kv heads
    xh = CROSS_KV * max(1, CROSS_HEADS // CROSS_KV // cut)
    qx = t(rng.normal(size=(b, s, xh, CROSS_HD)), bf16).transpose(1, 2)
    kx, vx = (t(rng.normal(size=(b, CROSS_T, CROSS_KV, CROSS_HD)), bf16)
              .transpose(1, 2) for _ in range(2))
    sdpa_x = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qx, kx, vx, enable_gqa=True)
    try:
        sdpa_x()
        x_call = "scaled_dot_product_attention(enable_gqa=True)"
    except TypeError:
        kr, vr = (x.repeat_interleave(xh // CROSS_KV, dim=1)
                  for x in (kx, vx))
        sdpa_x = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qx, kr, vr)
        x_call = "scaled_dot_product_attention on k/v repeated beforehand"
    if device.type == "cuda":
        one_kernel("bf16 cross flash_attention_fwd (32 heads over 8, T "
                   "1,601)", lambda: kf.flash_attention_fwd(qx, kx, vx,
                                                            False))
    xb, xf = flash_cost(b, xh, s, CROSS_HD, 2, CROSS_KV, CROSS_T)
    x_ms, x_by = bound(xb, xf, "bfloat16")
    cross = {
        "row": "11X", "name": "flash_attention_fwd", "route": "cuda",
        "source": SOURCES["flash_attention_fwd"],
        "replaces": TPU_KERNELS["flash_attention_fwd"],
        "shape": [b, xh, CROSS_KV, s, CROSS_T, CROSS_HD], "causal": False,
        "launches": 0, "max_abs_err": err_cross,
        "ms": timer(lambda: kf.flash_attention_fwd(qx, kx, vx, False),
                    reps=10, warmup=2),
        "device_ms": timer.graphed(
            lambda: kf.flash_attention_fwd(qx, kx, vx, False), calls=5,
            replays=4),
        "plain_ms": timer(lambda: kf.flash_attention_fwd_plain(qx, kx, vx,
                                                               False),
                          reps=3, warmup=1),
        "bound_ms": x_ms, "bound_by": x_by,
        "library_ms": timer(sdpa_x, reps=10, warmup=2),
        "library_device_ms": timer.graphed(sdpa_x, calls=5, replays=4),
        "library_call": x_call,
    }
    if cross["device_ms"] is not None:
        cross["tflops"] = xf / (cross["device_ms"] * 1e-3) / 1e12
        cross["library_tflops"] = (xf / (cross["library_device_ms"] * 1e-3)
                                   / 1e12)
    out["flash_attention_fwd"]["cross"] = cross
    print(f"phase 1: cross flash (row 11X) {xf / 1e9:.1f} GFLOP / "
          f"{xb / 1e6:.1f} MB at {cross['shape']}: {json.dumps(cross)}",
          flush=True)
    flash, ssd = out["flash_attention_fwd"], out["ssd_scan"]
    if flash["device_ms"] is not None:
        # achieved rates of the tensor-core routes over the causal flops
        flash["tflops"] = ff / (flash["device_ms"] * 1e-3) / 1e12
        flash["library_tflops"] = (ff / (flash["library_device_ms"] * 1e-3)
                                   / 1e12)
        ssd["tflops"] = sf / (ssd["device_ms"] * 1e-3) / 1e12
    print(f"phase 1: flash {ff / 1e9:.1f} GFLOP / {fb / 1e6:.1f} MB, ssd "
          f"{sf / 1e9:.1f} GFLOP / {sb / 1e6:.1f} MB at the timed shape; "
          f"flash routes {json.dumps(kf.ROUTES)}, ssd routes "
          f"{json.dumps(ks.ROUTES)}, ssd TFLOP/s {ssd.get('tflops')}",
          flush=True)
    return out


# ---------------------------------------------------------------- phase 5

# requests: (batch, prompt tokens, new tokens); the second is ragged for
# both kernels (1000 is no multiple of their 64-row tiles or of chunk 256)
REQUESTS = ((LM_BATCH, LM_SEQ, 64), (1, 1000, 16))
DECODE_STEPS = 8
# the consistency checks run on a float32 copy of the served weights, where
# the two routes differ only in float32 summation order (rel 3.4e-5 at the
# full depth on an H100, PERF.md section 6); in bf16 each route's rounding
# drifts over the 81 slots by more than the 0.05 the reference's smoke
# test allows (kernels vs plain 0.070, bf16 vs float32 0.086 there), so
# the bf16 gaps are reported beside that noise floor, not gated
CONSISTENCY_REL = 1e-3


@contextlib.contextmanager
def plain_routes():
    """The model's kernel wrappers replaced by their plain versions (the
    model reaches them through `kernels.ops` at call time)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ks
    saved = ops.flash_attention_fwd, ops.ssd_scan
    ops.flash_attention_fwd = kf.flash_attention_fwd_plain
    ops.ssd_scan = ks.ssd_scan_plain
    try:
        yield
    finally:
        ops.flash_attention_fwd, ops.ssd_scan = saved


def on_card(label: str, what: str, tensors) -> None:
    """Fail unless every tensor lies on the card."""
    off = sorted({str(t.device) for t in tensors if t.device.type != "cuda"})
    if off:
        fail(f"{label}: {what} not on the card: {off}")


def serve_model(torch, device, seed: int, label: str, cfg, requests,
                per_prefill: dict, trace: bool = True, draw=None,
                checks=None, check_cfg=None, extra=None, against=None,
                report=None) -> dict:
    """Serve `cfg` (bf16 weights drawn on the device from `seed`, then
    `draw(model, generator)` if given; `extra(b)`, if given, draws each
    request's other prefill inputs, a vlm model's image embeddings or an
    encdec model's frames, used by every call on that request) through
    ServeEngine: per request,
    the prefill and decode times, peak device memory and the launches of
    one prefill, which must be `per_prefill` ({kernel: launches}), every
    bf16 flash and SSD launch on its tensor-core route, and every weight,
    cache and logit on the card; for a `moe` model the router statistics
    of the prompt; traces of one prefill and one decode step of the
    batched request; then every request through `generate`, the counted
    main path, and peak device memory; then, on a float32 copy of the same
    weights, the kernels' prefill against the plain versions' and one
    decode step against the full forward over S + 1 tokens, on the
    requests numbered in `checks` (default: all), computed with
    `check_cfg` (default: `cfg`; a `moe` model's drop-free capacity, where
    the full forward drops nothing that decode keeps) and gated at
    CONSISTENCY_REL; the same gaps with `cfg` are reported beside them.
    With `against` (a config), the gated config's float32 prefill logits
    are held to `against`'s within CONSISTENCY_REL too; `report(model,
    prompts)`, if given, runs on the bf16 model after the main path.
    Returns the main path's launches of `per_prefill`'s kernels."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine

    cuda = device.type == "cuda"
    kernels = tuple(per_prefill)
    # every bf16 prefill launch of flash and of the SSD scan takes the
    # tensor-core route
    route_tables = {name: (routes, per_prefill[kernel])
                    for name, kernel, routes in (
                        ("flash", "flash_attention_fwd", kf.ROUTES),
                        ("ssd", "ssd_scan", ks.ROUTES))
                    if kernel in per_prefill}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def reset_counts():
        ops.reset_launch_counts()
        for routes, _ in route_tables.values():
            for r in routes:
                routes[r] = 0

    def check_routes(what: str, times: int) -> dict:
        taken = {}
        for name, (routes, n) in route_tables.items():
            taken[name] = dict(routes)
            want = {"tensor_core": n * times, "simt": 0}
            if cuda and taken[name] != want:
                fail(f"{label}: {what} took {name} routes {taken[name]}, "
                     f"expected {want}")
        return taken

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = lm.build_model(cfg, device, gen)
    if draw is not None:
        draw(model, gen)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{label}: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
          f"heads, {n_params} parameters, {n_bytes} bytes) built on "
          f"{device} in {time.perf_counter() - t0:.3f} s", flush=True)
    rng = np.random.default_rng(seed + 6)
    prompts = [rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
               for b, s, _ in requests]
    extras = [extra(b) if extra is not None else {} for b, _, _ in requests]

    def prefill(toks, max_seq, ex, c=cfg):
        return lm.prefill_fn(c, model, {"tokens": toks, **ex}, max_seq)

    def full_forward_last(toks, ex, c=cfg):
        h = lm._backbone_full(c, model, toks, extra=ex)
        return (h[:, -1:] @ lm._unembed(c, model)).float()

    def router_stats(toks) -> str:
        """The MoE layers' statistics over one full forward of the prompt:
        `frac_dropped` summed over layers (the reference's `aux`), and the
        largest expert load over the mean load, largest and median over
        layers."""
        stats = []
        lm._backbone_full(cfg, model, toks, stats=stats)
        dropped = sum(float(st["frac_dropped"]) for st in stats)
        skew = [float(st["expert_load"].max() / st["expert_load"].mean())
                for st in stats]
        return (f"router: frac_dropped summed over {len(stats)} layers "
                f"{dropped:.6g} (mean {dropped / len(stats):.6g}), largest "
                f"expert load over the mean {max(skew):.4g} (median over "
                f"layers {float(np.median(skew)):.4g})")

    bf16_logits = []
    peak = 0
    for (b, s, new), prompt, ex in zip(requests, prompts, extras):
        max_seq = s + new
        toks = torch.from_numpy(prompt).to(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        logits, caches = prefill(toks, max_seq, ex)
        sync()
        first_ms = (time.perf_counter() - t) * 1e3
        counts = {k: ops.launch_counts()[k] for k in kernels}
        if cuda and counts != per_prefill:
            fail(f"{label}: one prefill launched {counts}, expected "
                 f"{per_prefill}")
        routes = check_routes("one bf16 prefill", 1)
        if not (logits.shape == (b, 1, cfg.vocab)
                and bool(torch.isfinite(logits).all())):
            fail(f"{label}: prefill logits {tuple(logits.shape)} not finite")
        if cuda:
            on_card(label, "weights, caches or logits",
                    [*model.parameters(), *model.buffers(),
                     *caches.values(), logits])
        with plain_routes():
            logits_plain, _ = prefill(toks, max_seq, ex)
        t = time.perf_counter()
        logits, caches = prefill(toks, max_seq, ex)
        sync()
        warm_ms = (time.perf_counter() - t) * 1e3
        tok = torch.argmax(logits[:, -1], dim=-1)
        steps = []
        for i in range(DECODE_STEPS):
            t = time.perf_counter()
            logits_d, caches = lm.decode_fn(cfg, model, tok[:, None], caches,
                                            s + i)
            sync()
            steps.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                first_dec = logits_d
            tok = torch.argmax(logits_d[:, -1], dim=-1)
        if not bool(torch.isfinite(logits_d).all()):
            fail(f"{label}: decode logits not finite")
        first_tok = torch.argmax(logits[:, -1], dim=-1)
        full = full_forward_last(torch.cat([toks.long(), first_tok[:, None]],
                                           dim=1), ex)
        bf16_logits.append((logits, logits_plain, first_dec, full))
        mem = ""
        if cuda:
            req_peak = torch.cuda.max_memory_allocated()
            peak = max(peak, req_peak)
            mem = f"; peak device memory {req_peak} bytes"
        print(f"{label}: request {b} x {s} + {new}: prefill first "
              f"{first_ms:.3f} ms, warm {warm_ms:.3f} ms "
              f"({b * s / warm_ms * 1e3:.1f} tokens/s); decode first step "
              f"{steps[0]:.3f} ms, warm {float(np.median(steps[1:])):.3f} "
              f"ms/step (median of {len(steps) - 1}); bf16 gaps: kernels vs "
              f"plain rel {rel(logits, logits_plain):.4g}, decode vs full "
              f"forward rel {rel(first_dec, full):.4g}; launches per "
              f"prefill {json.dumps(counts)}, routes {json.dumps(routes)}"
              f"{mem}", flush=True)
        if cfg.family == "moe":
            print(f"{label}: request {b} x {s}: {router_stats(toks)}",
                  flush=True)
        if cuda and trace and b == requests[0][0]:
            traced(torch, device, f"{label}: one prefill, {b} x {s}",
                   lambda: prefill(toks, max_seq, ex))
            traced(torch, device, f"{label}: one warm decode step",
                   lambda: lm.decode_fn(cfg, model, tok[:, None], caches,
                                        s + DECODE_STEPS))
        del caches, logits_d

    # the main path: every request through ServeEngine.generate
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for (b, s, new), prompt, ex in zip(requests, prompts, extras):
        eng = ServeEngine(cfg, model, max_seq=s + new, temperature=0.0,
                          seed=seed)
        t = time.perf_counter()
        out = eng.generate(prompt, new, ex)
        gen_s = time.perf_counter() - t
        if not (out.shape == (b, new) and out.dtype == np.int32
                and ((out >= 0) & (out < cfg.vocab)).all()):
            fail(f"{label}: generate returned {out.shape} {out.dtype}")
        print(f"{label}: generate {b} x {s} + {new} tokens in {gen_s:.3f} s "
              f"({b * new / gen_s:.1f} new tokens/s incl. prefill); first "
              f"tokens {out[0, :8].tolist()}", flush=True)
    launches = {k: ops.launch_counts()[k] for k in kernels}
    want = {k: v * len(requests) for k, v in per_prefill.items()}
    if cuda and launches != want:
        fail(f"{label}: generate launched {launches}, expected {want}")
    routes = check_routes("generate", len(requests))
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())
        print(f"{label}: peak device memory serving bf16 {peak} bytes",
              flush=True)
    if report is not None:
        report(model, prompts)

    def f32_gaps(c, toks, s, max_seq, ex):
        """(kernels vs plain, decode vs full forward, logits, plain
        logits) of one request on the float32 weights, computed with c."""
        logits, caches = prefill(toks, max_seq, ex, c)
        with plain_routes():
            logits_plain, _ = prefill(toks, max_seq, ex, c)
        tok = torch.argmax(logits[:, -1], dim=-1)
        logits_d, _ = lm.decode_fn(c, model, tok[:, None], caches, s)
        del caches
        full = full_forward_last(torch.cat([toks.long(), tok[:, None]], dim=1),
                                 ex, c)
        return (rel(logits, logits_plain), rel(logits_d, full), logits,
                logits_plain)

    # consistency, on a float32 copy of the same weights (DeepSeek-V2-Lite's
    # are 62.8 GB: the allocator's cache goes first)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    model.float()
    gated = check_cfg or cfg
    for i, ((b, s, new), prompt) in enumerate(zip(requests, prompts)):
        if checks is not None and i not in checks:
            continue
        lk16, lp16, ld16, lf16 = bf16_logits[i]
        toks = torch.from_numpy(prompt).to(device)
        r_plain, r_dec, logits, logits_plain = f32_gaps(gated, toks, s,
                                                        s + new, extras[i])
        what = ""
        if check_cfg is not None:
            what = (f" (capacity factor {check_cfg.moe.capacity_factor:g}, "
                    f"drop-free)")
        print(f"{label}: request {b} x {s}, float32 weights{what}: kernels "
              f"vs plain rel {r_plain:.4g}, decode vs full forward rel "
              f"{r_dec:.4g}", flush=True)
        if not (r_plain < CONSISTENCY_REL and r_dec < CONSISTENCY_REL):
            fail(f"{label}: float32 consistency beyond {CONSISTENCY_REL}: "
                 f"kernels vs plain {r_plain}, decode vs full forward "
                 f"{r_dec}")
        if against is not None:
            other, _ = prefill(toks, s + new, extras[i], against)
            r_other = rel(logits, other)
            print(f"{label}: request {b} x {s}, float32 weights{what}: "
                  f"prefill logits vs moe_impl={against.moe_impl!r}'s rel "
                  f"{r_other:.4g}", flush=True)
            if not r_other < CONSISTENCY_REL:
                fail(f"{label}: float32 prefill vs moe_impl="
                     f"{against.moe_impl!r} rel {r_other} beyond "
                     f"{CONSISTENCY_REL}")
            del other
        if check_cfg is not None:
            # the bf16 runs served cfg: their rounding is read against
            # float32 at cfg too
            r_plain, r_dec, logits, logits_plain = f32_gaps(cfg, toks, s,
                                                            s + new,
                                                            extras[i])
            print(f"{label}: request {b} x {s}, float32 weights at the "
                  f"served capacity factor {cfg.moe.capacity_factor:g} "
                  f"(reported, not gated: the full forward may drop the "
                  f"last token, dropless decode never does): kernels vs "
                  f"plain rel {r_plain:.4g}, decode vs full forward rel "
                  f"{r_dec:.4g}", flush=True)
        print(f"{label}: request {b} x {s}, the bf16 route's own rounding: "
              f"plain bf16 vs plain float32 rel "
              f"{rel(lp16, logits_plain):.4g}, kernels bf16 vs float32 rel "
              f"{rel(lk16, logits):.4g}", flush=True)
    print(f"{label}: main-path launches {json.dumps(launches)}, routes "
          f"{json.dumps(routes)}", flush=True)
    del model
    return launches


def phase_serve(torch, device, seed: int) -> dict:
    """Phase 5: serve Zamba2-7B (81 slots, d_model 3584) at full size;
    `serve_model` says what is timed and checked."""
    from repro_torch.configs import get_config
    # the CPU rehearsal serves the smoke variant (same family and code path)
    cfg = get_config("zamba2-7b" if device.type == "cuda"
                     else "zamba2-7b-smoke")
    n_groups = cfg.n_layers // cfg.attn_every
    return serve_model(torch, device, seed, "phase 5", cfg, REQUESTS,
                       {"flash_attention_fwd": n_groups,
                        "ssd_scan": cfg.n_layers - n_groups})


# ---------------------------------------------------------------- phase 9

# Yi-9B (arXiv:2403.04652) served at full width and depth on phase 5's
# requests; the other three dense configurations at full width and 2
# layers (the only cut), 1 x 1,000 prompt tokens + 8 new each
DENSE_ARCH = "yi-9b"
DENSE_COVER = ("phi3-medium-14b", "qwen2.5-3b", "starcoder2-15b")
DENSE_COVER_LAYERS = 2
DENSE_COVER_REQUESTS = ((1, 1000, 8),)


def draw_biases_and_norms(model, gen) -> None:
    """The parameters the reference initializes to constants (QKV biases,
    the GELU MLP's biases, norm shifts to zero, norm scales to one, the vlm
    cross layers' gates to zero) drawn from `gen`: N(0, 0.1^2), scales 1 +
    N(0, 0.1^2), gates N(0, 1), so that the bias, LayerNorm and cross
    paths compute with non-trivial values (a zero gate hides its cross
    layer)."""
    import torch
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = parts[-1]
        norm = ".ln" in f".{name}" or parts[0] in ("final_norm",
                                                    "enc_final_norm")
        if parts[0] == "cross_layers" and leaf in ("gate", "mlp_gate") \
                and len(parts) == 3:
            p.data.copy_(torch.randn(p.shape, generator=gen,
                                     device=p.device))
        elif leaf in ("bq", "bk", "bv", "fc_b", "proj_b") or (
                norm and leaf in ("w", "b")):
            x = torch.randn(p.shape, generator=gen, device=p.device) * 0.1
            p.data.copy_(x + (1.0 if leaf == "w" else 0.0))


def phase_dense(torch, device, seed: int) -> dict:
    """Phase 9: the dense family.  Yi-9B at full width and depth (48
    layers, 32 heads over 4 kv heads of 128) through `serve_model` on
    phase 5's requests: 48 `flash_attention_fwd` launches a prefill, all
    on the tensor-core route; then Phi3-medium-14b (g = 4), Qwen2.5-3b (g =
    8, QKV bias, tied embeddings) and StarCoder2-15b (g = 12, QKV bias,
    LayerNorm, GELU) at full width and 2 layers, each on 1 x 1,000 + 8
    tokens with its biases and norm parameters drawn from the seed.
    Returns Yi-9B's main-path launches."""
    import dataclasses
    from repro_torch.configs import get_config
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    # the CPU rehearsal serves the smoke variants (same family and path)
    cfg = get_config(DENSE_ARCH if cuda else DENSE_ARCH + "-smoke")
    launches = serve_model(torch, device, seed, "phase 9", cfg, REQUESTS,
                           {"flash_attention_fwd": cfg.n_layers})
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    for arch in DENSE_COVER:
        if cuda:
            c = dataclasses.replace(get_config(arch),
                                    n_layers=DENSE_COVER_LAYERS)
        else:
            c = get_config(arch + "-smoke")
        serve_model(torch, device, seed, f"phase 9 ({arch}, "
                    f"{c.n_layers} layers)", c, DENSE_COVER_REQUESTS,
                    {"flash_attention_fwd": c.n_layers}, trace=False,
                    draw=draw_biases_and_norms)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(f"phase 9: {time.perf_counter() - t_phase:.3f} s of wall, builds "
          f"included", flush=True)
    return launches


# --------------------------------------------------------------- phase 10

# DeepSeek-V2-Lite (arXiv:2405.04434) served at full width and depth on
# phase 5's requests at the reference's capacity factor; Phi-3.5-MoE at
# full width and 2 of its 32 layers (its 83.7e9 bytes of bf16 weights at
# full depth leave 1.3e9 of the card's 85.0e9), 1 x 1,000 + 8 tokens.  The float32 checks run on
# the 1 x 1,000 request only: DeepSeek-V2-Lite's float32 weights are 62.8
# GB, and a drop-free 4 x 2,048 buffer would add about 15 GB
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_COVER = "phi3.5-moe-42b-a6.6b"
MOE_COVER_LAYERS = 2
MOE_COVER_REQUESTS = ((1, 1000, 8),)
MOE_CHECKS = (1,)          # REQUESTS[1], 1 x 1,000 + 16
MOE_CAPACITY = 1.25        # repro/models/moe.py MoEConfig's default


def drop_free(cfg):
    """`cfg` with the smoke variants' capacity (E / k): no assignment
    drops, so decode (dropless) and the full forward compute the same
    function."""
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)
        / cfg.moe.top_k))


def phase_moe(torch, device, seed: int) -> dict:
    """Phase 10: the moe family.  DeepSeek-V2-Lite at full width and depth
    (27 layers, MLA, 64 routed experts top-6 and 2 shared, layer 0 dense)
    through `serve_model` on phase 5's requests at capacity factor 1.25:
    no kernel on its path (MLA and the experts are plain torch, as in the
    reference), every tensor on the card, the router statistics of each
    prompt, float32 decode vs the full forward within CONSISTENCY_REL on
    the drop-free capacity; then Phi-3.5-MoE at full width and 2 layers
    (GQA: 32 heads over 8 kv heads of 128, 16 experts of 6,400, top-2) on
    1 x 1,000 + 8 tokens: 2 tensor-core `flash_attention_fwd` launches a
    prefill, float32 kernels vs plain too.  Returns Phi-3.5-MoE's
    main-path launches."""
    import dataclasses
    from repro_torch.configs import get_config
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()

    def served(arch):
        # the CPU rehearsal serves the smoke variants (same family and
        # path) at the served capacity factor
        c = get_config(arch if cuda else arch + "-smoke")
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=MOE_CAPACITY))

    cfg = served(MOE_ARCH)
    serve_model(torch, device, seed, "phase 10", cfg, REQUESTS, {},
                checks=MOE_CHECKS, check_cfg=drop_free(cfg))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    c = served(MOE_COVER)
    if cuda:
        c = dataclasses.replace(c, n_layers=MOE_COVER_LAYERS)
    launches = serve_model(torch, device, seed, f"phase 10 ({MOE_COVER}, "
                           f"{c.n_layers} layers)", c, MOE_COVER_REQUESTS,
                           {"flash_attention_fwd": c.n_layers}, trace=False,
                           check_cfg=drop_free(c))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t_phase:.3f} s of wall, builds "
          f"included", flush=True)
    return launches


# --------------------------------------------------------------- phase 11

# Llama-3.2-Vision-11B (hf:meta-llama/Llama-3.2-11B-Vision) served whole on
# phase 5's requests over 1,601 stub image tokens a request; Whisper-base
# (arXiv:2212.04356) whole over 1,500 stub frames, its requests within the
# 448-token text context.  The float32 checks run on the 1 x 1,000 request
# of Llama (39 GB of float32 weights) and on both of Whisper's
VLM_ARCH = "llama-3.2-vision-11b"
ENCDEC_ARCH = "whisper-base"
ENCDEC_REQUESTS = ((LM_BATCH, 64, 384), (1, 16, 64))
VLM_CHECKS = (1,)          # REQUESTS[1], 1 x 1,000 + 16


def frontend_inputs(torch, device, cfg, seed: int):
    """`extra(b)` for `serve_model`: a request's bf16 stub frontend output
    N(0, 1), drawn on the device from `seed` (the reference's specs give
    bf16 `image_embeds` / `frames`)."""
    from repro_torch.models import lm
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    key = lm.CROSS_INPUTS[cfg.family]
    t = cfg.n_frontend_tokens if cfg.family == "vlm" else cfg.enc_seq

    def extra(b):
        return {key: torch.randn((b, t, cfg.d_model), generator=gen,
                                 device=device).to(torch.bfloat16)}
    return extra


def phase_cross(torch, device, seed: int) -> dict:
    """Phase 11: the cross-attending families.  Llama-3.2-Vision-11B at
    full width and depth (40 layers: 8 groups of 4 dense blocks and 1
    gated cross layer, 32 heads over 8 kv heads of 128) through
    `serve_model` on phase 5's requests, each with 1,601 bf16 image
    embeddings: 40 `flash_attention_fwd` launches a prefill (32 causal, 8
    non-causal at T = 1,601), all on the tensor-core route; then
    Whisper-base whole (6 encoder and 6 decoder blocks, 8 heads of 64)
    over 1,500 bf16 frames a request: 18 launches a prefill (6 non-causal
    encoder, 6 causal self, 6 non-causal cross).  Gates, norms and biases
    are drawn from the seed.  Returns each model's main-path launches."""
    from repro_torch.configs import get_config
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    out = {}
    for fam, arch, requests, checks in (
            ("vlm", VLM_ARCH, REQUESTS, VLM_CHECKS),
            ("encdec", ENCDEC_ARCH, ENCDEC_REQUESTS, None)):
        # the CPU rehearsal serves the smoke variants (same family and path)
        cfg = get_config(arch if cuda else arch + "-smoke")
        if fam == "vlm":
            n_groups = cfg.n_layers // cfg.cross_every
            flash = n_groups * (cfg.cross_every - 1) + n_groups
        else:
            flash = cfg.enc_layers + 2 * cfg.n_layers
        out[fam] = serve_model(
            torch, device, seed, f"phase 11 ({arch})", cfg, requests,
            {"flash_attention_fwd": flash}, trace=fam == "vlm",
            draw=draw_biases_and_norms, checks=checks,
            extra=frontend_inputs(torch, device, cfg, seed))
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_phase:.3f} s of wall, builds "
          f"included", flush=True)
    return out


# --------------------------------------------------------------- phase 12

# 12a: Yi-9B (phase 9's weights, rebuilt from the seed) served with the
# int8 KV cache and with bf16 scores on REQUESTS[0]; the reference test's
# bounds (tests/test_perf_variants.py): the first decode step's
# distributions within total variation 0.05 and the same argmax (int8
# cache), the loss within 0.02 (bf16 scores)
QUANT_TV, SCORES_LOSS = 0.05, 0.02
# 12b / 12d: trained whole on TokenPipeline batches of seq 2,048 from a
# synthetic corpus in a session on the card, selected by the reference
# CLI's `quality > 0.1`, at its learning rate 3e-3 (warmup_cosine); the
# batch is reckoned from the card's memory (`train_memory`)
TRAIN_ARCH, TRAIN_SSM_ARCH = "qwen2.5-3b", "mamba2-370m"
TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2048, 5, 3e-3
TRAIN_FILTER = "quality > 0.1"
CARD_BYTES = 80e9
# 12c: full width, 2 layers, a float32 copy: kernels vs plain routes,
# within GRAD_REL of each gradient's largest entry and in norm (|g - g'| /
# |g|); attn_impl="flash"'s backward (the reference's) rounds P, dS, q and
# dO to bf16, so the two forwards' last-bit differences flip roundings that
# compound from layer to layer.  scripts/grad_bounds.py on an H100 (700 W),
# Qwen2.5-3B, seeds 12-19: at most 1.94e-3 entry-wise and 2.54e-3 in norm;
# kernel 11's log-sum-exp shifted by 2^-7 reads 1.58e-2 and 1.20e-2, by
# log 2 0.72 and 0.63.  So the flash route is held to FLASH_REL = 2^-7
# both ways (3x the largest sound reading, below a 2^-7 shift); the exact
# route, at GRAD_REL, also sees a 2^-10 shift (1.9e-3 and 1.5e-3)
GRAD_LAYERS, GRAD_REL, FLASH_REL = 2, 1e-3, 2.0 ** -7
GRAD_BATCH = (1, 1024)
# 12e: the reference CLI's default arch, checkpointed after REPLAY_AT of
# REPLAY_STEPS steps; losses after the replay within REPLAY_REL of the
# uninterrupted run's (no deterministic algorithms: the embedding's
# backward adds with atomics, so the two runs may differ in the last bits)
REPLAY_ARCH, REPLAY_STEPS, REPLAY_AT, REPLAY_REL = ("qwen2.5-3b-smoke", 8, 3,
                                                    1e-3)


def train_memory(n_params: int, tokens: int, cfg) -> dict:
    """The memory reckoning of one training step: the state at 16 bytes a
    parameter (bf16 parameters and gradients, float32 master, mu and nu)
    and, under remat, the activations kept: each block's input (bf16) and
    one block recomputed at a time (its largest tensors, the MLP's
    (tokens, d_ff) products and one KV chunk's float32 score tensors), and
    one loss chunk's float32 logits and their gradient."""
    state = 16.0 * n_params
    per_tok = 2.0 * cfg.d_model * cfg.n_layers
    block = tokens * (8.0 * max(cfg.d_ff, 2 * cfg.d_model)
                      + 4 * 4.0 * cfg.n_heads * min(cfg.kv_chunk, TRAIN_SEQ))
    logits = 2 * 4.0 * tokens / cfg.loss_chunks * cfg.vocab
    return {"state": state, "activations": tokens * per_tok + block + logits}


def loader(torch, device, cfg, batch: int, seed: int):
    """A card session, the synthetic corpus and the pipeline over it, as
    the reference CLI builds them; returns (session, pipeline, the
    selection's launches, its segment routes)."""
    from repro_torch.core import SharkSession
    from repro_torch.data import TokenPipeline, synthetic_corpus
    from repro_torch.kernels import ops
    sess = SharkSession(num_workers=4, max_threads=4, device=device)
    synthetic_corpus(sess, "corpus", cfg.vocab, n_docs=100,
                     mean_doc_len=4 * TRAIN_SEQ, seed=seed)
    before = ops.launch_counts()
    pipe = TokenPipeline(sess, "corpus", TRAIN_SEQ, batch,
                         sql_filter=TRAIN_FILTER, seed=seed)
    sel = {k: v - before[k] for k, v in ops.launch_counts().items()
           if v != before[k]}
    return sess, pipe, sel, sess.metrics().segment_routes()


def train_model(torch, device, seed: int, label: str, cfg, batch: int,
                trace: bool, replan=None) -> dict:
    """`cfg` trained whole for TRAIN_STEPS AdamW steps on TokenPipeline
    batches (`batch` x TRAIN_SEQ): the loss of each step, finite and
    falling (the last below the first), the warm step time and tokens/s,
    a forward alone and the optimizer alone, peak device memory beside
    the reckoning, and the main path's launches (the selection and every
    step, counted from 0), which must include kernel 11 or 12 in the
    forwards.  `replan(step, model, batch)`, if given, runs after each
    step and may return the train step for the steps after it.  Returns
    those launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.training import (AdamWConfig, adamw_update,
                                      init_opt_state, make_eval_step,
                                      make_train_step)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.build_model(cfg, device, torch.Generator(
        device=device).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = batch * TRAIN_SEQ
    need = train_memory(n_params, tokens, cfg)
    print(f"{label}: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters) built in "
          f"{time.perf_counter() - t0:.3f} s; reckoned for batch {batch} x "
          f"{TRAIN_SEQ}: state {need['state']:.4g} bytes (16 a parameter), "
          f"activations about {need['activations']:.4g}, of the card's "
          f"{CARD_BYTES:.3g}", flush=True)
    if cuda and need["state"] + need["activations"] > CARD_BYTES:
        fail(f"{label}: batch {batch} does not fit the card by the "
             f"reckoning")
    # the main path, counted from 0: the corpus's selection, then the steps
    ops.reset_launch_counts()
    sess, pipe, sel, routes = loader(torch, device, cfg, batch, seed)
    print(f"{label}: corpus of {len(pipe.stream)} tokens selected by "
          f"`{TRAIN_FILTER}` on {device}: kernel launches {json.dumps(sel)} "
          f"(rows 1-8 of the kernel table), segment routes "
          f"{json.dumps(routes)}", flush=True)
    opt_state = init_opt_state(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    eval_fn = make_eval_step(cfg)
    # a batch no step trains on: its loss before and after the steps (its
    # launches are not the main path's)
    held = {k: torch.from_numpy(v).to(device)
            for k, v in pipe.batch_at(TRAIN_STEPS).items()}
    counted = ops.launch_counts()
    held_before = float(eval_fn(model, held))
    ops.reset_launch_counts()
    losses, times = [], []
    for step in range(TRAIN_STEPS):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch_at(step).items()}
        t = time.perf_counter()
        model, opt_state, m = step_fn(model, opt_state, b)
        loss = float(m["loss"])
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        print(f"{label}: step {step} loss {loss:.6f} grad_norm "
              f"{float(m['grad_norm']):.4g} lr_scale "
              f"{float(m['lr_scale']):.4g} ({times[-1]:.3f} ms)",
              flush=True)
        if replan is not None:
            step_fn = replan(step, model, b) or step_fn
    launches = {k: v + counted[k] for k, v in ops.launch_counts().items()
                if v + counted[k]}
    sess.shutdown()
    warm = float(np.median(times[1:]))
    t = time.perf_counter()
    held_after = float(eval_fn(model, held))
    fwd = (time.perf_counter() - t) * 1e3
    print(f"{label}: loss of a batch no step trained on {held_before:.6f} "
          f"before the steps, {held_after:.6f} after", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and held_after < held_before):
        fail(f"{label}: losses {losses} (held-out {held_before} -> "
             f"{held_after}) not finite and falling")
    b = held
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda and trace:
        traced(torch, device, f"{label}: one warm training step",
               lambda: step_fn(model, opt_state, b))
    params = {n: p.data for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    sync()
    t = time.perf_counter()
    adamw_update(AdamWConfig(lr=TRAIN_LR), zeros, params, opt_state)
    sync()
    opt_ms = (time.perf_counter() - t) * 1e3
    print(f"{label}: {TRAIN_STEPS} steps of {batch} x {TRAIN_SEQ}: warm step "
          f"{warm:.3f} ms ({tokens / warm * 1e3:.1f} tokens/s), a forward "
          f"alone {fwd:.3f} ms, AdamW alone {opt_ms:.3f} ms, so backward "
          f"and update {1 - fwd / warm:.3f} of the step; loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; peak device memory {peak} "
          f"bytes; launches {json.dumps(launches)}", flush=True)
    del model, opt_state, params, zeros
    return launches


@contextlib.contextmanager
def plain_autograd():
    """Kernels 11 and 12 and their backwards replaced by autograd of their
    plain versions (the model reaches `models.flash.attention` and
    `models.mamba2.ssd_scan` at call time)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models import flash as mf
    from repro_torch.models import mamba2 as mm
    saved = mf.attention, mm.ssd_scan
    mf.attention = (lambda q, k, v, causal, bwd="exact", kv_chunk=1024:
                    kf.flash_attention_fwd_plain(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal).transpose(1, 2))
    mm.ssd_scan = (lambda x, dt, a, b, c, chunk, d:
                   ks.ssd_scan_plain(x, dt, a, b, c, chunk, d))
    try:
        yield
    finally:
        mf.attention, mm.ssd_scan = saved


def grad_gaps(torch, device, seed: int, cfg, impl: str) -> dict:
    """On a float32 copy of `cfg` at GRAD_LAYERS layers (norms and biases
    drawn from `seed`) with `attn_impl=impl`: the loss and every
    parameter's gradient through kernels 11 and 12 against the plain
    routes.  "blockwise" against autograd of the plain forwards; "flash"
    (the reference's hand-written backward) against the same backward
    after the plain forward.  Returns the loss's relative gap, the worst
    gradient's gap relative to its largest entry (and where), and the
    worst |g - g'| / |g|."""
    import dataclasses
    from repro_torch.models import lm
    gen = torch.Generator(device=device).manual_seed(seed)
    c = dataclasses.replace(cfg, n_layers=GRAD_LAYERS, attn_impl=impl)
    model = lm.build_model(c, device, gen)
    draw_biases_and_norms(model, gen)
    model.float()
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(seed)
    b, s = GRAD_BATCH
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                 .astype(np.int32)).to(device)
             for k in ("tokens", "labels")}
    names = [n for n, _ in model.named_parameters()]

    def run():
        loss = lm.loss_fn(c, model, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters()))
    lk, gk = run()
    with (plain_routes() if impl == "flash" else plain_autograd()):
        lp, gp = run()
    worst, where, norm = 0.0, None, 0.0
    for n, a, w in zip(names, gk, gp):
        r = float((a - w).abs().max() / (w.abs().max() + 1e-30))
        norm = max(norm, float((a - w).norm() / (w.norm() + 1e-30)))
        if r > worst:
            worst, where = r, n
    return {"loss_rel": abs(lk - lp) / abs(lp), "grad_rel": worst,
            "at": where, "grad_norm_rel": norm}


def grad_check(torch, device, seed: int, label: str, cfg) -> dict:
    """`grad_gaps` at seed + 12 for each `attn_impl` the family reads:
    the loss within GRAD_REL, the gradients within GRAD_REL entry by entry
    and in norm, or FLASH_REL for "flash".  Returns the gaps."""
    gaps = {}
    impls = ("blockwise", "flash") if cfg.family != "ssm" else ("blockwise",)
    for impl in impls:
        g = gaps[impl] = grad_gaps(torch, device, seed + 12, cfg, impl)
        rel = FLASH_REL if impl == "flash" else GRAD_REL
        if not (g["loss_rel"] < GRAD_REL and g["grad_norm_rel"] < rel
                and g["grad_rel"] < rel):
            fail(f"{label} ({impl}): kernels vs plain loss rel "
                 f"{g['loss_rel']}, gradient rel {g['grad_rel']} at "
                 f"{g['at']}, in norm {g['grad_norm_rel']} (bound {rel})")
        gc.collect()
    b, s = GRAD_BATCH
    print(f"{label}: {cfg.name} at {GRAD_LAYERS} layers, float32, batch "
          f"{b} x {s}: kernels vs plain {json.dumps(gaps)}", flush=True)
    return gaps


def serve_options(torch, device, seed: int) -> None:
    """12a: Yi-9B with the int8 KV cache and with bf16 scores (the
    reference's `kv_int8` and `scores_bf16` variants) on REQUESTS[0]."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    cuda = device.type == "cuda"
    cfg = get_config(DENSE_ARCH if cuda else DENSE_ARCH + "-smoke")
    model = lm.build_model(cfg, device, torch.Generator(
        device=device).manual_seed(seed))
    b, s, _ = REQUESTS[0]
    rng = np.random.default_rng(seed + 6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                            .astype(np.int32)).to(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def serve(c):
        ops.reset_launch_counts()
        t = time.perf_counter()
        logits, caches = lm.prefill_fn(c, model, {"tokens": toks},
                                       s + DECODE_STEPS)
        sync()
        pre = (time.perf_counter() - t) * 1e3
        flash = ops.launch_counts()["flash_attention_fwd"]
        nbytes = sum(v.numel() * v.element_size() for v in caches.values())
        tok = first = torch.argmax(logits[:, -1], -1)[:, None]
        steps, greedy, first_logits = [], [], None
        for i in range(DECODE_STEPS):
            t = time.perf_counter()
            d, caches = lm.decode_fn(c, model, tok, caches, s + i)
            sync()
            steps.append((time.perf_counter() - t) * 1e3)
            if first_logits is None:
                first_logits = d[:, 0].float()
            tok = torch.argmax(d[:, -1], -1)[:, None]
            greedy.append(tok[0, 0].item())
        return {"prefill_ms": pre, "flash_launches": flash,
                "cache_bytes": nbytes,
                "decode_ms": float(np.median(steps[1:])),
                "greedy": greedy, "dtypes": sorted(
                    {str(v.dtype) for v in caches.values()})}, first, \
            first_logits

    base, first, d1 = serve(cfg)
    q8cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    quant, _, _ = serve(q8cfg)
    # the reference test's comparison: one decode step of the prefill's
    # argmax token against each configuration's cache
    _, caches = lm.prefill_fn(q8cfg, model, {"tokens": toks},
                              s + DECODE_STEPS)
    d2, _ = lm.decode_fn(q8cfg, model, first, caches, s)
    del caches
    p1, p2 = torch.softmax(d1, -1), torch.softmax(d2[:, 0].float(), -1)
    tv = float(0.5 * (p1 - p2).abs().sum(-1).max())
    same = bool((d1.argmax(-1) == d2[:, 0].argmax(-1)).all())
    bfcfg = dataclasses.replace(cfg, attn_scores_dtype="bf16")
    scores, _, d3 = serve(bfcfg)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with torch.no_grad():
        l1 = float(lm.loss_fn(cfg, model, batch))
        l2 = float(lm.loss_fn(bfcfg, model, batch))
    ratio = quant["cache_bytes"] / base["cache_bytes"]
    print(f"phase 12a: {cfg.name} {b} x {s} + {DECODE_STEPS}: bf16 cache "
          f"{json.dumps(base)}; int8 cache {json.dumps(quant)} ({ratio:.4f} "
          f"of the bytes), first decode step TV {tv:.4g}, argmax equal "
          f"{same}; bf16 scores {json.dumps(scores)}, loss {l2:.6f} vs "
          f"{l1:.6f}", flush=True)
    if not (tv < QUANT_TV and same):
        fail(f"phase 12a: int8 cache TV {tv} (bound {QUANT_TV}), argmax "
             f"equal {same}")
    if not abs(l1 - l2) < SCORES_LOSS:
        fail(f"phase 12a: bf16 scores loss {l2} vs {l1}, beyond "
             f"{SCORES_LOSS}")
    if cuda and (quant["flash_launches"] != cfg.n_layers
                 or scores["flash_launches"] != 0):
        fail(f"phase 12a: flash launches a prefill {quant['flash_launches']}"
             f" (int8 cache, want {cfg.n_layers}), "
             f"{scores['flash_launches']} (bf16 scores: the plain route, "
             f"want 0)")
    del model


def replay(torch, device, seed: int) -> None:
    """12e: the reference CLI's default arch on the card, checkpointed
    (asynchronously, with the pipeline's manifest) after REPLAY_AT steps;
    the run goes on to REPLAY_STEPS; then a simulated preemption: the
    model and optimizer restored into fresh objects, the pipeline rebuilt
    from the manifest, and the steps from the manifest's step replayed.
    Their losses must equal the uninterrupted run's within REPLAY_REL."""
    import tempfile as tf
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import SharkSession
    from repro_torch.data import TokenPipeline, synthetic_corpus
    from repro_torch.models import lm
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    cfg = get_config(REPLAY_ARCH)
    sess = SharkSession(num_workers=4, max_threads=4, device=device)
    synthetic_corpus(sess, "corpus", cfg.vocab, n_docs=100,
                     mean_doc_len=4 * 64, seed=seed)
    pipe = TokenPipeline(sess, "corpus", 64, 16, sql_filter=TRAIN_FILTER,
                         seed=seed)
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))

    def fresh():
        model = lm.build_model(cfg, device, torch.Generator(
            device=device).manual_seed(seed))
        return model, init_opt_state(dict(model.named_parameters()))

    def batch(p, step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in p.batch_at(step).items()}
    with tf.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        model, opt = fresh()
        straight = []
        for step in range(REPLAY_STEPS):
            if step == REPLAY_AT:
                mgr.save(step, {"params": dict(model.named_parameters()),
                                "opt": opt},
                         {"pipeline": pipe.manifest(step)})
            model, opt, m = step_fn(model, opt, batch(pipe, step))
            straight.append(float(m["loss"]))
        mgr.wait()
        model, opt = fresh()
        params = dict(model.named_parameters())
        restored, manifest = mgr.restore_latest({"params": params,
                                                 "opt": opt})
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(restored["params"][n])
        opt = restored["opt"]
        pipe2 = TokenPipeline.from_manifest(sess, manifest["pipeline"])
        start = manifest["step"]
        replayed = []
        for step in range(start, REPLAY_STEPS):
            model, opt, m = step_fn(model, opt, batch(pipe2, step))
            replayed.append(float(m["loss"]))
        files = len(os.listdir(os.path.join(d, f"step_{start:08d}")))
    sess.shutdown()
    gap = max(abs(a - b) / abs(a) for a, b in zip(straight[start:],
                                                   replayed))
    print(f"phase 12e: {cfg.name}: checkpoint at step {start} ({files} "
          f"files, removed), simulated preemption, replay of steps "
          f"{start}..{REPLAY_STEPS - 1}: losses {replayed} vs uninterrupted "
          f"{straight[start:]}, max rel gap {gap:.3g} (no deterministic "
          f"algorithms)", flush=True)
    if not gap < REPLAY_REL or int(opt["step"]) != REPLAY_STEPS:
        fail(f"phase 12e: replay gap {gap} beyond {REPLAY_REL}, step "
             f"{int(opt['step'])}")


def phase_training(torch, device, seed: int) -> dict:
    """Phase 12: A.5.3's options on Yi-9B (12a), gradients through kernels
    11 and 12 against the plain routes (12c), Qwen2.5-3B (12b) and
    Mamba2-370m (12d) trained whole, a preemption replayed from a
    checkpoint (12e).  Returns the training main paths' launches, summed
    over 12b and 12d."""
    from repro_torch.configs import get_config
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    serve_options(torch, device, seed)
    free()
    for arch in (TRAIN_ARCH, TRAIN_SSM_ARCH):
        grad_check(torch, device, seed, "phase 12c", get_config(
            arch if cuda else arch + "-smoke"))
        free()
    launches = {}
    for label, arch, batch, trace in (("phase 12b", TRAIN_ARCH, 4, True),
                                      ("phase 12d", TRAIN_SSM_ARCH, 8,
                                       False)):
        cfg = get_config(arch if cuda else arch + "-smoke")
        got = train_model(torch, device, seed, label, cfg,
                          batch if cuda else 1, trace)
        kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention_fwd"
        if cuda and not got.get(kernel):
            fail(f"{label}: training never launched {kernel}: {got}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        free()
    replay(torch, device, seed)
    print(f"phase 12: {time.perf_counter() - t_phase:.3f} s of wall, builds "
          f"included; training launches {json.dumps(launches)}", flush=True)
    return launches


# --------------------------------------------------------------- phase 13

# Expert parallelism (moe_impl="ep_shardmap") on Phi-3.5-MoE
# (hf:microsoft/Phi-3.5-MoE-instruct) at full width and 2 of its 32
# layers (83.7e9 bytes of bf16 weights whole leave 1.3e9 of the card's
# 85.0e9, and slots on one card share its memory), over a (data 1, model 4) mesh
# of slots sharing the card: 4 experts a slot.  13a serves phase 5's
# requests at capacity 1.25 (the per-slot capacity drops other
# assignments than moe_apply's); 13b trains 5 AdamW steps of 4 x 2,048
# tokens with the PDE replanner of examples_torch/pde_moe_training.py;
# 13c runs the engine examples on the card and on the CPU
EP_ARCH = MOE_COVER
EP_LAYERS = 2
EP_MESH = (1, 4)
EP_BATCH = 4
EP_REPLAN_AFTER = (2, 4)
EP_EXAMPLES = {
    "quickstart": [r"day=7 rows: (\d+) +\(pruned (\d+)/16",
                   r"^(\d+) groups;", r"^join result: (.*)$",
                   r"COUNT = (\d+) "],
    "sql_ml_pipeline": [r"after 5 iters: accuracy = ([0-9.]+)",
                        r"after failure \+ 10 more iters: accuracy = "
                        r"([0-9.]+)",
                        r"^k-means objective: (.*)$"],
    "multi_tenant": [r"^dashboard: (\d+) errors;"],
}


def ep_slot_drops(p, h, cfg) -> tuple:
    """For one MoE layer's input h under the active mesh: the share of
    assignments each slot of `moe_apply_ep` drops at its own capacity,
    and `moe_apply`'s `frac_dropped` on the same h."""
    from repro_torch.models import moe as moe_mod
    slots, bl, sl, cap = moe_mod.ep_layout(h.shape, cfg.moe)
    shares = []
    for i in range(slots.shape[0]):
        for j in range(slots.shape[1]):
            xf = h[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl]
            _, _, topi = moe_mod._route(xf.reshape(bl * sl, -1), p.router,
                                        cfg.moe.top_k)
            _, keep = moe_mod._slots(topi.reshape(-1), cap)
            shares.append(1.0 - float(keep.float().mean()))
    _, st = moe_mod.moe_apply(p, h, cfg.moe, return_stats=True)
    return shares, float(st["frac_dropped"])


def ep_report(torch, device, label: str, cfg):
    """`serve_model`'s report for 13a: on the bf16 build, each request's
    EP drops by slot and layer beside moe_apply's, then the 4 x 2,048
    prefill with each `moe_impl`: warm (median of 3), busy (traced) and
    peak memory."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def report(model, prompts):
        for (b, s, new), prompt in zip(REQUESTS, prompts):
            toks = torch.from_numpy(prompt).to(device)
            seen, orig = [], moe_mod.moe_apply_ep

            def record(p, x, c, return_stats=False):
                seen.append((p, x))
                return orig(p, x, c, return_stats)
            moe_mod.moe_apply_ep = record
            try:
                with torch.no_grad():
                    lm.prefill_fn(cfg, model, {"tokens": toks}, s + new)
            finally:
                moe_mod.moe_apply_ep = orig
            for layer, (p, h) in enumerate(seen):
                shares, frac = ep_slot_drops(p, h, cfg)
                print(f"{label}: request {b} x {s}, layer {layer}, capacity "
                      f"{cfg.moe.capacity_factor:g}: EP's dropped share by "
                      f"slot {[round(x, 6) for x in shares]} (mean "
                      f"{float(np.mean(shares)):.6g}), moe_apply's "
                      f"frac_dropped {frac:.6g}", flush=True)
            del seen
        b, s, new = REQUESTS[0]
        toks = torch.from_numpy(prompts[0]).to(device)
        for impl in ("ep_shardmap", "gspmd"):
            c = dataclasses.replace(cfg, moe_impl=impl)

            def run():
                with torch.no_grad():
                    return lm.prefill_fn(c, model, {"tokens": toks}, s + new)
            run()
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t = time.perf_counter()
                run()
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            busy = "not measured"
            if cuda:
                peak = torch.cuda.max_memory_allocated()
                rec = traced(torch, device, f"{label}: one prefill, {b} x "
                             f"{s}, moe_impl={impl}", run)
                busy = f"{rec['device_busy_ms']:.3f} ms"
            else:
                peak = 0
            print(f"{label}: moe_impl={impl}: {b} x {s} prefill warm "
                  f"{float(np.median(times)):.3f} ms (median of 3), busy "
                  f"{busy}, peak device memory {peak} bytes", flush=True)
    return report


def ep_grad_check(torch, device, seed: int, label: str, cfg) -> dict:
    """13b's gradient check: a float32 copy of `cfg` at GRAD_LAYERS layers
    (norms and biases drawn), attn_impl="blockwise" (kernel 11's exact
    backward) at the drop-free capacity: the loss and every parameter's
    gradient of EP over the active mesh against moe_apply's, the loss
    within GRAD_REL and each gradient within GRAD_REL in norm."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.parallel import get_abstract_mesh
    mesh = get_abstract_mesh()
    c = drop_free(dataclasses.replace(cfg, n_layers=GRAD_LAYERS,
                                      attn_impl="blockwise"))
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    model = lm.build_model(c, device, gen)
    draw_biases_and_norms(model, gen)
    model.float()
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(seed)
    b, s = GRAD_BATCH
    batch = {k: torch.from_numpy(rng.integers(0, c.vocab, (b, s))
                                 .astype(np.int32)).to(device)
             for k in ("tokens", "labels")}

    def run(impl):
        cc = dataclasses.replace(c, moe_impl=impl)
        loss = lm.loss_fn(cc, model, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters()))
    le, ge = run("ep_shardmap")
    lg, gg = run("gspmd")
    worst, where, norm = 0.0, None, 0.0
    for (n, _), a, w in zip(model.named_parameters(), ge, gg):
        worst_n = float((a - w).abs().max() / (w.abs().max() + 1e-30))
        norm = max(norm, float((a - w).norm() / (w.norm() + 1e-30)))
        if worst_n > worst:
            worst, where = worst_n, n
    gaps = {"loss_rel": abs(le - lg) / abs(lg), "grad_rel": worst,
            "at": where, "grad_norm_rel": norm}
    print(f"{label}: {cfg.name} at {GRAD_LAYERS} layers, float32, batch "
          f"{b} x {s}, capacity {c.moe.capacity_factor:g} (drop-free), "
          f"kernel 11's exact backward: EP over {mesh} vs moe_apply "
          f"{json.dumps(gaps)}", flush=True)
    if not (gaps["loss_rel"] < GRAD_REL and norm < GRAD_REL):
        fail(f"{label}: EP vs moe_apply loss rel {gaps['loss_rel']}, "
             f"gradient rel in norm {norm} beyond {GRAD_REL}")
    del model, ge, gg
    return gaps


def ep_train(torch, device, seed: int, label: str, cfg) -> dict:
    """13b: `cfg` trained through `train_model` (the steps' losses, the
    held-out loss, step time, tokens/s, peak memory, launches) while
    `MoEReplanner` observes each step's expert load (layer 0's router over
    the embedded batch, as examples_torch/pde_moe_training.py observes it)
    and replans after the steps in EP_REPLAN_AFTER, one train step kept
    for each capacity bucket."""
    import dataclasses
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import embed_lookup
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.pde_moe import MoEReplanner
    replanner = MoEReplanner(cfg.moe.num_experts, cfg.moe.top_k)
    steps = {cfg.moe.capacity_factor: None}
    state = {"cf": cfg.moe.capacity_factor}
    tokens = EP_BATCH * TRAIN_SEQ

    def replan(step, model, batch):
        with torch.no_grad():
            x = embed_lookup(model.embed, batch["tokens"])
            _, st = moe_mod.moe_apply(model.layers[0].moe, x, cfg.moe,
                                      return_stats=True)
        replanner.observe(st["expert_load"])
        if step not in EP_REPLAN_AFTER:
            return None
        plan = replanner.plan(tokens)
        changed = plan.capacity_factor != state["cf"]
        print(f"{label}: [PDE] after step {step}: "
              f"{'re-planning' if changed else 'plan unchanged'} — "
              f"{plan.reason}", flush=True)
        state["cf"] = plan.capacity_factor
        if plan.capacity_factor not in steps:
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=plan.capacity_factor))
            steps[plan.capacity_factor] = make_train_step(
                c, AdamWConfig(lr=TRAIN_LR))
        return steps[plan.capacity_factor]
    launches = train_model(torch, device, seed, label, cfg,
                           EP_BATCH if device.type == "cuda" else 1,
                           device.type == "cuda", replan)
    print(f"{label}: the step cache held {len(steps)} capacity variants "
          f"{sorted(steps)}", flush=True)
    return launches


def load_example(name: str):
    import importlib.util
    path = Path(__file__).resolve().parent / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ep_examples(torch, device) -> dict:
    """13c: the engine examples of examples_torch/ run in this process on
    `device` and on the CPU; their answer lines (EP_EXAMPLES) must be
    equal.  Prints each card run's wall and kernel launches; returns the
    launches summed over the card runs."""
    import io
    from repro_torch.kernels import ops
    total = {}
    for name, patterns in EP_EXAMPLES.items():
        mod = load_example(name)
        got = {}
        for dev in (device, torch.device("cpu")):
            buf = io.StringIO()
            before = ops.launch_counts()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(["--device", str(dev)])
            wall = time.perf_counter() - t
            out = buf.getvalue()
            answers = []
            for pat in patterns:
                found = re.findall(pat, out, flags=re.M)
                if len(found) != 1:
                    fail(f"phase 13c: {name} on {dev}: {pat!r} matched "
                         f"{found}")
                answers.append(found[0])
            got[dev.type] = answers
            if dev == device:
                runs = {k: v - before[k] for k, v in ops.launch_counts()
                        .items() if v != before[k]}
                for k, v in runs.items():
                    total[k] = total.get(k, 0) + v
                print(f"phase 13c: {name} on {dev} in {wall:.3f} s: "
                      f"answers {json.dumps(answers)}; kernel launches "
                      f"{json.dumps(runs)}", flush=True)
        if got[device.type] != got["cpu"]:
            fail(f"phase 13c: {name}: answers on {device} {got[device.type]}"
                 f" differ from the CPU's {got['cpu']}")
        print(f"phase 13c: {name}: the card's answers equal the CPU's",
              flush=True)
    return total


def phase_ep(torch, device, seed: int) -> dict:
    """Phase 13: expert parallelism and the examples.  13a serves
    Phi-3.5-MoE at full width and EP_LAYERS layers with
    moe_impl="ep_shardmap" over `make_debug_mesh(*EP_MESH)` (slots
    `[device] * 4`) through `serve_model` on phase 5's requests at
    capacity 1.25: 2 tensor-core flash launches a prefill, every tensor on
    the card, float32 checks at the drop-free capacity (kernels vs plain,
    decode vs full forward, and EP's prefill logits vs moe_apply's), then
    `ep_report`.  13b: the same model and mesh trained (`ep_train`) and
    `ep_grad_check`.  13c: `ep_examples`.  Returns the main paths'
    launches, summed over 13a, 13b and 13c's card runs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import set_mesh
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    base = get_config(EP_ARCH if cuda else EP_ARCH + "-smoke")
    if cuda:
        base = dataclasses.replace(base, n_layers=EP_LAYERS)
    cfg = dataclasses.replace(base, moe_impl="ep_shardmap",
                              moe=dataclasses.replace(
                                  base.moe, capacity_factor=MOE_CAPACITY))
    mesh = make_debug_mesh(*EP_MESH, device=device)
    print(f"phase 13: {cfg.name} at {cfg.n_layers} layers, "
          f"moe_impl={cfg.moe_impl!r} over {mesh}: "
          f"{cfg.moe.num_experts // EP_MESH[1]} experts a slot", flush=True)
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    with set_mesh(mesh):
        add(serve_model(torch, device, seed, "phase 13a", cfg, REQUESTS,
                        {"flash_attention_fwd": cfg.n_layers}, trace=True,
                        draw=draw_biases_and_norms, check_cfg=drop_free(cfg),
                        against=dataclasses.replace(drop_free(cfg),
                                                    moe_impl="gspmd"),
                        report=ep_report(torch, device, "phase 13a", cfg)))
        free()
        got = ep_train(torch, device, seed, "phase 13b", cfg)
        if cuda and not got.get("flash_attention_fwd"):
            fail(f"phase 13b: training never launched flash: {got}")
        add(got)
        free()
        ep_grad_check(torch, device, seed, "phase 13b", cfg)
        free()
    add(ep_examples(torch, device))
    print(f"phase 13: {time.perf_counter() - t_phase:.3f} s of wall, builds "
          f"included; launches {json.dumps(launches)}", flush=True)
    return launches


# --------------------------------------------------------------- phase 14

# 14b holds the dry run against the card on two of the card's own runs:
# Yi-9B whole on phase 9's 4 x 2,048 prefill (caches at its max_seq, 64
# rows for the decode steps) and Qwen2.5-3B whole on one AdamW step of
# phase 12's 4 x 2,048 tokens (lr 3e-3, one microbatch)
DRY_NEW = 64
DRY_PEAK_RTOL = 0.10
# what the card's count must equal of the dry run's
DRY_EQUAL = (("program", "ops"), ("program", "dot_flops_by_dtype"),
             ("program", "elementwise_flops"), ("program", "traffic_bytes"),
             ("program", "kernel_calls"), ("roofline", "wire_bytes"))
# the dry runs' worker processes on the card's machine (spawned; they
# count on the meta device): its 8 cores
DRY_JOBS = 8


def dry_line(rec: dict) -> str:
    """One 14a line: a cell's memory, roofline terms and kernel calls."""
    from repro_torch.launch.roofline import enrich
    e = enrich(rec)
    return (f"phase 14a: {rec['arch']} x {rec['shape']}: peak_bytes "
            f"{rec['memory']['peak_bytes']} (fits {rec['fits']}), compute "
            f"{e['compute_s']:.6g} s, memory {e['memory_s']:.6g} s, "
            f"collective {e['collective_s']:.6g} s, {e['dominant']}-bound, "
            f"useful_ratio {e['useful_ratio']:.4f}, kernel calls "
            f"{json.dumps(rec['program']['kernel_calls'])}, counted in "
            f"{rec['compile_s']:.1f} s")


def dry_check_cell(rec: dict, cfg) -> None:
    """A 14a record's own checks: FLOPs and bytes counted, no wire bytes
    on one card, and the kernels the family's path runs: kernel 11 in
    every train and prefill of a family with GQA layers, kernel 12 in
    those of the ssm and hybrid families, neither in a decode."""
    rl, calls = rec["roofline"], rec["program"]["kernel_calls"]
    cell = f"{rec['arch']} x {rec['shape']}"
    if not (rl["flops"] > 0 and rl["hbm_bytes"] > 0
            and rec["memory"]["peak_bytes"] > 0):
        fail(f"phase 14a: {cell} counted nothing: {json.dumps(rl)}")
    if rl["wire_bytes"] != 0:
        fail(f"phase 14a: {cell} counted wire bytes on one card")
    decode = rec["shape"].startswith(("decode", "long"))
    want = set()
    if not decode and cfg.family != "ssm" and cfg.mla is None:
        want.add("flash_attention_fwd")
    if not decode and cfg.family in ("ssm", "hybrid"):
        want.add("ssd_scan")
    if set(calls) != want:
        fail(f"phase 14a: {cell} called kernels {calls}, expected {want}")


def dry_vs_card(torch, device, label: str, fn, args, meta: dict,
                mflops: float) -> dict:
    """14b on one cell: a warm fn(*args), then one timed at its peak
    memory, then one counted on the device (`launch/cost.analyze`), whose
    counts (`DRY_EQUAL`) must equal the meta dry run's `meta`, with kernel
    11 launched on its tensor-core route as often as the count says, and
    the dry run's peak within `DRY_PEAK_RTOL` of the measured one.
    Returns the counted call's launches."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops
    from repro_torch.launch.cost import H100, analyze
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    out = fn(*args)
    sync()
    del out
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if cuda else None
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    warm_s = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated() if cuda else None
    del out
    gc.collect()
    ops.reset_launch_counts()
    routes = dict(kf.ROUTES)
    _, card = analyze(fn, *args)
    sync()
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    for part, key in DRY_EQUAL:
        if card[part][key] != meta[part][key]:
            a, b = card["cost_analysis_raw"], meta["cost_analysis_raw"]
            diff = {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
                    if a.get(k) != b.get(k)}
            fail(f"phase 14b: {label}: the card counted {part}.{key} "
                 f"{card[part][key]!r}, the dry run {meta[part][key]!r}; "
                 f"ops (card, meta) that differ: {json.dumps(diff)}")
    calls = card["program"]["kernel_calls"].get("flash_attention_fwd", {})
    tc = kf.ROUTES["tensor_core"] - routes["tensor_core"]
    if cuda and not (launched.get("flash_attention_fwd", 0)
                     == calls.get("tensor_core", 0) == tc > 0
                     and set(calls) == {"tensor_core"}):
        fail(f"phase 14b: {label}: flash launched {launched}, {tc} on "
             f"tensor_core, counted {calls}")
    rl = meta["roofline"]
    bound_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    peak = meta["memory"]["peak_bytes"]
    if cuda:
        gap = abs(peak - measured) / measured
        if gap > DRY_PEAK_RTOL:
            fail(f"phase 14b: {label}: the dry run's peak {peak} bytes is "
                 f"{gap:.4f} off the card's {measured}")
        mem = (f"peak {peak} bytes predicted, {measured} measured "
               f"(max_memory_allocated; {held} held before the call), "
               f"rel gap {gap:.6f}")
    else:
        mem = f"peak {peak} bytes predicted, not measured on the CPU"
    print(f"phase 14b: {label}: counts on the {device.type} equal the dry "
          f"run's ({card['program']['ops']} ops, dot FLOPs "
          f"{json.dumps(card['program']['dot_flops_by_dtype'])}, "
          f"elementwise {card['program']['elementwise_flops']:.6g}, "
          f"{card['program']['traffic_bytes']:.6g} HBM bytes, kernel calls "
          f"{json.dumps(card['program']['kernel_calls'])}); {mem}; warm "
          f"{warm_s * 1e3:.3f} ms against the roofline's bound "
          f"{bound_s * 1e3:.3f} ms ({rl['dominant']}: compute "
          f"{rl['compute_s'] * 1e3:.3f}, memory {rl['memory_s'] * 1e3:.3f}); "
          f"model FLOPs {mflops:.6g} / {H100.peak('bfloat16') / 1e12:.0f} "
          f"TFLOP/s / time = {mflops / H100.peak('bfloat16') / warm_s:.4f}"
          + (f" on {card_line()}" if cuda else ""), flush=True)
    return launched


def phase_dryrun(torch, device, seed: int) -> dict:
    """Phase 14: the dry run (`launch/dryrun.py`).  14a counts the 32
    cells of `dryrun.cell_list()` on the meta device in `DRY_JOBS` worker
    processes and prints a line a cell (`dry_line`, `dry_check_cell`).
    14b (`dry_vs_card`): Yi-9B whole on phase 9's prefill and Qwen2.5-3B
    whole on one of phase 12's steps, counted on the card and on meta
    (the CPU rehearsal: their smoke variants at 2 x 256).  Returns 14b's
    launches."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import H100
    from repro_torch.launch.roofline import cell_model_flops
    from repro_torch.launch.specs import build_cell
    from repro_torch.training import AdamWConfig
    cuda = device.type == "cuda"
    t_phase = time.perf_counter()
    b, s = (LM_BATCH, LM_SEQ) if cuda else (2, 256)
    suffix = "" if cuda else "-smoke"
    pre = (get_config(DENSE_ARCH + suffix),
           ShapeConfig("phase9_prefill", "prefill", s, b))
    step = (get_config(TRAIN_ARCH + suffix),
            ShapeConfig("phase12_step", "train", s, b))
    cells = dryrun.cell_list()
    # the CPU rehearsal shares its machine: two processes
    jobs = DRY_JOBS if cuda else 2
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        metas = [pool.submit(dryrun.dry_run, *pre, 1, s + DRY_NEW),
                 pool.submit(dryrun.dry_run, *step)]
        # the train steps first: the longest counts (Zamba2's about 20 s),
        # which submitted last would finish alone
        futs = {c: pool.submit(dryrun.cell_record, *c) for c in sorted(
            cells, key=lambda c: not c[1].startswith("train"))}
        recs, errors = [], []
        for a, sh in cells:
            try:
                recs.append(futs[a, sh].result())
            except Exception as e:      # the worker's error, reported below
                errors.append(f"{a} x {sh}: {e!r}")
        try:
            meta_pre, meta_step = (f.result() for f in metas)
        except Exception as e:          # the worker's error, reported below
            errors.append(f"14b's dry runs: {e!r}")
    if errors:
        fail(f"phase 14a: dry runs failed: {errors}")
    for rec in recs:
        print(dry_line(rec), flush=True)
        dry_check_cell(rec, get_config(rec["arch"]))
    print(f"phase 14a: {len(recs)} cells dry-run on the meta device in "
          f"{time.perf_counter() - t_phase:.3f} s ({jobs} processes); "
          f"{sum(r['fits'] for r in recs)} fit the dry run's capacity of "
          f"{H100.hbm_bytes} bytes", flush=True)
    if cuda:
        # the capacity `fits` compares with, beside the card's own
        total = torch.cuda.get_device_properties(device).total_memory
        print(f"phase 14a: the card's total_memory {total} bytes, the dry "
              f"run's capacity {H100.hbm_bytes} ({total - H100.hbm_bytes:+d})",
              flush=True)
    launches = {}
    gen = torch.Generator(device=device).manual_seed(seed)
    for label, (cfg, shape), meta, kw in (
            (f"{pre[0].name} prefill {b} x {s}, max_seq {s + DRY_NEW}", pre,
             meta_pre, {"max_seq": s + DRY_NEW}),
            (f"{step[0].name} AdamW step of {b} x {s} tokens", step,
             meta_step, {"opt": AdamWConfig(lr=TRAIN_LR)})):
        # the weights drawn from seed 0 on the device (`lm.build_model`),
        # the tokens from the run's seed
        fn, args = build_cell(cfg, shape, device=device, **kw)
        for t in args[-1].values():
            t.random_(0, cfg.vocab, generator=gen)
        got = dry_vs_card(torch, device, label, fn, args, meta,
                          cell_model_flops(cfg, shape))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        del fn, args
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t_phase:.3f} s of wall; "
          f"launches {json.dumps(launches)}", flush=True)
    return launches


def release(torch, device, label: str, after: str) -> None:
    """Free what the last phase left (its models and caches are gone
    with its frame) and the allocator's cache; print the memory held."""
    if device.type == "cuda":
        held = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label}: device memory allocated {held} bytes after "
              f"{after}, {torch.cuda.memory_allocated()} after its release "
              f"({torch.cuda.memory_reserved()} reserved)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=6_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        fail("no CUDA device (run with --device cpu to rehearse)")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, str(src))

    if device.type == "cuda":
        print(card_line(), flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}", flush=True)
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()
        print(f"phase 0: kernels built in {time.perf_counter() - t0:.3f} s",
              flush=True)

    kernels = phase_kernels(torch, device, args.seed)
    kernels.update(phase_kernels_analytics(torch, device, args.seed))
    kernels.update(phase_kernels_lm(torch, device, args.seed))
    sql, data, od, want = phase_sql(torch, device, args.rows, args.seed)
    server = phase_server(torch, device, data, od, want)
    del data, od, want
    storage = phase_storage(torch, device, args.rows, args.seed)
    cluster = phase_cluster(torch, device, args.rows, args.seed)
    launches = {k: v for k, v in sql.items() if k in SQL_KERNELS}
    # phases 3 and 4 keep the SQL phase's ratio to their full sizes
    launches.update(phase_train(torch, device, args.rows * 5 // 3,
                                args.seed))
    launches.update(phase_search(torch, device, args.rows // 6, args.seed))
    launches.update(phase_serve(torch, device, args.seed))
    # phase 5's model and caches are gone with its frame; release the
    # allocator's cache before phase 9 builds Yi-9B
    release(torch, device, "phase 9", "phase 5")
    dense = phase_dense(torch, device, args.seed)
    release(torch, device, "phase 10", "phase 9")
    moe = phase_moe(torch, device, args.seed)
    release(torch, device, "phase 11", "phase 10")
    cross = phase_cross(torch, device, args.seed)
    release(torch, device, "phase 12", "phase 11")
    train = phase_training(torch, device, args.seed)
    release(torch, device, "phase 13", "phase 12")
    ep = phase_ep(torch, device, args.seed)
    release(torch, device, "phase 14", "phase 13")
    dry = phase_dryrun(torch, device, args.seed)
    if device.type == "cuda":
        idle = [k for k, v in launches.items() if v == 0]
        if idle:
            fail(f"kernels never launched on their main path: {idle}")
        if not dense.get("flash_attention_fwd"):
            fail(f"phase 9 never launched flash_attention_fwd: {dense}")
        if not moe.get("flash_attention_fwd"):
            fail(f"phase 10 never launched flash_attention_fwd: {moe}")
        for fam, got in cross.items():
            if not got.get("flash_attention_fwd"):
                fail(f"phase 11's {fam} model never launched "
                     f"flash_attention_fwd: {got}")
        if not ep.get("flash_attention_fwd"):
            fail(f"phase 13 never launched flash_attention_fwd: {ep}")
        if not dry.get("flash_attention_fwd"):
            fail(f"phase 14 never launched flash_attention_fwd: {dry}")
    for name, rec in kernels.items():
        rec["launches"] = launches[name]
        if name in SQL_KERNELS:
            rec["server_launches"] = server[name]
            rec["storage_launches"] = storage[name]
        if name in cluster:
            rec["cluster_launches"] = cluster[name]
        if name in dense:
            rec["dense_launches"] = dense[name]
            rec["gqa"]["launches"] = dense[name]
        if name in moe:
            rec["moe_launches"] = moe[name]
        if name in cross["vlm"]:
            rec["vlm_launches"] = cross["vlm"][name]
            rec["encdec_launches"] = cross["encdec"][name]
            rec["cross"]["launches"] = cross["vlm"][name]
        # phase 12's training main paths (12b and 12d, the SQL selection
        # of their corpora included)
        rec["train_launches"] = train.get(name, 0)
        # phase 13's main paths (13a's generate, 13b's selection and steps,
        # 13c's card runs)
        rec["ep_launches"] = ep.get(name, 0)
        # phase 14b's counted card runs (the Yi-9B prefill, the Qwen2.5-3B
        # step)
        rec["dry_launches"] = dry.get(name, 0)
    kernels["colscan"]["two_columns"]["launches"] = \
        sql["colscan.two_columns"]
    kernels["bitpack_decode"]["batched"]["launches"] = \
        launches["bitpack_decode"]
    kernels["rle_decode"]["into"]["launches"] = launches["rle_decode"]
    kernels["topk_similarity"]["lanes"]["launches"] = \
        launches["topk_similarity"]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": torch.cuda.device_count()}
    else:
        dev = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0}
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
