"""Training data on top of the Shark engine: the reference's
`repro/data/pipeline.py` on the port's `SharkSession` (the unification
the paper argues for in §4: SQL selects the data, the same engine feeds
the model).

A corpus is a columnar table with one row per token:

    corpus(doc: int64, pos: int32, tok: int32, quality: float32)

The store compresses each block as it chooses (at the default sizes
`doc` and `quality` run-length encode and `tok` dictionary encodes), and
partition statistics on `doc` / `quality` let a filtered select prune
partitions.  The selection is a filter and a projection with no
aggregate: on a session on the card it runs on the engine's `jit` route
(the compiled expression set, in PyTorch), and phase 12 of
`chip_smoke.py` counts no launch of the hand-written kernels 1-8 (the
scans, group-bys and decodes of PERF.md's table) on an H100.

`TokenPipeline` runs one SQL selection (a quality filter, say) through
the engine, keeps the selected token stream on the host, and serves
deterministic batches: `batch_at(step)` is a pure function of (corpus,
filter, seed, step), numpy int32 arrays identical to the reference's for
the same corpus.  The checkpoint manifest stores (table, filter, step),
so a restart replays from there (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core.columnar import Table
from ..core.session import SharkSession
from ..core.types import DType, Schema
from ..spans import span


def synthetic_corpus(session: SharkSession, name: str, vocab: int,
                     n_docs: int = 200, mean_doc_len: int = 512,
                     seed: int = 0, num_partitions: int = 8) -> Table:
    """Generate and load a synthetic tokenized corpus into the memory
    store: the reference's draws, from a numpy generator of `seed`."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(8, rng.poisson(mean_doc_len, n_docs))
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    pos = np.concatenate([np.arange(l, dtype=np.int32) for l in lens])
    # zipf-ish token distribution, bounded to vocab
    tok = (rng.zipf(1.3, size=len(doc)) % vocab).astype(np.int32)
    quality = np.repeat(rng.uniform(0, 1, n_docs).astype(np.float32), lens)
    schema = Schema.of(doc=DType.INT64, pos=DType.INT32, tok=DType.INT32,
                       quality=DType.FLOAT32)
    return session.create_table(
        name, schema,
        {"doc": doc, "pos": pos, "tok": tok, "quality": quality},
        num_partitions=num_partitions)


@dataclasses.dataclass
class PipelineManifest:
    table: str
    sql_filter: Optional[str]
    seq_len: int
    global_batch: int
    seed: int
    step: int


class TokenPipeline:
    """SQL-selected, deterministic training batches.

    batch_at(step) is a pure function of (corpus, filter, seed, step):
    restartable mid-epoch from the manifest, and the same on every host."""

    def __init__(self, session: SharkSession, table: str, seq_len: int,
                 global_batch: int, sql_filter: Optional[str] = None,
                 seed: int = 0):
        self.session = session
        self.table = table
        self.sql_filter = sql_filter
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        where = f" WHERE {sql_filter}" if sql_filter else ""
        res = session.sql_np(f"SELECT tok FROM {table}{where}")
        self.stream = np.asarray(res["tok"], dtype=np.int32)
        if len(self.stream) < seq_len + 1:
            reps = (seq_len + 1) // max(len(self.stream), 1) + 1
            self.stream = np.tile(self.stream, reps)

    @property
    def tokens_per_batch(self) -> int:
        return self.seq_len * self.global_batch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch: offsets drawn from a counter-based RNG keyed
        by (seed, step) — replayable after restart, no cursor state.  Under
        a profiler the draw is the span `repro_torch.data.batch`."""
        with span("data.batch"):
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=self.seed, spawn_key=(step,)))
            n = len(self.stream) - self.seq_len - 1
            offs = rng.integers(0, max(n, 1), self.global_batch)
            toks = np.stack([self.stream[o:o + self.seq_len] for o in offs])
            labels = np.stack([self.stream[o + 1:o + self.seq_len + 1]
                               for o in offs])
            return {"tokens": toks.astype(np.int32),
                    "labels": labels.astype(np.int32)}

    def manifest(self, step: int) -> Dict:
        return dataclasses.asdict(PipelineManifest(
            self.table, self.sql_filter, self.seq_len, self.global_batch,
            self.seed, step))

    @staticmethod
    def from_manifest(session: SharkSession, m: Dict) -> "TokenPipeline":
        return TokenPipeline(session, m["table"], m["seq_len"],
                             m["global_batch"], m["sql_filter"], m["seed"])
