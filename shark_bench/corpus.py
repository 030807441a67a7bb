"""The training corpus, made from the seed, and the plain form of what the
program's SQL-fed pipeline serves from it.

`draw` makes the corpus table's columns, one row per token:
doc int64, pos int32, tok int32, quality float32 (the draws of the
program's `data.synthetic_corpus`, copied here so that the program's
version can change without moving the data).  The program loads them into
its session and selects with SQL; `plain_stream` and `plain_batch` are the
reference's side: the same selection with numpy, and the batch of a step by
the pipeline's documented rule (offsets drawn by a counter-based generator
keyed by (seed, step); tokens the S rows from each offset, labels the S
rows one further).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def draw(vocab: int, n_docs: int, mean_doc_len: int, seed: int
         ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lens = np.maximum(8, rng.poisson(mean_doc_len, n_docs))
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    pos = np.concatenate([np.arange(l, dtype=np.int32) for l in lens])
    tok = (rng.zipf(1.3, size=len(doc)) % vocab).astype(np.int32)
    quality = np.repeat(rng.uniform(0, 1, n_docs).astype(np.float32), lens)
    return {"doc": doc, "pos": pos, "tok": tok, "quality": quality}


def plain_stream(cols: Dict[str, np.ndarray], min_quality: float
                 ) -> np.ndarray:
    """The selected tokens in table order (`quality > min_quality`)."""
    return cols["tok"][cols["quality"] > np.float32(min_quality)]


def plain_batch(stream: np.ndarray, seq: int, batch: int, seed: int,
                step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step,)))
    offs = rng.integers(0, max(len(stream) - seq - 1, 1), batch)
    return {"tokens": np.stack([stream[o:o + seq] for o in offs]),
            "labels": np.stack([stream[o + 1:o + seq + 1] for o in offs])}
