"""batch_ms.train: the data pipeline's host time a step in the measured
window: `TokenPipeline.batch_at(step)` and the copy of its batch to the
card issued from pinned memory, on the host's clock, averaged over the
window's steps."""


def read(rec):
    ms = rec.extra.get("batch_ms")
    if rec.kind != "train" or not ms:
        return None
    return sum(ms) / len(ms)
