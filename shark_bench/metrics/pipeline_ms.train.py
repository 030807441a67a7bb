"""pipeline_ms.train: host milliseconds a traced training step inside the
program's span `repro_torch.data.batch`: `TokenPipeline.batch_at`'s draw,
without the benchmark's copy of the batch to the card."""

from shark_bench.metrics._spans import host_ms


def read(rec):
    return host_ms(rec, "train", "data.batch")
