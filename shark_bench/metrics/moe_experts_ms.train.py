"""moe_experts_ms.train: device milliseconds a traced training step of the
operations the host launched inside the program's spans
`repro_torch.moe.experts`: the held experts' grouped products, the shared
experts and the combine, in the forward and in the checkpointed recompute
of the backward."""

from shark_bench.metrics._spans import device_ms


def read(rec):
    return device_ms(rec, "train", "moe.experts")
