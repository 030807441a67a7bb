"""moe_route_ms.train: device milliseconds a traced training step of the
operations the host launched inside the program's spans
`repro_torch.moe.route`: the MoE router's product, its scores, the choice
and the grouping of the held experts' assignments, in the forward and in
the checkpointed recompute of the backward."""

from shark_bench.metrics._spans import device_ms


def read(rec):
    return device_ms(rec, "train", "moe.route")
