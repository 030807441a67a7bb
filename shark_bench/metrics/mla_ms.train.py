"""mla_ms.train: device milliseconds a traced training step of the
operations the host launched inside the program's spans
`repro_torch.attn.mla`: multi-head latent attention's projections, RoPE,
chunked softmax and output, in the forward and in the checkpointed
recompute of the backward."""

from shark_bench.metrics._spans import device_ms


def read(rec):
    return device_ms(rec, "train", "attn.mla")
