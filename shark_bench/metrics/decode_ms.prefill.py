"""decode_ms.prefill: device milliseconds a traced batch of the operations
the host launched inside the program's spans `repro_torch.serve.decode`
(each decode step and its sample)."""

from shark_bench.metrics._spans import device_ms


def read(rec):
    return device_ms(rec, "prefill", "serve.decode")
