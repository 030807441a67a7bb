"""decode_idle_ms.prefill: milliseconds a traced batch in which the device
ran nothing while the host was inside the program's spans
`repro_torch.serve.decode`."""

from shark_bench.metrics._spans import idle_ms


def read(rec):
    return idle_ms(rec, "prefill", "serve.decode")
