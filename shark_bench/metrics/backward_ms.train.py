"""backward_ms.train: device milliseconds a traced training step of the
operations the host launched inside the program's span
`repro_torch.train.backward`."""

from shark_bench.metrics._spans import device_ms


def read(rec):
    return device_ms(rec, "train", "train.backward")
