"""device_idle_share.train: the share of the traced training steps' window
in which no kernel or copy ran on the card."""

from shark_bench.metrics._common import idle_share


def read(rec):
    return idle_share(rec, "train")
