"""device_idle_share.prefill: the share of the traced batches' window in
which no kernel or copy ran on the card."""

from shark_bench.metrics._common import idle_share


def read(rec):
    return idle_share(rec, "prefill")
