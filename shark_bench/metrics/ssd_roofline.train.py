"""ssd_roofline.train: as ssd_roofline.prefill, over the traced training
steps: one forward scan a layer a step is the work; the kernel's device
time includes the forward that the backward's recomputation runs again.
The scan's backward is plain PyTorch and is not matched."""

import re

from shark_bench.metrics._common import mixer_roofline

PATTERN = re.compile(r"ssd_fwd")


def read(rec):
    return mixer_roofline(rec, "train", "ssm", PATTERN)
