"""ssd_roofline.train: as ssd_roofline.prefill, over the traced training
steps: one forward scan a layer a step is the work; the kernel's device
time includes the forward that the backward's recomputation runs again.
The scan's backward (kernel 12b, ssd_bwd) is ssd_bwd_roofline.train's."""

import re

from shark_bench.metrics._common import roofline

PATTERN = re.compile(r"ssd_fwd")


def read(rec):
    return roofline(rec, "train", "ssd_fwd", PATTERN)
