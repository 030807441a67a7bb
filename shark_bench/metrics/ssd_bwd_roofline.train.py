"""ssd_bwd_roofline.train: the SSD scan backward's least time (ssd_bwd_cost,
one backward a layer a traced training step) over the device time of the
kernels that implement it, matched by PATTERN."""

import re

from shark_bench.metrics._common import roofline

# kernel 12b's route on the card (csrc/ssd_bwd.cu: ssd_bwd_tc)
PATTERN = re.compile(r"ssd_bwd")


def read(rec):
    return roofline(rec, "train", "ssd_bwd", PATTERN)
