"""ssd_roofline.prefill: the SSD scan's least time (ssd_cost, each layer of
each traced batch) over the device time of the kernels that implement it,
matched by PATTERN."""

import re

from shark_bench.metrics._common import roofline

# kernel 12's two routes (csrc/ssd.cu: ssd_fwd_tc, ssd_fwd)
PATTERN = re.compile(r"ssd_fwd")


def read(rec):
    return roofline(rec, "prefill", "ssd_fwd", PATTERN)
