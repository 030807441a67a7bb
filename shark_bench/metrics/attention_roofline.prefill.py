"""attention_roofline.prefill: causal attention's least time (the larger of
flash_cost's FLOPs over 989 TFLOP/s and its bytes over 3.35 TB/s, each
layer of each traced batch) over the device time of the kernels that
implement it, matched by PATTERN."""

import re

from shark_bench.metrics._common import roofline

# kernel 11's two routes (csrc/flash.cu: flash_fwd_tc, flash_fwd_simt)
PATTERN = re.compile(r"flash_fwd")


def read(rec):
    return roofline(rec, "prefill", "flash_fwd", PATTERN)
