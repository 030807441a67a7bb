"""mfu.prefill: model FLOPs of the prefills the measured window completed
(yardstick.prefill_flops: the forward, the head at each prompt's last
position) over the window times 989 TFLOP/s."""

from shark_bench import yardstick
from shark_bench.metrics._common import mfu


def read(rec):
    return mfu(rec, "prefill", yardstick.prefill_flops)
