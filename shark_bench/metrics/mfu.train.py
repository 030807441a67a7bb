"""mfu.train: model FLOPs of the training steps the measured window
completed (yardstick.train_flops: the forward, the head at every position,
and a backward at twice the forward) over the window times 989 TFLOP/s."""

from shark_bench import yardstick
from shark_bench.metrics._common import mfu


def read(rec):
    return mfu(rec, "train", yardstick.train_flops)
