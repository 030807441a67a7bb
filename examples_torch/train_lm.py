"""End-to-end LM training on the PyTorch port: SQL-selected corpus ->
columnar pipeline -> train a reduced qwen2.5 config for a few hundred
steps with checkpointing and a simulated preemption + restart.  The
reference's `examples/train_lm.py` over `repro_torch.launch.train` with
its arguments.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] \
        [--device cpu]

It trains on the card unless `--device cpu` is given, and raises without
one; further arguments go to the launcher.  Checkpoints go under the
temporary directory (`--ckpt-dir` to choose).
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main as train


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return train(["--arch", "qwen2.5-3b-smoke",
                  "--steps", "300", "--seq-len", "64", "--batch", "16",
                  "--lr", "3e-3", "--ckpt-every", "100",
                  "--simulate-preemption", "150",
                  "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                             "repro_example_ckpt")] + argv)


if __name__ == "__main__":
    main()
