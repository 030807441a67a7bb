"""Batched serving on the PyTorch port: prefill + KV-cache decode on a
reduced config, the reference's `examples/serve_lm.py` over
`repro_torch.launch.serve` with its arguments.

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]

It serves on the card unless `--device cpu` is given, and raises without
one; further arguments go to the launcher (`--arch`, `--batch`, ...).
"""

import sys

from repro_torch.launch.serve import main as serve


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve(["--arch", "yi-9b-smoke", "--batch", "8",
                  "--prompt-len", "32", "--new-tokens", "48"] + argv)


if __name__ == "__main__":
    main()
