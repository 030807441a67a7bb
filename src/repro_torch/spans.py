"""Named spans over the phases of the trainer and the serving engine.

`span(name)` marks one phase: a data batch's draw (`data.batch`), a
training step's forward, backward and optimizer (`train.forward`,
`train.backward`, `train.optimizer`), and a served batch's prefill, each
decode step and the copy of its tokens to the host (`serve.prefill`,
`serve.decode`, `serve.to_host`).  Under any `torch.profiler` session the
span is a `record_function` range named `repro_torch.<name>`: the profiler
keeps it beside the host's operations and writes it out with its trace, on
the clock of the device's kernels, so that each kernel can be credited to
the span in which the host launched it (the backward's kernels, launched
by autograd's own thread, start while the calling thread is inside
`train.backward`).  Without a profiler a span costs one check and records
nothing.  A span carries no value read from the device, so it adds no wait
for the device.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the phase `name` for a running
    profiler, and does nothing without one."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
