"""Shared checks for the kernel wrappers: a wrapper takes its plain
version for CPU tensors only, and for CUDA tensors launches its kernel or
raises — it never falls back.

Wrappers allocate outputs and scratch with torch and launch on the
current stream without synchronising.  Scratch may be freed while the
kernel still runs: PyTorch's caching allocator hands a freed block out
again only in that stream's order."""

from __future__ import annotations

import threading

import torch

THREADS = 256          # threads per block in every csrc/ kernel
MAX_BLOCKS = 1056      # 8 resident blocks on each of the H100's 132 SMs


def grid_blocks(n: int, rows_per_thread: int = 4,
                max_blocks: int = MAX_BLOCKS) -> int:
    """Blocks of a grid-stride launch over n rows: a function of n only, so
    the order of a kernel's fixed-order folds is the same on every run."""
    return max(1, min(max_blocks, -(-int(n) // (THREADS * rows_per_thread))))


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when every tensor lies on one CUDA device (the kernel runs);
    raises on anything else."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel operands on mixed devices: {devices}")
    return False


def check_cuda_operand(t: torch.Tensor, name: str, n: int = None) -> None:
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")


_COUNT_LOCK = threading.Lock()


def count_launch(launches: dict) -> None:
    """Add one to a wrapper's launch count (wrappers run on executor
    threads, so the increment takes a lock)."""
    with _COUNT_LOCK:
        launches["count"] += 1
