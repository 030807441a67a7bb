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


def one_device(*tensors: torch.Tensor) -> None:
    """Raises unless every tensor lies on one device (a fake
    implementation's check: the dispatcher sends a meta and a CPU operand
    to it together)."""
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"kernel operands on mixed devices: {devices}")


def check_cuda_operand(t: torch.Tensor, name: str, n: int = None) -> None:
    if t.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")


_COUNT_LOCK = threading.Lock()


def stream_ticket(tickets: dict, device: torch.device, stream: int,
                  name: str, numel: int = 1,
                  dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The fold ticket in `tickets` of `stream` (a raw handle) on `device`,
    for a kernel whose last block folds the others' partials: one int32
    zero, allocated at the first call on that stream (not inside a CUDA
    graph capture: warm a call up on the capturing stream first); each
    launch leaves it at 0 again.  Overlapping calls on two streams would
    race on one shared word; calls on one stream run in order.  A kernel
    that keeps more state between its blocks (radix.cu's look-back words)
    asks for `numel` zeros of `dtype`, always the same `numel`: the most
    any of its calls needs, so the tensor is never replaced and a graph
    captured later never holds a freed pointer."""
    key = (device.index, stream)
    t = tickets.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}'s first call on a stream must come "
                               f"before a CUDA graph capture on it")
        # setdefault: of two threads' first calls, both launch on one tensor
        t = tickets.setdefault(key, torch.zeros(numel, dtype=dtype,
                                                device=device))
    if t.numel() != numel or t.dtype != dtype:
        raise ValueError(f"{name}'s stream words are {t.numel()} x "
                         f"{t.dtype}, asked for {numel} x {dtype}")
    return t


def count_launch(launches: dict, name: str) -> None:
    """Add one to kernel `name`'s launch count in its module's `LAUNCHES`
    (wrappers run on executor threads, so the increment takes a lock)."""
    with _COUNT_LOCK:
        launches[name] += 1


# cuda.h's CUgraphNodeType, by name
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty"}


def graph_nodes(fn) -> dict:
    """The work one warm `fn()` puts on the card, as the nodes of a CUDA
    graph captured around the call, counted by type through libcuda's
    cuGraphGetNodes: a call that runs one kernel and nothing else is
    {"kernel": 1}.  (On the card torch.profiler has missed a kernel's
    record late in a long run; the graph sees every launch.)"""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    # warmed up on the stream that captures (train_grad's fold ticket is
    # allocated per stream at its first call there)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    rc = rc or cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        rc = rc or cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind))
        name = GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}")
        kinds[name] = kinds.get(name, 0) + 1
    del graph
    torch.cuda.synchronize()
    if rc:
        raise RuntimeError(f"reading a CUDA graph's nodes failed: CUresult "
                           f"{rc}")
    return kinds
