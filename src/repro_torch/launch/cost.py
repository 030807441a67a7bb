"""The cost count of the port's own program: the counterpart of the
reference's `launch/hlo_cost.py` and `launch/hlo_analysis.py`.

The reference lowers a cell to HLO and walks the text.  The port has no
compiled program to read, so it counts the program as it runs: a
`CostCounter` is a `TorchDispatchMode` that sees every aten operation the
program dispatches, on any device.  On the `meta` device nothing is
allocated and nothing is launched, so a cell of any size is counted on a
machine without a card (`launch/dryrun.py`); on the card or the CPU the
same program dispatches the same operations, and the counts agree.

Per operation (first order, as `hlo_cost.py` counts):
  - dot FLOPs: `torch.utils.flop_counter`'s formulas (2 numel(result) K
    for mm, bmm, addmm, baddbmm, convolution and the attention ops), kept
    by the dtype of the first operand, since the card's peak depends on it;
  - elementwise FLOPs: numel(result) of every other operation that
    computes (a copy, a cast, a gather or a scatter moves and counts 0);
  - HBM traffic: the bytes of each operand and each result at the
    operation's boundary.  Views and other metadata operations count 0.
    A write-only operand (`copy_`'s destination, `out=`) counts once, and
    an in-place scatter into a buffer (`index_put_`, `scatter_add_`)
    counts what it writes, not the buffer, as `hlo_cost.py` counts a
    dynamic-update-slice;
  - the scope: `attention`, `moe` or `mamba` where the operation runs
    inside a function the model marks with `models/common.named_scope`
    (the reference's `jax.named_scope` sites), `<scope>_bwd` in that
    function's backward, `backward_other` elsewhere in the backward,
    `other` elsewhere.  A forward recomputed in the backward
    (`torch.utils.checkpoint`) counts under its forward scope, as a
    rematerialized region of the reference keeps its scope;
  - collective wire bytes, where expert parallelism's exchange
    (`models/moe.moe_apply_ep`, `models/common.exchange`) moves tensors
    between mesh slots: the reference's ring model of an all-to-all,
    result_bytes (n - 1) / n, summed over the slots, in the forward and
    again in the backward.

The LM kernels count as one operation each (`kernel_calls`), with the
bytes and FLOPs of their formulas (`flash_cost`, `ssd_cost`, and
`ssd_bwd_cost` for the SSD scan's backward, whose `plain` route, the
float32 VJP, is counted by the kernel's formula at float32's peak) on the
route the card takes: each wrapper call is one operator
(`torch.ops.repro_torch.*`, with an implementation for each device), so
the counter sees it once, and whatever it runs inside (its output
allocations on the card, the plain version on the CPU, the empty outputs
on meta) runs below the counter, unseen.  Operations on tensors of other devices
than the program's (the host's copy of an RNG state) are not counted.

`LiveBytes` follows the program's memory: each storage the program
holds (its arguments, and whatever an operation reads or makes) adds its
size, rounded up to 512 bytes as the CUDA caching allocator rounds a
block, until its last reference dies (saved autograd tensors live as
long as the graph keeps them).  Its peak is what the card would hold at
most; the caching allocator's own slack (a large block not split) is not
modelled.  A tensor made from Python data (`lift_fresh`) is the host's
work: a CUDA device sees it as a copy, the meta device not at all, so it
is not counted as an operation.

The hardware model is `H100`: the data sheet's peaks of one H100 SXM at
its 700 W limit.  The float32 rate outside the tensor cores is kept
apart from the bf16 tensor-core rate because the port runs float32
products (MLA's scores, the exact attention backward): one bf16 peak
would put their bound 15x too low.  NVLink's rate is the data sheet's
and is unmeasured: a one-card run has no NVLink traffic to time.

`analyze(fn, *args)` runs fn(*args) under a counter and returns its
result and the reference's record: `roofline`, `program` and `memory`.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.autograd.graph import register_multi_grad_hook
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attention import flash_route
from ..kernels.ssd_scan import ssd_bwd_route, ssd_route

# the SSD kernels walk the sequence in tiles of 64 rows (csrc/ssd.cu)
SSD_TILE = 64
# the CUDA caching allocator rounds every block up to a multiple of this
BLOCK_BYTES = 512


@dataclasses.dataclass(frozen=True)
class Roofline:
    """A card's peaks: dot FLOP/s by operand dtype (`vector_flops` for
    the rest, and for a dtype the table lacks), HBM bytes/s and its
    capacity in bytes, the interconnect's bytes/s each way, at
    `power_w`."""
    name: str
    dot_flops: Dict[str, float]
    vector_flops: float
    hbm_bytes_per_s: float
    hbm_bytes: int
    link_bytes_per_s: float
    power_w: float

    def peak(self, dtype: str) -> float:
        """Dot FLOP/s for operands of `dtype` (a torch dtype's name)."""
        return self.dot_flops.get(dtype, self.vector_flops)

    def compute_s(self, dot_flops: Dict[str, float],
                  elementwise_flops: float) -> float:
        return (sum(f / self.peak(dt) for dt, f in dot_flops.items())
                + elementwise_flops / self.vector_flops)

    def bound_ms(self, nbytes: float, ops: float, dtype: str = "float32"
                 ) -> Tuple[float, str]:
        """The least time (ms) of a kernel that moves `nbytes` and does
        `ops` operations on `dtype` operands, and which of the two bounds
        it: "bytes" or "operations"."""
        t_bytes = nbytes / self.hbm_bytes_per_s * 1e3
        t_ops = ops / self.peak(dtype) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


# NVIDIA's H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 and fp16 on
# the tensor cores, 495 TF32, 67 TFLOP/s float32 outside them (also
# taken for float64 and integer work, which the table does not list),
# HBM3 at 3.35 TB/s, NVLink 4 at 450 GB/s each way.  The capacity is not
# the data sheet's "80 GB" (80 GiB of HBM3, some of it reserved) but what
# torch reports as an H100 80GB HBM3's total_memory (`chip_smoke.py`
# phase 14a prints the card's own beside it)
H100 = Roofline(
    name="H100 SXM", dot_flops={"bfloat16": 989e12, "float16": 989e12,
                                "float32": 67e12},
    vector_flops=67e12, hbm_bytes_per_s=3.35e12,
    hbm_bytes=85_017_493_504, link_bytes_per_s=450e9, power_w=700.0)


# ---------------------------------------------------------------------------
# The two LM kernels' formulas
# ---------------------------------------------------------------------------

def flash_cost(b, h, s, hd, itemsize, kv=None, t=None, causal=None):
    """(bytes, flops) of attention: q and k, v (kv heads, default h; t
    rows, default s) read and o written once; two hd-long dot products
    per (row, col) pair of each query head, col <= row where causal (by
    default: when t is None), every col of t otherwise."""
    kv = h if kv is None else kv
    causal = t is None if causal is None else causal
    t = s if t is None else t
    # causal rows see min(row + 1, t) cols
    pairs = (min(s, t) * (min(s, t) + 1) / 2 + max(s - t, 0) * t
             if causal else float(s) * t)
    return ((2.0 * h * s + 2.0 * kv * t) * b * hd * itemsize,
            4.0 * b * h * hd * pairs)


def ssd_cost(b, s, h, p, n, itemsize, groups: int = 1):
    """(bytes, flops) of the SSD scan with 64-row tiles: x, B, C (x's
    dtype; `groups` B and C a row) and dt read once, y (x's dtype) and the
    float32 final state written once, a and d read; per row and head the
    causal halves of C B^T and M x, C . state and the state update."""
    nbytes = (2.0 * b * s * h * p + 2.0 * b * s * groups * n) * itemsize \
        + 4.0 * b * s * h + 4.0 * b * h * p * n + 8.0 * h
    flops = 2.0 * b * s * h * (SSD_TILE / 2 * (n + p) + 2.0 * n * p)
    return nbytes, flops


def ssd_bwd_cost(b, s, h, p, n, itemsize, groups: int = 1):
    """(bytes, flops) of the SSD scan's backward with 64-row tiles: x, dy
    and dx (x's dtype), B, C, dB and dC (`groups` a row), dt and ddt, and
    the float32 dstate each moved once, a and d read, da and dD written;
    per row and head the causal halves of C B^T, dy x^T, dG B, dG^T C and
    M^T dy, and five N x P products (the rebuilt state, B dh^T, x dh,
    dy h and dh's update)."""
    nbytes = (3.0 * b * s * h * p + 4.0 * b * s * groups * n) * itemsize \
        + 8.0 * b * s * h + 4.0 * b * h * p * n + 16.0 * h
    flops = 2.0 * b * s * h * (SSD_TILE / 2 * (3.0 * n + 2.0 * p)
                               + 5.0 * n * p)
    return nbytes, flops


def _flash_call(q, k, v, causal, return_lse):
    b, h, s, hd = (int(x) for x in q.shape)
    kv, t = int(k.shape[1]), int(k.shape[2])
    nbytes, flops = flash_cost(b, h, s, hd, q.element_size(), kv, t, causal)
    return (flash_route(q.dtype, hd),
            nbytes + (4.0 * b * h * s if return_lse else 0.0), flops)


def _ssd_call(x, dt, a, b, c, chunk, d):
    bsz, s, h, p = (int(v) for v in x.shape)
    n = int(b.shape[-1])
    groups = int(b.shape[2]) if b.dim() == 4 else 1
    return (ssd_route(x.dtype, p, n),
            *ssd_cost(bsz, s, h, p, n, x.element_size(), groups))


def _ssd_bwd_call(x, dt, a, b, c, d, chunk, dy, dstate):
    bsz, s, h, p = (int(v) for v in x.shape)
    n = int(b.shape[-1])
    groups = int(b.shape[2]) if b.dim() == 4 else 1
    return (ssd_bwd_route(x.dtype, p, n),
            *ssd_bwd_cost(bsz, s, h, p, n, x.element_size(), groups))


# a kernel's operator name -> (route, bytes, flops) of one call, from its
# arguments
KERNEL_COSTS: Dict[str, Callable] = {"flash_attention_fwd": _flash_call,
                                     "ssd_scan": _ssd_call,
                                     "ssd_scan_bwd": _ssd_bwd_call}
# the namespace of the kernels' operators
KERNEL_NAMESPACE = "repro_torch"
# the dtype whose peak bounds a kernel route's operations
ROUTE_DTYPES = {"tensor_core": "bfloat16", "simt": "float32",
                "plain": "float32"}


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

def block_bytes(n: int) -> int:
    """n bytes as the caching allocator's block: 0 for 0, else n rounded
    up to a multiple of 512."""
    return -(-int(n) // BLOCK_BYTES) * BLOCK_BYTES


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class LiveBytes:
    """The summed size of the live storages that `track` has seen, and
    its peak.  A storage counts once, rounded as an allocator block, from
    its first sighting until its last reference dies."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            st = _storage(t)
            key = st._cdata
            if key in self._sizes:
                continue
            n = block_bytes(st.nbytes())
            self._sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def tensors_of(tree, out: Optional[List[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
    """The tensors in a nested structure of dicts, lists and tuples; a
    module stands for its parameters and buffers."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors_of(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors_of(x, out)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    return out


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# a tensor made from Python data entering the program: the host's work,
# which a CUDA device sees as a copy and the meta device not at all
_UNCOUNTED = {"lift_fresh"}
# operations that only allocate or alias: no traffic, no FLOPs
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "alias", "detach", "set_",
         "resize_"}
# operations that move or fill data and compute nothing
_MOVEMENT = {"copy_", "_to_copy", "clone", "cat", "stack", "index",
             "_unsafe_index", "index_select", "gather", "embedding",
             "constant_pad_nd", "repeat", "repeat_interleave", "zeros",
             "zeros_like", "ones", "ones_like", "full", "full_like",
             "new_zeros", "new_ones", "new_full", "fill_", "zero_",
             "arange", "index_put_", "_index_put_impl_", "index_put",
             "scatter", "scatter_", "scatter_add", "scatter_add_",
             "index_add", "index_add_", "index_copy_", "slice_scatter",
             "select_scatter", "masked_scatter_", "_unsafe_index_put",
             "contiguous", "tril", "triu", "lift_fresh_copy"}
# in-place operations whose destination is written, never read
_WRITE_ONLY_SELF = {"copy_", "fill_", "zero_", "normal_", "uniform_",
                    "random_"}
# in-place scatters: the destination's written part is the source's size
_SCATTER_SELF = {"index_put_", "_index_put_impl_", "scatter_",
                 "scatter_add_", "index_add_", "index_copy_",
                 "masked_scatter_"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class CostCounter(TorchDispatchMode):
    """Counts the operations the program dispatches on `device` (None: the
    device of the first tensor it sees) while it is entered; see the
    module's docstring.  `models/common.named_scope` and `exchange` find
    the innermost counter by its `counts_cost`."""

    counts_cost = True

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)
        self.ops = 0
        self.op_counts: Dict[str, int] = collections.Counter()
        self.dot_flops: Dict[str, float] = collections.defaultdict(float)
        self.dot_by_scope: Dict[str, float] = collections.defaultdict(float)
        self.elementwise_flops = 0.0
        self.traffic_bytes = 0.0
        self.traffic_by_scope: Dict[str, float] = \
            collections.defaultdict(float)
        self.wire_bytes = 0.0
        self.wire_by_op: Dict[str, float] = collections.defaultdict(float)
        self.wire_by_scope: Dict[str, float] = collections.defaultdict(float)
        self.collective_count: Dict[str, int] = collections.Counter()
        self.kernel_calls: Dict[str, Dict[str, int]] = {}
        self.live = LiveBytes()
        self._fwd: List[str] = []   # forward scopes, innermost last
        self._bwd: List[str] = []   # scopes whose backward is running
        self._hooks = []

    # -- the dispatch hook --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _on_device(self, tensors: List[torch.Tensor]) -> bool:
        if self.device is None:
            self.device = tensors[0].device
        return any(t.device == self.device for t in tensors)

    def _count(self, func, args, kwargs, out) -> None:
        ins = tensors_of((args, kwargs))
        outs = tensors_of(out)
        if not (ins or outs) or not self._on_device(ins + outs):
            return
        self.live.track(ins + outs)
        name = func.overloadpacket.__name__
        if name in _UNCOUNTED:
            return
        self.ops += 1
        self.op_counts[name] += 1
        if func.is_view or name in _FREE:
            return
        scope = self.scope()
        if func.namespace == KERNEL_NAMESPACE:
            self._kernel(name, args, kwargs, scope)
            return
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
            self.dot_flops[_dtype_name(ins[0].dtype)] += flops
            self.dot_by_scope[scope] += flops
        elif name not in _MOVEMENT:
            self.elementwise_flops += sum(t.numel() for t in outs)
        nbytes = self._traffic(name, args, kwargs, outs)
        self.traffic_bytes += nbytes
        self.traffic_by_scope[scope] += nbytes

    @staticmethod
    def _traffic(name: str, args, kwargs, outs) -> float:
        kw = dict(kwargs)
        written = kw.pop("out", None)
        reads = tensors_of((args, kw))
        if name in _WRITE_ONLY_SELF or name in _SCATTER_SELF:
            reads = tensors_of((args[1:], kw))
        if name in _SCATTER_SELF:
            # the values written: the last tensor operand (index_put_'s
            # values, scatter_'s src, index_add_'s source)
            src = tensors_of((args[1:], kw))
            return float(sum(map(_bytes, reads))
                         + (_bytes(src[-1]) if src else 0))
        writes = outs if written is None else tensors_of(written)
        return float(sum(map(_bytes, reads)) + sum(map(_bytes, writes)))

    # -- scopes ---------------------------------------------------------------

    def scope(self) -> str:
        """The scope of an operation dispatched now."""
        if torch._C._current_graph_task_id() == -1 or self._fwd:
            # the forward, or a forward recomputed in the backward
            return self._fwd[-1] if self._fwd else "other"
        return self._bwd[-1] + "_bwd" if self._bwd else "backward_other"

    def scoped(self, name: str, fn, args, kwargs):
        """fn(*args, **kwargs) in scope `name`.  Where autograd records
        (outside the backward), hooks mark the backward of the call: it
        begins when the first gradient of an output arrives and ends when
        the first gradient of an input is computed (the way
        `torch.utils.module_tracker` follows a module's backward)."""
        record = (torch.is_grad_enabled()
                  and torch._C._current_graph_task_id() == -1)
        if record:
            # the activations: a module argument's parameters get their
            # gradients inside the backward, not at its end
            ins = [t for t in (*args, *kwargs.values())
                   if isinstance(t, torch.Tensor) and t.requires_grad]
            if ins:
                self._hooks.append(register_multi_grad_hook(
                    ins, lambda _g: self._leave_bwd(name), mode="any"))
        self._fwd.append(name)
        try:
            out = fn(*args, **kwargs)
        finally:
            self._fwd.pop()
        if record:
            outs = [t for t in tensors_of(out) if t.requires_grad]
            if outs:
                self._hooks.append(register_multi_grad_hook(
                    outs, lambda _g: self._enter_bwd(name), mode="any"))
        return out

    def _enter_bwd(self, name: str) -> None:
        if not self._bwd:
            # forget what a backward left behind once it ends
            torch.autograd.Variable._execution_engine.queue_callback(
                self._bwd.clear)
        self._bwd.append(name)

    def _leave_bwd(self, name: str) -> None:
        if name in self._bwd:
            del self._bwd[len(self._bwd) - 1 - self._bwd[::-1].index(name)]

    # -- what the program reports ---------------------------------------------

    def _kernel(self, name: str, args, kwargs, scope: str) -> None:
        """One call of hand-written kernel `name`, by its formula
        (`KERNEL_COSTS`) on the card's route."""
        route, nbytes, flops = KERNEL_COSTS[name](*args, **kwargs)
        calls = self.kernel_calls.setdefault(name, {})
        calls[route] = calls.get(route, 0) + 1
        self.dot_flops[ROUTE_DTYPES[route]] += flops
        self.dot_by_scope[scope] += flops
        self.traffic_bytes += nbytes
        self.traffic_by_scope[scope] += nbytes

    def collective(self, op: str, tensors: List[torch.Tensor],
                   n: int) -> None:
        """An exchange `op` among n mesh slots whose results are
        `tensors`: the ring model's wire bytes now, and again when their
        gradients flow back (the exchange's transpose)."""
        if n < 2:
            return
        wire = sum(map(_bytes, tensors)) * (n - 1) / n
        self._wire(op, wire)
        if torch.is_grad_enabled():
            grads = [t for t in tensors if t.requires_grad]
            if grads:
                self._hooks.append(register_multi_grad_hook(
                    grads, lambda _g: self._wire(op, wire), mode="any"))

    def _wire(self, op: str, wire: float) -> None:
        self.wire_bytes += wire
        self.wire_by_op[op] += wire
        self.wire_by_scope[self.scope()] += wire
        self.collective_count[op] += 1

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._hooks.clear()
        return super().__exit__(*exc)

    def analyze(self) -> Dict:
        """The reference's `roofline` and `program` keys of what was
        counted (`memory` comes from `analyze`, which knows the call's
        arguments and results)."""
        dot = dict(self.dot_flops)
        flops = sum(dot.values()) + self.elementwise_flops
        compute_s = H100.compute_s(dot, self.elementwise_flops)
        memory_s = self.traffic_bytes / H100.hbm_bytes_per_s
        collective_s = self.wire_bytes / H100.link_bytes_per_s
        dominant = max((("compute", compute_s), ("memory", memory_s),
                        ("collective", collective_s)),
                       key=lambda kv: kv[1])[0]
        return {
            "roofline": {"flops": flops, "hbm_bytes": self.traffic_bytes,
                         "wire_bytes": self.wire_bytes,
                         "compute_s": compute_s, "memory_s": memory_s,
                         "collective_s": collective_s, "dominant": dominant,
                         "by_op": dict(self.wire_by_op),
                         "counts": dict(self.collective_count)},
            "program": {"dot_flops": sum(dot.values()),
                        "dot_flops_by_dtype": dot,
                        "dot_flops_by_scope": dict(self.dot_by_scope),
                        "elementwise_flops": self.elementwise_flops,
                        "traffic_bytes": self.traffic_bytes,
                        "traffic_by_scope": dict(self.traffic_by_scope),
                        "wire_by_scope": dict(self.wire_by_scope),
                        "kernel_calls": {k: dict(v) for k, v in
                                         self.kernel_calls.items()},
                        "ops": self.ops},
        }


def _storages(tensors: Iterable[torch.Tensor]) -> Dict[int, int]:
    """The distinct storages of `tensors`: their raw bytes by key."""
    return {_storage(t)._cdata: _storage(t).nbytes() for t in tensors}


def analyze(fn, *args):
    """fn(*args) under a `CostCounter` on the device of its first argument
    tensor; returns (its result, the record): the counter's `roofline`
    and `program`, the op tallies by aten name (`cost_analysis_raw`),
    and `memory`, the reference's keys of `memory_analysis()`:
    `argument_size_in_bytes` (the arguments' storages, the model's
    parameters among them), `output_size_in_bytes` (result storages that
    are not an argument's), `alias_size_in_bytes` (results that are
    arguments updated in place: caches, optimizer state, the trained
    parameters), `temp_size_in_bytes` (the peak less the blocks of the
    arguments and the new results) and `peak_bytes` (the most `LiveBytes`
    held, arguments included)."""
    arg_tensors = tensors_of(args)
    counter = CostCounter(arg_tensors[0].device if arg_tensors else None)
    counter.live.track(arg_tensors)
    arg_blocks = counter.live.live
    arg = _storages(arg_tensors)
    with counter:
        out = fn(*args)
    res = _storages(tensors_of(out))
    fresh = {k: n for k, n in res.items() if k not in arg}
    record = counter.analyze()
    record["memory"] = {
        "argument_size_in_bytes": sum(arg.values()),
        "output_size_in_bytes": sum(fresh.values()),
        "alias_size_in_bytes": sum(n for k, n in res.items() if k in arg),
        "temp_size_in_bytes": max(0, counter.live.peak - arg_blocks - sum(
            map(block_bytes, fresh.values()))),
        "peak_bytes": counter.live.peak}
    # the backend's own tallies, as the reference keeps XLA's
    record["cost_analysis_raw"] = dict(sorted(counter.op_counts.items()))
    return out, record
