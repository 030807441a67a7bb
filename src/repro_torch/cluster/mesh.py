"""Mesh placement layer (DESIGN.md §13.1).

A `MeshContext` holds an ordered list of torch devices, its *slots*, and
owns the *placement* of catalog partitions onto them: round-robin over the
alive slots, same convention as the DESIGN.md §5 ``('data',)`` axis.  With
no `devices` the slots are every CUDA device of the machine (and the
constructor raises without one); `devices=[...]` gives them explicitly,
and a device may repeat: ``[torch.device("cuda", 0)] * 4`` is four slots
sharing one card, ``[torch.device("cpu")] * 8`` eight CPU slots (what the
reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` gives
it).  Placement is physical-layer state only — it never appears in a
logical plan, so explain() output and plan fingerprints are byte-identical
with sharding on or off.

Device loss is modeled the way worker loss is in the runtime scheduler:
``kill_device(slot)`` marks the slot dead and bumps the placement
*generation*.  A dispatch that observes a generation change (or catches
`DeviceLost` from a chaos hook) rebuilds the placement over the survivors
and recomputes — results are identical because every mesh dispatch
computes pure partial states from host-resident partitions (the lineage
the single-host path already has).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel import compat

MAX_RETRIES = 3     # dispatch retries after a device loss, without a policy


class DeviceLost(RuntimeError):
    """A mesh device died mid-dispatch (raised by chaos hooks; real device
    loss would surface as a CUDA runtime error wrapped into this)."""

    def __init__(self, slot: int):
        super().__init__(f"mesh device slot {slot} lost")
        self.slot = slot


@dataclass(frozen=True)
class MeshPlacement:
    """Partition -> device-slot assignment for ONE dispatch: round-robin of
    `num_parts` partitions over the alive slots at `generation`."""
    generation: int
    alive_slots: Tuple[int, ...]
    device_of: Tuple[int, ...]          # partition ordinal -> alive-slot index
    parts_per_device: int               # most partitions on one slot

    @property
    def n_devices(self) -> int:
        return len(self.alive_slots)


class MeshContext:
    """Device-slot pool + placement authority for mesh-sharded execution.

    Thread-safe: executors on server worker threads share one context.
    Every slot computes on the current CUDA stream of its device (one
    stream for slots that share a card), so the exchange's copies and
    launches are ordered without events.
    """

    def __init__(self, devices: Optional[Sequence] = None, policy=None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MeshContext(): no CUDA device is available; pass "
                    "devices=[...] (e.g. [torch.device(\"cpu\")] * 4) to "
                    "place slots on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = compat.slot_devices(devices)
        self.alive: List[bool] = [True] * len(self.devices)
        self.generation = 0
        # the ResiliencePolicy owns the dispatch retry budget when given
        self.max_retries = (policy.mesh_max_retries if policy is not None
                            else MAX_RETRIES)
        self.chaos = None   # core.faults.ChaosEngine, when installed
        self.lock = threading.RLock()
        # chaos hook: called at every dispatch with (ctx, dispatch_ordinal);
        # tests install a killer that calls kill_device / raises DeviceLost
        self.on_dispatch: Optional[Callable[["MeshContext", int], None]] = None
        self.dispatches = 0
        self.retries = 0                # dispatches re-run after device loss

    def check_device(self, device) -> None:
        """Raise ValueError unless the slots are of `device`'s type (the
        session's or server's): nothing crosses between the CPU and a card
        behind the caller's back."""
        kind, slots = torch.device(device).type, self.devices[0].type
        if kind != slots:
            raise ValueError(f"mesh slots are {slots} devices but the engine "
                             f"computes on {kind}")

    # -- device liveness ------------------------------------------------------

    def alive_slots(self) -> List[int]:
        with self.lock:
            return [i for i, a in enumerate(self.alive) if a]

    @property
    def n_alive(self) -> int:
        return len(self.alive_slots())

    def kill_device(self, slot: int) -> None:
        """Chaos: mark a device slot dead.  Every placement built at an
        older generation is stale; in-flight dispatches recompute over the
        survivors."""
        with self.lock:
            if not self.alive[slot]:
                return
            if sum(self.alive) == 1:
                raise RuntimeError("cannot kill the last mesh device")
            self.alive[slot] = False
            self.generation += 1

    def revive_all(self) -> None:
        with self.lock:
            if not all(self.alive):
                self.alive = [True] * len(self.devices)
                self.generation += 1

    # -- placement ------------------------------------------------------------

    def place(self, num_parts: int) -> MeshPlacement:
        """Round-robin `num_parts` catalog partitions over the alive
        slots."""
        with self.lock:
            slots = tuple(self.alive_slots())
            n = len(slots)
            device_of = tuple(i % n for i in range(num_parts))
            per = max(1, -(-num_parts // n)) if num_parts else 1
            return MeshPlacement(self.generation, slots, device_of, per)

    def slot_devices(self, placement: MeshPlacement) -> List[torch.device]:
        """The device of each alive-slot index of `placement`."""
        return [self.devices[s] for s in placement.alive_slots]

    # -- dispatch bookkeeping -------------------------------------------------

    def fire_dispatch(self) -> int:
        """Invoke the chaos hook (if any) and count the dispatch.  Returns
        the generation observed at dispatch start, so callers can detect a
        placement made stale *during* the dispatch."""
        with self.lock:
            ordinal = self.dispatches
            self.dispatches += 1
            gen = self.generation
        hook = self.on_dispatch
        if hook is not None:
            hook(self, ordinal)
        # chaos seam "mesh.dispatch": kill an alive device slot and raise
        # DeviceLost — the dispatch retry loop re-places over the survivors
        # and recomputes.  Only armed while >1 slot survives (killing the
        # last device would be unrecoverable, not chaos).
        chaos = self.chaos
        if chaos is not None and self.n_alive > 1:
            trip = chaos.fire("mesh.dispatch")
            if trip is not None:
                slots = self.alive_slots()
                victim = slots[trip.ordinal % len(slots)]
                try:
                    self.kill_device(victim)
                except RuntimeError:
                    pass        # raced another killer down to one slot
                raise DeviceLost(victim)
        return gen

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return {"devices": len(self.devices), "alive": sum(self.alive),
                    "generation": self.generation,
                    "dispatches": self.dispatches, "retries": self.retries}
