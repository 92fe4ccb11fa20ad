"""Per-bank fault model for the serving cell: healthy / degraded-slow / dead.

UpDLRM's premise is that embedding reads fan out across many independent DPU
banks — which makes a single slow or dead bank the availability story, not
just the latency story. This module is the *model* half of fault-tolerant
serving (the *mechanism* half — bounded-degraded reads and the recovery
replan — lives in core/embedding.py's ``bank_live`` mask and
workload/runtime.py's ``on_bank_failure``):

  * ``BankFaultState``  — the per-bank health vector, advanced batch-by-batch
    by a deterministic injection schedule (seeded, replayable — every CI run
    and every test sees the identical failure sequence).
  * ``FaultEvent``      — one scheduled transition (bank b enters state s at
    batch t, with a slowdown factor for DEGRADED).

A numpy copy of the reference's ``repro/dist/bank_fault.py``: it wraps the
host-side serve loop, and its outputs (``live_mask``, ``slow_factor``) are
plain numpy vectors the loop hands to the serve step as ARGUMENTS (the same
pure-argument swap contract as the remap vectors).
"""
from __future__ import annotations

import dataclasses

import numpy as np

HEALTHY = 0
DEGRADED = 1          # alive but slow: reads land, latency x ``factor``
DEAD = 2              # reads destined here resolve to a degraded substitute

_STATE_NAMES = {"healthy": HEALTHY, "degraded": DEGRADED, "dead": DEAD}
_NAME_OF = {v: k for k, v in _STATE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Bank ``bank`` transitions to ``state`` when batch ``batch`` starts.

    ``factor`` is the latency multiplier for DEGRADED (ignored otherwise).
    """

    batch: int
    bank: int
    state: int = DEAD
    factor: float = 1.0

    def __str__(self) -> str:
        extra = f" x{self.factor:g}" if self.state == DEGRADED else ""
        return f"bank {self.bank} -> {_NAME_OF[self.state]}{extra} " \
               f"@batch {self.batch}"


def parse_fault_spec(spec: str) -> FaultEvent:
    """CLI form ``BATCH:BANK[:STATE[:FACTOR]]`` -> FaultEvent.

    ``--inject-bank-failure 12:3`` kills bank 3 at batch 12;
    ``12:3:degraded:4.0`` slows it 4x instead; ``20:3:healthy`` revives it.
    """
    parts = spec.split(":")
    if len(parts) < 2 or len(parts) > 4:
        raise ValueError(f"fault spec {spec!r}: want BATCH:BANK"
                         f"[:STATE[:FACTOR]]")
    batch, bank = int(parts[0]), int(parts[1])
    state = DEAD
    factor = 1.0
    if len(parts) >= 3:
        if parts[2] not in _STATE_NAMES:
            raise ValueError(f"fault spec {spec!r}: state must be one of "
                             f"{sorted(_STATE_NAMES)}")
        state = _STATE_NAMES[parts[2]]
    if len(parts) == 4:
        factor = float(parts[3])
    return FaultEvent(batch=batch, bank=bank, state=state, factor=factor)


class BankFaultState:
    """Per-bank health, driven by a deterministic event schedule.

    ``advance(batch)`` fires every not-yet-fired event with
    ``event.batch <= batch`` (in schedule order) and returns them; the serve
    loop calls it once per micro-batch before building the batch's
    ``bank_live`` argument. Revival (an event back to HEALTHY) is supported —
    a revived bank re-enters the planner's capacity on the next replan.
    """

    def __init__(self, n_banks: int,
                 events: "list[FaultEvent] | tuple[FaultEvent, ...]" = ()):
        for e in events:
            if not (0 <= e.bank < n_banks):
                raise ValueError(f"event {e}: bank out of range "
                                 f"[0, {n_banks})")
        self.n_banks = n_banks
        self.state = np.zeros(n_banks, dtype=np.int32)        # all HEALTHY
        self.factor = np.ones(n_banks, dtype=np.float64)
        self.schedule = sorted(events, key=lambda e: (e.batch, e.bank))
        self.fired: list[FaultEvent] = []
        self._next = 0

    @classmethod
    def from_specs(cls, n_banks: int, specs: "list[str]") -> "BankFaultState":
        return cls(n_banks, [parse_fault_spec(s) for s in specs])

    @classmethod
    def random_schedule(cls, n_banks: int, n_batches: int, *, seed: int,
                        n_failures: int = 1, p_degraded: float = 0.0,
                        degraded_factor: float = 4.0,
                        min_batch: int = 1) -> "BankFaultState":
        """Seeded random injection schedule — deterministic given
        (n_banks, n_batches, seed, knobs): the same seed replays the same
        failure sequence on every run (the testable contract)."""
        rng = np.random.default_rng(seed)
        n_failures = min(n_failures, n_banks - 1)   # keep >= 1 survivor
        banks = rng.choice(n_banks, size=n_failures, replace=False)
        batches = np.sort(rng.integers(min_batch, max(n_batches, min_batch + 1),
                                       size=n_failures))
        events = []
        for t, b in zip(batches, banks):
            degraded = rng.random() < p_degraded
            events.append(FaultEvent(
                batch=int(t), bank=int(b),
                state=DEGRADED if degraded else DEAD,
                factor=degraded_factor if degraded else 1.0))
        return cls(n_banks, events)

    # -- the per-batch hook --------------------------------------------------

    def advance(self, batch: int) -> list[FaultEvent]:
        """Fire every pending event scheduled at or before ``batch``."""
        fired = []
        while self._next < len(self.schedule) \
                and self.schedule[self._next].batch <= batch:
            e = self.schedule[self._next]
            self.state[e.bank] = e.state
            self.factor[e.bank] = e.factor if e.state == DEGRADED else 1.0
            fired.append(e)
            self.fired.append(e)
            self._next += 1
        return fired

    # -- views the serve loop feeds to the serve step / planner ------------

    def live_mask(self) -> np.ndarray:
        """(n_banks,) bool — False where DEAD (the serve step's argument)."""
        return self.state != DEAD

    def slow_factor(self) -> np.ndarray:
        """(n_banks,) float latency multiplier (1.0 unless DEGRADED)."""
        return np.where(self.state == DEGRADED, self.factor, 1.0)

    def dead_banks(self) -> list[int]:
        return [int(b) for b in np.flatnonzero(self.state == DEAD)]

    def degraded_banks(self) -> list[int]:
        return [int(b) for b in np.flatnonzero(self.state == DEGRADED)]

    def any_fault(self) -> bool:
        return bool((self.state != HEALTHY).any())
