"""Deterministic fault injection for DIGEST training (the port of
``src/repro/core/faults.py``).

Every fault decision is a pure function of ``(seed, fault_class, round,
worker)``: ``np.random.default_rng([seed, tag, round, worker])`` seeds a
fresh generator per decision, so decisions do not depend on the order
they are asked in, come out the same after a resume, and equal the
reference's decision for decision (the schedule is numpy, copied).

Fault classes: ``crash`` (the worker is down for ``crash_rounds``
rounds), ``drop_push`` (a push's transfer is lost), ``delay_pull`` (a
pull is deferred) and ``corrupt_push`` (the payload is bit-flipped in
flight and the receiver's CRC check rejects it, which acts as a drop).

The training epoch consumes the schedule as a per-part bool ``push_ok``
mask in the state (:func:`attach_fault_state`): a masked part's rows go
to its shard's sentinel slot in the same push, so the store keeps its
last good rows, and ``last_push_round`` records each part's last
accepted push.  The ``max_staleness`` watchdog forces a push once a part
is that many rounds behind.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

# Distinct integer tags keep the per-class decision streams disjoint.
_TAG_CRASH = 0x11
_TAG_DROP = 0x22
_TAG_DELAY = 0x33
_TAG_CORRUPT = 0x44


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-(round, worker) probabilities in [0, 1] and the schedule's
    knobs; ``enabled`` is False when every rate is 0."""
    seed: int = 0
    crash_rate: float = 0.0
    crash_rounds: int = 3          # rounds a crashed worker stays down
    drop_push_rate: float = 0.0
    delay_pull_rate: float = 0.0
    corrupt_rate: float = 0.0
    retry_backoff: int = 1         # rounds before first push retry; doubles
    retry_backoff_cap: int = 8     # ... up to this many rounds

    def __post_init__(self):
        for name in ("crash_rate", "drop_push_rate", "delay_pull_rate",
                     "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} not in [0, 1]")
        if self.crash_rounds < 1:
            raise ValueError("crash_rounds must be >= 1")
        if self.retry_backoff < 1:
            raise ValueError("retry_backoff must be >= 1")

    @property
    def enabled(self) -> bool:
        return (self.crash_rate > 0 or self.drop_push_rate > 0
                or self.delay_pull_rate > 0 or self.corrupt_rate > 0)


class FaultSchedule:
    """Counter-based fault decisions (see the module docstring)."""

    def __init__(self, config: FaultConfig):
        self.config = config

    def _hit(self, tag: int, rate: float, rnd: int, worker: int) -> bool:
        if rate <= 0.0:
            return False
        rng = np.random.default_rng(
            [int(self.config.seed), tag, int(rnd), int(worker)])
        return bool(rng.random() < rate)

    def crashes(self, rnd: int, worker: int) -> bool:
        return self._hit(_TAG_CRASH, self.config.crash_rate, rnd, worker)

    def drops_push(self, rnd: int, worker: int) -> bool:
        return self._hit(_TAG_DROP, self.config.drop_push_rate, rnd, worker)

    def delays_pull(self, rnd: int, worker: int) -> bool:
        return self._hit(_TAG_DELAY, self.config.delay_pull_rate, rnd, worker)

    def corrupts_push(self, rnd: int, worker: int) -> bool:
        return self._hit(_TAG_CORRUPT, self.config.corrupt_rate, rnd, worker)

    def down(self, rnd: int, worker: int) -> bool:
        """True if a crash at any round in (rnd - crash_rounds, rnd]
        leaves the worker still restarting at round ``rnd``."""
        k = self.config.crash_rounds
        return any(self.crashes(c, worker)
                   for c in range(max(1, rnd - k + 1), rnd + 1))

    def push_ok(self, rnd: int, num_parts: int) -> np.ndarray:
        """(num_parts,) bool: False where part m's push at round ``rnd``
        is lost — dropped, corrupted and rejected, or its worker down."""
        ok = np.ones(num_parts, dtype=bool)
        for m in range(num_parts):
            if (self.drops_push(rnd, m) or self.corrupts_push(rnd, m)
                    or self.down(rnd, m)):
                ok[m] = False
        return ok


def attach_fault_state(state: dict, num_parts: int) -> dict:
    """A copy of ``state`` with the fault-aware leaves on the store's
    device: the per-part ``push_ok`` mask (refreshed from the schedule
    every round) and the ``last_push_round`` age table.  Without them the
    epoch runs the fault-free program."""
    dev = state["store"]["data"].device
    state = dict(state)
    state["push_ok"] = torch.ones((num_parts,), dtype=torch.bool, device=dev)
    state["last_push_round"] = torch.zeros((num_parts,), dtype=torch.int32,
                                           device=dev)
    return state


def wire_crc32(rows: np.ndarray) -> int:
    """Checksum of a wire payload, as the receiver computes it before it
    accepts the rows."""
    return zlib.crc32(np.ascontiguousarray(rows).tobytes()) & 0xFFFFFFFF


def corrupt_rows(rows: np.ndarray, seed: int, rnd: int,
                 worker: int) -> np.ndarray:
    """Deterministically flip one bit of a wire payload — the in-flight
    corruption the receiver's CRC check must catch."""
    buf = np.ascontiguousarray(rows).copy()
    raw = buf.view(np.uint8).reshape(-1)
    if raw.size == 0:
        return buf
    rng = np.random.default_rng([int(seed), _TAG_CORRUPT, int(rnd),
                                 int(worker), 0x5A])
    pos = int(rng.integers(raw.size))
    raw[pos] ^= np.uint8(1 << int(rng.integers(8)))
    return buf


def measured_staleness(last_push_round: torch.Tensor, rnd) -> torch.Tensor:
    """Max age (rounds since the last accepted push) over the parts: a
    0-d int32 tensor on ``last_push_round``'s device."""
    last = torch.as_tensor(last_push_round).to(torch.int32)
    return torch.amax(torch.as_tensor(rnd, dtype=torch.int32,
                                      device=last.device) - last)


def check_schedule(schedule) -> Optional[FaultSchedule]:
    """None or a disabled schedule → None; a FaultConfig → its schedule;
    else the schedule."""
    if schedule is None:
        return None
    if isinstance(schedule, FaultConfig):
        schedule = FaultSchedule(schedule)
    return schedule if schedule.config.enabled else None
