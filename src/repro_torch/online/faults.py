"""Fault injection for the open-system simulator — faults are data (numpy).

The port's own copy of ``repro.online.faults``: the same schedules from the
same seeds, so a run here faces the reference's faults quantum for quantum.

A :class:`FaultProfile` is a seeded, versioned *description* of faults,
in the manner of the arrival stream (:func:`repro_torch.online.arrivals.
presample`): :meth:`FaultProfile.schedule` materialises it on the host into
per-quantum ``(up, speed)`` arrays, which the open-system engine
(``repro_torch.online.device_sim``) ships to the device once and indexes
per quantum.  The engine never branches on fault contents: failure flips
membership masks, straggling scales a multiplier, shapes never change.

RNG stream extension (``FAULT_RNG_STREAM_VERSION`` = 1):

* The fault stream is ``numpy.default_rng(seed + 6007)`` — disjoint by
  offset from the machine stream (``seed``), the arrival stream
  (``seed + 4242``) and the host policy stream (``seed + 7919``).
* When MTTF/MTTR draws are enabled, exactly **one uniform per (quantum,
  core)** is consumed, row-major in ascending (quantum, core) order,
  *regardless* of core state — so the stream is a pure function of
  ``(n_quanta, n_cores, seed)`` and explicit events never shift the random
  draws.  Profiles without MTTF/MTTR consume nothing.
* The engine's noise and phase draws are untouched: faults are
  pre-sampled data, not device randomness.

Semantics (the reference's, verbatim; see ``docs/resilience.md``):

* A core is *down* for whole quanta; both SMT contexts of a down core are
  unavailable.  Jobs on a core that goes down are **evicted** at the start
  of the quantum, before admission.
* An evicted job re-enters through a bounded **retry pool**: its retry
  count increments; past ``max_retries`` evictions it is *dropped*
  (work lost, counted — never silently); otherwise it becomes eligible
  for re-admission ``backoff_quanta`` later.  Eligible retries are
  re-admitted before the fresh FIFO queue, in ascending job-id order.
* Re-admission restarts the job at phase 0 (phase state is lost with the
  core); ``preserve_progress=True`` (default) restores the retired
  instruction count saved at eviction, ``False`` restarts from zero.
* A *straggler* core runs at ``speed < 1``: its contexts retire
  ``speed``-scaled instructions per quantum (interference components and
  PMU counters are unchanged — the model is a clock-throttled core).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

#: Version of the fault stream layout documented above (the
#: reference's).
FAULT_RNG_STREAM_VERSION = 1

#: Offset of the fault stream from the run seed (see module docstring).
FAULT_SEED_OFFSET = 6007

#: ``retry_at`` sentinel for "not waiting in the retry pool" — far beyond
#: any horizon, safely below int32 overflow when a backoff is added.
RETRY_NEVER = np.int32(1 << 30)


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Seeded, versioned description of core faults over a run.

    fail / recover:  explicit ``(quantum, core)`` events — the core goes
                     down (up) at the *start* of that quantum;
    straggle:        ``(core, start_q, end_q, speed)`` intervals — the core
                     runs at ``speed`` (0 < speed <= 1) for quanta in
                     ``[start_q, end_q)``;
    mttf_quanta:     mean quanta to failure of an up core (geometric
                     per-quantum hazard ``1/mttf``); 0 disables draws;
    mttr_quanta:     mean quanta to repair of a down core; 0 disables;
    max_retries:     evictions a job survives before it is dropped;
    backoff_quanta:  quanta an evicted job waits before re-admission
                     eligibility (0 = eligible the same quantum);
    preserve_progress: restore the victim's retired-instruction progress
                     on re-admission (True) or restart from zero (False).
    """

    fail: Tuple[Tuple[int, int], ...] = ()
    recover: Tuple[Tuple[int, int], ...] = ()
    straggle: Tuple[Tuple[int, int, int, float], ...] = ()
    mttf_quanta: float = 0.0
    mttr_quanta: float = 0.0
    max_retries: int = 3
    backoff_quanta: int = 2
    preserve_progress: bool = True

    def __post_init__(self):
        object.__setattr__(
            self, "fail", tuple((int(q), int(c)) for q, c in self.fail)
        )
        object.__setattr__(
            self, "recover", tuple((int(q), int(c)) for q, c in self.recover)
        )
        object.__setattr__(
            self, "straggle",
            tuple((int(c), int(a), int(b), float(s))
                  for c, a, b, s in self.straggle),
        )
        assert self.mttf_quanta >= 0 and self.mttr_quanta >= 0
        assert self.max_retries >= 0 and self.backoff_quanta >= 0
        for _c, a, b, s in self.straggle:
            assert 0.0 < s <= 1.0, f"straggler speed must be in (0, 1]: {s}"
            assert a <= b, "straggle interval must have start_q <= end_q"

    @property
    def static_config(self) -> Tuple[int, int, bool]:
        """The compile-shaping knobs (the device race is keyed on these)."""
        return (self.max_retries, self.backoff_quanta, self.preserve_progress)

    # -------------------------------------------------------- materialise
    def schedule(self, n_quanta: int, n_cores: int,
                 seed: int) -> "FaultSchedule":
        """Materialise into per-quantum ``(up, speed)`` arrays.

        Drawn once host-side from ``default_rng(seed + 6007)`` under the
        stream layout documented above, as the reference draws it, so a
        run here faces the reference's faults bit for bit.
        """
        for q, c in self.fail + self.recover:
            assert 0 <= c < n_cores, f"fault event core {c} out of range"
        up = np.ones((n_quanta, n_cores), bool)
        speed = np.ones((n_quanta, n_cores), np.float32)
        fail_at = {}
        rec_at = {}
        for q, c in self.fail:
            fail_at.setdefault(q, []).append(c)
        for q, c in self.recover:
            rec_at.setdefault(q, []).append(c)
        rng = np.random.default_rng(seed + FAULT_SEED_OFFSET)
        draws = self.mttf_quanta > 0 or self.mttr_quanta > 0
        p_fail = 1.0 / self.mttf_quanta if self.mttf_quanta > 0 else 0.0
        p_rec = 1.0 / self.mttr_quanta if self.mttr_quanta > 0 else 0.0
        state = np.ones(n_cores, bool)
        for q in range(n_quanta):
            for c in fail_at.get(q, ()):
                state[c] = False
            for c in rec_at.get(q, ()):
                state[c] = True
            if draws:
                u = rng.random(n_cores)   # one row per quantum, always
                state = np.where(
                    state, u >= p_fail, u < p_rec
                )
            up[q] = state
        for c, a, b, s in self.straggle:
            assert 0 <= c < n_cores, f"straggle core {c} out of range"
            speed[max(a, 0):min(b, n_quanta), c] = s
        return FaultSchedule(up=up, speed=speed)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Materialised fault data of one run: ``up``/``speed``, (Q, n_cores).

    ``up[q, k]`` — core ``k`` is available during quantum ``q``;
    ``speed[q, k]`` — its capability multiplier (1.0 = nominal).
    The ``ctx_*`` views expand cores to the 2-way SMT contexts
    (core ``k`` -> contexts ``2k, 2k+1``) the simulators index by.
    """

    up: np.ndarray
    speed: np.ndarray

    @property
    def n_quanta(self) -> int:
        return self.up.shape[0]

    @property
    def n_cores(self) -> int:
        return self.up.shape[1]

    def ctx_up(self) -> np.ndarray:
        """(Q, 2 * n_cores) bool — per-context availability."""
        return np.repeat(self.up, 2, axis=1)

    def ctx_speed(self) -> np.ndarray:
        """(Q, 2 * n_cores) f32 — per-context capability multiplier."""
        return np.repeat(self.speed, 2, axis=1)

    # Transition timelines: pure functions of the schedule.
    def failures(self) -> np.ndarray:
        """(Q,) cores newly down at each quantum (up[-1] := all up)."""
        prev = np.vstack([np.ones((1, self.n_cores), bool), self.up[:-1]])
        return (prev & ~self.up).sum(axis=1).astype(np.float64)

    def recoveries(self) -> np.ndarray:
        """(Q,) cores newly back up at each quantum."""
        prev = np.vstack([np.ones((1, self.n_cores), bool), self.up[:-1]])
        return (~prev & self.up).sum(axis=1).astype(np.float64)

    def straggling(self) -> np.ndarray:
        """(Q,) up cores running degraded (speed < 1)."""
        return (self.up & (self.speed < 1.0)).sum(axis=1).astype(np.float64)
