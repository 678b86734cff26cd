"""Online thread-to-core allocation under churn — the streaming SYNPA path
(the port's copy of ``repro.online.allocator``).

The closed-system :class:`repro_torch.core.synpa.SynpaScheduler` and this
streaming allocator share one engine: the **fused per-quantum step**
(:func:`repro_torch.core.synpa.make_fused_step`).  Per quantum the
counters go to the allocator's device (``cuda`` unless the caller passes
``device="cpu"``) in one copy queued without a host sync, the step runs
there — ISC stack repair, the §5.3 inverse (damped Gauss-Newton, one solve
per co-running *pair*), the all-pairs Eq. 4 scoring and the matching cost
preparation in one ``pair_score`` launch — and the prepared cost matrix
comes back in one device-to-host copy
(:func:`repro_torch.core.synpa.host_cost`).  The padded shape is a pure
function of the context capacity: arrivals and departures change mask
contents, never shapes.

What remains stateful:

* **ST placeholders** — a slot whose application has not produced counters
  yet (admitted this quantum) scores with the uniform stack until its first
  quantum completes; a slot that ran *alone* takes its measured fractions as
  its ST stack directly (no co-runner, nothing to invert).
* **Incremental re-matching** — on churn quanta the surviving pairs are
  kept, the uncovered vertices (arrivals, widows, a previously idle
  context) are matched exactly among themselves, and the incremental
  2-opt (:func:`repro_torch.core.matching.repair_pairs`) ripples the repair
  outward only through rows/columns it actually improves.  On static quanta
  the allocator re-matches like the batch scheduler — exactly (blossom) up
  to ``BLOSSOM_MAX_N``, and by re-converging the previous pairing
  (:func:`repro_torch.core.matching.refine_pairs`) at cluster scale, where the
  batch tier itself is heuristic.

**Exactness.**  The Gauss-Newton inverse is *stateless*: it starts from the
measured fractions and converges to float-noise residuals in a handful of
LM steps, so its result is a pure function of this quantum's counters — no
warm-start trajectory, no history dependence, so every configuration
computes the *same* ST stacks, bitwise.  What still distinguishes
:func:`exact_config` from the default is only the matcher tier: exact mode
re-matches static quanta in full (bit-identical pairings to
``SynpaScheduler.schedule`` on static populations — integration-tested),
while the default re-converges the previous pairing past the blossom tier
(``rematch="auto"``), which is quality-equal but not bitwise above
``BLOSSOM_MAX_N``.  The retained heavy-ball engine (``solver="hb"``) is
the gradient solve for A/B comparisons: two-start descent, warm-started
from the carried estimates with ``warm=True``.

Odd populations follow the idle-context convention: a virtual idle vertex
with edge cost :data:`repro_torch.core.matching.IDLE_COST` (= 1.0 + 1.0, two
interference-free slowdowns) joins the matching, and whoever pairs with it
runs alone on its core that quantum.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core import isc, matching, regression
from repro_torch.core.matching import IDLE_COST
from repro_torch.core.synpa import Scheduler, check_impl, host_cost, make_fused_step

Pair = Tuple[int, int]

_BIG = matching.BIG


class OnlinePolicy:
    """Interface the open-system simulator drives every quantum.

    ``pair`` receives the *previous* quantum's PMU counters (rows of slots
    that executed it), membership deltas since the last call, and the
    previous pairing; it returns the co-run slot pairs for this quantum plus
    the slot left with an idle context when the population is odd.
    """

    name = "online-base"

    def reset(self, machine, rng: np.random.Generator) -> None:
        self.machine = machine
        self.rng = rng

    def pair(
        self,
        q: int,
        active: np.ndarray,
        counters: np.ndarray,
        ran: np.ndarray,
        arrived: Sequence[int],
        departed: Sequence[int],
        prev_pairs: List[Pair],
        prev_solo: Optional[int],
        hints: Optional[Dict[int, np.ndarray]] = None,
    ) -> Tuple[List[Pair], Optional[int]]:
        """``hints`` (optional) maps an *arrived* slot to a profiled ST
        stack estimate for its application — the queue-aware admission tier
        (``repro_torch.online.admission``) supplies these so a newcomer scores
        with historical profile information instead of the uniform
        placeholder.  Policies are free to ignore them."""
        raise NotImplementedError

    # helpers --------------------------------------------------------------
    def _random_pairing(
        self, slots: Sequence[int]
    ) -> Tuple[List[Pair], Optional[int]]:
        slots = list(slots)
        perm = self.rng.permutation(len(slots))
        shuffled = [slots[k] for k in perm]
        solo = shuffled.pop() if len(shuffled) % 2 else None
        pairs = [
            (shuffled[2 * k], shuffled[2 * k + 1])
            for k in range(len(shuffled) // 2)
        ]
        return pairs, solo

    @staticmethod
    def _surviving(
        active: np.ndarray,
        arrived: Sequence[int],
        prev_pairs: List[Pair],
    ) -> Tuple[List[Pair], List[int]]:
        """Split the previous pairing into kept pairs + uncovered slots
        (a previously-solo slot falls out naturally as uncovered)."""
        alive = set(int(s) for s in active) - set(int(s) for s in arrived)
        kept = [
            (a, b) for a, b in prev_pairs if a in alive and b in alive
        ]
        covered = {v for p in kept for v in p}
        uncovered = [int(s) for s in active if int(s) not in covered]
        return kept, uncovered


class RandomOnline(OnlinePolicy):
    """Random-static under churn: pairs survive; churn is patched randomly."""

    name = "random"

    def pair(self, q, active, counters, ran, arrived, departed,
             prev_pairs, prev_solo, hints=None):
        if not prev_pairs and prev_solo is None:
            return self._random_pairing(active)
        kept, uncovered = self._surviving(active, arrived, prev_pairs)
        if not uncovered:
            return kept, None
        patch, solo = self._random_pairing(uncovered)
        return kept + patch, solo


class AdjacentOnline(OnlinePolicy):
    """Deterministic slot-ordered pairing: active slots pair in ascending
    adjacent order every quantum; an odd population leaves the highest
    active slot solo.  Interference-oblivious and *RNG-free* — the parity
    anchor of the device engine (``repro_torch.online.device_sim``
    implements the same rule on tensors), where a shared arrival stream
    plus this policy pins the whole open-system trajectory."""

    name = "adjacent"

    def pair(self, q, active, counters, ran, arrived, departed,
             prev_pairs, prev_solo, hints=None):
        a = [int(s) for s in active]
        solo = a.pop() if len(a) % 2 else None
        pairs = [(a[2 * k], a[2 * k + 1]) for k in range(len(a) // 2)]
        return pairs, solo


class LinuxOnline(RandomOnline):
    """CFS-like under churn: sticky pairing, occasional migrations,
    random patching of arrivals/departures (interference-oblivious)."""

    name = "linux"

    def __init__(self, p_migrate: float = 0.03):
        self.p_migrate = p_migrate

    def pair(self, q, active, counters, ran, arrived, departed,
             prev_pairs, prev_solo, hints=None):
        pairs, solo = super().pair(
            q, active, counters, ran, arrived, departed, prev_pairs, prev_solo
        )
        if len(pairs) >= 2 and self.rng.random() < self.p_migrate:
            pl = [list(p) for p in pairs]
            a, b = self.rng.choice(len(pl), size=2, replace=False)
            sa = int(self.rng.integers(2))
            sb = int(self.rng.integers(2))
            pl[a][sa], pl[b][sb] = pl[b][sb], pl[a][sa]
            pairs = [tuple(p) for p in pl]
        return pairs, solo


@dataclasses.dataclass
class StreamingConfig:
    """Knobs of the streaming allocator (see module docstring)."""

    solver: str = "gn"           # §5.3 engine: "gn" (default) or "hb"
    gn_steps: int = regression.GN_STEPS   # LM budget per GN solve
    warm: bool = True            # hb only: warm-start from previous ST
    warm_steps: int = 24         # hb budget when warm
    cold_steps: int = 80         # hb budget when cold / gn fallback budget
    incremental: bool = True     # repair the matching on churn
    rematch: str = "auto"        # static-quantum re-match: full/refine/auto
    #: Engine for full re-matches (``matching.min_cost_pairs`` methods), or
    #: ``"device"`` to swap the host matcher for the device tier
    #: (:func:`repro_torch.core.matching.device_pairs_partner`): sort seed
    #: + parallel 2-opt on the padded cost matrix on the device every
    #: quantum, with only the (P,) partner vector copied back.  Quality:
    #: the device tier's 2-opt gap instead of blossom exactness.
    matcher: str = "auto"
    #: Step-2 backend: "auto" only (the port picks it by device).
    pair_impl: str = "auto"
    #: Minimum cost improvement the refine/repair 2-opt tiers act on.
    #: Counter noise wiggles near-tie pair costs at the 1e-3..1e-2 level per
    #: quantum; swaps below this floor churn the pairing without moving
    #: ground-truth quality (hundreds of swaps/quantum at cluster N, each
    #: O(P)).  Full re-matches (the exact/cold paths) never use it.
    refine_eps: float = 1e-2
    #: Swap budget per refine/repair pass.  Bounds the matcher's latency on
    #: a single quantum; the 2-opt applies best-improvement-first, so the
    #: budget takes the swaps that matter and the residual (sub-noise)
    #: drift is repaired over the following quanta.
    refine_max_swaps: int = 24


def cold_config() -> StreamingConfig:
    """The batch SYNPA path verbatim: stateless inverse + full re-match
    every quantum.  The reference arm of the online benchmarks."""
    return StreamingConfig(warm=False, incremental=False, rematch="full")


def exact_config() -> StreamingConfig:
    """Bit-identical to ``SynpaScheduler.schedule`` on static populations
    (same fused dispatch + full re-match), incremental repair only on churn
    quanta — the safety configuration when bitwise reproducibility matters
    more than policy latency.  With the (stateless) Gauss-Newton inverse
    the only thing this switches off versus the default config is the
    ``refine`` matcher tier above ``BLOSSOM_MAX_N``."""
    return StreamingConfig(warm=False, incremental=True, rematch="full")


class StreamingAllocator(OnlinePolicy):
    """SYNPA through the fused step + incremental re-matching, on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``; the model is
    moved there).  The ST estimate state ``_st`` stays on the device.

    ``timings`` holds, for every quantum that ran the step, the host
    clock's ``(step_s, copy_s, match_s)``: the fused step until it returns,
    the cost (or partner) copy and the host matcher."""

    def __init__(
        self,
        method: isc.StackMethod,
        model: regression.CategoryModel,
        config: Optional[StreamingConfig] = None,
        name: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.method = method
        self.model = model.to(self.device)
        self.cfg = cfg = config or StreamingConfig()
        check_impl(cfg.pair_impl)
        # The auto-name reflects matcher statefulness (the inverse is
        # stateless under the default GN solver): cold = full re-match
        # every quantum, stream = anything that carries pairing state.
        mode = "stream" if (cfg.incremental or cfg.rematch != "full") \
            else "cold"
        self.name = name or (
            f"SYNPA{method.n_categories}_{method.name.split('_', 1)[1]}"
            f"-{mode}"
        )
        self._uniform = torch.as_tensor(
            isc.uniform_stack(method.n_categories), device=self.device)
        hb_steps = (
            cfg.warm_steps if (cfg.solver == "hb" and cfg.warm)
            else cfg.cold_steps
        )
        self._step = make_fused_step(
            method, self.model, impl=cfg.pair_impl, solver=cfg.solver,
            gn_steps=cfg.gn_steps, hb_steps=hb_steps, warm=cfg.warm,
        )
        self.timings: List[Tuple[float, float, float]] = []

    # ------------------------------------------------------------ lifecycle
    def reset(self, machine, rng: np.random.Generator) -> None:
        super().reset(machine, rng)
        self._st = None    # (capacity, 4) ST estimates on the device
        self.timings = []

    def _ensure_state(self, capacity: int) -> None:
        if self._st is None or self._st.shape[0] != capacity:
            self._st = self._uniform.repeat(capacity, 1)

    def _apply_hints(self, hints, arrived_set) -> List[int]:
        """Seed arrived slots' ST estimates from admission hints.

        Returns the hinted slot list (they skip the fresh-mask reset).  One
        small ``index_put_`` on the device-resident state, churn quanta
        only.
        """
        if not hints:
            return []
        slots = sorted(int(s) for s in hints if int(s) in arrived_set)
        if not slots:
            return []
        vals = np.stack([
            np.asarray(hints[s], np.float32).reshape(isc.N_CATS)
            for s in slots
        ])
        self._st.index_put_(
            (to_device(np.asarray(slots, np.int64), torch.int64,
                                self.device),),
            to_device(vals, torch.float32, self.device))
        return slots

    # ------------------------------------------------------------- pairing
    def pair(self, q, active, counters, ran, arrived, departed,
             prev_pairs, prev_solo, hints=None):
        active = np.asarray(active, np.int64)
        arrived_set = set(int(s) for s in arrived)
        capacity = int(counters.shape[0])
        if not prev_pairs and prev_solo is None:
            # First quantum with runnable applications: no counters yet.
            self._st = None
            self._ensure_state(capacity)
            self._apply_hints(hints, arrived_set)
            return self._random_pairing(active)
        self._ensure_state(capacity)

        # --- Build the fused-dispatch masks from the previous quantum.
        partner = np.arange(capacity, dtype=np.int32)
        masks = np.zeros((4, capacity), bool)   # solve, solo, valid, fresh
        if prev_pairs:
            pp = np.asarray(prev_pairs, np.int64).reshape(-1, 2)
            both_ran = ran[pp[:, 0]] & ran[pp[:, 1]]
            pa, pb = pp[both_ran, 0], pp[both_ran, 1]
            partner[pa], partner[pb] = pb, pa
            masks[0, pa] = masks[0, pb] = True
        if prev_solo is not None and ran[prev_solo]:
            masks[1, prev_solo] = True
        masks[2, active] = True
        if arrived_set:
            masks[3, list(arrived_set)] = True
        hinted = self._apply_hints(hints, arrived_set)
        if hinted:
            # A hinted newcomer scores with its profiled stack, not the
            # uniform placeholder: keep the fused step from resetting it.
            masks[3, hinted] = False
        a_count = int(active.size)
        odd = a_count % 2 == 1

        # --- Steps 0-2 + cost prep: one step on the device, one copy back.
        # The ST estimate state stays on the device: the returned ``st``
        # feeds the next quantum's call directly.
        dev = self.device
        t0 = time.perf_counter()
        cost_dev, self._st = self._step(
            to_device(np.asarray(counters, np.float32),
                               torch.float32, dev),
            to_device(partner, torch.int64, dev),
            self._st,
            to_device(masks, torch.bool, dev),
            odd,
        )
        t1 = time.perf_counter()

        if a_count == 1:
            self.timings.append((t1 - t0, 0.0, 0.0))
            return [], int(active[0])

        # --- Step 3 (device tier): sort seed + parallel 2-opt on the
        # padded matrix on the device; only the (P,) partner vector comes
        # back.  Slots are vertices directly (no compact remap); the idle
        # vertex is row ``capacity``.
        if self.cfg.matcher == "device":
            valid = np.zeros(int(cost_dev.shape[0]), bool)
            valid[active] = True
            if odd:
                valid[capacity] = True
            pairs_v = matching.device_pairs(
                cost_dev, valid, eps=self.cfg.refine_eps
            )
            out: List[Pair] = []
            solo: Optional[int] = None
            for x, y in pairs_v:
                if capacity in (x, y):
                    solo = x if y == capacity else y
                else:
                    out.append((x, y))
            self.timings.append((t1 - t0, time.perf_counter() - t1, 0.0))
            return out, solo

        host = host_cost(cost_dev)
        t2 = time.perf_counter()
        # --- Step 3: (incremental) matching on the compact active set.
        rows = [int(s) for s in active] + ([capacity] if odd else [])
        cost = matching.compact_cost(host, rows)
        nv = len(rows)
        compact = {int(s): k for k, s in enumerate(active)}
        idle = nv - 1 if odd else None

        churn = bool(arrived_set) or bool(departed) or (
            prev_solo is not None and not odd
        )
        kept_slots, _ = self._surviving(active, arrived, prev_pairs)
        kept = [(compact[a], compact[b]) for a, b in kept_slots]
        if prev_solo is not None and int(prev_solo) in compact and \
                int(prev_solo) not in arrived_set and odd and not churn:
            kept.append((compact[int(prev_solo)], idle))

        if churn and self.cfg.incremental and kept:
            covered = {v for p in kept for v in p}
            dirty = [v for v in range(nv) if v not in covered]
            pairs_c = matching.repair_pairs(
                cost, kept, dirty, eps=self.cfg.refine_eps,
                max_swaps=self.cfg.refine_max_swaps,
            )
        else:
            mode = self.cfg.rematch
            if mode == "auto":
                mode = "full" if nv <= matching.BLOSSOM_MAX_N else "refine"
            if mode == "refine" and not churn and len(kept) == nv // 2:
                pairs_c = matching.refine_pairs(
                    cost, kept, eps=self.cfg.refine_eps,
                    max_swaps=self.cfg.refine_max_swaps,
                )
            else:
                pairs_c = matching.min_cost_pairs(
                    cost, method=self.cfg.matcher
                )

        # Map back to slot space; the idle partner becomes the solo slot.
        inv = {k: int(s) for s, k in compact.items()}
        out: List[Pair] = []
        solo: Optional[int] = None
        for x, y in pairs_c:
            if idle is not None and idle in (x, y):
                solo = inv[x if y == idle else y]
            else:
                out.append((inv[x], inv[y]))
        self.timings.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        return out, solo


class StreamingScheduler(Scheduler):
    """Closed-system adapter: the streaming allocator as a drop-in
    :class:`repro_torch.core.synpa.Scheduler`, on ``device`` (``cuda``
    unless the caller passes ``"cpu"``).

    Lets ``SMTMachine.run_workload``/``run_quanta`` race the streaming
    path directly against the batch :class:`SynpaScheduler` on the *same*
    fixed population — the exactness and policy-cost comparisons of the
    acceptance tests.  Consumes the policy RNG exactly like SynpaScheduler
    (one permutation before samples exist), so a run only diverges if the
    chosen pairings do.
    """

    def __init__(
        self,
        method: isc.StackMethod,
        model: regression.CategoryModel,
        config: Optional[StreamingConfig] = None,
        name: Optional[str] = None,
        device=None,
    ):
        self._alloc = StreamingAllocator(method, model, config=config,
                                         device=device)
        self.device = self._alloc.device
        self.name = name or self._alloc.name

    def reset(self, n_apps: int, rng: np.random.Generator, machine=None) -> None:
        super().reset(n_apps, rng, machine)
        self._alloc.reset(machine, rng)

    def schedule(self, quantum, samples, prev_pairs):
        if not self._have_samples(samples) or not prev_pairs:
            return self._random_pairs()
        counters = self._counters_array(samples)
        active = np.arange(self.n_apps, dtype=np.int64)
        ran = np.ones(self.n_apps, bool)
        pairs, solo = self._alloc.pair(
            quantum, active, counters, ran, arrived=(), departed=(),
            prev_pairs=[tuple(p) for p in prev_pairs], prev_solo=None,
        )
        assert solo is None, "closed populations are even"
        return pairs
