"""The churn grid as one run: :func:`run_device_sim_batched`.

A scenario grid (seeds x load points x admission rules x fault profiles)
over one machine and one pool runs as a single open-system run whose
every tensor carries a leading **lane** axis: each quantum's device
operations launch once for the whole grid, not once a scenario.  It is
the loop of :mod:`repro_torch.online.device_sim` (a single run there is a
grid of one lane), so lane i of a grid is the run of scenario i alone.

What lanes share and what they own:

* **Shared** — the profiled :class:`repro_torch.smt.scan_engine.
  DeviceTables`, the synergy admission tables, the machine params, the
  capacity, the horizon and the policy (its stack method and model by
  identity).  Lanes are scenarios over the same machine and pool.
* **Per lane** — the pre-sampled job arrays (arrival quantum, pool row,
  target), re-padded to the grid's largest padded job count (padding
  jobs arrive at ``n_quanta``, never, and have an infinite target, so a
  wider pad changes no trajectory), the draws, the admission rule and,
  when any lane is faulted, the fault schedule and the retry knobs.

**Divergent control flow is masked data.**  A grid whose lanes admit
differently computes both rules every quantum and selects one per lane;
synergy's trip count is the largest any synergy lane needs, so fifo
lanes add no trips.  Retry knobs are (L, 1) tensors, and an unfaulted
lane of a faulted grid rides an all-up schedule at unit speed (eviction
never fires, and multiplying by exactly 1.0 changes no value).

**Host syncs do not grow with the grid.**  Each counted exit is read once
for all lanes: the GN fallback flag (``regression.NEED_FB_SYNCS``) once a
synpa quantum, the 2-opt's flag (``matching.TWO_OPT_SYNCS``) at most once
per block of rounds, and synergy's trip count (``device_sim.
ADMIT_SYNCS``) once a quantum when any lane admits by synergy.  Each lane
keeps its own device-side freezes (GN ``go``, the 2-opt's ``improved``),
so a lane that has converged stops changing, as it would alone.

**Draws are data.**  ``draws`` gives each quantum's numbers for all lanes;
the default is one :class:`repro_torch.smt.scan_engine.TorchDraws` a lane,
keyed from that lane's seed, so lane i sees the numbers ``run_device_sim``
of scenario i sees.  They cost two small launches a lane a quantum.

Timing: the lanes of one run are indivisible, so per-lane ``policy_s``
is the grid's median wall over ``L * n_quanta``: the cost a scenario.

Telemetry: each lane's rings are the rows of its own lane, so they equal
its single run's bit for bit; per-lane means divide by that lane's own
active count.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.online.device_sim import (
    DEVICE_SIM_KINDS,
    _lane_stats,
    _prepare_inputs,
    _run_lanes,
)
from repro_torch.smt.metrics import OnlineStats
from repro_torch.smt.scan_engine import LaneDraws, ScanPolicy, TorchDraws


def _spec_statics(spec: ScanPolicy):
    """What lanes of one grid must share of their policy (the method and
    model by identity)."""
    return (spec.kind, id(spec.method), id(spec.model), spec.matcher,
            spec.refine_eps, spec.refine_rounds)


def _check_lanes(sims) -> None:
    """Refuse a grid whose lanes cannot share one run."""
    if not sims:
        raise ValueError("a batched run needs at least one scenario lane")
    base = sims[0]
    statics = _spec_statics(base.policy)
    for s in sims:
        if s.engine != "scan":
            raise ValueError("batched lanes must be scan-engine sims")
        if s.policy.kind not in DEVICE_SIM_KINDS:
            raise ValueError(f"policy kind {s.policy.kind!r} is not one the "
                             "open system runs")
        if s.capacity != base.capacity:
            raise ValueError(f"lane capacity {s.capacity} differs from "
                             f"{base.capacity}")
        if s.machine.params != base.machine.params:
            raise ValueError("lane machine params differ")
        if _spec_statics(s.policy) != statics:
            raise ValueError("batched lanes must share their policy (method "
                             f"and model by identity): {s.policy} vs "
                             f"{base.policy}")
        if s.tables is not base.tables:
            raise ValueError("batched lanes must share one profiled "
                             "PhaseTables instance")
        if s.device != base.device:
            raise ValueError(f"lane device {s.device} differs from "
                             f"{base.device}")


def _shared_synergy_tables(sims, preps):
    """The admission tables every synergy lane agrees on (the first lane's
    zeros when no lane admits by synergy: fifo lanes never read them)."""
    syn = [p for s, p in zip(sims, preps) if s.admission == "synergy"]
    first = syn[0] if syn else preps[0]
    tables = tuple(first[k] for k in ("syn_cost", "syn_mean", "syn_stacks"))
    for p in syn[1:]:
        if not all(np.array_equal(p[k], t) for k, t in zip(
                ("syn_cost", "syn_mean", "syn_stacks"), tables)):
            raise ValueError("synergy lanes must share admission tables")
    return tables


def _grid(sims, n_quanta: int, draws=None):
    """A checked grid's host prologue: each lane's prepared inputs, the
    grid's padded job count, the shared synergy tables and the lane
    draws (one ``TorchDraws`` a lane by default)."""
    _check_lanes(sims)
    preps = [_prepare_inputs(s, n_quanta) for s in sims]
    j_pad = max(p["j_pad"] for p in preps)
    syn_tables = _shared_synergy_tables(sims, preps)
    if draws is None:
        draws = LaneDraws([TorchDraws(s.seed, s.device) for s in sims])
    return preps, j_pad, syn_tables, draws


def run_device_sim_batched(sims: Sequence, n_quanta: int, repeats: int = 1,
                           warmup: bool = True, draws=None,
                           telemetry: bool = False,
                           app_telemetry: bool = False) -> List[OnlineStats]:
    """Run a list of :class:`repro_torch.online.sim.ClusterSim` scenarios as
    one lane-batched run on their device; returns each lane's
    :class:`OnlineStats` in input order, each equal to
    :func:`repro_torch.online.device_sim.run_device_sim` of that scenario
    on the same draws.

    The scenarios must share the machine params, capacity, profiled tables
    (one instance), policy (method and model by identity) and device;
    they may differ in seed, arrivals, admission rule and fault profile.
    Synergy lanes must agree on their admission tables.  ``repeats`` and
    ``warmup`` follow ``run_device_sim``; per-lane ``policy_s`` spreads
    the grid's median wall over ``L * n_quanta``.  ``draws`` (a
    :class:`repro_torch.smt.scan_engine.LaneDraws` or alike) defaults to
    one ``TorchDraws`` a lane keyed from its sim's seed.  ``telemetry``
    and ``app_telemetry`` attach each lane's rings to its stats, each
    equal bit for bit to the ring of its scenario run alone.
    """
    sims = list(sims)
    preps, j_pad, syn_tables, draws = _grid(sims, n_quanta, draws)
    fetched, wall = _run_lanes(sims, preps, n_quanta, j_pad, syn_tables,
                               repeats, warmup, draws, telemetry=telemetry,
                               app_telemetry=app_telemetry)
    per_quantum = wall / max(len(sims) * n_quanta, 1)
    with obs_trace.span("device_sim.stats", lanes=len(sims)):
        return [_lane_stats(sim, prep, n_quanta, fetched, i, per_quantum,
                            telemetry=telemetry, app_telemetry=app_telemetry)
                for i, (sim, prep) in enumerate(zip(sims, preps))]
