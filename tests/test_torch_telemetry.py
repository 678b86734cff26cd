"""The port's telemetry rings against the reference's, on the CPU.

The reference's draws are data (``JaxDraws``, ``LaneDraws``), and the
fitted ``SYNPA4_R-FEBE`` model is carried across, so both packages run the
same trajectories and record rings of the same quanta:

* the field catalogues are the reference's;
* the closed race (``run_quanta_scan``, N = 15 and 64, 8 quanta, linux,
  random and synpa4) and the open system (capacity 16, 24 quanta: synpa4
  fifo, synergy, fifo under a crash wave, and adjacent) record the
  reference's rings, ``CLOSED_FIELDS`` / ``OPEN_FIELDS`` and
  ``APP_FIELDS``;
* a run with rings equals the run without them bit for bit;
* the lanes of a batched grid and of a seed-batched race record their
  single runs' rings bit for bit;
* ``make_fused_step(with_diag=True)`` and
  ``device_repair_partner(with_diag=True)`` report the reference's
  diagnostics.

Tolerances.  Integer-valued columns (queue indices, counts, app ids,
2-opt rounds, dirty vertices, GN step counts and fallbacks) are exact.
Float columns are held to rtol 1e-4: sums over contexts and slots run in
each library's order.  Two float columns get more room, for reasons of
the quantity, not of the port: ``gn_residual_max`` is the worst final
residual of a Gauss-Newton solve, a squared norm of about 1e-5 that
rounds through eight LM steps in float32 (the regression parity test
holds residuals to rtol 1e-3, atol 1e-7, and so does this one), and the
app ring's ``residual`` is a difference of two columns that each carry
rtol 1e-4, so it is held to 1e-4 of the predicted slowdown it was
subtracted from; the ST estimates are held to atol 1e-5, as
``tests/test_torch_synpa.py`` holds the solve's ST stacks.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.core import matching as jmat  # noqa: E402
from repro.core import synpa as jsyn  # noqa: E402
from repro.obs import telemetry as jtlm  # noqa: E402
from repro.online import ClusterSim as JClusterSim  # noqa: E402
from repro.online import PoissonArrivals as JPoissonArrivals  # noqa: E402
from repro.online import SynergyAdmission as JSynergyAdmission  # noqa: E402
from repro.online import faults as jflt  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import scan_engine as jse  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro.smt.apps import pool_profiles as j_pool  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.core import synpa as tsyn  # noqa: E402
from repro_torch.obs import telemetry as ttlm  # noqa: E402
from repro_torch.online import (  # noqa: E402
    ClusterSim,
    PoissonArrivals,
    SynergyAdmission,
    run_device_sim_batched,
)
from repro_torch.online import device_sim as tds  # noqa: E402
from repro_torch.online import faults as tflt  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import scan_engine as tse  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402
from repro_torch.smt.apps import pool_profiles as t_pool  # noqa: E402
from test_torch_online import _assert_integer_logs_equal, _finish  # noqa: E402
from test_torch_scan_engine import JaxDraws  # noqa: E402

RACE_QUANTA = 8
OPEN_QUANTA = 24
N_CORES = 8           # capacity 16
SEED = 11

#: Columns of each ring whose values are integers: held exactly.
CLOSED_INT = ("two_opt_rounds", "gn_iters_max", "gn_fallbacks")
OPEN_INT = ("queue_head", "queue_tail", "queue_depth", "admissions",
            "departures", "active", "solo", "repair_dirty",
            "two_opt_rounds", "gn_iters_max", "gn_fallbacks") \
    + ttlm.FAULT_FIELDS


@pytest.mark.parametrize("name", [
    "FUSED_DIAG_FIELDS", "CLOSED_FIELDS", "FAULT_FIELDS", "OPEN_FIELDS",
    "APP_FIELDS", "APP_ST_WIDTH"])
def test_field_catalogues_are_the_reference(name):
    assert getattr(ttlm, name) == getattr(jtlm, name)


def _assert_ring_close(got, want, fields, ints, what):
    """``got`` (port) against ``want`` (reference): (Q, F) rings."""
    assert got.shape == want.shape, what
    for k, f in enumerate(fields):
        g, w = got[:, k], want[:, k]
        if f in ints:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")
        elif f == "gn_residual_max":
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7,
                                       err_msg=f"{what} {f}")
        elif f == "gn_iters_mean":
            # A mean of integer step counts over the quantum's solves.
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-12,
                                       err_msg=f"{what} {f}")


def _assert_app_ring_close(got, want, what):
    """(Q, S, 9) per-app rings: identities exact, slowdowns rtol 1e-4,
    the residual to 1e-4 of its prediction, ST estimates atol 1e-5."""
    assert got.shape == want.shape, what
    f = ttlm.APP_FIELDS.index
    for col in ("app_id", "partner_app_id"):
        np.testing.assert_array_equal(got[..., f(col)], want[..., f(col)],
                                      err_msg=f"{what} {col}")
    for col in ("pred_cost", "real_slowdown"):
        np.testing.assert_allclose(got[..., f(col)], want[..., f(col)],
                                   rtol=1e-4, err_msg=f"{what} {col}")
    np.testing.assert_allclose(
        got[..., f("residual")], want[..., f("residual")], rtol=0,
        atol=1e-4 * max(np.abs(want[..., f("pred_cost")]).max(), 1.0),
        err_msg=f"{what} residual")
    np.testing.assert_allclose(got[..., 5:], want[..., 5:], rtol=0,
                               atol=1e-5, err_msg=f"{what} st")


@pytest.fixture(scope="module")
def env():
    """Both packages' machines, pools and fitted SYNPA4_R-FEBE models."""
    jmach = jmc.SMTMachine(jmc.MachineParams(), seed=0)
    jm = jtr.build_all_models(
        jmach, methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE})[0][
            "SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    tpool = t_pool()
    return dict(jmach=jmach, tmach=tmc.SMTMachine(tmc.MachineParams(), seed=0),
                jm=jm, tm=tm, jpool=j_pool(), tpool=tpool,
                ttables=tmc.PhaseTables.build(tpool))


def _race_policies(env):
    jpol = {"linux": jse.ScanPolicy(kind="linux"),
            "random": jse.ScanPolicy(kind="static"),
            "synpa4": jse.ScanPolicy(kind="synpa", method=jisc.SYNPA4_R_FEBE,
                                     model=env["jm"])}
    tpol = {"linux": tse.ScanPolicy(kind="linux"),
            "random": tse.ScanPolicy(kind="static"),
            "synpa4": tse.ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                                     model=env["tm"])}
    return jpol, tpol


@pytest.fixture(scope="module", params=[15, 64])
def race(request, env):
    """The closed race with both rings in both packages, and the port's
    race without rings, at N = 15 (odd: the idle vertex) and N = 64."""
    n = request.param
    jpol, tpol = _race_policies(env)
    jprofs = jwl.scaled_workload(n + n % 2, seed=n)[:n]
    tprofs = twl.scaled_workload(n + n % 2, seed=n)[:n]
    want = jse.run_quanta_scan(env["jmach"], jprofs, jpol,
                               n_quanta=RACE_QUANTA, seed=5,
                               app_telemetry=True)
    syncs = (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS)
    got = tse.run_quanta_scan(env["tmach"].params, tprofs, tpol,
                              n_quanta=RACE_QUANTA, seed=5, device="cpu",
                              draws=JaxDraws(5), repeats=0,
                              app_telemetry=True)
    mid = (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS)
    off = tse.run_quanta_scan(env["tmach"].params, tprofs, tpol,
                              n_quanta=RACE_QUANTA, seed=5, device="cpu",
                              draws=JaxDraws(5), repeats=0)
    end = (treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS)
    ring_syncs = tuple(b - a for a, b in zip(syncs, mid))
    plain_syncs = tuple(b - a for a, b in zip(mid, end))
    return n, got, want, off, ring_syncs, plain_syncs


def test_closed_rings_match_reference(race):
    n, got, want, _, _, _ = race
    for name in want:
        g, w = got[name], want[name]
        assert g.telemetry.data.shape == (RACE_QUANTA, 8)
        assert g.app_telemetry.data.shape == (RACE_QUANTA, n, 9)
        _assert_ring_close(g.telemetry.data, w.telemetry.data,
                           ttlm.CLOSED_FIELDS, CLOSED_INT, f"N={n} {name}")
        _assert_app_ring_close(g.app_telemetry.data, w.app_telemetry.data,
                               f"N={n} {name}")
    # linux and random predict nothing: their policy fields are zero.
    for name in ("linux", "random"):
        assert not got[name].telemetry.data[:, 2:].any(), name
    # synpa4's first quantum runs no policy; its later ones do.
    syn = got["synpa4"].telemetry
    assert not syn.data[0, 2:].any()
    assert (syn.timeline("pred_cost_mean")[1:] > 0).all()
    assert (syn.timeline("two_opt_rounds")[1:] >= 1).all()


def test_closed_ring_on_equals_off(race):
    """Rings only read: the race's results are the plain race's, bit for
    bit, with the same host syncs."""
    _, got, _, off, ring_syncs, plain_syncs = race
    for name in off:
        assert got[name].total_retired == off[name].total_retired, name
        assert got[name].mean_true_slowdown == off[name].mean_true_slowdown
        np.testing.assert_array_equal(got[name].ipc, off[name].ipc)
        assert off[name].telemetry is None
    assert ring_syncs == plain_syncs


def test_closed_seed_lanes_record_their_single_rings(env):
    """Each seed lane's rings are its single race's, bit for bit."""
    _, tpol = _race_policies(env)
    profs = twl.scaled_workload(16, seed=16)
    seeds = [3, 11]
    lanes = tse.run_quanta_multi_batched(
        env["tmach"], profs, tpol, seeds, n_quanta=RACE_QUANTA,
        device="cpu", repeats=0, app_telemetry=True,
        draws=tse.LaneDraws([JaxDraws(s) for s in seeds]))
    for i, seed in enumerate(seeds):
        single = tse.run_quanta_scan(
            env["tmach"].params, profs, tpol, n_quanta=RACE_QUANTA,
            seed=seed, device="cpu", draws=JaxDraws(seed), repeats=0,
            app_telemetry=True)
        for name in tpol:
            np.testing.assert_array_equal(lanes[name][i].telemetry.data,
                                          single[name].telemetry.data)
            np.testing.assert_array_equal(
                lanes[name][i].app_telemetry.data,
                single[name].app_telemetry.data)


# ------------------------------------------------------------ open system
def _crash_wave(mod):
    k = max(1, N_CORES // 8)
    crash = tuple((OPEN_QUANTA // 4 + i % 3, i) for i in range(k))
    heal = tuple(((3 * OPEN_QUANTA) // 4 + i % 3, i) for i in range(k))
    return mod.FaultProfile(fail=crash, recover=heal)


#: Open-system cases: (policy kind, admission, faulted).
OPEN_CASES = {
    "adjacent": ("adjacent", "fifo", False),
    "fifo": ("synpa", "fifo", False),
    "synergy": ("synpa", "synergy", False),
    "crash_wave": ("synpa", "fifo", True),
}


@pytest.fixture(scope="module")
def synergy(env):
    return (JSynergyAdmission(env["jmach"], env["jpool"], jisc.SYNPA4_R_FEBE,
                              env["jm"], quanta=12),
            SynergyAdmission(env["tmach"], env["tpool"], tisc.SYNPA4_R_FEBE,
                             env["tm"], quanta=12))


def _open_sims(env, synergy, case, seed=SEED, rate=1.5):
    kind, admission, faulted = OPEN_CASES[case]
    if kind == "adjacent":
        jpol, tpol = (jse.ScanPolicy(kind="adjacent"),
                      tse.ScanPolicy(kind="adjacent"))
    else:
        jpol = jse.ScanPolicy(kind="synpa", method=jisc.SYNPA4_R_FEBE,
                              model=env["jm"])
        tpol = tse.ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                              model=env["tm"])
    jkw, tkw = dict(admission=admission), dict(admission=admission)
    if admission == "synergy":
        jkw["synergy"], tkw["synergy"] = synergy
    if faulted:
        jkw["faults"], tkw["faults"] = _crash_wave(jflt), _crash_wave(tflt)
    jsim = JClusterSim(env["jmach"], env["jpool"], N_CORES, jpol,
                       JPoissonArrivals(rate=rate, n_pool=len(env["jpool"])),
                       seed=seed, target_scale=0.08, engine="scan", **jkw)
    tsim = ClusterSim(env["tmach"], env["tpool"], N_CORES, tpol,
                      PoissonArrivals(rate=rate, n_pool=len(env["tpool"])),
                      seed=seed, target_scale=0.08, tables=env["ttables"],
                      engine="scan", device="cpu", **tkw)
    return jsim, tsim


@pytest.fixture(scope="module")
def open_runs(env, synergy):
    """Per case: the reference's run with both rings, the port's with
    both rings and the port's without, on the same draws, with the
    port's host syncs over each of its two runs."""
    out = {}
    counters = (treg, "NEED_FB_SYNCS"), (tmat, "TWO_OPT_SYNCS"), \
        (tds, "ADMIT_SYNCS")

    def counted(fn):
        before = [getattr(m, c) for m, c in counters]
        res = fn()
        return res, tuple(getattr(m, c) - b
                          for (m, c), b in zip(counters, before))

    for case in OPEN_CASES:
        jsim, tsim = _open_sims(env, synergy, case)
        want = jsim.run(OPEN_QUANTA, app_telemetry=True)
        got, s_on = counted(lambda: tsim.run(
            OPEN_QUANTA, draws=JaxDraws(SEED), warmup=False,
            app_telemetry=True))
        off, s_off = counted(lambda: tsim.run(
            OPEN_QUANTA, draws=JaxDraws(SEED), warmup=False))
        out[case] = (got, want, off, s_on, s_off)
    return out


@pytest.mark.parametrize("case", list(OPEN_CASES))
def test_open_rings_match_reference(open_runs, case):
    got, want, _, _, _ = open_runs[case]
    assert got.n_completed > 0
    _assert_integer_logs_equal(got, want)
    assert got.telemetry.data.shape == (OPEN_QUANTA, 21)
    assert got.app_telemetry.data.shape == (OPEN_QUANTA, 2 * N_CORES, 9)
    _assert_ring_close(got.telemetry.data, want.telemetry.data,
                       ttlm.OPEN_FIELDS, OPEN_INT, f"open {case}")
    _assert_app_ring_close(got.app_telemetry.data, want.app_telemetry.data,
                           f"open {case}")
    if OPEN_CASES[case][2]:
        assert got.telemetry.timeline("evictions").sum() > 0


@pytest.mark.parametrize("case", list(OPEN_CASES))
def test_open_ring_on_equals_off(open_runs, case):
    """The run with rings is the run without, bit for bit, with the same
    host syncs; the ring's queue, active, solo and traffic columns are
    the stats' own timelines."""
    got, _, off, s_on, s_off = open_runs[case]
    _assert_integer_logs_equal(got, off)
    np.testing.assert_array_equal(_finish(got), _finish(off))
    assert got.mean_slowdown == off.mean_slowdown
    assert s_on == s_off
    tl = got.telemetry
    for col, series in (("queue_depth", got.queue_depth),
                        ("active", got.active),
                        ("solo", got.solo_quanta),
                        ("admissions", got.admissions),
                        ("departures", got.departures)):
        np.testing.assert_array_equal(tl.timeline(col), series, err_msg=col)
    np.testing.assert_array_equal(
        tl.timeline("queue_tail") - tl.timeline("queue_head"),
        tl.timeline("queue_depth"))
    assert "tlm_repair_dirty" in got.timelines()
    # Empty contexts record app and partner ids -1 and zeros elsewhere.
    app = got.app_telemetry
    empty = app.data[~app.valid()]
    assert (empty[:, :2] == -1).all() and (empty[:, 2:] == 0).all()
    assert (app.valid().sum(1) == got.active).all()


def test_grid_lanes_record_their_single_rings(env, synergy):
    """A mixed grid (fifo, synergy and faulted lanes): each lane's rings
    equal its scenario's single run's bit for bit."""
    cases = [("fifo", 5, 1.2), ("synergy", 9, 1.8), ("crash_wave", 7, 1.4)]
    tsims = [_open_sims(env, synergy, c, seed=s, rate=r)[1]
             for c, s, r in cases]
    draws = tse.LaneDraws([JaxDraws(s.seed) for s in tsims])
    grid = run_device_sim_batched(tsims, OPEN_QUANTA, warmup=False,
                                  draws=draws, app_telemetry=True)
    for sim, g in zip(tsims, grid):
        single = tds.run_device_sim(sim, OPEN_QUANTA, warmup=False,
                                    draws=JaxDraws(sim.seed),
                                    app_telemetry=True)
        _assert_integer_logs_equal(g, single)
        np.testing.assert_array_equal(g.telemetry.data, single.telemetry.data)
        np.testing.assert_array_equal(g.app_telemetry.data,
                                      single.app_telemetry.data)
    assert grid[2].telemetry.timeline("failures").sum() > 0
    assert not grid[0].telemetry.timeline("failures").any()


# ----------------------------------------------------- step diagnostics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_step_diag_matches_reference(env, seed):
    """``make_fused_step(with_diag=True)``: the same cost and ST as the
    plain step, and the reference's diagnostics (step counts and
    fallbacks exact, the residual as the regression test holds it)."""
    rng = np.random.default_rng(seed)
    n = 15
    counters = np.concatenate([
        np.full((n, 1), 1e6, np.float32),
        rng.uniform(1e4, 4e5, (n, 2)).astype(np.float32),
        rng.uniform(2e5, 9e5, (n, 2)).astype(np.float32)], 1)
    partner = np.arange(n) ^ 1
    partner[partner >= n] = n - 1
    partner[n - 1] = n - 1
    solve = partner != np.arange(n)
    masks = np.stack([solve, ~solve, np.ones(n, bool), np.zeros(n, bool)])
    prev = np.tile(jisc.uniform_stack(4), (n, 1)).astype(np.float32)
    jstep = jsyn.make_fused_step(jisc.SYNPA4_R_FEBE, env["jm"],
                                 with_diag=True)
    jc, js, jd = jstep(jnp.asarray(counters), jnp.asarray(partner, jnp.int32),
                       jnp.asarray(prev), jnp.asarray(masks),
                       jnp.asarray(True))
    args = (torch.as_tensor(counters), torch.as_tensor(partner),
            torch.as_tensor(prev), torch.as_tensor(masks), True)
    tc, ts, td = tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, env["tm"],
                                      with_diag=True)(*args)
    pc, ps = tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, env["tm"])(*args)
    assert torch.equal(tc, pc) and torch.equal(ts, ps)
    jd = np.asarray(jd)
    assert td.shape == (4,)
    np.testing.assert_allclose(td[0].item(), jd[0], rtol=1e-6)
    assert td[1].item() == jd[1] and td[3].item() == jd[3]
    np.testing.assert_allclose(td[2].item(), jd[2], rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_repair_partner_diag_matches_reference(seed):
    """``device_repair_partner(with_diag=True)``: the plain call's partner,
    and the reference's 2-opt rounds and dirty count, exactly."""
    rng = np.random.default_rng(seed)
    p = 24
    c = rng.uniform(1.0, 3.0, (p, p)).astype(np.float32)
    c = (c + c.T) / 2
    np.fill_diagonal(c, tmat.BIG)
    valid = rng.random(p) < 0.7
    if valid.sum() % 2:
        valid[np.flatnonzero(~valid)[0]] = True
    prev = np.arange(p).reshape(-1, 2)[rng.permutation(p // 2)]
    prev = np.stack([prev, prev[:, ::-1]]).reshape(2, -1)
    mate = np.empty(p, np.int64)
    mate[prev[0]] = prev[1]
    cost = np.where(valid[:, None] & valid[None, :], c, tmat.BIG)
    want = jmat.device_repair_partner(
        jnp.asarray(cost), jnp.asarray(mate, jnp.int32), jnp.asarray(valid),
        eps=1e-2, max_rounds=8, with_diag=True)
    plain = tmat.device_repair_partner(
        torch.as_tensor(cost), torch.as_tensor(mate), torch.as_tensor(valid),
        eps=1e-2, max_rounds=8)
    got = tmat.device_repair_partner(
        torch.as_tensor(cost), torch.as_tensor(mate), torch.as_tensor(valid),
        eps=1e-2, max_rounds=8, with_diag=True)
    assert torch.equal(got[0], plain)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    assert int(got[2]) > 0


def test_adjacent_ring_has_zero_policy_fields(env):
    """``adjacent`` predicts nothing: its policy and GN fields are zero,
    and a dataclass copy of the policy records the same ring."""
    pol = tse.ScanPolicy(kind="adjacent")
    sim = ClusterSim(env["tmach"], env["tpool"], 2, pol,
                     PoissonArrivals(rate=1.0, n_pool=len(env["tpool"])),
                     engine="scan", device="cpu")
    a = sim.run(6, warmup=False, telemetry=True)
    sim.policy = dataclasses.replace(pol, name="adjacent")
    b = sim.run(6, warmup=False, telemetry=True)
    pol_cols = [ttlm.OPEN_FIELDS.index(f) for f in (
        "pred_cost_mean", "repair_dirty", "two_opt_rounds")
        + ttlm.FUSED_DIAG_FIELDS]
    assert not a.telemetry.data[:, pol_cols].any()
    np.testing.assert_array_equal(a.telemetry.data, b.telemetry.data)
    assert b.telemetry.policy == "adjacent"
