"""Parity of the closed race ``repro_torch.smt.scan_engine`` with the
reference's ``repro.smt.scan_engine.run_quanta_scan``.

Random draws are data: :class:`JaxDraws` hands the port the reference's
own threefry draws, taken from the engine's documented keys (machine key
``PRNGKey(seed)``, counter noise ``fold_in(fold_in(key, q), 0)``, phase
durations ``fold_in(fold_in(key, q), 1)``, the k-th policy's migration
draw ``fold_in(fold_in(PRNGKey(seed + 7919), k), q)`` split three ways).
With the same fitted ``SYNPA4_R-FEBE`` coefficients, the whole race at
N in {16, 15} (8 quanta, all three policy kinds) must agree per policy on
``total_retired`` and ``mean_true_slowdown`` to rtol 1e-4.  A free-running
race on the port's own ``torch.Generator`` draws is held to the scheduler's
own check: ``synpa4`` beats ``random`` on mean true slowdown; and the
port's draws are held to the reference's distributions: the counter
noise's lognormal moments, the phase-length draws' Poisson moments, and
a free-running static race's aggregates against the reference engine's
within 3% (the card's twin of all three is
``test_torch_scan_engine_gpu.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import scan_engine as jse  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro.smt import workloads as jwl  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    category_model_from_numpy,
    device_tables_from_numpy,
)
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import scan_engine as tse  # noqa: E402
from repro_torch.smt import workloads as twl  # noqa: E402

N_QUANTA = 8


class JaxDraws:
    """The reference engine's threefry draws, as CPU tensors."""

    def __init__(self, seed):
        self.mkey = jax.random.PRNGKey(seed)
        self.pkey = jax.random.PRNGKey(seed + 7919)

    def _mkey(self, q, purpose):
        return jax.random.fold_in(jax.random.fold_in(self.mkey, q), purpose)

    def noise(self, q, n):
        z = jax.random.normal(self._mkey(q, 0), (n, 4), jnp.float32)
        return torch.tensor(np.asarray(z))

    def phase(self, q, lam):
        d = jax.random.poisson(self._mkey(q, 1), jnp.asarray(lam.numpy()),
                               (lam.shape[0],))
        return torch.tensor(np.asarray(d).astype(np.float32))

    def linux(self, k, q, n):
        key = jax.random.fold_in(jax.random.fold_in(self.pkey, k), q)
        k1, k2, k3 = jax.random.split(key, 3)
        x = int(jax.random.randint(k1, (), 0, n))
        y = int(jax.random.randint(k2, (), 0, n))
        u = float(jax.random.uniform(k3))
        return (torch.tensor([x]), torch.tensor([y]),
                torch.tensor([u], dtype=torch.float32))


@pytest.fixture(scope="module")
def models():
    """The reference's fitted SYNPA4_R-FEBE model and its port twin."""
    jmodels, _ = jtr.build_all_models(
        jmc.SMTMachine(jmc.MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE})
    jm = jmodels["SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    return jm, tm


def _policies(jm, tm):
    jpol = {"linux": jse.ScanPolicy(kind="linux"),
            "random": jse.ScanPolicy(kind="static"),
            "synpa4": jse.ScanPolicy(kind="synpa", method=jisc.SYNPA4_R_FEBE,
                                     model=jm)}
    tpol = {"linux": tse.ScanPolicy(kind="linux"),
            "random": tse.ScanPolicy(kind="static"),
            "synpa4": tse.ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                                     model=tm)}
    return jpol, tpol


@pytest.mark.parametrize("n", [8, 15, 16, 63])
def test_initial_pairing_matches(n):
    p = tse.fused_pad(n)
    want = jse._initial_mpart(n, p, np.random.default_rng(n + 7919))
    got = tse._initial_mpart(n, p, np.random.default_rng(n + 7919))
    np.testing.assert_array_equal(got, want)


def test_workload_and_tables_match():
    jprofs = jwl.scaled_workload(32, seed=32)
    tprofs = twl.scaled_workload(32, seed=32)
    assert [p.name for p in tprofs] == [p.name for p in jprofs]
    jt = jmc.PhaseTables.build(jprofs)
    dt = device_tables_from_numpy(jt, device="cpu")
    want = tse.DeviceTables.build(tmc.PhaseTables.build(tprofs), "cpu")
    assert dt.n_apps == want.n_apps == 32
    for field in ("n_phases", "comps", "util", "x_fe", "x_be", "duration",
                  "omega", "retire", "mem_sens", "fetch_sens"):
        assert torch.equal(getattr(dt, field), getattr(want, field)), field


def test_machine_quantum_matches():
    """One quantum on a fixed pairing: counters, slowdown and the phase
    advance against the reference's in-graph quantum."""
    n = 16
    tables = tmc.PhaseTables.build(twl.scaled_workload(n, seed=7))
    params = tmc.MachineParams()
    dt = tse.DeviceTables.build(tables, "cpu")
    jdt = jse.DeviceTables.build(jmc.PhaseTables.build(
        jwl.scaled_workload(n, seed=7)))
    partner = np.arange(n) ^ 1
    partner[3] = 3  # a solo slot
    partner[2] = 2
    state = tse._MachineState(torch.zeros(n, dtype=torch.int64),
                              dt.duration[:, 0].clone(), torch.zeros(n),
                              torch.zeros(n))
    jstate = jse._MachineState(jnp.zeros(n, jnp.int32), jdt.duration[:, 0],
                               jnp.zeros(n), jnp.zeros(n))
    quantum = tse._make_machine_quantum(dt, params)
    jquantum = jse._make_machine_quantum(jdt, jmc.MachineParams())
    draws = JaxDraws(11)
    for q in range(3):
        counters, state, slow = quantum(state, torch.as_tensor(partner),
                                        draws, q)
        jc, jstate, jslow = jquantum(jstate, jnp.asarray(partner, jnp.int32),
                                     draws.mkey, q)
        np.testing.assert_allclose(counters.numpy(), np.asarray(jc),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(slow), float(jslow), rtol=1e-6)
        np.testing.assert_array_equal(state.phase_idx.numpy(),
                                      np.asarray(jstate.phase_idx))
        np.testing.assert_array_equal(state.phase_left.numpy(),
                                      np.asarray(jstate.phase_left))
        np.testing.assert_allclose(state.total_retired.numpy(),
                                   np.asarray(jstate.total_retired),
                                   rtol=1e-6)


@pytest.mark.parametrize("n", [16, 15])
def test_race_matches_reference(models, n):
    jm, tm = models
    seed = 5
    jpol, tpol = _policies(jm, tm)
    jprofs = jwl.scaled_workload(16, seed=3)[:n]
    tprofs = twl.scaled_workload(16, seed=3)[:n]
    want = jse.run_quanta_scan(jmc.SMTMachine(jmc.MachineParams(), seed=0),
                               jprofs, jpol, n_quanta=N_QUANTA, seed=seed)
    fb, two = treg.NEED_FB_SYNCS, tmat.TWO_OPT_SYNCS
    got = tse.run_quanta_scan(tmc.MachineParams(), tprofs, tpol,
                              n_quanta=N_QUANTA, seed=seed, device="cpu",
                              draws=JaxDraws(seed), repeats=0)
    # One fallback-flag read per synpa quantum after quantum 0; the 2-opt
    # reads its flag at most once per block of SYNC_EVERY rounds.
    assert treg.NEED_FB_SYNCS - fb == N_QUANTA - 1
    assert tmat.TWO_OPT_SYNCS - two <= (
        4 * (tse.fused_pad(n) // 2) // tmat.SYNC_EVERY
        + (N_QUANTA - 2) * -(-8 // tmat.SYNC_EVERY))
    for name in jpol:
        g, w = got[name], want[name]
        assert g.n_apps == n and g.quanta == N_QUANTA
        np.testing.assert_allclose(g.total_retired, w.total_retired,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.mean_true_slowdown,
                                   w.mean_true_slowdown, rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(g.ipc, w.ipc, rtol=1e-4, err_msg=name)


def test_free_running_race(models):
    """The port's own draws (a ``torch.Generator`` keyed from the seed):
    the scheduler beats the random pairing, and a rerun is identical."""
    _, tm = models
    _, tpol = _policies(None, tm)
    profs = twl.scaled_workload(64, seed=64)
    runs = [tse.run_quanta_scan(tmc.MachineParams(), profs, tpol,
                                n_quanta=N_QUANTA, seed=3, device="cpu",
                                repeats=0) for _ in range(2)]
    res = runs[0]
    for name, r in res.items():
        assert r.ipc.shape == (64,) and np.isfinite(r.ipc).all(), name
        assert np.isfinite(r.mean_true_slowdown) and r.mean_true_slowdown >= 1
        assert r.total_retired == runs[1][name].total_retired
    assert res["synpa4"].mean_true_slowdown < res["random"].mean_true_slowdown
    # random and linux face the same initial pairing and workload draws
    assert res["random"].ipc_geomean > 0 and res["linux"].ipc_geomean > 0


def test_counter_noise_lognormal_moments():
    """The port's own draws (``TorchDraws`` on the CPU) make the counter
    noise distribution-equal to the reference's lognormal draws: the
    log-ratio of noisy to noiseless counters over 200 quanta has mean 0
    (within three standard errors) and standard deviation ``noise_sigma``
    (within 5%), the port's twin of ``tests/test_scan_engine.py``'s
    moment test."""
    params = tmc.MachineParams()
    n = 64
    dt = tse.DeviceTables.build(
        tmc.PhaseTables.build(twl.scaled_workload(n, seed=n)), "cpu")
    idx = torch.arange(n)
    ph = torch.zeros(n, dtype=torch.int64)
    comps = tse._corun_components_scan(dt, ph, idx.flip(0), params)
    cycles = float(np.float32(params.quantum_cycles))
    base = tse._pmu_counters_scan(comps, dt.omega, dt.retire, cycles, params)
    draws = tse.TorchDraws(0, "cpu")
    logs = torch.cat([torch.log(tse._pmu_counters_scan(
        comps, dt.omega, dt.retire, cycles, params, draws.noise(q, n))[:, 1:]
        / base[:, 1:]).ravel() for q in range(200)]).double().numpy()
    sigma = params.noise_sigma
    assert abs(logs.mean()) < 3 * sigma / np.sqrt(logs.size)
    assert abs(logs.std() - sigma) < 0.05 * sigma


def _phase_draw_residuals(draws, device, quanta=200, n=64):
    """Each phase-length draw at the pool's own means (every phase of a
    64-app workload), standardised as ``(x - lam) / sqrt(lam)``, over
    ``quanta`` quanta: a Poisson(lam) draw has mean 0 and variance 1."""
    dt = tse.DeviceTables.build(
        tmc.PhaseTables.build(twl.scaled_workload(n, seed=n)), device)
    live = (torch.arange(dt.duration.shape[1], device=device)
            < dt.n_phases[:, None])
    lam = dt.duration[live]
    x = torch.stack([torch.as_tensor(draws.phase(q, lam), device=device)
                     for q in range(quanta)]).double()
    assert bool((x >= 0).all()) and bool((x == x.round()).all())
    return ((x - lam.double()) / lam.double().sqrt()).cpu().numpy().ravel()


@pytest.mark.parametrize("who", ["port", "reference"])
def test_phase_draws_poisson_moments(who):
    """The port's phase-length draws (``TorchDraws.phase`` on the CPU) are
    Poisson at the pool's means, as the reference's threefry draws are:
    over 200 quanta the standardised residual has mean 0 (within three
    standard errors) and variance 1 (within 5%).  The reference's own
    draws pass the same check."""
    draws = tse.TorchDraws(0, "cpu") if who == "port" else JaxDraws(0)
    z = _phase_draw_residuals(draws, "cpu")
    assert abs(z.mean()) < 3 / np.sqrt(z.size)
    assert abs(z.var() - 1.0) < 0.05


def test_free_running_aggregates_match_reference_engine():
    """A static-policy race at N = 64 over 40 quanta on the port's own
    draws agrees with the reference engine's (threefry draws, same seed,
    same first pairing) on mean true slowdown and IPC geomean within 3%:
    different noise and phase trajectories, same distributions."""
    want = jse.run_quanta_scan(
        jmc.SMTMachine(jmc.MachineParams(), seed=0),
        jwl.scaled_workload(64, seed=64),
        {"static": jse.ScanPolicy(kind="static")}, n_quanta=40,
        seed=9)["static"]
    got = tse.run_quanta_scan(
        tmc.MachineParams(), twl.scaled_workload(64, seed=64),
        {"static": tse.ScanPolicy(kind="static")}, n_quanta=40, seed=9,
        device="cpu", repeats=0)["static"]
    assert got.mean_true_slowdown == pytest.approx(want.mean_true_slowdown,
                                                   rel=0.03)
    assert got.ipc_geomean == pytest.approx(want.ipc_geomean, rel=0.03)
