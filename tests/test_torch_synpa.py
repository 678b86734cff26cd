"""Parity of ``repro_torch.core.synpa.make_fused_step`` (Steps 0-2 and the
matching cost preparation) with the reference's fused step.

Both packages get the same ``(counters, partner, prev_st, masks, idle)``
at n in {8, 15, 33, 64}, made with numpy from a seed, and the same fitted
``SYNPA4_R-FEBE`` coefficients.  Tolerances: cost 2e-5 with every ``BIG``
and ``IDLE_COST`` entry exact; ST stacks 1e-5.  A pair whose solve stopped
on a plateau (noisy counters leave no exact solution: residual above the
solver's 1e-4 "good enough") sits in a flat valley, where the two packages'
float orders move the stopping point along the valley: such a pair's
stacks are held to 1e-4 and its residual to rtol 1e-4 instead.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.core import matching as jmat  # noqa: E402
from repro.core import regression as jreg  # noqa: E402
from repro.core import synpa as jsyn  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.core import synpa as tsyn  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt.workloads import scaled_workload  # noqa: E402


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


#: Open-system cases whose empty slots are chosen, not drawn: at n = 33
#: the two slots beside the idle vertex (row 33) are empty, which leaves
#: 31 applications and so wires the idle vertex.
_INVALID = {33: (31, 32)}


def _inputs(n, seed, open_system=False, invalid=None):
    """Counters of one machine quantum on a random pairing (solo slots
    where the pairing leaves them), carried estimates and masks.  An open
    system empties ``invalid`` slots, or 3 drawn ones."""
    rng = np.random.default_rng(seed)
    params = tmc.MachineParams()
    tables = tmc.PhaseTables.build(scaled_workload(n + n % 2, seed=seed)[:n])
    idx = np.arange(n)
    ph = rng.integers(0, tables.n_phases)
    valid = np.ones(n, bool)
    if open_system:
        valid[rng.choice(n, size=3, replace=False)] = False
        if invalid is not None:
            valid[:] = True
            valid[list(invalid)] = False
    perm = rng.permutation(np.flatnonzero(valid))
    partner = idx.copy()
    for k in range(len(perm) // 2):
        a, b = perm[2 * k], perm[2 * k + 1]
        partner[a], partner[b] = b, a
    comps = tmc.corun_components_batched(tables, idx, ph, partner,
                                         ph[partner], params)
    solo = partner == idx
    comps[solo] = tables.comps[idx[solo], ph[solo]]
    counters = tmc.pmu_counters_batched(
        comps, tables.omega, tables.retire, params.quantum_cycles, params,
        rng).astype(np.float32)
    prev_st = rng.dirichlet(np.ones(4), size=n).astype(np.float32)
    fresh = np.zeros(n, bool)
    if open_system:
        fresh[rng.choice(np.flatnonzero(valid), size=2, replace=False)] = True
    solve = partner != idx
    masks = np.stack([solve, ~solve & valid, valid, fresh])
    idle = bool(valid.sum() % 2)
    return counters, partner, prev_st, masks, idle


def _assert_cost_close(got, want):
    fixed = (want == jmat.BIG) | (want == jmat.IDLE_COST)
    np.testing.assert_array_equal(got[fixed], want[fixed])
    np.testing.assert_array_equal(got == jmat.BIG, want == jmat.BIG)
    np.testing.assert_allclose(got[~fixed], want[~fixed], rtol=2e-5,
                               atol=2e-5)


def _assert_st_close(jm, counters, partner, got, want):
    frac = np.asarray(jisc.build_stack_from_counters(
        *(counters[:, k] for k in range(4)), jisc.SYNPA4_R_FEBE))
    res = np.asarray(jreg.inverse_residual(
        jm, frac, frac[partner], want, want[partner]))
    res_got = np.asarray(jreg.inverse_residual(
        jm, frac, frac[partner], got, got[partner]))
    plateau = (partner != np.arange(partner.size)) & (
        res >= jreg._GN_GOOD_ENOUGH)
    err = np.abs(got - want).max(-1)
    np.testing.assert_array_less(err[~plateau], 1e-5)
    np.testing.assert_array_less(err[plateau], 1e-4)
    np.testing.assert_allclose(res_got[plateau], res[plateau], rtol=1e-4)


@pytest.mark.parametrize("open_system", [False, True])
@pytest.mark.parametrize("n", [8, 15, 64, 33])
def test_fused_step_matches(models, n, open_system):
    jm, tm = models
    counters, partner, prev_st, masks, idle = _inputs(
        n, n, open_system, _INVALID.get(n))
    jstep = jsyn.make_fused_step(jisc.SYNPA4_R_FEBE, jm, impl="xla")
    w_cost, w_st = jstep(jnp.asarray(counters),
                         jnp.asarray(partner, jnp.int32),
                         jnp.asarray(prev_st), jnp.asarray(masks),
                         jnp.asarray(idle))
    tstep = tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, tm)
    syncs = treg.NEED_FB_SYNCS
    g_cost, g_st = tstep(torch.as_tensor(counters), torch.as_tensor(partner),
                         torch.as_tensor(prev_st), torch.as_tensor(masks),
                         idle)
    assert treg.NEED_FB_SYNCS == syncs + 1
    p = tsyn.fused_pad(n)
    assert tuple(g_cost.shape) == (p, p) and g_cost.dtype == torch.float32
    assert tuple(g_st.shape) == (n, 4) and g_st.dtype == torch.float32
    _assert_cost_close(g_cost.numpy(), np.asarray(w_cost))
    _assert_st_close(jm, counters, partner, g_st.numpy(), np.asarray(w_st))
    # the idle vertex is wired exactly when the valid population is odd,
    # to the valid slots only
    assert bool((g_cost[n, :n] == jmat.IDLE_COST).any()) == idle
    valid = torch.as_tensor(masks[2])
    assert bool((g_cost[n, :n][~valid] == jmat.BIG).all())
    assert bool((g_cost[:n, n][~valid] == jmat.BIG).all())


def test_fused_step_deterministic_on_simplex(models):
    """Two calls on the same inputs agree bit for bit, and the refreshed
    ST stacks lie on the simplex."""
    _, tm = models
    counters, partner, prev_st, masks, idle = _inputs(16, 4)
    tstep = tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, tm)
    cost_a, st_a = tstep(torch.as_tensor(counters), torch.as_tensor(partner),
                         torch.as_tensor(prev_st), torch.as_tensor(masks),
                         idle)
    cost_b, st_b = tstep(torch.as_tensor(counters), torch.as_tensor(partner),
                         torch.as_tensor(prev_st), torch.as_tensor(masks),
                         idle)
    assert torch.equal(cost_a, cost_b) and torch.equal(st_a, st_b)
    assert torch.allclose(st_a.sum(-1), torch.ones(16), atol=1e-5)


@pytest.mark.parametrize("n", [15, 33, 64])
def test_fused_step_idle_flag_tensor_equals_host_bool(models, n):
    """``idle`` as a 0-d bool tensor (the open system's parity, on the
    device) gives the outputs of the host bool, bit for bit, whichever
    value it holds."""
    _, tm = models
    counters, partner, prev_st, masks, idle = _inputs(
        n, 2 * n, True, _INVALID.get(n))
    tstep = tsyn.make_fused_step(tisc.SYNPA4_R_FEBE, tm)
    args = (torch.as_tensor(counters), torch.as_tensor(partner),
            torch.as_tensor(prev_st), torch.as_tensor(masks))
    for flag in (idle, not idle):
        want_cost, want_st = tstep(*args, flag)
        got_cost, got_st = tstep(*args, torch.tensor(flag))
        assert torch.equal(got_cost, want_cost)
        assert torch.equal(got_st, want_st)
        assert bool((got_cost[n, :n] == tmat.IDLE_COST).any()) == flag
