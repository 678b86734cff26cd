"""Parity of ``repro_torch.core.regression`` (and the profiling campaign of
``repro_torch.smt.training``) with the reference.

Tolerances: ``fit`` coefficients rtol 1e-4, taken norm-wise (relative to
the largest coefficient of their category): both packages form the 4x4
Gram matrix in float32 with different summation orders, and the matrix is
ill-conditioned enough to turn those ulps into relative differences above
1e-4 on the smallest coefficients.  The
campaign model's predicted slowdowns agree to rtol 1e-4 entrywise.  The
§5.3 inverse's ST stacks atol 1e-5 with ``InverseDiag.iters`` and
``.fallback`` exact, on a batch that converges and on one that forces the
heavy-ball fallback.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro.core import regression as jreg  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.core import regression as treg  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import training as ttr  # noqa: E402

TOY = np.array([
    [0.007, 0.91, 0.004, 0.03],
    [0.02, 1.41, 0.0, 0.0],
    [0.0, 0.24, 1.07, 0.5],
    [0.03, 1.22, 0.33, 0.0],
], np.float32)


def _models(n_categories=4):
    coeffs = TOY.copy()
    if n_categories == 3:
        coeffs[3] = 0.0
    jm = jreg.CategoryModel(coeffs=jnp.asarray(coeffs), mse=jnp.zeros(4),
                            n_categories=n_categories)
    tm = category_model_from_numpy(coeffs, np.zeros(4), n_categories,
                                   device="cpu")
    return jm, tm


def _stacks(rng, n):
    return rng.dirichlet(np.ones(4) * 1.5, size=n).astype(np.float32)


def _fractions(seed, n, noise, n_categories=4):
    rng = np.random.default_rng(seed)
    jm, _ = _models(n_categories)
    st_i, st_j = _stacks(rng, n), _stacks(rng, n)
    if n_categories == 3:
        st_i[:, 3] = 0.0
        st_j[:, 3] = 0.0
        st_i /= st_i.sum(-1, keepdims=True)
        st_j /= st_j.sum(-1, keepdims=True)
    p_i = np.asarray(jreg.forward(jm, st_i, st_j))
    p_j = np.asarray(jreg.forward(jm, st_j, st_i))
    p_i = p_i * rng.lognormal(0, noise, size=p_i.shape)
    p_j = p_j * rng.lognormal(0, noise, size=p_j.shape)
    f_i = (p_i / p_i.sum(-1, keepdims=True)).astype(np.float32)
    f_j = (p_j / p_j.sum(-1, keepdims=True)).astype(np.float32)
    return f_i, f_j


def _assert_coeffs_close(got, want, rtol=1e-4, err_msg=""):
    """Coefficients within ``rtol`` of the largest one of their category."""
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_array_less(
        np.abs(got - want), np.broadcast_to(rtol * scale + 1e-12, want.shape),
        err_msg=err_msg)


@pytest.mark.parametrize("n_categories", [3, 4])
def test_fit_matches(n_categories):
    rng = np.random.default_rng(n_categories)
    jm, tm = _models(4)
    st_i, st_j = _stacks(rng, 3000), _stacks(rng, 3000)
    y = np.asarray(jreg.forward(jm, st_i, st_j))
    y = (y * rng.lognormal(0, 0.02, size=y.shape)).astype(np.float32)
    want = jreg.fit(st_i, st_j, y, n_categories=n_categories)
    got = treg.fit(st_i, st_j, y, n_categories=n_categories, device="cpu")
    _assert_coeffs_close(got.coeffs.numpy(), np.asarray(want.coeffs))
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(want.mse),
                               rtol=1e-3, atol=1e-9)
    assert got.n_categories == n_categories


def test_profiling_campaign_and_fit_match():
    """The port's numpy campaign (default size) replays the reference's RNG
    stream draw for draw, and fitting every SYNPA variant off it gives the
    same model: coefficients norm-wise, predicted slowdowns entrywise."""
    jdata = jtr.collect_profiles(jmc.SMTMachine(jmc.MachineParams(), seed=0))
    tmodels, tdata = ttr.build_all_models(
        tmc.SMTMachine(tmc.MachineParams(), seed=0), device="cpu")
    np.testing.assert_array_equal(tdata.solo_counters, jdata.solo_counters)
    np.testing.assert_array_equal(tdata.pair_counters, jdata.pair_counters)
    np.testing.assert_array_equal(tdata.pair_phases, jdata.pair_phases)
    rng = np.random.default_rng(1)
    st_i, st_j = _stacks(rng, 256), _stacks(rng, 256)
    for name, method in jisc.STACK_METHODS.items():
        want = jtr.fit_model(jdata, method)
        got = tmodels[name]
        _assert_coeffs_close(got.coeffs.numpy(), np.asarray(want.coeffs),
                             err_msg=name)
        np.testing.assert_allclose(
            treg.predict_slowdown(got, torch.as_tensor(st_i),
                                  torch.as_tensor(st_j)).numpy(),
            np.asarray(jreg.predict_slowdown(want, st_i, st_j)),
            rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("n_categories", [3, 4])
def test_forward_and_slowdown_match(n_categories):
    rng = np.random.default_rng(11)
    jm, tm = _models(n_categories)
    st_i, st_j = _stacks(rng, 64), _stacks(rng, 64)
    ti, tj = torch.as_tensor(st_i), torch.as_tensor(st_j)
    np.testing.assert_allclose(treg.forward(tm, ti, tj).numpy(),
                               np.asarray(jreg.forward(jm, st_i, st_j)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        treg.predict_slowdown(tm, ti, tj).numpy(),
        np.asarray(jreg.predict_slowdown(jm, st_i, st_j)),
        rtol=1e-6, atol=1e-6)


def test_unrolled_cholesky_matches():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(32, 8, 8)).astype(np.float32)
    a = np.einsum("bij,bkj->bik", m, m) + 0.5 * np.eye(8, dtype=np.float32)
    b = rng.normal(size=(32, 8)).astype(np.float32)
    want = np.asarray(jreg._chol_solve_small(jnp.asarray(a), jnp.asarray(b), 8))
    got = treg._chol_solve_small(torch.as_tensor(a), torch.as_tensor(b), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["converging", "fallback", "garbage"])
def test_gn_with_fallback_matches(case):
    jm, tm = _models(4)
    if case == "converging":
        f_i, f_j = _fractions(7, 64, 0.02)
    elif case == "fallback":
        f_i, f_j = _fractions(0, 64, 0.3)
    else:
        f_i = np.array([[0.9, 0.1, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0],
                        [0.25, 0.25, 0.25, 0.25]], np.float32)
        f_j = f_i[::-1].copy()
    w_i, w_j, wd = jreg._gn_with_fallback(
        jm, jnp.asarray(f_i), jnp.asarray(f_j), return_diag=True)
    syncs = treg.NEED_FB_SYNCS
    g_i, g_j, gd = treg._gn_with_fallback(
        tm, torch.as_tensor(f_i), torch.as_tensor(f_j), return_diag=True)
    assert treg.NEED_FB_SYNCS == syncs + 1
    np.testing.assert_allclose(g_i.numpy(), np.asarray(w_i), atol=1e-5)
    np.testing.assert_allclose(g_j.numpy(), np.asarray(w_j), atol=1e-5)
    np.testing.assert_array_equal(gd.iters.numpy(), np.asarray(wd.iters))
    np.testing.assert_array_equal(gd.fallback.numpy(), np.asarray(wd.fallback))
    np.testing.assert_allclose(gd.residual.numpy(), np.asarray(wd.residual),
                               rtol=1e-3, atol=1e-7)
    if case == "fallback":
        assert gd.fallback.any()
    # the plain call returns the same stacks as the diagnostic one
    p_i, p_j = treg._gn_with_fallback(tm, torch.as_tensor(f_i),
                                      torch.as_tensor(f_j))
    np.testing.assert_array_equal(p_i.numpy(), g_i.numpy())
    np.testing.assert_array_equal(p_j.numpy(), g_j.numpy())


def test_gn_masked_categories_match():
    jm, tm = _models(3)
    f_i, f_j = _fractions(3, 16, 0.02, n_categories=3)
    w_i, w_j = jreg._gn_with_fallback(jm, jnp.asarray(f_i), jnp.asarray(f_j))
    g_i, g_j = treg._gn_with_fallback(tm, torch.as_tensor(f_i),
                                      torch.as_tensor(f_j))
    np.testing.assert_allclose(g_i.numpy(), np.asarray(w_i), atol=1e-5)
    np.testing.assert_allclose(g_j.numpy(), np.asarray(w_j), atol=1e-5)
    np.testing.assert_array_equal(g_i[:, 3].numpy(), 0.0)


def test_hb_best_of_and_residual_match():
    jm, tm = _models(4)
    f_i, f_j = _fractions(9, 16, 0.05)
    w_i, w_j = jreg._hb_best_of(jm, jnp.asarray(f_i), jnp.asarray(f_j), 40, 1.5)
    g_i, g_j = treg._hb_best_of(tm, torch.as_tensor(f_i), torch.as_tensor(f_j),
                                40, 1.5)
    np.testing.assert_allclose(g_i.numpy(), np.asarray(w_i), atol=1e-5)
    np.testing.assert_allclose(g_j.numpy(), np.asarray(w_j), atol=1e-5)
    want = jreg.inverse_residual(jm, f_i, f_j, np.asarray(w_i), np.asarray(w_j))
    got = treg.inverse_residual(tm, torch.as_tensor(f_i), torch.as_tensor(f_j),
                                torch.tensor(np.asarray(w_i)),
                                torch.tensor(np.asarray(w_j)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("n,n_valid", [(16, 16), (24, 17)])
def test_pair_cost_matrix_matches(n, n_valid):
    jm, tm = _models(4)
    st = _stacks(np.random.default_rng(n), n)
    want = np.asarray(jreg.pair_cost_matrix(jm, st, impl="xla",
                                            n_valid=n_valid))
    got = treg.pair_cost_matrix(tm, torch.as_tensor(st), n_valid=n_valid)
    sentinel = want == jreg_diag()
    np.testing.assert_array_equal(got.numpy() == jreg_diag(), sentinel)
    np.testing.assert_allclose(got.numpy()[~sentinel], want[~sentinel],
                               rtol=2e-5, atol=2e-5)


def jreg_diag():
    from repro.kernels.pair_score.ref import DIAG

    return DIAG


def test_uniform_stack_shared():
    np.testing.assert_array_equal(tisc.uniform_stack(4),
                                  jisc.uniform_stack(4))
