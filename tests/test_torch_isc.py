"""Parity of ``repro_torch.core.isc`` with ``repro.core.isc`` (tolerance 1e-6).

Counters come from a numpy seed and cover LT100 and GT100 rows; both
packages repair the same float32 inputs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import isc as jisc  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _counters(seed, n=256):
    """(n, 4) f32 counters: cycles, FE stalls, BE stalls, INST_SPEC, with
    heights from well below to well above 100%."""
    rng = np.random.default_rng(seed)
    cycles = rng.uniform(1e6, 2.2e8, n)
    fe = rng.uniform(0.0, 0.6, n) * cycles
    be = rng.uniform(0.0, 0.8, n) * cycles
    spec = rng.uniform(0.2, 3.5, n) * cycles
    return np.stack([cycles, fe, be, spec], axis=1).astype(np.float32)


def _raw_pair(seed):
    c = _counters(seed)
    j = jisc.raw_stack(*(jnp.asarray(c[:, k]) for k in range(4)),
                       dtype=jnp.float32)
    t = tisc.raw_stack(*(torch.as_tensor(c[:, k]) for k in range(4)))
    return np.asarray(j), t


def test_raw_stack_matches():
    j, t = _raw_pair(0)
    np.testing.assert_allclose(t.numpy(), j, **TOL)
    height = t[:, :3].sum(-1)
    assert (height < 1.0).any() and (height > 1.0).any()


@pytest.mark.parametrize("name", sorted(jisc.STACK_METHODS))
def test_build_stack_matches(name):
    j_raw, t_raw = _raw_pair(1)
    want = np.asarray(jisc.build_stack(jnp.asarray(j_raw),
                                       jisc.STACK_METHODS[name]))
    got = tisc.build_stack(t_raw, tisc.STACK_METHODS[name]).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tisc.STACK_METHODS[name].name == jisc.STACK_METHODS[name].name


@pytest.mark.parametrize("name", sorted(jisc.STACK_METHODS))
def test_build_stack_from_counters_matches(name):
    c = _counters(2).astype(np.float64)
    want = np.asarray(jisc.build_stack_from_counters(
        c[:, 0], c[:, 1], c[:, 2], c[:, 3], jisc.STACK_METHODS[name]))
    got = tisc.build_stack_from_counters(
        c[:, 0], c[:, 1], c[:, 2], c[:, 3], tisc.STACK_METHODS[name]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_gt100_r_fe_spill_corner():
    """An excess larger than FE spills to BE and then DI in both."""
    raw = np.array([[0.9, 0.05, 0.3, 0.0], [0.7, 0.0, 0.6, 0.0]], np.float32)
    want = np.asarray(jisc.build_stack(jnp.asarray(raw), jisc.SYNPA4_R_FE))
    got = tisc.build_stack(torch.as_tensor(raw), tisc.SYNPA4_R_FE).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_collapse_and_helpers_match():
    _, t_raw = _raw_pair(3)
    stack = tisc.build_stack(t_raw, tisc.SYNPA4_R_FEBE)
    want = np.asarray(jisc.collapse_hw_into_be(jnp.asarray(stack.numpy())))
    np.testing.assert_allclose(tisc.collapse_hw_into_be(stack).numpy(), want,
                               **TOL)
    for name, m in tisc.STACK_METHODS.items():
        jm = jisc.STACK_METHODS[name]
        assert tisc.active_categories(m) == jisc.active_categories(jm)
        assert m.n_categories == jm.n_categories
    for c in (3, 4):
        np.testing.assert_array_equal(tisc.uniform_stack(c),
                                      jisc.uniform_stack(c))


@pytest.mark.parametrize("name", ["SYNPA4_R-FEBE", "SYNPA3_N"])
def test_stacks_broadcast_over_lanes(name):
    """``raw_stack`` and ``build_stack`` on counters with a leading lane
    axis (the batched runs' (L, n, 5) rows) give each lane what the lane
    alone gives, bit for bit."""
    method = tisc.STACK_METHODS[name]
    c = torch.as_tensor(_counters(3, n=96).reshape(3, 32, 4))
    lanes = tisc.build_stack(tisc.raw_stack(*c.unbind(-1)), method)
    assert tuple(lanes.shape) == (3, 32, 4)
    for k in range(3):
        alone = tisc.build_stack(tisc.raw_stack(*c[k].unbind(-1)), method)
        assert torch.equal(lanes[k], alone), k
