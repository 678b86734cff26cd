"""``repro_torch.kernels.pair_score``: the plain torch version against the
reference's ``pair_cost_ref`` and ``pair_costs(impl="xla")`` (tolerance
2e-5, ``DIAG`` sentinels exact), the fused cost preparation against the
chain of tensor ops it replaced (bit for bit) and against the reference's
own chain (2e-5, sentinels and idle edges exact), and the CPU/CUDA
dispatch.  The CUDA kernel itself is held against the plain version on a
GPU in ``test_torch_pair_score_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import matching as jmat  # noqa: E402
from repro.kernels.pair_score import ops as jops  # noqa: E402
from repro.kernels.pair_score.ref import pair_cost_ref as j_ref  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.kernels.pair_score import kernel, ops  # noqa: E402
from repro_torch.kernels.pair_score.ref import (  # noqa: E402
    DIAG, fixed_entries, pair_cost_ref)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(p, seed):
    rng = np.random.default_rng(seed)
    st = rng.dirichlet(np.ones(4), size=p).astype(np.float32)
    coeffs = rng.normal(0.3, 0.5, (4, 4)).astype(np.float32)
    return st, coeffs


def _assert_same(got, want, n_valid):
    got = np.asarray(got)
    want = np.asarray(want)
    sentinel = want == DIAG
    np.testing.assert_array_equal(got == DIAG, sentinel)
    np.testing.assert_allclose(got[~sentinel], want[~sentinel], **TOL)
    assert (got[n_valid:, :] == DIAG).all() and (got[:, n_valid:] == DIAG).all()


@pytest.mark.parametrize("p", [2, 8, 56, 60, 129])
@pytest.mark.parametrize("n_categories", [3, 4])
def test_plain_matches_reference(p, n_categories):
    st, coeffs = _inputs(p, p + 10 * n_categories)
    got = pair_cost_ref(torch.as_tensor(st), torch.as_tensor(coeffs),
                        n_categories)
    want = j_ref(st, coeffs, n_categories)
    _assert_same(got.numpy(), want, p)
    assert got.dtype == torch.float32 and tuple(got.shape) == (p, p)


@pytest.mark.parametrize("p,n_valid", [(2, 1), (8, 5), (56, 56), (60, 48),
                                       (129, 100)])
def test_pair_costs_n_valid_matches_xla(p, n_valid):
    st, coeffs = _inputs(p, 7 * p + n_valid)
    got = ops.pair_costs(torch.as_tensor(st), torch.as_tensor(coeffs),
                         n_categories=4, n_valid=n_valid)
    want = jops.pair_costs(jnp.asarray(st), jnp.asarray(coeffs),
                           n_categories=4, impl="xla", n_valid=n_valid)
    assert tuple(got.shape) == (p, p)
    _assert_same(got.numpy(), want, n_valid)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: a CPU tensor raises."""
    st, coeffs = _inputs(8, 0)
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(torch.as_tensor(st), torch.as_tensor(coeffs))


def test_source_and_build_location():
    """The kernel source ships with the package and builds under the
    checkout's ``build/repro_torch/``, keyed on the source's hash."""
    assert kernel.SOURCE.is_file()
    text = kernel.SOURCE.read_text()
    assert "pair_score_launch" in text and "_pair_score_kernel" in text
    path = kernel.library_path()
    assert path.parent == kernel.BUILD_DIR
    assert kernel.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert "sm_90a" in " ".join(kernel.NVCC_FLAGS)


def _old_pair_costs_plain(st, coeffs, n_categories=4, n_valid=None):
    """``pair_costs_plain`` as it was before the cost preparation moved
    into it, verbatim."""
    out = pair_cost_ref(st, coeffs, n_categories)
    n = st.shape[0]
    if n_valid is not None and n_valid < n:
        idx = torch.arange(n, device=st.device)
        invalid = (idx[:, None] >= n_valid) | (idx[None, :] >= n_valid)
        out = torch.where(invalid, DIAG, out)
    return out


def _old_fused_chain(st, coeffs, valid_mask, idle, p):
    """Step 2 and the cost preparation of ``make_fused_step`` as they were
    before the fusion, verbatim: uniform padding rows, the unfused
    scoring, then the mask-and-``where`` passes."""
    device = st.device
    n = st.shape[0]
    uniform = torch.as_tensor(tisc.uniform_stack(4))
    stp = torch.cat([st, uniform[None, :].expand(p - n, -1)], dim=0)
    cost = _old_pair_costs_plain(stp, coeffs, 4, n_valid=n)
    validp = torch.cat(
        [valid_mask, torch.zeros(p - n, dtype=torch.bool, device=device)])
    pairv = validp[:, None] & validp[None, :]
    cost = torch.where(pairv, cost, jmat.BIG)
    is_idle = (torch.arange(p, device=device) == n) & idle
    cost = torch.where(is_idle[:, None] & validp[None, :],
                       jmat.IDLE_COST, cost)
    cost = torch.where(validp[:, None] & is_idle[None, :],
                       jmat.IDLE_COST, cost)
    return cost


def _fused_inputs(p, n_valid, seed):
    st, coeffs = _inputs(p, seed)
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n_valid) > 0.15
    valid[n_valid - 1] = False   # an empty slot beside the idle vertex
    return st, coeffs, valid


@pytest.mark.parametrize("full_rows", [False, True],
                         ids=["n_valid_rows", "p_rows"])
@pytest.mark.parametrize("idle", [False, True], ids=["no_idle", "idle"])
@pytest.mark.parametrize("p,n_valid", [(8, 7), (16, 9), (264, 257),
                                       (1032, 1024)])
def test_fused_plain_matches_old_chain(p, n_valid, idle, full_rows):
    """The fused plain version equals, bit for bit, the unfused scoring
    plus the cost preparation that ``make_fused_step`` ran before."""
    st, coeffs, valid = _fused_inputs(p, n_valid, p + n_valid)
    st_t, coeffs_t = torch.as_tensor(st), torch.as_tensor(coeffs)
    valid_t = torch.as_tensor(valid)
    want = _old_fused_chain(st_t[:n_valid], coeffs_t, valid_t, idle, p)
    got = ops.pair_costs(st_t if full_rows else st_t[:n_valid], coeffs_t,
                         n_categories=4, n_valid=n_valid, valid=valid_t,
                         idle_row=n_valid if idle else -1, p=p)
    assert tuple(got.shape) == (p, p) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert bool((got == jmat.IDLE_COST).any()) == idle
    assert bool((got[n_valid, n_valid - 1] == DIAG))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_rows_past_n_valid_are_not_read(fused):
    """Stack rows at or past ``n_valid`` do not change the output, not even
    when they hold NaN or infinity."""
    p, n_valid = 40, 33
    st, coeffs, valid = _fused_inputs(p, n_valid, 5)
    kw = dict(n_categories=4, n_valid=n_valid, p=p)
    if fused:
        kw.update(valid=torch.as_tensor(valid), idle_row=n_valid)
    want = ops.pair_costs(torch.as_tensor(st[:n_valid]),
                          torch.as_tensor(coeffs), **kw)
    for junk in (np.nan, np.inf, 1e30):
        poisoned = st.copy()
        poisoned[n_valid:] = junk
        got = ops.pair_costs(torch.as_tensor(poisoned),
                             torch.as_tensor(coeffs), **kw)
        assert torch.equal(got, want)


@pytest.mark.parametrize("idle", [False, True], ids=["no_idle", "idle"])
@pytest.mark.parametrize("p,n_valid", [(8, 7), (33, 30), (264, 257)])
def test_fixed_entries_are_where_the_plain_version_writes_constants(
        p, n_valid, idle):
    """``fixed_entries`` finds by position the ``DIAG`` and ``IDLE_COST``
    entries that the plain version writes (none of these inputs has a cost
    of exactly ``IDLE_COST``)."""
    st, coeffs, valid = _fused_inputs(p, n_valid, 3 * p)
    valid_t = torch.as_tensor(valid)
    idle_row = n_valid if idle else -1
    out = ops.pair_costs(torch.as_tensor(st), torch.as_tensor(coeffs),
                         n_valid=n_valid, valid=valid_t, idle_row=idle_row,
                         p=p)
    diag, idle_e = fixed_entries(p, n_valid, valid_t, idle_row)
    assert torch.equal(diag, out == DIAG)
    assert torch.equal(idle_e, out == jmat.IDLE_COST)


def _jax_fused_chain(st, coeffs, valid, idle, p):
    """Step 2 and the cost preparation as the reference's fused step runs
    them (``repro.core.synpa.make_fused_step``): uniform padding rows,
    ``pair_costs(impl="xla")``, then its mask-and-``where`` passes."""
    n = st.shape[0]
    uniform = jnp.full((4,), 0.25, jnp.float32)
    stp = jnp.concatenate([jnp.asarray(st), jnp.tile(uniform[None, :],
                                                     (p - n, 1))], axis=0)
    cost = jops.pair_costs(stp, jnp.asarray(coeffs), n_categories=4,
                           impl="xla", n_valid=n)
    validp = jnp.concatenate([jnp.asarray(valid), jnp.zeros((p - n,), bool)])
    pairv = validp[:, None] & validp[None, :]
    cost = jnp.where(pairv, cost, jmat.BIG)
    is_idle = (jnp.arange(p) == n) & idle
    cost = jnp.where(is_idle[:, None] & validp[None, :], jmat.IDLE_COST, cost)
    cost = jnp.where(validp[:, None] & is_idle[None, :], jmat.IDLE_COST, cost)
    return np.asarray(cost)


@pytest.mark.parametrize("idle", [False, True], ids=["no_idle", "idle"])
@pytest.mark.parametrize("p,n_valid", [(16, 9), (264, 257), (1032, 1024)])
def test_fused_plain_matches_jax_chain(p, n_valid, idle):
    """The fused plain version against the reference's own Step 2 and cost
    preparation, with random empty slots: ``DIAG`` and ``IDLE_COST``
    entries exact (found by position), the rest within 2e-5."""
    st, coeffs, valid = _fused_inputs(p, n_valid, 11 * p + idle)
    valid_t = torch.as_tensor(valid)
    idle_row = n_valid if idle else -1
    got = ops.pair_costs(torch.as_tensor(st[:n_valid]),
                         torch.as_tensor(coeffs), n_categories=4,
                         n_valid=n_valid, valid=valid_t, idle_row=idle_row,
                         p=p).numpy()
    want = _jax_fused_chain(st[:n_valid], coeffs, valid, idle, p)
    assert got.shape == want.shape == (p, p)
    diag, idle_e = (m.numpy() for m in fixed_entries(p, n_valid, valid_t,
                                                     idle_row))
    assert (got[diag] == DIAG).all() and (want[diag] == DIAG).all()
    assert (got[idle_e] == jmat.IDLE_COST).all()
    assert (want[idle_e] == jmat.IDLE_COST).all()
    assert idle_e.any() == idle
    fixed = diag | idle_e
    np.testing.assert_allclose(got[~fixed], want[~fixed], **TOL)


@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("p,n_valid", [(16, 15), (264, 257), (1032, 1024)])
def test_device_idle_flag_equals_host_idle_row(p, n_valid, flag):
    """The idle vertex's flag as a one-element bool tensor: the output
    equals, bit for bit, the call with ``idle_row = n_valid`` (flag on) or
    ``-1`` (flag off)."""
    st, coeffs, valid = _fused_inputs(p, n_valid, 13 * p + flag)
    st_t, coeffs_t = torch.as_tensor(st[:n_valid]), torch.as_tensor(coeffs)
    valid_t = torch.as_tensor(valid)
    for shape in ((), (1,)):
        got = ops.pair_costs(st_t, coeffs_t, n_categories=4, n_valid=n_valid,
                             valid=valid_t, idle_row=n_valid, p=p,
                             idle_flag=torch.full(shape, flag))
        want = ops.pair_costs(st_t, coeffs_t, n_categories=4,
                              n_valid=n_valid, valid=valid_t,
                              idle_row=n_valid if flag else -1, p=p)
        assert torch.equal(got, want)
        # The idle row holds IDLE_COST toward the valid slots when the
        # flag is on, DIAG when it is off.
        edge = got[n_valid, :n_valid][valid_t]
        assert bool((edge == (jmat.IDLE_COST if flag else DIAG)).all())


def _lane_inputs(lanes, p, seed):
    """``lanes`` lanes at output size ``p``: ``n_valid = p - 1`` stacks,
    about 10% of the slots empty, the idle vertex live in every other
    lane."""
    rng = np.random.default_rng(seed)
    n_valid = p - 1
    st = rng.dirichlet(np.ones(4), size=(lanes, n_valid)).astype(np.float32)
    valid = rng.random((lanes, n_valid)) > 0.1
    flag = np.arange(lanes) % 2 == 0
    coeffs = rng.normal(0.3, 0.5, (4, 4)).astype(np.float32)
    return (torch.as_tensor(st), torch.as_tensor(coeffs), n_valid,
            torch.as_tensor(valid), torch.as_tensor(flag))


@pytest.mark.parametrize("p", [8, 264, 1032])
@pytest.mark.parametrize("lanes", [1, 3, 12])
def test_lane_batched_plain_equals_single_calls(lanes, p):
    """The plain version with a lane axis: each lane's slab equals, bit for
    bit, the one-lane call on that lane's inputs."""
    st, coeffs, n_valid, valid, flag = _lane_inputs(lanes, p, 17 * p + lanes)
    got = ops.pair_costs(st, coeffs, n_categories=4, n_valid=n_valid,
                         valid=valid, idle_row=n_valid, p=p, idle_flag=flag)
    assert tuple(got.shape) == (lanes, p, p) and got.dtype == torch.float32
    for k in range(lanes):
        want = ops.pair_costs(st[k], coeffs, n_categories=4, n_valid=n_valid,
                              valid=valid[k], idle_row=n_valid, p=p,
                              idle_flag=flag[k:k + 1])
        assert torch.equal(got[k], want), k
        # The idle row is live exactly in the lanes whose flag is set.
        edge = got[k, n_valid, :n_valid][valid[k]]
        assert bool((edge == (jmat.IDLE_COST if flag[k] else DIAG)).all())
