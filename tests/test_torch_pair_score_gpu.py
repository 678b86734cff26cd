"""The hand-written CUDA ``pair_score`` kernel against its plain torch
version, on the card (tolerance 2e-5 abs/rel; ``DIAG`` sentinels and
``IDLE_COST`` edges exact), with and without the fused cost preparation.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_pair_score_gpu.py

Every test but the check of ``chip_smoke.py``'s case list needs a GPU and
skips without one.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.pair_score import kernel, ops  # noqa: E402
from repro_torch.kernels.pair_score.ref import (  # noqa: E402
    DIAG, IDLE_COST, fixed_entries, pair_costs_plain)

TOL = 2e-5
#: Output sizes of the fused-mode check: 2 and 33 hold a single tile (the
#: diagonal one), 33 and 129 end in a partial tile, 4104 and 8200 launch
#: thousands of tiles.  chip_smoke.py's PAIR_SCORE_SIZES must match.
PAIR_SCORE_SIZES = [2, 33, 129, 264, 1032, 4104, 8200]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _inputs(p, seed, device):
    rng = np.random.default_rng(seed)
    st = rng.dirichlet(np.ones(4), size=p).astype(np.float32)
    coeffs = rng.normal(0.3, 0.5, (4, 4)).astype(np.float32)
    return (torch.as_tensor(st, device=device),
            torch.as_tensor(coeffs, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("p,n_valid,n_categories",
                         [(2, 2, 4), (8, 8, 4), (33, 30, 4), (264, 257, 3),
                          (1032, 1024, 4), (1032, 1032, 3)])
def test_kernel_matches_plain(cuda, p, n_valid, n_categories):
    st, coeffs = _inputs(p, p, cuda)
    before = kernel.LAUNCHES
    got = ops.pair_costs(st, coeffs, n_categories=n_categories,
                         n_valid=n_valid)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    want = pair_costs_plain(st, coeffs, n_categories, n_valid)
    assert got.shape == want.shape and got.dtype == torch.float32
    sentinel = want == DIAG
    assert torch.equal(got == DIAG, sentinel)
    assert (got[n_valid:, :] == DIAG).all() and (got[:, n_valid:] == DIAG).all()
    torch.testing.assert_close(got[~sentinel], want[~sentinel], rtol=TOL,
                               atol=TOL)


def _fused_case(p, seed, device):
    """A fused-mode call at output size ``p``: ``n_valid`` a little below
    ``p``, about 15% of the slots empty (the one beside the idle vertex
    always), the idle vertex at row ``n_valid`` (when ``p`` has room)."""
    n_valid = max(1, p - 1 - p // 64)
    rng = np.random.default_rng(seed)
    valid = rng.random(n_valid) > 0.15
    valid[n_valid - 1] = False
    st = rng.dirichlet(np.ones(4), size=p).astype(np.float32)
    return (torch.as_tensor(st, device=device), n_valid,
            torch.as_tensor(valid, device=device))


def test_chip_smoke_checks_the_same_sizes():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PAIR_SCORE_SIZES == PAIR_SCORE_SIZES


@pytest.mark.gpu
@pytest.mark.parametrize("full_rows", [False, True],
                         ids=["n_valid_rows", "p_rows"])
@pytest.mark.parametrize("idle", [False, True], ids=["no_idle", "idle"])
@pytest.mark.parametrize("p", PAIR_SCORE_SIZES)
def test_fused_kernel_matches_plain(cuda, p, idle, full_rows):
    st, n_valid, valid = _fused_case(p, p, cuda)
    _, coeffs = _inputs(4, p, cuda)
    if not full_rows:
        st = st[:n_valid].clone()
    idle_row = n_valid if idle and n_valid < p else -1
    before = kernel.LAUNCHES
    got = ops.pair_costs(st, coeffs, n_categories=4, n_valid=n_valid,
                         valid=valid, idle_row=idle_row, p=p)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    want = pair_costs_plain(st, coeffs, 4, n_valid, valid, idle_row, p)
    assert got.shape == (p, p) and got.dtype == torch.float32
    diag, idle_e = fixed_entries(p, n_valid, valid, idle_row, cuda)
    assert bool((got[diag] == DIAG).all()) and bool((want[diag] == DIAG).all())
    assert bool((got[idle_e] == IDLE_COST).all())
    assert bool((want[idle_e] == IDLE_COST).all())
    assert bool(idle_e.any()) == (idle_row >= 0 and p > 2)
    fixed = diag | idle_e
    torch.testing.assert_close(got[~fixed], want[~fixed], rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    st, coeffs = _inputs(16, 0, cuda)
    with pytest.raises(TypeError):
        kernel.pair_score_cuda(st.double(), coeffs)
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st[:, :3].contiguous(), coeffs)
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st.t().contiguous().t(), coeffs)
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st, coeffs.cpu())
    valid = torch.ones(12, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kernel.pair_score_cuda(st, coeffs, 4, 12, valid.to(torch.uint8))
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st, coeffs, 4, 12, valid[:11])
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st, coeffs, 4, 12, valid.cpu())
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st[:8], coeffs, 4, 12, valid, p=16)


@pytest.mark.gpu
@pytest.mark.parametrize("flag", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("p", PAIR_SCORE_SIZES)
def test_idle_flag_kernel_matches_plain(cuda, p, flag):
    """The idle vertex's flag read by the kernel from device memory: the
    output equals, bit for bit, the kernel given ``idle_row = n_valid``
    (flag on) or ``-1`` (flag off) on the host, and the plain version
    with the same flag."""
    st, n_valid, valid = _fused_case(p, 3 * p + flag, cuda)
    _, coeffs = _inputs(4, p, cuda)
    st = st[:n_valid].clone()
    idle_row = n_valid if n_valid < p else -1
    flag_t = torch.full((1,), flag, dtype=torch.bool, device=cuda)
    before = kernel.LAUNCHES
    got = kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid, idle_row, p,
                                 idle_flag=flag_t)
    host = kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid,
                                  idle_row if flag else -1, p)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 2
    assert torch.equal(got, host)
    want = pair_costs_plain(st, coeffs, 4, n_valid, valid, idle_row, p,
                            idle_flag=flag_t)
    diag, idle_e = fixed_entries(p, n_valid, valid,
                                 idle_row if flag else -1, cuda)
    assert bool((got[diag] == DIAG).all()) and bool((want[diag] == DIAG).all())
    assert bool((got[idle_e] == IDLE_COST).all())
    assert bool((want[idle_e] == IDLE_COST).all())
    fixed = diag | idle_e
    torch.testing.assert_close(got[~fixed], want[~fixed], rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_wrapper_refuses_a_flag_it_cannot_read(cuda):
    st, coeffs = _inputs(16, 0, cuda)
    valid = torch.ones(12, dtype=torch.bool, device=cuda)
    for bad, err in ((torch.ones(1, dtype=torch.bool), ValueError),
                     (torch.ones(1, dtype=torch.uint8, device=cuda),
                      TypeError),
                     (torch.ones(2, dtype=torch.bool, device=cuda),
                      TypeError)):
        with pytest.raises(err):
            kernel.pair_score_cuda(st, coeffs, 4, 12, valid, 12, 16,
                                   idle_flag=bad)


#: Lane counts and output sizes of the lane-batched kernel's check.
LANES = [1, 3, 12]
LANE_SIZES = [8, 264, 1032]


@pytest.mark.gpu
@pytest.mark.parametrize("p", LANE_SIZES)
@pytest.mark.parametrize("lanes", LANES)
def test_lane_batched_kernel_matches_single_launches(cuda, lanes, p):
    """One launch for L lanes (empty slots, the idle vertex live in every
    other lane): each lane's slab equals a one-lane launch on that lane's
    inputs bit for bit, and the plain version within 2e-5 (sentinels and
    idle edges exact)."""
    rng = np.random.default_rng(19 * p + lanes)
    n_valid = p - 1
    st = torch.as_tensor(rng.dirichlet(np.ones(4), size=(lanes, n_valid))
                         .astype(np.float32), device=cuda)
    valid = torch.as_tensor(rng.random((lanes, n_valid)) > 0.1, device=cuda)
    flag = torch.as_tensor(np.arange(lanes) % 2 == 0, device=cuda)
    _, coeffs = _inputs(4, p, cuda)
    before = kernel.LAUNCHES
    got = kernel.pair_score_cuda(st, coeffs, 4, n_valid, valid, n_valid, p,
                                 idle_flag=flag)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    assert tuple(got.shape) == (lanes, p, p)
    want = pair_costs_plain(st, coeffs, 4, n_valid, valid, n_valid, p,
                            idle_flag=flag)
    for k in range(lanes):
        one = kernel.pair_score_cuda(st[k], coeffs, 4, n_valid, valid[k],
                                     n_valid, p, idle_flag=flag[k:k + 1])
        assert torch.equal(got[k], one), k
        diag, idle_e = fixed_entries(p, n_valid, valid[k],
                                     n_valid if bool(flag[k]) else -1, cuda)
        assert bool((got[k][diag] == DIAG).all())
        assert bool((got[k][idle_e] == IDLE_COST).all())
        fixed = diag | idle_e
        torch.testing.assert_close(got[k][~fixed], want[k][~fixed],
                                   rtol=TOL, atol=TOL)


@pytest.mark.gpu
def test_wrapper_refuses_lanes_it_cannot_read(cuda):
    st, coeffs = _inputs(16, 0, cuda)
    st = st[None].repeat(3, 1, 1)
    valid = torch.ones(3, 12, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st, coeffs, 4, 12, valid[:2])
    with pytest.raises(ValueError):
        kernel.pair_score_cuda(st, coeffs, 4, 12, valid[:, :11])
    with pytest.raises(TypeError):
        kernel.pair_score_cuda(st, coeffs, 4, 12, valid, 12, 16,
                               idle_flag=torch.ones(2, dtype=torch.bool,
                                                    device=cuda))
