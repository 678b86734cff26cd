"""The hand-written CUDA ``pair_score`` kernel against its plain torch
version, on the card (tolerance 2e-5 abs/rel, ``DIAG`` sentinels exact).

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_pair_score_gpu.py

Every test needs a GPU and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.pair_score import kernel, ops  # noqa: E402
from repro_torch.kernels.pair_score.ref import DIAG, pair_costs_plain  # noqa: E402

TOL = 2e-5


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
