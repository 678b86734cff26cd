"""``repro_torch.kernels.pair_score``: the plain torch version against the
reference's ``pair_cost_ref`` and ``pair_costs(impl="xla")`` (tolerance
2e-5, ``DIAG`` sentinels exact) and the CPU/CUDA dispatch.  The CUDA
kernel itself is held against the plain version on a GPU in
``test_torch_pair_score_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.pair_score import ops as jops  # noqa: E402
from repro.kernels.pair_score.ref import pair_cost_ref as j_ref  # noqa: E402
from repro_torch.kernels.pair_score import kernel, ops  # noqa: E402
from repro_torch.kernels.pair_score.ref import DIAG, pair_cost_ref  # noqa: E402

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
