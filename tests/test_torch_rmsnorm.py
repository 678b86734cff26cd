"""``repro_torch.kernels.rmsnorm``: the plain torch version against the
reference's Pallas kernel in interpret mode (3e-4 in float32, 2e-2 in
bfloat16, the reference tests' own tolerances), against its jnp oracle
and the model's ``layers.rms_norm`` (1e-5 in float32), and the CPU/CUDA
dispatch.  The CUDA kernel itself is held against the plain version on a
GPU in ``test_torch_attention_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rmsnorm import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel, ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rms_norm_plain  # noqa: E402


def _to_torch(x):
    t = torch.as_tensor(np.array(x, np.float32))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(7, 64), (3, 77, 256), (2, 4, 8, 512)])
def test_plain_matches_reference_kernel_and_oracle(shape, dtype):
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    x = jnp.asarray(rng.normal(size=shape), dtype)
    sc = jnp.asarray(rng.normal(1.0, 0.1, (shape[-1],)), jnp.float32)
    got = ops.rms_norm(_to_torch(x), _to_torch(sc))
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    assert tuple(got.shape) == shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 3e-4
    kern = jops.rms_norm(x, sc, impl="pallas_interpret")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern, np.float32), rtol=tol, atol=tol)
    if dtype == jnp.float32:
        oracle = jops.rms_norm(x, sc, impl="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   rtol=1e-5, atol=1e-5)


def test_matches_model_layer():
    rng = np.random.default_rng(96)
    x = rng.normal(size=(4, 96)).astype(np.float32)
    sc = rng.normal(1.0, 0.1, (96,)).astype(np.float32)
    want = jlayers.rms_norm({"scale": jnp.asarray(sc)}, jnp.asarray(x))
    got = rms_norm_plain(torch.as_tensor(x), torch.as_tensor(sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    sc = torch.ones(64)
    before = kernel.LAUNCHES
    torch.testing.assert_close(ops.rms_norm(x, sc), rms_norm_plain(x, sc),
                               rtol=0, atol=0)
    assert kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="not a GPU"):
        kernel.rms_norm_cuda(x, sc)


def test_source_and_build_location():
    text = kernel.SOURCE.read_text()
    assert "rmsnorm_launch" in text and "_rmsnorm_kernel" in text
    assert kernel.LIB.library_path().parent == _build.BUILD_DIR
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
