"""``repro_torch.kernels.decode_attention``: the plain torch version against
the reference's Pallas kernel in interpret mode (3e-4, the reference
tests' own tolerance) and against its jnp oracle (1e-5 in float32), the
poisoned-tail property, and the CPU/CUDA dispatch.  The CUDA kernel itself
is held against the plain version on a GPU in
``test_torch_attention_gpu.py``."""

import hypothesis
import hypothesis.strategies as st
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ops as jops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: E402


def _inputs(shape, seed, lo=1):
    b, hq, hkv, d, s = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.integers(lo, s, size=(b,)).astype(np.int32))


def _port(q, kc, vc, lens, window=0):
    return ops.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                torch.as_tensor(vc), torch.as_tensor(lens),
                                window=window).numpy()


@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, D, S), as the reference's kernel tests
    (1, 1, 1, 64, 512),
    (2, 8, 2, 64, 700),      # GQA + ragged cache
    (4, 16, 16, 128, 1024),  # MHA
])
def test_plain_matches_reference_kernel_and_oracle(shape, window):
    q, kc, vc, lens = _inputs(shape, sum(shape) + window)
    got = _port(q, kc, vc, lens, window)
    assert got.shape == q.shape and got.dtype == np.float32
    kern = jops.decode_attention(q, kc, vc, lens, window=window,
                                 impl="pallas_interpret")
    np.testing.assert_allclose(got, np.asarray(kern), rtol=3e-4, atol=3e-4)
    oracle = jops.decode_attention(q, kc, vc, lens, window=window, impl="xla")
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-5, atol=1e-5)


def test_length_zero_and_past_the_cache():
    """Length 0 attends position 0 alone; a length past the cache attends
    all of it, as the reference's oracle does (its kernel would also
    attend the zero padding it adds past the cache)."""
    q, kc, vc, _ = _inputs((3, 4, 2, 64, 100), 3)
    lens = np.array([0, 99, 150], np.int32)
    got = _port(q, kc, vc, lens)
    oracle = jops.decode_attention(q, kc, vc, lens, impl="xla")
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].reshape(2, 2, 64),
                               np.repeat(vc[0, 0][:, None], 2, 1), rtol=1e-6,
                               atol=1e-6)


@hypothesis.given(
    b=st.integers(1, 3), group=st.sampled_from([1, 2, 4]),
    length=st.integers(0, 511), seed=st.integers(0, 2**31 - 1))
@hypothesis.settings(max_examples=15, deadline=None)
def test_property_poisoned_tail_never_counts(b, group, length, seed):
    """Tokens beyond ``length`` must never influence the output."""
    rng = np.random.default_rng(seed)
    hkv, d, s = 2, 64, 512
    q = rng.normal(size=(b, hkv * group, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    lens = np.full((b,), length, np.int32)
    got = _port(q, kc, vc, lens)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, length + 1:] = 1e3
    vc2[:, length + 1:] = -1e3
    np.testing.assert_allclose(got, _port(q, kc2, vc2, lens), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    q, kc, vc, lens = (torch.as_tensor(t)
                       for t in _inputs((2, 4, 2, 64, 40), 5))
    before = kernel.LAUNCHES
    got = ops.decode_attention(q, kc, vc, lens)
    torch.testing.assert_close(got, decode_attention_plain(q, kc, vc, lens),
                               rtol=0, atol=0)
    assert kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="not a GPU"):
        kernel.decode_attention_cuda(q, kc, vc, lens)


def test_source_and_build_location():
    text = kernel.SOURCE.read_text()
    assert "decode_attention_launch" in text and "_decode_kernel" in text
    path = kernel.LIB.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("decode_attention_")
