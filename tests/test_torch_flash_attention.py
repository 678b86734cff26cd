"""``repro_torch.kernels.flash_attention``: the plain torch version against
the reference's Pallas kernel in interpret mode (3e-4, the reference
tests' own tolerance; 2e-2 in bfloat16) and against its jnp oracle
(1e-5 in float32), and the CPU/CUDA dispatch.  The CUDA kernel itself is
held against the plain version on a GPU in
``test_torch_attention_gpu.py``; here a torch emulation of its TF32
rounding shows why its float32 products are three TF32 products."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_plain  # noqa: E402

SHAPES = [
    # (B, Sq, Hq, Hkv, D), as the reference's kernel tests
    (1, 128, 1, 1, 64),
    (2, 256, 8, 2, 64),     # GQA
    (1, 200, 8, 8, 128),    # ragged + MHA
    (1, 384, 4, 1, 256),    # MQA, wide heads
]
MASKS = [(True, 0), (True, 64), (False, 0)]


def _qkv(shape, seed, skv=None):
    b, s, hq, hkv, d = shape
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, s, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(shape, causal, window):
    q, k, v = _qkv(shape, sum(shape) + window)
    got = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=causal,
                              window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    kern = jops.attention(q, k, v, causal=causal, window=window,
                          impl="pallas_interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=3e-4,
                               atol=3e-4)
    oracle = j_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, 16), (False, 16)])
def test_fully_masked_rows_are_zero_as_in_the_reference_kernel(causal, window):
    """Query rows past every key under a window see nothing: the reference
    kernel writes 0 there (its oracle would average uniformly)."""
    q, k, v = _qkv((1, 160, 2, 1, 64), 7, skv=48)
    got = flash_attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), causal, window)
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=3e-4,
                               atol=3e-4)
    assert (got[:, 63:] == 0).all() and (got[:, :48].abs().sum(-1) > 0).all()


def test_bfloat16_matches_reference_kernel():
    rng = np.random.default_rng(4)
    shape = (1, 256, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64)
    q, k, v = (jnp.asarray(rng.normal(size=s), jnp.bfloat16) for s in shape)
    got = ops.flash_attention(*(torch.as_tensor(np.asarray(t, np.float32))
                                .to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    kern = jops.attention(q, k, v, impl="pallas_interpret")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    q, k, v = (torch.as_tensor(t) for t in _qkv((1, 32, 2, 1, 64), 1))
    before = kernel.LAUNCHES
    got = ops.flash_attention(q, k, v)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), rtol=0,
                               atol=0)
    assert kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="not a GPU"):
        kernel.flash_attention_cuda(q, k, v)


def test_source_and_build_location():
    """The kernel source ships with the package and builds under the
    checkout's ``build/repro_torch/``, keyed on the source's hash."""
    text = kernel.SOURCE.read_text()
    assert "flash_attention_launch" in text and "_fa_kernel" in text
    path = kernel.LIB.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention_") and path.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


# ---------------------------------------------- the kernel's 3xTF32 split
def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from 0),
    as ``cvt.rna.tf32.f32`` does; a TF32 x TF32 product is exact in
    float32, so a float32 matmul of rounded operands emulates the MMA."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, terms):
    """a @ b as the kernel computes it: ``terms`` 3 is hi.hi + hi.lo +
    lo.hi with lo = x - hi rounded again; 1 is a single TF32 product."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    return ah @ _tf32(b - bh) + _tf32(a - ah) @ bh + ah @ bh


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("product", ["qk", "pv"])
def test_three_tf32_products_keep_the_float32_limit_and_one_does_not(
        product, terms):
    """At the serving scale (D 64, S 2048 rows of N(0, 1), causal) the
    3-term split of Q K^T / sqrt(D) and of P V stays inside the card
    check's float32 limit (1e-4 abs/rel) against float64; one TF32
    product misses it, which is why the kernel pays for three."""
    s, d = 2048, 64
    rng = np.random.default_rng(13)
    q, k, v = (torch.as_tensor(rng.normal(size=(s, d)).astype(np.float32))
               for _ in range(3))
    scores = (q.double() @ k.double().T) * d ** -0.5
    if product == "qk":
        got = _tf32_matmul(q, k.T.contiguous(), terms) * d ** -0.5
        want = scores
    else:
        causal = torch.ones(s, s, dtype=torch.bool).tril()
        p = torch.softmax(scores.masked_fill(~causal, -1e30), -1).float()
        got = _tf32_matmul(p, v, terms)
        want = p.double() @ v.double()
    excess = ((got.double() - want).abs() / (1e-4 + 1e-4 * want.abs())).max()
    if terms == 3:
        assert float(excess) < 0.1
    else:
        assert float(excess) > 2.0
