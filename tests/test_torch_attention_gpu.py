"""The hand-written CUDA kernels of the serving path (``flash_attention``,
``decode_attention``, ``rmsnorm``) against their plain torch versions on
the card, and their wrappers' refusals.

Tolerances: 1e-4 abs/rel in float32, because the online and the direct
softmax sum in different orders; 2e-2 in bfloat16.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_attention_gpu.py

Every test but one needs a GPU and skips without one; that one checks that
``chip_smoke.py`` holds flash attention to the same edge cases.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rn_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rms_norm_plain  # noqa: E402


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-4, atol=1e-4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _normal(rng, shape, dtype, device):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                           device=device).to(dtype)


# --------------------------------------------------------- flash attention
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, Hq, Hkv, D)
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 8, 2, 64),     # GQA
    (1, 200, 200, 8, 8, 128),    # ragged length, MHA
    (1, 384, 384, 4, 1, 256),    # MQA, wide heads
    (2, 77, 150, 6, 3, 64),      # Sq != Skv, both ragged
    (1, 160, 48, 2, 1, 64),      # rows past the keys: fully masked
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0),
                                           (False, 40)])
def test_flash_kernel_matches_plain(cuda, shape, causal, window):
    b, sq, skv, hq, hkv, d = shape
    rng = np.random.default_rng(sq * 7 + skv + hq)
    q = _normal(rng, (b, sq, hq, d), torch.float32, cuda)
    k = _normal(rng, (b, skv, hkv, d), torch.float32, cuda)
    v = _normal(rng, (b, skv, hkv, d), torch.float32, cuda)
    before = fa_kernel.LAUNCHES
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES == before + 1
    want = flash_attention_plain(q, k, v, causal, window)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **_tol(torch.float32))


@pytest.mark.gpu
def test_flash_kernel_bfloat16(cuda):
    rng = np.random.default_rng(3)
    q = _normal(rng, (1, 256, 4, 64), torch.bfloat16, cuda)
    k = _normal(rng, (1, 256, 2, 64), torch.bfloat16, cuda)
    v = _normal(rng, (1, 256, 2, 64), torch.bfloat16, cuda)
    got = fa_ops.flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


#: The tensor-core design's edges: (B, Sq, Skv, Hq, Hkv, D, causal, window,
#: q scale).  Lengths that are multiples of no tile, Sq != Skv both ways,
#: GQA groups 1, 4 and 8, windows whose first key falls mid-tile, q scaled
#: by 8 (logits x 8: near one-hot rows, the split's large terms), and, in
#: the last three, rows that see no key.  chip_smoke.py's FLASH_EDGES must
#: match this list.
FLASH_EDGES = [
    (1, 333, 251, 4, 4, 64, True, 0, 1.0),
    (2, 190, 517, 8, 2, 64, False, 0, 1.0),
    (1, 300, 300, 8, 8, 64, True, 37, 1.0),
    (1, 300, 300, 8, 2, 64, True, 100, 8.0),
    (1, 300, 300, 8, 1, 64, False, 77, 1.0),
    (1, 129, 131, 4, 1, 128, True, 45, 1.0),
    (1, 257, 70, 2, 2, 128, False, 0, 8.0),
    (1, 97, 161, 4, 1, 256, True, 0, 1.0),
    (1, 161, 97, 2, 1, 256, False, 33, 8.0),
    (1, 200, 70, 2, 1, 64, True, 20, 1.0),
    (1, 200, 70, 2, 1, 128, True, 20, 1.0),
    (1, 200, 70, 2, 1, 256, True, 20, 1.0),
]


def test_chip_smoke_checks_the_same_flash_edges():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FLASH_EDGES == FLASH_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_EDGES)
def test_flash_kernel_edges(cuda, case, dtype):
    b, sq, skv, hq, hkv, d, causal, window, q_scale = case
    rng = np.random.default_rng(sq * 13 + skv + d + window)
    q = (_normal(rng, (b, sq, hq, d), torch.float32, cuda) * q_scale).to(dtype)
    k = _normal(rng, (b, skv, hkv, d), dtype, cuda)
    v = _normal(rng, (b, skv, hkv, d), dtype, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal, window)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_fully_masked_rows_are_zero(cuda, d, dtype):
    """Causal rows past every key, with a window, see nothing: 0."""
    rng = np.random.default_rng(5)
    q = _normal(rng, (1, 160, 2, d), dtype, cuda)
    k = _normal(rng, (1, 48, 1, d), dtype, cuda)
    got = fa_ops.flash_attention(q, k, k, causal=True, window=16)
    assert bool((got[:, 63:] == 0).all())
    assert bool((got[:, :48].float().abs().sum(-1) > 0).all())


# -------------------------------------------------------- decode attention
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, D, S)
    (1, 1, 1, 64, 512),
    (2, 8, 2, 64, 700),      # GQA, ragged cache
    (4, 16, 16, 128, 1024),  # MHA
    (3, 24, 8, 128, 300),    # llama3.2-3b's grouping (G 3)
    (2, 8, 1, 256, 333),     # G 8, wide heads
])
@pytest.mark.parametrize("window", [0, 200])
def test_decode_kernel_matches_plain(cuda, shape, window):
    b, hq, hkv, d, s = shape
    rng = np.random.default_rng(b * 1000 + s + window)
    q = _normal(rng, (b, hq, d), torch.float32, cuda)
    kc = _normal(rng, (b, s, hkv, d), torch.float32, cuda)
    vc = _normal(rng, (b, s, hkv, d), torch.float32, cuda)
    lens = torch.as_tensor(rng.integers(0, s, size=(b,)).astype(np.int32),
                           device=cuda)
    before = da_kernel.LAUNCHES
    got = da_ops.decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert da_kernel.LAUNCHES == before + 1
    want = decode_attention_plain(q, kc, vc, lens, window)
    torch.testing.assert_close(got, want, **_tol(torch.float32))


@pytest.mark.gpu
def test_decode_kernel_bfloat16_and_poisoned_tail(cuda):
    rng = np.random.default_rng(11)
    b, hq, hkv, d, s = 3, 8, 2, 64, 512
    q = _normal(rng, (b, hq, d), torch.bfloat16, cuda)
    kc = _normal(rng, (b, s, hkv, d), torch.bfloat16, cuda)
    vc = _normal(rng, (b, s, hkv, d), torch.bfloat16, cuda)
    lens = torch.tensor([0, 100, 511], dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, kc, vc, lens)
    want = decode_attention_plain(q, kc, vc, lens)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))
    kc2, vc2 = kc.clone(), vc.clone()
    for i, n in enumerate(lens.tolist()):
        kc2[i, n + 1:] = 1e3
        vc2[i, n + 1:] = -1e3
    assert torch.equal(da_ops.decode_attention(q, kc2, vc2, lens), got)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7, 64), (3, 77, 256), (2, 4, 8, 512),
                                   (5, 1024), (3, 2052)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = _normal(rng, shape, dtype, cuda)
    sc = torch.as_tensor(rng.normal(1.0, 0.1, (shape[-1],)).astype(np.float32),
                         device=cuda)
    before = rn_kernel.LAUNCHES
    got = rn_ops.rms_norm(x, sc)
    torch.cuda.synchronize()
    assert rn_kernel.LAUNCHES == before + 1
    want = rms_norm_plain(x, sc)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


# ------------------------------------------------------- wrapper refusals
@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    q = _normal(rng, (1, 32, 4, 64), torch.float32, cuda)
    k = _normal(rng, (1, 32, 2, 64), torch.float32, cuda)
    fa = fa_kernel.flash_attention_cuda
    with pytest.raises(TypeError):
        fa(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa(q, k.half(), k.half())
    # Head dims up to the largest tile (256) are zero-padded; past it,
    # refused.
    wide = [t.repeat(1, 1, 1, 5) for t in (q, k, k)]
    with pytest.raises(ValueError, match="head dim"):
        fa(*wide)
    with pytest.raises(ValueError):
        fa(q, k, k.cpu())
    with pytest.raises(ValueError):
        fa(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError):
        fa(q[:, :, :3].contiguous(), k, k)

    qd = _normal(rng, (2, 4, 64), torch.float32, cuda)
    kc = _normal(rng, (2, 50, 2, 64), torch.float32, cuda)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    da = da_kernel.decode_attention_cuda
    with pytest.raises(TypeError):
        da(qd.bfloat16(), kc, kc, lens)
    with pytest.raises(TypeError):
        da(qd, kc, kc, lens.long())
    with pytest.raises(ValueError):
        da(qd, kc, kc, lens[:1])
    with pytest.raises(ValueError):
        da(qd, kc, kc.cpu(), lens)
    with pytest.raises(ValueError):
        da(qd, kc.transpose(1, 2), kc, lens)
    with pytest.raises(ValueError):
        da(_normal(rng, (2, 40, 64), torch.float32, cuda),
           _normal(rng, (2, 50, 4, 64), torch.float32, cuda),
           _normal(rng, (2, 50, 4, 64), torch.float32, cuda), lens)

    x = _normal(rng, (8, 64), torch.float32, cuda)
    sc = torch.ones(64, device=cuda)
    rn = rn_kernel.rms_norm_cuda
    with pytest.raises(TypeError):
        rn(x.half(), sc)
    with pytest.raises(TypeError):
        rn(x, sc.bfloat16())
    with pytest.raises(ValueError):
        rn(x, sc[:32])
    with pytest.raises(ValueError):
        rn(x.t(), sc)
    with pytest.raises(ValueError):
        rn(x.cpu(), sc)
    with pytest.raises(ValueError):
        rn(x[:, :62].contiguous(), sc[:62].contiguous())
