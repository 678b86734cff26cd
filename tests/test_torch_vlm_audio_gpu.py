"""The vlm and audio families on the card, against the same calls on the
CPU: flash attention at the two shapes their main paths give it, and a
smoke forward of each family through the kernel.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_vlm_audio_gpu.py

Every test needs a GPU and skips without one.  TF32 is off, so the card's
float32 products are float32's.  Tolerances: the kernel against its plain
version 1e-4 abs/rel in float32, 2e-2 in bfloat16; logits within 1e-4 of
the largest |logit|.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_plain  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [
    ((4, 2048, 32, 8, 128), True),     # llama-3.2-vision-11b's self blocks
    ((4, 1500, 20, 20, 64), False),    # whisper-large-v3's encoder
])
def test_flash_at_the_main_paths_shapes(cuda, shape, causal, dtype):
    b, s, hq, hkv, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, s, hq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,launches,noncausal", [
    ("llama-3.2-vision-11b", 4, 0), ("whisper-large-v3", 4, 2)])
def test_smoke_forward_on_the_card_matches_the_cpu(cuda, arch, launches,
                                                   noncausal):
    """Heads of 64 (the kernel's least), every gate at 0.5; the card runs
    the kernel once a self block (the whisper encoder's non-causally), the
    CPU its plain version."""
    cfg = get_config(arch, smoke=True, head_dim=64, attention_impl="kernel",
                     **F32)
    on_cpu = build_model(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for name, p in on_cpu.named_parameters():
            if name.endswith("gate"):
                p.fill_(0.5)
    on_card = copy.deepcopy(on_cpu).to(cuda)
    rng = np.random.default_rng(2)
    t = cfg.n_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
    key = "image_embeds" if cfg.family == "vlm" else "audio_frames"
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)).astype(
        np.int32), key: rng.normal(size=(2, t, cfg.d_model)).astype(
            np.float32)}
    before = (fa_kernel.LAUNCHES, fa_kernel.NONCAUSAL_LAUNCHES)
    with torch.no_grad():
        got, _ = on_card.forward(batch)
        torch.cuda.synchronize()
        assert (fa_kernel.LAUNCHES - before[0],
                fa_kernel.NONCAUSAL_LAUNCHES - before[1]) == (launches,
                                                               noncausal)
        want, _ = on_cpu.forward(batch)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
