"""The last five architectures on the card, against the same calls on the
CPU: flash attention at head dims that are no tile of the kernel's (zero-
padded to the next one), the ring-buffer decode, and the hybrid and ssm
families' smoke configs.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_families_gpu.py

Every test needs a GPU and skips without one.  TF32 is off, so the card's
float32 products are float32's.  Tolerances: the kernel against its plain
version 1e-4 abs/rel in float32, 2e-2 in bfloat16; logits within 2e-5 of
the largest |logit|; greedy tokens identical.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_plain  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
LOGIT_REL = 2e-5


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
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 300, 64, 8, 112), True, 0),   # kimi-k2's heads, padded to 128
    ((2, 333, 4, 2, 16), True, 0),     # the smoke configs' D 16, to 64
    ((1, 200, 5, 1, 12), True, 16),    # hymba's smoke heads, a window
    ((1, 97, 4, 4, 32), False, 0),     # gemma's smoke heads, non-causal
])
def test_padded_head_dims_match_the_plain_version(cuda, shape, causal,
                                                  window, dtype):
    """The scale is the true head dim's: a padded launch equals the plain
    version at the unpadded shape."""
    b, s, hq, hkv, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, s, hq, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    before = fa_kernel.LAUNCHES
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    assert fa_kernel.LAUNCHES - before == 1
    assert got.shape == q.shape and got.is_contiguous()
    want = flash_attention_plain(q, k, v, causal, window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _twins(cuda, arch):
    cfg = get_config(arch, smoke=True, attention_impl="kernel", **F32)
    on_cpu = build_model(cfg, device="cpu", seed=1)
    return cfg, on_cpu, copy.deepcopy(on_cpu).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["starcoder2-3b", "hymba-1.5b",
                                  "rwkv6-3b"])
def test_smoke_serving_on_the_card_matches_the_cpu(cuda, arch):
    """A 40-token prefill (past the smoke windows of 16, through the
    padded kernel on the card), then 48 decode steps that wrap the 16-slot
    rings three times, slot 1 reset after step 20: logits at every step,
    greedy choices identical."""
    cfg, on_cpu, on_card = _twins(cuda, arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    with torch.no_grad():
        want, _ = on_cpu.forward({"tokens": toks[:, :40]})
        got, _ = on_card.forward({"tokens": toks[:, :40]})
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= LOGIT_REL * scale
    engines = [ServeEngine(m, 64, 2) for m in (on_cpu, on_card)]
    caches = [m.init_cache(2, 64) for m in (on_cpu, on_card)]
    for t in range(48):
        outs = []
        for i, (eng, dev) in enumerate(zip(engines, ("cpu", cuda))):
            tok = torch.as_tensor(toks[:, t:t + 1], device=dev)
            logits, caches[i] = eng.serve_step(caches[i], tok)
            if t == 20:
                caches[i] = eng.reset_slots(caches[i], np.array([False, True]))
            outs.append(logits.cpu())
        scale = float(outs[0].abs().max())
        assert float((outs[1] - outs[0]).abs().max()) <= LOGIT_REL * scale
        assert torch.equal(outs[1].argmax(-1), outs[0].argmax(-1))
    assert caches[1]["pos"].tolist() == caches[0]["pos"].tolist() == [48, 27]
