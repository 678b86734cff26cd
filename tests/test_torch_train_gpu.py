"""The training path and the moe family on the card, against the same
calls on the CPU.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_gpu.py

Every test needs a GPU and skips without one.  TF32 is off, so the card's
float32 products are float32's.  Tolerances: losses rtol 1e-4; parameters
after three steps within 1e-4 of each tensor's largest |value|; logits
within 1e-4 of the largest |logit|.  The key bias is added before RoPE,
so in the dimensions that RoPE turns slowly its gradient is near zero,
at the float error, and AdamW steps on that noise: its first moment (the
gradients) is held within 1e-4 of the largest first moment, its values
within the learning rates' sum.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import TrainStepBuilder  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _train(model, steps, batch_size=4, seq=32):
    builder = TrainStepBuilder(model, AdamWConfig(lr=1e-3), warmup_steps=1,
                               total_steps=10)
    state = builder.fresh_state()
    data = SyntheticLM(model.cfg.vocab_size, seq, batch_size, seed=1)
    metrics = []
    for it in range(steps):
        state, m = builder.train_step(state, data.global_batch_at(it))
        metrics.append((float(m["loss"]), float(m["aux"]), float(m["lr"])))
    return np.array(metrics), state


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch):
    """Depth 2 (the smoke configs), the same weights, three steps."""
    cfg = get_config(arch, smoke=True, **F32)
    on_cpu = build_model(cfg, device="cpu", seed=2)
    on_card = copy.deepcopy(on_cpu).to(cuda)
    want, want_state = _train(on_cpu, 3)
    got, got_state = _train(on_card, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    lr_sum = float(want[:, 2].sum())
    want_mu, got_mu = want_state["opt"]["mu"], got_state["opt"]["mu"]
    mu_atol = 1e-4 * max(float(m.abs().max()) for m in want_mu.values())
    for name, p in want_state["params"].items():
        err = float((got_state["params"][name].detach().cpu()
                     - p.detach()).abs().max())
        if name.endswith("attn.bk"):
            mu_err = float((got_mu[name].cpu() - want_mu[name]).abs().max())
            assert mu_err <= mu_atol, name + " first moment"
            limit = lr_sum
        else:
            limit = 1e-4 * float(p.detach().abs().max())
        assert err <= limit, name


@pytest.mark.gpu
def test_moe_prefill_launches_flash_once_a_layer(cuda):
    cfg = get_config("qwen2-moe-a2.7b", smoke=True, head_dim=64,
                     attention_impl="kernel", **F32)
    model = build_model(cfg, device=cuda, seed=3)
    plain = build_model(cfg.scaled(attention_impl="plain"), device=cuda,
                        seed=3)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32), device=cuda)
    before = fa_kernel.LAUNCHES
    with torch.no_grad():
        got, aux = model.forward({"tokens": tokens})
        torch.cuda.synchronize()
        assert fa_kernel.LAUNCHES - before == cfg.n_layers
        want, want_aux = plain.forward({"tokens": tokens})
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-4)


@pytest.mark.gpu
def test_training_through_the_kernel_is_refused(cuda):
    cfg = get_config("qwen2-moe-a2.7b", smoke=True, head_dim=64,
                     attention_impl="kernel")
    with pytest.raises(NotImplementedError, match="backward kernel"):
        TrainStepBuilder(build_model(cfg, device=cuda))
