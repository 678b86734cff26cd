"""Kimi-K2-Instruct's paths on the card: the flash kernel at latent
attention's shapes, starcoder2's launches as before, the grouped expert
products, and a two-layer model at full width against the plain float32
reference (``portbench/reference/moe.py``), routed by the port's own
expert choices.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src:. python -m pytest -m gpu tests/test_torch_kimi_k2_gpu.py

Every test needs a GPU and skips without one.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench.reference import moe as ref  # noqa: E402
from portbench.reference import weights as weights_mod  # noqa: E402
from portbench.reference.common import exact_matmul, final_logits  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _randn(*shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, device=device, dtype=dtype, generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("seq", [1000, 2048])
def test_flash_at_latent_attention_shapes(cuda, dtype, tol, seq):
    """q and k of 192, v of 128, the MLA scale: against the plain twin
    (bfloat16 rounds its probabilities before the product with v)."""
    q = _randn(1, seq, 16, 192, dtype=dtype, device=cuda, seed=1)
    k = _randn(1, seq, 16, 192, dtype=dtype, device=cuda, seed=2)
    v = _randn(1, seq, 16, 128, dtype=dtype, device=cuda, seed=3)
    got = fa_kernel.flash_attention_cuda(q, k, v, True, 0, 0.13086)
    want = flash_attention_plain(q, k, v, True, 0, 0.13086)
    assert got.shape == (1, seq, 16, 128)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
def test_starcoder2_launches_are_bit_identical_to_before(cuda):
    """The wrapper's default scale launches exactly what it did before it
    took one: the same kernel arguments, the same output bits."""
    b, s, h, hkv, d, window = 2, 6144, 24, 2, 128, 4096
    q = _randn(b, s, h, d, dtype=torch.bfloat16, device=cuda, seed=4)
    k = _randn(b, s, hkv, d, dtype=torch.bfloat16, device=cuda, seed=5)
    v = _randn(b, s, hkv, d, dtype=torch.bfloat16, device=cuda, seed=6)
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=True, window=window)
    before = torch.empty_like(q)
    units = fa_kernel.LIB.call("flash_attention_scratch", b, s, hkv, d, 1)
    scratch = torch.empty(16 * max(units, 1), dtype=torch.float32,
                          device=cuda)
    fa_kernel.LIB.launch(
        "flash_attention_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        before.data_ptr(), scratch.data_ptr(), b, s, s, h, hkv, d, 1, window,
        d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(got, before)


@pytest.mark.gpu
def test_grouped_products_match_the_loop(cuda):
    """The card's grouped route against a loop of products over the same
    groups, empty groups included; rows past the last end are not read."""
    x = _randn(3000, 7168, dtype=torch.bfloat16, device=cuda, seed=7)
    w = _randn(12, 7168, 2048, dtype=torch.bfloat16, device=cuda, seed=8)
    w = w * 7168 ** -0.5
    counts = torch.tensor([300, 0, 500, 100, 0, 250, 400, 100, 50, 300, 200,
                           150], device=cuda)
    ends = torch.cumsum(counts, 0).to(torch.int32)
    got = moe._grouped(x, w, ends)
    want = moe._grouped(x.float(), w, ends)
    n = int(ends[-1])
    err = (got[:n].float() - want[:n]).abs().max()
    assert float(err) <= 2 ** -7 * float(want[:n].abs().max())


def _two_layers(dtype):
    spec = json.loads((ROOT / "portbench/configs/kimi-k2-instruct.json")
                      .read_text())["model"]
    return dict(spec, n_layers=2, dtype=dtype)


def _build(cfg, w):
    model = Model(ModelConfig(**cfg), device="meta")
    for name, _ in list(model.named_parameters()):
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf,
                torch.nn.Parameter(w[name], requires_grad=False))
    return model


def _gap(w, cfg, h, chosen):
    logits = final_logits(w, cfg, h)
    return float((logits.max(-1).values
                  - logits.gather(1, chosen[:, None])[:, 0]).max())


@pytest.mark.gpu
def test_two_layers_at_full_width_match_the_reference(cuda, monkeypatch):
    """The dense block and one MoE block at the published widths, 12 of
    384 experts held: float32 activations against the float32 reference
    (the flash kernel's 3xTF32 products, 1e-4); then bfloat16 through the
    grouped products, against the reference routed by the port's own
    expert choices, beside the float8 control against the reference routed
    by the control's: the port's widest logit gap and widest route gap at
    most a third of the control's (bfloat16 keeps 8 bits of mantissa,
    e4m3 4)."""
    cfg = _two_layers("float32")
    w = weights_mod.draw(cfg, 2024, cuda)
    toks = torch.randint(0, cfg["vocab_size"], (1, 2048), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))
    ids = []
    route = moe._route_sigmoid

    def recording(params, x, c):
        weights, top = route(params, x, c)
        ids.append(top)
        return weights, top

    with torch.no_grad():
        got, _ = _build(cfg, w).forward({"tokens": toks})
        with exact_matmul():
            want = final_logits(w, cfg, ref.hidden(w, cfg, toks)[0])
        assert float((got[0] - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
        del got, want
        monkeypatch.setattr(moe, "_route_sigmoid", recording)
        bf, _ = _build(dict(cfg, dtype="bfloat16"), w).forward(
            {"tokens": toks})
        monkeypatch.setattr(moe, "_route_sigmoid", route)
        chosen = bf[0].argmax(-1)
        del bf
        with exact_matmul():
            port = ref.Routes(follow=ids)
            port_gap = _gap(w, cfg, ref.hidden(w, cfg, toks, routes=port)[0],
                            chosen)
            own = ref.Routes()
            hc = ref.hidden(w, cfg, toks, fp8=True, routes=own)[0]
            ctrl_chosen = final_logits(w, cfg, hc, fp8=True).argmax(-1)
            ctrl = ref.Routes(follow=own.ids)
            ctrl_gap = _gap(w, cfg, ref.hidden(w, cfg, toks, routes=ctrl)[0],
                            ctrl_chosen)
    assert len(ids) == 1
    assert 3 * port_gap <= ctrl_gap
    assert 3 * max(port.gaps) <= max(ctrl.gaps)


@pytest.mark.gpu
def test_the_bfloat16_forward_waits_for_nothing(cuda):
    """No host sync in a bfloat16 forward of the two layers: the grouped
    products' ends, the held rows and the combine stay on the device."""
    cfg = _two_layers("bfloat16")
    model = _build(cfg, weights_mod.draw(cfg, 7, cuda))
    toks = torch.zeros((1, 512), dtype=torch.long, device=cuda)
    with torch.no_grad():
        model.forward({"tokens": toks})
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.forward({"tokens": toks})
        finally:
            torch.cuda.set_sync_debug_mode("default")
