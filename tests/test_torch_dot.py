"""``layers.dot``'s two routes, on the CPU.

Two bfloat16 operands that are plain CUDA tensors, whose product autograd
does not record, multiply on the tensor cores (``torch.mm`` with a float32
result); anything else is upcast to float32.  The CPU has no kernel for the
tensor-core product, so the rule is tested here on what it reads: the
operands' dtypes, rank and grad flags as they are, the device type and
DTensor-ness given.  Over a smoke forward the card's choice is replayed by
reading the device type as "cuda" and multiplying as the float32 route
does, and the counters are held to one forward's products: 6 a layer and
the logits for starcoder2-3b, one a layer (the time mix's ``w_out``) and
the logits against eight a layer for rwkv6-3b.  The product itself is
tested on the card (``tests/test_torch_dot_gpu.py``).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _operands(x_dtype=BF16, w_dtype=BF16, w_shape=(8, 5), grad=False):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 8), generator=g).to(x_dtype)
    w = torch.randn(w_shape, generator=g).to(w_dtype).requires_grad_(grad)
    return x, w


def _counts():
    return layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32


@pytest.mark.parametrize("case,device_type,distributed,want", [
    (dict(), "cuda", False, True),
    (dict(x_dtype=F32), "cuda", False, False),
    (dict(w_dtype=F32), "cuda", False, False),
    (dict(x_dtype=F32, w_dtype=F32), "cuda", False, False),
    (dict(x_dtype=torch.float16, w_dtype=torch.float16), "cuda", False,
     False),
    (dict(grad=True), "cuda", False, False),
    (dict(), "cuda", True, False),
    (dict(), "cpu", False, False),
    (dict(), "meta", False, False),
    (dict(w_shape=(8, 5, 1)), "cuda", False, False),
])
def test_route_rule(case, device_type, distributed, want):
    x, w = _operands(**case)
    assert layers.tensor_core_route(x, w, device_type, distributed) is want


def test_grad_counts_only_while_autograd_records():
    """A weight that requires grad keeps the route under ``no_grad`` and
    ``inference_mode``, where autograd records nothing; an input that
    requires grad leaves it while grad is on."""
    x, w = _operands(grad=True)
    assert not layers.tensor_core_route(x, w, "cuda", False)
    with torch.no_grad():
        assert layers.tensor_core_route(x, w, "cuda", False)
    with torch.inference_mode():
        assert layers.tensor_core_route(x, w, "cuda", False)
    x, w = _operands()
    assert not layers.tensor_core_route(x.requires_grad_(True), w, "cuda",
                                        False)


@pytest.mark.parametrize("x_dtype,w_dtype", [(BF16, BF16), (F32, BF16),
                                             (BF16, F32), (F32, F32)])
def test_cpu_takes_the_float32_route_bit_for_bit(x_dtype, w_dtype):
    x, w = _operands(x_dtype, w_dtype)
    before = _counts()
    got = layers.dot(x, w)
    assert got.dtype == F32
    assert torch.equal(got, x.float() @ w.float())
    assert _counts() == (before[0], before[1] + 1)


@pytest.fixture
def as_on_the_card(monkeypatch):
    """``dot`` choosing as on the card: the device type read as "cuda",
    DTensor-ness as it is, and the tensor-core product computed as the
    float32 route computes it."""
    rule = layers.tensor_core_route
    monkeypatch.setattr(layers, "tensor_core_route",
                        lambda x, w, device_type, distributed:
                        rule(x, w, "cuda", distributed))
    monkeypatch.setattr(layers, "_tensor_core_mm",
                        lambda x2d, w: x2d.float() @ w.float())


def test_dot_shapes_on_the_tensor_core_route(as_on_the_card):
    """Rows flattened and viewed back: a (2, 3, 8) input, a 1-D one and a
    transposed weight (``tied_unembed``'s ``table.T``)."""
    x, w = _operands()
    before = _counts()
    got = layers.dot(x, w)
    assert got.dtype == F32 and tuple(got.shape) == (2, 3, 5)
    torch.testing.assert_close(got, x.float() @ w.float(), rtol=1e-6,
                               atol=1e-6)
    assert tuple(layers.dot(x[0, 0], w).shape) == (5,)
    table = torch.randn(5, 8).to(BF16)
    torch.testing.assert_close(layers.dot(x, table.T),
                               x.float() @ table.float().T, rtol=1e-6,
                               atol=1e-6)
    assert _counts() == (before[0] + 3, before[1])


def test_dtensor_takes_the_float32_route(as_on_the_card, tmp_path):
    """DTensor operands (a one-rank gloo mesh, as ``serve_mesh`` lays them)
    keep the float32 route even where the device reads as "cuda"."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        x, w = _operands()
        xd, wd = (distribute_tensor(t, mesh, [Replicate()]) for t in (x, w))
        assert layers._is_dtensor(wd) and not layers._is_dtensor(w)
        before = _counts()
        got = layers.dot(xd, wd)
        assert _counts() == (before[0], before[1] + 1)
        assert torch.equal(got.full_tensor(), x.float() @ w.float())
        layers.dot(x, w)
        assert _counts() == (before[0] + 1, before[1] + 1)
    finally:
        dist.destroy_process_group()


def _forward_counts(arch, grad=False, **overrides):
    """One smoke forward of ``arch`` (20 tokens): products taken on each
    route."""
    cfg = get_config(arch, smoke=True, **overrides)
    model = Model(cfg, "cpu").init_weights(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    for p in model.parameters():
        p.requires_grad_(grad)
    before = _counts()
    with torch.set_grad_enabled(grad):
        model.forward({"tokens": tokens})
    after = _counts()
    return cfg, (after[0] - before[0], after[1] - before[1])


@pytest.mark.parametrize("arch,want", [
    ("starcoder2-3b", lambda n: (6 * n + 1, 0)),
    ("rwkv6-3b", lambda n: (n + 1, 8 * n)),
])
def test_forward_counts(as_on_the_card, arch, want):
    """bfloat16 as the benchmark's configurations: 181 and 0 for
    starcoder2-3b's 30 layers, 33 and 256 for rwkv6-3b's 32; every product
    on the float32 route in float32, or while training."""
    cfg, counts = _forward_counts(arch, dtype="bfloat16",
                                  param_dtype="bfloat16")
    n = cfg.n_layers
    assert counts == want(n)
    total = sum(want(n))
    assert _forward_counts(arch, dtype="float32",
                           param_dtype="float32")[1] == (0, total)
    assert _forward_counts(arch, grad=True, dtype="bfloat16",
                           param_dtype="bfloat16")[1] == (0, total)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "rwkv6-3b"])
def test_cpu_forward_counts_no_tensor_core_product(arch):
    cfg, (tc, f32) = _forward_counts(arch, dtype="bfloat16",
                                     param_dtype="bfloat16")
    assert tc == 0 and f32 > 0

