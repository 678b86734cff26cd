"""``layers.dot``'s tensor-core route on the card, at the benchmark cells'
product shapes, against float64 products of the same bfloat16 values.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dot_gpu.py

Every test needs a GPU and skips without one.  The products of two
bfloat16 values are exact in float32, so the route's only error is its
float32 sum's: over ``k`` terms in any order, and with truncating
additions, at most ``k * 2**-23`` times the sum of the terms' magnitudes
(``|x| @ |w|``).  That bound, elementwise, is the tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402

BF16 = torch.bfloat16

#: (name, leading shape of x, k, n): starcoder2-3b's seven products at
#: 16,384 rows (a prefill batch of 2 x 8,192), rwkv6-3b's time-mix output
#: and logits at 256 rows (a decode step of 256 slots).
SHAPES = [
    ("starcoder2.q", (2, 8192), 3072, 3072),
    ("starcoder2.k", (2, 8192), 3072, 256),
    ("starcoder2.v", (2, 8192), 3072, 256),
    ("starcoder2.o", (2, 8192), 3072, 3072),
    ("starcoder2.wi", (2, 8192), 3072, 12288),
    ("starcoder2.wo", (2, 8192), 12288, 3072),
    ("starcoder2.logits", (2, 8192), 3072, 49152),
    ("rwkv6.w_out", (256, 1), 2560, 2560),
    ("rwkv6.logits", (256, 1), 2560, 65536),
]
#: Rows compared in float64 at a time.
CHUNK = 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _operands(lead, k, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((*lead, k), generator=g, device=device).to(BF16)
    w = (torch.randn((k, n), generator=g, device=device) * k ** -0.5).to(BF16)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("name,lead,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_tensor_core_route_within_the_float32_sum_bound(cuda, name, lead, k,
                                                        n):
    x, w = _operands(lead, k, n, cuda)
    before = (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32)
    with torch.no_grad():
        y = layers.dot(x, w)
    assert (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32) == (before[0] + 1,
                                                            before[1])
    assert y.dtype == torch.float32 and tuple(y.shape) == (*lead, n)
    x2d, y2d = x.reshape(-1, k).double(), y.reshape(-1, n)
    w64 = w.double()
    worst = 0.0
    for r in range(0, x2d.shape[0], CHUNK):
        xs = x2d[r:r + CHUNK]
        err = (y2d[r:r + CHUNK].double() - xs @ w64).abs()
        bound = k * 2.0 ** -23 * (xs.abs() @ w64.abs())
        worst = max(worst, float((err - bound).max()))
    assert worst <= 0.0, name
    assert bool(torch.isfinite(y).all())


@pytest.mark.gpu
def test_recorded_products_keep_the_float32_route(cuda):
    """While autograd records the product (training), ``dot`` upcasts and
    the gradient flows back in bfloat16."""
    x, w = _operands((4, 16), 64, 32, cuda)
    w.requires_grad_(True)
    before = (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32)
    y = layers.dot(x, w)
    assert (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32) == (before[0],
                                                            before[1] + 1)
    y.sum().backward()
    assert w.grad.dtype == BF16 and tuple(w.grad.shape) == (64, 32)
    x2d = x.reshape(-1, 64).float()
    want = x2d.T @ torch.ones(x2d.shape[0], 32, device=cuda)
    np.testing.assert_allclose(w.grad.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,want", [
    ("starcoder2-3b", lambda n: (6 * n + 1, 0)),
    ("rwkv6-3b", lambda n: (n + 1, 8 * n)),
])
def test_smoke_forward_counts_on_the_card(cuda, arch, want):
    """The smoke configs in bfloat16 take the routes the CPU test replays
    (``tests/test_torch_dot.py::test_forward_counts``)."""
    cfg = get_config(arch, smoke=True, dtype="bfloat16",
                     param_dtype="bfloat16")
    model = build_model(cfg, device=cuda, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda)
    before = (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32)
    with torch.no_grad():
        model.forward({"tokens": tokens})
    after = (layers.DOT_TENSOR_CORE, layers.DOT_FLOAT32)
    assert (after[0] - before[0], after[1] - before[1]) == want(cfg.n_layers)
