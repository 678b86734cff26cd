"""``plan_colocation`` on the card against the same call on the CPU: the
same pairs, ``predicted_cost`` within 1e-5 relative, one ``pair_score``
launch a plan.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_colocation_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import colocation, isc  # noqa: E402
from repro_torch.kernels.pair_score import kernel as ps_kernel  # noqa: E402
from repro_torch.smt import training  # noqa: E402
from repro_torch.smt.machine import MachineParams, SMTMachine  # noqa: E402

#: The reference's stand-in jobs (``examples/colocation_demo.py``).
FALLBACK_JOBS = [
    ("gemma-7b/train_4k", 0.9, 0.5, 0.3, 0.8),
    ("kimi-k2/train_4k", 0.3, 0.9, 1.2, 0.5),
    ("llama3.2-3b/decode_32k", 0.05, 0.9, 0.1, 0.9),
    ("rwkv6-3b/long_500k", 0.1, 0.7, 0.05, 0.9),
    ("starcoder2-3b/prefill_32k", 0.8, 0.4, 0.2, 0.7),
    ("qwen2-moe/train_4k", 0.4, 0.6, 0.9, 0.6),
    ("whisper-v3/prefill_32k", 0.7, 0.5, 0.2, 0.75),
    ("hymba-1.5b/decode_32k", 0.1, 0.8, 0.1, 0.85),
]


def _records(seeded: bool):
    if not seeded:
        return [{"arch": n.split("/")[0], "shape": n.split("/")[1],
                 "compute_s": c, "memory_s": m, "collective_s": i,
                 "useful_flops_ratio": u} for n, c, m, i, u in FALLBACK_JOBS]
    rng = np.random.default_rng(0)
    terms = rng.lognormal(-2.0, 1.5, size=(64, 3))
    return [{"arch": f"job{i}", "shape": "train_4k", "compute_s": float(c),
             "memory_s": float(m), "collective_s": float(k),
             "useful_flops_ratio": float(u)}
            for i, ((c, m, k), u) in enumerate(
                zip(terms, rng.uniform(0.02, 1.2, size=64)))]


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    models, _ = training.build_all_models(
        SMTMachine(MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": isc.SYNPA4_R_FEBE}, device="cpu")
    return models["SYNPA4_R-FEBE"]


@pytest.mark.gpu
@pytest.mark.parametrize("seeded", [False, True], ids=["stand-in", "seeded-64"])
def test_plan_on_the_card_matches_the_cpu(model, seeded):
    records = _records(seeded)
    cpu = colocation.plan_colocation(records, model, device="cpu")
    ps_kernel.LAUNCHES = 0
    card = colocation.plan_colocation(records, model, device="cuda")
    assert ps_kernel.LAUNCHES == 1
    assert card.pairs == cpu.pairs
    np.testing.assert_allclose(card.predicted_cost, cpu.predicted_cost,
                               rtol=1e-5)
