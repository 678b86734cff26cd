"""Serving over a process group of one NCCL rank on the card, against the
plain one-device run on the card (``chip_smoke.py`` phase 42's serving
and recurrent-state checks at the smoke size).

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_serve_mesh_gpu.py

Every test needs a GPU and skips without one.  Two ranks cannot share one
card under NCCL, so runs of more ranks are held on the CPU over gloo
(``tests/test_torch_serve_mesh.py``).  The one-rank mesh lays the
weights, the decode cache and each step's tokens out as DTensors over a
(1, 1) mesh:

* ``serve_demo`` joined to the group gives the plain run's tokens, with
  no kernel launch, and its only host syncs are the counted token reads
  (``token_reads`` on the traced ``serve.generate`` span, one a step), as
  without the group;
* hymba-1.5b and rwkv6-3b (float32) give the plain run's tokens through
  24 greedy decode steps, their recurrent states written in place.
"""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rn_kernel  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.sharding import (distribute_model, make_plan,  # noqa: E402
                                  step_layout, whole)

STEPS = 24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


def _audited(fn):
    """``fn()``'s result and its host syncs' warnings."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [w for w in seen if "synchroniz" in str(w.message)
                 and "prototype" not in str(w.message)]


def _greedy(model, steps=STEPS):
    """``steps`` greedy decode steps of 4 slots from seeded tokens: every
    step's tokens, on the host."""
    engine = engine_mod.ServeEngine(model, max_len=64, batch_size=4)
    cache = model.init_cache(4, 64)
    tok = torch.as_tensor(np.random.default_rng(42).integers(
        0, model.cfg.vocab_size, (4, 1)), device=model.device)
    out = []
    for _ in range(steps):
        logits, cache = engine.serve_step(cache, tok)
        tok = whole(torch.argmax(logits[:, -1], dim=-1))[:, None]
        out.append(tok.cpu().numpy())
    return np.concatenate(out, axis=1)


@pytest.mark.gpu
def test_serve_demo_over_one_nccl_rank(cuda, tmp_path):
    want = serve_demo("qwen1.5-0.5b", smoke=True, device=cuda)
    mods = (fa_kernel, da_kernel, rn_kernel)
    for mod in mods:
        mod.LAUNCHES = 0
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    obs_trace.enable()
    try:
        got, syncs = _audited(lambda: serve_demo("qwen1.5-0.5b", smoke=True,
                                                 device=cuda))
    finally:
        obs_trace.disable()
        dist.destroy_process_group()
    reads = sum(e["args"]["token_reads"] for e in obs_trace.events()
                if e["name"] == "serve.generate")
    obs_trace.clear()
    assert got["ranks"] == 1 and want["ranks"] == 1
    assert got["generated"] == want["generated"]
    assert [m.LAUNCHES for m in mods] == [0, 0, 0]
    assert reads > 0 and len(syncs) == reads, [str(w.message)[:200]
                                               for w in syncs]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-3b"])
def test_recurrent_states_over_one_nccl_rank(nccl_rank, arch):
    cfg = get_config(arch, smoke=True, dtype="float32", param_dtype="float32")
    want = _greedy(build_model(cfg, device=nccl_rank, seed=0))
    model = build_model(cfg, device=nccl_rank, seed=0)
    mesh = make_host_mesh(1)
    plan = make_plan(fsdp=False)
    distribute_model(model, plan, mesh)
    with step_layout(plan, mesh):
        got = _greedy(model)
    np.testing.assert_array_equal(got, want)
