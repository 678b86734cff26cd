"""``repro_torch.launch.train.train`` over a real process group: gloo ranks
on the CPU (``torch.multiprocessing.spawn``, the rank bodies in
``torch_mesh_ranks.py``), each run held against the one-process run from
the same seed.

The reference cannot be the oracle here: its own ``launch.train`` fails
under this JAX, even on one device (a sharding error in the embedding
gather).  The one-process run is held to the reference's step by
``tests/test_torch_train.py``.

float32 smoke configs, 3 steps of 4 x 16 tokens, a loss logged every
step.  Tolerances:

* losses within 1e-5 relative;
* the final state, gathered whole through the checkpoint, within
  ``test_torch_train.TOL`` (2e-4 abs/rel) by ``_assert_tree_close``;
* every batch a rank's step receives: its rows of
  ``SyntheticLM.global_batch_at`` bit for bit;
* the sharding helpers' gradients within 1e-5 of their largest |value|.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from test_torch_train import F32, TOL, _assert_tree_close  # noqa: E402

RUN = dict(smoke=True, steps=3, batch=4, seq=16, log_every=1, device="cpu")

#: (arch, ranks, model_parallel, grad_accum, config overrides).
CASES = {
    "llama-2x1": ("llama3.2-3b", 2, 1, 1, {}),
    "llama-1x2": ("llama3.2-3b", 2, 2, 1, {}),
    "llama-2x2": ("llama3.2-3b", 4, 2, 1, {}),
    # 2 KV heads over a 4-way model axis: sharding.reshape and local_heads
    # gather the heads.
    "llama-1x4": ("llama3.2-3b", 4, 4, 1, {}),
    # The config's scatter dispatch, over the whole tokens on every rank.
    "moe-2x2": ("qwen2-moe-a2.7b", 4, 2, 1, {}),
    # The expert-parallel dispatch, at a capacity that drops no token (a
    # rank counts its own tokens' capacity, as the reference's shard_map).
    "moe-2x2-shard_map": ("qwen2-moe-a2.7b", 4, 2, 1,
                          {"moe_dispatch": "shard_map",
                           "capacity_factor": 8.0}),
    "llama-2x1-accum2": ("llama3.2-3b", 2, 1, 2, {}),
}


def _final(ckpt_dir, step):
    got, tree, _ = CheckpointManager(ckpt_dir).restore_latest()
    assert got == step
    return tree


def _run(arch, kw, path, world=1, model_parallel=1, kill=False):
    """One run of ``train``: in this process (``world`` 1), or on
    ``world`` gloo ranks.  Returns its result (None if killed)."""
    if world == 1:
        if not kill:
            return train_mod.train(arch, **kw)
        with ranks.killed_after_first_save():
            train_mod.train(arch, **kw)
        return None
    out = str(path / "result.json")
    ranks.spawn(ranks.train_rank, world, arch, model_parallel, kw, out, kill)
    assert not dist.is_initialized()
    if kill:
        return None
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_run_matches_the_plain(case, tmp_path):
    arch, world, mp_, accum, extra = CASES[case]
    kw = dict(RUN, grad_accum=accum, overrides=dict(F32, **extra))
    want = _run(arch, dict(kw, ckpt_dir=str(tmp_path / "plain")), tmp_path)
    got = _run(arch, dict(kw, ckpt_dir=str(tmp_path / "mesh")), tmp_path,
               world, mp_)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=0)
    assert len(got["losses"]) == RUN["steps"]
    _assert_tree_close(_final(tmp_path / "mesh", RUN["steps"]),
                       _final(tmp_path / "plain", RUN["steps"]), **TOL)


@pytest.mark.parametrize("writer,reader", [(4, 1), (1, 4)])
def test_checkpoint_resumes_across_meshes(writer, reader, tmp_path):
    """Killed after its step-2 checkpoint, a run on ``writer`` ranks
    (a (2, 2) mesh, or one process) is resumed to step 4 on ``reader``
    ranks: the final state is the uninterrupted one-process run's."""
    kw = dict(RUN, steps=4, ckpt_every=2, overrides=F32)
    _run("llama3.2-3b", dict(kw, ckpt_dir=str(tmp_path / "full")), tmp_path)
    split = dict(kw, ckpt_dir=str(tmp_path / "split"))
    _run("llama3.2-3b", split, tmp_path, writer, 2, kill=True)
    assert CheckpointManager(split["ckpt_dir"]).latest_step() == 2
    _run("llama3.2-3b", split, tmp_path, reader, 2)
    _assert_tree_close(_final(tmp_path / "split", 4),
                       _final(tmp_path / "full", 4), **TOL)


def test_sharding_helpers_gradients_on_real_ranks():
    """``lookup``, ``batch_local`` (a shared tensor; hymba's Mamba time
    loop) and the expert-parallel moe dispatch on four gloo ranks: each
    gradient equals the plain function's (``torch_mesh_ranks.
    helpers_rank``)."""
    ranks.spawn(ranks.helpers_rank, 4)
    assert not dist.is_initialized()


def test_torchrun_launch_trains_on_two_gloo_ranks(tmp_path):
    """The command line under ``torch.distributed.run``: ``train`` joins
    the group from the environment it sets, trains on a (1, 2) mesh and
    writes the checkpoint once; rank 0 alone prints."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--smoke", "--model-parallel", "2", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("# loss") == 1, proc.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
