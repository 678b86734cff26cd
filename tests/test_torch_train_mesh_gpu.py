"""``launch.train.train`` over a process group of one NCCL rank on the card,
against the plain one-device run on the card.

This file imports nothing of JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_train_mesh_gpu.py

Every test needs a GPU and skips without one.  Two ranks cannot share one
card under NCCL, so runs of more ranks are held on the CPU over gloo
(``tests/test_torch_train_mesh.py``).  The one-rank mesh lays the state
and batches out as DTensors over a (1, 1) mesh; its logged losses and
its final state (gathered through the checkpoint) are held to the plain
run's bit for bit, as ``chip_smoke.py`` phase 41 found them at full size.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402

RUN = dict(smoke=True, steps=6, batch=4, seq=64, log_every=1, ckpt_every=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.2-3b"])
def test_one_rank_nccl_mesh_trains_as_one_device(cuda, arch, tmp_path):
    want = train_mod.train(arch, device=cuda, ckpt_dir=str(tmp_path / "plain"),
                           **RUN)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        rank=0, world_size=1)
    try:
        got = train_mod.train(arch, device=cuda,
                              ckpt_dir=str(tmp_path / "mesh"), **RUN)
    finally:
        dist.destroy_process_group()
    assert got["losses"] == want["losses"]
    trees = [dict(_leaves(CheckpointManager(str(tmp_path / d))
                          .restore_latest()[1])) for d in ("mesh", "plain")]
    assert trees[0].keys() == trees[1].keys()
    for k, v in trees[1].items():
        assert trees[0][k].tobytes() == v.tobytes(), k
