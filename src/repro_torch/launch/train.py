"""End-to-end training entry point, the twin of ``repro.launch.train``.

Synthetic data, the training step, a checkpoint manager with resume and a
heartbeat, as the reference's ``train``.  Inside a process group (one the
caller has initialised, or one joined from ``torch.distributed.run``'s
environment: ``launch.mesh.host_group``) the state is laid out as the
reference lays it: a ``make_host_mesh(model_parallel)`` of (data, model)
over the group's ranks and ``make_plan(multi_pod=False, fsdp=False)``,
weights and moments as DTensors, each rank's rows of the global batch
sharded over "data"; NCCL on ``cuda`` (one card a rank), gloo on
``cpu``.  Without a group a run takes one device.  Checkpoints hold the
reference's training state tree (blocks stacked over layers), whole
whatever the mesh, so each package resumes the other's and a sharded run
resumes a one-device run's, and the reverse.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --smoke \\
        --model-parallel 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import resolve_device, to_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.launch.mesh import host_group, make_host_mesh
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import (batch_sharding, distribute_model,
                                  make_plan, placements_for, step_layout,
                                  whole)
from repro_torch.train.step import TrainStepBuilder

#: Host reads of a step's metrics in this process: :func:`train` adds one
#: at each log (one copy of the loss and the learning rate together), the
#: only time a training step waits for the device.
LOSS_READS = 0


def train(
    arch: str,
    smoke: bool = True,
    steps: int = 200,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-3,
    ckpt_dir: str = "",
    ckpt_every: int = 50,
    model_parallel: int = 1,
    grad_accum: int = 1,
    log_every: int = 10,
    overrides: Dict[str, Any] | None = None,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Train ``arch`` for ``steps`` steps on ``device`` (``cuda`` unless
    told otherwise), weights drawn from a generator seeded ``seed`` on
    that device.  Resumes from the newest checkpoint in ``ckpt_dir``.
    Inside a process group every rank draws the same whole weights and
    keeps its part of them (see the module's docstring); without one,
    ``model_parallel`` other than 1 raises ``make_host_mesh``'s error.
    Returns the first and final logged losses, and every logged loss."""
    device = resolve_device(device)
    with host_group(device) as rank_device:
        mesh = None
        if rank_device is not None or model_parallel != 1:
            mesh = make_host_mesh(model_parallel)
            device = rank_device
        return _train(arch, smoke, steps, batch, seq, lr, ckpt_dir,
                      ckpt_every, grad_accum, log_every, overrides, seed,
                      device, mesh)


def _train(arch, smoke, steps, batch, seq, lr, ckpt_dir, ckpt_every,
           grad_accum, log_every, overrides, seed, device, mesh):
    global LOSS_READS
    from torch.distributed.tensor import DTensor

    cfg = get_config(arch, smoke=smoke, **(overrides or {}))
    builder = TrainStepBuilder(
        Model(cfg, device), AdamWConfig(lr=lr), grad_accum=grad_accum,
        warmup_steps=max(steps // 10, 1), total_steps=steps)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    rank, world = ((dist.get_rank(), dist.get_world_size()) if mesh
                   is not None else (0, 1))
    monitor = HeartbeatMonitor(hosts=[f"host{r}" for r in range(world)])

    builder.model.init_weights(
        torch.Generator(device=device).manual_seed(seed))
    layout = contextlib.nullcontext()
    data_rank, data_size = 0, 1
    if mesh is not None:
        plan = make_plan(multi_pod=False, fsdp=False)
        distribute_model(builder.model, plan, mesh)
        data_axis = mesh.mesh_dim_names.index("data")
        data_rank = mesh.get_local_rank(data_axis)
        data_size = mesh.size(data_axis)
        rows = {k: torch.empty((batch, seq), device="meta")
                for k in ("tokens", "labels")}
        batch_pl = {k: placements_for(spec, mesh) for k, spec in
                    batch_sharding(rows, plan, mesh).items()}
        layout = step_layout(plan, mesh)
    # The moments are made here, laid out as the weights.
    state = builder.fresh_state()
    start_step = 0
    if manager is not None:
        latest, restored, meta = manager.restore_latest()
        if latest is not None:
            state = train_state_from_numpy(restored, builder.model)
            start_step = int(meta.get("step", latest))
            if rank == 0:
                print(f"# resumed from checkpoint step {start_step}")

    losses = []
    t0 = time.time()
    with layout:
        for it in range(start_step, steps):
            hb = data.host_batch(it, data_rank, data_size)
            batch_dev = {k: to_device(v, torch.int32, device)
                         for k, v in hb.items()}
            if mesh is not None:
                batch_dev = {k: DTensor.from_local(v, mesh, batch_pl[k],
                                                   run_check=False)
                             for k, v in batch_dev.items()}
            state, metrics = builder.train_step(state, batch_dev)
            monitor.beat(f"host{rank}")
            if (it + 1) % log_every == 0 or it == steps - 1:
                loss, step_lr = torch.stack([whole(metrics["loss"]),
                                             metrics["lr"]]).tolist()
                LOSS_READS += 1
                losses.append(loss)
                if rank == 0:
                    print(f"step {it+1:5d}  loss {loss:.4f}  lr "
                          f"{step_lr:.2e}  "
                          f"{(it + 1 - start_step) / (time.time()-t0):.2f} "
                          "it/s")
            if manager is not None and (it + 1) % ckpt_every == 0:
                manager.save(it + 1, train_state_to_numpy(state),
                             meta={"arch": arch})
    if manager is not None:
        manager.save(steps, train_state_to_numpy(state), meta={"arch": arch})

    return {
        "first_loss": losses[0] if losses else float("nan"),
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "steps": steps,
    }


def main():
    ap = argparse.ArgumentParser(
        description="Train on one device, or on every rank of a process "
        "group: python -m torch.distributed.run --standalone "
        "--nproc-per-node N -m repro_torch.launch.train --model-parallel M "
        "[--device cpu] (NCCL on cuda, one card a rank; gloo on cpu).")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's model axis (ranks // M data-parallel)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, model_parallel=args.model_parallel,
                grad_accum=args.grad_accum, device=args.device)
    if int(os.environ.get("RANK", 0)) == 0:
        print(f"# loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
              f"over {out['steps']} steps")


if __name__ == "__main__":
    main()
