"""End-to-end training entry point on one device.

Synthetic data, the training step, a checkpoint manager with resume and a
heartbeat, as the reference's ``train``, without its mesh: a run takes one
device (``model_parallel`` other than 1 would lay ``launch.mesh.
make_host_mesh`` over an NCCL group, which nothing drives yet: ROADMAP.md,
section 1).  Checkpoints hold the reference's training state
tree (blocks stacked over layers), so each package resumes the other's.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch import resolve_device, to_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig
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
    Returns the first and final logged losses."""
    global LOSS_READS
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the port trains on one device; "
            "nothing runs it over launch.mesh.make_host_mesh yet "
            "(ROADMAP.md, section 1)")
    device = resolve_device(device)
    cfg = get_config(arch, smoke=smoke, **(overrides or {}))
    builder = TrainStepBuilder(
        Model(cfg, device), AdamWConfig(lr=lr), grad_accum=grad_accum,
        warmup_steps=max(steps // 10, 1), total_steps=steps)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = HeartbeatMonitor(hosts=["host0"])

    state = builder.init_state(torch.Generator(device=device).manual_seed(seed))
    start_step = 0
    if manager is not None:
        latest, restored, meta = manager.restore_latest()
        if latest is not None:
            state = train_state_from_numpy(restored, builder.model)
            start_step = int(meta.get("step", latest))
            print(f"# resumed from checkpoint step {start_step}")

    losses = []
    t0 = time.time()
    for it in range(start_step, steps):
        hb = data.host_batch(it, 0, 1)
        batch_dev = {k: to_device(v, torch.int32, device)
                     for k, v in hb.items()}
        state, metrics = builder.train_step(state, batch_dev)
        monitor.beat("host0")
        if (it + 1) % log_every == 0 or it == steps - 1:
            loss, step_lr = torch.stack([metrics["loss"],
                                         metrics["lr"]]).tolist()
            LOSS_READS += 1
            losses.append(loss)
            print(f"step {it+1:5d}  loss {loss:.4f}  lr {step_lr:.2e}  "
                  f"{(it + 1 - start_step) / (time.time()-t0):.2f} it/s")
        if manager is not None and (it + 1) % ckpt_every == 0:
            manager.save(it + 1, train_state_to_numpy(state),
                         meta={"arch": arch})
    if manager is not None:
        manager.save(steps, train_state_to_numpy(state), meta={"arch": arch})

    return {
        "first_loss": losses[0] if losses else float("nan"),
        "final_loss": losses[-1] if losses else float("nan"),
        "steps": steps,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, model_parallel=args.model_parallel,
                grad_accum=args.grad_accum, device=args.device)
    print(f"# loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"over {out['steps']} steps")


if __name__ == "__main__":
    main()
