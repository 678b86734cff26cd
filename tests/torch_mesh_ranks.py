"""Rank bodies for ``tests/test_torch_train_mesh.py``.

Each function here runs in a process that ``torch.multiprocessing.spawn``
starts, as one rank of a gloo process group over localhost.  The module
imports torch, numpy and the port alone, so a rank starts without JAX.
"""

import contextlib
import json
import socket
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Killed(Exception):
    """Raised by a run's checkpoint manager right after its first save."""


def spawn(fn, world: int, *args) -> None:
    """``fn(rank, world, port, *args)`` on ``world`` gloo ranks."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(fn, args=(world, port) + args, nprocs=world)


@contextlib.contextmanager
def gloo(rank: int, world: int, port: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def killed_after_first_save():
    """The run's checkpoint manager raises :class:`Killed` right after its
    first save (every rank, past the save's barrier)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    save = CheckpointManager.save

    def dying(self, step, tree, meta=None):
        save(self, step, tree, meta)
        raise Killed(step)

    CheckpointManager.save = dying
    try:
        yield
    except Killed:
        pass
    finally:
        CheckpointManager.save = save


def train_rank(rank, world, port, arch, model_parallel, kw, out, kill=False):
    """``launch.train.train`` on this rank; rank 0 writes its result to
    ``out``.  Every batch the step receives is checked: this rank's rows
    of the global batch as ``SyntheticLM.global_batch_at`` gives them,
    sharded over "data" (the same rows on each rank of a "model" group),
    and the whole DTensor equal to the global batch."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models.registry import get_config
    from repro_torch.train.step import TrainStepBuilder

    cfg = get_config(arch, smoke=kw.get("smoke", True),
                     **kw.get("overrides", {}))
    data = SyntheticLM(cfg.vocab_size, kw["seq"], kw["batch"], seed=0)
    per = kw["batch"] // (world // model_parallel)
    lo = (rank // model_parallel) * per
    seen = []
    step = TrainStepBuilder.train_step

    def checked(builder, state, batch):
        want = data.global_batch_at(int(state["step"]))
        for k, v in batch.items():
            assert v.shape == want[k].shape, k
            np.testing.assert_array_equal(v.to_local().numpy(),
                                          want[k][lo:lo + per], err_msg=k)
            np.testing.assert_array_equal(v.full_tensor().numpy(), want[k],
                                          err_msg=k)
        seen.append(int(state["step"]))
        return step(builder, state, batch)

    killed = killed_after_first_save if kill else contextlib.nullcontext
    TrainStepBuilder.train_step = checked
    try:
        with gloo(rank, world, port), killed():
            res = train_mod.train(arch, model_parallel=model_parallel, **kw)
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(res, f)
    finally:
        TrainStepBuilder.train_step = step
    assert seen, "no step ran"


def _grads_plain_and_sharded(loss_of, tensors, placements, mesh):
    """Gradients of ``loss_of(*tensors)`` with respect to its float
    tensors, on plain tensors and on DTensors laid out by ``placements``
    (one list a tensor; integer tensors are laid out and take no
    gradient); returns both lists, the DTensor ones gathered whole."""
    from torch.distributed.tensor import distribute_tensor

    def run(ts):
        leaves = [t.requires_grad_(True) for t in ts if t.is_floating_point()]
        return torch.autograd.grad(loss_of(*ts), leaves)

    want = run([t.clone() for t in tensors])
    got = run([distribute_tensor(t, mesh, pl, src_data_rank=None)
               for t, pl in zip(tensors, placements)])
    return want, [t.full_tensor() for t in got]


def helpers_rank(rank, world, port):
    """The sharding helpers' gradients on a (2, 2) mesh with real data,
    each against the same function on plain tensors, float32, within 1e-5
    of the gradient's largest |value| (the ranks sum in another order):
    ``lookup``'s table, ``batch_local``'s shared tensor (summed over the
    ranks that split the rows), hymba's Mamba block (a ``batch_local``
    time loop whose inputs' gradient comes back transposed), and the
    expert-parallel moe dispatch's router, experts and tokens against the
    scatter dispatch at a capacity that drops no token."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe, ssm
    from repro_torch.models.registry import get_config
    from repro_torch.sharding import (axis_rules, batch_local, lookup,
                                      make_plan, param_partition_specs,
                                      placements_for)

    with gloo(rank, world, port):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(23)
        rows, whole = [Shard(0), Replicate()], [Replicate(), Replicate()]
        by_model = [Replicate(), Shard(0)]

        def randn(*shape):
            return torch.randn(*shape, generator=g)

        cases = {
            "lookup": (
                lambda table, v, ids: (lookup(table, ids) * v).sum(),
                [randn(12, 8), randn(4, 5, 8),
                 torch.randint(0, 12, (4, 5), generator=g)],
                [by_model, rows, rows]),
            "batch_local shared": (
                lambda x, a: batch_local(lambda x, a: x * a, (x,), (a,))
                .square().sum(), [randn(4, 6, 8), randn(8)], [rows, whole]),
        }
        # hymba's Mamba block: its time loop runs on each rank's rows,
        # time-major, so the gradient of its inputs comes back transposed.
        hcfg = get_config("hymba-1.5b", smoke=True, dtype="float32",
                          param_dtype="float32")
        block = ssm.Mamba(hcfg, device="cpu")
        block.reset_parameters(g)
        pnames = [n for n, _ in block.named_parameters()]
        specs = param_partition_specs(
            {f"blocks.0.ssm.{n}": p for n, p in block.named_parameters()},
            make_plan(fsdp=False), mesh)

        def mamba_loss(*t):
            params = SimpleNamespace(**dict(zip(pnames, t[:-1])))
            return ssm.mamba_forward(params, t[-1], hcfg).square().sum()

        cases["mamba"] = (
            mamba_loss, [p.detach().clone() for p in block.parameters()]
            + [randn(4, 6, hcfg.d_model)],
            [placements_for(specs[f"blocks.0.ssm.{n}"], mesh) for n in pnames]
            + [rows])
        cfg = get_config("qwen2-moe-a2.7b", smoke=True, capacity_factor=8.0)
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
        names = ("router", "experts_wi", "experts_wi_gate", "experts_wo")
        y_w = randn(16, d)

        def moe_loss(*t):
            p = SimpleNamespace(**dict(zip(names, t[:4])))
            dispatch = (moe._dispatch_shard_map if hasattr(t[4], "placements")
                        else moe._dispatch_scatter)
            y, probs = dispatch(p, t[4], cfg)
            return (y.float() * y_w).sum() + probs.square().sum()

        cases["shard_map"] = (
            moe_loss, [randn(d, e) * d ** -0.5, randn(e, d, ff) * d ** -0.5,
                       randn(e, d, ff) * d ** -0.5,
                       randn(e, ff, d) * ff ** -0.5, randn(16, d)],
            [whole, by_model, by_model, by_model, rows])
        with axis_rules(make_plan(fsdp=False).activation_rules, mesh), \
                implicit_replication():
            for name, (fn, tensors, pls) in cases.items():
                want, got = _grads_plain_and_sharded(fn, tensors, pls, mesh)
                for i, (gw, gg) in enumerate(zip(want, got)):
                    err = float((gg - gw).abs().max() / gw.abs().max())
                    assert err <= 1e-5, f"{name} gradient {i}: {err:.3e}"
