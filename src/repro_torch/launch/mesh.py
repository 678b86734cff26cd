"""Meshes, the twin of ``repro.launch.mesh``.

The production mesh is the deployment target: 256 GPUs as (16, 16)
``("data", "model")``, or 512 as (2, 16, 16) ``("pod", "data",
"model")``.  The dry-run lays it over a *fake* process group
(``torch.testing``'s ``FakeStore`` and the ``"fake"`` backend): this
process is rank 0, every collective returns at once without moving data,
and tensors live on the ``meta`` device, so nothing is allocated and no
card is touched — the reference lowers over 512 placeholder host devices
the same way.  :func:`production_mesh` creates the group and always
destroys it.  Its device type is ``cpu`` on every host, so a cell's
record does not depend on whether the host's PyTorch has CUDA, and no
CUDA device is set or context opened (a ``cuda`` mesh may set one).
DTensor's cost model needs a device type with a device count, which
``meta`` has not; on a ``cpu`` mesh it trades each all-to-all for an
all-gather of the same operand and a local chunk, so an all-to-all is
counted as an all-gather of equal bytes, and its gathered buffer is live
for a moment.

:func:`make_host_mesh` lays a (data, model) mesh over the ranks of a real
process group (NCCL on GPUs, gloo on the CPU): one the caller has
initialised, or one :func:`host_group` joins from the environment that
``torch.distributed.run`` sets.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

#: The production meshes: shape and axis names.
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION[multi_pod][0]))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the duration of the block; destroyed on the way out whatever
    happens.  Refuses to stack on a group that is already there."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(multi_pod: bool = False, shape=None):
    """The production ``DeviceMesh`` over the process group in place, which
    must have exactly its 256 (512) ranks: see :func:`production_mesh`.
    ``shape`` replaces the axes' sizes (a small test mesh keeps the
    names)."""
    sizes, axes = PRODUCTION[multi_pod]
    shape = tuple(shape or sizes)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"process group of {n} ranks: use "
                           "production_mesh()")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_mesh(multi_pod: bool = False, shape=None):
    """The production mesh (its axes resized to ``shape`` if given) over a
    fake process group made for the block."""
    with fake_group(math.prod(shape or PRODUCTION[multi_pod][0])):
        yield make_production_mesh(multi_pod, shape)


def make_host_mesh(model_parallel: int = 1):
    """A (data, model) mesh over the ranks of the process group the caller
    has initialised: (n // model_parallel, model_parallel)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


#: The backend of each device type's process group.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@contextlib.contextmanager
def host_group(device):
    """The process group a run on ``device`` lays its mesh over, for the
    block: yields this rank's device, or None when there is no group.

    The group is the one the caller has initialised, if any (left as it
    is on the way out); else, when ``torch.distributed.run``'s
    environment is set (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), one joined from it and destroyed on the way out.
    The backend is NCCL for ``cuda`` and gloo for ``cpu``: a group of the
    other backend is refused, a failed init fails, and nothing falls back
    to another backend or device.  On ``cuda`` the rank's device is
    ``cuda:LOCAL_RANK`` (the rank modulo the host's devices when the
    variable is unset), made current.
    """
    device = torch.device(device)
    backend = BACKENDS[device.type]
    made = False
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            yield None
            return
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        made = True
    try:
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {device.type} run needs a {backend} "
                               f"process group, not {dist.get_backend()}")
        if device.type == "cuda":
            local = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        yield device
    finally:
        if made:
            dist.destroy_process_group()
