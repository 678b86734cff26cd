"""Laying a model, its training state, its batches and its decode cache
out over a mesh.

One piece of code for every run that lays tensors out by a
:class:`~repro_torch.sharding.plan.ShardingPlan`: the dry-run over a fake
process group (``launch/dryrun.py``), and training (``launch/train.py``)
and serving (``launch/serve.py``, ``serve/engine.py``) over a real one.
Each rank holds the whole tensor and keeps its own part of it
(``src_data_rank=None``): nothing is sent, so every rank must hold the
same values (weights drawn from one seed, a checkpoint read by every
rank, the same requests).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import torch

from repro_torch.sharding.ctx import (axis_rules, current_rules,
                                      logical_to_mesh, placements_for)
from repro_torch.sharding.plan import (mesh_shape_of, param_partition_specs,
                                       sanitize_spec)


def distribute(t: torch.Tensor, spec, mesh):
    """``t`` (the whole tensor, the same on every rank) as a DTensor laid
    out by ``spec`` over ``mesh``, each rank keeping its own part."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements_for(spec, mesh),
                             src_data_rank=None)


def distribute_like(t: torch.Tensor, like):
    """``t`` (the whole tensor, the same on every rank) laid out as
    ``like`` if that is a DTensor, each rank keeping its own part; else
    ``t`` as it is."""
    if not hasattr(like, "placements"):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank, a collective that every
    rank of its mesh makes; any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` over a nested dict, ``specs`` of the same
    nesting."""
    return {k: (distribute_tree(v, specs[k], mesh) if isinstance(v, dict)
                else distribute(v, specs[k], mesh)) for k, v in tree.items()}


def distribute_model(model, plan, mesh) -> Dict[str, tuple]:
    """Replace every parameter of ``model`` by a DTensor laid out by the
    plan (gradients off, as a model's parameters start); returns the specs
    by parameter name."""
    specs = param_partition_specs(model.named_parameters(), plan, mesh)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), specs[name], mesh), requires_grad=False)
    return specs


def rows_spec(shape, rules, mesh, batch_shardable: bool = True) -> tuple:
    """The spec of a batch-first tensor of ``shape``: its rows over the
    "batch" rule's axes when they divide, the rest whole."""
    ba = "batch" if batch_shardable else None   # logical name, not mesh axes
    spec = logical_to_mesh([ba] + [None] * (len(shape) - 1), rules)
    return sanitize_spec(spec, tuple(shape), mesh_shape_of(mesh))


def batch_sharding(specs: Mapping[str, torch.Tensor], plan, mesh,
                   batch_shardable: bool = True) -> Dict[str, tuple]:
    """A spec for each batch entry (anything with the entry's global
    ``shape``): :func:`rows_spec` by the plan's rules."""
    return {name: rows_spec(leaf.shape, plan.activation_rules, mesh,
                            batch_shardable)
            for name, leaf in specs.items()}


def distribute_rows(t: torch.Tensor, mesh):
    """``t`` (batch first: the whole batch, the same on every rank) laid
    out by :func:`rows_spec` under the installed rules, each rank keeping
    its own rows; a DTensor as it is."""
    if hasattr(t, "placements"):
        return t
    return distribute(t, rows_spec(t.shape, current_rules(), mesh), mesh)


def cache_sharding(cache, rules, mesh, batch_shardable: bool = True) -> Dict:
    """Specs for a decode cache (the same nesting as the cache): ``k``,
    ``v`` (L, B, S, Hkv, hd), ``ssm`` (L, B, d_inner, N), ``rwkv/wkv`` (L,
    B, H, hd, hd), ``image_embeds`` and ``enc`` (B, T, d); anything else
    of rank 2 or more (L, B, ...); ``pos`` (B,) whole.  ``mesh`` is a
    ``DeviceMesh`` or an {axis: size} dict."""
    ba = "batch" if batch_shardable else None   # logical name, not mesh axes

    def spec_for(name, leaf):
        nd = leaf.dim()
        if name in ("k", "v"):
            dims = [None, ba, "kv_seq", "kv_heads", None]
        elif name == "ssm":
            dims = [None, ba, "mlp", None]
        elif name.endswith("wkv"):
            dims = [None, ba, None, None, None]
        elif name in ("image_embeds", "enc"):
            dims = [ba, None, None]
        elif nd >= 2:
            dims = [None, ba] + [None] * (nd - 2)
        else:
            dims = [None] * nd
        spec = logical_to_mesh(dims[:nd], rules)
        return sanitize_spec(spec, tuple(leaf.shape), mesh_shape_of(mesh))

    def walk(tree, prefix):
        return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else spec_for(prefix + k, v)) for k, v in tree.items()}

    return walk(cache, "")


def distribute_cache(cache, mesh, rules=None, batch_shardable: bool = True):
    """A decode cache (whole, the same on every rank) laid out over
    ``mesh`` by :func:`cache_sharding` (the installed rules unless
    ``rules`` is given), each rank keeping its own part."""
    return distribute_tree(cache, cache_sharding(
        cache, current_rules() if rules is None else rules, mesh,
        batch_shardable), mesh)


@contextlib.contextmanager
def step_layout(plan, mesh):
    """The context a step over ``mesh`` runs in: the plan's rules
    installed with the mesh, and plain tensors that meet DTensors taken as
    replicated.  Every such tensor must be the same on each rank (drawn
    from one seed, or computed from replicated values): nothing checks."""
    from torch.distributed.tensor.experimental import implicit_replication

    with axis_rules(plan.activation_rules, mesh), implicit_replication():
        yield
