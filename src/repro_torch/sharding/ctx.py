"""Logical-axis sharding context, the twin of ``repro.sharding.ctx``.

Models annotate activations with *logical* axis names ("batch", "embed",
"experts", ...).  The launcher installs a rule set mapping logical names
to mesh axes; with a ``DeviceMesh`` installed too, the annotation
redistributes a DTensor to that layout, otherwise it is a no-op — so the
same model code runs on one device and on the dry-run's 512-rank mesh.

A spec is a tuple with one entry per tensor dimension: ``None``, a mesh
axis name, or a tuple of names (entry for entry the reference's
``PartitionSpec``).  :func:`placements_for` turns it into DTensor
placements.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

_state = threading.local()


def current_rules() -> Dict[str, MeshAxes]:
    return getattr(_state, "rules", {})


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, MeshAxes], mesh=None):
    """Install logical->mesh axis rules (and optionally the mesh itself)."""
    old_rules = getattr(_state, "rules", None)
    old_mesh = getattr(_state, "mesh", None)
    _state.rules = dict(rules)
    _state.mesh = mesh
    try:
        yield
    finally:
        if old_rules is None:
            del _state.rules
        else:
            _state.rules = old_rules
        _state.mesh = old_mesh


def logical_to_mesh(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Dict[str, MeshAxes]] = None) -> Spec:
    """Translate per-dimension logical names into a spec."""
    rules = current_rules() if rules is None else rules
    spec = []
    used = set()
    for name in logical_axes:
        rule = rules.get(name) if name is not None else None
        if rule is None:
            spec.append(None)
            continue
        # A tuple rule stays a tuple even with one element.
        was_tuple = not isinstance(rule, str)
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        # A mesh axis may appear only once in a spec.
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            spec.append(None)
        elif was_tuple:
            spec.append(axes)
        else:
            spec.append(axes[0])
    return tuple(spec)


def placements_for(spec: Spec, mesh) -> list:
    """DTensor placements over ``mesh`` for ``spec``: ``Shard(d)`` on each
    mesh axis that dimension ``d``'s entry names, ``Replicate()`` on the
    others.  A dimension named by several axes is split over them in the
    entry's order, major first, as a ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry):
            dim_of[axis] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate()
            for a in mesh.mesh_dim_names]


def _reshape_dtensor(x, shape):
    from torch.distributed.tensor import Replicate, Shard

    try:
        return x.reshape(shape)
    except RuntimeError:    # DTensor refuses an uneven split or merge
        pass
    first = 0
    while (first < min(x.dim(), len(shape))
           and x.shape[first] == shape[first]):
        first += 1
    placements = [Replicate() if isinstance(p, Shard) and p.dim >= first
                  else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements).reshape(shape)


class _GatheringReshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.in_shape), None


def reshape(x, *shape):
    """``x.reshape(*shape)``.  A DTensor that cannot be reshaped as it is
    laid out (DTensor splits or merges only evenly sharded dimensions,
    where GSPMD pads: 24 heads over a 16-way axis) is first gathered on
    every mesh axis that shards a dimension from the first one the
    reshape changes onward, the twin of that padding's cost; its gradient
    is reshaped back the same way."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    if not hasattr(x, "placements"):
        return x.reshape(shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    return _GatheringReshape.apply(x, tuple(shape))


def local_part(t, placements, rows=None):
    """``t`` laid out as ``placements``, as this rank's local tensor; a
    plain tensor passes through.

    The local tensor's gradient is taken as laid out as ``t``, unless
    ``rows`` (the placements of the batch rows that ``t`` meets) is
    given: ``t`` is then shared by those rows, and on each mesh axis
    that splits the rows but not ``t`` a rank's gradient covers only its
    own rows, so the ranks' gradients are summed (``Partial``) as data
    parallelism sums them."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if not isinstance(t, DTensor):
        return t
    grad = None
    if rows is not None:
        grad = [Partial() if isinstance(r, Shard) and not isinstance(p, Shard)
                else p for p, r in zip(placements, rows)]
    return t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grad)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a DTensor takes its
    local tensor's layout as contiguous, so the gradient of a local tensor
    that a time-major loop transposed would break the views of later ops
    in the backward pass."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the installed "batch" rule names (present in ``mesh``)."""
    rule = current_rules().get("batch")
    axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def batch_local(fn, batched, shared=()):
    """``fn(*batched, *shared)`` run on each device's own batch rows.

    Over DTensors, every ``batched`` tensor (batch first) is laid out with
    its rows over the "batch" rule's mesh axes (replicated where the batch
    does not divide) and whole on every other axis, every ``shared`` one
    replicated, its gradient summed over the ranks that split the rows
    (:func:`local_part`); ``fn`` gets the local tensors, and its
    (batch-first) result, or each tensor of a tuple result, is laid out
    the same way.  A time loop then runs on plain local tensors, not as
    one redistribution per step.  Plain tensors go straight to ``fn``.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not any(isinstance(t, DTensor) for t in batched):
        return fn(*batched, *shared)
    mesh = next(t for t in batched if isinstance(t, DTensor)).device_mesh
    axes = batch_axes(mesh)
    rows = 1
    for a in axes:
        rows *= mesh.size(mesh.mesh_dim_names.index(a))
    split = batched[0].shape[0] % rows == 0
    row_pl = [Shard(0) if split and a in axes else Replicate()
              for a in mesh.mesh_dim_names]
    whole = [Replicate()] * mesh.ndim
    out = fn(*(_ContiguousGrad.apply(local_part(t, row_pl))
               for t in batched),
             *(_ContiguousGrad.apply(local_part(t, whole, row_pl))
               for t in shared))
    # A DTensor takes its local tensor's layout as contiguous: a local
    # transpose would break the views of later ops (and their backward).
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(t.contiguous(), mesh, row_pl,
                                        run_check=False) for t in out)
    return DTensor.from_local(out.contiguous(), mesh, row_pl,
                              run_check=False)


def local_heads(fn, headed, rows=(), shared=()):
    """``fn(*headed, *rows, *shared)`` run on each device's own batch rows
    and heads.

    Over DTensors, every ``headed`` tensor (batch dim 0, heads dim 2: q,
    k and v) is laid out with its rows over the "batch" rule's axes and
    its heads over the "heads" rule's axes (each whole where its count
    does not divide them; the heads only when every headed tensor's count
    divides, so that a device's query heads meet their own KV heads),
    every ``rows`` tensor (batch dim 0: a per-row mask) with its rows
    alone, every ``shared`` one replicated (its gradient summed over the
    ranks that split the rows); ``fn``'s result (batch dim 0,
    heads dim 2) is laid out as the headed tensors.  Attention then runs
    on plain local tensors, where DTensor could not merge a sharded batch
    with sharded heads.  Plain tensors go straight to ``fn``.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not any(isinstance(t, DTensor) for t in headed):
        return fn(*headed, *rows, *shared)
    mesh = next(t for t in headed if isinstance(t, DTensor)).device_mesh
    names = mesh.mesh_dim_names
    rule = current_rules().get("heads")
    head_axes = [a for a in ((rule,) if isinstance(rule, str) else rule or ())
                 if a in names]

    def prod(axes):
        return math.prod(mesh.size(names.index(a)) for a in axes)

    b_axes = batch_axes(mesh)
    split = headed[0].shape[0] % prod(b_axes) == 0
    by_heads = all(t.shape[2] % prod(head_axes) == 0 for t in headed)
    row_pl = [Shard(0) if split and a in b_axes else Replicate()
              for a in names]
    head_pl = [Shard(2) if by_heads and a in head_axes else p
               for a, p in zip(names, row_pl)]

    whole = [Replicate()] * mesh.ndim
    out = fn(*(local_part(t, head_pl) for t in headed),
             *(local_part(t, row_pl) for t in rows),
             *(local_part(t, whole, row_pl) for t in shared))
    return DTensor.from_local(out.contiguous(), mesh, head_pl,
                              run_check=False)


def lookup(table, ids):
    """``table[ids]``.  Over a DTensor table, the vocabulary-parallel
    lookup: each device gathers the table's columns, reads the rows of
    its own vocabulary slice for its own batch rows (0 for ids outside the
    slice), and an all-reduce over the vocabulary's axes sums the slices;
    the result's rows are laid out over the "batch" rule's axes, and the
    table's gradient is summed over the ranks that split them.  Plain
    ``ids`` are the whole batch, the same on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    b_axes = batch_axes(mesh)
    split = ids.shape[0] % math.prod(
        mesh.size(names.index(a)) for a in b_axes) == 0
    row_pl = [Shard(0) if split and a in b_axes else Replicate()
              for a in names]
    vocab_pl = [Shard(0) if p == Shard(0) else Replicate()
                for p in table.placements]
    (n, _), (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, vocab_pl)
    rows = local_part(table, vocab_pl, row_pl)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids = ids.redistribute(mesh, row_pl).to_local()
    local = ids - lo
    inside = (local >= 0) & (local < n)
    out = rows[local.clamp(0, n - 1)] * inside[..., None].to(rows.dtype)
    partial = [Partial() if v == Shard(0) else p
               for v, p in zip(vocab_pl, row_pl)]
    return DTensor.from_local(out, mesh, partial,
                              run_check=False).redistribute(mesh, row_pl)


def put_rows(cache, idx, values, keep=None):
    """``cache[b, idx[b]] = values[b]`` for every row ``b`` (where
    ``keep[b]``, if given), in place.

    cache: (B, S, ...); idx: (B,) integer; values: (B, ...).  Over a
    DTensor cache each device writes its own shard: the rows it holds, at
    the slots that fall in its part of S (a sequence-sharded cache), with
    ``values`` laid out as the cache's rows.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        if keep is not None:
            keep = keep.reshape((-1,) + (1,) * (values.dim() - 1))
            values = torch.where(keep, values, cache[rows, idx])
        cache[rows, idx] = values
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = cache.device_mesh
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    row_pl = [p if not isinstance(p, Shard) else
              Replicate() if p.dim == 1 else Shard(p.dim - (p.dim > 1))
              for p in cache.placements]
    vals = values.redistribute(mesh, row_pl).to_local()
    lo, n = offset[0], shape[0]
    slot = whole(idx)[lo:lo + n].long() - offset[1]
    ok = (slot >= 0) & (slot < shape[1])
    if keep is not None:
        ok = ok & whole(keep)[lo:lo + n]
    slot = slot.clamp(0, shape[1] - 1)
    local = cache.to_local()
    rows = torch.arange(n, device=local.device)
    ok = ok.reshape((-1,) + (1,) * (vals.dim() - 1))
    local[rows, slot] = torch.where(ok, vals.to(local.dtype),
                                    local[rows, slot])


def assign(dst, src) -> None:
    """``dst.copy_(src)``: ``src``'s values written into ``dst``'s own
    storage.  Over a DTensor ``dst`` each rank writes its own part, from
    ``src`` laid out as ``dst`` (a plain ``src`` is the whole tensor, the
    same on every rank), so that the tensor stays the one the caller holds
    (a cache's view included), in its layout."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    dst.to_local().copy_(src.redistribute(mesh, dst.placements).to_local())


class _Constrain(torch.autograd.Function):
    """``x`` laid out as ``placements``, and its gradient too."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if list(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def shard(x, *logical_axes: Optional[str]):
    """Constrain ``x``'s layout by logical axis names (no-op without rules).

    Example: ``x = shard(x, "batch", None, "embed")`` for a (B, S, D)
    tensor.  With a mesh installed, a DTensor is laid out by the spec and
    so is its gradient, the twin of ``with_sharding_constraint`` (whose
    transpose constrains the cotangent alike): DTensor then picks no
    layout of its own there in either pass.  Anything else passes
    through.  A dimension the named axes do not divide stays whole (GSPMD
    would pad it; DTensor cannot split it into heads later).
    """
    rules = current_rules()
    if not rules:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(
            f"rank mismatch: tensor has {x.ndim} dims, got "
            f"{len(logical_axes)} names"
        )
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = []
    for dim, entry in zip(x.shape, logical_to_mesh(logical_axes, rules)):
        prod = 1
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            prod *= sizes.get(a, 1)
        spec.append(entry if dim % prod == 0 else None)
    return _Constrain.apply(x, placements_for(tuple(spec), mesh))


def gather_weight(w):
    """``w`` whole over the mesh axes of the "param_embed" rule, FSDP's
    (ZeRO-3) shard axes: a weight is gathered before its product, and its
    gradient is reduce-scattered back by the redistribution's backward.
    Anything but a DTensor passes through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    rule = current_rules().get("param_embed")
    axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
    want = [Replicate() if a in axes else p
            for a, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)
