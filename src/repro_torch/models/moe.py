"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch and
optional shared experts, the twin of ``repro.models.moe``.

Two dispatch strategies:

* ``scatter`` (default): tokens are placed into an (E, C, d) buffer with a
  scatter-add at their per-expert positions (the cumsum trick) and
  gathered back after the expert products.  No products beyond the
  useful expert compute.
* ``einsum``: one-hot dispatch and combine products over a (k*T, E, C)
  tensor, the naive baseline (about 5.4 GB in float32 at a 4 x 2048
  prefill of qwen2-moe-a2.7b: keep it to small inputs).

``shard_map`` is the reference's expert-parallel dispatch
(:func:`_dispatch_shard_map`) over the mesh that ``repro_torch.sharding``
installs (the dry-run's); without one it is the reference's own mesh-less
branch, which is ``scatter``.

The routing copies the reference's order exactly, because it decides
which (token, slot) pairs the capacity drops: the top k by a stable
descending sort (the lower expert first on ties, as ``jax.lax.top_k``),
slots flattened slot-major (``topi.T``), the load-balance loss's argmax
taking the first maximum.  Products accumulate in float32 and round once
(:func:`repro_torch.models.layers.dot`).

Kimi-K2's layer (``cfg.router_scoring == "sigmoid"``, :func:`_moe_sigmoid`)
routes and dispatches apart from all of the above, which stays the JAX
package's twin:

    s = sigmoid(h W_r)                     float32, over all
                                           ``router_experts``
    top = the k largest of s + b           b the float32 correction bias,
                                           used only to choose; a stable
                                           sort, the lower id first on ties
    w_i = routed_scaling_factor * s_i / sum_top s
    y = sum_{i in top, i held} w_i E_i(h) + S(h)

with no capacity and no dropped pair.  Only the ``n_experts`` held here
(ids ``expert_offset ...``) are computed: the (token, slot) pairs that
land on them are sorted by expert and run as grouped bfloat16 products
over the pairs (``torch._grouped_mm`` on the card, float32 sums; a loop
of :func:`~repro_torch.models.layers.dot` elsewhere), the weight applied
before the down projection, and added back per token; the router's
product runs in float32 on the normalised stream, as published.  Nothing
waits for the device: the buffers hold every pair that could land here
(``T * min(k, n_experts)`` rows), and the groups' ends stay on the
device.  Spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine``; ``GROUPED_EXPERTS`` counts the held experts' calls (one
a layer), and while tracing is on :func:`held_pairs` gets each call's
count of pairs that landed here, still on the device.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BF16, dot, param, truncated_normal_
from repro_torch.obs import trace as obs_trace

F32 = torch.float32
DISPATCHES = ("scatter", "einsum", "shard_map")

#: Calls of the held experts' grouped products in this process (one a
#: sigmoid-routed layer); :func:`_moe_sigmoid` adds one a call.
GROUPED_EXPERTS = 0
#: While tracing is on, each sigmoid-routed call's count of (token, slot)
#: pairs that landed on the held experts, a one-element device tensor.
_HELD_PAIRS = []


class MoE(nn.Module):
    """The reference's tree: ``router`` (d, E) float32, ``experts_wi`` and
    ``experts_wi_gate`` (E, d, d_ff), ``experts_wo`` (E, d_ff, d), and with
    shared experts ``shared_wi``, ``shared_wi_gate`` (d, S) and
    ``shared_wo`` (S, d), S = d_ff x n_shared_experts.  The sigmoid router
    scores ``router_experts`` (its width) and adds ``router_bias`` (that
    many, float32) to choose; E is the experts held here."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dff, e = cfg.d_model, cfg.resolved_moe_d_ff, cfg.n_experts
        wd = cfg.weight_dtype()
        self.router = param((d, cfg.resolved_router_experts), F32, device)
        self.router_bias = (param((cfg.resolved_router_experts,), F32, device)
                            if cfg.router_scoring == "sigmoid" else None)
        self.experts_wi = param((e, d, dff), wd, device)
        self.experts_wi_gate = param((e, d, dff), wd, device)
        self.experts_wo = param((e, dff, d), wd, device)
        if cfg.n_shared_experts > 0:
            sh = dff * cfg.n_shared_experts
            self.shared_wi = param((d, sh), wd, device)
            self.shared_wi_gate = param((d, sh), wd, device)
            self.shared_wo = param((sh, d), wd, device)
        else:
            self.shared_wi = self.shared_wi_gate = self.shared_wo = None

    def reset_parameters(self, generator) -> None:
        d, dff = self.experts_wi.shape[1:]
        truncated_normal_(self.router, d ** -0.5, generator)
        if self.router_bias is not None:
            with torch.no_grad():
                self.router_bias.zero_()
        truncated_normal_(self.experts_wi, d ** -0.5, generator)
        truncated_normal_(self.experts_wi_gate, d ** -0.5, generator)
        truncated_normal_(self.experts_wo, dff ** -0.5, generator)
        if self.shared_wi is not None:
            truncated_normal_(self.shared_wi, d ** -0.5, generator)
            truncated_normal_(self.shared_wi_gate, d ** -0.5, generator)
            truncated_normal_(self.shared_wo, self.shared_wo.shape[0] ** -0.5,
                              generator)


def _router(params: MoE, x, cfg: ModelConfig):
    """x: (T, d) -> top-k (weights (T, k) float32, ids (T, k), probs (T, E))."""
    probs = torch.softmax(dot(x, params.router), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_per_token
    topw, topi = vals[:, :k], ids[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi, probs


def _capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of ``t`` tokens (decode steps and
    microbatches get their own)."""
    c = int(t * cfg.n_experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(c, 4)


def _one_hot(ids, n: int):
    """(N,) integer -> (N, n) bool, without ``F.one_hot``'s range check
    (a host sync on a GPU)."""
    return ids[:, None] == torch.arange(n, device=ids.device)


def _slots(topi, cfg: ModelConfig, c: int):
    """Each (token, slot) pair's expert and position in that expert's
    buffer, flattened slot-major (all first choices, then all second
    ones, ...): (flat_ids, pos, keep) of shape (k*T,); ``keep`` is False
    where the pair falls past the capacity ``c`` and is dropped."""
    flat_ids = topi.T.reshape(-1)
    # The one-hot laid out (E, k*T), so that the cumsum runs along the
    # inner dimension (a GPU scans an outer one with a thread a column).
    experts = torch.arange(cfg.n_experts, device=flat_ids.device)
    onehot = (flat_ids[None, :] == experts[:, None]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1) - 1
    pos = pos_in_e.gather(0, flat_ids[None, :])[0]
    return flat_ids, pos, pos < c


def _expert_ffn(params: MoE, xs, cfg: ModelConfig):
    """xs: (E, C, d) -> (E, C, d), every expert's SwiGLU as batched
    products."""
    xf = xs.float()
    h = torch.bmm(xf, params.experts_wi.float())
    g = torch.bmm(xf, params.experts_wi_gate.float())
    h = (F.silu(g) * h).to(xs.dtype)
    return torch.bmm(h.float(), params.experts_wo.float()).to(xs.dtype)


def _dispatch_scatter(params: MoE, x, cfg: ModelConfig):
    """Scatter/gather dispatch: no products beyond the experts'."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    c = _capacity(t, cfg)
    topw, topi, probs = _router(params, x, cfg)
    flat_ids, pos, keep = _slots(topi, cfg, c)
    slot_w = topw.T.reshape(-1)
    # A dropped pair adds 0 at its expert's last slot, so every slot's sum
    # is exact in any order of the adds.
    safe_pos = torch.where(keep, pos, c - 1)
    contrib = torch.where(keep[:, None], x.repeat(k, 1), 0)
    buf = x.new_zeros((e, c, d)).index_put((flat_ids, safe_pos), contrib,
                                           accumulate=True)
    out_buf = _expert_ffn(params, buf, cfg)
    gathered = torch.where(keep[:, None], out_buf[flat_ids, safe_pos], 0)
    y = (gathered.float() * slot_w[:, None]).reshape(k, t, d).sum(0)
    return y.to(x.dtype), probs


def _shard_map_local(router_w, wi, wi_gate, wo, xt, rank: int,
                     cfg: ModelConfig):
    """One model-axis rank's part of the expert-parallel dispatch, the body
    of the reference's ``shard_map``: the routing recomputed over the
    rank's tokens ``xt`` (T, d), then a local scatter, the batched FFN and
    a gather over its ``E_local = wi.shape[0]`` experts, those numbered
    ``rank * E_local ...`` (inert padding past ``n_experts``).  Returns
    (this rank's partial y (T, d), probs (T, E)); the ranks' partial y sum
    to the layer's output."""
    t, d = xt.shape
    e_local, k = wi.shape[0], cfg.n_experts_per_token
    topw, topi, probs = _router(SimpleNamespace(router=router_w), xt, cfg)
    c = _capacity(t, cfg)
    flat_ids = topi.T.reshape(-1)
    local_ids = flat_ids - rank * e_local
    mine = (local_ids >= 0) & (local_ids < e_local)
    bucket = torch.where(mine, local_ids, e_local)
    slots = torch.arange(e_local + 1, device=xt.device)
    onehot = (bucket[None, :] == slots[:, None]).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(0, bucket[None, :])[0]
    keep = mine & (pos < c)
    safe_ids = torch.where(mine, local_ids, 0)
    safe_pos = torch.where(keep, pos, c - 1)
    contrib = torch.where(keep[:, None], xt.repeat(k, 1), 0)
    buf = xt.new_zeros((e_local, c, d)).index_put((safe_ids, safe_pos),
                                                  contrib, accumulate=True)
    experts = SimpleNamespace(experts_wi=wi, experts_wi_gate=wi_gate,
                              experts_wo=wo)
    out_buf = _expert_ffn(experts, buf, cfg)
    gathered = torch.where(keep[:, None], out_buf[safe_ids, safe_pos], 0)
    slot_w = topw.T.reshape(-1)
    y = (gathered.float() * slot_w[:, None]).reshape(k, t, d).sum(0)
    return y.to(xt.dtype), probs


def _dispatch_shard_map(params: MoE, x, cfg: ModelConfig):
    """Expert-parallel dispatch over the installed mesh (the reference's
    production path).

    Tokens are sharded over the data axes and replicated over the model
    axis; every model rank recomputes the (cheap) routing and runs only
    its own experts (:func:`_shard_map_local`), then an all-reduce over
    the model axis merges the partial outputs.  An expert count the axis
    does not divide (60 on 16) is padded with inert experts that no token
    reaches.  Without a mesh, or on plain tensors, this is ``scatter``.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.sharding import (batch_axes, current_mesh, current_rules,
                                      local_part)

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return _dispatch_scatter(params, x, cfg)
    names = mesh.mesh_dim_names
    model_axis = current_rules().get("experts") or "model"
    n_model = mesh.size(names.index(model_axis))
    rank = mesh.get_local_rank(model_axis)
    e = cfg.n_experts
    e_local = -(-e // n_model)
    data = batch_axes(mesh)
    rows = 1
    for a in data:
        rows *= mesh.size(names.index(a))
    tok_pl = [Shard(0) if a in data and x.shape[0] % rows == 0
              else Replicate() for a in names]
    whole = [Replicate()] * mesh.ndim
    # What a rank computes for its own experts alone (the routing to
    # them, their products) has a gradient that covers those experts
    # alone: the model ranks' gradients are summed, as the data ranks'
    # are for their own tokens.
    by_expert = [Shard(0) if a == model_axis else p
                 for a, p in zip(names, tok_pl)]

    def experts(w):
        """The rank's experts, whole on every other axis, padded."""
        even = e % n_model == 0
        pl = [Shard(0) if a == model_axis and even else Replicate()
              for a in names]
        local = local_part(w, pl, by_expert)
        if even:
            return local
        local = local[rank * e_local:(rank + 1) * e_local]
        pad = e_local - local.shape[0]
        return F.pad(local, (0, 0, 0, 0, 0, pad)) if pad else local

    y, _ = _shard_map_local(
        local_part(params.router, whole, by_expert),
        experts(params.experts_wi), experts(params.experts_wi_gate),
        experts(params.experts_wo), local_part(x, tok_pl, by_expert),
        rank, cfg)
    # The router's probabilities (the load-balance loss's) are the same on
    # every model rank: computed apart, their gradient is not summed over
    # the model axis.
    router = SimpleNamespace(router=local_part(params.router, whole, tok_pl))
    _, _, probs = _router(router, local_part(x, tok_pl), cfg)
    partial = [Partial() if a == model_axis else p
               for a, p in zip(names, tok_pl)]
    y = DTensor.from_local(y, mesh, partial, run_check=False)
    return (y.redistribute(mesh, tok_pl),
            DTensor.from_local(probs, mesh, tok_pl, run_check=False))


def _dispatch_whole(dispatch, params: MoE, x, cfg: ModelConfig):
    """``dispatch(params, x, cfg)``; over DTensors run on the whole tokens
    and experts on every rank, so that each expert's capacity and the
    tokens it drops are those of the whole call, as on one device (the
    expert-parallel ``shard_map`` dispatch counts them a rank at a time).
    Every rank computes the same: the gradients are laid out whole."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding import local_part

    if not isinstance(x, DTensor):
        return dispatch(params, x, cfg)
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    own = SimpleNamespace(**{n: local_part(getattr(params, n), whole) for n in
                             ("router", "experts_wi", "experts_wi_gate",
                              "experts_wo")})
    y, probs = dispatch(own, local_part(x, whole), cfg)
    return (DTensor.from_local(y, mesh, whole, run_check=False),
            DTensor.from_local(probs, mesh, whole, run_check=False))


def _dispatch_einsum(params: MoE, x, cfg: ModelConfig):
    """One-hot einsum dispatch (the baseline with extra products)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    c = _capacity(t, cfg)
    topw, topi, probs = _router(params, x, cfg)
    flat_ids, pos, keep = _slots(topi, cfg, c)
    slot_w = topw.T.reshape(-1)
    disp = (_one_hot(flat_ids, e).to(F32)[:, :, None]
            * _one_hot(torch.where(keep, pos, c - 1), c).to(F32)[:, None, :])
    disp = disp * keep[:, None, None]
    src = x.repeat(k, 1).float()
    buf = torch.einsum("sec,sd->ecd", disp, src).to(x.dtype)
    out_buf = _expert_ffn(params, buf, cfg).float()
    comb = torch.einsum("sec,ecd->sd", disp, out_buf) * slot_w[:, None]
    y = comb.reshape(k, t, d).sum(0)
    return y.to(x.dtype), probs


def _route_sigmoid(params: MoE, x, cfg: ModelConfig):
    """x (T, d) -> (weights (T, k) float32, ids (T, k)) over all the
    router's experts."""
    scores = torch.sigmoid(dot(x, params.router))
    _, ids = torch.sort(scores + params.router_bias, dim=-1, descending=True,
                        stable=True)
    ids = ids[:, :cfg.n_experts_per_token]
    w = scores.gather(1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return w, ids


def _grouped(x, w, ends):
    """Rows of ``x`` (N, k) in groups, group ``g`` the rows up to
    ``ends[g]`` (int32, on ``x``'s device) from the previous end, each
    times ``w[g]`` (G, k, n) -> (N, n) in x's dtype; rows past the last end
    are left undefined.  Two bfloat16 CUDA operands run as one grouped
    tensor-core product with float32 sums; anything else a loop of
    :func:`dot` over the groups (reading ``ends`` on the host)."""
    if x.device.type == "cuda" and x.dtype == BF16 and w.dtype == BF16:
        return torch._grouped_mm(x, w, offs=ends)
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(ends.tolist()):
        out[start:end] = dot(x[start:end], w[g]).to(x.dtype)
        start = end
    return out


def _dispatch_dropless(params: MoE, x, cfg: ModelConfig):
    """The held experts' part of the sigmoid-routed layer, x (T, d) ->
    float32 (T, d); see the module's docstring."""
    global GROUPED_EXPERTS
    t, d = x.shape
    k, e = cfg.n_experts_per_token, cfg.n_experts
    with obs_trace.span("moe.route"):
        w, ids = _route_sigmoid(params, x, cfg)
    with obs_trace.span("moe.dispatch"):
        local = ids.reshape(-1) - cfg.expert_offset
        key = torch.where((local >= 0) & (local < e), local, e)
        # Pairs on the held experts first, by expert, then in token order;
        # a token reaches an expert once, so at most T * min(k, E) pairs.
        rows = t * min(k, e)
        order = torch.sort(key, stable=True).indices[:rows]
        counts = (key[:, None] == torch.arange(e, device=x.device)).sum(0)
        ends = torch.cumsum(counts, 0).to(torch.int32)
        if obs_trace.enabled():
            _HELD_PAIRS.append(ends[-1:])
        token = order // k
        xs = x.index_select(0, token)
        pair_w = w.reshape(-1)[order]
        held = torch.arange(rows, device=x.device) < ends[-1]
    with obs_trace.span("moe.experts"):
        GROUPED_EXPERTS += 1
        h = _grouped(xs, params.experts_wi, ends)
        g = _grouped(xs, params.experts_wi_gate, ends)
        a = (F.silu(g.float()) * h.float() * pair_w[:, None]).to(x.dtype)
        out = _grouped(a, params.experts_wo, ends)
    with obs_trace.span("moe.combine"):
        y = torch.zeros((t, d), dtype=F32, device=x.device)
        # T rows at a time: the float32 copy of all the rows would be 4
        # bytes a row-element more.
        for a0 in range(0, rows, t):
            part = out[a0:a0 + t]
            y.index_add_(0, token[a0:a0 + t], torch.where(
                held[a0:a0 + t, None], part.float(), 0.0))
    return y


def held_pairs():
    """Each sigmoid-routed call's count of pairs on the held experts since
    the last read, while tracing was on (a host read: call it after the
    traced stretch); clears them."""
    counts = torch.cat(_HELD_PAIRS).tolist() if _HELD_PAIRS else []
    _HELD_PAIRS.clear()
    return counts


def _moe_sigmoid(params: MoE, x, cfg: ModelConfig):
    """x (B, S, d) -> (y, 0): the held experts' part plus the shared
    experts, one rounding to x's dtype."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    y = _dispatch_dropless(params, xt, cfg)
    if params.shared_wi is not None:
        hs = (F.silu(dot(xt, params.shared_wi_gate))
              * dot(xt, params.shared_wi)).to(xt.dtype)
        y = y + dot(hs, params.shared_wo)
    return (y.to(x.dtype).reshape(b, s, d),
            torch.zeros((), dtype=F32, device=x.device))


def moe_layer(params: MoE, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Routed experts + optional shared."""
    if cfg.router_scoring == "sigmoid":
        return _moe_sigmoid(params, x, cfg)
    if cfg.moe_dispatch not in DISPATCHES:
        raise ValueError(f"moe_dispatch {cfg.moe_dispatch!r} not in "
                         f"{DISPATCHES}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if cfg.moe_dispatch == "shard_map":
        y, probs = _dispatch_shard_map(params, xt, cfg)
    else:
        y, probs = _dispatch_whole(
            _dispatch_einsum if cfg.moe_dispatch == "einsum"
            else _dispatch_scatter, params, xt, cfg)
    if params.shared_wi is not None:
        h = dot(xt, params.shared_wi)
        g = dot(xt, params.shared_wi_gate)
        hs = (F.silu(g) * h).to(x.dtype)
        y = y + dot(hs, params.shared_wo).to(x.dtype)
    # Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e.
    me = probs.mean(dim=0)
    density = _one_hot(torch.argmax(probs, dim=-1), cfg.n_experts).to(F32)
    aux = cfg.n_experts * torch.sum(me * density.mean(dim=0))
    return y.reshape(b, s, d), aux
