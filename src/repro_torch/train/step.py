"""Training step: loss, backward, optimizer update, microbatch
accumulation — the twin of ``repro.train.step``.

``TrainStepBuilder`` gives ``train_step(state, batch) -> (state,
metrics)``.  The state is the reference's tree: ``params`` (the model's
own parameters, by name), ``opt`` (``mu``, ``nu``, ``count``) and
``step``; ``repro_torch.convert.train_state_{to,from}_numpy`` carry it in
the reference's stacked layout.  A step writes the parameters and the
moments in place, as the reference's donated buffers, and reads nothing
back to the host.  Gradients come from autograd through the model's plain
attention, as the reference differentiates its ``"xla"`` attention: no
backward kernel exists, so training with ``attention_impl="kernel"`` is
refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call

from repro_torch import to_device
from repro_torch.models.transformer import Model, reference_ndim
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.sharding import shard, whole

F32 = torch.float32


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Token-mean cross entropy (+ tiny z-loss for logit drift control):
    ``(ce + z_loss * mean(lse^2), ce)``."""
    logits = shard(logits.float(), "batch", None, "vocab")
    lse = shard(_logsumexp(logits), "batch", None)
    ce = torch.mean(shard(lse[..., None] - _gold(logits,
                                                 labels.long()[..., None]),
                          "batch", None, None))
    zl = z_loss * torch.mean(torch.square(lse))
    return ce + zl, ce


def _logsumexp(logits):
    """``logsumexp`` over the vocabulary (see :class:`_LogSumExp`)."""
    return _LogSumExp.apply(logits)


class _LogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last dimension.  Over a DTensor sharded on
    it (the dry-run's, a sharded run's) written out, so that each device
    reduces its own shard and only the (B, S) maxima and sums travel: the
    ops and their order are ``torch.logsumexp``'s, and so is the backward
    pass, written here for both, so that a run over a one-rank mesh gives
    the one-device run's numbers bit for bit.  Keeps the logits and the
    result for the backward pass, as ``torch.logsumexp`` does."""

    @staticmethod
    def forward(ctx, logits):
        if getattr(logits, "placements", None) is None:
            lse = torch.logsumexp(logits, dim=-1)
        else:
            m = shard(logits.amax(-1, keepdim=True), "batch", None, None)
            total = shard(torch.exp(logits - m).sum(-1, keepdim=True),
                          "batch", None, None)
            lse = shard((torch.log(total) + m)[..., 0], "batch", None)
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * (logits - lse[..., None]).exp()


def _gold(logits, idx):
    """The labels' logits, (B, S, 1).

    Over a DTensor (the dry-run's), the vocabulary-parallel gather: each
    device reads, from its own logits, its rows' labels that fall in its
    vocabulary shard (0 for the others), and the shards' parts are summed;
    the backward pass scatters into each device's shard alone."""
    placements = getattr(logits, "placements", None)
    if placements is None:
        return torch.gather(logits, -1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh, vocab = logits.device_mesh, Shard(logits.dim() - 1)
    (*_, n), (*_, lo) = compute_local_shape_and_global_offset(
        logits.shape, mesh, placements)
    rows = [Replicate() if p == vocab else p for p in placements]
    ids = idx.redistribute(mesh, rows).to_local().reshape(-1) - lo
    inside = (ids >= 0) & (ids < n)
    # Indexing keeps no copy of the logits for the backward pass (a
    # gather keeps its input).
    flat = logits.to_local().reshape(-1, n)
    gold = flat[torch.arange(flat.shape[0], device=flat.device),
                ids.clamp(0, n - 1)] * inside
    gold = gold.reshape(logits.to_local().shape[:-1] + (1,))
    parts = [Partial() if p == vocab else p for p in placements]
    return shard(DTensor.from_local(gold, mesh, parts, run_check=False),
                 "batch", None, None)


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.asarray(v).dtype.kind == "f"


def _microbatches(batch: Dict, n: int):
    """``batch`` cut into ``n`` microbatches of contiguous rows: the i-th
    holds rows [i m, (i+1) m) of the global batch, as the reference's
    reshape to (n, B / n, ...) takes them.  A DTensor entry is gathered
    whole once, and each microbatch is laid out as the entry where its
    rows divide the entry's row axes, else replicated."""
    rows = {k: whole(v).reshape((n, v.shape[0] // n) + v.shape[1:])
            for k, v in batch.items()}
    for i in range(n):
        yield {k: _rows_like(r[i], batch[k]) for k, r in rows.items()}


def _rows_like(t, like):
    """``t``, some rows of the batch entry ``like``, laid out as ``like``
    (each rank keeping its own part) where they divide the mesh axes that
    split ``like``'s rows, else replicated; as it is for a plain
    ``like``."""
    if not hasattr(like, "placements"):
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh, placements = like.device_mesh, list(like.placements)
    split = math.prod(mesh.size(i) for i, p in enumerate(placements)
                      if getattr(p, "dim", None) == 0)
    if t.shape[0] % split:
        placements = [Replicate()] * mesh.ndim
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _grads(total, leaves):
    """d total / d leaf for every leaf; 0 for a leaf outside the graph (the
    QKV biases of a cross block, which cross-attention does not add), as
    the reference's gradient of an unused parameter.  A DTensor leaf's
    gradient comes in the leaf's layout."""
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else _like(g, p)
            for p, g in zip(leaves, grads)]


def _like(g, p):
    """A DTensor gradient in its parameter's layout (the dry-run's: data
    parallelism's reduce-scatter); any other passes through."""
    placements = getattr(p, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(p.device_mesh, placements)


def _fresh_state(model: Model, opt: AdamWConfig) -> Dict:
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params, "opt": adamw_init(params, opt),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


@dataclasses.dataclass
class TrainStepBuilder:
    model: Model
    opt: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    aux_weight: float = 0.01       # MoE load-balance loss weight
    warmup_steps: int = 100
    total_steps: int = 10_000

    def __post_init__(self):
        if self.model.cfg.attention_impl == "kernel":
            raise NotImplementedError(
                "training with attention_impl='kernel': the flash_attention "
                "kernel has no backward kernel (nor has the reference's); "
                "train with attention_impl='plain'")
        # Draws ``opt.compress_grads``' rounding noise.
        self._generator = (torch.Generator(device=self.model.device)
                           .manual_seed(17)
                           if self.opt.compress_grads else None)

    # ----------------------------------------------------------- state
    def fresh_state(self) -> Dict:
        """A state that trains the model's current weights in place:
        gradients on, moments 0, step 0."""
        return _fresh_state(self.model, self.opt)

    def init_state(self, generator: torch.Generator) -> Dict:
        """Draw the model's weights from ``generator`` (on its device) and
        start training them."""
        self.model.init_weights(generator)
        return self.fresh_state()

    def state_shapes(self) -> Dict:
        """The state's tensors on the ``meta`` device: shapes and dtypes,
        no allocation."""
        return _fresh_state(Model(self.model.cfg, torch.device("meta")),
                            self.opt)

    # ------------------------------------------------------------ loss
    def loss_fn(self, params: Dict[str, torch.Tensor], batch: Dict
                ) -> Tuple[torch.Tensor, Dict]:
        logits, aux = functional_call(self.model, params, (batch,))
        loss, ce = cross_entropy(logits, batch["labels"])
        total = loss + self.aux_weight * aux
        return total, {"loss": ce, "aux": aux}

    # ------------------------------------------------------------ step
    def train_step(self, state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        """One step on ``batch``: ``tokens`` and ``labels`` (B, S), cast to
        int32, and any float entry (``image_embeds``, ``audio_frames``) in
        the activation dtype."""
        params = state["params"]
        names = list(params)
        leaves = [params[n] for n in names]
        dev = leaves[0].device
        act = self.model.cfg.activation_dtype()
        batch = {k: to_device(v, act if _is_float(v) else torch.int32, dev)
                 for k, v in batch.items()}

        if self.grad_accum <= 1:
            total, metrics = self.loss_fn(params, batch)
            grads = _grads(total, leaves)
        else:
            # Contiguous microbatches, gradients summed in float32.
            n = self.grad_accum
            g_sum = [torch.zeros_like(p, dtype=F32) for p in leaves]
            loss_sum = torch.zeros((), dtype=F32, device=dev)
            for i, mb in enumerate(_microbatches(batch, n)):
                total, m = self.loss_fn(params, mb)
                for acc, g in zip(g_sum, _grads(total, leaves)):
                    acc += g
                loss_sum = loss_sum + m["loss"].detach()
            grads = [g / n for g in g_sum]
            metrics = {"loss": loss_sum / n,
                       "aux": torch.zeros((), dtype=F32, device=dev)}

        lr = linear_warmup_cosine(state["step"], self.warmup_steps,
                                  self.total_steps, self.opt.lr)
        decay = {n: reference_ndim(n, params[n]) >= 2 for n in names}
        params, opt_state = adamw_update(
            params, dict(zip(names, grads)), state["opt"], self.opt, lr=lr,
            decay=decay, generator=self._generator)
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        metrics = {"loss": metrics["loss"].detach(),
                   "aux": metrics["aux"].detach(), "lr": lr}
        return new_state, metrics
