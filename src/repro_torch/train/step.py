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
from typing import Dict, Tuple

import numpy as np
import torch
from torch.func import functional_call

from repro_torch import to_device
from repro_torch.models.transformer import Model, reference_ndim
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine

F32 = torch.float32


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Token-mean cross entropy (+ tiny z-loss for logit drift control):
    ``(ce + z_loss * mean(lse^2), ce)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - gold)
    zl = z_loss * torch.mean(torch.square(lse))
    return ce + zl, ce


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.asarray(v).dtype.kind == "f"


def _grads(total, leaves):
    """d total / d leaf for every leaf; 0 for a leaf outside the graph (the
    QKV biases of a cross block, which cross-attention does not add), as
    the reference's gradient of an unused parameter."""
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


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
            g_sum = [torch.zeros(p.shape, dtype=F32, device=dev)
                     for p in leaves]
            loss_sum = torch.zeros((), dtype=F32, device=dev)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
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
