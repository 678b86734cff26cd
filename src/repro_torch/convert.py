"""Carry fitted weights, workload tables and model weights across as plain
arrays.

Both packages can then compute with the same coefficients, the same phase
tables, the same language-model weights and the same training state: the
arrays come from any source (the reference package's fitted
``CategoryModel``, ``PhaseTables``, ``Model.init`` tree and training state
in the parity tests, or a checkpoint), and land as tensors on the
requested device.  Model trees go both ways in the reference's layout,
the parameters of each block group stacked on a leading layer axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.regression import CategoryModel
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import STACKED, Model
from repro_torch.sharding import distribute_like, whole
from repro_torch.smt.scan_engine import DeviceTables


def category_model_from_numpy(coeffs, mse, n_categories: int,
                              device=None) -> CategoryModel:
    """(4, 4) coefficients + (4,) MSE arrays -> a :class:`CategoryModel`."""
    device = resolve_device(device)
    return CategoryModel(
        coeffs=torch.tensor(np.asarray(coeffs), dtype=torch.float32,
                            device=device),
        mse=torch.tensor(np.asarray(mse), dtype=torch.float32, device=device),
        n_categories=int(n_categories),
    )


def device_tables_from_numpy(phase_tables, device=None) -> DeviceTables:
    """An object with ``PhaseTables``' numpy attributes -> :class:`DeviceTables`."""
    return DeviceTables.build(phase_tables, resolve_device(device))


#: The reference's ``attention_impl`` values and their twins here.
ATTENTION_IMPL = {"xla": "plain", "pallas": "kernel",
                  "pallas_interpret": "kernel"}


def model_config_from(cfg) -> ModelConfig:
    """Any object with :class:`ModelConfig`'s fields (the reference's own
    config, for one) -> a :class:`ModelConfig`, its ``attention_impl``
    mapped to the port's name."""
    if isinstance(cfg, ModelConfig):
        return cfg
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
          if hasattr(cfg, f.name)}
    impl = kw.get("attention_impl", "plain")
    kw["attention_impl"] = ATTENTION_IMPL.get(impl, impl)
    return ModelConfig(**kw)


def _tensor(arr) -> torch.Tensor:
    """An array as a CPU tensor.  bfloat16 arrives as the reference's numpy
    bfloat16 or as the 2-byte void its checkpoints hold (the raw bits)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(arr)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bfloat16 as the 2-byte void (its raw bits)
    that the reference's checkpoints hold.  A DTensor is gathered whole
    first, a collective: every rank of its mesh makes it, in one order."""
    t = whole(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _paths(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _paths(val, prefix + (key,))
        else:
            yield prefix + (key,)


def _unstacked(tree, model: Model) -> Dict[str, torch.Tensor]:
    """A reference-layout tree -> one CPU tensor per parameter of ``model``,
    by its name.  The leaves of each stacked group (``blocks``,
    ``cross_blocks``, ``dec_cross``, ``encoder``: :data:`STACKED`) carry a
    leading layer axis (``tree["blocks"]["attn"]["wq"]`` is (L, d, H, hd),
    ``tree["cross_blocks"]["gate"]`` (L,)); layer ``i`` of each goes to
    ``<group>.<i>``.  Every parameter must be found with its shape, and
    every array used."""
    out, used = {}, set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] in STACKED
        path = (parts[0],) + tuple(parts[2:]) if stacked else tuple(parts)
        arr = tree
        for key in path:
            arr = arr[key]
        arr = np.asarray(arr)
        t = _tensor(arr[int(parts[1])] if stacked else arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: array {tuple(t.shape)}, parameter "
                             f"{tuple(p.shape)}")
        out[name] = t
        used.add(path)
    unused = sorted(set(_paths(tree)) - used)
    if unused:
        raise ValueError(f"arrays with no parameter here: {unused}")
    return out


def _stacked(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`_unstacked`: tensors by parameter name -> the
    reference's tree of host arrays, each stacked group on a layer axis."""
    tree: Dict = {}
    layers: Dict = {}
    for name, t in tensors.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            key = (parts[0],) + tuple(parts[2:])
            layers.setdefault(key, {})[int(parts[1])] = _numpy(t)
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = _numpy(t)
    for path, by_layer in layers.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return tree


def model_params_from_numpy(params, cfg, device=None) -> Model:
    """The reference's ``Model.init`` tree, as numpy arrays -> a
    :class:`Model` on ``device`` holding those weights.

    The port keeps the reference's einsum layouts (``wq`` (d, H, hd),
    ``wo`` (H, hd, d), an MLP's ``wi`` (d, d_ff), an expert stack's
    ``experts_wi`` (E, d, d_ff), the table (vocab, d)), so each layer of an
    array lands as it is (see :func:`_unstacked`).
    """
    device = resolve_device(device)
    model = Model(model_config_from(cfg), device)
    with torch.no_grad():
        for name, t in _unstacked(params, model).items():
            model.get_parameter(name).copy_(t)
    return model


def model_params_to_numpy(model: Model) -> Dict:
    """A model's weights as the reference's ``Model.init`` tree of host
    arrays, blocks stacked on a leading layer axis."""
    return _stacked(dict(model.named_parameters()))


def train_state_to_numpy(state: Dict) -> Dict:
    """A training state (``repro_torch.train.step``) as the reference's
    tree of host arrays: ``params``, ``opt`` (``mu``, ``nu``, ``count``)
    and ``step``, the parameters and moments stacked over layers.  Saved
    through a checkpoint manager, it holds the leaves of the reference's
    training checkpoint.  A sharded state's leaves are gathered whole,
    leaf by leaf in the state's order, so every rank calls this."""
    opt = state["opt"]
    return {"params": _stacked(state["params"]),
            "opt": {"mu": _stacked(opt["mu"]), "nu": _stacked(opt["nu"]),
                    "count": _numpy(opt["count"])},
            "step": _numpy(state["step"])}


def train_state_from_numpy(tree, model: Model) -> Dict:
    """The reference's training state tree (host arrays) -> a training
    state for ``model``: the weights are copied into the model, whose
    parameters become the state's ``params`` (with gradients on), and the
    moments land on its device in the dtype they were saved in.  Where
    the model's parameters are DTensors (a sharded run, every rank
    reading the same tree), each rank keeps its own part of each weight
    and moment, laid out as the parameter."""
    dev = model.device
    params = dict(model.named_parameters())

    def laid_out(name, t):
        return distribute_like(t.to(dev), params[name])

    with torch.no_grad():
        for name, t in _unstacked(tree["params"], model).items():
            params[name].copy_(laid_out(name, t))
    for p in params.values():
        p.requires_grad_(True)

    def moments(sub):
        return {n: laid_out(n, t) for n, t in _unstacked(sub, model).items()}

    def scalar(arr):
        return torch.tensor(np.asarray(arr), dtype=torch.int32, device=dev)

    opt = tree["opt"]
    return {"params": params,
            "opt": {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
                    "count": scalar(opt["count"])},
            "step": scalar(tree["step"])}
