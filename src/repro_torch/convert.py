"""Carry fitted weights, workload tables and model weights across as plain
arrays.

Both packages can then compute with the same coefficients, the same phase
tables and the same language-model weights: the arrays come from any source
(the reference package's fitted ``CategoryModel``, ``PhaseTables`` and
``Model.init`` tree in the parity tests, or a file), and land as tensors on
the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.regression import CategoryModel
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
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
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # numpy has no bfloat16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def model_params_from_numpy(params, cfg, device=None) -> Model:
    """The reference's ``Model.init`` tree, as numpy arrays -> a
    :class:`Model` on ``device`` holding those weights.

    The tree's blocks are stacked on a leading layer axis
    (``params["blocks"]["attn"]["wq"]`` is (L, d, H, hd)); layer ``i`` of
    each goes to ``model.blocks[i]``.  The port keeps the reference's
    einsum layouts (``wq`` (d, H, hd), ``wo`` (H, hd, d), an MLP's ``wi``
    (d, d_ff), the table (vocab, d)), so each array lands as it is.  Every
    parameter must be found with its shape, and every array used.
    """
    device = resolve_device(device)
    model = Model(model_config_from(cfg), device)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                path = ("blocks",) + tuple(parts[2:])
                arr = params
                for key in path:
                    arr = arr[key]
                arr = np.asarray(arr)[int(parts[1])]
            else:
                path = tuple(parts)
                arr = params
                for key in path:
                    arr = arr[key]
            t = _tensor(arr)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: array {tuple(t.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
            used.add(path)

    def leaves(tree, prefix=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from leaves(val, prefix + (key,))
            else:
                yield prefix + (key,)

    unused = sorted(set(leaves(params)) - used)
    if unused:
        raise ValueError(f"arrays with no parameter here: {unused}")
    return model
