"""Carry fitted weights and workload tables across as plain arrays.

Both packages can then compute with the same coefficients and the same
phase tables: the arrays come from any source (the reference package's
fitted ``CategoryModel`` and ``PhaseTables`` in the parity tests, or a
file), and land as tensors on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.regression import CategoryModel
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
