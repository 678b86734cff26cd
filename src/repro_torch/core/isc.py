"""ISC (Instructions and Stall Cycles) stacks — the paper's Section 3/4.

The ISC stack characterises where an application's execution cycles go, built
at the *dispatch* stage of a ``width``-wide SMT core from only four PMU events
(paper Table 1): CPU_CYCLES, STALL_FRONTEND, STALL_BACKEND and INST_SPEC.

Raw categories (fractions of CPU_CYCLES):

    DI  = INST_SPEC / (width * CPU_CYCLES)   "full dispatch equivalent cycles"
    FE  = STALL_FRONTEND / CPU_CYCLES
    BE  = STALL_BACKEND  / CPU_CYCLES

A real PMU never makes these sum to exactly 1.0: the gap of an LT100 stack
is horizontal waste, the excess of a GT100 stack is double-counted overlap.
The paper's repairs (Sections 4.2/4.3):

    LT100:  ISC3_A-BE   assign the gap to Backend            (SYNPA3 classic)
            ISC4        new 4th category "Horizontal waste"  (SYNPA4)
    GT100:  ISC3_N      proportional normalisation of all categories
            ISC3_R-FE   subtract the whole excess from Frontend
            ISC3_R-FEBE subtract the excess from FE and BE, weighted by size

Stacks are ``(..., 4)`` float tensors in the fixed category order
``(DI, FE, BE, HW)``; three-category methods leave ``HW == 0``.  Every
function is elementwise on tensors and keeps its inputs' device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

# Fixed category order used across the whole framework.
CAT_DI = 0
CAT_FE = 1
CAT_BE = 2
CAT_HW = 3
N_CATS = 4
CATEGORY_NAMES: Tuple[str, ...] = ("dispatch", "frontend", "backend", "horiz_waste")

DISPATCH_WIDTH = 4  # ThunderX2 (Vulcan) is 4-wide at dispatch.

_EPS = 1e-9


class LT100Method(enum.Enum):
    """Repairs for stacks capturing < 100% of cycles (paper §4.2)."""

    ISC3_A_BE = "isc3_a_be"  # assign not-accounted cycles to Backend
    ISC4 = "isc4"            # expose them as the Horizontal-waste category


class GT100Method(enum.Enum):
    """Repairs for stacks exceeding 100% of cycles (paper §4.3)."""

    ISC3_N = "isc3_n"            # normalise all categories proportionally
    ISC3_R_FE = "isc3_r_fe"      # subtract all the excess from Frontend
    ISC3_R_FEBE = "isc3_r_febe"  # weighted removal from Frontend and Backend


@dataclasses.dataclass(frozen=True)
class StackMethod:
    """A (LT100, GT100) repair pair = one member of the ISCX_Y family."""

    lt100: LT100Method
    gt100: GT100Method

    @property
    def n_categories(self) -> int:
        return 4 if self.lt100 is LT100Method.ISC4 else 3

    @property
    def name(self) -> str:
        lt = {LT100Method.ISC3_A_BE: "3", LT100Method.ISC4: "4"}[self.lt100]
        gt = {
            GT100Method.ISC3_N: "N",
            GT100Method.ISC3_R_FE: "R-FE",
            GT100Method.ISC3_R_FEBE: "R-FEBE",
        }[self.gt100]
        return f"ISC{lt}_{gt}"


# The four SYNPA variants' stack methods (paper Table 2).
SYNPA3_N = StackMethod(LT100Method.ISC3_A_BE, GT100Method.ISC3_N)
SYNPA4_N = StackMethod(LT100Method.ISC4, GT100Method.ISC3_N)
SYNPA4_R_FE = StackMethod(LT100Method.ISC4, GT100Method.ISC3_R_FE)
SYNPA4_R_FEBE = StackMethod(LT100Method.ISC4, GT100Method.ISC3_R_FEBE)

STACK_METHODS = {
    "SYNPA3_N": SYNPA3_N,
    "SYNPA4_N": SYNPA4_N,
    "SYNPA4_R-FE": SYNPA4_R_FE,
    "SYNPA4_R-FEBE": SYNPA4_R_FEBE,
}


def raw_stack(
    cpu_cycles,
    stall_frontend,
    stall_backend,
    inst_spec,
    width: int = DISPATCH_WIDTH,
    dtype: torch.dtype = torch.float32,
):
    """Raw (unrepaired) ISC stack from PMU counters.

    Returns an ``(..., 4)`` tensor ``(DI, FE, BE, 0)``; the sum of the first
    three columns is the measured stack height (may be <1 or >1).  Tensor
    inputs keep their device; arrays land on the CPU.
    """
    cycles = torch.clamp(torch.as_tensor(cpu_cycles, dtype=dtype), min=_EPS)
    di = torch.as_tensor(inst_spec, dtype=dtype) / (width * cycles)
    fe = torch.as_tensor(stall_frontend, dtype=dtype) / cycles
    be = torch.as_tensor(stall_backend, dtype=dtype) / cycles
    hw = torch.zeros_like(di)
    return torch.stack([di, fe, be, hw], dim=-1)


def stack_height(stack):
    """Measured height of a raw stack (sum of DI, FE, BE; HW excluded)."""
    return stack[..., CAT_DI] + stack[..., CAT_FE] + stack[..., CAT_BE]


def _repair_lt100(stack, method: LT100Method):
    """Expand a <100% stack to exactly 1.0 (paper §4.2). Gap must be >= 0."""
    gap = torch.clamp(1.0 - stack_height(stack), min=0.0)
    di, fe, be = stack[..., CAT_DI], stack[..., CAT_FE], stack[..., CAT_BE]
    if method is LT100Method.ISC3_A_BE:
        return torch.stack([di, fe, be + gap, torch.zeros_like(di)], dim=-1)
    if method is LT100Method.ISC4:
        return torch.stack([di, fe, be, gap], dim=-1)
    raise ValueError(f"unknown LT100 method {method}")


def _repair_gt100(stack, method: GT100Method):
    """Shrink a >100% stack to exactly 1.0 (paper §4.3). Excess must be >= 0.

    GT100 stacks always have three categories (horizontal waste is only
    visible when the measured height is below 100%).
    """
    di, fe, be = stack[..., CAT_DI], stack[..., CAT_FE], stack[..., CAT_BE]
    height = di + fe + be
    excess = torch.clamp(height - 1.0, min=0.0)
    hw = torch.zeros_like(di)
    if method is GT100Method.ISC3_N:
        scale = 1.0 / torch.clamp(height, min=_EPS)
        return torch.stack([di * scale, fe * scale, be * scale, hw], dim=-1)
    if method is GT100Method.ISC3_R_FE:
        # All the excess comes off Frontend; a remainder spills to Backend,
        # then Dispatch, so the stack still sums to 1.
        take_fe = torch.minimum(fe, excess)
        rest = excess - take_fe
        take_be = torch.minimum(be, rest)
        rest2 = rest - take_be
        return torch.stack([di - rest2, fe - take_fe, be - take_be, hw], dim=-1)
    if method is GT100Method.ISC3_R_FEBE:
        # Each stall category absorbs a share of the excess proportional to
        # its size (the paper's recommended design choice).
        denom = torch.clamp(fe + be, min=_EPS)
        take_fe = excess * fe / denom
        take_be = excess * be / denom
        return torch.stack([di, fe - take_fe, be - take_be, hw], dim=-1)
    raise ValueError(f"unknown GT100 method {method}")


def build_stack(raw, method: StackMethod):
    """Repair a raw ISC stack into a 100%-height stack with ``method``.

    LT100 rows use ``method.lt100``; GT100 rows use ``method.gt100``.  The
    result sums to 1 along the last axis (up to float error) and is
    non-negative.
    """
    raw = torch.as_tensor(raw)
    lt = _repair_lt100(raw, method.lt100)
    gt = _repair_gt100(raw, method.gt100)
    is_lt = (stack_height(raw) <= 1.0)[..., None]
    return torch.clamp(torch.where(is_lt, lt, gt), min=0.0)


def build_stack_from_counters(
    cpu_cycles,
    stall_frontend,
    stall_backend,
    inst_spec,
    method: StackMethod,
    width: int = DISPATCH_WIDTH,
):
    """Convenience: PMU counters -> repaired ISC stack."""
    return build_stack(
        raw_stack(cpu_cycles, stall_frontend, stall_backend, inst_spec, width),
        method,
    )


def collapse_hw_into_be(stack):
    """Fold Horizontal waste into Backend (turn a 4-cat stack into 3-cat)."""
    di, fe, be, hw = (stack[..., i] for i in range(N_CATS))
    return torch.stack([di, fe, be + hw, torch.zeros_like(di)], dim=-1)


def active_categories(method: StackMethod):
    """Indices of the categories a method actually uses."""
    if method.n_categories == 4:
        return (CAT_DI, CAT_FE, CAT_BE, CAT_HW)
    return (CAT_DI, CAT_FE, CAT_BE)


def uniform_stack(n_categories: int) -> np.ndarray:
    """The uniform ST-stack placeholder for ``n_categories`` (3 or 4): the
    (N_CATS,) float32 simplex point with 1/C on the active categories."""
    return np.array(
        [1.0 / n_categories if k < n_categories else 0.0
         for k in range(N_CATS)],
        dtype=np.float32,
    )
