"""SYNPA's fused per-quantum decision (paper §5), on tensors.

Every quantum a SYNPA policy:

  Step 0. reads the PMU counters of every application and builds its measured
          ISC stack with the variant's (LT100, GT100) repair pair (Table 2);
  Step 1. applies the Eq. 4 model *inversely* to the current pairs to recover
          the stack each application would have had running alone (ST mode);
  Step 2. applies the forward model to every candidate pair (both directions)
          to predict each pair's mutual slowdown — the ``pair_score`` kernel;
  Step 3. matches on the predicted-degradation matrix
          (``repro_torch.core.matching``).

:func:`make_fused_step` is Steps 0-2 plus the matching cost preparation
(padding sentinels, the idle-context vertex for odd populations).
"""

from __future__ import annotations

import torch

from repro_torch.core import isc, matching, regression
from repro_torch.kernels.pair_score.ref import DIAG as _KERNEL_DIAG


def fused_pad(n: int) -> int:
    """Padded vertex count of the fused pipeline: the smallest multiple of 8
    with room for the idle-context vertex (row ``n``)."""
    return max(8, ((n + 1 + 7) // 8) * 8)


def make_fused_step(
    method: isc.StackMethod,
    model: regression.CategoryModel,
    gn_steps: int = regression.GN_STEPS,
    hb_steps: int = 80,
    lr: float = 1.5,
):
    """The fused per-quantum SYNPA step (Steps 0-2 + cost preparation),
    with the damped Gauss-Newton §5.3 solver (``hb_steps`` is its
    heavy-ball fallback budget).

    Returns ``step(counters, partner, prev_st, masks, idle)`` with, for
    capacity ``n`` and ``P = fused_pad(n)``:

    * ``counters``  (n, 5) f32 — previous-quantum PMU rows by slot;
    * ``partner``   (n,)  int — co-runner slot (self for solo/no-partner);
    * ``prev_st``   (n, 4) f32 — carried ST estimates; rows that do not
      solve pass through;
    * ``masks``     (4, n) bool — rows *solve* (slot co-ran and its
      estimate should refresh), *solo* (slot ran alone: its measured
      fractions are its ST stack), *valid* (slot hosts an application),
      *fresh* (reset the slot to the uniform placeholder);
    * ``idle``      bool — augment the idle-context vertex (row ``n``)
      with :data:`repro_torch.core.matching.IDLE_COST` edges;

    and returns ``(cost (P, P) f32, st (n, 4) f32)``.  Each co-running pair
    is solved once, by its lower-index side, and both slots receive their
    estimate from that single solve.
    """
    # The kernel's padding sentinel and the matcher's must be the same
    # value, or padded rows could out-compete real edges in the matching.
    assert _KERNEL_DIAG == matching.BIG, (_KERNEL_DIAG, matching.BIG)
    # Copied to the model's device once: a host-to-device copy inside the
    # step would synchronise the host with the device every quantum.
    uniform = torch.as_tensor(isc.uniform_stack(method.n_categories),
                              device=model.coeffs.device)

    def step(counters, partner, prev_st, masks, idle):
        device = counters.device
        solve_mask, solo_mask, valid_mask, fresh_mask = (
            masks[0], masks[1], masks[2], masks[3])
        n = counters.shape[0]
        p = fused_pad(n)
        idx = torch.arange(n, device=device)

        # Step 0: measured SMT stack fractions of every slot.
        raw = isc.raw_stack(counters[:, 0], counters[:, 1], counters[:, 2],
                            counters[:, 3])
        frac = isc.build_stack(raw, method)

        # Step 1: one inverse solve per co-running pair, by its lower-index
        # side; the pair-firsts go to the front in index order.
        first = solve_mask & (idx < partner)
        order = torch.argsort((~first).to(torch.int32), stable=True)
        take = order[: n // 2]
        p_take = partner[take]
        valid = first[take]
        v1 = valid[:, None]
        fi = torch.where(v1, frac[take], uniform)
        fj = torch.where(v1, frac[p_take], uniform)
        si, sj = regression._gn_with_fallback(
            model, fi, fj, gn_steps=gn_steps, hb_steps=hb_steps, lr=lr)
        # Deliver the pair solves by gather: slot s is the solving side of
        # pair rank[s] when first[s] (estimate si), and the partner side of
        # pair rank[partner[s]] when its partner solves (estimate sj).
        rank = torch.cumsum(first.to(torch.int64), 0) - 1
        k1 = torch.clamp(rank, 0, n // 2 - 1)
        k2 = torch.clamp(rank[partner], 0, n // 2 - 1)
        sec = first[partner]
        st = torch.where(first[:, None], si[k1],
                         torch.where(sec[:, None], sj[k2], prev_st))
        # A slot that ran alone measured its ST stack directly.
        st = torch.where(solo_mask[:, None], frac, st)
        # Arrivals reset to the uniform placeholder.
        st = torch.where(fresh_mask[:, None], uniform[None, :], st)

        # Step 2: all-pairs Eq. 4 scoring on the padded stack matrix.
        stp = torch.cat([st, uniform[None, :].expand(p - n, -1)], dim=0)
        cost = regression.pair_cost_matrix(model, stp, n_valid=n)

        # Step 3 prep: sentinel out inactive slots, wire the idle vertex.
        validp = torch.cat(
            [valid_mask, torch.zeros(p - n, dtype=torch.bool, device=device)])
        pairv = validp[:, None] & validp[None, :]
        cost = torch.where(pairv, cost, matching.BIG)
        is_idle = (torch.arange(p, device=device) == n) & idle
        cost = torch.where(is_idle[:, None] & validp[None, :],
                           matching.IDLE_COST, cost)
        cost = torch.where(validp[:, None] & is_idle[None, :],
                           matching.IDLE_COST, cost)
        return cost, st

    return step
