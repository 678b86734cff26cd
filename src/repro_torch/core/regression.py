"""Per-category linear regression performance model — the paper's Eq. 4.

For every ISC category ``C`` a tiny linear model predicts the cycles spent
in category C in SMT mode, per ST cycle of the same instruction window:

    C_smt(i|j) = alpha_C + beta_C * C_st(i) + gamma_C * C_st(j)
                 + rho_C * C_st(i) * C_st(j)                          (Eq. 4)

ST stacks are fractions of ST cycles (they sum to 1); the predicted SMT
values sum to the application's slowdown.

Operations (paper §5.3 steps 1-2):

* :func:`fit`              — least-squares coefficients + per-category MSE.
* :func:`forward`          — ST stacks of a pair -> predicted SMT values.
* :func:`predict_slowdown` — sum of the forward components.
* :func:`inverse` / :func:`_gn_with_fallback` — measured SMT stack
  *fractions* of co-running pairs -> estimated ST stacks, by a batched
  damped Gauss-Newton (Levenberg-Marquardt) iteration over
  softmax-parameterised simplex points, with a heavy-ball gradient solve
  as the fallback for rows GN has not converged (``solver="hb"``: the
  heavy-ball solve alone); :func:`inverse_gn_trace` and
  :func:`inverse_trace` give each solver's per-step residuals.
* :func:`pair_cost_matrix` — dense all-pairs cost through
  ``repro_torch.kernels.pair_score``.
* :func:`profile_to_training_set` — profiling runs -> training triples
  (numpy).

The GN Jacobian is assembled in closed form from Eq. 4's bilinear
structure, and each LM step solves a batch of 8x8 damped normal equations
by an unrolled Cholesky.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import isc

_EPS = 1e-8
MIN_SLOWDOWN = 0.25
MAX_SLOWDOWN = 16.0

#: LM step budget: the bilinear system is exactly determined, so GN reaches
#: float-noise residuals in a median of 2-3 accepted steps.
GN_STEPS = 8
_GN_LAM0 = 1e-2        # initial LM damping
_GN_LAM_DOWN = 0.33    # damping decay on an accepted step
_GN_LAM_UP = 10.0      # damping escalation on a rejected step
#: A row still improving by more than this relative amount over its last two
#: LM steps at budget end has not converged -> heavy-ball fallback.
_GN_PLATEAU_RTOL = 0.05
#: ...unless its residual is already below this.
_GN_GOOD_ENOUGH = 1e-4
#: Damping level past which a rejected LM trial counts as a stall.
_GN_LAM_STALL = 1e3

#: Host reads of the fallback flag (one per :func:`_gn_with_fallback`
#: call): the solve's only device-to-host sync.
NEED_FB_SYNCS = 0
#: Calls of :func:`_gn_with_fallback` that ran the heavy-ball fallback.
FALLBACK_RUNS = 0


@dataclasses.dataclass(frozen=True)
class CategoryModel:
    """Fitted Eq. 4 coefficients for one stack method.

    coeffs: (4, 4) f32 tensor, rows in ISC category order (DI, FE, BE, HW),
            columns (alpha, beta, gamma, rho).  Rows beyond ``n_categories``
            are zero.
    mse:    (4,) training mean-squared error per category.
    n_categories: 3 or 4 (SYNPA3 vs SYNPA4 stacks).
    """

    coeffs: torch.Tensor
    mse: torch.Tensor
    n_categories: int

    def to(self, device) -> "CategoryModel":
        return CategoryModel(self.coeffs.to(device), self.mse.to(device),
                             self.n_categories)


class InverseDiag(NamedTuple):
    """Per-row diagnostics of the §5.3 inverse solve.

    iters:    LM steps taken while the row was still live.
    residual: final inverse residual of the returned solution.
    fallback: the heavy-ball fallback's solution beat GN's on this row.
    """

    iters: torch.Tensor
    residual: torch.Tensor
    fallback: torch.Tensor


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def design_matrix(c_i, c_j):
    """Rows of the Eq. 4 design: [1, C_i, C_j, C_i*C_j]."""
    c_i = _f32(c_i)
    c_j = _f32(c_j, c_i.device)
    return torch.stack([torch.ones_like(c_i), c_i, c_j, c_i * c_j], dim=-1)


def fit(st_i, st_j, smt_i, n_categories: int, ridge: float = 1e-6,
        device=None) -> CategoryModel:
    """Least-squares fit of Eq. 4, one independent model per category.

    st_i:  (S, 4) ST stack (fractions, height 1) of the measured app.
    st_j:  (S, 4) ST stack of its co-runner.
    smt_i: (S, 4) instruction-aligned SMT category values (per ST cycle).
    Arrays land on ``device`` (default: the CPU, or the tensors' own).
    """
    st_i = _f32(st_i, device)
    st_j = _f32(st_j, st_i.device)
    smt_i = _f32(smt_i, st_i.device)
    eye = torch.eye(4, dtype=torch.float32, device=st_i.device)
    coeffs, mses = [], []
    for c in range(n_categories):
        x = design_matrix(st_i[:, c], st_j[:, c])
        y = smt_i[:, c]
        gram = x.T @ x + ridge * eye
        w = torch.linalg.solve(gram, x.T @ y)
        coeffs.append(w)
        mses.append(torch.mean((x @ w - y) ** 2))
    zero = torch.zeros(4, dtype=torch.float32, device=st_i.device)
    while len(coeffs) < isc.N_CATS:
        coeffs.append(zero)
        mses.append(zero[0])
    return CategoryModel(torch.stack(coeffs), torch.stack(mses), n_categories)


def _cat_mask(model: CategoryModel, device):
    return (torch.arange(isc.N_CATS, device=device)
            < model.n_categories).to(torch.float32)


def forward(model: CategoryModel, st_i, st_j):
    """Eq. 4 forward: ST stacks -> per-ST-cycle SMT category values of i."""
    a, b, g, r = (model.coeffs[:, k] for k in range(4))
    pred = a + b * st_i + g * st_j + r * st_i * st_j
    return torch.clamp(pred * _cat_mask(model, st_i.device), min=0.0)


def predict_slowdown(model: CategoryModel, st_i, st_j):
    """Predicted slowdown of i next to j = predicted SMT stack height."""
    s = forward(model, st_i, st_j).sum(-1)
    return torch.clamp(s, MIN_SLOWDOWN, MAX_SLOWDOWN)


def _log_init(stacks):
    """Masked-softmax pre-image of a (clipped) simplex point."""
    return torch.log(torch.clamp(stacks, min=1e-4))


def _make_to_simplex(mask):
    def to_simplex(z):
        e = torch.exp(z - torch.amax(z, dim=-1, keepdim=True)) * mask
        return e / torch.clamp(e.sum(-1, keepdim=True), min=_EPS)
    return to_simplex


def inverse_residual(model: CategoryModel, frac_i, frac_j, st_i, st_j):
    """Residual of a candidate ST-stack pair against measured fractions:
    the objective the inverse minimises, at simplex points."""
    p_i = forward(model, st_i, st_j)
    p_j = forward(model, st_j, st_i)
    r_i = p_i - p_i.sum(-1, keepdim=True) * frac_i
    r_j = p_j - p_j.sum(-1, keepdim=True) * frac_j
    return (r_i * r_i).sum(-1) + (r_j * r_j).sum(-1)


# ---------------------------------------------------------------------------
# Heavy-ball gradient solve — the fallback of the GN inverse.
# ---------------------------------------------------------------------------
def _inverse_problem(model: CategoryModel, frac_i, frac_j, lr: float):
    """``(to_simplex, residual, solve_from)`` over the measured fractions;
    ``solve_from(z0_i, z0_j, n_steps)`` runs the heavy-ball gradient loop
    and returns the final ``(z_i, z_j)`` (with ``trace=True`` also the
    (n_steps, ...) residual after each step)."""
    to_simplex = _make_to_simplex(_cat_mask(model, frac_i.device))

    def residual(z_i, z_j):
        return inverse_residual(model, frac_i, frac_j,
                                to_simplex(z_i), to_simplex(z_j))

    def grad(z_i, z_j):
        with torch.enable_grad():
            zi = z_i.detach().requires_grad_(True)
            zj = z_j.detach().requires_grad_(True)
            loss = residual(zi, zj).sum()
            return torch.autograd.grad(loss, (zi, zj))

    def solve_from(z_i, z_j, n_steps: int, trace: bool = False):
        m_i = torch.zeros_like(z_i)
        m_j = torch.zeros_like(z_j)
        res = []
        for _ in range(n_steps):
            g_i, g_j = grad(z_i, z_j)
            # Heavy-ball momentum keeps the solve cheap yet fast-converging.
            m_i = 0.7 * m_i + g_i
            m_j = 0.7 * m_j + g_j
            z_i = z_i - lr * m_i
            z_j = z_j - lr * m_j
            if trace:
                res.append(residual(z_i, z_j))
        if trace:
            return (z_i, z_j), torch.stack(res)
        return z_i, z_j

    return to_simplex, residual, solve_from


def _hb_best_of(model: CategoryModel, frac_i, frac_j, n_steps: int,
                lr: float, init_i=None, init_j=None):
    """The heavy-ball solve: two trajectories, from the measured fractions
    and from the uniform stack (or the warm ``init``), per-row best."""
    to_simplex, residual, solve_from = _inverse_problem(
        model, frac_i, frac_j, lr)
    za = solve_from(_log_init(frac_i), _log_init(frac_j), n_steps)
    if init_i is None:
        zb = solve_from(torch.zeros_like(frac_i), torch.zeros_like(frac_j),
                        n_steps)
    else:
        zb = solve_from(_log_init(_f32(init_i, frac_i.device)),
                        _log_init(_f32(init_j, frac_i.device)), n_steps)
    better_b = (residual(*zb) < residual(*za))[..., None]
    z_i = torch.where(better_b, zb[0], za[0])
    z_j = torch.where(better_b, zb[1], za[1])
    return to_simplex(z_i), to_simplex(z_j)


# ---------------------------------------------------------------------------
# Damped Gauss-Newton inverse (§5.3 step 1) — the production solver.
# ---------------------------------------------------------------------------
def _chol_solve_small(A, b, n: int):
    """Batched SPD solve by unrolled Cholesky, elementwise on tensors.

    ``A``: (..., n, n) SPD (LM-damped normal equations), ``b``: (..., n).
    The factor and the forward substitution run a column at a time over
    the rows below it; every entry sees the same operations in the same
    order as the scalar recurrence.  Zeroed rows/columns (masked
    categories) pass through with a zero solution component.
    """
    cols = []  # cols[j]: (..., n - j) entries L[j:, j]
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k, None]
        d = torch.sqrt(torch.clamp(s[..., :1], min=1e-20))
        cols.append(torch.cat([d, s[..., 1:] / d], dim=-1))
    diag = [cols[i][..., 0] for i in range(n)]
    y = []
    s = b
    for i in range(n):
        y.append(s[..., i] / diag[i])
        if i + 1 < n:
            s = torch.cat(
                [s[..., : i + 1], s[..., i + 1:] - cols[i][..., 1:] * y[i][..., None]],
                dim=-1)
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - cols[i][..., k - i] * x[k]
        x[i] = s / diag[i]
    return torch.stack(x, dim=-1)


def _gn_problem(model: CategoryModel, frac_i, frac_j):
    """Closures of the GN solve: simplex map, residual vector, Jacobian.

    With the co-runner's stack fixed, each predicted category is affine in
    the own stack, so each C x C Jacobian block (including the chain
    through the masked softmax) reduces to
    ``diag(q) - frac q^T - (q - (sum q) frac) x^T`` with ``q = u * x``.
    """
    device = frac_i.device
    mask = _cat_mask(model, device)
    a, b, g, r = (model.coeffs[:, k] for k in range(4))
    eye = torch.eye(isc.N_CATS, dtype=torch.float32, device=device)
    to_simplex = _make_to_simplex(mask)

    def resvec(x, y):
        p_i = forward(model, x, y)
        p_j = forward(model, y, x)
        r_i = p_i - p_i.sum(-1, keepdim=True) * frac_i
        r_j = p_j - p_j.sum(-1, keepdim=True) * frac_j
        return torch.cat([r_i, r_j], dim=-1)

    def residual(x, y):
        rv = resvec(x, y)
        return (rv * rv).sum(-1)

    def _block(frac, u, x):
        q = u * x
        s = q.sum(-1, keepdim=True)
        d = eye * q[..., None, :]
        d = d - frac[..., :, None] * q[..., None, :]
        return d - (q - s * frac)[..., :, None] * x[..., None, :]

    def jac(x, y):
        pred_i = (a + b * x + g * y + r * x * y) * mask
        pred_j = (a + b * y + g * x + r * y * x) * mask
        act_i = (pred_i > 0).to(torch.float32) * mask  # clip subgradient
        act_j = (pred_j > 0).to(torch.float32) * mask
        u_i = (b + r * y) * act_i      # d p_i / d x
        w_i = (g + r * x) * act_i      # d p_i / d y
        u_j = (b + r * x) * act_j      # d p_j / d y
        w_j = (g + r * y) * act_j      # d p_j / d x
        top = torch.cat([_block(frac_i, u_i, x), _block(frac_i, w_i, y)], dim=-1)
        bot = torch.cat([_block(frac_j, w_j, x), _block(frac_j, u_j, y)], dim=-1)
        return torch.cat([top, bot], dim=-2)

    return to_simplex, resvec, residual, jac


def _make_lm_step(model: CategoryModel, frac_i, frac_j):
    """One LM-damped Gauss-Newton step with per-row accept/reject.

    Returns ``(to_simplex, init_carry, step)`` with
    ``step(z_i, z_j, rv, res, lam) -> (z_i, z_j, rv, res, lam)``.
    """
    to_simplex, resvec, _residual, jac = _gn_problem(model, frac_i, frac_j)
    two_c = 2 * isc.N_CATS
    eye2 = torch.eye(two_c, dtype=torch.float32, device=frac_i.device)

    def init_carry(z_i, z_j):
        rv = resvec(to_simplex(z_i), to_simplex(z_j))
        res = (rv * rv).sum(-1)
        lam = torch.full_like(res, _GN_LAM0)
        return z_i, z_j, rv, res, lam

    def step(z_i, z_j, rv, res, lam):
        x, y = to_simplex(z_i), to_simplex(z_j)
        J = jac(x, y)
        grad = torch.einsum("...ki,...k->...i", J, rv)
        H = torch.einsum("...ki,...kj->...ij", J, J)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        A = H + (lam[..., None, None] * diag[..., None, :] + 1e-8) * eye2
        delta = _chol_solve_small(A, -grad, two_c)
        z_i_t = z_i + delta[..., : isc.N_CATS]
        z_j_t = z_j + delta[..., isc.N_CATS:]
        rv_t = resvec(to_simplex(z_i_t), to_simplex(z_j_t))
        res_t = (rv_t * rv_t).sum(-1)
        ok = (res_t < res) & torch.isfinite(res_t)
        okx = ok[..., None]
        z_i = torch.where(okx, z_i_t, z_i)
        z_j = torch.where(okx, z_j_t, z_j)
        rv = torch.where(okx, rv_t, rv)
        res = torch.where(ok, res_t, res)
        lam = torch.clamp(
            torch.where(ok, lam * _GN_LAM_DOWN, lam * _GN_LAM_UP), 1e-7, 1e8)
        return z_i, z_j, rv, res, lam

    return to_simplex, init_carry, step


def _gn_solve(model: CategoryModel, frac_i, frac_j, z0_i, z0_j,
              n_steps: int, diag: bool = False):
    """GN solve that steps every row until *all* rows are done or the
    budget runs out.

    A row is *done* when its residual is below :data:`_GN_GOOD_ENOUGH` or
    it has plateaued (two consecutive steps improving by less than
    :data:`_GN_PLATEAU_RTOL` relative).  The loop runs ``n_steps`` times;
    each iteration is applied only under the device-side flag
    ``go = ~all(done)``, which reproduces the early-exit loop exactly with
    no host sync.

    Rows lie along the second-to-last axis (``frac_i`` (..., m, C)); any
    axes before it are lanes, each with its own ``go`` over its own rows,
    as a batched early-exit loop freezes each lane: a lane's result does
    not depend on the other lanes.

    Returns ``(st_i, st_j, res, not_converged)`` plus the per-row live-step
    count ``iters`` when ``diag=True``.
    """
    to_simplex, init_carry, step = _make_lm_step(model, frac_i, frac_j)
    z_i, z_j, rv, res, lam = init_carry(z0_i, z0_j)
    stall = torch.zeros(res.shape, dtype=torch.int32, device=res.device)
    ever = torch.zeros(res.shape, dtype=torch.bool, device=res.device)
    iters = torch.zeros_like(stall)

    def done_of(res, stall):
        return (res < _GN_GOOD_ENOUGH) | (stall >= 2)

    for _ in range(n_steps):
        live = ~done_of(res, stall)
        go = live.any(-1, keepdim=True)     # one flag a lane
        gv = go[..., None]
        z_i_n, z_j_n, rv_n, res_n, lam_n = step(z_i, z_j, rv, res, lam)
        small = (res - res_n) <= _GN_PLATEAU_RTOL * (res_n + 1e-12)
        accepted = res_n < res
        # A rejected trial on a row that has descended before is plateau
        # evidence; on a row still at its starting residual it only counts
        # once damping has escalated past _GN_LAM_STALL.
        stalled = small & (accepted | ever | (lam_n >= _GN_LAM_STALL))
        stall_n = torch.where(
            stalled, stall + 1, torch.where(accepted, 0, stall))
        ever_n = ever | accepted
        iters = torch.where(go, iters + live.to(torch.int32), iters)
        z_i = torch.where(gv, z_i_n, z_i)
        z_j = torch.where(gv, z_j_n, z_j)
        rv = torch.where(gv, rv_n, rv)
        res = torch.where(go, res_n, res)
        lam = torch.where(go, lam_n, lam)
        stall = torch.where(go, stall_n, stall)
        ever = torch.where(go, ever_n, ever)
    not_converged = ~done_of(res, stall)
    out = (to_simplex(z_i), to_simplex(z_j), res, not_converged)
    return out + (iters,) if diag else out


def _gn_solve_scan(model: CategoryModel, frac_i, frac_j, z0_i, z0_j,
                   n_steps: int):
    """Fixed-step GN solve with a per-step residual trace (diagnostics):
    the LM step of :func:`_gn_solve` applied ``n_steps`` times, without
    its early exit.  Returns ``(st_i, st_j, res, trace)``; ``trace`` has
    shape ``(n_steps, ...batch)``."""
    to_simplex, init_carry, step = _make_lm_step(model, frac_i, frac_j)
    carry = init_carry(z0_i, z0_j)
    trace = []
    for _ in range(n_steps):
        carry = step(*carry)
        trace.append(carry[3])
    z_i, z_j, _rv, res, _lam = carry
    return to_simplex(z_i), to_simplex(z_j), res, torch.stack(trace)


def _gn_with_fallback(model: CategoryModel, frac_i, frac_j,
                      gn_steps: int = GN_STEPS, hb_steps: int = 80,
                      lr: float = 1.5, init_i=None, init_j=None,
                      return_diag: bool = False):
    """GN solve from the measured fractions (or from ``init_i``/``init_j``,
    which replace the start) + heavy-ball fallback for non-converged rows.

    The fallback runs at most once, and only when some row has not
    converged (or went non-finite): reading that flag is the one host
    sync of the solve, counted in :data:`NEED_FB_SYNCS`.  Per row, the
    lower-residual solution wins.  With lanes (``frac_i`` (L, m, C)) the
    flag is read once for all of them; the fallback then runs over every
    row, and a row takes its solution only where its own lane flagged a
    row, so each lane gets what a solve of its rows alone would give.

    ``return_diag=True`` returns ``(st_i, st_j, InverseDiag)``.
    """
    global NEED_FB_SYNCS, FALLBACK_RUNS
    if gn_steps < 3:
        raise ValueError("plateau detection needs at least 3 LM steps")
    if init_i is None:
        z0_i, z0_j = _log_init(frac_i), _log_init(frac_j)
    else:
        z0_i = _log_init(_f32(init_i, frac_i.device))
        z0_j = _log_init(_f32(init_j, frac_i.device))
    st_i, st_j, res, not_converged, iters = _gn_solve(
        model, frac_i, frac_j, z0_i, z0_j, gn_steps, diag=True)
    need_fb = torch.any(not_converged | ~torch.isfinite(res), -1,
                        keepdim=True)       # one flag a lane
    fallback = torch.zeros_like(not_converged)
    NEED_FB_SYNCS += 1
    if bool(need_fb.any()):
        FALLBACK_RUNS += 1
        hb_i, hb_j = _hb_best_of(model, frac_i, frac_j, hb_steps, lr,
                                 init_i=init_i, init_j=init_j)
        res_hb = inverse_residual(model, frac_i, frac_j, hb_i, hb_j)
        fallback = (res_hb < res) & need_fb
        bx = fallback[..., None]
        st_i = torch.where(bx, hb_i, st_i)
        st_j = torch.where(bx, hb_j, st_j)
        res = torch.where(fallback, res_hb, res)
    if return_diag:
        return st_i, st_j, InverseDiag(iters=iters, residual=res,
                                       fallback=fallback)
    return st_i, st_j


def _inputs_on(model: CategoryModel, device, *arrays):
    """The model and float32 tensors of ``arrays`` on the resolved
    ``device`` (``cuda`` unless the caller asks for the CPU); ``None``
    entries stay ``None``."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    return (model.to(dev),) + tuple(
        None if a is None else _f32(a, dev) for a in arrays)


def inverse_gn_trace(model: CategoryModel, frac_i, frac_j,
                     n_steps: int = GN_STEPS, init_i=None, init_j=None,
                     device=None):
    """Pure GN trajectory (no fallback): ``(st_i, st_j, trace)``.

    ``trace[k]`` is the residual after LM step ``k+1`` — the step-count
    budget assertions of the solver tests read it directly.  Runs on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    """
    model, frac_i, frac_j, init_i, init_j = _inputs_on(
        model, device, frac_i, frac_j, init_i, init_j)
    if init_i is None:
        z0_i, z0_j = _log_init(frac_i), _log_init(frac_j)
    else:
        z0_i, z0_j = _log_init(init_i), _log_init(init_j)
    st_i, st_j, _res, trace = _gn_solve_scan(
        model, frac_i, frac_j, z0_i, z0_j, n_steps)
    return st_i, st_j, trace


def inverse(model: CategoryModel, frac_i, frac_j, n_steps: int = 80,
            lr: float = 1.5, init_i=None, init_j=None, solver: str = "gn",
            gn_steps: int = GN_STEPS, return_diag: bool = False,
            device=None):
    """Invert Eq. 4 (paper §5.3 step 1).

    Inputs are the *measured SMT stack fractions* of the two applications
    sharing a core (each sums to 1).  The solve looks for the two ST
    stacks (height 1) whose forward predictions are *parallel* to the
    measured fractions, over the product of simplices (masked softmax).

    ``solver="gn"`` (default): ``gn_steps`` damped Gauss-Newton steps from
    the measured fractions (or from ``init_i``/``init_j``, which replace
    the start); rows still descending at budget end, or non-finite, take
    the heavy-ball fallback (``n_steps`` from both starts, per-row best)
    where it does better.  ``solver="hb"``: the two heavy-ball
    trajectories of ``n_steps`` each from (a) the measured fractions and
    (b) the uniform stack (or the warm ``init``), per-row best.

    ``return_diag=True`` returns ``(st_i, st_j, diag)`` with a per-row
    :class:`InverseDiag`; under ``solver="hb"`` ``iters`` is the full
    ``n_steps`` and ``fallback`` all-False.  Runs on ``device``
    (``cuda`` unless the caller passes ``"cpu"``).
    """
    model, frac_i, frac_j, init_i, init_j = _inputs_on(
        model, device, frac_i, frac_j, init_i, init_j)
    if solver == "hb":
        st_i, st_j = _hb_best_of(model, frac_i, frac_j, n_steps, lr,
                                 init_i=init_i, init_j=init_j)
        if not return_diag:
            return st_i, st_j
        res = inverse_residual(model, frac_i, frac_j, st_i, st_j)
        return st_i, st_j, InverseDiag(
            iters=torch.full(res.shape, n_steps, dtype=torch.int32,
                             device=res.device),
            residual=res,
            fallback=torch.zeros(res.shape, dtype=torch.bool,
                                 device=res.device))
    if solver != "gn":
        raise ValueError(f"unknown solver {solver!r}")
    return _gn_with_fallback(model, frac_i, frac_j, gn_steps=gn_steps,
                             hb_steps=n_steps, lr=lr, init_i=init_i,
                             init_j=init_j, return_diag=return_diag)


def inverse_trace(model: CategoryModel, frac_i, frac_j, n_steps: int = 80,
                  lr: float = 1.5, init_i=None, init_j=None, device=None):
    """Per-step residual trace of a single-start *heavy-ball* solve, from
    the measured fractions (cold) or from ``init_i``/``init_j`` (warm):
    ``(st_i, st_j, trace)``, ``trace`` of shape ``(n_steps, ...batch)``.
    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    """
    model, frac_i, frac_j, init_i, init_j = _inputs_on(
        model, device, frac_i, frac_j, init_i, init_j)
    to_simplex, _residual, solve_from = _inverse_problem(
        model, frac_i, frac_j, lr)
    if init_i is None:
        z0_i, z0_j = _log_init(frac_i), _log_init(frac_j)
    else:
        z0_i, z0_j = _log_init(init_i), _log_init(init_j)
    (z_i, z_j), trace = solve_from(z0_i, z0_j, n_steps, trace=True)
    return to_simplex(z_i), to_simplex(z_j), trace


def pair_cost_matrix(model: CategoryModel, st_stacks, n_valid=None,
                     valid=None, idle_row: int = -1, p=None, idle_flag=None):
    """Dense all-pairs cost: cost[i, j] = slowdown(i|j) + slowdown(j|i).

    st_stacks: (rows, 4) ST stacks, or (L, rows, 4) for L lanes at once
    (then ``valid`` is (L, n_valid), ``idle_flag`` (L,) and the result
    (L, p, p), from one kernel launch).  Returns (p, p) (``p`` defaults to
    ``rows``); the diagonal and, with ``n_valid``, every padding row/column
    carry the ``DIAG`` sentinel; ``valid`` and ``idle_row`` add the
    matcher's cost preparation, and ``idle_flag`` (a one-element bool
    tensor) turns the idle vertex on or off on the device.  See
    :func:`repro_torch.kernels.pair_score.ops.pair_costs`.
    """
    from repro_torch.kernels.pair_score import ops as pair_score_ops

    return pair_score_ops.pair_costs(
        st_stacks.to(torch.float32).contiguous(), model.coeffs,
        n_categories=model.n_categories, n_valid=n_valid, valid=valid,
        idle_row=idle_row, p=p, idle_flag=idle_flag)


def profile_to_training_set(
    st_stacks: np.ndarray,
    pair_smt_values: np.ndarray,
    pairs: Sequence[Tuple[int, int]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble (st_i, st_j, smt_i) training triples from profiling runs.

    st_stacks:       (A, 4) per-app ST stacks.
    pair_smt_values: (P, 2, 4) per-pair instruction-aligned SMT values.
    pairs:           length-P list of (i, j) app indices.
    """
    xs_i, xs_j, ys = [], [], []
    for p, (i, j) in enumerate(pairs):
        xs_i.append(st_stacks[i]); xs_j.append(st_stacks[j])
        ys.append(pair_smt_values[p, 0])
        xs_i.append(st_stacks[j]); xs_j.append(st_stacks[i])
        ys.append(pair_smt_values[p, 1])
    return np.stack(xs_i), np.stack(xs_j), np.stack(ys)
