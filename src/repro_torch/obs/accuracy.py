"""Per-application prediction-accuracy aggregation over app rings — the
twin of ``repro.obs.accuracy`` (host numpy, the reference's code).

The Eq. 4 regression predicts pair slowdown from ISC stacks; aggregate
health (mean and max slowdown per quantum) hides a model that is 3% off
on average and 40% off for one victim application, or one that drifts as
the workload moves.  This module turns the per-app telemetry rings
(:class:`repro_torch.obs.telemetry.AppTelemetryLog`, recorded on the
device by both engines under ``app_telemetry=True``) into:

* :func:`samples` — the scored prediction events: every (quantum, app)
  cell where the policy committed a pair prediction and the machine
  produced a ground-truth slowdown;
* :func:`error_stack` — MAPE / signed bias / RMSE / n, overall and
  grouped per app or per (app, partner) pair;
* :func:`error_ccdf` — P(|relative error| > x) on a fixed grid;
* :func:`drift_windows` — per-window MAPE against a budget, flagging the
  windows past it;
* :func:`accuracy_report` — one JSON-native dict bundling all of the
  above (the ``accuracy`` block of a run export).

Everything here reads already-fetched rings on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

#: Default |relative error| grid for :func:`error_ccdf` (fractions, not
#: percent): 1% .. 100%.
CCDF_GRID = (0.01, 0.02, 0.05, 0.10, 0.15, 0.20, 0.30, 0.50, 1.00)

#: Drift budget fallback: when no recorded budget is supplied, a window
#: is flagged when its MAPE exceeds this multiple of the run's own
#: overall MAPE.  Loose on purpose — the tight budget is the *recorded*
#: one carried by the smoke baseline.
DEFAULT_BUDGET_X = 1.5


def samples(log) -> Dict[str, np.ndarray]:
    """Extract the scored prediction events from an app ring.

    Returns flat arrays (one entry per event): ``quantum``, ``app_id``,
    ``partner_app_id``, ``pred``, ``real``, ``residual``, ``rel_err``
    (signed, ``(pred - real) / real``).  An event is a (quantum, context)
    cell where an application was resident (``app_id >= 0``), the policy
    committed a pair prediction (``pred > 0``) and the machine produced a
    positive ground-truth slowdown — solo quanta and empty contexts are
    not prediction events and are excluded.
    """
    aid = np.asarray(log.series("app_id"))
    part = np.asarray(log.series("partner_app_id"))
    pred = np.asarray(log.series("pred_cost"))
    real = np.asarray(log.series("real_slowdown"))
    resid = np.asarray(log.series("residual"))
    mask = (aid >= 0) & (pred > 0.0) & (real > 0.0)
    q_idx = np.broadcast_to(
        np.arange(aid.shape[0])[:, None], aid.shape)
    return {
        "quantum": q_idx[mask].astype(np.int64),
        "app_id": aid[mask].astype(np.int64),
        "partner_app_id": part[mask].astype(np.int64),
        "pred": pred[mask].astype(np.float64),
        "real": real[mask].astype(np.float64),
        "residual": resid[mask].astype(np.float64),
        "rel_err": (resid[mask] / real[mask]).astype(np.float64),
    }


def _stack_of(rel_err: np.ndarray, resid: np.ndarray) -> Dict[str, float]:
    return {
        "mape": float(np.mean(np.abs(rel_err))),
        "bias": float(np.mean(rel_err)),
        "rmse": float(np.sqrt(np.mean(resid ** 2))),
        "n": int(rel_err.size),
    }


def error_stack(log, by: Optional[str] = None,
                app_names: Optional[Sequence[str]] = None) -> Dict:
    """MAPE / bias / RMSE stacks from an app ring.

    ``by=None`` returns the overall stack; ``by="app"`` a dict keyed by
    app id (named via ``app_names`` when given); ``by="pair"`` a dict
    keyed by the unordered ``"i+j"`` pair label.  Empty rings (no scored
    events) return an all-zero stack rather than NaN, so reports render
    and diff cleanly on degenerate runs.
    """
    s = samples(log)
    if s["rel_err"].size == 0:
        zero = {"mape": 0.0, "bias": 0.0, "rmse": 0.0, "n": 0}
        return zero if by is None else {}
    if by is None:
        return _stack_of(s["rel_err"], s["residual"])

    def name(i: int) -> str:
        if app_names is not None and 0 <= i < len(app_names):
            return str(app_names[i])
        return str(i)

    if by == "app":
        keys = s["app_id"]
        label = name
    elif by == "pair":
        lo = np.minimum(s["app_id"], s["partner_app_id"])
        hi = np.maximum(s["app_id"], s["partner_app_id"])
        keys = lo * 1_000_000 + hi

        def label(k: int) -> str:
            return f"{name(k // 1_000_000)}+{name(k % 1_000_000)}"
    else:
        raise ValueError(f"unknown grouping {by!r}")

    out: Dict[str, Dict[str, float]] = {}
    for k in np.unique(keys):
        m = keys == k
        out[label(int(k))] = _stack_of(s["rel_err"][m], s["residual"][m])
    return out


def error_ccdf(log, grid: Sequence[float] = CCDF_GRID) -> Dict:
    """P(|relative error| > x) over the scored events, on ``grid``.

    The tail complement of the MAPE scalar: two models with the same
    MAPE can have very different worst-victim behaviour, and the paper's
    fairness argument lives in that tail.
    """
    s = samples(log)
    ae = np.abs(s["rel_err"])
    n = ae.size
    return {
        "grid": [float(g) for g in grid],
        "p_gt": [float(np.mean(ae > g)) if n else 0.0 for g in grid],
        "n": int(n),
    }


def drift_windows(log, window: int = 8,
                  budget: Optional[float] = None) -> Dict:
    """Windowed drift detector over the run's quanta.

    Slices the run into consecutive ``window``-quantum windows and
    computes each window's MAPE over its scored events.  A window is
    *flagged* when its MAPE exceeds ``budget``; with no budget given,
    the budget defaults to ``DEFAULT_BUDGET_X`` x the run's own overall
    MAPE (self-referential, catches only intra-run drift).  The real
    guard passes the *recorded* baseline MAPE budget from the smoke
    baseline, which also catches run-over-run aging.

    Returns ``{"window", "budget", "mape", "n", "flagged"}`` where
    ``mape``/``n`` are per-window lists (windows with no events carry
    MAPE 0 and are never flagged) and ``flagged`` lists the offending
    window indices.
    """
    assert window >= 1
    s = samples(log)
    n_q = int(np.asarray(log.series("app_id")).shape[0])
    n_w = max(1, -(-n_q // window))
    if budget is None:
        overall = (float(np.mean(np.abs(s["rel_err"])))
                   if s["rel_err"].size else 0.0)
        budget = DEFAULT_BUDGET_X * overall
    w_of = s["quantum"] // window
    mapes, counts = [], []
    for w in range(n_w):
        m = w_of == w
        counts.append(int(np.sum(m)))
        mapes.append(float(np.mean(np.abs(s["rel_err"][m])))
                     if counts[-1] else 0.0)
    flagged = [w for w in range(n_w)
               if counts[w] and mapes[w] > budget]
    return {
        "window": int(window),
        "budget": float(budget),
        "mape": mapes,
        "n": counts,
        "flagged": flagged,
    }


def accuracy_report(log, budget: Optional[float] = None,
                    window: int = 8,
                    app_names: Optional[Sequence[str]] = None) -> Dict:
    """The full per-app accuracy artefact for one run/arm.

    JSON-native; stored under the export's ``accuracy`` block (schema
    v2) and rendered by ``tools/obs_report.py``.  ``budget`` is the
    recorded drift budget (overall-MAPE units); see
    :func:`drift_windows` for the fallback.
    """
    return {
        "policy": getattr(log, "policy", ""),
        "overall": error_stack(log),
        "per_app": error_stack(log, by="app", app_names=app_names),
        "per_pair": error_stack(log, by="pair", app_names=app_names),
        "ccdf": error_ccdf(log),
        "drift": drift_windows(log, window=window, budget=budget),
    }


def report_metrics(report: Dict, prefix: str = "") -> Dict[str, float]:
    """Flatten an accuracy report into export metric rows (the flat
    ``metrics`` block the diff machinery compares)."""
    overall = report["overall"]
    per_app = report.get("per_app", {})
    worst = max((v["mape"] for v in per_app.values()), default=0.0)
    return {
        f"{prefix}acc_mape": float(overall["mape"]),
        f"{prefix}acc_bias": float(overall["bias"]),
        f"{prefix}acc_rmse": float(overall["rmse"]),
        f"{prefix}acc_n": float(overall["n"]),
        f"{prefix}acc_mape_worst_app": float(worst),
        f"{prefix}acc_drift_flagged":
            float(len(report["drift"]["flagged"])),
    }
