"""Readings of two comparisons for the kimi-k2-instruct prefill cell, on
the card: ``portbench/check.py``'s widest gap, and the same gap against
the reference routed by each candidate's own expert choices.

    python3 experiments/kimi_k2/calibrate.py --seeds 1 2 ... [--out f.jsonl]

For each seed: the weights drawn from the seed into the port's model
(built anew and freed before the reference's draw, so that one copy of
the 32.75 GB of weights is on the card at a time), one prefill cycle of
the ``prefill_long`` mix's lengths, and of it the sample that
``entries.prefill``'s ``samples(check)`` takes (the longest batch and
``check - 1`` others, from the seed), each run through
``ServeEngine.prefill`` with the moe layers' choices recorded.  Then,
with the port freed, on every position of the sample:

* ``check``: the widest gap by which the reference's logit of the
  port's greedy token lies below its best (``portbench/check.py``), and
  the float8 control's (the reference with every product's inputs
  rounded to e4m3, for the token it puts first);
* ``followed``: the same two gaps, each against the float32 reference
  routed by that candidate's own choices (the port's, the control's:
  ``reference.moe.Routes``), with each candidate's widest route gap (how
  far the weakest expert it chose lies below the reference's own 8th
  best, in sigmoid score plus bias) and its share of (token, layer)
  choices that differ from the reference's.

One JSON line a seed, then a summary line.  Needs a CUDA card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import harness, traffic  # noqa: E402
from portbench.check import ROWS_AT_ONCE  # noqa: E402
from portbench.reference import moe as ref  # noqa: E402
from portbench.reference import weights as weights_mod  # noqa: E402
from portbench.reference.common import exact_matmul, final_logits  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "kimi-k2-instruct.json"
MIX = "prefill_long"


def port_samples(cfg, mix, seed, device):
    """[(tokens (1, S) int32 host, greedy choices (S,) device, the moe
    layers' choices [(S, k) device])] of the sampled batches."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    cycle = traffic.Prefill(mix, cfg["vocab_size"], seed).cycle()
    rng = traffic.rng(seed, traffic.SAMPLE)
    longest = max(t.shape[1] for t in cycle)
    tops = [i for i, t in enumerate(cycle) if t.shape[1] == longest]
    picked = [int(rng.choice(tops))]
    rest = [i for i in range(len(cycle)) if i not in picked]
    picked += [int(i) for i in rng.choice(
        rest, size=min(int(mix["check"]) - 1, len(rest)), replace=False)]
    route = moe._route_sigmoid
    ids = []

    def recording(params, x, c):
        w, top = route(params, x, c)
        ids.append(top)
        return w, top

    out = []
    with torch.no_grad():
        model = harness.build(cfg, weights_mod.draw(cfg, seed, device))
        engine = ServeEngine(model, max_len=longest, batch_size=1)
        moe._route_sigmoid = recording
        try:
            for i in picked:
                ids.clear()
                logits = engine.prefill({"tokens": cycle[i]})
                out.append((cycle[i], logits[0].argmax(-1), list(ids)))
                del logits
        finally:
            moe._route_sigmoid = route
        del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gaps(w, cfg, h, chosen):
    """Widest gap of ``chosen`` (S,) under the reference's logits of
    final-normed rows ``h`` (S, d)."""
    widest = 0.0
    for a in range(0, h.shape[0], ROWS_AT_ONCE):
        logits = final_logits(w, cfg, h[a:a + ROWS_AT_ONCE])
        got = logits.gather(1, chosen[a:a + ROWS_AT_ONCE, None])[:, 0]
        widest = max(widest, float((logits.max(-1).values - got).max()))
    return widest


def fp8_choices(w, cfg, h):
    return torch.cat([final_logits(w, cfg, h[a:a + ROWS_AT_ONCE],
                                   fp8=True).argmax(-1)
                      for a in range(0, h.shape[0], ROWS_AT_ONCE)])


def differing(a, b):
    """Share of rows of two (T, k) choices whose sets differ."""
    return float((a.sort(-1).values != b.sort(-1).values).any(-1)
                 .float().mean())


@torch.no_grad()
def reading(cfg, mix, seed, device):
    t0 = time.perf_counter()
    samples = port_samples(cfg, mix, seed, device)
    w = weights_mod.draw(cfg, seed, device)
    r = {"seed": seed, "positions": 0, "check": {"program": 0.0,
                                                 "control": 0.0},
         "followed": {"program": 0.0, "control": 0.0,
                      "program_route_gap": 0.0, "control_route_gap": 0.0},
         "differing_choices": {"program": [], "control": []}}
    with exact_matmul():
        for tokens, chosen, port_ids in samples:
            toks = torch.as_tensor(tokens, dtype=torch.long, device=device)
            r["positions"] += toks.shape[1]
            own = ref.Routes()
            h = ref.hidden(w, cfg, toks, routes=own)[0]
            ctrl = ref.Routes()
            ctrl_chosen = fp8_choices(
                w, cfg, ref.hidden(w, cfg, toks, fp8=True, routes=ctrl)[0])
            c = r["check"]
            c["program"] = max(c["program"], gaps(w, cfg, h, chosen))
            c["control"] = max(c["control"], gaps(w, cfg, h, ctrl_chosen))
            del h
            f = r["followed"]
            for name, ids, pick in (("program", port_ids, chosen),
                                    ("control", ctrl.ids, ctrl_chosen)):
                routes = ref.Routes(follow=ids)
                h = ref.hidden(w, cfg, toks, routes=routes)[0]
                f[name] = max(f[name], gaps(w, cfg, h, pick))
                f[name + "_route_gap"] = max(f[name + "_route_gap"],
                                             max(routes.gaps))
                r["differing_choices"][name].append(
                    [differing(a, b) for a, b in zip(ids, own.ids)])
                del h
    del w
    gc.collect()
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    return r


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cfg = json.loads(CONFIG.read_text())["model"]
    mix = traffic.load(MIX)
    rows = []
    for seed in args.seeds:
        rows.append(reading(cfg, mix, seed, torch.device("cuda")))
        line = json.dumps(rows[-1])
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    summary = {"summary": True, "device": torch.cuda.get_device_name(0),
               "power_limit": harness.power_limit()}
    for comp in ("check", "followed"):
        for who in ("program", "control"):
            summary[f"{comp}.{who}"] = [r[comp][who] for r in rows]
        summary[f"{comp}.lower"] = max(summary[f"{comp}.program"])
        summary[f"{comp}.upper"] = min(summary[f"{comp}.control"])
    line = json.dumps(summary)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
