"""The comparison that decides ``correct``.

The plain reference (``portbench/reference/<family>.py``, float32, TF32
off) runs over each sampled sequence once, from weights drawn anew from
the seed after the port's model is gone.  At every judged position it
reads how far the reference's logit of the token the port chose lies
below the reference's best: the widest such gap over the sample is the
number compared with the cell's limit (``portbench/limits/<cell>.json``).
With ``control`` the chosen token is instead the one that the reference
computed in float8 puts first, at the same positions: the control, which
has to fail the limit.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench.reference import weights as weights_mod
from portbench.reference.common import exact_matmul, final_logits

HERE = Path(__file__).resolve().parent
#: Tokens the reference takes at once; rows of logits it makes at once.
TOKENS_AT_ONCE = 16384
ROWS_AT_ONCE = 2048


def limits(cell: str) -> dict:
    """name -> {"limit", "lower", "upper", ...} of the cell's numbers;
    empty where the cell has none yet (it then cannot be correct)."""
    path = HERE / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _groups(samples):
    """Samples in groups of one padded length, at most TOKENS_AT_ONCE
    tokens each (a single longer sample goes alone)."""
    order = sorted(range(len(samples)),
                   key=lambda i: -len(samples[i]["tokens"]))
    group, width = [], 0
    for i in order:
        n = len(samples[i]["tokens"])
        if group and max(width, n) * (len(group) + 1) > TOKENS_AT_ONCE:
            yield group, width
            group, width = [], 0
        group.append(i)
        width = max(width, n)
    if group:
        yield group, width


@torch.no_grad()
def widest_gaps(cfg: dict, weights, samples, device, control: bool = False):
    """(program's widest gap, control's widest gap or None, positions)."""
    fam = weights_mod.family_module(cfg)
    prog = ctrl = 0.0
    positions = 0
    with exact_matmul():
        for group, width in _groups(samples):
            toks = torch.zeros((len(group), width), dtype=torch.long,
                               device=device)
            for row, i in enumerate(group):
                t = torch.as_tensor(samples[i]["tokens"], dtype=torch.long)
                toks[row, :len(t)] = t.to(device)
            h = fam.hidden(weights, cfg, toks)
            hc = fam.hidden(weights, cfg, toks, fp8=True) if control else None
            for row, i in enumerate(group):
                pos = torch.as_tensor(samples[i]["positions"],
                                      dtype=torch.long, device=device)
                chosen = torch.as_tensor(samples[i]["chosen"],
                                         dtype=torch.long, device=device)
                positions += len(pos)
                vocab = weights["embed.table"].shape[0]
                if bool(((chosen < 0) | (chosen >= vocab)).any()):
                    prog = float("inf")          # no token of the vocabulary
                    chosen = chosen.clamp(0, vocab - 1)
                for a in range(0, len(pos), ROWS_AT_ONCE):
                    p = pos[a:a + ROWS_AT_ONCE]
                    ref = final_logits(weights, cfg, h[row, p])
                    best = ref.max(-1).values
                    got = ref.gather(1, chosen[a:a + ROWS_AT_ONCE, None])[:, 0]
                    prog = max(prog, float((best - got).max()))
                    if control:
                        first = final_logits(weights, cfg, hc[row, p],
                                             fp8=True).argmax(-1)
                        got = ref.gather(1, first[:, None])[:, 0]
                        ctrl = max(ctrl, float((best - got).max()))
            del h, hc
    return prog, (ctrl if control else None), positions
