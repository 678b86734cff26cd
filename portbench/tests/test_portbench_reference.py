"""Each family's plain reference against the port at a smoke size.

With float32 activations over the drawn bfloat16 weights the port's
arithmetic is the reference's up to float32 rounding: logits within 1e-5
of the largest, and greedy decode through the cache (ring and slot reuse
included) chooses the reference's best.  In the configurations' bfloat16
the port rounds its activations between products: the reference's
widest gap over its greedy choices stays under 0.05 here, below the
float8 control's.
"""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import weights as weights_mod
from portbench.reference.common import final_logits

from portbench.tests._smoke import CONFIGS, bench


def _model_and_weights(name, **extra):
    cfg = dict(harness.config_of(bench(), name)["model"], **CONFIGS[name],
               **extra)
    w = weights_mod.draw(cfg, 1234, "cpu")
    return cfg, harness.build(cfg, w), w


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_the_port_in_float32(name):
    cfg, model, w = _model_and_weights(name, dtype="float32")
    toks = torch.randint(0, cfg["vocab_size"], (2, 150),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, _ = model.forward({"tokens": toks})
        h = weights_mod.family_module(cfg).hidden(w, cfg, toks)
        want = final_logits(w, cfg, h.reshape(-1, cfg["d_model"]))
    want = want.reshape(got.shape)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_in_bfloat16_stays_near_the_reference(name):
    cfg, model, w = _model_and_weights(name)
    toks = torch.randint(0, cfg["vocab_size"], (2, 96),
                         generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        logits, _ = model.forward({"tokens": toks})
    samples = [{"tokens": toks[i].numpy(), "positions": np.arange(96),
                "chosen": logits[i].argmax(-1).numpy()} for i in range(2)]
    prog, ctrl, n = check.widest_gaps(cfg, w, samples, torch.device("cpu"),
                                      control=True)
    assert n == 192
    assert prog < 0.05 and ctrl > prog


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_through_the_cache_matches_the_reference(name):
    """Greedy decode through ``ServeEngine.generate`` (slots reused, the
    state reset) judged against the reference's full forward."""
    from repro_torch.serve.engine import ServeEngine

    cfg, model, w = _model_and_weights(name, dtype="float32")
    eng = ServeEngine(model, max_len=32, batch_size=2)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg["vocab_size"], (n,), dtype=np.int32)
               for n in (5, 3, 7, 4)]
    outs = eng.generate(prompts, max_new_tokens=6, eos_id=-1, greedy=True)
    samples = [{"tokens": np.concatenate([p, o[:-1]]),
                "positions": len(p) - 1 + np.arange(len(o)), "chosen": o}
               for p, o in zip(prompts, outs)]
    prog, _, n = check.widest_gaps(cfg, w, samples, torch.device("cpu"))
    assert n == 24 and prog <= 1e-4
