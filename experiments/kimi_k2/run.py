"""Kimi-K2-Instruct at the benchmark's cut (21 layers, 12 of 384 experts
held), prefill then decode through the latent cache, on the card.

    python3 experiments/kimi_k2/run.py [--seed N] [--prompt 8192] \
        [--steps 32] [--json out.json]

From the root of a checkout on a machine with an H100: the weights drawn
from the seed (``portbench/reference/weights.py``) into the port's model;
``ServeEngine.prefill`` of one prompt with a latent cache; ``--steps``
greedy tokens through ``ServeEngine.serve_step`` (absorbed attention over
the cache); then, with the port freed, the plain float32 reference's full
forward over the prompt and the tokens fed back, and at every position
how far the reference's logit of the port's greedy token lies below the
reference's best: once with the reference routing on its own
(``portbench/check.py``'s widest gap) and once routed by the port's own
expert choices, recorded in the prefill and in every step
(``reference.moe.Routes``, with the widest route gap).  Prints one
JSON line.  Needs a CUDA card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import moe as ref  # noqa: E402
from portbench.reference import weights as weights_mod  # noqa: E402
from portbench.reference.common import exact_matmul, final_logits  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "kimi-k2-instruct.json"


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3000000101)
    ap.add_argument("--prompt", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("run: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.models import attention, moe
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda")
    cfg = json.loads(CONFIG.read_text())["model"]
    prompt = np.random.default_rng(args.seed).integers(
        0, cfg["vocab_size"], (1, args.prompt), dtype=np.int32)
    route = moe._route_sigmoid
    ids = []

    def recording(params, x, c):
        w, top = route(params, x, c)
        ids.append(top)
        return w, top

    with torch.no_grad():
        model = harness.build(cfg, weights_mod.draw(cfg, args.seed, dev))
        eng = ServeEngine(model, max_len=args.prompt + args.steps,
                          batch_size=1)
        eng.prefill({"tokens": prompt[:, :64]})            # warm-up
        torch.cuda.synchronize()
        cache = model.init_cache(1, args.prompt + args.steps)
        moe._route_sigmoid = recording
        try:
            t0 = time.perf_counter()
            logits = eng.prefill({"tokens": prompt}, cache=cache)
            prefill_choice = logits[0].argmax(-1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            del logits
            nxt = prefill_choice[-1:].view(1, 1).int()
            decode_calls = attention.MLA_DECODE
            steps, step_s = [int(nxt)], []
            for _ in range(args.steps - 1):
                t0 = time.perf_counter()
                out, cache = eng.serve_step(cache, nxt)
                nxt = out[:, -1].argmax(-1).view(1, 1).int()
                steps.append(int(nxt))
                step_s.append(time.perf_counter() - t0)
        finally:
            moe._route_sigmoid = route
        decode_calls = attention.MLA_DECODE - decode_calls
        cache_bytes = sum(cache[k].numel() * cache[k].element_size()
                          for k in ("c_kv", "k_pe"))
        peak = torch.cuda.max_memory_allocated()
        prefill_choice = prefill_choice.cpu().numpy()
    del model, eng, cache
    gc.collect()
    torch.cuda.empty_cache()
    # The prefill's choices, then one row a step, layer by layer.
    layers = cfg["n_layers"] - cfg["first_k_dense"]
    follow = [torch.cat(ids[j::layers]) for j in range(layers)]
    tokens = np.concatenate([prompt[0], np.array(steps[:-1], np.int32)])
    n = args.prompt
    toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)[None]
    parts = {"prefill": (np.arange(n), prefill_choice),
             "decode": (n - 1 + np.arange(args.steps), np.array(steps))}
    w = weights_mod.draw(cfg, args.seed, dev)
    out = {}
    with torch.no_grad(), exact_matmul():
        for how, routes in (("own", None),
                            ("followed", ref.Routes(follow=follow))):
            h = ref.hidden(w, cfg, toks, routes=routes)[0]
            for part, (pos, chosen) in parts.items():
                logits = final_logits(w, cfg, h[torch.as_tensor(pos)])
                got = logits.gather(1, torch.as_tensor(
                    chosen, device=dev).long()[:, None])[:, 0]
                out[f"widest_gap_{part}_{how}"] = float(
                    (logits.max(-1).values - got).max())
            if routes is not None:
                out["widest_route_gap"] = max(routes.gaps)
            del h
    out = {"seed": args.seed, "prompt": n, "steps": args.steps,
           "prefill_s": prefill_s,
           "decode_step_ms": [1e3 * s for s in step_s],
           "mla_decode_calls": decode_calls,
           "latent_cache_bytes": cache_bytes,
           "bytes_per_token_layer": cache_bytes / ((n + args.steps)
                                                   * cfg["n_layers"]),
           **out, "peak_bytes": peak,
           "device": torch.cuda.get_device_name(0),
           "power_limit": harness.power_limit()}
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        Path(args.json).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
