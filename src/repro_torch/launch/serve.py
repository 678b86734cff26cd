"""Serving driver: continuous-batched generation on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.registry import build_model, get_config
from repro_torch.serve.engine import ServeEngine


def serve_demo(arch: str, smoke: bool = True, n_requests: int = 12,
               batch_slots: int = 4, max_new: int = 16, max_len: int = 64,
               seed: int = 0, device=None):
    """Serve ``n_requests`` random prompts (4-11 tokens, numpy seed
    ``seed``) through ``batch_slots`` slots with greedy decoding, on a model
    whose float32 weights come from a generator seeded ``seed``.  After the
    prompts the same numpy generator draws, as the reference's, a standard
    normal ``image_embeds`` (slots, n_image_tokens, d) for vlm or encoder
    output ``enc`` (slots, encoder_seq, d) for audio, which every slot
    attends."""
    device = resolve_device(device)
    cfg = get_config(arch, smoke=smoke, dtype="float32",
                     param_dtype="float32")
    model = build_model(cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    engine = ServeEngine(model, max_len=max_len, batch_size=batch_slots)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
               .astype(np.int32) for _ in range(n_requests)]
    extras = None
    key, seq = {"vlm": ("image_embeds", cfg.n_image_tokens),
                "audio": ("enc", cfg.encoder_seq)}.get(cfg.family, (None, 0))
    if key is not None:
        extras = {key: torch.as_tensor(
            rng.normal(size=(batch_slots, seq, cfg.d_model)),
            dtype=torch.float32, device=device)}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=max_new, extras=extras)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(o) for o in outs)
    return {
        "requests": len(outs),
        "tokens": total_tokens,
        "tok_per_s": total_tokens / max(dt, 1e-9),
        "seconds": dt,
        "device": str(device),
        "outputs": [o.tolist()[:8] for o in outs[:3]],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    out = serve_demo(args.arch, smoke=args.smoke, n_requests=args.requests,
                     batch_slots=args.slots, device=args.device)
    print(f"# served {out['requests']} requests, {out['tokens']} tokens, "
          f"{out['tok_per_s']:.1f} tok/s on {out['device']}")
    print(f"# sample outputs: {out['outputs']}")


if __name__ == "__main__":
    main()
