"""Serving entry point: continuous-batched generation, the twin of
``repro.launch.serve``.

Inside a process group (one the caller has initialised, or one joined
from ``torch.distributed.run``'s environment: ``launch.mesh.host_group``)
it serves as the reference's ``serve_demo`` does, on a
``make_host_mesh(1)`` of (data, model) over the group's ranks with
``make_plan(fsdp=False)``: every rank draws the same whole weights from
the seed and keeps its part (whole, on a model axis of 1), the slots lie
over "data" (whole on every rank where they do not divide), every rank
serves the same requests and returns the same outputs, and rank 0
prints; NCCL on ``cuda`` (one card a rank), gloo on ``cpu``.  Without a
group it serves on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.serve --smoke --device cpu

``--trace PATH`` records the run's spans (``repro_torch.obs.trace``: each
``generate`` call, decode step and its parts, and request) and writes
them to PATH as a Chrome trace, to open in https://ui.perfetto.dev;
inside a group rank 0 writes PATH and rank r ``PATH.rank<r>``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import host_group, make_host_mesh
from repro_torch.models.registry import build_model, get_config
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import distribute_model, make_plan, step_layout


def serve_demo(arch: str, smoke: bool = True, n_requests: int = 12,
               batch_slots: int = 4, max_new: int = 16, max_len: int = 64,
               seed: int = 0, device=None):
    """Serve ``n_requests`` random prompts (4-11 tokens, numpy seed
    ``seed``) through ``batch_slots`` slots with greedy decoding, on a model
    whose float32 weights come from a generator seeded ``seed``.  After the
    prompts the same numpy generator draws, as the reference's, a standard
    normal ``image_embeds`` (slots, n_image_tokens, d) for vlm or encoder
    output ``enc`` (slots, encoder_seq, d) for audio, which every slot
    attends.  Inside a process group it serves over its ranks (see the
    module's docstring).  ``generated`` holds every request's tokens,
    ``outputs`` the first 8 of the first three, as the reference's."""
    device = resolve_device(device)
    with host_group(device) as rank_device:
        mesh = None
        if rank_device is not None:
            mesh = make_host_mesh(1)
            device = rank_device
        return _serve(arch, smoke, n_requests, batch_slots, max_new, max_len,
                      seed, device, mesh)


def _serve(arch, smoke, n_requests, batch_slots, max_new, max_len, seed,
           device, mesh):
    cfg = get_config(arch, smoke=smoke, dtype="float32",
                     param_dtype="float32")
    model = build_model(cfg, device=device, seed=seed)
    layout = contextlib.nullcontext()
    if mesh is not None:
        plan = make_plan(fsdp=False)
        distribute_model(model, plan, mesh)
        layout = step_layout(plan, mesh)
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
    with layout:
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
        "ranks": 1 if mesh is None else mesh.size(),
        "outputs": [o.tolist()[:8] for o in outs[:3]],
        "generated": [o.tolist() for o in outs],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve on one device, or on every rank of a process "
        "group: python -m torch.distributed.run --standalone "
        "--nproc-per-node N -m repro_torch.launch.serve [--device cpu] "
        "(NCCL on cuda, one card a rank; gloo on cpu).")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's spans to PATH as a Chrome trace "
                    "(Perfetto)")
    args = ap.parse_args(argv)
    rank = int(os.environ.get("RANK", 0))
    if args.trace:
        obs_trace.enable()
    out = serve_demo(args.arch, smoke=args.smoke, n_requests=args.requests,
                     batch_slots=args.slots, device=args.device)
    if args.trace:
        obs_trace.disable()
        path = obs_trace.save(args.trace if rank == 0
                              else f"{args.trace}.rank{rank}")
        print(f"# spans written to {path}")
    if rank == 0:
        print(f"# served {out['requests']} requests, {out['tokens']} tokens, "
              f"{out['tok_per_s']:.1f} tok/s on {out['device']} over "
              f"{out['ranks']} rank(s)")
        print(f"# sample outputs: {out['outputs']}")


if __name__ == "__main__":
    main()
