"""Rank bodies for ``tests/test_torch_train_mesh.py``.

Each function here runs in a process that ``torch.multiprocessing.spawn``
starts, as one rank of a gloo process group over localhost.  The module
imports torch, numpy and the port alone, so a rank starts without JAX.
"""

import contextlib
import json
import socket
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Killed(Exception):
    """Raised by a run's checkpoint manager right after its first save."""


def spawn(fn, world: int, *args, join: bool = True):
    """``fn(rank, world, port, *args)`` on ``world`` gloo ranks; with
    ``join`` false, started and returned (``torch.multiprocessing``'s
    process context) without waiting."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return mp.spawn(fn, args=(world, port) + args, nprocs=world, join=join)


def join_all(contexts) -> None:
    """Wait for every rank of each started :func:`spawn`, raising as
    ``spawn`` does; on a failure the ranks still running are ended."""
    try:
        for ctx in contexts:
            while not ctx.join():
                pass
    finally:
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()


@contextlib.contextmanager
def gloo(rank: int, world: int, port: int):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def killed_after_first_save():
    """The run's checkpoint manager raises :class:`Killed` right after its
    first save (every rank, past the save's barrier)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    save = CheckpointManager.save

    def dying(self, step, tree, meta=None):
        save(self, step, tree, meta)
        raise Killed(step)

    CheckpointManager.save = dying
    try:
        yield
    except Killed:
        pass
    finally:
        CheckpointManager.save = save


def train_rank(rank, world, port, arch, model_parallel, kw, out, kill=False):
    """``launch.train.train`` on this rank; rank 0 writes its result to
    ``out``.  Every batch the step receives is checked: this rank's rows
    of the global batch as ``SyntheticLM.global_batch_at`` gives them,
    sharded over "data" (the same rows on each rank of a "model" group),
    and the whole DTensor equal to the global batch."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.models.registry import get_config
    from repro_torch.train.step import TrainStepBuilder

    cfg = get_config(arch, smoke=kw.get("smoke", True),
                     **kw.get("overrides", {}))
    data = SyntheticLM(cfg.vocab_size, kw["seq"], kw["batch"], seed=0)
    per = kw["batch"] // (world // model_parallel)
    lo = (rank // model_parallel) * per
    seen = []
    step = TrainStepBuilder.train_step

    def checked(builder, state, batch):
        want = data.global_batch_at(int(state["step"]))
        for k, v in batch.items():
            assert v.shape == want[k].shape, k
            np.testing.assert_array_equal(v.to_local().numpy(),
                                          want[k][lo:lo + per], err_msg=k)
            np.testing.assert_array_equal(v.full_tensor().numpy(), want[k],
                                          err_msg=k)
        seen.append(int(state["step"]))
        return step(builder, state, batch)

    killed = killed_after_first_save if kill else contextlib.nullcontext
    TrainStepBuilder.train_step = checked
    try:
        with gloo(rank, world, port), killed():
            res = train_mod.train(arch, model_parallel=model_parallel, **kw)
            if rank == 0:
                with open(out, "w") as f:
                    json.dump(res, f)
    finally:
        TrainStepBuilder.train_step = step
    assert seen, "no step ran"


def _grads_plain_and_sharded(loss_of, tensors, placements, mesh):
    """Gradients of ``loss_of(*tensors)`` with respect to its float
    tensors, on plain tensors and on DTensors laid out by ``placements``
    (one list a tensor; integer tensors are laid out and take no
    gradient); returns both lists, the DTensor ones gathered whole."""
    from torch.distributed.tensor import distribute_tensor

    def run(ts):
        leaves = [t.requires_grad_(True) for t in ts if t.is_floating_point()]
        return torch.autograd.grad(loss_of(*ts), leaves)

    want = run([t.clone() for t in tensors])
    got = run([distribute_tensor(t, mesh, pl, src_data_rank=None)
               for t, pl in zip(tensors, placements)])
    return want, [t.full_tensor() for t in got]


def helpers_rank(rank, world, port):
    """The sharding helpers' gradients on a (2, 2) mesh with real data,
    each against the same function on plain tensors, float32, within 1e-5
    of the gradient's largest |value| (the ranks sum in another order):
    ``lookup``'s table, ``batch_local``'s shared tensor (summed over the
    ranks that split the rows), hymba's Mamba block (a ``batch_local``
    time loop whose inputs' gradient comes back transposed), and the
    expert-parallel moe dispatch's router, experts and tokens against the
    scatter dispatch at a capacity that drops no token."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import moe, ssm
    from repro_torch.models.registry import get_config
    from repro_torch.sharding import (axis_rules, batch_local, lookup,
                                      make_plan, param_partition_specs,
                                      placements_for)

    with gloo(rank, world, port):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(23)
        rows, whole = [Shard(0), Replicate()], [Replicate(), Replicate()]
        by_model = [Replicate(), Shard(0)]

        def randn(*shape):
            return torch.randn(*shape, generator=g)

        cases = {
            "lookup": (
                lambda table, v, ids: (lookup(table, ids) * v).sum(),
                [randn(12, 8), randn(4, 5, 8),
                 torch.randint(0, 12, (4, 5), generator=g)],
                [by_model, rows, rows]),
            "batch_local shared": (
                lambda x, a: batch_local(lambda x, a: x * a, (x,), (a,))
                .square().sum(), [randn(4, 6, 8), randn(8)], [rows, whole]),
        }
        # hymba's Mamba block: its time loop runs on each rank's rows,
        # time-major, so the gradient of its inputs comes back transposed.
        hcfg = get_config("hymba-1.5b", smoke=True, dtype="float32",
                          param_dtype="float32")
        block = ssm.Mamba(hcfg, device="cpu")
        block.reset_parameters(g)
        pnames = [n for n, _ in block.named_parameters()]
        specs = param_partition_specs(
            {f"blocks.0.ssm.{n}": p for n, p in block.named_parameters()},
            make_plan(fsdp=False), mesh)

        def mamba_loss(*t):
            params = SimpleNamespace(**dict(zip(pnames, t[:-1])))
            return ssm.mamba_forward(params, t[-1], hcfg).square().sum()

        cases["mamba"] = (
            mamba_loss, [p.detach().clone() for p in block.parameters()]
            + [randn(4, 6, hcfg.d_model)],
            [placements_for(specs[f"blocks.0.ssm.{n}"], mesh) for n in pnames]
            + [rows])
        cfg = get_config("qwen2-moe-a2.7b", smoke=True, capacity_factor=8.0)
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
        names = ("router", "experts_wi", "experts_wi_gate", "experts_wo")
        y_w = randn(16, d)

        def moe_loss(*t):
            p = SimpleNamespace(**dict(zip(names, t[:4])))
            dispatch = (moe._dispatch_shard_map if hasattr(t[4], "placements")
                        else moe._dispatch_scatter)
            y, probs = dispatch(p, t[4], cfg)
            return (y.float() * y_w).sum() + probs.square().sum()

        cases["shard_map"] = (
            moe_loss, [randn(d, e) * d ** -0.5, randn(e, d, ff) * d ** -0.5,
                       randn(e, d, ff) * d ** -0.5,
                       randn(e, ff, d) * ff ** -0.5, randn(16, d)],
            [whole, by_model, by_model, by_model, rows])
        with axis_rules(make_plan(fsdp=False).activation_rules, mesh), \
                implicit_replication():
            for name, (fn, tensors, pls) in cases.items():
                want, got = _grads_plain_and_sharded(fn, tensors, pls, mesh)
                for i, (gw, gg) in enumerate(zip(want, got)):
                    err = float((gg - gw).abs().max() / gw.abs().max())
                    assert err <= 1e-5, f"{name} gradient {i}: {err:.3e}"


# ------------------------------------------------------------------ serving
#: Cross blocks' gate in the serving checks: at its initial 0,
#: ``tanh(0)`` hides the cross-attention from every output.
GATE = 0.5
#: The serving checks' slots, cache length, requests, new tokens, and the
#: manual decode run's steps and the step after which slot 1 is reset (the
#: smoke configs' 16-slot rings wrap).
SLOTS, MAX_LEN, REQUESTS, NEW_TOKENS = 4, 32, 7, 5
STEPS, RESET_AFTER = 20, 8


def serve_model(arch, seed=0, npz=None):
    """The smoke config of ``arch`` in float32 with ``attention_impl=
    "kernel"`` (the prefill through the flash wrapper), on the CPU: weights
    drawn from ``seed``, or the reference's tree in ``npz`` (keys joined by
    "/") carried across by ``convert``; every cross block's gate at
    :data:`GATE`."""
    from repro_torch import convert
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config(arch, smoke=True, dtype="float32", param_dtype="float32",
                     attention_impl="kernel")
    if npz is None:
        model = build_model(cfg, device="cpu", seed=seed)
    else:
        tree = {}
        with np.load(npz) as f:
            for key in f.files:
                *path, leaf = key.split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = f[key]
        model = convert.model_params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                p.fill_(GATE)
    return model


def serve_inputs(cfg, seed=0):
    """Prompts of 2-9 tokens, the decode run's tokens, the decode cache's
    extras (vlm ``image_embeds``, audio ``enc``) and a prefill batch of
    (SLOTS, 12) tokens with its embeddings, all from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(2, 10))
               .astype(np.int32) for _ in range(REQUESTS)]
    steps = rng.integers(0, cfg.vocab_size, (STEPS, SLOTS, 1)).astype(np.int32)
    extras, batch = None, {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SLOTS, 12)).astype(np.int32))}
    key, seq = {"vlm": ("image_embeds", cfg.n_image_tokens),
                "audio": ("enc", cfg.encoder_seq)}.get(cfg.family, (None, 0))
    if key is not None:
        extras = {key: torch.as_tensor(
            rng.normal(size=(SLOTS, seq, cfg.d_model)), dtype=torch.float32)}
        batch["audio_frames" if key == "enc" else key] = torch.as_tensor(
            rng.normal(size=(SLOTS, seq, cfg.d_model)), dtype=torch.float32)
    return prompts, steps, extras, batch


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rel(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _greedy_gap(model):
    """Wrap ``model.decode_step``: the least gap between the top two
    logits of a step, over the largest |logit|, kept in the returned
    list's one entry."""
    from repro_torch.sharding import whole

    least, step = [np.inf], model.decode_step

    def recorded(cache, tokens):
        logits, cache = step(cache, tokens)
        last = whole(logits[:, -1])
        top2 = torch.topk(last, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / last.abs().max()
        least[0] = min(least[0], float(gap.min()))
        return logits, cache

    model.decode_step = recorded
    return least


def serve_case(arch, mesh, plan, seed=0, npz=None):
    """One family's serving checks over ``mesh``, each against the same
    calls on a one-process model holding the same weights; returns the
    readings (nothing is asserted here: the test does)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import (cache_sharding, current_rules,
                                      distribute_model, placements_for,
                                      step_layout, whole)

    plain = serve_model(arch, seed, npz)
    sharded = serve_model(arch, seed, npz)
    distribute_model(sharded, plan, mesh)
    cfg = plain.cfg
    prompts, steps, extras, batch = serve_inputs(cfg, seed)
    one = ServeEngine(plain, max_len=MAX_LEN, batch_size=SLOTS)
    eng = ServeEngine(sharded, max_len=MAX_LEN, batch_size=SLOTS)
    out = {}
    with step_layout(plan, mesh):
        gap = _greedy_gap(sharded)
        got = eng.generate(prompts, NEW_TOKENS, extras=extras)
        del sharded.decode_step
    want = one.generate(prompts, NEW_TOKENS, extras=extras)
    out["tokens"] = [g.tolist() for g in got]
    out["want_tokens"] = [w.tolist() for w in want]
    out["gap"] = gap[0]

    # Sampled tokens: each side's generator seeded alike.
    with step_layout(plan, mesh):
        got = eng.generate(prompts, NEW_TOKENS, greedy=False, extras=extras,
                           generator=torch.Generator().manual_seed(7))
    want = one.generate(prompts, NEW_TOKENS, greedy=False, extras=extras,
                        generator=torch.Generator().manual_seed(7))
    out["sampled_equal"] = all(np.array_equal(a, b) for a, b in
                               zip(got, want))

    # Decode steps by hand, slot 1 reset midway: logits each step, every
    # state after, and the cache's own tensors written in place.
    logit_err, own, laid_out = 0.0, True, True
    cache_p = plain.init_cache(SLOTS, MAX_LEN, extras=extras)
    with step_layout(plan, mesh):
        cache = sharded.init_cache(SLOTS, MAX_LEN, extras=extras)
        specs = cache_sharding(cache, current_rules(), mesh)
        for i, toks in enumerate(steps):
            before = dict(_leaves(cache))
            logits, cache = eng.serve_step(cache, eng._tokens(toks))
            lp, cache_p = one.serve_step(cache_p, torch.as_tensor(toks))
            logit_err = max(logit_err, _rel(whole(logits), lp))
            for k, v in _leaves(cache):
                if k != "pos":
                    own &= v is before[k]
            if i == RESET_AFTER:
                mask = np.arange(SLOTS) == 1
                cache = eng.reset_slots(cache, mask)
                cache_p = one.reset_slots(cache_p, mask)
        spec = dict(_leaves(specs))
        for k, v in _leaves(cache):
            laid_out &= list(v.placements) == placements_for(spec[k], mesh)
        states = {k: whole(v) for k, v in _leaves(cache)}
    want_states = dict(_leaves(cache_p))
    out["logit_err"] = logit_err
    out["state_err"] = max((_rel(states[k], v), k) for k, v in
                           want_states.items() if v.abs().max() > 0)
    out["pos_equal"] = bool(torch.equal(states["pos"], want_states["pos"]))
    out["own_tensors"], out["laid_out"] = own, laid_out

    # The flash prefill: the wrapper sees plain tensors alone (it refuses
    # DTensors), once a self block (and an encoder block).
    calls = []
    flash = fa_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(type(q).__name__)
        return flash(q, k, v, **kw)

    fa_ops.flash_attention = counted
    try:
        with step_layout(plan, mesh):
            logits = whole(eng.prefill(batch))
    finally:
        fa_ops.flash_attention = flash
    out["prefill_err"] = _rel(logits, one.prefill(batch))
    # The sequential prefill through decode steps.
    with step_layout(plan, mesh):
        logits, cache = eng.prefill_into_cache(batch["tokens"], extras)
        logits, pos = whole(logits), whole(cache["pos"])
    want, cache_p = one.prefill_into_cache(batch["tokens"], extras)
    out["prefill_cache_err"] = _rel(logits, want)
    out["prefill_cache_pos"] = bool(torch.equal(pos, cache_p["pos"]))
    out["flash_calls"] = calls
    out["self_blocks"] = (len(plain.blocks)
                          + len(getattr(plain, "encoder", ())))
    out["attention_free"] = cfg.family == "ssm"
    return out


def plain_ids_rank(rank, world, port, out_dir):
    """``lookup`` and ``put_rows`` with plain ids and indices (the whole
    batch, the same on every rank) against a table and a cache laid out
    over a (``world``, 1) mesh, each against the plain call; writes the
    readings to ``rank<r>.json`` in ``out_dir``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.sharding import axis_rules, lookup, make_plan, put_rows

    g = torch.Generator().manual_seed(24)
    table = torch.randn(12, 8, generator=g)
    ids = torch.randint(0, 12, (4, 3), generator=g)
    cache = torch.randn(4, 6, 3, generator=g)
    idx = torch.tensor([5, 0, 2, 7])         # 7 is past the cache: no write
    vals = torch.randn(4, 3, generator=g)
    keep = torch.tensor([True, True, False, True])
    out = {}
    with gloo(rank, world, port):
        mesh = init_device_mesh("cpu", (world, 1),
                                mesh_dim_names=("data", "model"))
        with axis_rules(make_plan(fsdp=False).activation_rules, mesh):
            got = lookup(distribute_tensor(table, mesh,
                                           [Replicate(), Shard(0)],
                                           src_data_rank=None), ids)
            out["lookup_shape"] = list(got.shape)
            out["lookup_equal"] = (tuple(got.shape) == tuple(ids.shape) + (8,)
                                   and bool(torch.equal(got.full_tensor(),
                                                        table[ids])))
            laid = distribute_tensor(cache, mesh, [Shard(0), Replicate()],
                                     src_data_rank=None)
            want = cache.clone()
            for k in (idx < 6, keep):
                put_rows(laid, idx.clamp(max=5), vals, keep=k)
                put_rows(want, idx.clamp(max=5), vals, keep=k)
                out.setdefault("put_rows_equal", []).append(
                    bool(torch.equal(laid.full_tensor(), want)))
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def refusals(mesh):
    """The messages of the flash wrapper and of a kernel's input check
    handed a DTensor ("" where one did not refuse it)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels._build import check_inputs
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q = distribute_tensor(torch.zeros(2, 4, 2, 8), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    out = []
    for fn in (lambda: fa_ops.flash_attention(q, q, q),
               lambda: check_inputs("kernel", (torch.float32,), q=q)):
        try:
            fn()
            out.append("")
        except TypeError as e:
            out.append(str(e))
    return out


def serve_rank(rank, world, port, cases, ref, out_dir):
    """The serving checks on one of ``world`` gloo ranks over
    ``make_host_mesh(1)`` with ``make_plan(fsdp=False)``: every family of
    ``cases`` ({name: (arch, seed)}), ``serve_demo`` joined to the group,
    with ``ref`` (the reference's weights as an ``.npz`` file, and the
    arch) the dense model on the reference's weights, and a DTensor handed
    to the flash wrapper and a kernel's input check.  Writes
    ``rank<r>.json`` in ``out_dir``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_demo
    from repro_torch.sharding import make_plan

    with gloo(rank, world, port):
        mesh = make_host_mesh(1)
        plan = make_plan(fsdp=False)
        out = {name: serve_case(arch, mesh, plan, seed)
               for name, (arch, seed) in cases.items()}
        demo = serve_demo("qwen1.5-0.5b", smoke=True, device="cpu")
        out["serve_demo"] = {"generated": demo["generated"],
                             "ranks": demo["ranks"]}
        if ref is not None:
            npz, arch = ref
            out["reference"] = serve_case(arch, mesh, plan, npz=npz)
        out["refused"] = refusals(mesh)
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
