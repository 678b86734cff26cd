"""Multi-pod dry-run: prove the distribution config is coherent, the twin
of ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell this program

    1. lays the production mesh (16x16 single pod / 2x16x16 multi-pod)
       over a fake process group (``launch.mesh.production_mesh``),
    2. builds the model at full size on the ``meta`` device, drawing no
       weights, and distributes every parameter (and, to train, the AdamW
       moments) as a DTensor by the ShardingPlan,
    3. runs the cell's step (``train_step``, the prefill ``forward``, or
       ``decode_step`` over a meta cache of ``seq_len``) under
       :class:`StepCounter`, which counts rank 0's FLOPs, bytes accessed,
       collectives and live bytes,
    4. derives the roofline terms against the H100's constants
       (``launch.roofline``) and whether the step fits its HBM.

Nothing is allocated and no card is touched: the reference likewise lowers
over 512 placeholder host devices and never runs its accelerator.

The reference lowers each cell twice (layers unrolled for honest counts,
scanned for liveness) and offers ``--scan-only``.  Neither has a meaning
here: the step runs op by op in Python, so one trace counts every layer
and sees every tensor's lifetime.  ``compile_s`` in a record holds the
cell's wall: laying the mesh, distributing the parameters and tracing the
step.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k [--multi-pod] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import weakref
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, shapes_for
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import mesh_name, production_mesh
from repro_torch.models.registry import get_config, list_archs
from repro_torch.sharding import (batch_sharding, distribute_cache,
                                  distribute_model, distribute_tree,
                                  make_plan, step_layout)
from repro_torch.sharding.plan import mesh_shape_of


#: Cells whose time loops (``models/ssm.py``) trace one step at a time on
#: ``meta``: minutes each, where every other cell takes seconds.
LOOP_BOUND = {("hymba-1.5b", "train_4k"), ("hymba-1.5b", "prefill_32k"),
              ("rwkv6-3b", "train_4k"), ("rwkv6-3b", "prefill_32k")}


# ------------------------------------------------------------------ counting
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: Ops that write no data of their own.
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "detach", "lift_fresh", "wait_tensor",
            "_wrap_tensor_autograd"}


class StepCounter(TorchDispatchMode):
    """What one device (rank 0) does in a step over DTensors.

    An op on DTensors is let through (``NotImplemented``) so that DTensor
    runs it: it then issues the op on rank 0's local shards and any
    collective its layouts need, and those come back here as plain ops.
    So each op is counted where it runs, on the local shapes: an op whose
    output is ``Shard`` or ``Partial`` over some mesh axes does the global
    work divided by the product of those axes' sizes, and one that is
    ``Replicate`` over an axis repeats the work on every device of it.

    * ``flops``: ``torch.utils.flop_counter``'s count of each op;
    * ``bytes``: each op's tensor inputs and outputs, views and
      collectives aside (a proxy of HBM traffic: no fusion is assumed);
    * ``collective_bytes`` / ``collective_counts`` by the reference's
      kind names, a collective's bytes being its operand's;
    * ``peak_bytes``: the most bytes that storages created in the step
      held at once, each tracked by weak reference until it is freed (an
      op writing in place, or into ``out=``, creates none).

    DTensor's own sharding propagation runs ops on fake tensors (whose
    kernels run on ``meta`` with the meta key in the thread's dispatch
    set) to learn output shapes, and on small host tensors to learn shard
    sizes: those are not counted (the step's own tensors all live on
    ``meta``).
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = {k: 0 for k in rl.COLLECTIVES}
        self.collective_counts = {k: 0 for k in rl.COLLECTIVES}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}

    def _free(self, key, nbytes):
        self._live.pop(key, None)
        self.live_bytes -= nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if (any(issubclass(t, FakeTensor) for t in types)
                or torch._C._meta_in_tls_dispatch_include()):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        first = out[0] if isinstance(out, (list, tuple)) and out else out
        if isinstance(first, torch.Tensor) and first.device.type != "meta":
            return out      # DTensor's bookkeeping on host tensors
        self.n_ops += 1
        name = func._schema.name.split("::")[-1]
        kind = rl.collective_kind(name)
        if kind is not None:
            operand = next(_tensors((args, kwargs)))
            self.collective_bytes[kind] += _nbytes(operand)
            self.collective_counts[kind] += 1
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if func.is_view or name in _NO_DATA:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if not func._schema.is_mutable:     # in place: no new storage
            self._track(out)
        return out


def local_bytes(tree) -> int:
    """Bytes that rank 0 holds of a tree of (DTensor or plain) tensors."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if isinstance(t, DTensor) else t)
    return total


# --------------------------------------------------------------------- specs
def input_specs(arch: str, shape_name: str,
                cfg=None) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of a cell."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    return make_batch_specs(cfg, shape.seq_len, shape.global_batch, shape.kind)


def count_params(named: Mapping[str, torch.Tensor]) -> int:
    return int(sum(math.prod(t.shape) for t in named.values()))


def active_params(cfg, total: int) -> float:
    """MoE: only top-k routed experts are active per token."""
    if cfg.n_experts == 0:
        return float(total)
    routed = (cfg.n_layers * cfg.n_experts * 3
              * cfg.d_model * cfg.resolved_moe_d_ff)
    frac = cfg.n_experts_per_token / cfg.n_experts
    return float(total - routed + routed * frac)


# ---------------------------------------------------------------------- cell
def _trace(model, cfg, shape, plan, mesh, batch_shardable, opt_kw):
    """Run the cell's step over DTensors under a :class:`StepCounter`;
    returns (counter, argument bytes, parameter count, model FLOPs)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainStepBuilder

    distribute_model(model, plan, mesh)
    params = dict(model.named_parameters())
    n_params = count_params(params)
    batch = input_specs(cfg.name, shape.name, cfg)
    batch = distribute_tree(
        batch, batch_sharding(batch, plan, mesh, batch_shardable), mesh)
    if shape.kind == "decode":
        # Laid out here, by the dry-run's batch_shardable: a cache made
        # under the layout would shard its rows wherever they divide.
        cache = distribute_cache(
            model.init_cache(shape.global_batch, shape.seq_len), mesh,
            plan.activation_rules, batch_shardable)
    counter = StepCounter()
    with step_layout(plan, mesh):
        if shape.kind == "train":
            builder = TrainStepBuilder(model, AdamWConfig(**(opt_kw or {})))
            state = builder.fresh_state()   # moments laid out as the weights
            args = (state, batch)
            with counter:
                out = builder.train_step(state, batch)
            tokens = shape.global_batch * shape.seq_len
            mflops = rl.model_flops(active_params(cfg, n_params), tokens,
                                    "train")
        elif shape.kind == "prefill":
            args = (params, batch)
            with torch.no_grad(), counter:
                out = model(batch)[0]
            tokens = shape.global_batch * shape.seq_len
            mflops = rl.model_flops(active_params(cfg, n_params), tokens,
                                    "inference")
        else:
            args = (params, cache, batch["tokens"])
            with torch.no_grad(), counter:
                out = model.decode_step(cache, batch["tokens"])
            mflops = rl.model_flops(active_params(cfg, n_params),
                                    shape.global_batch, "inference")
    del out
    return counter, local_bytes(args), n_params, mflops


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    overrides: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
    fsdp: bool = True,
    rules_override: Optional[Dict[str, Any]] = None,
    opt_kw: Optional[Dict[str, Any]] = None,
    smoke: bool = False,
    mesh_shape: Optional[Tuple[int, ...]] = None,
) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) cell; return its roofline record.

    ``smoke`` takes the arch's smoke config and ``mesh_shape`` resizes the
    production mesh's axes (both for tests: a (2, 2) mesh traces in
    seconds).

    Training cells recompute every block in the backward pass
    (``remat="full"``), MoE archs dispatch expert-parallel
    (``moe_dispatch="shard_map"``), as the reference's dry-run.
    ``bytes_per_device`` is rank 0's local bytes of the step's arguments
    plus the peak of its live intermediates (see :class:`StepCounter`);
    allocator slack and fragmentation are not in it.
    """
    from repro_torch.models.transformer import Model

    shape = SHAPES[shape_name]
    overrides = dict(overrides or {})
    if shape.kind == "train":
        overrides.setdefault("remat", "full")
    cfg = get_config(arch, smoke=smoke, **overrides)
    if cfg.n_experts > 0:
        overrides.setdefault("moe_dispatch", "shard_map")
        cfg = get_config(arch, smoke=smoke, **overrides)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        raise ValueError(f"{arch} is full-attention; long_500k is skipped")

    t0 = time.time()
    with production_mesh(multi_pod, mesh_shape) as mesh:
        n_dev = mesh.size()
        name = "x".join(map(str, mesh.shape))
        data_axes = ("pod", "data") if multi_pod else ("data",)
        batch_shardable = shape.global_batch >= math.prod(
            mesh_shape_of(mesh)[a] for a in data_axes)
        shard_kv_seq = (shape.kind == "decode") and not batch_shardable
        plan = make_plan(multi_pod=multi_pod, fsdp=fsdp,
                         shard_kv_seq=shard_kv_seq)
        if rules_override:
            import dataclasses

            rules = dict(plan.activation_rules)
            rules.update(rules_override)
            plan = dataclasses.replace(plan, activation_rules=rules)
        model = Model(cfg, device="meta")
        counter, arg_bytes, n_params, mflops = _trace(
            model, cfg, shape, plan, mesh, batch_shardable, opt_kw)
        del model
    compile_s = time.time() - t0

    terms = rl.terms_from_counts(
        arch, shape_name, name, n_dev, counter.flops,
        counter.bytes, counter.collective_bytes, mflops,
        bytes_per_device=float(arg_bytes + counter.peak_bytes))
    record = terms.as_dict()
    record.update(
        compile_s=compile_s,
        n_params=n_params,
        fits_hbm=bool(terms.bytes_per_device <= rl.HBM_BYTES),
        collective_counts=dict(counter.collective_counts),
        overrides=overrides,
        fsdp=fsdp,
        rules_override=rules_override or {},
        opt_kw=opt_kw or {},
    )
    if verbose:
        print(f"== {arch} x {shape_name} on {terms.mesh} ==")
        print(f"  traced: {counter.n_ops} ops, flops={counter.flops:.3e} "
              f"bytes={counter.bytes:.3e}; arguments {arg_bytes / 2**30:.2f} "
              f"GiB, peak of intermediates {counter.peak_bytes / 2**30:.2f} "
              f"GiB")
        print(f"  collective bytes/dev: {terms.collective_bytes:.3e} "
              f"{record['collective_counts']}")
        print(f"  terms: compute={terms.compute_s:.4f}s "
              f"memory={terms.memory_s:.4f}s "
              f"collective={terms.collective_s:.4f}s "
              f"-> dominant={terms.dominant}")
        print(f"  useful_flops_ratio={terms.useful_flops_ratio:.3f} "
              f"roofline_fraction={terms.roofline_fraction:.3f} "
              f"bytes/dev={terms.bytes_per_device / 2**30:.2f}GiB "
              f"fits_hbm={record['fits_hbm']} wall={compile_s:.1f}s")
    return record


def _cell_task(arch: str, shape: str, multi_pod: bool, kw: Dict):
    """One cell for :func:`run_cells`: ("ok", record), ("skip", why) or
    ("fail", why), with the cell's wall."""
    t0 = time.time()
    try:
        out = ("ok", run_cell(arch, shape, multi_pod=multi_pod, verbose=False,
                              **kw))
    except ValueError as e:
        out = ("skip", str(e))
    except Exception as e:  # a cell's failure is reported, not raised
        import traceback

        where = [f"{f.filename.rsplit('/src/', 1)[-1]}:{f.lineno}"
                 for f in traceback.extract_tb(e.__traceback__)
                 if "repro_torch" in f.filename]
        first = str(e).splitlines()[0] if str(e) else ""
        out = ("fail", f"{type(e).__name__}: {first} (at {where[-1:]})")
    return out + (time.time() - t0,)


def run_cells(cells, multi_pod: bool = False, jobs: int = 1, **kw):
    """(arch, shape, status, record or reason, wall) for each cell, in
    order; a cell is (arch, shape) or (arch, shape, multi_pod).  With
    ``jobs`` > 1 the cells run in that many fresh (spawned) processes at
    once, each with its own fake process group."""
    cells = [tuple(c) + (multi_pod,) * (3 - len(c)) for c in cells]
    if jobs <= 1:
        return [(a, s) + _cell_task(a, s, mp, kw) for a, s, mp in cells]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_cell_task, a, s, mp, kw)
                   for a, s, mp in cells]
        return [(a, s) + f.result()
                for (a, s, _), f in zip(cells, futures)]


def all_cells(multi_pod: bool):
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            yield arch, shape.name


def _cache_path(args, arch: str, shape: str) -> Optional[str]:
    if not args.cache_dir:
        return None
    os.makedirs(args.cache_dir, exist_ok=True)
    fname = f"{arch}__{shape}__{mesh_name(args.multi_pod)}.json"
    return os.path.join(args.cache_dir, fname.replace("/", "_"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--cache-dir", type=str, default=None,
                    help="write/read per-cell JSON records here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in all_cells(args.multi_pod):
            print(arch, shape)
        return

    overrides: Dict[str, Any] = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    records = []
    cells = (list(all_cells(args.multi_pod)) if args.all
             else [(args.arch, args.shape)])
    todo = []
    for arch, shape in cells:
        path = _cache_path(args, arch, shape)
        if path and os.path.exists(path):
            with open(path) as f:
                records.append(json.load(f))
            print(f"CACHED {arch} x {shape}")
        else:
            todo.append((arch, shape))
    for arch, shape, status, rec, wall in run_cells(
            todo, args.multi_pod, args.jobs, overrides=dict(overrides),
            fsdp=not args.no_fsdp):
        if status == "skip":
            print(f"SKIP {arch} x {shape}: {rec}")
            continue
        if status == "fail":
            print(f"FAIL {arch} x {shape}: {rec}")
            continue
        print(f"OK {arch} x {shape} on {rec['mesh']}: wall {wall:.1f} s, "
              f"dominant {rec['dominant']}, useful "
              f"{rec['useful_flops_ratio']:.3f}, "
              f"{rec['bytes_per_device'] / 2**30:.2f} GiB/dev", flush=True)
        records.append(rec)
        path = _cache_path(args, arch, shape)
        if path:
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(records, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
