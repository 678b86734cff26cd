"""``repro_torch.sharding`` and ``repro_torch.launch.mesh`` against the
reference's ``repro.sharding`` and ``repro.launch.dryrun``.

Specs are compared entry for entry (a port spec is a tuple, the
reference's a ``PartitionSpec``, which writes a one-axis tuple as the
axis name; both padded with ``None`` to the tensor's rank).  A port parameter has no layer axis: its spec is the
reference's at the mapped path (``blocks.3.attn.wq`` -> ``blocks/attn/wq``)
less that path's leading layer entry, which must be ``None``.  The
reference's trees come from ``jax.eval_shape``; specs need no devices, so
a mesh is only its {axis: size} here.
"""

import itertools
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.sharding import plan as jplan  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,  # noqa: E402
                                     production_mesh)
from repro_torch.models.registry import get_config, list_archs  # noqa: E402
from repro_torch.models.transformer import STACKED, Model  # noqa: E402
from repro_torch.sharding import ctx, layout, plan  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _norm(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry


def _entries(spec, ndim):
    spec = tuple(_norm(e) for e in spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported without leaving its
    512-device ``XLA_FLAGS`` in this process's environment."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


RULE_SETS = [jplan.default_activation_rules(mp, fsdp=f, shard_kv_seq=kv)
             for mp, f, kv in itertools.product((False, True), repeat=3)]
LOGICAL = [("batch", None, "embed"), ("batch", None, "heads", None),
           ("param_vocab", "param_embed"), ("batch", "kv_seq", "kv_heads", None),
           ("experts", "param_embed", None), ("batch", "batch", "mlp"),
           (None, "mlp", "param_embed"), ("seq", "vocab")]


@pytest.mark.parametrize("rules", RULE_SETS, ids=lambda r: str(r["batch"]))
def test_logical_to_mesh_and_sanitize_match(rules):
    rules = dict(rules, tup=("model",), pair=("data", "model"))
    for names in LOGICAL + [("tup", None), ("pair", "tup")]:
        want = jctx.logical_to_mesh(names, rules)
        got = ctx.logical_to_mesh(names, rules)
        assert _entries(got, 0) == _entries(want, 0), names
        for shape in [(16,) * len(names), (24, 8, 32, 2)[:len(names)],
                      (512, 1, 60, 4096)[:len(names)]]:
            if len(shape) != len(names):
                continue
            for ms in MESHES.values():
                w = jplan.sanitize_spec(want, shape, ms)
                assert (_entries(plan.sanitize_spec(got, shape, ms), 0)
                        == _entries(w, 0))


def _reference_specs(arch, multi_pod):
    jcfg = jget(arch)
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    fake_mesh = SimpleNamespace(shape=MESHES["2x16x16" if multi_pod
                                             else "16x16"])
    specs = jplan.param_partition_specs(shapes, jplan.make_plan(multi_pod),
                                        fake_mesh)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    out = {}
    for path, spec in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = (tuple(spec), len(leaves[path].shape))
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_at_full_size(arch, multi_pod):
    want = _reference_specs(arch, multi_pod)
    model = Model(get_config(arch), "meta")
    mesh = MESHES["2x16x16" if multi_pod else "16x16"]
    got = plan.param_partition_specs(model.named_parameters(),
                                     plan.make_plan(multi_pod), mesh)
    seen = set()
    for name, p in model.named_parameters():
        path = plan.reference_path(name)
        ref, ref_ndim = want[path]
        seen.add(path)
        ref = _entries(ref, ref_ndim)
        if name.split(".")[0] in STACKED:
            assert ref[0] is None, path
            ref = ref[1:]
        assert _entries(got[name], p.dim()) == ref, name
    assert seen == set(want)


@pytest.mark.parametrize("arch,shape_name", [
    (a, s) for a in ("qwen1.5-0.5b", "starcoder2-3b", "hymba-1.5b",
                     "rwkv6-3b", "llama-3.2-vision-11b", "whisper-large-v3")
    for s in ("decode_32k", "long_500k")
    if s == "decode_32k" or a in ("hymba-1.5b", "rwkv6-3b")])
def test_cache_specs_match(jdry, monkeypatch, arch, shape_name):
    from repro_torch.configs import SHAPES

    cfg = get_config(arch)

    shape = SHAPES[shape_name]
    ms = MESHES["16x16"]
    shardable = shape.global_batch >= ms["data"]
    jp = jplan.make_plan(shard_kv_seq=not shardable)
    monkeypatch.setattr(jdry, "NamedSharding", lambda mesh, spec: spec)
    jcache = jax.eval_shape(lambda: jbuild(jget(arch)).init_cache(
        shape.global_batch, shape.seq_len))
    want = jdry._cache_sharding(jcache, jp, SimpleNamespace(shape=ms),
                                shardable)
    cache = Model(cfg, "meta").init_cache(shape.global_batch, shape.seq_len)
    got = layout.cache_sharding(cache, plan.make_plan(
        shard_kv_seq=not shardable).activation_rules, ms, shardable)

    def walk(g, w, t):
        assert set(g) == set(w)
        for k in g:
            if isinstance(g[k], dict):
                walk(g[k], w[k], t[k])
            else:
                nd = t[k].dim()
                assert _entries(g[k], nd) == _entries(w[k], nd), k

    walk(got, want, cache)


def test_shard_is_a_no_op_without_rules():
    x = torch.zeros(2, 3, 4)
    assert ctx.shard(x, "batch", None, "embed") is x
    with ctx.axis_rules(plan.default_activation_rules(False)):
        assert ctx.shard(x, "batch", None, "embed") is x   # no mesh
        with pytest.raises(ValueError, match="rank mismatch"):
            ctx.shard(x, "batch", None)
    assert ctx.current_rules() == {}


def test_placements_follow_the_spec():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert ctx.placements_for((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert ctx.placements_for((None, None), mesh) == [Replicate()] * 3


def test_meshes_and_the_fake_group_is_gone():
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="production_mesh"):
        make_production_mesh()
    for multi_pod, names, sizes in ((False, ("data", "model"), (16, 16)),
                                    (True, ("pod", "data", "model"),
                                     (2, 16, 16))):
        with production_mesh(multi_pod) as mesh:
            assert dist.get_world_size() == mesh.size() == 256 * (1 + multi_pod)
            assert mesh.mesh_dim_names == names
            assert tuple(mesh.shape) == sizes
        assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with production_mesh():
            1 / 0
    assert not dist.is_initialized()


def _sharded_loss_rank(rank: int, port: int) -> None:
    """One of four gloo ranks of ``test_sharded_loss_matches_the_plain``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.step import cross_entropy

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(22)
        x = torch.randn(4, 6, 50, generator=g)
        labels = torch.randint(0, 50, (4, 6), generator=g)
        xp = x.clone().requires_grad_(True)
        want, _ = cross_entropy(xp, labels)
        want_grad, = torch.autograd.grad(want, xp)
        xd = distribute_tensor(x, mesh, [Shard(0), Shard(2)]
                               ).requires_grad_(True)
        ld = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
        with ctx.axis_rules(plan.make_plan().activation_rules, mesh), \
                implicit_replication():
            got, _ = cross_entropy(xd, ld)
            grad, = torch.autograd.grad(got, xd)
            got, full_grad = got.full_tensor(), grad.full_tensor()
        assert tuple(grad.placements) == (Shard(0), Shard(2))
        torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0)
        torch.testing.assert_close(full_grad, want_grad, rtol=0, atol=1e-7)
    finally:
        dist.destroy_process_group()


def test_sharded_loss_matches_the_plain():
    """The loss over logits split by rows ("data") and by the vocabulary
    ("model") on four gloo ranks, a (2, 2) mesh with real data: the loss
    and its gradient equal the plain ones (float32, loss within 1e-6
    relative, gradient within 1e-7), and the gradient keeps the logits'
    layout."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_sharded_loss_rank, args=(port,), nprocs=4)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def plain_ids(tmp_path_factory):
    """Each of two gloo ranks' readings of ``torch_mesh_ranks.
    plain_ids_rank`` on a (2, 1) mesh."""
    import json

    import torch_mesh_ranks as ranks

    out = tmp_path_factory.mktemp("plain_ids")
    ranks.spawn(ranks.plain_ids_rank, 2, str(out))
    assert not dist.is_initialized()
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_lookup_takes_plain_ids_as_the_whole_batch(plain_ids):
    """Plain (4, 3) ids over a table laid out on a (2, 1) mesh: a (4, 3, 8)
    DTensor equal to ``table[ids]`` (the ids once counted as each rank's
    rows, a global batch of 8)."""
    for r in plain_ids:
        assert r["lookup_shape"] == [4, 3, 8]
        assert r["lookup_equal"]


def test_put_rows_takes_a_plain_index_as_the_whole_batch(plain_ids):
    """A plain index, values and ``keep`` written into a cache whose rows
    lie over the (2, 1) mesh: the cache equals the plain write, with an
    index past the cache and a row kept out."""
    for r in plain_ids:
        assert r["put_rows_equal"] == [True, True]
