"""``repro_torch.launch.dryrun``, ``launch.roofline``, ``configs.shapes``,
``data.synthetic.make_batch_specs`` and the expert-parallel moe dispatch
against the reference's.

Exact: shape suites, batch specs (keys, shapes, dtypes), parameter counts
of all ten archs at full size (the port's model on ``meta``, the
reference's ``jax.eval_shape``), active parameters, model FLOPs and the
roofline properties.  The per-device counting rule is held to a product
whose answer is known; ``run_cell`` runs smoke configs on a (2, 2) fake
mesh; the shard_map dispatch's ranks, summed, meet the reference's
dispatch within 1e-5 (float32).
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import shapes_for as jshapes_for  # noqa: E402
from repro.data.synthetic import make_batch_specs as jspecs  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.sharding import axis_rules as jaxis_rules  # noqa: E402
from repro.sharding.plan import default_activation_rules  # noqa: E402
from repro_torch.configs import SHAPES, shapes_for  # noqa: E402
from repro_torch.data.synthetic import make_batch_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import production_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import get_config, list_archs  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

KINDS = ("train", "prefill", "decode")


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


@pytest.mark.parametrize("arch", list_archs())
def test_shapes_and_batch_specs_match(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert [s.name for s in shapes_for(cfg)] == [
        s.name for s in jshapes_for(jcfg)]
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind) == (
            j.seq_len, j.global_batch, j.kind)
    for kind in KINDS:
        got = make_batch_specs(cfg, 64, 4, kind)
        want = jspecs(jcfg, 64, 4, kind)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_exact_at_full_size(jdry, arch):
    cfg, jcfg = get_config(arch), jget(arch)
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    total = dryrun.count_params(dict(Model(cfg, "meta").named_parameters()))
    assert total == jdry.count_params(shapes)
    assert dryrun.active_params(cfg, total) == jdry.active_params(jcfg, total)
    for kind in KINDS:
        assert rl.model_flops(1.5e9, 4096.0, kind) == jrl.model_flops(
            1.5e9, 4096.0, kind)


def test_roofline_terms_match_the_reference_formulas():
    kw = dict(arch="a", shape="s", mesh="16x16", n_devices=256,
              hlo_flops=3.1e12, hlo_bytes=7.7e10, collective_bytes=2.5e9,
              collective_breakdown={"all-gather": 2.5e9},
              model_flops_global=5.0e14, bytes_per_device=3e9)
    got, want = rl.RooflineTerms(**kw), jrl.RooflineTerms(**kw)
    assert got.useful_flops_ratio == want.useful_flops_ratio
    assert got.compute_s == kw["hlo_flops"] / 989.4e12
    assert got.memory_s == kw["hlo_bytes"] / 3.35e12
    assert got.collective_s == kw["collective_bytes"] / 50e9
    assert got.bound_s == max(got.compute_s, got.memory_s, got.collective_s)
    ideal = kw["model_flops_global"] / 256 / rl.PEAK_FLOPS
    assert got.roofline_fraction == ideal / got.bound_s
    assert set(got.as_dict()) == set(want.as_dict())
    for terms in ((1.0, 0.1, 0.2), (0.1, 1.0, 0.2), (0.1, 0.2, 1.0)):
        g = rl.RooflineTerms(**dict(kw, hlo_flops=terms[0] * rl.PEAK_FLOPS,
                                    hlo_bytes=terms[1] * rl.HBM_BW,
                                    collective_bytes=terms[2] * rl.NET_BW))
        w = jrl.RooflineTerms(**dict(kw, hlo_flops=terms[0] * jrl.PEAK_FLOPS,
                                     hlo_bytes=terms[1] * jrl.HBM_BW,
                                     collective_bytes=terms[2] * jrl.ICI_BW))
        assert g.dominant == w.dominant
    t = rl.terms_from_counts("a", "s", "16x16", 256, 1.0, 2.0,
                             {"all-gather": 3, "all-reduce": 4}, 5.0)
    assert t.collective_bytes == 7.0
    assert set(t.collective_breakdown) == set(jrl._COLLECTIVES)
    assert rl.collective_kind("all_gather_into_tensor") == "all-gather"
    assert rl.collective_kind("reduce_scatter_tensor") == "reduce-scatter"
    assert rl.collective_kind("mm") is None


def test_per_device_counts_on_a_known_product():
    """(256, 4096) @ (4096, 4096) on the 16x16 mesh, x [Shard(0),
    Replicate()], w [Replicate(), Shard(1)]: 8.590e9 FLOPs in all, 3.355e7
    on a device; then w [Shard(0), Shard(1)] adds the all-gather of x's
    columns that CommDebugMode sees, with its operand's bytes."""
    with production_mesh() as mesh:
        x = distribute_tensor(torch.empty(256, 4096, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        counter = dryrun.StepCounter()
        with counter:
            y = x @ w
        assert 2 * 256 * 4096 * 4096 == 8_589_934_592
        assert counter.flops == 8_589_934_592 // 256 == 33_554_432
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert sum(counter.collective_counts.values()) == 0
        w2 = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh,
                               [Shard(0), Shard(1)], src_data_rank=None)
        counter = dryrun.StepCounter()
        with CommDebugMode() as comm, counter:
            x @ w2
        counts = {str(k).split(".")[-1]: v
                  for k, v in comm.get_comm_counts().items()}
        assert counts == {"all_gather_into_tensor": 1}
        assert counter.collective_counts["all-gather"] == 1
        # x's local (16, 4096) float32 block, gathered over "data"
        assert counter.collective_bytes["all-gather"] == 16 * 4096 * 4
        assert counter.flops == 2 * 256 * 4096 * 4096 // 256
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", [
    ("qwen1.5-0.5b", "prefill_32k"), ("qwen1.5-0.5b", "train_4k"),
    ("qwen2-moe-a2.7b", "prefill_32k")])
def test_run_cell_on_a_small_mesh(jdry, arch, shape):
    rec = dryrun.run_cell(arch, shape, smoke=True, mesh_shape=(2, 2),
                          verbose=False)
    assert not dist.is_initialized()
    for key in ("arch", "shape", "mesh", "n_devices", "hlo_flops",
                "hlo_bytes", "collective_bytes", "collective_breakdown",
                "model_flops_global", "bytes_per_device", "compute_s",
                "memory_s", "collective_s", "dominant", "bound_s",
                "useful_flops_ratio", "roofline_fraction", "compile_s",
                "n_params", "fits_hbm", "collective_counts", "overrides",
                "fsdp", "rules_override", "opt_kw"):
        assert key in rec, key
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    assert rec["hlo_flops"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes"] > 0
    assert set(rec["collective_counts"]) == set(jrl._COLLECTIVES)
    if "moe" in arch:
        assert rec["overrides"]["moe_dispatch"] == "shard_map"
    if shape == "train_4k":
        assert rec["overrides"]["remat"] == "full"
    n = dryrun.count_params(dict(Model(get_config(arch, smoke=True), "meta")
                                 .named_parameters()))
    assert rec["n_params"] == n
    kind = SHAPES[shape].kind
    tokens = SHAPES[shape].global_batch * SHAPES[shape].seq_len
    assert rec["model_flops_global"] == rl.model_flops(
        dryrun.active_params(get_config(arch, smoke=True), n), tokens, kind)


@pytest.mark.parametrize("multi_pod,mesh_shape", [(False, (2, 2)),
                                                  (True, (2, 2, 2))])
def test_loss_head_keeps_the_logits_layout(multi_pod, mesh_shape):
    """The loss and its gradient over (batch, None, vocab) logits: the
    gradient comes back in the logits' layout, and the peak of live bytes
    is four local logits (the global logits over data x model), not a
    gather of the vocabulary or the batch."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding import (axis_rules, logical_to_mesh, make_plan,
                                      placements_for)
    from repro_torch.train.step import cross_entropy

    b, s, v = 32, 64, 4096
    with production_mesh(multi_pod, mesh_shape) as mesh:
        rules = make_plan(multi_pod=multi_pod).activation_rules

        def meta(shape, dtype, names):
            return distribute_tensor(
                torch.empty(shape, dtype=dtype, device="meta"), mesh,
                placements_for(logical_to_mesh(names, rules), mesh),
                src_data_rank=None)

        logits = meta((b, s, v), torch.float32,
                      ("batch", None, "vocab")).requires_grad_(True)
        labels = meta((b, s), torch.int32, ("batch", None))
        counter = dryrun.StepCounter()
        with axis_rules(rules, mesh), implicit_replication(), counter:
            loss, _ = cross_entropy(logits, labels)
            grad, = torch.autograd.grad(loss, logits)
        assert tuple(grad.placements) == tuple(logits.placements)
        local = b * s * v * 4 // math.prod(mesh_shape)
        assert counter.peak_bytes <= 4.5 * local
    assert not dist.is_initialized()


def test_train_cell_bytes_do_not_grow_with_the_pod_axis():
    """A vocabulary-heavy smoke train cell (the loss head dominates): a
    (2, 2, 2) mesh holds no more bytes a device than (2, 2), and each
    holds about four of its local logits."""
    vocab, out = 32_768, {}
    for multi_pod, mesh_shape in ((False, (2, 2)), (True, (2, 2, 2))):
        rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", multi_pod=multi_pod,
                              smoke=True, mesh_shape=mesh_shape,
                              overrides={"vocab_size": vocab, "n_layers": 1},
                              verbose=False)
        local = 256 * 4096 * vocab * 4 / math.prod(mesh_shape)
        assert rec["bytes_per_device"] <= 4.5 * local
        out[multi_pod] = rec["bytes_per_device"]
    assert out[True] <= out[False]


def test_shard_map_dispatch_ranks_sum_to_the_reference():
    """6 experts on 4 model ranks: 2 a rank, the last rank's two inert."""
    jcfg = jget("qwen2-moe-a2.7b", smoke=True, dtype="float32",
                param_dtype="float32", moe_dispatch="shard_map")
    cfg = get_config("qwen2-moe-a2.7b", smoke=True, dtype="float32",
                     param_dtype="float32", moe_dispatch="shard_map")
    p = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    x = np.random.default_rng(7).standard_normal((24, 64)).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh, jaxis_rules(default_activation_rules(False), mesh):
        want_y, want_p = jax.jit(
            lambda p, x: jmoe._dispatch_shard_map(p, x, jcfg))(p, jnp.asarray(x))
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
    n_model, e = 4, cfg.n_experts
    e_local = math.ceil(e / n_model)

    def stack(w, r):
        local = w[r * e_local:(r + 1) * e_local]
        pad = e_local - local.shape[0]
        return torch.nn.functional.pad(local, (0, 0, 0, 0, 0, pad))

    ys = []
    for r in range(n_model):
        y, probs = moe._shard_map_local(
            t["router"], stack(t["experts_wi"], r),
            stack(t["experts_wi_gate"], r), stack(t["experts_wo"], r),
            torch.as_tensor(x), r, cfg)
        np.testing.assert_allclose(probs.numpy(), np.asarray(want_p),
                                   rtol=1e-5, atol=1e-5)
        ys.append(y)
    assert e_local * n_model - e == 2
    np.testing.assert_allclose(sum(ys).numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    # without a mesh the dispatch is scatter's
    got, _ = moe._dispatch_shard_map(moe.MoE(cfg, "cpu"), torch.zeros(4, 64),
                                     cfg)
    assert got.shape == (4, 64)
