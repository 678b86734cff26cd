"""``repro_torch.models.moe`` and the moe family of ``Model`` against the
reference's, on the same weights (``convert``) and the same numpy inputs.

float32 throughout, the qwen2-moe-a2.7b smoke config (6 experts, top 2,
2 shared).  Tolerances: 1e-5 abs/rel for one layer's output and its
load-balance loss; 2e-4 abs/rel for logits after two blocks.  Integer
routing (the top-k experts, which (token, slot) pairs the capacity
drops) must be identical.  Greedy ``generate`` tokens must be identical,
each choice having won by more than the logits' tolerance.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import PORT_ONLY  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from test_torch_serve import GapRecorder  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _cfgs(**overrides):
    kw = dict(dtype="float32", param_dtype="float32", **overrides)
    return jget(ARCH, smoke=True, **kw), get_config(ARCH, smoke=True, **kw)


def _layer_pair(seed, **overrides):
    """The reference's MoE parameters and a port ``MoE`` holding them."""
    jcfg, cfg = _cfgs(**overrides)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    layer = moe.MoE(cfg, "cpu")
    with torch.no_grad():
        for name, arr in p.items():
            getattr(layer, name).copy_(_t(arr))
    return jcfg, cfg, p, layer


def _ref_keep(topi, c, e):
    """The reference's capacity rule (``moe.py:90-95``) in numpy."""
    flat = np.asarray(topi).T.reshape(-1)
    pos_in_e = np.cumsum(np.eye(e, dtype=np.int32)[flat], axis=0) - 1
    return pos_in_e[np.arange(flat.size), flat] < c


@pytest.fixture(scope="module")
def pair():
    """Two-block model pair shared by the model-level tests."""
    jcfg, _ = _cfgs()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(4))
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), jcfg, device="cpu")
    return jcfg, jm, params, model


# ------------------------------------------------------------- config
def test_config_and_parameter_count_match_the_reference():
    for smoke in (False, True):
        ours = dataclasses.asdict(get_config(ARCH, smoke=smoke))
        ref = dataclasses.asdict(jget(ARCH, smoke=smoke))
        assert ref.pop("attention_impl") == "xla"
        assert ours.pop("attention_impl") == "plain"
        assert {k: ours.pop(k) for k in PORT_ONLY} == PORT_ONLY
        assert ours == ref
    cfg = get_config(ARCH)
    assert cfg.resolved_moe_d_ff == 1408
    full = Model(cfg, torch.device("meta"))
    shapes = jax.eval_shape(jbuild(jget(ARCH)).init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in full.parameters()) == want
    assert want > 14e9


# -------------------------------------------------------------- layer
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum", "shard_map"])
def test_moe_layer_matches(dispatch, cf):
    """Output, load-balance loss and the dropped pairs; ``shard_map`` on
    one device is the reference's mesh-less branch (scatter)."""
    jcfg, cfg, p, layer = _layer_pair(0, capacity_factor=cf,
                                      moe_dispatch=dispatch)
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    want_y, want_aux = jmoe.moe_layer(p, jnp.asarray(x), jcfg)
    y, aux = moe.moe_layer(layer, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    xt = x.reshape(-1, cfg.d_model)
    c = moe._capacity(xt.shape[0], cfg)
    assert c == jmoe._capacity(xt.shape[0], jcfg)
    _, jtopi, _ = jmoe._router(p, jnp.asarray(xt), jcfg)
    _, topi, _ = moe._router(layer, _t(xt), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    keep = moe._slots(topi, cfg, c)[2].numpy()
    np.testing.assert_array_equal(keep, _ref_keep(jtopi, c, cfg.n_experts))
    if cf < 1:
        assert 0 < keep.sum() < keep.size     # the capacity drops pairs


def test_router_ties_take_the_lower_expert():
    """A zero router ties every expert: top-k takes experts 0..k-1 (as
    ``jax.lax.top_k``) and the load-balance argmax expert 0."""
    jcfg, cfg, p, layer = _layer_pair(2)
    p = dict(p, router=np.zeros_like(np.asarray(p["router"])))
    with torch.no_grad():
        layer.router.zero_()
    x = np.random.default_rng(3).normal(size=(1, 9, cfg.d_model)).astype(
        np.float32)
    _, topi, _ = moe._router(layer, _t(x[0]), cfg)
    assert (topi.numpy() == np.arange(cfg.n_experts_per_token)).all()
    want_y, want_aux = jmoe.moe_layer(p, jnp.asarray(x), jcfg)
    y, aux = moe.moe_layer(layer, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    assert float(aux) == pytest.approx(1.0, rel=1e-6)


def test_unknown_dispatch_is_refused():
    _, cfg, _, layer = _layer_pair(0, moe_dispatch="ragged")
    with pytest.raises(ValueError, match="moe_dispatch"):
        moe.moe_layer(layer, torch.zeros(1, 4, cfg.d_model), cfg)


# -------------------------------------------------------------- model
def test_forward_matches(pair):
    jcfg, jm, params, model = pair
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    want, jaux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward({"tokens": _t(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0


def test_decode_step_matches_step_by_step(pair):
    """Each decode step routes its B tokens with the capacity of B."""
    jcfg, jm, params, model = pair
    b, max_len, steps = 3, 16, 6
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (b, steps)).astype(np.int32)
    jcache = jm.init_cache(b, max_len)
    cache = model.init_cache(b, max_len)
    start = np.array([0, 3, 5], np.int32)
    jcache["pos"] = jnp.asarray(start)
    cache["pos"] = _t(start)
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(steps):
            jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
            got, cache = model.decode_step(cache, _t(tokens[:, t:t + 1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **LOGIT_TOL)


def test_params_round_trip_in_the_reference_layout(pair):
    _, _, params, model = pair
    tree = convert.model_params_to_numpy(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_generate_greedy_matches_reference(pair):
    jcfg, jm, params, model = pair
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jcfg.vocab_size, size=rng.integers(3, 8))
               .astype(np.int32) for _ in range(5)]
    want = JServeEngine(jm, max_len=24, batch_size=2).generate(
        params, prompts, max_new_tokens=4)
    gaps = GapRecorder(model)
    got = ServeEngine(model, max_len=24, batch_size=2).generate(
        prompts, max_new_tokens=4)
    del model.decode_step                 # the recorder's, on the instance
    assert gaps.least > 2e-4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_serve_demo_serves_the_moe_smoke_config():
    out = serve_demo(ARCH, smoke=True, n_requests=3, batch_slots=2,
                     max_new=3, device="cpu")
    assert out["requests"] == 3 and out["tokens"] == 9
