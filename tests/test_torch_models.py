"""``repro_torch.models``: layers, attention, ``Model.forward`` and
``decode_step`` against the reference's, with the reference's weights
carried across by ``convert.model_params_from_numpy``.

Both packages get the same numpy inputs; the smoke configs of qwen1.5-0.5b
(QKV bias, 4/4 heads) and llama3.2-3b (grouped KV heads, 4/2) run under
both attention routes.  Tolerances: 1e-5 for single layers in float32,
2e-4 abs/rel for logits after two blocks.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.config import PORT_ONLY  # noqa: E402
from repro_torch.models.registry import build_model, get_config, list_archs  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "llama3.2-3b"]
IMPLS = ["xla", "pallas_interpret"]
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _pair(arch, impl="xla", seed=0):
    """The reference's model, its parameters and the port's model holding
    the same weights."""
    cfg = jget(arch, smoke=True, dtype="float32", param_dtype="float32",
               attention_impl=impl)
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, jm, params, model


# -------------------------------------------------------------- configs
def test_configs_match_the_reference():
    assert list_archs() == ["gemma-7b", "hymba-1.5b", "kimi-k2-1t-a32b",
                            "llama-3.2-vision-11b", "llama3.2-3b",
                            "qwen1.5-0.5b", "qwen2-moe-a2.7b", "rwkv6-3b",
                            "starcoder2-3b", "whisper-large-v3"]
    for arch in ARCHS:
        for smoke in (False, True):
            ours = dataclasses.asdict(get_config(arch, smoke=smoke))
            ref = dataclasses.asdict(jget(arch, smoke=smoke))
            assert ref.pop("attention_impl") == "xla"
            assert ours.pop("attention_impl") == "plain"
            assert {k: ours.pop(k) for k in PORT_ONLY} == PORT_ONLY
            assert ours == ref
    cfg = get_config("qwen1.5-0.5b", dtype="float32", param_dtype="float32")
    assert cfg.activation_dtype() == torch.float32
    assert (cfg.n_layers, cfg.d_model, cfg.resolved_head_dim) == (24, 1024, 64)
    with pytest.raises(ValueError, match="attention_impl"):
        cfg.scaled(attention_impl="pallas")


def test_full_qwen_parameter_count():
    """qwen1.5-0.5b at full width holds 463,987,712 parameters (meta
    tensors: nothing is allocated)."""
    model = Model(get_config("qwen1.5-0.5b"), torch.device("meta"))
    assert sum(p.numel() for p in model.parameters()) == 463_987_712


def test_convert_maps_config_and_refuses_mismatches():
    cfg, jm, params, model = _pair("qwen1.5-0.5b", "pallas_interpret")
    assert model.cfg.attention_impl == "kernel"
    assert convert.model_config_from(cfg.scaled(attention_impl="xla")
                                     ).attention_impl == "plain"
    tree = jax.tree.map(np.asarray, params)
    tree["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="no parameter"):
        convert.model_params_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["final_norm"]["scale"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        convert.model_params_from_numpy(tree, cfg, device="cpu")


# --------------------------------------------------------------- layers
def test_norms_embed_unembed():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    sc = rng.normal(1.0, 0.1, (48,)).astype(np.float32)
    for jfn, fn in ((jlayers.rms_norm, layers.rms_norm),
                    (jlayers.layer_norm, layers.layer_norm)):
        np.testing.assert_allclose(fn(_t(x), _t(sc)).numpy(),
                                   np.asarray(jfn({"scale": sc}, x)), **TOL)
    table = rng.normal(size=(30, 48)).astype(np.float32)
    ids = rng.integers(0, 30, (2, 5)).astype(np.int32)
    for scale in (False, True):
        np.testing.assert_allclose(
            layers.embed(_t(table), _t(ids), scale).numpy(),
            np.asarray(jlayers.embed({"table": table}, ids, scale)), **TOL)
    for softcap in (0.0, 5.0):
        np.testing.assert_allclose(
            layers.tied_unembed(_t(x), _t(table), softcap).numpy(),
            np.asarray(jlayers.tied_unembed({"table": table}, x, softcap)),
            **TOL)
        kern = table.T.copy()
        np.testing.assert_allclose(
            layers.unembed(_t(x), _t(kern), softcap).numpy(),
            np.asarray(jlayers.unembed({"kernel": kern}, x, softcap)), **TOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp(activation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"wi": rng.normal(size=(32, 40)).astype(np.float32) / 6,
         "wo": rng.normal(size=(40, 32)).astype(np.float32) / 6,
         "wi_gate": rng.normal(size=(32, 40)).astype(np.float32) / 6}
    gate = p["wi_gate"] if activation != "gelu" else None
    got = layers.mlp(_t(x), _t(p["wi"]), None if gate is None else _t(gate),
                     _t(p["wo"]), activation)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlayers.mlp(p, x, activation)),
                               **TOL)


def test_rope_rotates_halves():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 40]).astype(np.int32)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 16, 1e6)
    c, s = layers.rope_angles(_t(pos), 16, 1e6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(layers.apply_rope(_t(x), c, s).numpy(),
                               np.asarray(jlayers.apply_rope(x, jc, js)),
                               **TOL)


def test_truncated_normal_init():
    g = torch.Generator().manual_seed(0)
    t = layers.truncated_normal_(torch.empty(200_000), 0.5, g)
    assert float(t.abs().max()) <= 1.0
    assert abs(float(t.std()) - 0.5 * 0.8796) < 5e-3   # std of N(0,1) cut at 2
    assert abs(float(t.mean())) < 5e-3


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_matches(arch, impl):
    cfg, _, params, model = _pair(arch, impl)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want = jattn.attention(p0, jnp.asarray(x), cfg)
    got = attention.attention(model.blocks[0].attn, _t(x), model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_attention_layouts_and_scales():
    """The reference's layouts; weights cut at +-2 sigma of the reference's
    scales (d^-0.5, and (H hd)^-0.5 for ``wo``); biases 0."""
    cfg = get_config("qwen1.5-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32")
    p = attention.init_attention(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    jp = jattn.init_attention(jax.random.PRNGKey(0), jget(
        "qwen1.5-0.5b", smoke=True, dtype="float32", param_dtype="float32"))
    sigma = {"wq": cfg.d_model ** -0.5, "wk": cfg.d_model ** -0.5,
             "wv": cfg.d_model ** -0.5,
             "wo": (cfg.n_heads * cfg.resolved_head_dim) ** -0.5}
    for name, arr in jp.items():
        t = getattr(p, name)
        assert tuple(t.shape) == arr.shape, name
        if name in sigma:
            assert float(t.abs().max()) <= 2 * sigma[name] * (1 + 1e-6)
            assert abs(float(t.std()) / sigma[name] - 0.8796) < 0.05
        else:
            assert (t == 0).all()


@pytest.mark.parametrize("window,causal", [(0, True), (6, True), (0, False)])
def test_sdpa_and_kernel_routes_agree(window, causal):
    cfg = get_config("llama3.2-3b", smoke=True, dtype="float32",
                     param_dtype="float32", sliding_window=window)
    model = build_model(cfg, device="cpu", seed=1)
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator().manual_seed(2))
    plain = attention.attention(model.blocks[1].attn, x, cfg, causal=causal)
    kern = attention.attention(model.blocks[1].attn, x,
                               cfg.scaled(attention_impl="kernel"),
                               causal=causal)
    torch.testing.assert_close(kern, plain, **TOL)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, impl):
    cfg, jm, params, model = _pair(arch, impl, seed=4)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    want, jaux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward({"tokens": _t(tokens)})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_step_by_step(arch):
    cfg, jm, params, model = _pair(arch, seed=6)
    b, max_len, steps = 3, 16, 7
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    jcache = jm.init_cache(b, max_len)
    cache = model.init_cache(b, max_len)
    # slots start at different positions, as after slot reuse
    start = np.array([0, 3, 5], np.int32)
    jcache["pos"] = jnp.asarray(start)
    cache["pos"] = _t(start)
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, cache = model.decode_step(cache, _t(tokens[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **LOGIT_TOL)


def test_decode_write_past_the_cache_is_dropped():
    """A position at or past max_len writes nothing, as the reference's
    out-of-bounds update; the step still attends the whole cache."""
    cfg, jm, params, model = _pair("qwen1.5-0.5b", seed=8)
    jcache = jm.init_cache(2, 4)
    cache = model.init_cache(2, 4)
    tok = np.array([[5], [9]], np.int32)
    for _ in range(6):
        jl, jcache = jm.decode_step(params, jcache, jnp.asarray(tok))
        got, cache = model.decode_step(cache, _t(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **LOGIT_TOL)


def test_unported_families_and_ring_decode_raise():
    """Only a family the reference does not have is refused: hybrid and
    ssm build, and a window that fits the cache decodes through a ring of
    ``window`` slots (``tests/test_torch_families.py`` holds both to the
    reference)."""
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    with pytest.raises(ValueError, match="family"):
        Model(cfg.scaled(family="retnet"), torch.device("meta"))
    for family in ("hybrid", "ssm"):
        Model(cfg.scaled(family=family), torch.device("meta"))
    model = build_model(cfg.scaled(sliding_window=4), device="cpu")
    cache = model.init_cache(1, 16)
    assert cache["k"].shape[2] == 4
    for t in range(6):
        logits, cache = model.decode_step(
            cache, torch.full((1, 1), t, dtype=torch.int32))
    assert bool(torch.isfinite(logits).all()) and cache["pos"].tolist() == [6]


def test_build_model_is_seeded():
    cfg = get_config("llama3.2-3b", smoke=True)
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3)
    c = build_model(cfg, device="cpu", seed=4)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.embed.table, c.embed.table)
    assert a.embed.table.dtype == torch.bfloat16
    assert a.blocks[0].ln1.scale.dtype == torch.float32
    assert len(a.blocks) == cfg.n_layers
