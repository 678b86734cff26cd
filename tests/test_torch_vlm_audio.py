"""The vlm and audio families (llama-3.2-vision-11b, whisper-large-v3)
against the reference's, on the same weights (``convert``) and the same
numpy inputs: ``cross_attention``, ``Model.forward``, ``decode_step``,
greedy ``generate``, ``serve_demo``, ``train_step`` and ``convert``.

float32 smoke configs throughout.  The reference starts every cross
block's ``gate`` at 0, where ``tanh(0) = 0`` hides the cross-attention
from every output; so each test that runs a cross block sets every gate
to 0.5 in the numpy tree both packages get.  Tolerances: 1e-5 abs/rel
for one cross-attention and for the encoder; 2e-4 abs/rel for logits
(``LOGIT_TOL``); greedy tokens identical, each choice having won by more
than the logits' tolerance; two ``train_step``s at
``test_torch_train.py``'s tolerances; ``convert`` round trips bit for
bit.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train.step import TrainStepBuilder as JBuilder  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.config import PORT_ONLY  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.transformer import Model, reference_ndim  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import TrainStepBuilder  # noqa: E402
from test_torch_serve import GapRecorder  # noqa: E402
from test_torch_train import _assert_state_close, _flat  # noqa: E402

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-large-v3"
ARCHS = [VLM, AUDIO]
IMPLS = ["xla", "pallas_interpret"]
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
F32 = dict(dtype="float32", param_dtype="float32")
GATE = 0.5
#: The reference's parameter counts at full size (``jax.eval_shape`` of
#: ``Model.init``).
FULL_PARAMS = {VLM: 9_775_157_256, AUDIO: 2_020_830_752}


def _t(x):
    return torch.as_tensor(np.array(x))


def _cross(cfg) -> str:
    return "cross_blocks" if cfg.family == "vlm" else "dec_cross"


def _gated(params, cfg, gate=GATE):
    """A host copy of a reference tree with every cross block's gate set."""
    params = jax.tree.map(np.asarray, params)
    group = params[_cross(cfg)]
    group["gate"] = np.full_like(group["gate"], gate)
    return params


def _pair(arch, impl="xla", seed=0, **overrides):
    """The reference's model, its parameters (gates at ``GATE``) and the
    port's model holding the same weights."""
    cfg = jget(arch, smoke=True, attention_impl=impl, **F32, **overrides)
    jm = jbuild(cfg)
    params = _gated(jm.init(jax.random.PRNGKey(seed)), cfg)
    model = convert.model_params_from_numpy(params, cfg, device="cpu")
    return cfg, jm, params, model


def _extras(cfg, rng, b):
    """A batch's embeddings: image patches (vlm) or audio frames."""
    if cfg.family == "vlm":
        key, t = "image_embeds", cfg.n_image_tokens
    else:
        key, t = "audio_frames", cfg.encoder_seq
    return {key: rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)}


def _cache_extras(cfg, rng, b):
    """A decode cache's embeddings: image patches (vlm) or an encoder
    output (audio)."""
    key = "image_embeds" if cfg.family == "vlm" else "enc"
    t = cfg.n_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
    return {key: rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)}


# -------------------------------------------------------------- configs
def test_configs_match_the_reference():
    for arch in ARCHS:
        for smoke in (False, True):
            ours = dataclasses.asdict(get_config(arch, smoke=smoke))
            ref = dataclasses.asdict(jget(arch, smoke=smoke))
            assert ref.pop("attention_impl") == "xla"
            assert ours.pop("attention_impl") == "plain"
            assert {k: ours.pop(k) for k in PORT_ONLY} == PORT_ONLY
            assert ours == ref
    vlm, audio = get_config(VLM), get_config(AUDIO)
    assert (vlm.cross_attn_every, vlm.n_image_tokens) == (5, 1601)
    assert (audio.encoder_layers, audio.encoder_seq, audio.qkv_bias,
            audio.norm) == (32, 1500, True, "layernorm")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_counts(arch):
    """Meta tensors here, ``jax.eval_shape`` there: nothing is allocated."""
    ours = Model(get_config(arch), torch.device("meta"))
    shapes = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in ours.parameters()) == ref == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_ndim_is_the_stacked_tree_rank(arch):
    """Every parameter's rank in the reference's stacked tree: the stacked
    norm scales (L, d) are decayed there, the stacked gates (L,) not."""
    cfg, _, params, model = _pair(arch)
    ranks = {k: v.ndim for k, v in _flat(params).items()}
    ours = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[1].isdigit():
            parts = [parts[0]] + parts[2:]
        ours["/".join(parts)] = reference_ndim(name, p)
    assert ours == ranks
    assert ranks[f"{_cross(cfg)}/gate"] == 1
    assert ranks[f"{_cross(cfg)}/ln1/scale"] == 2


def test_unrounded_vlm_depth_is_refused():
    cfg = get_config(VLM, smoke=True, n_layers=7)
    with pytest.raises(ValueError, match="whole groups"):
        Model(cfg, torch.device("meta"))


# ------------------------------------------------------ cross-attention
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches(arch):
    """Layer 0 of the cross blocks, queries (2, 9) against 2 x T source
    rows.  Whisper's cross blocks hold QKV biases that neither package
    adds: set to random values here, they change nothing."""
    cfg, _, params, model = _pair(arch, seed=1)
    rng = np.random.default_rng(3)
    p0 = jax.tree.map(lambda a: np.array(a[0]), params[_cross(cfg)]["attn"])
    layer = getattr(model, _cross(cfg))[0].attn
    if cfg.qkv_bias:
        with torch.no_grad():
            for name in ("bq", "bk", "bv"):
                p0[name] = rng.normal(size=p0[name].shape).astype(np.float32)
                getattr(layer, name).copy_(_t(p0[name]))
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 23, cfg.d_model)).astype(np.float32)
    want = jattn.cross_attention(p0, jnp.asarray(x), jnp.asarray(src), cfg)
    got = attention.cross_attention(layer, _t(x), _t(src), model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cfg.qkv_bias:
        with torch.no_grad():
            for name in ("bq", "bk", "bv"):
                getattr(layer, name).zero_()
        again = attention.cross_attention(layer, _t(x), _t(src), model.cfg)
        assert torch.equal(again, got)


def test_encoder_matches():
    """Whisper's encoder alone: non-causal, RoPE at the frame positions,
    ``enc_norm``."""
    cfg, jm, params, model = _pair(AUDIO, seed=2)
    frames = np.random.default_rng(4).normal(
        size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jm._encoder(params, jnp.asarray(frames))
    got = model._encoder(_t(frames))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, impl):
    cfg, jm, params, model = _pair(arch, impl, seed=4)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 33))
             .astype(np.int32), **_extras(cfg, rng, 2)}
    want, jaux = jm.forward(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got, aux = model.forward({k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0
    # The gates matter: at 0 the logits move.
    with torch.no_grad():
        for blk in getattr(model, _cross(cfg)):
            blk.gate.zero_()
    closed, _ = model.forward({k: _t(v) for k, v in batch.items()})
    assert float((closed - got).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(arch):
    """Seven decode steps, slots at different positions, the extras in the
    cache (for audio the encoder's output of the same frames on each
    side): logits at every step, the K/V caches at the end."""
    cfg, jm, params, model = _pair(arch, seed=6)
    b, max_len, steps = 3, 16, 7
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    if cfg.family == "vlm":
        img = _cache_extras(cfg, rng, b)["image_embeds"]
        jextras, extras = {"image_embeds": jnp.asarray(img)}, {
            "image_embeds": _t(img)}
    else:
        frames = _extras(cfg, rng, b)["audio_frames"]
        jextras = {"enc": jm._encoder(params, jnp.asarray(frames))}
        with torch.no_grad():
            extras = {"enc": model._encoder(_t(frames))}
    jcache = jm.init_cache(b, max_len, extras=jextras)
    cache = model.init_cache(b, max_len, extras=extras)
    assert cache["k"].shape == jcache["k"].shape
    start = np.array([0, 3, 5], np.int32)
    jcache["pos"] = jnp.asarray(start)
    cache["pos"] = _t(start)
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        with torch.no_grad():
            got, cache = model.decode_step(cache, _t(tokens[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), start + steps)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **LOGIT_TOL)


def test_two_vlm_groups_match():
    """Ten layers: two groups of four self blocks and a cross block each,
    self block ``g * 4 + j`` in group ``g`` (the reference reshapes its
    stacked blocks row-major); forward and three decode steps."""
    cfg, jm, params, model = _pair(VLM, seed=12, n_layers=10)
    assert (len(model.blocks), len(model.cross_blocks)) == (8, 2)
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 11))
             .astype(np.int32), **_extras(cfg, rng, 2)}
    want, _ = jm.forward(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = model.forward({k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    img = batch["image_embeds"]
    jcache = jm.init_cache(2, 8, extras={"image_embeds": jnp.asarray(img)})
    cache = model.init_cache(2, 8, extras={"image_embeds": _t(img)})
    for t in range(3):
        tok = batch["tokens"][:, t:t + 1]
        jl, jcache = jm.decode_step(params, jcache, jnp.asarray(tok))
        with torch.no_grad():
            got, cache = model.decode_step(cache, _t(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_cache_extras_and_reset_keep_them(arch):
    """``init_cache`` without extras holds zero embeddings of the
    reference's shapes; ``reset_slots`` leaves them as they are."""
    cfg, jm, _, model = _pair(arch)
    jcache, cache = jm.init_cache(2, 8), model.init_cache(2, 8)
    key = "image_embeds" if cfg.family == "vlm" else "enc"
    assert tuple(cache[key].shape) == jcache[key].shape
    assert not cache[key].any()
    cache[key] = torch.ones_like(cache[key])
    out = ServeEngine(model, 8, 2).reset_slots(cache, np.array([True, False]))
    assert out[key] is cache[key] and out["pos"].tolist() == [0, 0]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches(arch, impl):
    """``ServeEngine.prefill`` passes the whole batch on."""
    cfg, jm, params, model = _pair(arch, impl, seed=8)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12))
             .astype(np.int32), **_extras(cfg, rng, 2)}
    want = JServeEngine(jm, 16, 2).prefill(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ServeEngine(model, 16, 2).prefill(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(arch):
    """Prompts of 2-9 tokens through 3 slots, slots reused while others
    are mid-prompt, every slot attending its own extras."""
    cfg, jm, params, model = _pair(arch, seed=9)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(2, 10))
               .astype(np.int32) for _ in range(6)]
    extras = _cache_extras(cfg, rng, 3)
    want = JServeEngine(jm, max_len=24, batch_size=3).generate(
        params, prompts, max_new_tokens=5,
        extras={k: jnp.asarray(v) for k, v in extras.items()})
    gaps = GapRecorder(model)
    got = ServeEngine(model, max_len=24, batch_size=3).generate(
        prompts, max_new_tokens=5,
        extras={k: _t(v) for k, v in extras.items()})
    assert gaps.least > 2e-4
    assert len(got) == 6 and all(len(o) == 5 for o in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


class _GatedJModel(JModel):
    """The reference's model with every gate at ``GATE`` after ``init``."""

    def init(self, rng):
        return _gated(super().init(rng), self.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_matches_reference(arch, monkeypatch):
    """Both ``serve_demo``s at the same seed, on the same (gated) weights:
    the port's draws its extras after the prompts, as the reference's, so
    it serves the same tokens."""
    kw = dict(smoke=True, n_requests=5, batch_slots=2, max_new=4, seed=3)
    monkeypatch.setattr(jserve, "build_model", _GatedJModel)
    want = jserve.serve_demo(arch, **kw)
    recorders = []

    def build(cfg, device=None, seed=0):
        jcfg = jget(arch, smoke=True, **F32)
        params = _GatedJModel(jcfg).init(jax.random.PRNGKey(seed))
        model = convert.model_params_from_numpy(params, cfg, device=device)
        recorders.append(GapRecorder(model))
        return model

    monkeypatch.setattr(serve_mod, "build_model", build)
    got = serve_mod.serve_demo(arch, device="cpu", **kw)
    assert recorders[0].least > 2e-4
    assert (got["requests"], got["tokens"]) == (want["requests"],
                                                want["tokens"]) == (5, 20)
    assert got["outputs"] == want["outputs"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_on_cpu_at_its_defaults(arch):
    out = serve_mod.serve_demo(arch, smoke=True, device="cpu")
    assert out["requests"] == 12 and out["tokens"] == 12 * 16
    assert len(out["outputs"]) == 3 and len(out["outputs"][0]) == 8


# ------------------------------------------------------------- training
BATCH, SEQ, STEPS, LR = 4, 16, 2, 1e-2


def _train_batch(cfg, step):
    """``SyntheticLM``'s batch ``step`` plus its embeddings, seeded by the
    step."""
    batch = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0).global_batch_at(
        step)
    return {**batch, **_extras(cfg, np.random.default_rng(100 + step), BATCH)}


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's initial state (gates at ``GATE``; whisper's unused
    cross-block QKV biases set to random values, so their decay shows),
    its per-step metrics and its state after ``STEPS`` steps."""
    cfg = jget(arch, smoke=True, **F32)
    builder = JBuilder(jbuild(cfg), jadamw.AdamWConfig(lr=LR),
                       warmup_steps=1, total_steps=10)
    state = builder.init_state(jax.random.PRNGKey(0))
    state = dict(state, params=_gated(state["params"], cfg))
    if cfg.qkv_bias:
        attn = state["params"]["dec_cross"]["attn"]
        rng = np.random.default_rng(11)
        for name in ("bq", "bk", "bv"):
            attn[name] = rng.normal(0, 0.1, attn[name].shape).astype(
                np.float32)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(builder.train_step)
    metrics = []
    for it in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                _train_batch(cfg, it).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, init, metrics, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match(arch):
    """Two steps from the reference's state, the float embeddings in the
    batch: loss, aux, lr, the parameters (whisper's cross-block QKV
    biases get zero gradients and are decayed, the gates are not) and the
    moments."""
    cfg, init, want_metrics, want_state = _reference_run(arch)
    builder = TrainStepBuilder(Model(convert.model_config_from(cfg), "cpu"),
                               adamw.AdamWConfig(lr=LR), warmup_steps=1,
                               total_steps=10)
    state = convert.train_state_from_numpy(init, builder.model)
    for it, want in enumerate(want_metrics):
        state, m = builder.train_step(state, _train_batch(cfg, it))
        for key in ("loss", "aux", "lr"):
            np.testing.assert_allclose(float(m[key]), want[key], err_msg=key,
                                       rtol=2e-4, atol=2e-4)
    got = convert.train_state_to_numpy(state)
    assert int(got["step"]) == int(want_state["step"]) == STEPS
    _assert_state_close(got, want_state, steps=STEPS)
    if cfg.qkv_bias:
        assert not np.any(got["opt"]["mu"]["dec_cross"]["attn"]["bq"])
        bq = got["params"]["dec_cross"]["attn"]["bq"]
        bq0 = init["params"]["dec_cross"]["attn"]["bq"]
        assert np.all(np.abs(bq) < np.abs(bq0))


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit(arch, remat):
    def loss_and_grads(mode):
        cfg = get_config(arch, smoke=True, remat=mode, **F32)
        builder = TrainStepBuilder(Model(cfg, "cpu"))
        state = builder.init_state(torch.Generator().manual_seed(3))
        with torch.no_grad():
            for name, p in state["params"].items():
                if name.endswith("gate"):
                    p.fill_(GATE)
        batch = {k: _t(v) for k, v in _train_batch(cfg, 0).items()}
        total, _ = builder.loss_fn(state["params"], batch)
        params = list(state["params"].values())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return total, [g for g in grads if g is not None]

    want, got = loss_and_grads("none"), loss_and_grads(remat)
    assert torch.equal(got[0], want[0]) and len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


# -------------------------------------------------------------- convert
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips(arch):
    """The reference's tree -> the port -> the reference's tree, bit for
    bit, for the weights and for a training state; a missing group
    refuses."""
    cfg, _, params, model = _pair(arch)
    back = convert.model_params_to_numpy(model)
    want = _flat(params)
    got = _flat(back)
    assert got.keys() == want.keys()
    for key, arr in want.items():
        assert got[key].shape == arr.shape, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    _, init, _, _ = _reference_run(arch)
    twin = Model(convert.model_config_from(cfg), "cpu")
    state = convert.train_state_from_numpy(init, twin)
    again = _flat(convert.train_state_to_numpy(state))
    for key, arr in _flat(init).items():
        np.testing.assert_array_equal(again[key], arr, err_msg=key)
    tree = dict(params)
    tree.pop(_cross(cfg))
    with pytest.raises(KeyError):
        convert.model_params_from_numpy(tree, cfg, device="cpu")
