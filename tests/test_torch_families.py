"""The last five architectures against the reference's, on the same
weights (``convert``) and the same numpy inputs: the configs of gemma-7b,
starcoder2-3b, kimi-k2-1t-a32b, hymba-1.5b and rwkv6-3b, the hybrid and
ssm families (``Model.forward``, ``decode_step``, ``init_cache``),
decoding through a ring-buffer KV cache (``_ring_decode_attention``),
``reset_slots`` on recurrent states, greedy ``generate``, ``serve_demo``,
``train_step`` and ``convert``.

float32 smoke configs throughout; starcoder2's and hymba's windows are 16
there, so a prompt of 40 tokens runs past them and the decode caches are
rings of 16 slots.  Tolerances: logits within 2e-5 of the largest |logit|
(``LOGIT_REL``); K/V caches and recurrent states within 1e-5 abs/rel;
greedy tokens identical, each choice having won by more than the logits'
tolerance (``GapRecorder``'s gap, relative to the largest |logit|); three ``train_step``s at ``test_torch_train.py``'s
tolerances; ``convert`` round trips bit for bit.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train.step import TrainStepBuilder as JBuilder  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import PORT_ONLY  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models.transformer import Model, reference_ndim  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import TrainStepBuilder  # noqa: E402
from test_torch_serve import GapRecorder  # noqa: E402
from test_torch_train import _assert_state_close, _flat  # noqa: E402

GEMMA, STARCODER, KIMI = "gemma-7b", "starcoder2-3b", "kimi-k2-1t-a32b"
HYMBA, RWKV = "hymba-1.5b", "rwkv6-3b"
ARCHS = [GEMMA, STARCODER, KIMI, HYMBA, RWKV]
RING = [STARCODER, HYMBA]
STATEFUL = [HYMBA, RWKV]
IMPLS = ["xla", "pallas_interpret"]
LOGIT_REL = 2e-5
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(dtype="float32", param_dtype="float32")
#: The reference's parameter counts at full size (``jax.eval_shape`` of
#: ``Model.init``).
FULL_PARAMS = {GEMMA: 8_537_680_896, STARCODER: 3_180_625_920,
               KIMI: 1_043_853_440_000, HYMBA: 1_968_849_600,
               RWKV: 3_272_542_720}


def _t(x):
    return torch.as_tensor(np.array(x))


def _pair(arch, impl="xla", seed=0, **overrides):
    """The reference's model, its parameters (host arrays) and the port's
    model holding the same weights."""
    cfg = jget(arch, smoke=True, attention_impl=impl, **F32, **overrides)
    jm = jbuild(cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    model = convert.model_params_from_numpy(params, cfg, device="cpu")
    return cfg, jm, params, model


def _assert_logits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_REL * scale, f"{what}: {err:.3e} of {scale:.4f}"


def _flat_torch(tree, prefix=""):
    """A port cache's tensors by their "/"-joined path, as ``_flat``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _assert_caches(cache, jcache):
    """Every leaf of the caches: positions, K/V rings, recurrent states."""
    got, want = _flat_torch(cache), _flat(jcache)
    assert got.keys() == want.keys()
    for key, arr in want.items():
        np.testing.assert_allclose(got[key].numpy(), arr, err_msg=key, **TOL)


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
    assert get_config(GEMMA).resolved_head_dim == 256
    assert get_config(KIMI).resolved_head_dim == 112
    assert get_config(HYMBA).resolved_head_dim == 64
    assert get_config(RWKV).resolved_ssm_heads == 40
    assert get_config(STARCODER).sliding_window == 4096


def test_arch_modules_are_the_references():
    assert list(configs.ARCH_MODULES) == list(jconfigs.ARCH_MODULES)
    assert len(configs.ARCH_MODULES) == 10


@pytest.mark.parametrize("arch", list(jconfigs.SMOKE_CONFIGS))
def test_every_smoke_config_builds_and_runs(arch):
    """Each of the reference's ten smoke configs: the model builds, and a
    prompt and two decode steps run, with no ``NotImplementedError``."""
    cfg = get_config(arch, smoke=True, **F32)
    model = Model(cfg, "cpu").init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20))}
    extras = {}
    if cfg.family == "vlm":
        batch["image_embeds"] = extras["image_embeds"] = rng.normal(
            size=(2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        logits, _ = model.forward({k: _t(v) for k, v in batch.items()})
        cache = model.init_cache(2, 24, extras={k: _t(v) for k, v in
                                                extras.items()})
        for t in range(2):
            step, cache = model.decode_step(cache, _t(batch["tokens"][:, t:t + 1]))
    assert tuple(logits.shape) == (2, 20, cfg.vocab_size)
    assert bool(torch.isfinite(step).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_counts(arch):
    """Meta tensors here, ``jax.eval_shape`` there: nothing is allocated."""
    ours = Model(get_config(arch), torch.device("meta"))
    shapes = jax.eval_shape(jbuild(jget(arch)).init, jax.random.PRNGKey(0))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in ours.parameters()) == ref == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", STATEFUL)
def test_reference_ndim_is_the_stacked_tree_rank(arch):
    """Every parameter's rank in the reference's stacked tree, which AdamW
    decays by: ``mu_r`` (L, d) is decayed there, as is ``b_dt``."""
    cfg, _, params, model = _pair(arch)
    ranks = {k: v.ndim for k, v in _flat(params).items()}
    ours = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[1].isdigit():
            parts = [parts[0]] + parts[2:]
        ours["/".join(parts)] = reference_ndim(name, p)
    assert ours == ranks
    group = "blocks/ssm" if cfg.family == "hybrid" else "blocks/rwkv"
    assert all(r >= 2 for k, r in ranks.items() if k.startswith(group))


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, impl):
    """A prompt of 40 tokens, longer than the smoke windows (16)."""
    cfg, jm, params, model = _pair(arch, impl, seed=4)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, jaux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model.forward({"tokens": _t(tokens)})
    assert got.dtype == torch.float32
    _assert_logits(got.detach().numpy(), want, arch)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(arch):
    """Eight decode steps, slots at different positions: logits at every
    step, the caches (K/V, the ring's slots, the recurrent states) at the
    end."""
    cfg, jm, params, model = _pair(arch, seed=6)
    b, max_len, steps = 3, 24, 8
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    jcache = jm.init_cache(b, max_len)
    cache = model.init_cache(b, max_len)
    start = np.array([0, 3, 5], np.int32)
    jcache["pos"] = jnp.asarray(start)
    cache["pos"] = _t(start)
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        with torch.no_grad():
            got, cache = model.decode_step(cache, _t(tokens[:, t:t + 1]))
        _assert_logits(got, jl, f"{arch} step {t}")
    np.testing.assert_array_equal(cache["pos"].numpy(), start + steps)
    _assert_caches(cache, jcache)


def test_init_cache_matches_the_reference():
    for arch in ARCHS:
        cfg, jm, _, model = _pair(arch)
        jcache, cache = jm.init_cache(2, 40), model.init_cache(2, 40)
        jflat = {k: v for k, v in _flat(jcache).items()}
        flat = {k: v.numpy() for k, v in _flat_torch(cache).items()}
        assert flat.keys() == jflat.keys(), arch
        for key, arr in jflat.items():
            assert flat[key].shape == arr.shape, (arch, key)
            assert flat[key].dtype == arr.dtype, (arch, key)
            assert not flat[key].any(), (arch, key)
    assert model.cfg.family == "ssm" and "k" not in cache


def test_ring_decode_attention_matches():
    """``_ring_decode_attention`` alone: a random 16-slot ring, positions
    before the ring fills (only written slots count), at its edge and
    past it (every slot counts), on starcoder2's QKV biases and 4/2
    heads."""
    cfg, jm, params, model = _pair(STARCODER, seed=1)
    p0 = jax.tree.map(lambda a: np.array(a[0]), params["blocks"]["attn"])
    layer = model.blocks[0].attn
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for name in ("bq", "bk", "bv"):
            p0[name] = rng.normal(0, 0.5, p0[name].shape).astype(np.float32)
            getattr(layer, name).copy_(_t(p0[name]))
    cl, hkv, hd = 16, cfg.n_kv_heads, cfg.resolved_head_dim
    pos = np.array([0, 7, 15, 16, 37, 100], np.int32)
    b = len(pos)
    a = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, cl, hkv, hd)).astype(np.float32)
    vc = rng.normal(size=(b, cl, hkv, hd)).astype(np.float32)
    jy, jk, jv = jtransformer._ring_decode_attention(
        p0, jnp.asarray(a), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos), cfg)
    k_t, v_t = _t(kc), _t(vc)
    y = transformer._ring_decode_attention(layer, _t(a), k_t, v_t, _t(pos),
                                           model.cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    # Written in place, at pos % 16.
    np.testing.assert_allclose(k_t.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(jv), **TOL)
    changed = (k_t.numpy() != kc).any(axis=(2, 3))
    assert changed.sum(1).tolist() == [1] * b
    assert np.argmax(changed, 1).tolist() == (pos % cl).tolist()


@pytest.mark.parametrize("arch", RING + [RWKV])
def test_ring_decode_wraps_and_resets(arch):
    """A 40-token prompt through decode steps, then 8 more steps: 48 steps
    past window 16, so the rings wrap three times; slot 1 is reset by
    ``reset_slots`` after step 20 on both sides, which zeroes its ``ssm`` or
    ``rwkv`` state and its position (and leaves slot 0's alone).  Logits
    and greedy choices at every step; the caches at the end."""
    cfg, jm, params, model = _pair(arch, seed=8)
    b, max_len, steps = 2, 64, 48
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (b, steps)).astype(np.int32)
    jeng, eng = JServeEngine(jm, max_len, b), ServeEngine(model, max_len, b)
    jcache, cache = jm.init_cache(b, max_len), model.init_cache(b, max_len)
    if cfg.family != "ssm":
        assert cache["k"].shape[2] == jcache["k"].shape[2] == 16
    reset = np.array([False, True])
    gaps = GapRecorder(model)
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        jl, jcache = jeng.serve_step(params, jcache, jnp.asarray(tok))
        got, cache = eng.serve_step(cache, _t(tok))
        _assert_logits(got, jl, f"{arch} step {t}")
        assert (np.argmax(got.numpy(), -1) == np.argmax(np.asarray(jl), -1)).all()
        if t == 20:
            jcache = jeng.reset_slots(jcache, reset)
            before = {k: v.clone() for k, v in _flat_torch(cache).items()}
            cache = eng.reset_slots(cache, reset)
            after = _flat_torch(cache)
            assert cache["pos"].tolist() == [21, 0]
            for key in after:
                if key.startswith(("ssm", "rwkv")):
                    assert not after[key][:, 1].any(), key
                    assert torch.equal(after[key][:, 0], before[key][:, 0])
                    assert before[key][:, 1].any(), key
    assert gaps.least > LOGIT_REL
    _assert_caches(cache, jcache)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(arch):
    """Prompts of 2-9 tokens through 3 slots, 12 new tokens each: slots
    are reused while others are mid-prompt, and the rings (16 slots)
    wrap."""
    cfg, jm, params, model = _pair(arch, seed=10)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(2, 10))
               .astype(np.int32) for _ in range(5)]
    want = JServeEngine(jm, max_len=40, batch_size=3).generate(
        params, prompts, max_new_tokens=12)
    gaps = GapRecorder(model)
    got = ServeEngine(model, max_len=40, batch_size=3).generate(
        prompts, max_new_tokens=12)
    assert gaps.least > LOGIT_REL
    assert len(got) == 5 and all(len(o) == 12 for o in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", [STARCODER] + STATEFUL)
def test_serve_demo_matches_reference(arch):
    kw = dict(smoke=True, n_requests=5, batch_slots=2, max_new=4, seed=3)
    want = jserve.serve_demo(arch, **kw)
    got = serve_mod.serve_demo(arch, device="cpu", **kw)
    assert (got["requests"], got["tokens"]) == (want["requests"],
                                                want["tokens"]) == (5, 20)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_demo_on_cpu_at_its_defaults(arch):
    out = serve_mod.serve_demo(arch, smoke=True, device="cpu")
    assert out["requests"] == 12 and out["tokens"] == 12 * 16


# ------------------------------------------------------------- training
BATCH, SEQ, STEPS, LR = 4, 24, 3, 1e-2


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's initial state, its per-step metrics and its state
    after ``STEPS`` steps of ``SyntheticLM`` batches."""
    cfg = jget(arch, smoke=True, **F32)
    builder = JBuilder(jbuild(cfg), jadamw.AdamWConfig(lr=LR),
                       warmup_steps=1, total_steps=10)
    state = builder.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    data = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    step = jax.jit(builder.train_step)
    metrics = []
    for it in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                data.global_batch_at(it).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, init, metrics, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("arch", STATEFUL)
def test_train_steps_match(arch):
    """Three steps from the reference's state: loss, aux, lr, the
    parameters and the moments."""
    cfg, init, want_metrics, want_state = _reference_run(arch)
    builder = TrainStepBuilder(Model(convert.model_config_from(cfg), "cpu"),
                               adamw.AdamWConfig(lr=LR), warmup_steps=1,
                               total_steps=10)
    state = convert.train_state_from_numpy(init, builder.model)
    data = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    for it, want in enumerate(want_metrics):
        state, m = builder.train_step(state, data.global_batch_at(it))
        for key in ("loss", "aux", "lr"):
            np.testing.assert_allclose(float(m[key]), want[key], err_msg=key,
                                       rtol=2e-4, atol=2e-4)
    got = convert.train_state_to_numpy(state)
    assert int(got["step"]) == int(want_state["step"]) == STEPS
    _assert_state_close(got, want_state, steps=STEPS)
    assert want_metrics[-1]["loss"] < want_metrics[0]["loss"]


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", STATEFUL)
def test_remat_is_bit_for_bit(arch, remat):
    def loss_and_grads(mode):
        cfg = get_config(arch, smoke=True, remat=mode, **F32)
        builder = TrainStepBuilder(Model(cfg, "cpu"))
        state = builder.init_state(torch.Generator().manual_seed(3))
        batch = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0
                             ).global_batch_at(0)
        total, _ = builder.loss_fn(state["params"],
                                   {k: _t(v) for k, v in batch.items()})
        grads = torch.autograd.grad(total, list(state["params"].values()))
        return total, grads

    want, got = loss_and_grads("none"), loss_and_grads(remat)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


# -------------------------------------------------------------- convert
@pytest.mark.parametrize("arch", STATEFUL)
def test_convert_round_trips(arch):
    """The reference's tree -> the port -> the reference's tree, bit for
    bit, for the weights and for a training state; a missing leaf
    refuses."""
    cfg, _, params, model = _pair(arch)
    want, got = _flat(params), _flat(convert.model_params_to_numpy(model))
    assert got.keys() == want.keys()
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    _, init, _, _ = _reference_run(arch)
    twin = Model(convert.model_config_from(cfg), "cpu")
    state = convert.train_state_from_numpy(init, twin)
    again = _flat(convert.train_state_to_numpy(state))
    for key, arr in _flat(init).items():
        np.testing.assert_array_equal(again[key], arr, err_msg=key)
    group = "ssm" if cfg.family == "hybrid" else "rwkv"
    tree = jax.tree.map(lambda a: a, params)
    tree["blocks"][group].pop(next(iter(tree["blocks"][group])))
    with pytest.raises(KeyError):
        convert.model_params_from_numpy(tree, cfg, device="cpu")
