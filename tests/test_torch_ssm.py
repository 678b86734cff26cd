"""``repro_torch.models.ssm`` against ``repro.models.ssm``: the Mamba-style
selective scan and RWKV6, on the same weights (the reference's ``init_*``
trees copied into the port's modules) and the same numpy inputs.

The smoke configs of hymba-1.5b (d_model 64, d_inner 128, N 4) and
rwkv6-3b (d_model 64, 4 heads of 16) in float32, and hymba's in
bfloat16.  Each checks the full-sequence path, the one-token decode path,
the state shapes and that the full sequence equals step-by-step decode.
The time loops are also run in chunks of a few steps
(``ssm.CHUNK_ELEMS``), as long sequences run on the card.  Tolerances:
1e-5 abs/rel in float32 (``TOL``); in bfloat16 one rounding of the output
(``BF16_TOL``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

HYMBA, RWKV = "hymba-1.5b", "rwkv6-3b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
F32 = dict(dtype="float32", param_dtype="float32")
#: Chunk limits (``ssm.CHUNK_ELEMS``): the whole sequence in one chunk,
#: and three steps a chunk (batch 2: a Mamba step holds 2 x 128 x 4
#: floats, an RWKV step 2 x 4 x 16 x 16).
MAMBA_CHUNKS = [1 << 26, 3 * 2 * 128 * 4]
RWKV_CHUNKS = [1 << 26, 3 * 2 * 4 * 16 * 16]


def _t(x):
    return torch.as_tensor(np.array(x))


def _cfgs(arch, **kw):
    jcfg = jget(arch, smoke=True, **{**F32, **kw})
    return jcfg, convert.model_config_from(jcfg)


def _module(cls, tree, *args):
    """A port module holding the reference tree's arrays, by name."""
    mod = cls(*args, device="cpu")
    with torch.no_grad():
        for name, arr in tree.items():
            getattr(mod, name).copy_(convert._tensor(np.asarray(arr)))
    return mod


def _mamba(seed=0, **kw):
    jcfg, cfg = _cfgs(HYMBA, **kw)
    tree = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, tree, _module(ssm.Mamba, tree, cfg)


def _rwkv(seed=0):
    jcfg, cfg = _cfgs(RWKV)
    tree = jssm.init_rwkv6(jax.random.PRNGKey(seed), jcfg)
    # mu_* at 0.5 weigh x and its shift alike; draw them so that the two
    # sides of every mix are told apart.
    rng = np.random.default_rng(seed + 100)
    tree = {k: (rng.uniform(0, 1, v.shape).astype(np.float32)
                if k.startswith("mu_") else np.asarray(v))
            for k, v in tree.items()}
    return jcfg, cfg, tree, _module(ssm.RWKV6, tree, cfg)


def _x(cfg, b, s, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(dtype)


# ----------------------------------------------------------------- init
def test_mamba_init_matches_reference_tree():
    jcfg, cfg = _cfgs(HYMBA, param_dtype="bfloat16")
    tree = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
    mod = ssm.Mamba(cfg, device="cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    params = dict(mod.named_parameters())
    assert set(params) == set(tree)
    for name, arr in tree.items():
        p = params[name]
        assert tuple(p.shape) == arr.shape, name
        assert str(p.dtype)[6:] == str(arr.dtype), name
    for name in ("b_dt", "a_log", "d_skip"):
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(tree[name]), err_msg=name)
    assert ssm.mamba_state_shape(cfg, 3) == jssm.mamba_state_shape(jcfg, 3)
    assert ssm.mamba_state_shape(cfg, 3) == (3, 128, 4)


def test_rwkv_init_matches_reference_tree():
    jcfg, cfg = _cfgs(RWKV, param_dtype="bfloat16")
    tree = jssm.init_rwkv6(jax.random.PRNGKey(0), jcfg)
    mod = ssm.RWKV6(cfg, device="cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    params = dict(mod.named_parameters())
    assert set(params) == set(tree)
    for name, arr in tree.items():
        p = params[name]
        assert tuple(p.shape) == arr.shape, name
        assert str(p.dtype)[6:] == str(arr.dtype), name
        if name.startswith("mu_") or name in ("b_w", "ln_x"):
            np.testing.assert_array_equal(p.numpy(), np.asarray(arr),
                                          err_msg=name)
    # The truncated normals' scales: u_bonus 0.5, w_w a tenth of w_r's.
    assert float(params["u_bonus"].abs().max()) <= 1.0
    ratio = float(params["w_w"].float().std() / params["w_r"].float().std())
    assert 0.05 < ratio < 0.2
    assert ssm.rwkv6_state_shapes(cfg, 2) == jssm.rwkv6_state_shapes(jcfg, 2)
    assert ssm.rwkv6_state_shapes(cfg, 2)["wkv"] == (2, 4, 16, 16)


# ---------------------------------------------------------------- mamba
@pytest.mark.parametrize("chunk", MAMBA_CHUNKS)
def test_mamba_forward_matches(chunk, monkeypatch):
    monkeypatch.setattr(ssm, "CHUNK_ELEMS", chunk)
    jcfg, cfg, tree, mod = _mamba(seed=1)
    x = _x(cfg, 2, 23, seed=2)
    want = jssm.mamba_forward(tree, jnp.asarray(x), jcfg)
    got = ssm.mamba_forward(mod, _t(x), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_forward_matches_in_bfloat16():
    jcfg, cfg, tree, mod = _mamba(seed=3, dtype="bfloat16",
                                  param_dtype="bfloat16")
    x = _x(cfg, 2, 17, seed=4)
    want = jssm.mamba_forward(tree, jnp.asarray(x, jnp.bfloat16), jcfg)
    got = ssm.mamba_forward(mod, _t(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_mamba_decode_matches_and_equals_the_scan():
    """Eleven one-token steps from a zero state on both sides: outputs and
    states at every step; the port's steps equal its own full-sequence
    path."""
    jcfg, cfg, tree, mod = _mamba(seed=5)
    x = _x(cfg, 3, 11, seed=6)
    jstate = jnp.zeros(jssm.mamba_state_shape(jcfg, 3), jnp.float32)
    state = torch.zeros(ssm.mamba_state_shape(cfg, 3))
    outs = []
    for t in range(x.shape[1]):
        jy, jstate = jssm.mamba_decode(tree, jnp.asarray(x[:, t:t + 1]),
                                       jstate, jcfg)
        y, state = ssm.mamba_decode(mod, _t(x[:, t:t + 1]), state, cfg)
        assert tuple(y.shape) == (3, 1, cfg.d_model)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
        outs.append(y)
    full = ssm.mamba_forward(mod, _t(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_mamba_step_matches():
    jcfg, cfg, tree, mod = _mamba(seed=7)
    rng = np.random.default_rng(8)
    di, n = tree["w_b"].shape
    state = rng.normal(size=(2, di, n)).astype(np.float32)
    xin, z = (rng.normal(size=(2, di)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.001, 0.1, (2, di)).astype(np.float32)
    b_t, c_t = (rng.normal(size=(2, n)).astype(np.float32) for _ in range(2))
    ins = (xin, z, dt, b_t, c_t)
    jst, jy = jssm._mamba_step(tree, jnp.asarray(state),
                               *map(jnp.asarray, ins))
    st, y = ssm._mamba_step(mod, _t(state), *map(_t, ins))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


# ---------------------------------------------------------------- rwkv6
@pytest.mark.parametrize("chunk", RWKV_CHUNKS)
def test_rwkv_time_mix_matches(chunk, monkeypatch):
    monkeypatch.setattr(ssm, "CHUNK_ELEMS", chunk)
    jcfg, cfg, tree, mod = _rwkv(seed=1)
    x = _x(cfg, 2, 19, seed=2)
    want = jssm.rwkv6_time_mix(tree, jnp.asarray(x), jcfg)
    got = ssm.rwkv6_time_mix(mod, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rwkv_channel_mix_matches():
    jcfg, cfg, tree, mod = _rwkv(seed=3)
    x, prev = _x(cfg, 2, 7, seed=4), _x(cfg, 2, 7, seed=5)
    want = jssm.rwkv6_channel_mix(tree, jnp.asarray(x), jnp.asarray(prev))
    got = ssm.rwkv6_channel_mix(mod, _t(x), _t(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rwkv_time_inputs_decay_in_unit_interval():
    jcfg, cfg, tree, mod = _rwkv(seed=6)
    x, prev = _x(cfg, 2, 5, seed=7), _x(cfg, 2, 5, seed=8)
    want = jssm._rwkv_time_inputs(tree, jnp.asarray(x), jnp.asarray(prev))
    got = ssm._rwkv_time_inputs(mod, _t(x), _t(prev))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert bool(((got[-1] > 0) & (got[-1] < 1)).all())


def test_rwkv_decode_matches_and_equals_the_scan():
    """Nine steps of the time and channel decodes from zero states on both
    sides: outputs and states; the port's time-mix steps equal its
    full-sequence time-mix, and its channel steps the full channel-mix
    over the token-shifted inputs."""
    jcfg, cfg, tree, mod = _rwkv(seed=9)
    b, s = 3, 9
    x = _x(cfg, b, s, seed=10)
    shapes = ssm.rwkv6_state_shapes(cfg, b)
    jst = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    st = {k: torch.zeros(v) for k, v in shapes.items()}
    t_outs, c_outs = [], []
    for t in range(s):
        a = x[:, t]
        jy, jnew = jssm.rwkv6_time_decode(
            tree, jnp.asarray(a), {"wkv": jst["wkv"], "x_tm": jst["x_tm"]},
            jcfg)
        y, new = ssm.rwkv6_time_decode(
            mod, _t(a), {"wkv": st["wkv"], "x_tm": st["x_tm"]}, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for key in ("wkv", "x_tm"):
            np.testing.assert_allclose(new[key].numpy(),
                                       np.asarray(jnew[key]), **TOL)
        jy2, jcm = jssm.rwkv6_channel_decode(tree, jnp.asarray(a),
                                             jst["x_cm"])
        y2, cm = ssm.rwkv6_channel_decode(mod, _t(a), st["x_cm"])
        np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
        np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
        jst = {"wkv": jnew["wkv"], "x_tm": jnew["x_tm"], "x_cm": jcm}
        st = {"wkv": new["wkv"], "x_tm": new["x_tm"], "x_cm": cm}
        t_outs.append(y)
        c_outs.append(y2)
    full = ssm.rwkv6_time_mix(mod, _t(x), cfg)
    np.testing.assert_allclose(torch.stack(t_outs, 1).numpy(), full.numpy(),
                               **TOL)
    prev = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    chan = ssm.rwkv6_channel_mix(mod, _t(x), _t(prev))
    np.testing.assert_allclose(torch.stack(c_outs, 1).numpy(), chan.numpy(),
                               **TOL)


def test_rwkv_step_matches():
    jcfg, cfg, tree, mod = _rwkv(seed=11)
    rng = np.random.default_rng(12)
    h = cfg.resolved_ssm_heads
    hd = cfg.d_model // h
    wkv = rng.normal(size=(2, h, hd, hd)).astype(np.float32)
    r, k, v = (rng.normal(size=(2, cfg.d_model)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (2, cfg.d_model)).astype(np.float32)
    jw, jo = jssm._rwkv_step(tree, jnp.asarray(wkv), *map(jnp.asarray,
                                                         (r, k, v, w)), h)
    gw, go = ssm._rwkv_step(mod, _t(wkv), *map(_t, (r, k, v, w)), h)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(go.numpy(), np.asarray(jo), **TOL)


def test_scans_read_nothing_back_to_the_host(monkeypatch):
    """No ``.item()``, ``.cpu()`` or ``.tolist()`` inside either time loop:
    each would be a host sync a step on the card."""
    jcfg, cfg, tree, mamba = _mamba(seed=13)
    _, rcfg, _, rwkv = _rwkv(seed=13)
    calls = []
    for name in ("item", "cpu", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    with torch.no_grad():
        ssm.mamba_forward(mamba, torch.randn(2, 9, cfg.d_model), cfg)
        ssm.rwkv6_time_mix(rwkv, torch.randn(2, 9, rcfg.d_model), rcfg)
    assert calls == []
