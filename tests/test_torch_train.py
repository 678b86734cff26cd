"""The LM training path (``repro_torch.{optim,data,train}``,
``launch/train.py``) against the reference's, on the same numpy inputs
and, through ``convert``, the same weights and optimizer state.

float32 smoke configs throughout.  Tolerances:

* schedules: 1e-7 abs/rel;
* ``adamw_update`` on the reference's stacked tree: 1e-6 abs/rel
  (bfloat16 moments: 2^-7 relative, one bfloat16 rounding);
* ``cross_entropy``: 1e-6; ``SyntheticLM``: bit for bit;
* three ``train_step``s on llama3.2-3b and qwen2-moe-a2.7b, weights and
  state carried across: loss, ``aux``, learning rate, parameters and
  moments within 2e-4 abs/rel.  The key bias ``attn.bk`` is added before
  RoPE, so only its fast-turning dimensions change the scores along a
  short sequence; in the slow ones its gradient is near zero, at the
  packages' float error, and AdamW divides that noise by its own size
  into a step of up to the learning rate.  So its first moment (the
  gradients) is held within 2e-4 of the largest first moment of the
  tree, and its elements whose reference first moment lies below that
  limit are held to the learning rate times the steps with lr > 0;
* ``remat`` "dots" and "full" against "none": bit for bit;
* a training checkpoint written by one package and resumed by the other:
  2e-4; by the port and resumed by the port: bit for bit.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.train.step import TrainStepBuilder as JBuilder  # noqa: E402
from repro.train.step import cross_entropy as jcross_entropy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.ckpt import load_tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.models.transformer import Model, reference_ndim  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train.step import TrainStepBuilder, cross_entropy  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _flat(tree):
    """A reference tree's leaves by their "/"-joined path, in its order."""
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in paths}


def _assert_tree_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


def _assert_state_close(got, want, steps=None):
    """Parameters and moments within ``TOL``; the key bias's first moment
    within 2e-4 of the tree's largest, and its elements whose gradients
    lie below that (near-zero, so AdamW steps on float noise) within the
    learning rate times the steps with lr > 0 (``steps`` steps, ``STEPS``
    by default, the first at lr 0)."""
    steps = steps or STEPS
    _assert_tree_close(got["opt"], want["opt"], **TOL)
    got_mu, want_mu = _flat(got["opt"]["mu"]), _flat(want["opt"]["mu"])
    mu_atol = 2e-4 * max(float(np.abs(m).max()) for m in want_mu.values())
    got_p, want_p = _flat(got["params"]), _flat(want["params"])
    assert got_p.keys() == want_p.keys()
    for key, w in want_p.items():
        # A key bias outside the graph (a cross block's) has no gradient
        # and is held to TOL as the rest.
        if not key.endswith("attn/bk") or not want_mu[key].any():
            np.testing.assert_allclose(got_p[key], w, err_msg=key, **TOL)
            continue
        np.testing.assert_allclose(got_mu[key], want_mu[key], rtol=0,
                                   atol=mu_atol, err_msg=key + " mu")
        noise = np.abs(want_mu[key]) <= mu_atol
        assert noise.mean() < 0.75, key     # a quarter or more have a gradient
        np.testing.assert_allclose(got_p[key][~noise], w[~noise],
                                   err_msg=key, **TOL)
        np.testing.assert_allclose(got_p[key][noise], w[noise], rtol=0,
                                   atol=LR * (steps - 1), err_msg=key)


# ---------------------------------------------------------- schedules
def test_schedules_match():
    steps = np.arange(41, dtype=np.int32)
    for warmup, total, peak, floor in ((5, 40, 3e-3, 0.0), (1, 10, 1e-2, 0.0),
                                       (10, 30, 1.0, 0.1), (0, 25, 0.5, 0.0)):
        got = schedule.linear_warmup_cosine(_t(steps), warmup, total, peak,
                                            floor)
        want = jschedule.linear_warmup_cosine(jnp.asarray(steps), warmup,
                                              total, peak, floor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-7)
        got = schedule.cosine_schedule(_t(steps), total, peak, floor)
        want = jschedule.cosine_schedule(jnp.asarray(steps), total, peak,
                                         floor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-7)
    # Step 0 of a warmup gives 0: the first update moves no parameter.
    assert float(schedule.linear_warmup_cosine(_t(0), 5, 40, 3e-3)) == 0.0


# -------------------------------------------------------------- AdamW
@functools.lru_cache(maxsize=None)
def _qwen_params():
    cfg = jget("qwen1.5-0.5b", smoke=True, **F32)
    return jax.tree.map(np.asarray,
                        jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("moments,compress", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_adamw_update_matches_on_a_stacked_tree(moments, compress):
    """The reference's stacked tree, flattened by path: every block leaf is
    (L, ...), so the rank rule decays its norm scales and biases too."""
    params = _qwen_params()
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda p: rng.normal(0, 0.05, p.shape).astype(np.float32), params)
    mdt = jnp.dtype(moments)
    state = {"mu": jax.tree.map(lambda p: jnp.asarray(
                 rng.normal(0, 0.01, p.shape), mdt), params),
             "nu": jax.tree.map(lambda p: jnp.asarray(
                 rng.uniform(0, 1e-3, p.shape), mdt), params),
             "count": jnp.asarray(3, jnp.int32)}
    ocfg = jadamw.AdamWConfig(lr=1e-2, moment_dtype=moments,
                              compress_grads=compress)
    key = jax.random.PRNGKey(17)
    want_p, want_s = jax.jit(functools.partial(
        jadamw.adamw_update, cfg=ocfg))(params, grads, state,
                                        lr=jnp.float32(1e-2), rng=key)

    noise = None
    if compress:   # the reference's draws, by leaf in its flattening order
        keys = jax.random.split(key, len(jax.tree.leaves(grads)))
        noise = {name: _t(jax.random.uniform(k, g.shape, jnp.float32,
                                             -0.5, 0.5))
                 for (name, g), k in zip(_flat(grads).items(), keys)}

    def tensors(tree):
        return {n: convert._tensor(a) for n, a in _flat(tree).items()}

    p_t, g_t = tensors(params), tensors(grads)
    s_t = {"mu": tensors(state["mu"]), "nu": tensors(state["nu"]),
           "count": torch.tensor(3, dtype=torch.int32)}
    got_p, got_s = adamw.adamw_update(
        p_t, g_t, s_t, adamw.AdamWConfig(lr=1e-2, moment_dtype=moments,
                                         compress_grads=compress),
        lr=torch.tensor(1e-2), noise=noise)
    assert got_p is p_t and int(got_s["count"]) == 4
    want_flat = _flat(want_p)
    for name, t in got_p.items():
        np.testing.assert_allclose(t.numpy(), want_flat[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    mtol = (dict(rtol=2 ** -7, atol=1e-9) if moments == "bfloat16"
            else dict(rtol=1e-6, atol=1e-6))
    for which in ("mu", "nu"):
        want_m = _flat(want_s[which])
        for name, t in got_s[which].items():
            assert t.dtype == getattr(torch, moments)
            np.testing.assert_allclose(t.float().numpy(),
                                       want_m[name].astype(np.float32),
                                       err_msg=name, **mtol)


def test_weight_decay_follows_the_reference_rank():
    """The port's blocks are 1-D where the reference's stacked leaves are
    2-D: block norm scales and QKV biases are decayed, ``final_norm`` is
    not.  With zero gradients only the decay moves a parameter."""
    cfg = get_config("qwen1.5-0.5b", smoke=True, **F32)
    builder = TrainStepBuilder(Model(cfg, "cpu"), warmup_steps=1)
    state = builder.init_state(torch.Generator().manual_seed(0))
    params = state["params"]
    for name in ("blocks.1.ln1.scale", "blocks.0.attn.bq", "final_norm.scale"):
        with torch.no_grad():
            params[name].normal_(generator=torch.Generator().manual_seed(1))
    before = {n: p.detach().clone() for n, p in params.items()}
    decay = {n: reference_ndim(n, p) >= 2 for n, p in params.items()}
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    lr, wd = 0.5, builder.opt.weight_decay
    adamw.adamw_update(params, zeros, state["opt"], builder.opt,
                       lr=torch.tensor(lr), decay=decay)
    for name in ("blocks.1.ln1.scale", "blocks.0.attn.bq", "blocks.0.attn.wq"):
        torch.testing.assert_close(params[name].detach(),
                                   before[name] * (1 - lr * wd))
    assert torch.equal(params["final_norm.scale"].detach(),
                       before["final_norm.scale"])


# ------------------------------------------------------ data and loss
def test_synthetic_batches_bit_for_bit():
    for vocab, seq, batch, seed in ((256, 16, 4, 0), (151_936, 33, 3, 7)):
        ours = SyntheticLM(vocab, seq, batch, seed=seed)
        ref = JSyntheticLM(vocab, seq, batch, seed=seed)
        for step in (0, 1, 17):
            got, want = ours.global_batch_at(step), ref.global_batch_at(step)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype == np.int32
                np.testing.assert_array_equal(got[key], want[key])
    ours, ref = SyntheticLM(256, 8, 4, seed=3), JSyntheticLM(256, 8, 4, seed=3)
    for host in (0, 1):
        np.testing.assert_array_equal(ours.host_batch(5, host, 2)["tokens"],
                                      ref.host_batch(5, host, 2)["tokens"])
    with pytest.raises(ValueError, match="split"):
        ours.host_batch(0, 0, 3)


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_matches(z_loss):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (2, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    got = cross_entropy(_t(logits), _t(labels), z_loss)
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- train step
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-2


@functools.lru_cache(maxsize=None)
def _reference_run(arch, grad_accum):
    """The reference's initial state, its per-step metrics and its state
    after ``STEPS`` steps on ``SyntheticLM`` batches (warmup 1: the first
    step has lr 0, the next ones lr > 0)."""
    cfg = jget(arch, smoke=True, **F32)
    builder = JBuilder(jbuild(cfg), jadamw.AdamWConfig(lr=LR),
                       grad_accum=grad_accum, warmup_steps=1, total_steps=10)
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


@pytest.mark.parametrize("arch,grad_accum", [(a, 1) for a in ARCHS]
                         + [(a, 2) for a in ARCHS])
def test_train_steps_match(arch, grad_accum):
    """Three steps from the reference's weights: loss, aux, lr, the
    parameters (AdamW's decay by the reference's rank, the MoE capacity
    drops of every microbatch) and the moments."""
    cfg, init, want_metrics, want_state = _reference_run(arch, grad_accum)
    builder = TrainStepBuilder(Model(convert.model_config_from(cfg), "cpu"),
                               adamw.AdamWConfig(lr=LR),
                               grad_accum=grad_accum, warmup_steps=1,
                               total_steps=10)
    state = convert.train_state_from_numpy(init, builder.model)
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    for it, want in enumerate(want_metrics):
        before = {n: p.detach().clone() for n, p in state["params"].items()}
        state, m = builder.train_step(state, data.global_batch_at(it))
        for key in ("loss", "aux", "lr"):
            np.testing.assert_allclose(float(m[key]), want[key], err_msg=key,
                                       **TOL)
        if it == 0:    # lr 0: only the moments and the count move
            for n, p in state["params"].items():
                assert torch.equal(p.detach(), before[n]), n
    if arch.startswith("qwen2-moe") and grad_accum == 1:
        assert want_metrics[-1]["aux"] > 0
    got = convert.train_state_to_numpy(state)
    assert int(got["step"]) == int(want_state["step"]) == STEPS
    assert int(got["opt"]["count"]) == STEPS
    _assert_state_close(got, want_state)


def _loss_and_grads(arch, remat):
    cfg = get_config(arch, smoke=True, remat=remat, **F32)
    builder = TrainStepBuilder(Model(cfg, "cpu"))
    state = builder.init_state(torch.Generator().manual_seed(3))
    batch = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=4).global_batch_at(0)
    batch = {k: _t(v) for k, v in batch.items()}
    total, metrics = builder.loss_fn(state["params"], batch)
    grads = torch.autograd.grad(total, list(state["params"].values()))
    return total, metrics["aux"], grads


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit(arch, remat):
    want = _loss_and_grads(arch, "none")
    got = _loss_and_grads(arch, remat)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_state_shapes_allocate_nothing():
    cfg = get_config("qwen2-moe-a2.7b")
    builder = TrainStepBuilder(Model(cfg, torch.device("meta")))
    shapes = builder.state_shapes()
    leaves = (list(shapes["params"].values()) + list(shapes["opt"]["mu"].values())
              + [shapes["opt"]["count"], shapes["step"]])
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in shapes["params"].values())
    assert n == sum(p.numel() for p in builder.model.parameters()) > 14e9
    assert shapes["opt"]["mu"]["blocks.3.moe.experts_wi"].dtype == torch.float32


def test_kernel_attention_is_refused_for_training():
    cfg = get_config("qwen1.5-0.5b", smoke=True, attention_impl="kernel")
    with pytest.raises(NotImplementedError, match="backward kernel"):
        TrainStepBuilder(Model(cfg, torch.device("meta")))


# ------------------------------------------- entry point and checkpoints
TRAIN = dict(smoke=True, steps=4, batch=2, seq=16, lr=3e-3, overrides=F32)


class _Killed(Exception):
    pass


def _kill_after_first_save(monkeypatch):
    """The port's ``train`` dies right after its first checkpoint."""
    save = CheckpointManager.save

    def dying(self, step, tree, meta=None):
        save(self, step, tree, meta)
        raise _Killed(step)

    monkeypatch.setattr(CheckpointManager, "save", dying)


def _final(ckpt_dir):
    step, tree, meta = CheckpointManager(ckpt_dir).restore_latest()
    assert step == TRAIN["steps"] and meta["arch"] == "llama3.2-3b"
    return tree


def _reference_loop(ckpt_dir, stop=None):
    """The reference ``train``'s loop (``repro/launch/train.py:72-107``) on
    the reference's step and checkpoint manager, for ``TRAIN``: resume
    from ``ckpt_dir``, save every 2 steps and at the end, stop after step
    ``stop``.  Its own ``train`` does not run under this JAX (a sharding
    error in the embedding gather), so the test drives the same calls."""
    steps = TRAIN["steps"]
    cfg = jget("llama3.2-3b", smoke=True, **F32)
    builder = JBuilder(jbuild(cfg), jadamw.AdamWConfig(lr=TRAIN["lr"]),
                       warmup_steps=max(steps // 10, 1), total_steps=steps)
    data = JSyntheticLM(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=0)
    manager = JManager(ckpt_dir)
    state = builder.init_state(jax.random.PRNGKey(0))
    start = 0
    latest, restored, meta = manager.restore_latest(like=state)
    if latest is not None:
        state, start = restored, int(meta.get("step", latest))
    step_fn = jax.jit(builder.train_step)
    for it in range(start, steps):
        hb = data.host_batch(it, 0, 1)
        state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in hb.items()})
        if (it + 1) % 2 == 0:
            manager.save(it + 1, jax.device_get(state),
                         meta={"arch": "llama3.2-3b"})
        if it + 1 == stop:
            return None
    manager.save(steps, jax.device_get(state), meta={"arch": "llama3.2-3b"})
    return state


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("port", "reference"), ("reference", "port")])
def test_training_checkpoint_resumes(writer, reader, tmp_path, monkeypatch):
    """Killed after the step-2 checkpoint, resumed by ``reader`` to step 4:
    the same final state as the writer's 4 uninterrupted steps."""
    run = dict(TRAIN, ckpt_every=2, device="cpu")
    full, split = str(tmp_path / "full"), str(tmp_path / "split")
    if writer == "port":
        train_mod.train("llama3.2-3b", ckpt_dir=full, **run)
        want = _final(full)
        with monkeypatch.context() as m:
            _kill_after_first_save(m)
            with pytest.raises(_Killed):
                train_mod.train("llama3.2-3b", ckpt_dir=split, **run)
    else:
        want = jax.tree.map(np.asarray, _reference_loop(full))
        _reference_loop(split, stop=2)
    if reader == "port":
        train_mod.train("llama3.2-3b", ckpt_dir=split, **run)
        got = _final(split)
    else:
        got = jax.tree.map(np.asarray, _reference_loop(split))
    if writer == reader:
        for key, arr in _flat(want).items():
            np.testing.assert_array_equal(_flat(got)[key], arr, err_msg=key)
    else:
        _assert_tree_close(got, want, **TOL)


def test_train_entry_point_trains_and_refuses_what_it_cannot_run(monkeypatch):
    out = train_mod.train("llama3.2-3b", smoke=True, steps=30, batch=4,
                          seq=32, log_every=5, device="cpu")
    assert out["final_loss"] < out["first_loss"] - 0.5
    # A mesh needs a process group: without one, make_host_mesh refuses.
    with pytest.raises(RuntimeError, match="initialised process group"):
        train_mod.train("llama3.2-3b", model_parallel=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train("llama3.2-3b", steps=1)


def test_bfloat16_state_survives_a_checkpoint(tmp_path):
    """bfloat16 leaves are written as the reference writes them (their
    raw bits, a 2-byte void) and come back bit for bit."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    model = build_model(cfg, device="cpu", seed=5)
    builder = TrainStepBuilder(model, adamw.AdamWConfig(
        moment_dtype="bfloat16"))
    state = builder.init_state(torch.Generator().manual_seed(5))
    state, _ = builder.train_step(state, SyntheticLM(
        cfg.vocab_size, 8, 2).global_batch_at(0))
    CheckpointManager(str(tmp_path)).save(1, convert.train_state_to_numpy(
        state))
    tree, _ = load_tree(str(tmp_path / "step_00000001"))
    assert tree["params"]["blocks"]["moe"]["experts_wi"].dtype == "V2"
    twin = build_model(cfg, device="cpu", seed=6)
    back = convert.train_state_from_numpy(tree, twin)
    for name, p in state["params"].items():
        assert back["params"][name].dtype == p.dtype
        assert torch.equal(back["params"][name], p), name
        assert torch.equal(back["opt"]["nu"][name], state["opt"]["nu"][name])
