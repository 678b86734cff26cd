"""Kimi-K2-Instruct in the port (``configs/kimi_k2_instruct.py``): latent
attention with YaRN, a dense first block, and a sigmoid router over more
experts than are held, against the plain float32 reference
``portbench/reference/moe.py`` (which imports nothing of the port), on
the CPU at small widths of the same structure.

In float32 the port's arithmetic is the reference's up to float32
rounding: logits within 1e-5 of the largest, routing the same."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import moe as ref
from portbench.reference import weights as weights_mod
from portbench.reference.common import final_logits
from repro_torch.configs import kimi_k2_instruct
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.models import attention, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import ServeEngine

#: Small widths, the published structure: one dense block then moe
#: blocks, top 2 of 8 router experts, 4 held from id 2.
SMALL = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
             vocab_size=256, n_experts=4, router_experts=8, expert_offset=2,
             n_experts_per_token=2, moe_d_ff=32, q_lora_rank=24,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=8, rope_original_max_len=64, dtype="float32")


def _cfg(**over):
    c = kimi_k2_instruct.CONFIG.scaled(**dict(SMALL, **over))
    return {f: getattr(c, f) for f in c.__dataclass_fields__}


def _model(cfg, seed=1234):
    """The port's model holding the reference's draw, and the draw."""
    w = weights_mod.draw(cfg, seed, "cpu")
    model = Model(ModelConfig(**cfg), device="meta")
    params = dict(model.named_parameters())
    assert set(params) == set(w)
    for name, p in params.items():
        assert p.shape == w[name].shape and p.dtype == w[name].dtype, name
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf,
                torch.nn.Parameter(w[name], requires_grad=False))
    return model, w


def _ref_logits(cfg, w, toks):
    h = ref.hidden(w, cfg, torch.as_tensor(toks))
    return final_logits(w, cfg, h.reshape(-1, cfg["d_model"])).reshape(
        *h.shape[:2], -1)


def _close(got, want, rel=1e-5):
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())


def test_the_published_config():
    c = kimi_k2_instruct.CONFIG
    assert (c.n_layers, c.first_k_dense, c.d_model, c.n_heads) == (61, 1,
                                                                   7168, 64)
    assert (c.q_lora_rank, c.kv_lora_rank, c.qk_nope_head_dim,
            c.qk_rope_head_dim, c.v_head_dim) == (1536, 512, 128, 64, 128)
    assert (c.d_ff, c.n_experts, c.moe_d_ff, c.n_experts_per_token,
            c.n_shared_experts) == (18432, 384, 2048, 8, 1)
    assert c.resolved_router_experts == 384 and c.vocab_size == 163_840
    assert c.routed_scaling_factor == 2.827 and c.router_scoring == "sigmoid"
    # A latent cache entry: 512 + 64 bfloat16 values, 1,152 bytes.
    assert (c.kv_lora_rank + c.qk_rope_head_dim) * 2 == 1152


def test_the_softmax_scale_by_hand():
    m = 0.1 * math.log(32) + 1
    assert kimi_k2_instruct.CONFIG.mla_softmax_scale == pytest.approx(
        192 ** -0.5 * m * m, rel=1e-12)
    assert round(kimi_k2_instruct.CONFIG.mla_softmax_scale, 5) == 0.13086


def test_the_yarn_frequencies_by_hand():
    """Base 50000, 64 rotated dims, factor 32 over 4096 positions, both
    betas 1: the correction dim is 64 ln(4096 / 2 pi) / (2 ln 50000) =
    19.17, so dims 0-19 keep their frequency and 20-31 are divided by 32;
    cos and sin are scaled by mscale / mscale_all_dim = 1."""
    cfg = kimi_k2_instruct.CONFIG
    got = attention.yarn_inv_freq(cfg)
    assert 19 < 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(5e4)) < 20
    for i, f in enumerate(got.tolist()):
        plain = 50000.0 ** (-2 * i / 64)
        assert f == pytest.approx(plain if i <= 19 else plain / 32, rel=1e-6)
    cos, sin = attention.yarn_angles(torch.tensor([[0, 1000]]), cfg)
    assert torch.allclose(cos[0, 1], torch.cos(1000 * got), atol=1e-4)
    assert float(cos[0, 0].min()) == 1.0 and float(sin.abs()[0, 0].max()) == 0
    # The reference computes the same frequencies from the same formula.
    d = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    assert torch.allclose(ref.inv_freq(d), got, rtol=1e-6)


def test_the_flash_wrapper_takes_a_scale_and_a_smaller_v():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 9, 4, 12, generator=g)
    k = torch.randn(2, 9, 2, 12, generator=g)
    v = torch.randn(2, 9, 2, 8, generator=g)
    out = fa_ops.flash_attention(q, k, v, causal=True, scale=0.3)
    assert out.shape == (2, 9, 4, 8)
    kk, vv = k.repeat_interleave(2, 2), v.repeat_interleave(2, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 0.3
    s = s.masked_fill(torch.ones(9, 9).triu(1).bool(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    assert torch.allclose(out, want, atol=1e-6)
    # Without a scale, the true head dim's.
    assert torch.allclose(flash_attention_plain(q, k, v),
                          flash_attention_plain(q, k, v, scale=12 ** -0.5))


def test_forward_matches_the_reference():
    cfg = _cfg()
    model, w = _model(cfg)
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator()
                         .manual_seed(5))
    with torch.no_grad():
        got, aux = model.forward({"tokens": toks})
    _close(got, _ref_logits(cfg, w, toks))
    assert float(aux) == 0.0


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_then_latent_decode_matches_the_reference(impl):
    """``ServeEngine.prefill`` writes the prompt's latents into the cache,
    then 6 greedy steps decode through it (absorbed attention): every
    step's logits are the reference's full forward's at that position."""
    cfg = _cfg(attention_impl=impl)
    model, w = _model(cfg)
    eng = ServeEngine(model, max_len=24, batch_size=2)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 11),
                                               dtype=np.int32)
    cache = model.init_cache(2, 24)
    assert set(cache) == {"pos", "c_kv", "k_pe"}
    assert cache["c_kv"].shape == (3, 2, 24, 16)
    assert cache["k_pe"].shape == (3, 2, 24, 8)
    logits = eng.prefill({"tokens": prompt}, cache=cache)
    assert cache["pos"].tolist() == [11, 11]
    seq = torch.as_tensor(prompt).long()
    steps = [logits[:, -1]]
    for _ in range(6):
        nxt = steps[-1].argmax(-1)
        seq = torch.cat([seq, nxt[:, None]], 1)
        out, cache = eng.serve_step(cache, nxt[:, None].int())
        steps.append(out[:, 0])
    assert cache["pos"].tolist() == [17, 17]
    want = _ref_logits(cfg, w, seq)
    _close(logits, want[:, :11])
    _close(torch.stack(steps[1:], 1), want[:, 11:])


def test_generate_decodes_through_the_latent_cache():
    """The slots' own one-token prompt feed, slot reuse included."""
    cfg = _cfg()
    model, w = _model(cfg)
    eng = ServeEngine(model, max_len=20, batch_size=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, (n,), dtype=np.int32) for n in (5, 3, 6)]
    outs = eng.generate(prompts, max_new_tokens=4, greedy=True)
    for p, o in zip(prompts, outs):
        seq = torch.as_tensor(np.concatenate([p, o[:-1]]))[None].long()
        want = _ref_logits(cfg, w, seq)[0, len(p) - 1:]
        chosen = want.gather(1, torch.as_tensor(o)[:, None].long())[:, 0]
        assert float((want.max(-1).values - chosen).max()) <= 1e-4


def test_the_ranks_shares_add_up_to_the_whole_layer():
    """Four ranks of 2 of the router's 8 experts (offsets 0, 2, 4, 6):
    their held experts' parts, with the shared expert counted once, sum
    to the uncut reference layer (all 8 held)."""
    whole = _cfg(n_experts=8, expert_offset=0, n_layers=2)
    model, w = _model(whole)
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(8))
    p = "blocks.1."
    with torch.no_grad():
        want = ref._moe(w, p, whole, x, False)
        shared = ref._swiglu(x, w[p + "moe.shared_wi"],
                             w[p + "moe.shared_wi_gate"],
                             w[p + "moe.shared_wo"], False)
        total = torch.zeros_like(x)
        for rank in range(4):
            cfg = ModelConfig(**dict(whole, n_experts=2,
                                     expert_offset=2 * rank))
            part = moe.MoE(cfg)
            for name, t in model.blocks[1].moe.named_parameters():
                if name.startswith("experts"):
                    t = t[2 * rank:2 * rank + 2]
                setattr(part, name, torch.nn.Parameter(t, requires_grad=False))
            y, _ = moe.moe_layer(part, x, cfg)
            total += y - (shared if rank else 0)
        port_whole, _ = moe.moe_layer(model.blocks[1].moe, x,
                                      ModelConfig(**whole))
    _close(total, want)
    _close(port_whole, want)


def test_a_routing_onto_one_expert_drops_nothing():
    """A correction bias that puts held expert 3 first for every token:
    all 2 x 40 tokens land on it (far past any capacity) and none is
    dropped; the weights still come from the unbiased scores."""
    cfg = _cfg()
    model, w = _model(cfg)
    for i in (1, 2):
        w[f"blocks.{i}.moe.router_bias"][3] = 100.0
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator()
                         .manual_seed(6))
    moe.held_pairs()
    from repro_torch.obs import trace as obs_trace
    obs_trace.enable()
    try:
        with torch.no_grad():
            got, _ = model.forward({"tokens": toks})
    finally:
        obs_trace.disable()
        obs_trace.clear()
    counts = moe.held_pairs()
    assert len(counts) == 2 and all(c >= 80 for c in counts)
    _close(got, _ref_logits(cfg, w, toks))


def test_counters_and_spans():
    from repro_torch.obs import trace as obs_trace

    cfg = _cfg()
    model, _ = _model(cfg)
    calls = (attention.MLA_PREFILL, attention.MLA_DECODE,
             moe.GROUPED_EXPERTS)
    obs_trace.enable()
    try:
        with torch.no_grad():
            model.forward({"tokens": torch.zeros((1, 5), dtype=torch.long)})
            cache = model.init_cache(1, 8)
            model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long))
        names = [e["name"] for e in obs_trace.events()]
    finally:
        obs_trace.disable()
        obs_trace.clear()
    assert attention.MLA_PREFILL - calls[0] == 3
    assert attention.MLA_DECODE - calls[1] == 3
    assert moe.GROUPED_EXPERTS - calls[2] == 4
    for name, n in (("mla.prefill", 3), ("mla.decode", 3), ("moe.route", 4),
                    ("moe.dispatch", 4), ("moe.experts", 4),
                    ("moe.combine", 4)):
        assert names.count(name) == n, name
    assert len(moe.held_pairs()) == 4
    assert moe.held_pairs() == []


def test_the_stream_stays_bfloat16_and_the_router_scores_in_float32(
        monkeypatch):
    """In bfloat16, as the configuration states, the blocks pass a
    bfloat16 stream and the router reads the bfloat16 normalised stream;
    its product, the scores and the weights are float32, as published."""
    cfg = _cfg(dtype="bfloat16")
    model, _ = _model(cfg)
    seen = []
    route = moe._route_sigmoid

    def spy(params, x, c):
        w, ids = route(params, x, c)
        seen.append((x.dtype, w.dtype))
        return w, ids

    monkeypatch.setattr(moe, "_route_sigmoid", spy)
    outs = []
    for blk in model.blocks:
        blk.register_forward_hook(lambda m, i, o: outs.append(o[0].dtype))
    with torch.no_grad():
        logits, _ = model.forward({"tokens": torch.zeros((1, 6),
                                                         dtype=torch.long)})
    assert outs == [torch.bfloat16] * 3
    assert seen == [(torch.bfloat16, torch.float32)] * 2
    assert logits.dtype == torch.float32


def _port_routes(model, toks, monkeypatch):
    """The port's greedy choices and its moe layers' expert choices."""
    ids = []
    route = moe._route_sigmoid

    def recording(params, x, c):
        w, top = route(params, x, c)
        ids.append(top)
        return w, top

    monkeypatch.setattr(moe, "_route_sigmoid", recording)
    with torch.no_grad():
        logits, _ = model.forward({"tokens": torch.as_tensor(toks)})
    monkeypatch.setattr(moe, "_route_sigmoid", route)
    return logits, ids


def test_the_reference_follows_the_ports_routes(monkeypatch):
    """Routed by the float32 port's own choices, the reference is the
    reference routing on its own, with a route gap of 0; a port that
    chose its experts at random is far from it."""
    cfg = _cfg()
    model, w = _model(cfg)
    toks = np.random.default_rng(5).integers(0, 256, (2, 12))
    _, ids = _port_routes(model, toks, monkeypatch)
    own = ref.Routes()
    want = ref.hidden(w, cfg, torch.as_tensor(toks), routes=own)
    assert len(ids) == len(own.ids) == cfg["n_layers"] - 1
    for a, b in zip(ids, own.ids):
        assert torch.equal(a.sort(-1).values, b.sort(-1).values)
    followed = ref.Routes(follow=ids)
    got = ref.hidden(w, cfg, torch.as_tensor(toks), routes=followed)
    assert torch.allclose(got, want, atol=1e-6)
    assert followed.gaps == [0.0] * len(ids)
    g = torch.Generator().manual_seed(3)
    at_random = [torch.stack([
        torch.randperm(cfg["router_experts"], generator=g)[
            :cfg["n_experts_per_token"]] for _ in range(a.shape[0])])
        for a in ids]
    wrong = ref.Routes(follow=at_random)
    ref.hidden(w, cfg, torch.as_tensor(toks), routes=wrong)
    assert min(wrong.gaps) > 0.05


def test_the_grouped_products_loop_off_the_card():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(10, 6, generator=g)
    w = torch.randn(3, 6, 5, generator=g).bfloat16()
    ends = torch.tensor([2, 2, 7], dtype=torch.int32)
    out = moe._grouped(x, w, ends)
    want = torch.cat([x[:2] @ w[0].float(), x[2:7] @ w[2].float()])
    assert torch.allclose(out[:7], want, atol=1e-5)


def test_the_reference_names_are_the_ports_at_full_size():
    cfg = {f: getattr(kimi_k2_instruct.CONFIG, f) for f in
           kimi_k2_instruct.CONFIG.__dataclass_fields__}
    cfg.update(n_layers=3, n_experts=12)
    specs = ref.param_specs(cfg)
    model = Model(ModelConfig(**cfg), device="meta")
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == {n: (tuple(s), dt) for n, (s, dt, _) in specs.items()}
    assert got["blocks.1.moe.router"] == ((7168, 384), "float32")
    assert got["blocks.1.moe.experts_wi"] == ((12, 7168, 2048), "bfloat16")
    assert got["blocks.0.mlp.wi"] == ((7168, 18432), "bfloat16")
