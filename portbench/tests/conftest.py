"""The kimi-k2-instruct cell's smoke sizes, added to :mod:`_smoke`'s
tables before the tests that take every cell are collected: the same
structure as the cell's model (a dense block, then moe blocks; 8 of 64
experts held, from id 8, top 8 as published; latent attention and YaRN
at small ranks), and two sequences a batch, so that half a batch can be
left out."""

from portbench.tests import _smoke

_smoke.CONFIGS.setdefault("kimi-k2-instruct", dict(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=256, n_experts=8, router_experts=64, expert_offset=8,
    n_experts_per_token=8, moe_d_ff=32, q_lora_rank=24, kv_lora_rank=16,
    qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
    rope_original_max_len=64))
_smoke.MIXES.setdefault("prefill_spans", dict(batch=2, lengths=[24, 32, 40]))
