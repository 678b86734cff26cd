"""The counts against counts made by hand at small shapes."""

import pytest

from portbench.counts import attention, h100, model_step


@pytest.mark.parametrize("seq,window", [(1, 0), (7, 0), (7, 3), (7, 7),
                                        (7, 9), (12, 4)])
def test_attended_pairs_by_brute_force(seq, window):
    want = sum(1 for i in range(seq) for j in range(seq)
               if j <= i and (window == 0 or j > i - window))
    assert attention.attended_pairs(seq, window) == want


def test_attention_flops_bytes_and_least_time():
    # 2 x 8 tokens, 4 query heads on 2 key heads of 16, window 3.
    pairs = 3 * 4 // 2 + (8 - 3) * 3                     # 6 + 15
    assert attention.flops(2, 8, 4, 16, 3) == 4 * 2 * 4 * 16 * pairs
    assert attention.bytes_moved(2, 8, 4, 2, 16, 2) == \
        (2 * 2 * 8 * 4 * 16 + 2 * 2 * 8 * 2 * 16) * 2
    least = attention.least_seconds(2, 8, 4, 2, 16, 3, 2)
    assert least == max(attention.flops(2, 8, 4, 16, 3) / h100.PEAK_BF16_FLOPS,
                        attention.bytes_moved(2, 8, 4, 2, 16, 2) / h100.HBM_BW)


DENSE = dict(family="dense", n_layers=2, d_model=8, n_heads=2, n_kv_heads=1,
             d_ff=16, vocab_size=10, mlp_activation="gelu", sliding_window=3)


def test_dense_prefill_flops_by_hand():
    # Per layer: Q 8x8, K and V 8x4 each, O 8x8, MLP 8x16 twice; logits 8x10.
    per_token = 2 * (2 * (64 + 32 + 32 + 64 + 128 + 128) + 80)
    att = 2 * attention.flops(1, 5, 2, 4, 3)
    assert model_step.prefill_flops(DENSE, 1, 5) == 5 * per_token + att
    swiglu = dict(DENSE, mlp_activation="swiglu")
    assert model_step.prefill_flops(swiglu, 1, 5) == \
        5 * (per_token + 2 * 2 * 128) + att


def test_dense_decode_flops_by_hand():
    per_token = 2 * (2 * (64 + 32 + 32 + 64 + 128 + 128) + 80)
    keys = 1 + 2 + 3 + 3                                  # window 3
    assert model_step.decode_flops(DENSE, [0, 1, 2, 5]) == \
        4 * per_token + 4 * 2 * 4 * 2 * keys
    # A prefill is the decode steps of its positions.
    assert model_step.decode_flops(DENSE, range(5)) == \
        model_step.prefill_flops(DENSE, 1, 5)


def test_ssm_flops_by_hand():
    cfg = dict(family="ssm", n_layers=3, d_model=8, n_heads=1, n_kv_heads=1,
               d_ff=28, vocab_size=10, ssm_heads=2)
    products = 3 * (7 * 64 + 2 * 8 * 28) + 80
    state = 3 * 7 * 2 * 4 * 4
    assert model_step.prefill_flops(cfg, 2, 6) == 12 * (2 * products + state)
    assert model_step.decode_flops(cfg, range(6)) == \
        model_step.prefill_flops(cfg, 1, 6)


def test_full_size_counts_are_in_the_expected_range():
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    sc = json.loads((root / "portbench/configs/starcoder2-3b.json")
                    .read_text())["model"]
    rw = json.loads((root / "portbench/configs/rwkv6-3b.json")
                    .read_text())["model"]
    # About 2 x 3.0 B weights a token, attention on top.
    assert 6.0e9 < model_step.prefill_flops(sc, 1, 4096) / 4096 < 7.5e9
    assert 6.0e9 < model_step.prefill_flops(rw, 1, 4096) / 4096 < 6.5e9
