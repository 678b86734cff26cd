"""``repro_torch.core.colocation`` and ``regression.profile_to_training_set``
against the reference's, on the same records and the same fitted Eq. 4
coefficients (``convert.category_model_from_numpy``).

The numpy parts (job stacks, job profiles, the training triples) must be
exact; ``plan_colocation``'s pairs identical and its predicted cost within
1e-5 relative (the port scores in float32 torch, the reference in float32
XLA); ``evaluate_placement`` within 1e-12.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import colocation as jcol  # noqa: E402
from repro.core import isc as jisc  # noqa: E402
from repro.core import regression as jreg  # noqa: E402
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import colocation, regression  # noqa: E402

#: The reference's stand-in jobs (``examples/colocation_demo.py``): name,
#: compute_s, memory_s, collective_s, useful_flops_ratio.
FALLBACK_JOBS = [
    ("gemma-7b/train_4k", 0.9, 0.5, 0.3, 0.8),
    ("kimi-k2/train_4k", 0.3, 0.9, 1.2, 0.5),
    ("llama3.2-3b/decode_32k", 0.05, 0.9, 0.1, 0.9),
    ("rwkv6-3b/long_500k", 0.1, 0.7, 0.05, 0.9),
    ("starcoder2-3b/prefill_32k", 0.8, 0.4, 0.2, 0.7),
    ("qwen2-moe/train_4k", 0.4, 0.6, 0.9, 0.6),
    ("whisper-v3/prefill_32k", 0.7, 0.5, 0.2, 0.75),
    ("hymba-1.5b/decode_32k", 0.1, 0.8, 0.1, 0.85),
]


def _fallback_records():
    return [{"arch": n.split("/")[0], "shape": n.split("/")[1],
             "compute_s": c, "memory_s": m, "collective_s": i,
             "useful_flops_ratio": u} for n, c, m, i, u in FALLBACK_JOBS]


def _seeded_records(n=64, seed=0):
    """``n`` records with the dry-run's keys, terms drawn from a seed
    (some useful ratios above 1, as a padded or capacity-dropping cell's)."""
    rng = np.random.default_rng(seed)
    terms = rng.lognormal(-2.0, 1.5, size=(n, 3))
    useful = rng.uniform(0.02, 1.2, size=n)
    return [{"arch": f"job{i}", "shape": "train_4k", "compute_s": float(c),
             "memory_s": float(m), "collective_s": float(k),
             "useful_flops_ratio": float(u)}
            for i, ((c, m, k), u) in enumerate(zip(terms, useful))]


@pytest.fixture(scope="module")
def models():
    """The reference's fitted SYNPA4_R-FEBE and the port's copy of it."""
    jm = jtr.build_all_models(
        jmc.SMTMachine(jmc.MachineParams(), seed=0),
        methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE}, solo_quanta=30,
        pair_quanta=6)[0]["SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    return jm, tm


@pytest.mark.parametrize("records", [_fallback_records(), _seeded_records()],
                         ids=["stand-in", "seeded-64"])
def test_job_stacks_and_profiles_exact(records):
    for r in records:
        want = jcol.job_stack_from_record(r)
        got = colocation.job_stack_from_record(r)
        np.testing.assert_array_equal(got, want)
        jp, tp = jcol.job_profile("j", want), colocation.job_profile("j", got)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_profile_to_training_set_exact():
    rng = np.random.default_rng(3)
    st = rng.dirichlet(np.ones(4), size=10)
    pairs = [(0, 1), (2, 7), (9, 3), (4, 4), (5, 8)]
    smt = rng.uniform(0.1, 2.0, size=(len(pairs), 2, 4))
    want = jreg.profile_to_training_set(st, smt, pairs)
    got = regression.profile_to_training_set(st, smt, pairs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("records", [_fallback_records(), _seeded_records()],
                         ids=["stand-in", "seeded-64"])
def test_plan_colocation_matches(models, records):
    jm, tm = models
    want = jcol.plan_colocation(records, jm)
    got = colocation.plan_colocation(records, tm, device="cpu")
    assert got.pairs == want.pairs
    assert got.job_names == want.job_names
    assert got.named_pairs() == want.named_pairs()
    np.testing.assert_allclose(got.predicted_cost, want.predicted_cost,
                               rtol=1e-5)
    for pairs in (want.pairs, [(i, i + 1) for i in range(0, len(records), 2)]):
        np.testing.assert_allclose(
            colocation.evaluate_placement(records, pairs),
            jcol.evaluate_placement(records, pairs), rtol=0, atol=1e-12)
