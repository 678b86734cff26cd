"""``repro_torch.serve`` and ``repro_torch.launch.serve`` over a real
process group: gloo ranks on the CPU (``torch.multiprocessing.spawn``, one
spawn a world size; the rank bodies in ``torch_mesh_ranks.py``, which
imports no JAX), each serving over ``make_host_mesh(1)`` with
``make_plan(fsdp=False)`` and held to the one-process run from the same
seed.

The cases: the smoke configs of all seven families (float32,
``attention_impl="kernel"``, the config's moe dispatch, every cross gate
at 0.5 on both sides, since ``tanh(0)`` hides the cross-attention) on 2
ranks, 4 slots; qwen1.5-0.5b on 4 ranks (one slot each) and on 3 (the
slots do not divide: the rows stay whole on every rank).  For each, on
every rank:

* greedy ``generate`` tokens identical (7 requests of 2-9 tokens through
  4 slots, 5 new tokens each: slots are reset mid-run), every greedy
  choice won by more than ``LOGIT_REL`` of the largest |logit| (the
  near-tie rule of ``test_torch_families.py``);
* sampled tokens identical under one generator seed;
* 20 decode steps by hand, slot 1 reset after step 8: logits within
  ``LOGIT_REL_MESH`` (1e-5) of the largest |logit| at every step; every
  state tensor after them (positions, K/V and its rings, Mamba and RWKV
  states, embeddings) within ``STATE_REL`` (1e-6) of its largest |value|
  (positions exactly); a step writes the
  cache's own tensors, which keep the layout ``sharding.cache_sharding``
  gives them;
* ``ServeEngine.prefill`` of 4 x 12 tokens within 1e-5 of the largest
  |logit|, the flash wrapper called once a self (and encoder) block with
  plain tensors (it refuses DTensors); ``prefill_into_cache`` of the same
  tokens within 1e-5 too.

Then ``serve_demo`` joined to the group on 2, 3 and 4 ranks gives the
one-process ``serve_demo``'s tokens; the dense model on the reference's
weights (carried through ``convert`` in an ``.npz`` file) gives the
reference's ``ServeEngine.generate`` tokens over 2 ranks; the flash
wrapper and a kernel's input check refuse a DTensor; and the command line
serves under ``torch.distributed.run``.  ``lookup`` and ``put_rows`` with
plain ids are held on a (2, 1) mesh in ``test_torch_sharding.py``.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import get_config as jget  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402

LOGIT_REL = 2e-5
LOGIT_REL_MESH = 1e-5
STATE_REL = 1e-6
FAMILIES = {"qwen1.5-0.5b": 0, "qwen2-moe-a2.7b": 1, "starcoder2-3b": 2,
            "hymba-1.5b": 3, "rwkv6-3b": 4, "llama-3.2-vision-11b": 5,
            "whisper-large-v3": 6}
#: world size -> {case: (arch, seed)}.
WORLDS = {2: {f"{a}-2": (a, s) for a, s in FAMILIES.items()},
          3: {"qwen1.5-0.5b-3": ("qwen1.5-0.5b", 7)},
          4: {"qwen1.5-0.5b-4": ("qwen1.5-0.5b", 8)}}
CASES = {name: world for world, cases in WORLDS.items() for name in cases}
REF_ARCH, REF_SEED = "qwen1.5-0.5b", 9


def _reference(path):
    """The reference's dense smoke model (float32): its weights written
    through ``convert`` to ``path`` (an ``.npz`` file, keys joined by "/")
    and its greedy ``generate`` tokens on the rank bodies' prompts."""
    cfg = jget(REF_ARCH, smoke=True, dtype="float32", param_dtype="float32")
    jm = jbuild(cfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(REF_SEED)))
    tree = convert.model_params_to_numpy(
        convert.model_params_from_numpy(params, cfg, device="cpu"))
    flat = {"/".join(k): v for k, v in _flat(tree)}
    np.savez(path, **flat)
    prompts = ranks.serve_inputs(cfg, 0)[0]
    return [np.asarray(t).tolist() for t in JServeEngine(
        jm, max_len=ranks.MAX_LEN, batch_size=ranks.SLOTS).generate(
            params, prompts, max_new_tokens=ranks.NEW_TOKENS)]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's readings]}, one spawn a world size, all three
    at once (the reference's run in this process between them), and the
    reference's tokens and the one-process ``serve_demo``'s."""
    root = tmp_path_factory.mktemp("serve_mesh")
    npz = str(root / "reference.npz")
    started = []
    for world in sorted(WORLDS, reverse=True):   # 2, the one with ref, last
        d = root / f"world{world}"
        d.mkdir()
        if world == 2:
            ref_tokens = _reference(npz)
        started.append(ranks.spawn(
            ranks.serve_rank, world, WORLDS[world],
            (npz, REF_ARCH) if world == 2 else None, str(d), join=False))
    demo = serve_demo("qwen1.5-0.5b", smoke=True, device="cpu")
    ranks.join_all(started)
    assert not dist.is_initialized()
    out = {world: [json.loads((root / f"world{world}" / f"rank{r}.json")
                              .read_text()) for r in range(world)]
           for world in WORLDS}
    return out, ref_tokens, demo["generated"]


def _case(runs, name):
    world = CASES[name]
    return [r[name] for r in runs[0][world]]


@pytest.mark.parametrize("name", list(CASES))
def test_generate_greedy_matches_one_process(runs, name):
    for r in _case(runs, name):
        assert r["gap"] > LOGIT_REL
        assert len(r["tokens"]) == ranks.REQUESTS
        assert r["tokens"] == r["want_tokens"]


@pytest.mark.parametrize("name", list(CASES))
def test_sampling_matches_one_process(runs, name):
    for r in _case(runs, name):
        assert r["sampled_equal"]


@pytest.mark.parametrize("name", list(CASES))
def test_decode_logits_and_states_match(runs, name):
    for r in _case(runs, name):
        assert r["logit_err"] <= LOGIT_REL_MESH, r["logit_err"]
        assert r["state_err"][0] <= STATE_REL, r["state_err"]
        assert r["pos_equal"]
        assert r["own_tensors"], "a decode step made new state tensors"
        assert r["laid_out"], "a state left the cache's layout"


@pytest.mark.parametrize("name", list(CASES))
def test_flash_prefill_matches_one_process(runs, name):
    for r in _case(runs, name):
        assert r["prefill_err"] <= LOGIT_REL_MESH, r["prefill_err"]
        assert r["prefill_cache_err"] <= LOGIT_REL_MESH, r["prefill_cache_err"]
        assert r["prefill_cache_pos"]
        want = 0 if r["attention_free"] else r["self_blocks"]
        assert r["flash_calls"] == ["Tensor"] * want


@pytest.mark.parametrize("world", list(WORLDS))
def test_serve_demo_over_ranks_gives_one_process_tokens(runs, world):
    for r in runs[0][world]:
        assert r["serve_demo"]["ranks"] == world
        assert r["serve_demo"]["generated"] == runs[2]


def test_dense_model_gives_the_reference_tokens(runs):
    for r in runs[0][2]:
        assert r["reference"]["tokens"] == runs[1]
        assert r["reference"]["gap"] > LOGIT_REL


def test_flash_wrapper_and_input_check_refuse_a_dtensor(runs):
    for world in WORLDS:
        for r in runs[0][world]:
            assert len(r["refused"]) == 2
            assert all("is a DTensor" in msg for msg in r["refused"])


def test_torchrun_serves_on_two_gloo_ranks():
    """The command line under ``torch.distributed.run``: ``serve_demo``
    joins the group from the environment it sets and serves over both
    ranks; rank 0 alone prints."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--smoke", "--device", "cpu", "--requests", "4"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("# served 4 requests") == 1, proc.stdout
    assert "over 2 rank(s)" in proc.stdout
