"""The port's checkpoints: ``repro_torch.checkpoint`` against
``repro.checkpoint`` and ``repro_torch.online.run_device_sim_checkpointed``
against the port's own ``run_device_sim`` and the reference's
``repro.online.device_sim.run_device_sim_checkpointed``, on the CPU.

* ``save_tree`` / ``load_tree`` round trip (numpy and tensor leaves),
  corruption and shape mismatch refused, the manager's rotation and crash
  recovery: the reference's cases (``tests/test_substrates.py``);
* the on-disk format is the reference's: a port checkpoint loads in
  ``repro.checkpoint.load_tree`` and a reference one in the port's, both
  with ``like=None`` and with a ``like`` tree;
* the segmented run equals ``run_device_sim`` bit for bit on the same
  device (its finish log already lives in the state), rings included;
  killed after 2 of 4 segments and resumed, it equals the run left alone
  bit for bit; one host round trip a segment (``CKPT_SYNCS``);
* a snapshot of another configuration, or of the reference package, is
  refused with "mismatch"; ``resume=False`` restarts; a horizon that is
  not a whole number of segments is refused;
* against the reference's checkpointed run on the same draws
  (``JaxDraws``), integer logs are identical and finish quanta within
  rtol 1e-5 (the float32 finish arithmetic rounds in each library's
  order).
"""

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.checkpoint as jck  # noqa: E402
from repro.core import isc as jisc  # noqa: E402
from repro.online import ClusterSim as JClusterSim  # noqa: E402
from repro.online import FaultProfile as JFaultProfile  # noqa: E402
from repro.online import PoissonArrivals as JPoissonArrivals  # noqa: E402
from repro.online.device_sim import (  # noqa: E402
    run_device_sim_checkpointed as j_checkpointed)
from repro.smt import machine as jmc  # noqa: E402
from repro.smt import training as jtr  # noqa: E402
from repro.smt.apps import pool_profiles as j_pool  # noqa: E402
from repro.smt.scan_engine import ScanPolicy as JScanPolicy  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.convert import category_model_from_numpy  # noqa: E402
from repro_torch.core import isc as tisc  # noqa: E402
from repro_torch.online import (  # noqa: E402
    ClusterSim,
    FaultProfile,
    PoissonArrivals,
    run_device_sim_checkpointed,
)
from repro_torch.online import device_sim as tds  # noqa: E402
from repro_torch.online.device_sim import run_device_sim  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt.apps import pool_profiles as t_pool  # noqa: E402
from repro_torch.smt.scan_engine import ScanPolicy  # noqa: E402
from test_torch_online import _assert_integer_logs_equal, _finish  # noqa: E402
from test_torch_scan_engine import JaxDraws  # noqa: E402

QUANTA, SEG = 32, 8


# ----------------------------------------------------------- the format
def test_roundtrip_numpy_and_tensors(tmp_path):
    tree = {"a": {"w": np.arange(12, dtype=np.float32).reshape(3, 4)},
            "b": torch.arange(5), "c": [torch.ones(2, dtype=torch.bool),
                                        np.int32(7)], "skip": None}
    path = str(tmp_path / "ck")
    tck.save_tree(path, tree, extra_meta={"step": 7})
    got, meta = tck.load_tree(path, like=tree)
    assert meta["step"] == 7 and got["skip"] is None
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    assert isinstance(got["b"], torch.Tensor) and torch.equal(got["b"],
                                                              tree["b"])
    assert torch.equal(got["c"][0], tree["c"][0]) and got["c"][1] == 7
    nested, _ = tck.load_tree(path)
    assert sorted(nested) == ["a", "b", "c"] and sorted(nested["c"]) == \
        ["0", "1"]


def test_corruption_detected(tmp_path):
    tree = {"w": torch.ones(4, 4)}
    path = str(tmp_path / "ck")
    tck.save_tree(path, tree)
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        tck.load_tree(path, like=tree)


def test_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ck")
    tck.save_tree(path, {"w": np.ones((4, 4), np.float32)})
    with pytest.raises(ValueError):
        tck.load_tree(path, like={"w": np.ones((2, 2), np.float32)})
    with pytest.raises(KeyError):
        tck.load_tree(path, like={"v": np.ones((4, 4), np.float32)})


def test_manager_rotation_and_crash_recovery(tmp_path):
    root = str(tmp_path / "ckpts")
    mgr = tck.CheckpointManager(root, keep=2)
    tree = {"w": torch.zeros(3)}
    for step in (10, 20, 30):
        tree["w"] = tree["w"] + 1
        mgr.save(step, tree)
    assert mgr.latest_step() == 30
    assert len(os.listdir(root)) == 2      # rotation pruned step 10
    # A crash mid-write of step 40: its manifest is garbage.
    bad = os.path.join(root, "step_00000040")
    os.makedirs(bad)
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        f.write("{not json")
    step, got, meta = mgr.restore_latest(like=tree)
    assert step == 30 and meta["step"] == 30
    assert torch.equal(got["w"], tree["w"])
    assert not os.path.exists(bad)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = {"carry": {"x": torch.arange(6, dtype=torch.int64).reshape(2, 3),
                      "f": torch.linspace(0, 1, 4)},
            "ys": [np.ones(3, np.float32), np.zeros((2, 2), bool)]}
    path = str(tmp_path / "port")
    tck.save_tree(path, tree, extra_meta={"who": "port"})
    got, meta = jck.load_tree(path)
    assert meta == {"who": "port"}
    np.testing.assert_array_equal(got["carry"]["x"], tree["carry"]["x"])
    np.testing.assert_array_equal(got["ys"]["1"], tree["ys"][1])
    # The reference's own flattening reads it into the same structure.
    like = {"carry": {"x": np.zeros((2, 3), np.int64),
                      "f": np.zeros(4, np.float32)},
            "ys": [np.zeros(3, np.float32), np.zeros((2, 2), bool)]}
    back, _ = jck.load_tree(path, like=like)
    np.testing.assert_array_equal(np.asarray(back["carry"]["f"]),
                                  tree["carry"]["f"].numpy())


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = {"a": {"w": np.arange(8, dtype=np.float32)},
            "b": [np.int32(4), np.ones((2, 2), np.int32)]}
    path = str(tmp_path / "ref")
    jck.save_tree(path, tree, extra_meta={"step": 3})
    nested, meta = tck.load_tree(path)
    assert meta == {"step": 3}
    np.testing.assert_array_equal(nested["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(nested["b"]["1"], tree["b"][1])
    like = {"a": {"w": torch.zeros(8)},
            "b": [np.int32(0), torch.zeros(2, 2, dtype=torch.int32)]}
    got, _ = tck.load_tree(path, like=like)
    assert torch.equal(got["a"]["w"], torch.arange(8, dtype=torch.float32))
    assert got["b"][1].dtype == torch.int32


# ------------------------------------------------------- the runner
#: The reference's fault profile for the checkpoint tests
#: (``tests/test_faults.py``): two failures, staggered recoveries, one
#: straggler window.
def _profile(cls):
    return cls(fail=((5, 1), (9, 0)), recover=((12, 1), (15, 0)),
               straggle=((2, 4, 20, 0.5),), max_retries=2, backoff_quanta=2)


@pytest.fixture(scope="module")
def env():
    jmach = jmc.SMTMachine(jmc.MachineParams(), seed=0)
    jm = jtr.build_all_models(
        jmach, methods={"SYNPA4_R-FEBE": jisc.SYNPA4_R_FEBE})[0][
            "SYNPA4_R-FEBE"]
    tm = category_model_from_numpy(np.asarray(jm.coeffs), np.asarray(jm.mse),
                                   jm.n_categories, device="cpu")
    return dict(jmach=jmach, tmach=tmc.SMTMachine(tmc.MachineParams(), seed=0),
                jm=jm, tm=tm, jpool=j_pool(), tpool=t_pool())


#: The runner's cases: (policy, capacity's cores, faulted).  ``adjacent``
#: on the single-phase pool is the reference's own case; ``synpa4`` runs
#: the fused step, the repair matcher and the fault path.
CASES = {"adjacent": ("adjacent", 4, True), "synpa4": ("synpa", 8, True)}


def _single_phase(pool):
    return [dataclasses.replace(p, phases=(p.phases[0],)) for p in pool]


def _tsim(env, case, seed=3):
    kind, n_cores, faulted = CASES[case]
    pool = env["tpool"]
    if kind == "adjacent":
        pol, pool = ScanPolicy(kind="adjacent"), _single_phase(pool)
        mach, rate, scale = tmc.SMTMachine(tmc.MachineParams(), seed=0), \
            0.5, 0.1
    else:
        pol = ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                         model=env["tm"])
        mach, rate, scale = env["tmach"], 1.5, 0.08
    return ClusterSim(mach, pool, n_cores, pol,
                      PoissonArrivals(rate=rate, n_pool=len(pool)),
                      seed=seed, target_scale=scale, engine="scan",
                      device="cpu",
                      faults=_profile(FaultProfile) if faulted else None)


def _jsim(env, case, seed=3):
    kind, n_cores, faulted = CASES[case]
    pool = env["jpool"]
    if kind == "adjacent":
        pol, pool = JScanPolicy(kind="adjacent"), _single_phase(pool)
        mach, rate, scale = jmc.SMTMachine(jmc.MachineParams(), seed=0), \
            0.5, 0.1
    else:
        pol = JScanPolicy(kind="synpa", method=jisc.SYNPA4_R_FEBE,
                          model=env["jm"])
        mach, rate, scale = env["jmach"], 1.5, 0.08
    return JClusterSim(mach, pool, n_cores, pol,
                       JPoissonArrivals(rate=rate, n_pool=len(pool)),
                       seed=seed, target_scale=scale, engine="scan",
                       faults=_profile(JFaultProfile) if faulted else None)


def _assert_bitwise(a, b):
    _assert_integer_logs_equal(a, b)
    np.testing.assert_array_equal(_finish(a), _finish(b))
    for series in ("evictions", "requeues", "failures", "recoveries",
                   "straggling"):
        np.testing.assert_array_equal(getattr(a, series), getattr(b, series),
                                      err_msg=series)
    assert (a.n_dropped, a.n_retry_waiting, a.n_in_flight) == \
        (b.n_dropped, b.n_retry_waiting, b.n_in_flight)


@pytest.fixture(scope="module")
def straight(env):
    """Each case's ``run_device_sim`` with both rings, on the reference's
    draws."""
    return {case: run_device_sim(_tsim(env, case), QUANTA, warmup=False,
                                 draws=JaxDraws(3), app_telemetry=True)
            for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_segmented_equals_run_device_sim(env, straight, case, tmp_path):
    """Same loop, same device: equal bit for bit, finish quanta and rings
    included; one host round trip a segment."""
    syncs = tds.CKPT_SYNCS
    seg = run_device_sim_checkpointed(_tsim(env, case), QUANTA, SEG,
                                      str(tmp_path / "ck"),
                                      app_telemetry=True, draws=JaxDraws(3))
    assert tds.CKPT_SYNCS - syncs == QUANTA // SEG
    ref = straight[case]
    assert ref.n_completed > 0 and ref.n_evicted > 0
    _assert_bitwise(seg, ref)
    np.testing.assert_array_equal(seg.telemetry.data, ref.telemetry.data)
    np.testing.assert_array_equal(seg.app_telemetry.data,
                                  ref.app_telemetry.data)


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_bit_identical(env, straight, case, tmp_path):
    ck = str(tmp_path / "ck")
    # "Crash" after 2 of 4 segments ...
    assert run_device_sim_checkpointed(
        _tsim(env, case), QUANTA, SEG, ck, max_segments=2,
        app_telemetry=True, draws=JaxDraws(3)) is None
    assert tck.CheckpointManager(ck).latest_step() == 2 * SEG
    # ... then resume: the run left alone, bit for bit.
    syncs = tds.CKPT_SYNCS
    res = run_device_sim_checkpointed(_tsim(env, case), QUANTA, SEG, ck,
                                      app_telemetry=True, draws=JaxDraws(3))
    assert tds.CKPT_SYNCS - syncs == 2
    _assert_bitwise(res, straight[case])
    np.testing.assert_array_equal(res.telemetry.data,
                                  straight[case].telemetry.data)
    np.testing.assert_array_equal(res.app_telemetry.data,
                                  straight[case].app_telemetry.data)
    # A finished run resumed again runs no segment and gives the same.
    again = run_device_sim_checkpointed(_tsim(env, case), QUANTA, SEG, ck,
                                        app_telemetry=True)
    assert tds.CKPT_SYNCS - syncs == 2
    _assert_bitwise(again, res)


def test_resume_skips_a_corrupt_snapshot(env, straight, tmp_path):
    ck = str(tmp_path / "ck")
    assert run_device_sim_checkpointed(
        _tsim(env, "adjacent"), QUANTA, SEG, ck, max_segments=3,
        app_telemetry=True, draws=JaxDraws(3)) is None
    newest = os.path.join(ck, f"step_{3 * SEG:08d}", "arrays.npz")
    with open(newest, "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad\xbe\xef")
    res = run_device_sim_checkpointed(_tsim(env, "adjacent"), QUANTA, SEG,
                                      ck, app_telemetry=True,
                                      draws=JaxDraws(3))
    _assert_bitwise(res, straight["adjacent"])


def test_config_mismatch_refused(env, tmp_path):
    ck = str(tmp_path / "ck")
    assert run_device_sim_checkpointed(_tsim(env, "adjacent", seed=3),
                                       QUANTA, SEG, ck,
                                       max_segments=1) is None
    with pytest.raises(AssertionError, match="mismatch"):
        run_device_sim_checkpointed(_tsim(env, "adjacent", seed=4), QUANTA,
                                    SEG, ck)
    with pytest.raises(AssertionError, match="mismatch"):
        run_device_sim_checkpointed(_tsim(env, "adjacent", seed=3), QUANTA,
                                    SEG, ck, telemetry=True)
    # resume=False ignores the stale snapshot instead.
    stats = run_device_sim_checkpointed(_tsim(env, "adjacent", seed=4),
                                        QUANTA, SEG, ck, resume=False)
    assert stats is not None and stats.n_arrived > 0


def test_reference_snapshot_refused_by_fingerprint(env, tmp_path):
    """A snapshot the reference's runner wrote is refused by the
    fingerprint's ``engine``, not by a shape error."""
    ck = str(tmp_path / "ck")
    assert j_checkpointed(_jsim(env, "adjacent"), QUANTA, SEG, ck,
                          max_segments=1) is None
    with pytest.raises(AssertionError, match="mismatch"):
        run_device_sim_checkpointed(_tsim(env, "adjacent"), QUANTA, SEG, ck)


def test_horizon_must_divide(env, tmp_path):
    with pytest.raises(AssertionError, match="whole number"):
        run_device_sim_checkpointed(_tsim(env, "adjacent"), 30, SEG,
                                    str(tmp_path / "ck"))


@pytest.mark.parametrize("case", list(CASES))
def test_matches_reference_checkpointed(env, straight, case, tmp_path):
    """The reference's checkpointed run against the port's, same traffic,
    faults and draws: integer logs identical, finish quanta within rtol
    1e-5."""
    want = j_checkpointed(_jsim(env, case), QUANTA, SEG,
                          str(tmp_path / "ref"))
    got = run_device_sim_checkpointed(_tsim(env, case), QUANTA, SEG,
                                      str(tmp_path / "port"),
                                      draws=JaxDraws(3))
    assert want.n_completed > 0
    _assert_integer_logs_equal(got, want)
    np.testing.assert_allclose(_finish(got), _finish(want), rtol=1e-5)
    for series in ("evictions", "requeues"):
        np.testing.assert_array_equal(getattr(got, series),
                                      getattr(want, series), err_msg=series)
