"""The port's observability glue against the reference's, on the CPU:
``repro_torch.obs.{trace,metrics,accuracy,telemetry}``.

* span tracing records the reference's Chrome event format on the
  profiler's clock, with ids and parents that nest; a disabled span
  records nothing and opens no profiler range, each enabled span shows as
  a ``record_function`` in a ``torch.profiler`` capture, ``record``
  writes a span after the fact, ``idle_by_span`` splits idle time by the
  innermost span, and ``dispatch_cost`` records a call's cost as
  ``<name>.cost``; the port's runners carry the reference's span
  names (``device_sim.commit``, ``.dispatch``, ``.checkpoint``,
  ``.stats``);
* ``TelemetryLog`` / ``AppTelemetryLog`` behave as the reference's;
* run exports round-trip, are stamped ``engine="torch"`` with the port's
  own draw-stream version, and each package's ``check_stamp`` refuses the
  other's recording;
* ``accuracy_report`` (and each of its parts) of the same ring is equal
  in both packages, on hand-built rings and on a ring the port recorded.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.obs import accuracy as jacc  # noqa: E402
from repro.obs import metrics as jmet  # noqa: E402
from repro.obs.telemetry import AppTelemetryLog as JAppLog  # noqa: E402
from repro_torch.obs import accuracy as tacc  # noqa: E402
from repro_torch.obs import metrics as tmet  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.telemetry import (  # noqa: E402
    APP_FIELDS,
    OPEN_FIELDS,
    AppTelemetryLog,
    TelemetryLog,
)
from repro_torch.online import ClusterSim, PoissonArrivals  # noqa: E402
from repro_torch.online import run_device_sim_checkpointed  # noqa: E402
from repro_torch.smt import machine as tmc  # noqa: E402
from repro_torch.smt import scan_engine as tse  # noqa: E402
from repro_torch.smt.apps import pool_profiles as t_pool  # noqa: E402
from repro_torch.smt.workloads import scaled_workload  # noqa: E402


@pytest.fixture(autouse=True)
def _trace_off():
    """Spans must never leak across tests."""
    yield
    ttrace.disable()
    ttrace.clear()


# ----------------------------------------------------------- span tracing
def test_disabled_span_is_a_noop():
    """Nothing recorded, one shared no-op context, no profiler range."""
    from torch.profiler import ProfilerActivity, profile

    assert ttrace.span("a") is ttrace.span("b", q=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.span("nothing", q=1) as sp:
            sp.set(x=1)
            torch.ones(4).sum()
    assert "nothing" not in {e.key for e in prof.key_averages()}
    ttrace.instant("nothing.cost", x=1)
    assert ttrace.events() == []
    assert ttrace.dispatch_cost("nothing", lambda: None, "cpu") is None


def test_spans_record_chrome_events(tmp_path):
    ttrace.enable()
    with ttrace.span("outer", n=4):
        with ttrace.span("inner"):
            pass
    ttrace.disable()
    ev = ttrace.events()
    assert [e["name"] for e in ev] == ["inner", "outer"]
    for e in ev:
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    assert ev[1]["args"] == {"n": 4}
    path = tmp_path / "trace.json"
    ttrace.save(str(path))
    payload = json.loads(path.read_text())
    assert [e["name"] for e in payload["traceEvents"]] == ["inner", "outer"]
    rows = ttrace.breakdown()
    assert rows["outer"]["count"] == 1 and rows["outer"]["mean_us"] >= 0


def test_span_is_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    ttrace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.span("device_sim.dispatch"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "device_sim.dispatch" in names


def test_span_lies_on_the_profilers_clock():
    """``ts`` is the profiler's Unix clock: each span starts within 100 us
    before its ``record_function``'s ``start_ns()`` and ends after it."""
    from torch.profiler import ProfilerActivity, profile

    ttrace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.span("clock.warm"):     # the profiler's first range
            pass
        for i in range(3):
            with ttrace.span(f"clock.probe{i}"):
                torch.ones(4).sum()
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()}
    probes = [e for e in ttrace.events() if e["name"].startswith("clock.p")]
    assert len(probes) == 3
    for ev in probes:
        start, end = ranges[ev["name"]]
        lead_us = start / 1e3 - ev["ts"]
        assert -1.0 <= lead_us < 100.0, (ev, start)
        assert ev["ts"] + ev["dur"] >= end / 1e3 - 1.0, (ev, end)


def test_parent_ids_nest():
    ttrace.enable()
    with ttrace.span("a") as a:
        with ttrace.span("b") as b:
            with ttrace.span("c") as c:
                pass
        with ttrace.span("d") as d:
            pass
    with ttrace.span("e") as e:
        pass
    ev = {x["name"]: x for x in ttrace.events()}
    assert len({x["id"] for x in ev.values()}) == 5
    assert [ev[n]["id"] for n in "abcde"] == [s.id for s in (a, b, c, d, e)]
    assert ev["a"]["parent"] is None and ev["e"]["parent"] is None
    assert ev["b"]["parent"] == a.id and ev["d"]["parent"] == a.id
    assert ev["c"]["parent"] == b.id


def test_record_writes_the_span_it_is_given():
    ttrace.enable()
    t0 = ttrace.now_ns()
    with ttrace.span("outer") as outer:
        sid = ttrace.record("unit.request", t0 - 5_000, t0 + 12_345_000,
                            rid=3, slot=1)
    ttrace.disable()
    assert ttrace.record("unit.request", 0, 1) is None
    ev = [e for e in ttrace.events() if e["name"] == "unit.request"]
    assert len(ev) == 1
    ev = ev[0]
    assert ev["ph"] == "X" and ev["id"] == sid and ev["parent"] == outer.id
    assert ev["ts"] == (t0 - 5_000) / 1e3
    assert ev["dur"] == 12_350.0
    assert ev["args"] == {"rid": 3, "slot": 1}


def test_span_args_set_before_it_closes():
    ttrace.enable()
    with ttrace.span("call", n=1) as call:
        call.set(steps=7)
    assert ttrace.events()[0]["args"] == {"n": 1, "steps": 7}


def _x(name, ts_ns, end_ns, sid, parent):
    return {"name": name, "ph": "X", "ts": ts_ns / 1e3,
            "dur": (end_ns - ts_ns) / 1e3, "id": sid, "parent": parent}


def test_idle_by_span_on_hand_made_intervals():
    """Window 0-150 ns, device busy to 5, 20-30, 55-58, 90-120: the idle 102 ns
    go to the innermost open span on the stack; a recorded span across
    its parent's bounds (a request) takes none."""
    spans = [_x("outer", 0, 100, 1, None), _x("child", 10, 40, 2, 1),
             _x("child2", 50, 60, 3, 1), _x("quiet", 92, 98, 4, 1),
             _x("unit.request", -5, 200, 5, 2)]
    busy = [(-10, 5), (20, 30), (55, 58), (90, 120), (160, 170)]
    got = ttrace.idle_by_span(spans, busy, 0, 150)
    want = {"outer": 5 + 10 + 30, "child": 10 + 10,
            "child2": 5 + 2, "quiet": 0, "none": 30}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v / 1e9, abs=1e-15), k
    assert sum(got.values()) == pytest.approx(
        (150 - 5 - 10 - 3 - 30) / 1e9, abs=1e-15)
    assert ttrace.idle_by_span([], [], 0, 10) == {"none": pytest.approx(1e-8)}


def test_serve_spans_readings_on_hand_made_spans():
    """The readings ``experiments/serve_spans/run.py`` takes from the
    serving path's spans: the host's own time a step, time to first
    token, and a share of idle time by span."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "experiments" /
            "serve_spans" / "run.py")
    spec = importlib.util.spec_from_file_location("serve_spans_run", path)
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    us = 1e3                                    # ns in a microsecond
    spans = [_x("serve.step", 0, 10_000 * us, 1, None),
             _x("serve.token_read", 1_000 * us, 7_000 * us, 2, 1),
             _x("serve.step", 10_000 * us, 14_000 * us, 3, None),
             _x("serve.token_read", 11_000 * us, 12_000 * us, 4, 3),
             _x("serve.step", 14_000 * us, 20_000 * us, 5, None)]
    # Host time a step: 4, 3 and 6 ms; the median is 4.
    assert run.host_step_ms(spans) == pytest.approx(4.0)
    assert run.host_step_ms([]) is None
    reqs = []
    for i, first_ms in enumerate(range(1, 101)):
        ev = _x("serve.request", 5_000 * us, 90_000_000 * us, 10 + i, None)
        ev["args"] = {"first_token_ns": 5_000 * us + first_ms * 1e6}
        reqs.append(ev)
    assert run.ttft_p95_ms(reqs) == pytest.approx(95.05)
    assert run.ttft_p95_ms(spans) is None
    idle = {"serve.decode": 0.5, "serve.feed": 0.1, "serve.step": 0.2,
            "none": 0.2}
    assert run.idle_share(idle, 10.0, run.ENGINE) == pytest.approx(3.0)
    assert run.idle_share(idle, 10.0, ("serve.decode",)) == \
        pytest.approx(5.0)
    assert run.idle_share(idle, 10.0, ("ssm.rwkv_scan",)) is None


def test_dispatch_cost_on_the_cpu_is_host_time():
    ttrace.enable()
    calls = []
    stats = ttrace.dispatch_cost("unit", lambda: calls.append(1), "cpu")
    assert calls == [1] and set(stats) == {"host_ms"}
    ev = [e for e in ttrace.events() if e["name"] == "unit.cost"]
    assert ev and ev[0]["ph"] == "i" and ev[0]["args"] == stats


def _tiny_sim(seed=3):
    pool = t_pool()
    return ClusterSim(tmc.SMTMachine(tmc.MachineParams(), seed=0), pool, 2,
                      tse.ScanPolicy(kind="adjacent"),
                      PoissonArrivals(rate=0.8, n_pool=len(pool)), seed=seed,
                      target_scale=0.1, engine="scan", device="cpu")


def test_runners_carry_the_reference_span_names(tmp_path):
    ttrace.enable()
    _tiny_sim().run(4, repeats=1, telemetry=True)
    run_device_sim_checkpointed(_tiny_sim(), 4, 2, str(tmp_path / "ck"))
    ttrace.disable()
    rows = ttrace.breakdown()
    for name in ("device_sim.commit", "device_sim.dispatch",
                 "device_sim.checkpoint", "device_sim.stats",
                 "device_sim.race.cost"):
        assert name in rows, name
    assert rows["device_sim.checkpoint"]["count"] == 2
    # One warm and one timed run, then two segments.
    assert rows["device_sim.dispatch"]["count"] == 3


# ---------------------------------------------------------- the log API
def test_telemetry_log_roundtrip_and_views():
    data = np.arange(12, dtype=np.float64).reshape(3, 4)
    log = TelemetryLog(("a", "b", "c", "d"), data, policy="p")
    assert log.quanta == 3
    np.testing.assert_array_equal(log.timeline("b"), [1.0, 5.0, 9.0])
    s = log.summary()
    assert s["tlm_b_mean"] == 5.0 and s["tlm_d_max"] == 11.0
    clone = TelemetryLog.from_dict(log.to_dict())
    assert clone.fields == log.fields and clone.policy == "p"
    np.testing.assert_array_equal(clone.data, log.data)
    with pytest.raises(AssertionError):
        TelemetryLog(("a",), data)


def test_app_log_roundtrip_and_views():
    data = np.zeros((2, 3, len(APP_FIELDS)))
    data[:, :, 0] = [[0, 1, -1], [2, -1, -1]]
    log = AppTelemetryLog(APP_FIELDS, data, policy="x")
    assert (log.quanta, log.slots) == (2, 3)
    np.testing.assert_array_equal(log.valid().sum(1), [2, 1])
    back = AppTelemetryLog.from_dict(json.loads(json.dumps(log.to_dict())))
    np.testing.assert_array_equal(back.series("app_id"), data[:, :, 0])
    assert repr(back).startswith("AppTelemetryLog(policy='x'")


def test_stats_timelines_carry_the_ring():
    st = _tiny_sim().run(5, warmup=False, telemetry=True)
    tl = st.timelines()
    for f in OPEN_FIELDS:
        np.testing.assert_array_equal(tl[f"tlm_{f}"],
                                      st.telemetry.timeline(f))
    assert "tlm_active" not in _tiny_sim().run(5, warmup=False).timelines()


# ---------------------------------------------------------- run exports
def test_export_roundtrip(tmp_path):
    run = tmet.export_run(
        "unit", {"m": 1.5}, timelines={"t": [1, 2, 3]},
        telemetry={"arm": TelemetryLog(("x",), np.ones((2, 1)))},
        spans=[{"name": "s", "ph": "X", "ts": 0, "dur": 1}],
        meta={"k": "v"}, faults=True, batched=True, lanes=3,
        accuracy={"arm": {"overall": {"mape": 0.1}}})
    assert run["engine"] == "torch"
    assert run["scan_rng_stream_version"] == tse.TORCH_DRAW_STREAM_VERSION
    assert run["obs_schema_version"] == jmet.OBS_SCHEMA_VERSION
    path = str(tmp_path / "run.json")
    tmet.save_run(path, run)
    back = tmet.load_run(path)
    assert back["metrics"] == {"m": 1.5} and back["lanes"] == 3
    assert back["timelines"]["t"] == [1.0, 2.0, 3.0]
    assert TelemetryLog.from_dict(back["telemetry"]["arm"]).quanta == 2
    assert tmet.check_stamp(back, batched=True, lanes=3)
    assert not tmet.check_stamp(back, batched=False)
    assert not tmet.check_stamp(back, lanes=4)


def test_stale_stamps_refused(tmp_path):
    run = tmet.export_run("unit", {"m": 1.0})
    for key in ("obs_schema_version", "rng_stream_version",
                "scan_rng_stream_version", "engine"):
        bad = dict(run)
        bad[key] = -1
        path = str(tmp_path / f"bad_{key}.json")
        tmet.save_run(path, bad)
        assert tmet.load_run(path) is None, key
    path = str(tmp_path / "legacy.json")
    with open(path, "w") as f:
        json.dump({"stream_median_us": 1.0}, f)
    assert tmet.load_run(path) is None
    assert tmet.load_run(str(tmp_path / "missing.json")) is None


@pytest.mark.parametrize("engine", ["scan", "device", None])
def test_each_package_refuses_the_others_recording(engine):
    """The port's draws are not threefry: a reference recording fails the
    port's check, and a port recording fails the reference's."""
    ref = jmet.export_run("unit", {"m": 1.0}, engine=engine)
    assert jmet.check_stamp(ref)
    assert not tmet.check_stamp(ref)
    port = tmet.export_run("unit", {"m": 1.0})
    assert tmet.check_stamp(port)
    assert not jmet.check_stamp(port)


def test_metric_rows():
    st = _tiny_sim().run(4, warmup=False)
    rows = tmet.stats_metrics(st, prefix="a_")
    assert rows["a_n_arrived"] == st.n_arrived
    res = tse.run_quanta_scan(
        tmc.MachineParams(), scaled_workload(8, seed=1),
        {"random": tse.ScanPolicy(kind="static")}, n_quanta=2,
        device="cpu", repeats=0)["random"]
    rows = tmet.throughput_metrics(res)
    assert rows["mean_true_slowdown"] == res.mean_true_slowdown
    assert rows["ipc_geomean"] == res.ipc_geomean


# ------------------------------------------------------------- accuracy
def _synthetic_ring(seed):
    """A random app ring: occupancy, pairs, predictions and truths, with
    solo and empty contexts among them."""
    rng = np.random.default_rng(seed)
    q, s = 20, 12
    data = np.zeros((q, s, len(APP_FIELDS)))
    aid = rng.integers(0, 6, (q, s)).astype(float)
    aid[rng.random((q, s)) < 0.2] = -1
    part = np.where(rng.random((q, s)) < 0.7,
                    rng.integers(0, 6, (q, s)), -1).astype(float)
    part[aid < 0] = -1
    pred = np.where(part >= 0, rng.uniform(1.0, 2.0, (q, s)), 0.0)
    real = np.where(aid >= 0, rng.uniform(1.0, 2.0, (q, s)), 0.0)
    data[..., 0], data[..., 1], data[..., 2], data[..., 3] = \
        aid, part, pred, real
    data[..., 4] = np.where(pred > 0, pred - real, 0.0)
    data[..., 5:] = np.where((aid >= 0)[..., None],
                             rng.dirichlet(np.ones(4), (q, s)), 0.0)
    return data


@pytest.mark.parametrize("seed", range(3))
def test_accuracy_report_equals_the_reference(seed):
    data = _synthetic_ring(seed)
    names = [f"app{i}" for i in range(6)]
    got = tacc.accuracy_report(AppTelemetryLog(APP_FIELDS, data, "p"),
                               window=5, app_names=names)
    want = jacc.accuracy_report(JAppLog(APP_FIELDS, data, "p"), window=5,
                                app_names=names)
    assert got == want
    assert tacc.report_metrics(got, "x_") == jacc.report_metrics(want, "x_")
    assert tacc.drift_windows(AppTelemetryLog(APP_FIELDS, data),
                              budget=0.1) == \
        jacc.drift_windows(JAppLog(APP_FIELDS, data), budget=0.1)


def test_accuracy_report_of_a_recorded_ring():
    """A ring the port recorded reads the same in both packages."""
    from repro_torch.core import isc as tisc
    from repro_torch.smt import training as ttr

    mach = tmc.SMTMachine(tmc.MachineParams(), seed=0)
    model = ttr.build_all_models(
        mach, methods={"SYNPA4_R-FEBE": tisc.SYNPA4_R_FEBE},
        device="cpu")[0]["SYNPA4_R-FEBE"]
    pool = t_pool()
    st = ClusterSim(mach, pool, 4,
                    tse.ScanPolicy(kind="synpa", method=tisc.SYNPA4_R_FEBE,
                                   model=model),
                    PoissonArrivals(rate=1.2, n_pool=len(pool)), seed=5,
                    target_scale=0.1, engine="scan", device="cpu").run(
                        12, warmup=False, app_telemetry=True)
    log = st.app_telemetry
    got = tacc.accuracy_report(log)
    assert got["overall"]["n"] > 0
    assert got == jacc.accuracy_report(JAppLog(log.fields, log.data,
                                               log.policy))
