"""The port's import boundary and its device rule.

* No file under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of the reference package ``repro`` (an AST scan).
* Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
  without a GPU they raise instead of carrying on quietly on the CPU.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import isc  # noqa: E402
from repro_torch.launch.serve import serve_demo  # noqa: E402
from repro_torch.models.registry import build_model, get_config  # noqa: E402
from repro_torch.smt import machine, scan_engine, training, workloads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    assert path.is_file(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.core import isc\n")
    assert "repro.core" in list(_imported_modules(bad))


@pytest.fixture
def no_gpu(monkeypatch):
    """Pretend there is no GPU, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    profs = workloads.scaled_workload(8, seed=1)
    pols = {"random": scan_engine.ScanPolicy(kind="static")}
    return profs, pols


def _params_tree(model):
    """A model's weights as the reference's ``Model.init`` tree of numpy
    arrays, blocks stacked on a leading layer axis."""
    tree, stacked = {}, {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            stacked.setdefault(tuple(parts[2:]), []).append(p.detach().numpy())
        else:
            tree.setdefault(parts[0], {})[parts[1]] = p.detach().numpy()
    for (mod, leaf), arrs in stacked.items():
        tree.setdefault("blocks", {}).setdefault(mod, {})[leaf] = np.stack(arrs)
    return tree


@pytest.mark.parametrize("entry", [
    "resolve_device", "run_quanta_scan", "build_all_models",
    "category_model_from_numpy", "device_tables_from_numpy", "build_model",
    "serve_demo", "model_params_from_numpy", "SynpaScheduler",
    "make_synpa_pipeline", "StreamingAllocator", "StreamingScheduler",
    "ClusterSim(engine='host')", "inverse", "plan_colocation"])
def test_entry_points_raise_without_gpu(no_gpu, entry):
    from repro_torch.core import colocation, regression, synpa
    from repro_torch.online import (ClusterSim, LinuxOnline, PoissonArrivals,
                                    StreamingAllocator, StreamingScheduler)

    profs, pols = _tiny()
    toy = convert.category_model_from_numpy(
        np.eye(4, dtype=np.float32)[:, [1, 0, 2, 3]], np.zeros(4), 4,
        device="cpu")
    frac = np.full((3, 4), 0.25, np.float32)
    cfg = get_config("qwen1.5-0.5b", smoke=True, dtype="float32",
                     param_dtype="float32")
    calls = {
        "resolve_device": lambda **kw: repro_torch.resolve_device(**kw),
        "run_quanta_scan": lambda **kw: scan_engine.run_quanta_scan(
            machine.MachineParams(), profs, pols, n_quanta=2, repeats=0,
            **kw),
        "build_all_models": lambda **kw: training.build_all_models(
            machine.SMTMachine(), methods={"SYNPA4_R-FEBE":
                                           isc.SYNPA4_R_FEBE},
            solo_quanta=4, pair_quanta=2, **kw),
        "category_model_from_numpy": lambda **kw:
            convert.category_model_from_numpy(np.zeros((4, 4)), np.zeros(4),
                                              4, **kw),
        "device_tables_from_numpy": lambda **kw:
            convert.device_tables_from_numpy(machine.PhaseTables.build(profs),
                                             **kw),
        "build_model": lambda **kw: build_model(cfg, **kw),
        "serve_demo": lambda **kw: serve_demo(
            "qwen1.5-0.5b", smoke=True, n_requests=2, max_new=2, **kw),
        "model_params_from_numpy": lambda **kw:
            convert.model_params_from_numpy(
                _params_tree(build_model(cfg, device="cpu")), cfg, **kw),
        "SynpaScheduler": lambda **kw: synpa.SynpaScheduler(
            isc.SYNPA4_R_FEBE, toy, **kw),
        "make_synpa_pipeline": lambda **kw: synpa.make_synpa_pipeline(
            isc.SYNPA4_R_FEBE, toy, **kw),
        "StreamingAllocator": lambda **kw: StreamingAllocator(
            isc.SYNPA4_R_FEBE, toy, **kw),
        "StreamingScheduler": lambda **kw: StreamingScheduler(
            isc.SYNPA4_R_FEBE, toy, **kw),
        "ClusterSim(engine='host')": lambda **kw: ClusterSim(
            machine.SMTMachine(), profs, 2, LinuxOnline(),
            PoissonArrivals(rate=1.0, n_pool=len(profs)), **kw).run(2),
        "inverse": lambda **kw: regression.inverse(toy, frac, frac, **kw),
        "plan_colocation": lambda **kw: colocation.plan_colocation(
            [{"arch": "a", "shape": str(i), "compute_s": 1.0 + i,
              "memory_s": 1.0, "collective_s": 0.5} for i in range(4)],
            toy, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry](device="cuda")
    # the same call on the CPU, asked for by name, runs
    calls[entry](device="cpu")
