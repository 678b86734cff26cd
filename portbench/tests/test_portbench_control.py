"""The control: the reference computed in float8 (e4m3) put in the
port's place, the step below the configurations' bfloat16.

On the CPU, at the smoke size, the control's widest gap is at least three
times the port's on every seed: the comparison separates them.  On the
card (``-m gpu``), at each cell's own size, the control fails the cell's
limit and the port passes it, on three seeds: run

    python3 -m pytest -m gpu portbench/tests/test_portbench_control.py

from the root of a checkout on a machine with an H100 (``-s`` prints
each seed's readings).
"""

import json

import pytest
import torch

from portbench import calibrate, check
from portbench.tests._smoke import bench, cells, use_smoke_sizes


@pytest.mark.parametrize("cell", cells())
def test_the_control_separates_at_the_smoke_size(tmp_path, monkeypatch,
                                                  cell):
    use_smoke_sizes(tmp_path, monkeypatch)
    for r in calibrate.readings(bench(), cell, [31, 32, 33],
                                torch.device("cpu")):
        assert r["control"] > 0 and r["control"] >= 3 * r["program"], r


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_the_cells_limit_on_the_card(cuda, cell):
    limit = check.limits(cell)["widest_gap"]["limit"]
    for r in calibrate.readings(bench(), cell, [41, 42, 43], cuda):
        print(json.dumps(dict(r, limit=limit)))
        assert r["program"] <= limit < r["control"], r
