"""The control of each cell's check: the reference at float8 e4m3 put in
the program's place. On the CPU, at a test's size, its readings stand
far above a sound run's; on the card (marked ``cuda``), at the cell's
own size, it fails the cell's limits, as ``portbench/control.py``
reads it for the limits (PERF.md, section 2)."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import bench
from portbench.tests.cells import tiny

torch.set_num_threads(1)

CELLS = [w["name"] for w in bench.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_far_above_a_sound_run(name):
    cell = tiny(name)
    drv = bench.driver(cell.traffic["kind"])
    sound = drv.run(cell, 21, 0.3, False, torch.device("cpu"),
                    time.perf_counter())["check"]
    low = drv.control(cell, 21, torch.device("cpu"))
    # one of the numbers, at least, separates the two readings
    assert any(max(x for key, x in low.items() if key.endswith(k))
               > 100 * max(v, 1e-7) for k, v in sound.items()), (sound, low)


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits_on_the_card(name, card):
    cell = bench.find_cell(name)
    got = bench.driver(cell.traffic["kind"]).control(cell, 31, card)
    failed = [k for k, v in got.items() if k.split(".")[-1] in cell.limits
              and v > cell.limits[k.split(".")[-1]]]
    assert failed, got
