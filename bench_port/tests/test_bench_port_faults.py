"""``correct`` against a broken timed path: each fault a cell can have,
planted underneath a whole run at a small size on the CPU, and the
lower-precision control, come out as not correct; the sound run as
correct."""

import time

import pytest
import torch

import conftest


def run_cpu(cell, hooks=None, control=False, seed=11, seconds=0.5):
    from bench_port import harness

    return harness.run(cell, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter(), config=conftest.small(cell),
                       hooks=hooks, control=control)


@pytest.mark.parametrize("cell", conftest.CELLS)
def test_sound_run_is_correct(cell):
    res = run_cpu(cell)
    assert res["correct"], res["compared"]


from bench_port.faults import altered, half_batch, unchanged  # noqa: E402


@pytest.mark.parametrize("cell,fault", [
    ("d3_chunked.train3", unchanged), ("dense10k.train4", unchanged),
    ("d3_chunked.train3", half_batch), ("dense10k.train4", half_batch),
    ("d3_chunked.eval3", half_batch), ("dense10k.eval4", half_batch),
    ("d3_chunked.eval3", altered), ("dense10k.eval4", altered)])
def test_fault_is_not_correct(cell, fault):
    res = run_cpu(cell, hooks=fault)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", ["dense10k.train4", "dense10k.eval4"])
def test_control_is_not_correct(cell):
    """The all-pairs path has no lower-precision mode: its control is the
    reference with TF32 products in the program's place."""
    res = run_cpu(cell, control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["d3_chunked.train3", "d3_chunked.eval3"])
def test_fast_math_control_is_not_correct(card, cell):
    """The chunked path's own lower-precision mode (fast_math_dots: one
    TF32 pass) runs only on the card; its plain CPU version is exact."""
    from bench_port import harness

    res = harness.run(cell, 5, 0.5, False, card, time.perf_counter(),
                      config=conftest.small(cell), control=True)
    assert not res["correct"], res["compared"]
