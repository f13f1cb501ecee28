"""The comparison that decides `correct` fails what it has to fail: the
control (the reference in the program's place, energies read in
bfloat16) and runs whose timed path is broken underneath, each fault of
faults.py (beside these tests) that a cell can have.  The CPU tests run
the tiny cells of conftest.py; the `cuda` tests run the benchmark's own
cells on a card, at their own size, on three seeds."""

import faults
import pytest
from conftest import WORKERS, run_tiny

from perfbench import control, core

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-api"])
def test_the_control_comes_out_not_correct(tiny_bench, cell):
    numbers, limits, n = control.control(
        tiny_bench, cell, SEEDS[0], tiny_bench.workload(cell)["control_answers"],
        workers=WORKERS)
    assert n > 0
    assert numbers["mismatched_answers"] > limits["mismatched_answers"]


@pytest.mark.parametrize("cell,fault,seconds", [
    ("tiny-stream", "state_unchanged", 6.0),
    ("tiny-stream", "half_batch", 40.0),
    ("tiny-stream", "answer_altered", 4.0),
    ("tiny-api", "state_unchanged", 4.0),
    ("tiny-api", "answer_altered", 4.0)])
def test_a_broken_timed_path_comes_out_not_correct(tiny_bench, cell, fault,
                                                   seconds):
    # half_batch: the frozen lanes answer only once the engine's step limit
    # (2 x max_steps = 48 rounds) banks them, so its window holds 48 rounds
    # on the CPU with room to spare; the check compares every failed answer
    with faults.planted(fault):
        result, compared = run_tiny(tiny_bench, cell, seconds)
    assert result["correct"] is False, compared
    assert any(v > lim for v, lim in compared.values())


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["n100ms50-b128", "ms20traj-api"])
@pytest.mark.parametrize("fault", faults.KINDS)
def test_each_fault_fails_the_cell_on_the_card(cell, fault, capsys):
    _card()
    if fault == "half_batch" and cell == "ms20traj-api":
        pytest.skip("B=1: no half of the batch to leave out")
    for seed in SEEDS:
        with faults.planted(fault):
            result, compared = core.run_cell(cell, seed, 20.0, False)
        with capsys.disabled():
            print(f"\nfault {fault} in {cell}, seed {seed}: "
                  f"{ {k: v for k, (v, _) in compared.items()} } of "
                  f"{result['attempted']} answers, failed {result['failed']}")
        assert result["correct"] is False
