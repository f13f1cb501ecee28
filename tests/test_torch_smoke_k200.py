"""chip_smoke.py's --k200-full row plan and the K=200 row rule, on the CPU.

--k200-full folds the whole committed -n 200 -ms 200 corpus on the card;
what it folds is chosen by chip_smoke.k200_plan, and what it accepts by
chip_smoke._k200_row (an unflagged fold's best row equals the committed
sweep's, or its whole beam equals fold_cpu's).  Both are held here
without a card: the plan against the committed checkpoints and their
manifests, the rule on hand-made beams of a short sequence.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rafft_tpu_torch.engine import fold_cpu  # noqa: E402

torch.set_num_threads(1)
ART = os.path.join(ROOT, "benchmarks", "artifacts")


def _lines(name):
    with open(os.path.join(ART, name)) as fh:
        return [json.loads(line) for line in fh]


def test_k200_plan_assigns_every_committed_row_once():
    plan = chip_smoke.k200_plan()
    counts = {N: len(rows) for N, rows in plan.items()}
    assert counts == {64: 44, 128: 1894, 256: 80, 512: 252, 1024: 24,
                      4096: 2}
    files = {N: {r["_file"] for r in rows} for N, rows in plan.items()}
    assert files == {64: {chip_smoke.K200_TPU}, 128: {chip_smoke.K200_TPU},
                     256: {chip_smoke.K200_TPU}, 512: {chip_smoke.K200_CPU},
                     1024: {chip_smoke.K200_CPU}, 4096: {chip_smoke.K200_LONG}}
    keys = [(r["name"], r["seq"]) for rows in plan.values() for r in rows]
    assert len(keys) == len(set(keys)) == 2294 + 2
    # every committed row, at the bucket its sweep folded it at
    want = {(r["name"], r["seq"]): (name, r["_bucket"])
            for name in (chip_smoke.K200_TPU, chip_smoke.K200_CPU,
                         chip_smoke.K200_LONG) for r in _lines(name)}
    assert {(r["name"], r["seq"]): (r["_file"], N)
            for N, rows in plan.items() for r in rows} == want
    # the buckets and row counts of each sweep's own manifest
    for name in ("sweep_200n200_tpu", "sweep_200n200_cpu"):
        with open(os.path.join(ART, f"{name}.manifest.json")) as fh:
            man = json.load(fh)
        for N, b in man["buckets"].items():
            assert counts[int(N)] == b["n"], (name, N)
    for N, rows in plan.items():
        assert [r["_idx"] for r in rows] == sorted(r["_idx"] for r in rows)
        assert all(chip_smoke.TS.bucket_of(len(r["seq"]),
                                           chip_smoke.K200_BUCKETS) == N
                   for r in rows)
    assert set(chip_smoke.K200_SWEPT) == {64, 128, 256}


SEQ = "GGGGAAAACCCCUUUUGGGGAAAACCCCAA"


def _cpu_beam():
    return [(s.str_struct, s.energy)
            for s in fold_cpu.fold(SEQ, nb_mode=200, max_stack=200,
                                   max_branch=1000)]


@pytest.mark.parametrize("case", ["committed", "fold_cpu", "neither"])
def test_k200_row_rule(case):
    """A beam whose best row is the committed row passes without fold_cpu;
    one that differs from it passes only as fold_cpu's whole beam."""
    cpu = _cpu_beam()
    assert len(cpu) > 1
    committed = dict(seq=SEQ, struct=cpu[0][0], nrj=cpu[0][1])
    if case == "committed":
        beam = [cpu[0], ("." * len(SEQ), 0.0)]
        assert chip_smoke._k200_row(beam, committed, "row") is False
        return
    # a committed row that fold_cpu does not give (a run's artifact)
    committed = dict(committed, struct="." * len(SEQ), nrj=0.0)
    if case == "fold_cpu":
        assert chip_smoke._k200_row(cpu, committed, "row") is True
        assert chip_smoke._k200_row(cpu, committed, "row", cpu_beam=cpu)
        return
    wrong = cpu[:-1]
    with pytest.raises(AssertionError, match="differs from the committed"):
        chip_smoke._k200_row(wrong, committed, "row")
    with pytest.raises(AssertionError):
        chip_smoke._k200_row(wrong, committed, "row", cpu_beam=cpu)
