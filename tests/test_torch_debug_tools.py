"""The fold engine's exactness tools (rafft_tpu_torch/tools/debug_seq.py,
debug_delta.py, perfcheck.py) on the CPU, against the JAX package and its
tools.

- debug_seq: no divergence on row 7 at the bench configuration; a
  divergence planted in fold_cpu's trajectory is found at its step; the
  port engine's beam before each step equals the JAX FoldEngine's,
  stepped on the CPU, for one short row.
- debug_delta: the rows of the JAX tool's candidates_for
  (tools/debug_delta.py, loaded by path), field by field.  That tool
  calls fold_jax._combo_pt on one combination's rows, from before
  _combo_pt took a batch of them; the test hands them over as a batch of
  one.  At N=32 the JAX tool's engine refuses M=100 (more lags than the
  region has); the port takes M=63, and is held to the integer oracle.
- perfcheck: parity on three rows of at most 32 nt at a cut configuration.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.tools import corpus as TC
from rafft_tpu_torch.tools import debug_delta, debug_seq, perfcheck

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _journal(max_nt):
    """The journal's rows of at most max_nt nt, reference order."""
    rows = {(r["seq"], r["name"]): r for r in TC.journal()}
    return [rows[(s, name)] for s, _t, name in TC.reference_order()
            if (s, name) in rows and len(s) <= max_nt]


def test_debug_seq_row7_has_no_divergence():
    seq = debug_seq.pick_sequence(7)
    assert len(seq) == 102
    want = debug_seq.cpu_trajectory(seq, **debug_seq.CPU_ARGS)
    d = debug_seq.first_divergence(
        FT.FoldEngine(debug_seq.CONFIG, B=1, device="cpu"), seq, want)
    assert d.step is None and d.got == want[-1]
    assert d.steps == len(want) - 1
    assert debug_seq.report(d)[0] == "no divergence in stepped beams"


@pytest.fixture(scope="module")
def short_fold():
    """A 30-nt row at -n 20 -ms 5 --max_branch 50: its engine and
    fold_cpu's trajectory."""
    seq = _journal(32)[0]["seq"]
    cfg = FT.fold_one_config(len(seq), 20, 5, 50)
    return seq, FT.FoldEngine(cfg, B=1, device="cpu"), \
        debug_seq.cpu_trajectory(seq, 20, 5, 50)


@pytest.mark.parametrize("where", ["step", "final"])
def test_debug_seq_finds_a_planted_divergence(short_fold, where):
    seq, eng, want = short_fold
    assert debug_seq.first_divergence(eng, seq, want).step is None
    at = 1 if where == "step" else len(want) - 1
    assert len(want) > 2 and want[at]
    planted = [list(b) for b in want]
    db, e = planted[at][-1]
    planted[at][-1] = (db, e + 0.1)
    d = debug_seq.first_divergence(eng, seq, planted)
    assert d.step == at and d.want == planted[at] and d.got == want[at]
    lines = debug_seq.report(d)
    assert lines[0].startswith(f"DIVERGED at step {at}:")


def test_engine_steps_equal_jax_engine_steps():
    seq = _journal(32)[1]["seq"]
    small = dict(N=32, K=5, R=4, M=12, V=32, CPLX=8, S=128, max_branch=24,
                 max_steps=8)
    je = FJ.FoldEngine(FJ.EngineConfig(**small), B=1)
    te = FT.FoldEngine(FT.EngineConfig(**small), B=1, device="cpu")
    js, ts = je.init_state([seq]), te.init_state([seq])
    steps = 0
    while not bool(np.asarray(js["done"]).all()):
        assert te._beams(ts, 1) == je._beams(js, 1), f"step {steps}"
        js, ts = je._step(js), te.step(ts)
        steps += 1
        assert steps <= small["max_steps"]
    assert bool(ts["done"].all()) and te._beams(ts, 1) == je._beams(js, 1)
    assert steps >= 2


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_debug_delta", os.path.join(REPO, "tools", "debug_delta.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_debug_delta_matches_jax_tool(monkeypatch):
    row = next(r for r in _journal(60) if len(r["seq"]) > 40)
    seq, parent = row["seq"], row["beam"][-1][0]
    combo = FJ._combo_pt
    monkeypatch.setattr(FJ, "_combo_pt",
                        lambda cfg, *a: combo(cfg, *(x[None] for x in a))[0])
    want = _jax_tool().candidates_for(seq, parent)
    got = debug_delta.candidates_for(seq, parent, device="cpu")
    assert len(got) > 5 and got == want
    assert all(r["ok"] for r in got if not r["unsup"])
    assert debug_delta.summary(got)[0].startswith(f"{len(got)} candidates, 0 ")


def test_debug_delta_at_n32():
    row = _journal(32)[0]
    seq, parent = row["seq"], row["beam"][0][0]
    with pytest.raises(ValueError, match="M=100"):
        _jax_tool().candidates_for(seq, parent)
    got = debug_delta.candidates_for(seq, parent, device="cpu")
    assert got and all(r["ok"] for r in got if not r["unsup"])
    got0 = debug_delta.candidates_for(seq, "." * len(seq), device="cpu")
    assert len(got0) > 5 and all(r["ok"] for r in got0 if not r["unsup"])


def test_perfcheck_parity():
    seqs = TC.short_rows(TC.reference_order(), 32)
    lines = []
    out = perfcheck.run(seqs, nseq=3, B=2, device="cpu", workers=2,
                        log=lines.append,
                        cfg=FT.fold_one_config(32, 20, 5, 50))
    assert out["parity"] == (3, 3) and out["mismatches"] == []
    assert out["cplx_dropped"] == (0, 0) and out["enum_suspect"] == (0, 0)
    assert lines[-1].startswith("parity: 3/3 exact")
