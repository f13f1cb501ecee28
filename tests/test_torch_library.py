"""The port's host library modules and package root against the originals.

analysis.py, energy/features.py, viz/ and the root `fold` of
rafft_tpu_torch are held against rafft_tpu's on seeded inputs, as
tests/test_torch_oracle.py holds the other copies.  Everything compared
is integer, text or the same float arithmetic, so every comparison is
exact.  The drawing modules must import where matplotlib and
scikit-learn are absent (the card machine has neither).
"""

import dataclasses
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rafft_tpu
import rafft_tpu_torch
from rafft_tpu import analysis as JA
from rafft_tpu.energy import features as JF
from rafft_tpu.energy import params as JP
from rafft_tpu.viz import layout as JL
from rafft_tpu.viz import surface as JSu
from rafft_tpu_torch import analysis as PA
from rafft_tpu_torch.energy import features as PF
from rafft_tpu_torch.energy import params as PP
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.viz import layout as PL
from rafft_tpu_torch.viz import surface as PSu

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAN = {("A", "U"), ("U", "A"), ("G", "C"), ("C", "G"), ("G", "U"), ("U", "G")}


def _random_pair(rng, nmin, nmax):
    """A seeded sequence and a nested structure of canonical pairs with
    hairpins >= 3."""
    seq = "".join(rng.choice(list("ACGU"), int(rng.integers(nmin, nmax))))
    pairs, stack = [], []
    for i, ch in enumerate(seq):
        u = rng.random()
        if stack and i - stack[-1] > 3 and (seq[stack[-1]], ch) in CAN \
                and u < 0.5:
            pairs.append((stack.pop(), i))
        elif u > 0.6:
            stack.append(i)
    db = ["."] * len(seq)
    for i, j in pairs:
        db[i], db[j] = "(", ")"
    return seq, "".join(db)


CASES = [_random_pair(np.random.default_rng(k), 20, 160) for k in range(24)]
CASES += [("GGGAAACCC", "(((...)))"), ("AAAA", "....")]


def test_analysis_equal(tmp_path):
    for seq, db in CASES:
        for fn in ("shapiro", "shapiro_weighted", "loop_content",
                   "loop_content_sized"):
            assert getattr(PA, fn)(db) == getattr(JA, fn)(db), (fn, db)
        for mod, tag in ((JA, "j"), (PA, "p")):
            mod.write_ct(db, seq, str(tmp_path / f"{tag}.ct"), "x")
        assert (tmp_path / "j.ct").read_text() == (tmp_path / "p.ct").read_text()
        assert PA.parse_ct(str(tmp_path / "p.ct")) == JA.parse_ct(str(tmp_path / "p.ct"))
        assert PA.ct_to_db(str(tmp_path / "p.ct")) == JA.ct_to_db(str(tmp_path / "p.ct"))
    dbs = [db for _, db in CASES]
    assert PA.loop_entropy(dbs) == JA.loop_entropy(dbs)
    csv = tmp_path / "rows.csv"
    csv.write_text("seq,struct,name\n" + "".join(
        f"{s},{d},r{k}\n" for k, (s, d) in enumerate(CASES)))
    assert PA.read_csv(str(csv)) == JA.read_csv(str(csv))
    assert PA.read_true_struct(str(csv)) == JA.read_true_struct(str(csv))


@pytest.mark.parametrize("temp", [37.0, 25.0])
def test_features_equal(temp):
    jp, pp = JP.get_params(temp), PP.get_params(temp)
    for seq, db in CASES:
        for specials in (False, True):
            jf, jo = JF.featurize(seq, db, jp, specials_as_params=specials)
            pf, po = PF.featurize(seq, db, pp, specials_as_params=specials)
            assert (pf, po) == (jf, jo), (seq, db)
            assert {k: PF.value_of(k, pp) for k in pf} == \
                {k: JF.value_of(k, jp) for k in jf}
            assert PF.energy_from_features(pf, po, pp) == \
                JF.energy_from_features(jf, jo, jp)


def test_viz_equal():
    for seq, db in CASES:
        assert np.array_equal(PL.layout(db), JL.layout(db))
        assert PL.structure_svg(seq, db) == JL.structure_svg(seq, db)
    dbs = [db for _, db in CASES if len(db) == len(CASES[0][1])] + \
        [CASES[0][1].replace("(", ".").replace(")", ".")]
    for a in dbs:
        for b in dbs:
            assert PSu.bp_distance(a, b) == JSu.bp_distance(a, b)
    assert np.array_equal(PSu.get_distance_matrix(dbs),
                          JSu.get_distance_matrix(dbs))


def test_energy_exports_equal():
    import rafft_tpu.energy as JE
    import rafft_tpu_torch.energy as PE
    assert PE.__all__ == JE.__all__
    for seq, db in CASES[:8]:
        assert PE.eval_structure_int(seq, db) == JE.eval_structure_int(seq, db)
        assert PE.eval_structure(seq, db) == JE.eval_structure(seq, db)
    assert dataclasses.asdict(PE.get_params(37.0)).keys() == \
        dataclasses.asdict(JE.get_params(37.0)).keys()


def test_root_api():
    for name in ("fold", "kinetics", "mfe_fold", "__version__"):
        assert name in rafft_tpu_torch.__all__ and name in rafft_tpu.__all__
    assert rafft_tpu_torch.__version__ == rafft_tpu.__version__
    for name in ("FoldEngine", "fold_one", "MfeEngine", "mfe_batch"):
        assert hasattr(rafft_tpu_torch, name)
    seq = CASES[3][0]
    assert rafft_tpu_torch.mfe_fold(seq) == rafft_tpu.mfe_fold(seq)


def _rows(structs):
    return [(s.str_struct, s.energy) for s in structs]


FOLD_ARGS = [("GGGUUUGCGGUGUAAGUGCAGCCCGUCUUACACCGUGCGGCACAGG", 100, 5, 1000),
             (CASES[1][0], 20, 3, 100), (CASES[2][0], 50, 8, 200)]


@pytest.mark.parametrize("k", range(len(FOLD_ARGS)))
def test_root_fold_equals_rafft_tpu(k):
    seq, nb, ms, mb = FOLD_ARGS[k]
    for traj in (False, True):
        got = rafft_tpu_torch.fold(seq, nb, ms, mb, traj=traj, device="cpu")
        want = rafft_tpu.fold(seq, nb, ms, mb, traj=traj)
        if traj:
            assert [_rows(s) for s in got[1]] == [_rows(s) for s in want[1]]
            got, want = got[0], want[0]
        assert _rows(got) == _rows(want)


def _lists(structs):
    """Each structure's pair set and its node_list as a list of tuples."""
    return [(set(s.pair_list), [tuple(int(x) for x in a) for a in s.node_list])
            for s in structs]


@pytest.mark.parametrize("k", range(len(FOLD_ARGS)))
def test_root_fold_fills_pair_and_node_lists(k):
    """The root fold's structures from the engine carry rafft_tpu.fold's
    pair set, and its node_list in order, in the final beam and in every
    trajectory step; fold_one keeps both empty, as fold_jax.fold_one."""
    seq, nb, ms, mb = FOLD_ARGS[k]
    before = FT.REFOLDS
    got, got_traj = rafft_tpu_torch.fold(seq, nb, ms, mb, traj=True,
                                         device="cpu")
    assert FT.REFOLDS == before           # the engine answered
    want, want_traj = rafft_tpu.fold(seq, nb, ms, mb, traj=True)
    assert _lists(got) == _lists(want)
    assert [_lists(s) for s in got_traj] == [_lists(s) for s in want_traj]
    for s in got:
        assert s.pair_list == sorted(s.pair_list)
        assert all(i < j for i, j in s.pair_list)
        assert all(a.dtype == np.int64 for a in s.node_list)
    assert any(s.pair_list for s in got) and any(s.node_list for s in got)
    for s in FT.fold_one(seq, nb, ms, mb, device="cpu"):
        assert s.pair_list == [] and s.node_list == []


SEQ30 = "GGGGAAAACCCCUUUUGGGGAAAACCCCAA"
DEGENERATE = [("", {}), (SEQ30, dict(max_stack=0)), (SEQ30, dict(max_stack=-1)),
              (SEQ30, dict(nb_mode=0)), (SEQ30, dict(nb_mode=-1))]


@pytest.mark.parametrize("seq,kw", DEGENERATE,
                         ids=["empty", "max_stack_0", "max_stack_-1",
                              "nb_mode_0", "nb_mode_-1"])
def test_root_fold_sends_degenerate_inputs_to_fold_cpu(seq, kw, monkeypatch,
                                                       caplog):
    """An empty sequence, max_stack < 1 and nb_mode < 1 go to fold_cpu
    before any engine is built (logged, counted), so the root fold equals
    rafft_tpu.fold, final beam and trajectory, pair and node lists."""
    def no_engine(*a, **k):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(FT, "FoldEngine", no_engine)
    for traj in (False, True):
        before = FT.REFOLDS
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=FT.__name__):
            got = rafft_tpu_torch.fold(seq, traj=traj, device="cpu", **kw)
        assert FT.REFOLDS == before + 1
        assert "goes to fold_cpu" in caplog.text
        assert FT.fold_refusal(seq, kw.get("nb_mode", 100),
                               kw.get("max_stack", 1), None) in caplog.text
        want = rafft_tpu.fold(seq, traj=traj, **kw)
        if traj:
            assert [(_rows(s), _lists(s)) for s in got[1]] == \
                [(_rows(s), _lists(s)) for s in want[1]]
            got, want = got[0], want[0]
        assert (_rows(got), _lists(got)) == (_rows(want), _lists(want))


def test_root_fold_refolds_a_flagged_fold(monkeypatch, caplog):
    """A fold the engine flags comes from fold_cpu, logged with its cause."""
    seq, nb, ms, mb = FOLD_ARGS[0]
    cut = FT.fold_one_config

    def tiny_seen_set(*a):
        return dataclasses.replace(cut(*a), S=24)

    monkeypatch.setattr(FT, "fold_one_config", tiny_seen_set)
    assert FT._fold_one(seq, nb, ms, mb, 3, 0.0, False, 37.0, 3.0, 2.0, 1.0,
                        "cpu")[1] & FT.FLAG_SEEN
    before = FT.REFOLDS
    with caplog.at_level(logging.INFO, logger=FT.__name__):
        got, traj = rafft_tpu_torch.fold(seq, nb, ms, mb, traj=True,
                                         device="cpu")
    assert FT.REFOLDS == before + 1
    assert "seen_set" in caplog.text
    want, want_traj = rafft_tpu.fold(seq, nb, ms, mb, traj=True)
    assert _rows(got) == _rows(want)
    assert [_rows(s) for s in traj] == [_rows(s) for s in want_traj]


@pytest.mark.parametrize("kw", [dict(max_stack=256), dict(min_hp=-1)],
                         ids=["max_stack_256", "min_hp_-1"])
def test_root_fold_takes_what_the_engine_refuses(kw, caplog):
    """FoldEngine refuses K > 255 and min_hp < 0; the root fold sends
    those calls to fold_cpu (logged, counted) and so equals
    rafft_tpu.fold, final beam and trajectory."""
    seq = FOLD_ARGS[0][0][:43]
    cfg = FT.fold_one_config(len(seq), 100, kw.get("max_stack", 1), 100,
                             kw.get("min_hp", 3))
    assert FT.engine_refusal(cfg) is not None
    with pytest.raises(ValueError):
        FT.fold_one(seq, device="cpu", **kw)
    before = FT.REFOLDS
    with caplog.at_level(logging.INFO, logger=FT.__name__):
        got, traj = rafft_tpu_torch.fold(seq, traj=True, device="cpu", **kw)
    assert FT.REFOLDS == before + 1
    assert FT.engine_refusal(cfg) in caplog.text
    want, want_traj = rafft_tpu.fold(seq, traj=True, **kw)
    assert _rows(got) == _rows(want) and len(got) >= 1
    assert [_rows(s) for s in traj] == [_rows(s) for s in want_traj]


def test_root_fold_sends_long_sequences_to_fold_cpu(monkeypatch, caplog):
    """Past 4,096 nt (MAX_N) the root fold builds no engine and returns
    fold_cpu's answer for the same arguments (fold_cpu itself is patched:
    folding 4,200 nt here would take minutes)."""
    from rafft_tpu_torch.engine import fold_cpu

    calls = []

    def fake_fold(seq, *args):
        calls.append((len(seq), args))
        return ["fold_cpu's beam"]

    def no_engine(*a, **kw):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(fold_cpu, "fold", fake_fold)
    monkeypatch.setattr(FT, "FoldEngine", no_engine)
    seq = "GGGGAAAACCCC" * 350
    before = FT.REFOLDS
    with caplog.at_level(logging.INFO, logger=FT.__name__):
        got = rafft_tpu_torch.fold(seq, 20, 3, 50, device="cpu")
    assert got == ["fold_cpu's beam"]
    assert calls == [(4200, (20, 3, 50, 3, 0.0, False, 37.0, 3.0, 2.0, 1.0))]
    assert FT.REFOLDS == before + 1
    assert f"exceeds {FT.MAX_N}" in caplog.text


def test_drawing_modules_import_without_matplotlib_or_sklearn():
    script = r"""
import sys
for m in ("matplotlib", "matplotlib.pyplot", "sklearn", "sklearn.manifold"):
    sys.modules[m] = None
from rafft_tpu_torch.kin import plot
from rafft_tpu_torch.viz import layout, plot_path, surface
from rafft_tpu_torch.cli import kin_cli
assert surface.bp_distance("((..))", "(....)") == 1
try:
    plot.plot_traj([[1.0]], [None], [1.0], 10, 4, 3, 0.1, "x.png")
except ImportError:
    print("OK")
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
