"""The port's own copies of the JAX-free modules against the originals.

rafft_tpu_torch keeps its own energy tables, parameters, encodings,
structure helpers, scorer, numpy evaluator, sequential CPU parity engine
and native evaluator, so that it imports nothing of rafft_tpu.  Each copy
is held here against its original on seeded numpy inputs.  Everything is
integer or copied data, so every comparison is exact.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from rafft_tpu import scoring as JS
from rafft_tpu import struct as JSt
from rafft_tpu.energy import eval_np as JE
from rafft_tpu.energy import params as JP
from rafft_tpu.engine import fold_cpu as JF
from rafft_tpu.scan import encode as JEnc
from rafft_tpu_torch import scoring as PS
from rafft_tpu_torch import struct as PSt
from rafft_tpu_torch.convert import (device_params_from_energy_params,
                                     device_params_from_numpy)
from rafft_tpu_torch.energy import eval_np as PE
from rafft_tpu_torch.energy import eval_torch as ET
from rafft_tpu_torch.energy import params as PP
from rafft_tpu_torch.engine import fold_cpu as PF
from rafft_tpu_torch.parallel import sweep as PSw
from rafft_tpu_torch.scan import encode as PEnc

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SEQS = ("GGGUUUGCGGUGUAAGUGCAGCCCGUCUUACACCGUGCGGCACAGG",
        "GCGCUUCGCCGCGCGCAAGCGGCUUAGCCGAAAGGCUAAG",
        "AUGGCUACGUAGCUAGCUAGCGAUCGAUCGUAGCUAGCUGACUGAUCGUAGC",
        "GGGAAACCCAAAGGGAAACCCUUUGGGAAACCC")


def _random_seq(rng, n):
    return "".join(rng.choice(list("ACGU"), n))


def _random_structure(rng, seq):
    """A nested structure of canonical pairs with hairpins >= 3."""
    can = {("A", "U"), ("U", "A"), ("G", "C"), ("C", "G"), ("G", "U"),
           ("U", "G")}
    pairs, stack = [], []
    for i, ch in enumerate(seq):
        u = rng.random()
        if stack and i - stack[-1] > 3 and (seq[stack[-1]], ch) in can \
                and u < 0.5:
            pairs.append((stack.pop(), i))
        elif u > 0.6:
            stack.append(i)
    return pairs


@pytest.mark.parametrize("temp", [37.0, 25.0])
def test_params_equal(temp):
    a, b = JP.get_params(temp), PP.get_params(temp)
    fa = {f.name for f in dataclasses.fields(a)}
    assert fa == {f.name for f in dataclasses.fields(b)}
    for name in sorted(fa):
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name          # scalars and the loop dictionaries


def test_encodings_and_weights_equal():
    rng = np.random.default_rng(0)
    for n in (1, 17, 200):
        seq = "".join(rng.choice(list("ACGUTNacgu"), n))
        a, b = JP.encode_sequence(seq), PP.encode_sequence(seq)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(JEnc.forward_onehot(a),
                                      PEnc.forward_onehot(b))
    for w in ((3.0, 2.0, 1.0), (2.5, 1.5, 0.5)):
        W = JEnc.weight_matrix(*w)
        np.testing.assert_array_equal(W, PEnc.weight_matrix(*w))
        codes = rng.integers(0, 5, 30)
        np.testing.assert_array_equal(JEnc.backward_weights(codes, W),
                                      PEnc.backward_weights(codes, W))


def test_struct_and_scoring_equal():
    rng = np.random.default_rng(1)
    for k in range(20):
        seq = _random_seq(rng, int(rng.integers(20, 90)))
        pairs = _random_structure(rng, seq)
        other = _random_structure(rng, seq)
        db = JSt.dot_bracket(pairs, len(seq))
        assert db == PSt.dot_bracket(pairs, len(seq))
        assert JSt.pair_table(db) == PSt.pair_table(db)
        assert JSt.pair_table(pairs, len(seq)) == PSt.pair_table(pairs, len(seq))
        assert JSt.paired_positions(db) == PSt.paired_positions(db)
        true_db = JSt.dot_bracket(other, len(seq))
        assert JS.score_structures(db, true_db) == PS.score_structures(db, true_db)
        beam = [db, true_db, "." * len(seq)]
        assert JS.best_of(beam, true_db) == PS.best_of(beam, true_db)


def test_eval_structure_int_equal():
    rng = np.random.default_rng(2)
    pj, pp = JP.get_params(37.0), PP.get_params(37.0)
    n_paired = 0
    for k in range(40):
        seq = _random_seq(rng, int(rng.integers(20, 120)))
        db = PSt.dot_bracket(_random_structure(rng, seq), len(seq))
        n_paired += "(" in db
        assert JE.eval_structure_int(seq, db, pj) == \
            PE.eval_structure_int(seq, db, pp), (seq, db)
        assert JE.eval_structure(seq, db) == PE.eval_structure(seq, db)
    assert n_paired > 20


@pytest.mark.parametrize("max_stack", [5, 20])
@pytest.mark.parametrize("k", range(len(SEQS)))
def test_fold_cpu_equal(k, max_stack):
    """Same structures, energies and trajectory from both engines."""
    want, wtraj = JF.fold(SEQS[k], nb_mode=50, max_stack=max_stack,
                          max_branch=200, traj=True)
    got, gtraj = PF.fold(SEQS[k], nb_mode=50, max_stack=max_stack,
                         max_branch=200, traj=True)
    rows = lambda beam: [(s.str_struct, s.energy, sorted(s.pair_list))
                         for s in beam]
    assert rows(got) == rows(want)
    assert [rows(b) for b in gtraj] == [rows(b) for b in wtraj]
    assert PF.EVALUATOR in ("native", "numpy")


def test_native_evaluator_equals_numpy():
    if shutil.which("g++") is None:
        pytest.skip("needs g++: the native evaluator is built at first use")
    from rafft_tpu_torch.native import native_oracle
    rng = np.random.default_rng(3)
    for temp in (37.0, 25.0, 37.0):      # the library re-initialises its tables
        ev, params = native_oracle(temp), PP.get_params(temp)
        for k in range(25):
            seq = _random_seq(rng, int(rng.integers(12, 150)))
            db = PSt.dot_bracket(_random_structure(rng, seq), len(seq))
            pt = np.asarray(PSt.pair_table(db), np.int32)
            codes = PP.encode_sequence(seq).astype(np.int8)
            assert ev(codes, pt) == PE.eval_structure_int(seq, db, params)
    with pytest.raises(ValueError):
        ev(codes.astype(np.int32), pt)
    PF.fold(SEQS[3], nb_mode=20, max_stack=2, max_branch=50)
    assert PF.EVALUATOR == "native"


def test_native_library_builds_under_build_dir():
    if shutil.which("g++") is None:
        pytest.skip("needs g++: the native evaluator is built at first use")
    from rafft_tpu_torch import _build
    lib = _build.build("turner_eval")
    assert lib.parent == _build.BUILD_DIR and lib.parent.name == "rafft_tpu_torch"
    assert lib.parent.parent.name == "build"
    assert not list((_build.PKG / "native").glob("*.so"))


@pytest.mark.parametrize("temp", [37.0, 25.0])
def test_convert_from_both_parameter_sources(temp):
    N = 96
    from_jax = device_params_from_energy_params(JP.get_params(temp), N, "cpu")
    from_port = device_params_from_energy_params(PP.get_params(temp), N, "cpu")
    own = ET.DeviceParams(ET.param_arrays(PP.get_params(temp), N), temp)
    arrays = {k: getattr(from_jax, k) for k in ET.TABLES + ET.SCALARS}
    again = device_params_from_numpy(
        {k: np.asarray(v) for k, v in arrays.items()}, temp, "cpu")
    for dp in (from_port, own, again):
        assert dp.temp == temp
        for k in ET.TABLES:
            a, b = getattr(from_jax, k), getattr(dp, k)
            assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b), k
        for k in ET.SCALARS:
            assert getattr(from_jax, k) == getattr(dp, k), k


def test_sweep_helpers_equal():
    from rafft_tpu.parallel import sweep as JSw
    assert PSw.JAX_BUCKETS == JSw.DEFAULT_BUCKETS
    assert PSw.FLAG_NAMES == JSw.FLAG_NAMES
    for n in (1, 128, 129, 1024, 1025, 5000):
        assert PSw.bucket_of(n, JSw.DEFAULT_BUCKETS) == \
            JSw.bucket_of(n, JSw.DEFAULT_BUCKETS)
    for N in JSw.DEFAULT_BUCKETS:
        assert PSw.bucket_batch(16, N) == JSw.bucket_batch(16, N)
    task = (3, SEQS[1], 30, 5, 100)
    i, rows, evaluator = PSw._cpu_refold(task)
    assert (i, rows) == JSw._cpu_refold(task) and evaluator == PF.EVALUATOR


def test_results_csv_equal(tmp_path):
    from rafft_tpu.parallel import sweep as JSw
    rows = [dict(seq="GGGAAACCC", len_seq=9, struct="(((...)))", nrj=-1.5,
                 nbp=3, pvv=100.0, sens=50.0, struct_bk="((.....))",
                 nrj_bk=-0.5, pvv_bk=66.67, sens_bk=40.0, name="a,b"), None]
    for sel in ("best_nrj", "best_of_k"):
        JSw.write_results_csv(rows, tmp_path / "j.csv", sel)
        PSw.write_results_csv(rows, tmp_path / "p.csv", sel)
        assert (tmp_path / "j.csv").read_text() == (tmp_path / "p.csv").read_text()
    src = tmp_path / "bench.csv"
    src.write_text("GGGAAACCC,(((...))),one\nshort,row\nACGU,....,two,extra\n")
    assert PSw.load_benchmark_csv(src) == JSw.load_benchmark_csv(src)


def test_entry_points_default_to_cuda():
    """No device named means the card: the defaults say cuda, and where
    there is no card the engine raises instead of folding on the CPU."""
    import inspect

    from rafft_tpu_torch.cli import fold_cli
    from rafft_tpu_torch.engine import fold_torch as FT
    for fn in (FT.fold_one, FT.FoldEngine.__init__, PSw.sweep):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert fold_cli.parse_arguments(["-s", "ACGU"]).device == "cuda"
    assert fold_cli.parse_arguments(["-s", "ACGU", "--device", "cpu"]).device == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises((RuntimeError, AssertionError)):
        FT.fold_one("GGGAAACCC", nb_mode=4, max_stack=1, max_branch=4)
    with pytest.raises((RuntimeError, AssertionError)):
        PSw.sweep([("GGGAAACCC", ".........", "x")], buckets=(32,))
