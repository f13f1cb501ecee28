"""The port's kinetics (rafft_tpu_torch.kin) and kinetics CLI against the
originals in rafft_tpu, on the same inputs.

Kinetics is host numpy/scipy in both packages.  The rate matrix is
compared exactly (longdouble); populations within 1e-12 (expm at any
horizon; eig at max_time <= 10, where its eigendecomposition is well
conditioned: see tests/test_kinetics.py).  The CLI's stdout is compared
as text on the committed output of the JAX fold CLI
(chip_smoke_refs.json, "cli": the README sequence at -ms 20 --traj).
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rafft_tpu.cli import kin_cli as JC
from rafft_tpu.struct import Structure as JStructure
from rafft_tpu_torch.struct import Structure as PStructure

# the modules (each package's kin/__init__ exports a function of that name)
JK = importlib.import_module("rafft_tpu.kin.kinetics")
PK = importlib.import_module("rafft_tpu_torch.kin.kinetics")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "rafft_tpu_torch", "testdata",
                       "chip_smoke_refs.json")) as _fh:
    REFS = json.load(_fh)
TOL = 1e-12


def _paths(cls, steps):
    out = []
    for step in steps:
        row = []
        for db, e in step:
            s = cls()
            s.str_struct, s.energy = db, e
            row.append(s)
        out.append(row)
    return out


def _cases():
    yield "two-state -1", [[["....", 0.0]], [["(..)", -1.0], ["....", 0.0]]]
    yield "two-state -2", [[["....", 0.0]], [["(..)", -2.0], ["....", 0.0]]]
    for ms in ("5", "20"):
        ref = REFS["fold_one"][ms]
        yield f"README ms={ms}", ref["traj"] + [ref["final"]]


CASES = dict(_cases())


@pytest.mark.parametrize("case", list(CASES))
def test_transition_matrix_equal(case):
    steps = CASES[case]
    want_p, got_p = _paths(JStructure, steps), _paths(PStructure, steps)
    structs = list({db: e for step in steps for db, e in step}.items())
    smap = {db: (i, e) for i, (db, e) in enumerate(structs)}
    want = JK.get_transition_mat(want_p, len(structs), smap)
    got = PK.get_transition_mat(got_p, len(structs), smap)
    assert got.dtype == np.longdouble and np.array_equal(got, want)


@pytest.mark.parametrize("method, max_time", [("expm", 30), ("expm", 10),
                                              ("eig", 10), ("eig", 5)])
@pytest.mark.parametrize("case", list(CASES))
def test_kinetics_equal(case, method, max_time):
    steps = CASES[case]
    init = [(0, 0.5), (1, 0.5)] if case.startswith("two") else None
    want = JK.kinetics(_paths(JStructure, steps), max_time, 60, init,
                       method=method)
    got = PK.kinetics(_paths(PStructure, steps), max_time, 60, init,
                      method=method)
    assert np.array_equal(got[1], want[1]) and len(got[0]) == len(want[0]) == 61
    diff = max(np.abs(np.real(np.asarray(g, dtype=np.complex128))
                      - np.real(np.asarray(w, dtype=np.complex128))).max()
               for g, w in zip(got[0], want[0]))
    assert diff <= TOL, diff
    assert [s.str_struct for s in got[2]] == [s.str_struct for s in want[2]]
    for g, w in zip(got[3], want[3]):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])
        assert abs(float(np.real(g[2])) - float(np.real(w[2]))) <= TOL


KIN_ARGS = ([], ["--method", "expm"], ["-mt", "10"],
            ["-ns", "50", "--method", "expm", "-ip", "0:0.5", "3:0.5"])


@pytest.mark.parametrize("args", KIN_ARGS, ids=" ".join)
def test_kin_cli_stdout_equal(tmp_path, args):
    path = tmp_path / "rafft.out"
    path.write_text(REFS["cli"]["stdout"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JC.main([str(path), *args])
    got = subprocess.run(
        [sys.executable, "-m", "rafft_tpu_torch.cli.kin_cli", str(path), *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout == buf.getvalue() and got.stdout.count("\n") > 10
