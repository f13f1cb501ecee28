"""The reference outputs that chip_smoke.py holds the card against.

chip_smoke.py runs where the JAX package is not installed and imports
nothing of it, so the outputs of the JAX package that it compares with
are committed in rafft_tpu_torch/testdata/chip_smoke_refs.json:

  fold_one  the README sequence through the sequential CPU parity oracle
            fold_cpu at max_stack 5 and 20, every trajectory step and
            the final beam;
  cli       the reference CLI's stdout (CPU engine) for the README
            sequence at -ms 20 --traj;
  oracle    fold_cpu's beams (-n 100 -ms 50) for the journal rows where
            the committed journal differs from the reference semantics;
  weights   the README sequence through the JAX engine on the CPU
            (fold_jax.fold_one, its FFT correlation path) at non-integral
            pair weights, max_stack 5 and 20, trajectory and final beam;
  cli_nono  the reference CLI's stdout for the README sequence at
            -ms 5 --nono (the tree-keeping engine and its printed tree);
  long      two seeded sequences of 1,100 to 2,000 nt
            (tools/measure.py:seeded_sequence) with fold_cpu's beams at
            the cut configuration -n 20 -ms 3 --max_branch 100;
  mfe       the JAX package's batched MFE DP (mfe_jax.mfe_batch, one
            batch at N=128) on the README sequence and the first 8
            journal rows of 65 to 120 nt: structures and energies;
  kin       the JAX kinetics CLI's stdout on the `cli` output (the
            README fold's trajectory), with --method expm at the
            default -mt 30 and with the eig method at -mt 10 (where its
            eigendecomposition is well conditioned, so that another
            LAPACK prints the same).

Each test recomputes one part from the JAX package and asserts that the
committed file still holds it (the max_stack 20 part of `weights` is
checked in tests/test_torch_smoke_refs_w20.py: each costs one compile of
the JAX engine; `mfe` in tests/test_torch_smoke_refs_mfe.py: the JAX DP
takes about 8 s a sequence on the CPU at N=128).  To write the file anew:

    JAX_PLATFORMS=cpu python tests/test_torch_smoke_refs.py --write
"""

import contextlib
import gzip
import io
import json
import os
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rafft_tpu.cli import fold_cli as JCLI  # noqa: E402
from rafft_tpu.cli import kin_cli as JKIN  # noqa: E402
from rafft_tpu.engine.fold_cpu import fold as cpu_fold  # noqa: E402
from rafft_tpu_torch.tools.measure import seeded_sequence  # noqa: E402

REFS = os.path.join(ROOT, "rafft_tpu_torch", "testdata",
                    "chip_smoke_refs.json")
JOURNAL = os.path.join(ROOT, "benchmarks", "artifacts",
                       "beams_100n50.jsonl.gz")
README_SEQ = ("GGGUUUGCGGUGUAAGUGCAGCCCGUCUUACACCGUGCGGCACAGGCACUAGUACUGAUGU"
              "CGUAUACAGGGCUUUUGACAU")
CLI_ARGS = ["-s", README_SEQ, "-ms", "20", "--traj"]
# unflagged 128-bucket rows whose journal beam is not fold_cpu's
ORACLE_ROWS = (443, 567, 947, 1262)
WEIGHTS = dict(gc_wei=2.5, au_wei=1.7, gu_wei=0.8)
NONO_ARGS = ["-s", README_SEQ, "-ms", "5", "--nono"]
# (seed, shortest, longest) of the seeded long sequences, and their cut
# configuration
LONG_SEQS = ((2048, 1100, 2000), (2049, 1100, 2000))
LONG_CUT = dict(nb_mode=20, max_stack=3, max_branch=100)
# the MFE entry: journal rows of the 128 MFE bucket, at most 120 nt
MFE_N, MFE_ROWS, MFE_MAXLEN = 128, 8, 120
KIN_ARGS = (["--method", "expm"], ["-mt", "10"])


def _rows(structs):
    return [[s.str_struct, s.energy] for s in structs]


def ref_fold_one(ms):
    final, traj = cpu_fold(README_SEQ, 100, ms, 1000, 3, 0.0, True, 37.0,
                           3.0, 2.0, 1.0)
    return dict(traj=[_rows(s) for s in traj], final=_rows(final))


def ref_cli(args=CLI_ARGS):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JCLI.main(args)
    return dict(args=args[2:], stdout=buf.getvalue())


def ref_weights(ms):
    """The JAX engine on the CPU at non-integral weights."""
    from rafft_tpu.engine.fold_jax import fold_one
    final, traj = fold_one(README_SEQ, nb_mode=100, max_stack=ms,
                           max_branch=1000, traj=True, **WEIGHTS)
    return dict(traj=[_rows(s) for s in traj], final=_rows(final))


def ref_long(seed, nmin, nmax):
    seq = seeded_sequence(seed, nmin, nmax)
    beam = [[s.str_struct, float(np.float32(s.energy))]
            for s in cpu_fold(seq, **LONG_CUT)]
    return dict(seed=seed, nmin=nmin, nmax=nmax, seq=seq, cut=LONG_CUT,
                beam=beam)


def ref_oracle(row):
    with gzip.open(JOURNAL, "rt") as fh:
        r = next(json.loads(line) for i, line in enumerate(fh) if i == row)
    beam = [[s.str_struct, float(np.float32(s.energy))]
            for s in cpu_fold(r["seq"], nb_mode=100, max_stack=50,
                              max_branch=1000)]
    return dict(row=row, name=r["name"], seq=r["seq"], beam=beam)


def mfe_rows():
    """(journal index or None, name, seq): the README sequence, then the
    first MFE_ROWS journal rows of 65 to MFE_MAXLEN nt."""
    out = [(None, "readme", README_SEQ)]
    with gzip.open(JOURNAL, "rt") as fh:
        for i, line in enumerate(fh):
            r = json.loads(line)
            if 64 < len(r["seq"]) <= MFE_MAXLEN:
                out.append((i, r["name"], r["seq"]))
                if len(out) > MFE_ROWS:
                    break
    return out


def ref_mfe(rows):
    from rafft_tpu.mfe.mfe_jax import mfe_batch
    res = mfe_batch([seq for _, _, seq in rows], N=MFE_N)
    return [dict(row=i, name=name, seq=seq, struct=db, nrj=e)
            for (i, name, seq), (db, e) in zip(rows, res)]


def ref_kin(rafft_out, tmp_dir):
    path = os.path.join(tmp_dir, "rafft.out")
    with open(path, "w") as fh:
        fh.write(rafft_out)
    out = []
    for args in KIN_ARGS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            JKIN.main([path, *args])
        out.append(dict(args=args, stdout=buf.getvalue()))
    return out


def build():
    return dict(readme_seq=README_SEQ,
                fold_one={str(ms): ref_fold_one(ms) for ms in (5, 20)},
                cli=ref_cli(),
                oracle=[ref_oracle(i) for i in ORACLE_ROWS],
                weights=dict(args=WEIGHTS, fold_one={
                    str(ms): ref_weights(ms) for ms in (5, 20)}),
                cli_nono=ref_cli(NONO_ARGS),
                long=[ref_long(*a) for a in LONG_SEQS],
                mfe=dict(N=MFE_N, rows=ref_mfe(mfe_rows())),
                kin=ref_kin(ref_cli()["stdout"], tempfile.mkdtemp()))


@pytest.fixture(scope="module")
def committed():
    with open(REFS) as fh:
        return json.load(fh)


@pytest.mark.parametrize("ms", [5, 20])
def test_fold_one_refs(committed, ms):
    assert committed["readme_seq"] == README_SEQ
    assert committed["fold_one"][str(ms)] == ref_fold_one(ms)


def test_cli_refs(committed):
    assert committed["cli"] == ref_cli()


@pytest.mark.parametrize("k", range(len(ORACLE_ROWS)))
def test_oracle_refs(committed, k):
    want = ref_oracle(ORACLE_ROWS[k])
    assert committed["oracle"][k] == want
    with gzip.open(JOURNAL, "rt") as fh:
        row = next(json.loads(line) for i, line in enumerate(fh)
                   if i == ORACLE_ROWS[k])
    # these rows are committed because the journal is not the reference
    # semantics there
    assert not row["flagged"] and row["beam"] != want["beam"]


def test_weights_refs(committed):
    assert committed["weights"]["args"] == WEIGHTS
    assert committed["weights"]["fold_one"]["5"] == ref_weights(5)


def test_cli_nono_refs(committed):
    assert committed["cli_nono"] == ref_cli(NONO_ARGS)
    assert "Full Tree" in committed["cli_nono"]["stdout"]


@pytest.mark.parametrize("k", range(len(LONG_SEQS)))
def test_long_refs(committed, k):
    want = ref_long(*LONG_SEQS[k])
    assert committed["long"][k] == want
    assert 1100 <= len(want["seq"]) <= 2000 and want["beam"][0][1] < 0


def test_kin_refs(committed, tmp_path):
    assert committed["kin"] == ref_kin(committed["cli"]["stdout"], str(tmp_path))
    for k in committed["kin"]:
        assert len(k["stdout"].splitlines()) > 10


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit(__doc__)
    os.makedirs(os.path.dirname(REFS), exist_ok=True)
    with open(REFS, "w") as fh:
        json.dump(build(), fh, indent=0)
        fh.write("\n")
    print(f"wrote {REFS}")
