"""The port's corpus-pipeline tools (rafft_tpu_torch/tools/merge_corpus.py,
fold_longtail.py, rescore_bk.py, bench_parity.py) and the reference
corpus order (tools/corpus.py:reference_order) on the CPU, against the
committed result files and the JAX package's tools.

The JAX tools that start a process pool (tools/fold_longtail.py,
benchmarks/bench_parity.py) run in a subprocess of their own, since this
process holds JAX's threads; the port's run as `python -m` modules.
Every output file is compared whole.
"""

import csv
import gzip
import importlib.util
import itertools
import json
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from rafft_tpu_torch.struct import dot_bracket
from rafft_tpu_torch.tools import bench_parity, corpus as TC
from rafft_tpu_torch.tools import fold_longtail, merge_corpus, rescore_bk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "benchmarks", "artifacts")


def _by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _random_structure(rng, n):
    """A seeded nested structure of n positions (hairpins >= 3)."""
    stack, pairs = [], []
    for i in range(n):
        u = rng.random()
        if stack and i - stack[-1] > 3 and u < 0.3:
            pairs.append((stack.pop(), i))
        elif u > 0.7:
            stack.append(i)
    return dot_bracket(pairs, n)


def test_reference_order():
    recs = TC.reference_order()
    assert len(recs) == 2296 and all(t == "" for _s, t, _n in recs)
    in_repo = {(r["seq"], r["name"]) for r in TC.journal()}
    with open(TC.LONGTAIL) as fh:
        in_repo |= {(r["seq"], r["name"]) for r in map(json.loads, fh)}
    assert {(s, n) for s, _t, n in recs} == in_repo
    short = TC.short_rows(recs)
    assert len(short) == 1733 and len(short[7]) == 102
    assert next(n for s, _t, n in recs if s == short[7]) == \
        "srp_Chro.viol._AE016825"


def test_merge_corpus_rebuilds_the_committed_csvs(tmp_path, capsys):
    a, b = tmp_path / "best_nrj.csv", tmp_path / "best_of_k.csv"
    merge_corpus.main(["--ckpt", os.path.join(ART, "sweep_100n50.ckpt.jsonl"),
                       os.path.join(ART, "longtail.ckpt.jsonl"),
                       "--out-best-nrj", str(a), "--out-best-of-k", str(b)])
    assert capsys.readouterr().out.startswith("2296 rows -> ")
    for got, name in ((a, "fft_100n_50ms_best_nrj_scores.csv"),
                      (b, "fft_100n_50ms_scores.csv")):
        with open(got, "rb") as g, open(os.path.join(ART, name), "rb") as w:
            assert g.read() == w.read(), name


def test_merge_corpus_refuses_a_partial_artifact(tmp_path):
    with pytest.raises(SystemExit, match="2 corpus rows have no result"):
        merge_corpus.main(["--ckpt", os.path.join(ART, "sweep_100n50.ckpt.jsonl"),
                           "--out-best-nrj", str(tmp_path / "a.csv"),
                           "--out-best-of-k", str(tmp_path / "b.csv")])


def test_rescore_bk_matches_jax(tmp_path):
    """50 committed journal rows re-scored from their saved beams against
    a seeded truth: the port's rewrite equals the JAX tool's."""
    with open(os.path.join(ART, "sweep_100n50.ckpt.jsonl")) as fh:
        rows = [json.loads(line) for line in itertools.islice(fh, 50)]
    keys = {(r["seq"], r["name"]) for r in rows}
    beams = tmp_path / "beams.jsonl.gz"
    with gzip.open(os.path.join(ART, "beams_100n50.jsonl.gz"), "rt") as fh, \
            gzip.open(beams, "wt") as out:
        for line in fh:
            if (json.loads(line)["seq"], json.loads(line)["name"]) in keys:
                out.write(line)
    rng = np.random.default_rng(50)
    truth = tmp_path / "truth.csv"
    with open(truth, "w", newline="") as fh:
        csv.writer(fh).writerows(
            (r["seq"], _random_structure(rng, len(r["seq"])), r["name"])
            for r in rows)
    ckpts = []
    for tag in ("jax", "port"):
        ckpt = tmp_path / f"{tag}.ckpt.jsonl"
        with open(ckpt, "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in rows)
        ckpts.append(ckpt)
    argv = lambda ckpt: ["--ckpt", str(ckpt), "--beams", str(beams),
                         "--truth", str(truth)]
    _by_path("jax_rescore_bk", "tools/rescore_bk.py").main(argv(ckpts[0]))
    rescore_bk.main(argv(ckpts[1]))
    got, want = (p.read_text() for p in reversed(ckpts))
    assert got == want and got != "".join(json.dumps(r) + "\n" for r in rows)
    assert not os.path.exists(str(ckpts[1]) + ".tmp")


def test_fold_longtail_matches_jax(tmp_path):
    """One seeded 1,100-nt sequence (and one short row the tool skips)
    at -n 20 -ms 3 --max_branch 100: equal journal and beams files."""
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("ACGU"), p=(.3, .2, .2, .3), size=1100))
    src = tmp_path / "bench.csv"
    with open(src, "w", newline="") as fh:
        csv.writer(fh).writerows([
            ("GGGAAACCC", "(((...)))", "short"),
            (seq, _random_structure(rng, len(seq)), "seeded_1100")])
    outs = {}
    for tag, cmd in (("jax", ["tools/fold_longtail.py"]),
                     ("port", ["-m", "rafft_tpu_torch.tools.fold_longtail"])):
        out, beams = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.beams.jsonl"
        stdout = _run([*cmd, "--csv", str(src), "--out", str(out),
                       "-n", "20", "-ms", "3", "--max_branch", "100",
                       "--save-beams", str(beams)])
        assert "[longtail] 1 sequences >= 1025 nt" in stdout
        outs[tag] = (out.read_text(), beams.read_text())
    assert outs["port"] == outs["jax"]
    row = json.loads(outs["port"][0])
    assert row["_idx"] == 1 and row["_bucket"] == 4096 and "_secs" not in row


def test_bench_parity_matches_jax(tmp_path):
    """Three short corpus rows: run_one's rows and the written file equal
    the JAX tool's."""
    recs = [r for r in TC.reference_order() if len(r[0]) <= 32][:3]
    jax_tool = _by_path("jax_bench_parity", "benchmarks/bench_parity.py")
    jax_tool._ARGS = Namespace(n_mode=100, max_stack=50, max_branch=1000)
    for rec in recs:
        assert bench_parity.run_one(rec) == jax_tool.run_one(rec)
    src = tmp_path / "bench.csv"
    with open(src, "w", newline="") as fh:
        csv.writer(fh).writerows((s, "." * len(s), n) for s, _t, n in recs)
    files = {}
    for tag, cmd in (("jax", ["benchmarks/bench_parity.py"]),
                     ("port", ["-m", "rafft_tpu_torch.tools.bench_parity"])):
        out = tmp_path / f"{tag}.csv"
        stdout = _run([*cmd, "2", "--csv", str(src), "--out", str(out)])
        assert stdout.startswith("3 seqs in ")
        files[tag] = out.read_text()
    assert files["port"] == files["jax"] and len(files["port"].splitlines()) == 3


def test_tools_take_the_reference_order_by_default(tmp_path, capsys):
    """Without --csv / --corpus the tools read reference_order(); the
    tools that score against the truth require it."""
    out = tmp_path / "parity.csv"
    bench_parity.main(["1", "--max_len", "30", "--limit", "2", "--out",
                       str(out), "-n", "20", "-ms", "3"])
    short = [r for r in TC.reference_order() if len(r[0]) <= 30][:2]
    assert capsys.readouterr().out.startswith("2 seqs in ")
    assert [ln.split(",")[:2] for ln in out.read_text().splitlines()] == \
        [[s, n] for s, _t, n in short]
    for main, argv, flag in (
            (fold_longtail.main, ["--out", "x"], "--csv"),
            (rescore_bk.main, ["--ckpt", "x", "--beams", "y"], "--truth")):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2 and flag in capsys.readouterr().err
