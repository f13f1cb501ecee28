"""The port's benchmark entry point against the root bench.py, on the CPU.

rafft_tpu_torch/tools/bench.py is held to bench.py (loaded by path) in
what it builds: with every FoldEngine replaced by a spy that records its
(config, B) and folds nothing, the port's cells take bench.py's
configurations and batches, but for the kept CPLX difference (the port
measures the sweep's configuration, CPLX=1024 above N=128; bench.py
leaves CPLX at 512).  What the cells fold is held to the JAX engine's
run_stream at a small configuration, and the JSON line to bench.py's
keys.  The corpus helpers, the CPU baseline tool and bench_full's two
sections run here at small sizes.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import time

import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.parallel import sweep as TS
from rafft_tpu_torch.tools import bench as TB
from rafft_tpu_torch.tools import bench_full as BF
from rafft_tpu_torch.tools import corpus as TC
from rafft_tpu_torch.tools import measure_baseline as MB

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = tuple(N for N, _ in TB.BUCKET_SAMPLES)
CELLS = tuple(str(N) for N in BUCKETS) + ("headline",)
# where the port keeps the sweep's CPLX=1024 and bench.py has 512
KEPT_CPLX = ("256", "512", "1024")
# where the port keeps the sweep's region slots (region_slots) and
# bench.py has 16
KEPT_R = ("512",)
# a configuration small enough for the JAX engine to compile quickly
SMALL = dict(N=32, K=5, R=4, M=12, V=32, CPLX=8, S=128, max_branch=24,
             max_steps=8)


def _spy(made):
    """A FoldEngine stand-in: records (cfg, B) in `made` and yields an
    empty structure for every sequence, after a millisecond."""
    class Spy:
        def __init__(self, cfg, B, device=None):
            self.cfg, self.B = cfg, B
            made.append((cfg, B))

        def run_stream(self, seqs):
            time.sleep(1e-3)
            for i, s in enumerate(seqs):
                yield i, [("." * len(s), 0.0)], 0
    return Spy


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    """bench.py's main over the in-repo corpus written as its CSV, every
    FoldEngine a spy: the (cfg, B) of each cell and its JSON line."""
    path = tmp_path_factory.mktemp("bench") / "corpus.csv"
    with open(path, "w") as fh:
        for i, (seq, _row) in enumerate(TC.corpus()):
            fh.write(f"{seq},{'.' * len(seq)},r{i}\n")
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    made, buf = [], io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FJ, "FoldEngine", _spy(made))
        mp.setattr(mod, "CORPUS", str(path))
        with contextlib.redirect_stdout(buf):
            mod.main()
    # bench.py builds the bucket engines in BUCKET_SAMPLES order, then
    # the headline's
    assert [b for b, _ in mod.BUCKET_SAMPLES] == list(BUCKETS)
    return dict(configs=dict(zip(CELLS, made)),
                line=json.loads(buf.getvalue().strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def port_configs():
    made = []
    seqs_by_bucket, _counts, _n = TC.by_bucket(TC.corpus(), BUCKETS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "FoldEngine", _spy(made))
        for N, sample in TB.BUCKET_SAMPLES:
            TB.bucket_rate(N, sample, seqs_by_bucket, "cpu")
        TB.headline(TC.headline_rows(TC.corpus()), "cpu")
    return dict(zip(CELLS, made))


@pytest.mark.parametrize("cell", CELLS)
def test_configs_match_jax_bench(cell, jax_bench, port_configs):
    """Every field and the batch equal bench.py's, but CPLX and R where
    kept."""
    (jcfg, jB), (pcfg, pB) = jax_bench["configs"][cell], port_configs[cell]
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(pcfg)
    for key, kept in (("CPLX", KEPT_CPLX), ("R", KEPT_R)):
        if cell in kept:
            want.pop(key)
            got.pop(key)
    assert got == want and pB == jB


@pytest.mark.parametrize("cell", KEPT_CPLX)
def test_cplx_kept_difference(cell, jax_bench, port_configs):
    """bench.py leaves CPLX at 512; the port takes the sweep's 1024."""
    N = int(cell)
    assert jax_bench["configs"][cell][0].CPLX == 512
    assert port_configs[cell][0].CPLX == 1024
    assert port_configs[cell][0] == TS.bucket_config(N, 100, 50, 1000)


def test_region_slots_kept_difference(jax_bench, port_configs):
    """bench.py gives the 512 bucket 16 region slots; the port takes the
    sweep's (region_slots), which hold that band's need.  The 128 and 256
    cells keep every field of the sweep's configuration, as before."""
    assert jax_bench["configs"]["512"][0].R == 16
    assert port_configs["512"][0].R == FT.region_slots(512) == 24
    for cell in CELLS:
        R = port_configs[cell][0].R
        assert R == (24 if cell == "512" else
                     jax_bench["configs"][cell][0].R), cell
    for N in (128, 256):
        assert port_configs[str(N)][0] == TS.bucket_config(N, 100, 50, 1000)
        assert dataclasses.asdict(TS.bucket_config(N, 100, 50, 1000)) == dict(
            N=N, K=50, R=16, M=100, V=4096, W=8 if N == 128 else 24,
            CPLX=512 if N == 128 else 1024, S=16384, max_steps=24,
            max_branch=1000, min_hp=3, min_nrj=0.0, temp=37.0, gc_wei=3.0,
            au_wei=2.0, gu_wei=1.0)


def test_corpus_buckets(jax_bench):
    """bench.py's bucketing of the corpus: counts, and order kept."""
    records = TC.corpus()
    seqs_by_bucket, counts, n_longtail = TC.by_bucket(records, BUCKETS)
    assert counts == {128: 1938, 256: 80, 512: 252, 1024: 24}
    assert n_longtail == 2 and len(records) == 2296
    assert [s for N in BUCKETS for s in seqs_by_bucket[N]] == \
        [s for s, _row in records if len(s) <= 1024]
    line = jax_bench["line"]
    assert {N: v["corpus_n"] for N, v in line["per_bucket"].items()} == \
        {str(N): n for N, n in counts.items()}
    assert line["corpus_excluded_gt1024nt"] == n_longtail


def test_headline_rows():
    """The first 256 journal rows of at most 120 nt, in journal order."""
    rows = TC.headline_rows(TC.corpus())
    want = [r["seq"] for r in TC.journal() if len(r["seq"]) <= 120][:256]
    assert rows == want and len(rows) == 256
    assert max(map(len, rows)) <= 120


@pytest.fixture(scope="module")
def small_folds():
    """The journal rows of at most 32 nt, and the JAX engine's
    run_stream over them at SMALL, B=2, as (seq, rows, flagged)."""
    seqs = [r["seq"] for r in TC.journal() if len(r["seq"]) <= SMALL["N"]]
    assert len(seqs) >= 4
    out = FJ.FoldEngine(FJ.EngineConfig(**SMALL), B=2).run_stream(seqs)
    return seqs, [(seqs[i], rows, flag) for i, rows, flag in sorted(out)]


@pytest.mark.parametrize("cell", ["bucket_rate", "headline", "scan"])
def test_cells_fold_as_jax_run_stream(cell, monkeypatch, small_folds):
    """The bench's cells and bench_full's scan, at the small
    configuration, yield the JAX engine's rows and flags exactly."""
    seqs, want = small_folds
    monkeypatch.setattr(TB, "bucket_config",
                        lambda N, *a: FT.EngineConfig(**SMALL))
    monkeypatch.setattr(TB, "bucket_batch", lambda batch, N: 2)
    if cell == "scan":
        folds = {}
        scan = BF.batch_scan(seqs, "cpu", bs=(2, 3), folds=folds)
        assert [(r["B"], r["n"]) for r in scan] == [(2, len(seqs)),
                                                    (3, len(seqs))]
        assert scan[0]["seq_s"] > 0 and scan[0]["peak_mib"] is None
        assert folds[2] == want and folds[3] == want
        return
    got = (TB.headline(seqs, "cpu") if cell == "headline" else
           TB.bucket_rate(128, len(seqs), {128: seqs}, "cpu"))
    assert got.n == len(seqs) and len(got.secs) == 1
    assert TB.folded(seqs, got.out) == want


def test_json_line(monkeypatch, jax_bench):
    """run() on tiny samples: bench.py's keys plus device and passes, and
    the corpus rate is the count-weighted harmonic combination of the
    bucket rates."""
    monkeypatch.setattr(TB, "FoldEngine", _spy([]))
    monkeypatch.setattr(TB, "BUCKET_SAMPLES",
                        ((128, 4), (256, 2), (512, 1), (1024, 1)))
    folds = {}
    line = json.loads(json.dumps(TB.run(device="cpu", passes=2,
                                        folds=folds)))
    assert set(line) == set(jax_bench["line"]) | {"device", "passes"}
    pb = line["per_bucket"]
    assert [(N, v["sampled"]) for N, v in pb.items()] == \
        [("128", 4), ("256", 2), ("512", 1), ("1024", 1)]
    assert line["corpus_seqs_per_s"] == \
        sum(v["corpus_n"] for v in pb.values()) / \
        sum(v["corpus_n"] / v["seqs_per_s"] for v in pb.values())
    assert line["corpus_covered"] == 2294
    assert line["corpus_excluded_gt1024nt"] == 2
    assert line["metric"] == jax_bench["line"]["metric"]
    assert line["n_seqs"] == 256 and line["device"] == "cpu"
    assert line["vs_baseline"] == line["value"] / line["baseline_seqs_per_s"]
    assert {k: len(v) for k, v in line["passes"].items()} == \
        dict.fromkeys(CELLS, 2)
    assert [len(folds[c]) for c in CELLS] == [4, 2, 1, 1, 256]


@pytest.mark.parametrize("missing", ["cuda", "baseline"])
def test_no_fallback(missing, monkeypatch, tmp_path):
    """No card: run(device="cuda") raises; no baseline artifact: raises.
    Neither folds anything first."""
    made = []
    monkeypatch.setattr(TB, "FoldEngine", _spy(made))
    if missing == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TB.run(device="cuda")
    else:
        monkeypatch.setattr(TB, "BASELINE", str(tmp_path / "none.json"))
        with pytest.raises(FileNotFoundError, match="measure_baseline"):
            TB.run(device="cpu")
    assert made == []


@pytest.mark.parametrize("which", ["measured", "committed"])
def test_baseline_artifact(which, tmp_path):
    """measure_baseline on 2 rows, and the committed artifact, carry the
    JAX artifact's keys plus the CPU model and the evaluator."""
    if which == "measured":
        path = tmp_path / "baseline.json"
        MB.main(["2", "--out", str(path)])
    else:
        path = TB.BASELINE
    with open(path) as fh:
        art = json.load(fh)
    with open(os.path.join(REPO, "benchmarks", "baseline_cpu.json")) as fh:
        jax_keys = set(json.load(fh))
    assert jax_keys | {"cpu", "evaluator"} <= set(art)
    assert art["seqs_per_s"] == art["n_seqs"] / art["wall_s"] > 0
    assert art["cpu"] and art["evaluator"] in ("native", "numpy")
    if which == "measured":
        assert art["n_seqs"] == 2 and TB.load_baseline(str(path)) > 0
    else:
        assert art["n_seqs"] == 64 and art["evaluator"] == "native"


def test_baseline_sample():
    """The JAX tool's deterministic stride over the <=120-nt sequences."""
    seqs = [s for s, _row in TC.corpus() if len(s) <= 120]
    got = MB.sample(64)
    assert len(got) == 64 and got == seqs[::len(seqs) // 64][:64]


def test_bench_full_manifest(tmp_path):
    """Section 1 on the manifest of a tiny sweep run on the CPU."""
    rows = TC.journal()[:3]
    csv_path, out = tmp_path / "in.csv", tmp_path / "res.csv"
    with open(csv_path, "w") as fh:
        for r in rows:
            fh.write(f"{r['seq']},{r['beam'][0][0]},{r['name']}\n")
    TS.main(["--csv", str(csv_path), "--out", str(out), "--device", "cpu",
             "-n", "8", "-ms", "2", "--max_branch", "16", "--batch", "4",
             "--fallback-workers", "1"])
    md = tmp_path / "report.md"
    BF.main(["--manifest", f"{out}.manifest.json", "--skip-scan",
             "--out", str(md)])
    text = md.read_text()
    assert "`-n 8 -ms 2`, batch 4, engine torch on cpu" in text
    assert "| 128 | 3 | 4 |" in text and "| **all** | 3 |" in text
    assert "CPU-fallback folds (flagged sequences): 0" in text
