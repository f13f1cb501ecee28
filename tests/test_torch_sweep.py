"""The port's corpus sweep against the JAX package's, on the CPU.

The reference run is rafft_tpu.parallel.sweep.sweep(..., engine="cpu"):
every sequence folded by the sequential CPU parity engine through the
JAX package's own sweep (which imports no JAX on that path).  The port
folds the same records with its FoldEngine on device="cpu" at the
bucket's configuration; result dicts, checkpoint rows and beams-journal
rows must be equal.  The records are the first 6 journal rows, with
their journal best structure standing in for the true one so that the
scores are not trivial; nb_mode 20 and max_stack 3 keep the run short.
"""

import csv
import dataclasses
import gzip
import json
import math
import os

import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu.parallel import sweep as JS
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.parallel import sweep as TS

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

JOURNAL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
ARGS = dict(nb_mode=20, max_stack=3, max_branch=1000, batch=4, workers=2)
# the 512 bucket's region slots, the port's kept difference (the JAX
# sweep's 16 drops regions of two of its corpus rows)
R512 = 24


def _records(count=6):
    out = []
    for line in gzip.open(JOURNAL, "rt"):
        r = json.loads(line)
        out.append((r["seq"], r["beam"][0][0], r["name"]))
        if len(out) == count:
            break
    return out


def _run(fn, tmp_path, tag, **kw):
    ckpt, beams = tmp_path / f"{tag}.ckpt", tmp_path / f"{tag}.beams"
    stats = {}
    res = fn(_records(), checkpoint=str(ckpt), save_beams=str(beams),
             stats=stats, **ARGS, **kw)
    read = lambda p: [json.loads(line) for line in open(p)]
    return res, read(ckpt), read(beams), stats


@pytest.fixture(scope="module")
def cpu_ref(tmp_path_factory):
    return _run(JS.sweep, tmp_path_factory.mktemp("ref"), "ref", engine="cpu")


def _by_name(rows):
    return sorted(rows, key=lambda r: r["name"])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _run(TS.sweep, tmp_path_factory.mktemp("port"), "port",
                device="cpu")


def test_sweep_matches_jax_sweep(cpu_ref, port_run):
    res, ckpt, beams, stats = port_run
    want_res, want_ckpt, want_beams, _ = cpu_ref
    assert res == want_res
    assert ckpt == want_ckpt
    assert [r["_bucket"] for r in ckpt] == [128] * 6
    assert _by_name(beams) == _by_name(want_beams)
    assert stats["n_fallback"] == 0 and stats["flag_causes"] == {}
    assert stats["buckets"]["128"]["n"] == 6
    assert stats["buckets"]["128"]["batch"] == 4


def test_sweep_refolds_flagged(cpu_ref, tmp_path, monkeypatch):
    """With R=2 slots the engine flags r_slots; those folds go to the CPU
    refold pool and the results still equal the CPU engine's."""
    real = TS.bucket_config
    monkeypatch.setattr(TS, "bucket_config", lambda *a: dataclasses.replace(
        real(*a), R=2))
    res, ckpt, beams, stats = _run(TS.sweep, tmp_path, "port", device="cpu")
    want_res, want_ckpt, want_beams, _ = cpu_ref
    assert stats["n_fallback"] > 0
    assert stats["flag_causes"].get("r_slots") == stats["n_fallback"]
    flagged = [r for r in beams if r["flagged"]]
    assert len(flagged) == stats["n_fallback"]
    assert all(r["flagged"] & FT.FLAG_RSLOTS for r in flagged)
    assert res == want_res
    assert ckpt == want_ckpt
    strip = lambda rows: _by_name([dict(r, flagged=0) for r in rows])
    assert strip(beams) == strip(want_beams)


def test_sweep_engine_cpu_matches_device_sweep(cpu_ref, port_run, tmp_path):
    """engine="cpu": the whole bucket on the port's fold_cpu through the
    pool, no engine built.  Result dicts, checkpoint and beams journal
    equal those of the port's device sweep (no row is flagged there) and
    of the JAX package's engine="cpu" sweep."""
    res, ckpt, beams, stats = _run(TS.sweep, tmp_path, "cpu", engine="cpu",
                                   device="no-such-device")
    dev_res, dev_ckpt, dev_beams, dev_stats = port_run
    assert dev_stats["n_fallback"] == 0
    assert res == dev_res == cpu_ref[0]
    assert ckpt == dev_ckpt == cpu_ref[1]
    assert _by_name(beams) == _by_name(dev_beams) == _by_name(cpu_ref[2])
    assert stats["n_fallback"] == 0 and stats["flag_causes"] == {}
    assert stats["refold_evaluator"] in ("native", "numpy")
    assert stats["buckets"] == {"128": dict(
        n=6, secs=stats["buckets"]["128"]["secs"], batch=4)}
    with pytest.raises(ValueError, match="engine"):
        TS.sweep(_records(1), engine="jax", device="cpu")


def test_sweep_cli_engine_flag(tmp_path):
    """--engine cpu through main(): the results CSV and the manifest."""
    src = tmp_path / "bench.csv"
    with open(src, "w", newline="") as fh:
        csv.writer(fh).writerows(_records(2))
    out = tmp_path / "res.csv"
    TS.main(["--csv", str(src), "--out", str(out), "--engine", "cpu",
             "--device", "no-such-device", "-n", "20", "-ms", "3",
             "--fallback-workers", "2"])
    lines = out.read_text().splitlines()
    assert lines[0].startswith("seq,len_seq,struct") and len(lines) == 3
    manifest = json.load(open(f"{out}.manifest.json"))
    assert manifest["argv"]["engine"] == "cpu" and manifest["n_records"] == 2
    assert manifest["n_fallback"] == 0


def _jax_bucket_config(N, nb_mode, max_stack, max_branch):
    # rafft_tpu/parallel/sweep.py:167-186, as the JAX sweep builds it
    return FJ.EngineConfig(N=N, K=max_stack, M=min(nb_mode, 2 * N - 1),
                           R=16 if N <= 512 else 32, max_branch=max_branch,
                           V=4096, W=8 if N <= 128 else 24,
                           CPLX=512 if N <= 128 else 1024,
                           S=max(16384, 32 * max_stack))


def _check_bucket_config(N, nb_mode, max_stack, max_branch):
    """Every field is the JAX sweep's but CPLX and, at 512, R, the kept
    differences: the JAX sweep's budget once per 50 beam rows begun, and
    region_slots' width."""
    want = dataclasses.asdict(_jax_bucket_config(N, nb_mode, max_stack,
                                                 max_branch))
    want["CPLX"] *= math.ceil(max_stack / 50)
    if N == 512:
        assert want["R"] == 16
        want["R"] = R512
    got = TS.bucket_config(N, nb_mode, max_stack, max_branch)
    assert dataclasses.asdict(got) == want
    assert TS.bucket_batch(16, N) == JS.bucket_batch(16, N) == {
        128: 16, 256: 16, 512: 8, 1024: 4, 2048: 2, 4096: 1}[N]
    # the engine takes the configuration (nothing is folded here)
    assert FT.FoldEngine(got, B=1, device="cpu").cfg is got


@pytest.mark.parametrize("N", [128, 256, 512, 1024, 2048, 4096])
def test_bucket_config_matches_jax_sweep(N):
    _check_bucket_config(N, 100, 50, 1000)
    assert TS.bucket_config(N, 100, 50, 1000).CPLX == \
        _jax_bucket_config(N, 100, 50, 1000).CPLX


@pytest.mark.parametrize("N", [128, 256, 512, 1024, 2048, 4096])
def test_bucket_config_k200_matches_jax_sweep(N):
    """-n 200 -ms 200, the reference's second published configuration:
    the JAX sweep's but a budget four times its own."""
    _check_bucket_config(N, 200, 200, 1000)
    assert TS.bucket_config(N, 200, 200, 1000).CPLX == 4 * (
        512 if N <= 128 else 1024)


@pytest.mark.parametrize("K", [1, 5, 20, 49, 50, 51, 100, 150, 200, 255])
def test_cplx_budget_rule(K):
    """K <= 50 keeps the JAX engine's budget, at every bucket and in
    fold_one's configuration; above, the budget grows by its base per
    50 beam rows begun (4x at K = 200)."""
    times = math.ceil(K / 50)
    assert FT.cplx_budget(512, K) == 512 * times
    for N in TS.DEFAULT_BUCKETS:
        base = _jax_bucket_config(N, 100, K, 1000).CPLX
        assert TS.bucket_config(N, 100, K, 1000).CPLX == base * times
    # the JAX fold_one's configuration leaves CPLX at its default, 512
    assert FJ.EngineConfig.CPLX == 512
    for n in (20, 60, 128, 300, 1000, 4000):
        cfg = FT.fold_one_config(n, 100, K, 1000)
        assert cfg.CPLX == 512 * times


@pytest.mark.parametrize("max_stack", [50, 200])
def test_region_slots_kept_difference(max_stack):
    """The 512 bucket takes R512 region slots where the JAX sweep has 16:
    the largest r_need of the corpus's 252 rows of 257-512 nt at -n 100
    -ms 50, measured on the card, fits in it.  Every other bucket keeps
    the JAX sweep's R, and the 128 and 256 buckets every field; fold_one
    takes the same width by its N."""
    assert [FT.region_slots(N) for N in TS.DEFAULT_BUCKETS] == \
        [16, 16, R512, 32, 32, 32]
    for N in TS.DEFAULT_BUCKETS:
        got = TS.bucket_config(N, 100, max_stack, 1000)
        want = _jax_bucket_config(N, 100, max_stack, 1000)
        assert got.R == FT.region_slots(N) == (R512 if N == 512 else want.R)
        if N <= 256:
            assert dataclasses.asdict(got) == dict(
                dataclasses.asdict(want), CPLX=want.CPLX * max_stack // 50)
    for n in (20, 64, 128, 200, 256, 257, 300, 509, 512, 513, 1000, 4096):
        cfg = FT.fold_one_config(n, 100, max_stack, 1000)
        assert cfg.R == FT.region_slots(cfg.N) == (
            R512 if 256 < n <= 512 else 16 if n <= 256 else 32), n


def test_the_measured_cells_configurations_are_unchanged():
    """The benchmark's two accepted configurations, field by field."""
    assert dataclasses.asdict(TS.bucket_config(128, 100, 50, 1000)) == dict(
        N=128, K=50, R=16, M=100, V=4096, W=8, CPLX=512, S=16384,
        max_steps=24, max_branch=1000, min_hp=3, min_nrj=0.0, temp=37.0,
        gc_wei=3.0, au_wei=2.0, gu_wei=1.0)
    for n in (65, 100, 128):
        assert dataclasses.asdict(FT.fold_one_config(n, 100, 20, 1000)) == \
            dict(N=128, K=20, R=16, M=100, V=2000, W=8, CPLX=512, S=4096,
                 max_steps=24, max_branch=1000, min_hp=3, min_nrj=0.0,
                 temp=37.0, gc_wei=3.0, au_wei=2.0, gu_wei=1.0)


def test_long_buckets_refused():
    """The 2048/4096 buckets were refused before they were ported; the
    same calls now give the JAX sweep's configuration and fold."""
    assert TS.DEFAULT_BUCKETS == JS.DEFAULT_BUCKETS
    cfg = TS.bucket_config(2048, 100, 50, 1000)
    assert (cfg.N, cfg.R, cfg.W, cfg.CPLX, cfg.M) == (2048, 32, 24, 1024, 100)
    res = TS.sweep(_records(1), buckets=(128, 2048), device="cpu", **ARGS)
    assert res[0]["struct"].count("(") > 0


@pytest.mark.parametrize("n", [1025, 4096])
def test_long_records_refused(n):
    """A record of 1025 to 4096 nt was refused before the 2048/4096
    buckets were ported; now it lands in its bucket and is folded (here
    by the CPU parity engine: the batched engine takes minutes on the CPU
    at N >= 2048, see tests/test_torch_long2048.py)."""
    seq = "GGGGAAAACCCC" * (n // 12) + "A" * (n % 12)
    seen = []
    res = TS.sweep([(seq, "." * n, "long")], nb_mode=5, max_stack=1,
                   max_branch=10, workers=1, engine="cpu",
                   device="no-such-device",
                   progress=lambda N, *a, **kw: seen.append(N))
    assert set(seen) == {2048 if n == 1025 else 4096}
    assert res[0]["len_seq"] == n and res[0]["nbp"] > 0 and res[0]["nrj"] < 0


def test_records_past_jax_buckets_skipped(tmp_path):
    """Past 4096 nt the JAX sweep skips a record; so does the port."""
    recs = [("GC" * 2049, ".", "huge")]
    beams = tmp_path / "beams.jsonl"
    assert TS.sweep(recs, save_beams=str(beams), device="cpu") == [None]
    assert not beams.exists()
