"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits nonzero and prints no
result line):
  1. device  - a CUDA card is present; print its name and power limit;
  2. build   - nvcc-build the wavefront kernel from csrc/ (timed);
  3. kernel  - at the N=128 headline shapes (16 x 50 beam rows, R=16),
               all seven kernel tables equal the plain PyTorch version
               on seeded random and degenerate layouts; time both;
  4. fold_one - the README sequence at max_stack 5 and 20 gives the same
               trajectory and final beam as the sequential CPU oracle;
  5. headline - FoldEngine at N=128, K=50, M=100, R=16, V=4096, W=8,
               CPLX=512, S=16384, max_branch=1000, B=16: run_stream over
               the first 64 journal rows of <= 120 nt must reproduce the
               committed beams exactly with flag 0, through the kernel.
The last two lines are the kernel summary and the device record.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The port runs without JAX.  fold_cpu's optional native oracle would
# import it; blocking the import makes fold_cpu use its numpy evaluator.
sys.modules.setdefault("jax", None)

from rafft_tpu.engine.fold_cpu import fold as cpu_fold  # noqa: E402
from rafft_tpu_torch import _build  # noqa: E402
from rafft_tpu_torch.energy.eval_torch import device_params  # noqa: E402
from rafft_tpu_torch.engine import wavefront as WT  # noqa: E402
from rafft_tpu_torch.engine.fold_torch import (EngineConfig,  # noqa: E402
                                               FoldEngine, fold_one)
from rafft_tpu.scan.encode import weight_matrix  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
JOURNAL = os.path.join(ROOT, "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
README_SEQ = ("GGGUUUGCGGUGUAAGUGCAGCCCGUCUUACACCGUGCGGCACAGGCACUAGUACUGAUGU"
              "CGUAUACAGGGCUUUUGACAU")
HEADLINE = EngineConfig(N=128, K=50, M=100, R=16, V=4096, W=8, CPLX=512,
                        S=16384, max_branch=1000)
B = 16


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    lib = _build.build("wavefront")
    secs = time.perf_counter() - t0
    _, out = _build.BUILD_LOG.get("wavefront", (0.0, "(cached)"))
    log(f"[build] {lib.name} in {secs:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    return secs


def _layouts(rng, rows, R, N):
    """Engine-valid region layouts: each beam row's unpaired positions of
    a random sequence split into up to R ascending regions."""
    rpos = np.full((rows, R, N), N, np.int32)
    rcodes = np.zeros((rows, R, N), np.int32)
    mlen = np.zeros((rows, R), np.int32)
    for b in range(rows):
        n = int(rng.integers(60, 121))
        codes = rng.integers(1, 5, size=n)
        keep = np.nonzero(rng.random(n) < rng.uniform(0.2, 1.0))[0]
        nreg = int(rng.integers(1, R + 1))
        slot = rng.integers(0, nreg, size=len(keep))
        if b % 50 == 0:               # the step-0 layout: one whole region
            keep, slot = np.arange(n), np.zeros(n, np.int64)
        for r in range(nreg):
            pos = keep[slot == r]
            rpos[b, r, : len(pos)] = pos
            rcodes[b, r, : len(pos)] = codes[pos]
            mlen[b, r] = len(pos)
    # degenerate rows: beam row 1 has only empty regions, row 2 a
    # single-position region
    rpos[1], rcodes[1], mlen[1] = N, 0, 0
    rpos[2, 0, 0], rcodes[2, 0, 0], mlen[2, 0] = 5, 2, 1
    return rcodes, rpos, mlen


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernel():
    cfg, dev = HEADLINE, torch.device("cuda")
    dp = device_params(cfg.temp, cfg.N, dev)
    W = weight_matrix(cfg.gc_wei, cfg.au_wei, cfg.gu_wei)
    z1, z2 = np.random.default_rng(0xA5F7).integers(
        1, 2**32 - 1, (2, cfg.N + 1), dtype=np.uint64).astype(np.uint32).view(np.int32)
    max_err = 0.0
    for seed in (0, 1):
        rc, rp, ml = _layouts(np.random.default_rng(seed), B * cfg.K, cfg.R, cfg.N)
        rpc = np.clip(rp, 0, cfg.N)
        shape = (B, cfg.K)
        args = [torch.as_tensor(x.reshape(shape + x.shape[1:]), device=dev)
                for x in (rc, rp, ml, z1[rpc], z2[rpc])]
        want = WT.wavefront_tables_ref(cfg, dp, W, *args)
        got = WT.wavefront_tables(cfg, dp, W, *args)
        torch.cuda.synchronize()
        for k in WT.KEYS:
            if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
                bad = (got[k] != want[k]).nonzero()[:5].tolist()
                raise AssertionError(f"kernel table {k} differs (seed {seed}) "
                                     f"at {bad}")
            err = (got[k].double() - want[k].double()).abs().max().item()
            max_err = max(max_err, err)
        log(f"[kernel] seed {seed}: 7/7 tables equal over {tuple(got['cor_raw'].shape)}")
    ms = _event_ms(lambda: WT.wavefront_tables(cfg, dp, W, *args), 50)
    plain_ms = _event_ms(lambda: WT.wavefront_tables_ref(cfg, dp, W, *args), 5)
    log(f"[kernel] wavefront {ms:.4f} ms/call, plain torch {plain_ms:.4f} ms/call "
        f"(tolerance: exact; max abs err {max_err})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _rows(structs):
    return [(s.str_struct, s.energy) for s in structs]


def phase_fold_one():
    for ms in (5, 20):
        t0 = time.perf_counter()
        res, traj = fold_one(README_SEQ, nb_mode=100, max_stack=ms,
                             max_branch=1000, traj=True, device="cuda")
        t1 = time.perf_counter()
        ref, rtraj = cpu_fold(README_SEQ, 100, ms, 1000, 3, 0.0, True, 37.0,
                              3.0, 2.0, 1.0)
        got = [_rows(s) for s in traj] + [_rows(res)]
        want = [_rows(s) for s in rtraj] + [_rows(ref)]
        if got != want:
            raise AssertionError(f"fold_one ms={ms} differs from fold_cpu")
        log(f"[fold_one] ms={ms}: {len(traj)} steps + final beam equal "
            f"fold_cpu ({t1 - t0:.2f} s on the card)")


def phase_headline():
    rows = []
    for line in gzip.open(JOURNAL, "rt"):
        r = json.loads(line)
        if len(r["seq"]) <= 120:
            rows.append(r)
        if len(rows) == 64:
            break
    seqs = [r["seq"] for r in rows]
    eng = FoldEngine(HEADLINE, B=B, device="cuda")
    for _ in eng.run_stream(seqs[:16]):
        pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    WT.LAUNCHES = 0
    t0 = time.perf_counter()
    out = list(eng.run_stream(seqs))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = WT.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    bad = []
    for idx, beam, flag in out:
        want = [(db, float(e)) for db, e in rows[idx]["beam"]]
        if flag != 0 or beam != want:
            bad.append((idx, flag))
    if len(out) != len(seqs) or sorted(i for i, _, _ in out) != list(range(len(seqs))):
        raise AssertionError("run_stream did not yield every sequence once")
    if bad:
        raise AssertionError(f"{len(bad)}/{len(seqs)} beams differ from the "
                             f"journal (index, flag): {bad[:8]}")
    if launches == 0:
        raise AssertionError("the headline run never launched the kernel")
    log(f"[headline] {len(out)}/{len(seqs)} beams equal the journal, flag 0; "
        f"{len(out) / secs:.3f} seq/s ({secs:.2f} s); peak "
        f"{peak / 2**20:.1f} MiB; wavefront launches {launches}")
    return launches


def main():
    smi = phase_device()
    phase_build()
    kern = phase_kernel()
    phase_fold_one()
    launches = phase_headline()
    log(json.dumps({"kernels": [dict(
        name="wavefront", route="cuda",
        source="rafft_tpu_torch/csrc/wavefront.cu",
        replaces="rafft_tpu/engine/wavefront.py:44", launches=launches,
        **kern)]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
