"""The port's multi-process runtime: localhost gloo processes on the CPU.

Two processes join one process group (rafft_tpu_torch.parallel.
distributed), as tests/test_multihost.py does for the JAX runtime; then
the port's launcher and the JAX package's each run a two-process sweep
of the same CSV with the CPU parity engine, and the merged CSVs and the
printed global means must be equal.  Every wait has its own timeout: a
process group that never forms fails the test, not the suite.
"""

import csv
import gzip
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rafft_tpu_torch.parallel.launch import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOURNAL = os.path.join(ROOT, "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
TIMEOUT_S = 240

WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, %r)
    import torch
    from rafft_tpu_torch.parallel.distributed import (global_mean,
        init_multihost, shard_records, shutdown)
    coord, pid = sys.argv[1], int(sys.argv[2])
    p, n, ld, gd = init_multihost(coord, 2, pid, ["cpu"])
    assert (p, n) == (pid, 2), (p, n)
    assert ld == [torch.device("cpu")] and len(gd) == 2 * len(ld), (ld, gd)
    recs = shard_records(list(range(10)), p, n)
    assert recs == list(range(p, 10, 2)), recs
    # per-process means 1.0 / 3.0 with counts 1 / 3 -> global 2.5
    m = global_mean(1.0 if p == 0 else 3.0, 1 if p == 0 else 3)
    assert abs(m - 2.5) < 1e-12, m
    shutdown()
    print("OK", p, flush=True)
""" % ROOT)


def _wait(procs, what):
    """(returncode, stdout, stderr) of each process; kills every process
    group and fails the test past TIMEOUT_S."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
                q.communicate()
            pytest.fail(f"{what} did not finish in {TIMEOUT_S} s: the process "
                        "group never formed or a process hung")
        outs.append((p.returncode, out, err))
    return outs


def _start(cmd, env=None):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


def test_two_process_runtime(tmp_path):
    coord = f"127.0.0.1:{free_port()}"
    w = tmp_path / "worker.py"
    w.write_text(WORKER)
    procs = [_start([sys.executable, str(w), coord, str(pid)])
             for pid in range(2)]
    for rc, out, err in _wait(procs, "the two-process runtime"):
        assert rc == 0, (rc, out[-500:], err[-2000:])
        assert out.startswith("OK")


def test_launch_matches_jax_launch(tmp_path):
    """launch(2, ..., device="cpu") of the port's sweep and the JAX
    package's launch(2, ..., backend="cpu") on a 4-row CSV with the CPU
    parity engine: byte-equal merged CSVs (part 0's rows, then part 1's)
    and the same global means."""
    src = tmp_path / "bench.csv"
    with open(src, "w", newline="") as fh:
        rows = []
        for line in gzip.open(JOURNAL, "rt"):
            r = json.loads(line)
            rows.append((r["seq"], r["beam"][0][0], r["name"]))
            if len(rows) == 4:
                break
        csv.writer(fh).writerows(rows)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)      # no virtual-device split in processes
    args = ["--csv", str(src), "-n", "20", "-ms", "3", "--engine", "cpu",
            "--fallback-workers", "1"]
    jax_out, port_out = tmp_path / "jax.csv", tmp_path / "port.csv"
    procs = [
        _start([sys.executable, "-m", "rafft_tpu.parallel.launch",
                "--num_processes", "2", "--backend", "cpu", "--",
                "--out", str(jax_out), *args], env),
        _start([sys.executable, "-m", "rafft_tpu_torch.parallel.launch",
                "--num_processes", "2", "--device", "cpu", "--",
                "--out", str(port_out), *args], env)]
    (jrc, jout, jerr), (prc, pout, perr) = _wait(procs, "the launches")
    assert jrc == 0, jerr[-2000:]
    assert prc == 0, perr[-2000:]
    merged = port_out.read_text()
    assert merged == jax_out.read_text()
    lines = merged.splitlines()
    assert len(lines) == 5
    assert [ln.split(",")[-1] for ln in lines[1:]] == [
        rows[0][2], rows[2][2], rows[1][2], rows[3][2]]
    # the global means are those of the merged rows, as one process
    # prints them: the port reduces in float64; the JAX all-gather runs
    # in float32 (x64 is off) and may differ in the last printed digit
    ppv, sens = (np.mean([float(ln.split(",")[c]) for ln in lines[1:]])
                 for c in (5, 6))
    summary = [ln for ln in pout.splitlines() if "merged" in ln]
    assert summary == [f"4 sequences merged; global mean PPV {ppv:.2f} "
                       f"mean sens {sens:.2f}"]
    jax_summary = [ln for ln in jout.splitlines() if "merged" in ln]
    jax_means = [float(x) for x in jax_summary[0].split()[6::3]]
    assert np.allclose(jax_means, [ppv, sens], atol=0.01), jax_summary
    assert "[multihost] process 1/2: 1 local / 2 global devices" in pout
