"""The port's one-core CPU baseline (counterpart of tools/measure_baseline.py).

The reference publishes no runtime, so the yardstick of tools/bench.py's
vs_baseline is the port's sequential CPU parity engine
(engine/fold_cpu.py: the reference's beam loop with the native Turner
evaluator, or numpy where g++ is missing) at -n 100 -ms 50
--max_branch 1000, pinned to one core, over a deterministic stride of the
corpus sequences of at most 120 nt (the headline population).

    python -m rafft_tpu_torch.tools.measure_baseline [N_SAMPLE] [--out PATH]

N_SAMPLE defaults to 64, PATH to rafft_tpu_torch/testdata/baseline_cpu.json.
The artifact has the JAX package's keys (seqs_per_s, n_seqs, wall_s,
config, population, engine) plus the host's CPU model (`cpu`) and the
evaluator that ran (`evaluator`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import time

from rafft_tpu_torch.engine import fold_cpu
from rafft_tpu_torch.tools.bench import BASELINE
from rafft_tpu_torch.tools.corpus import HEADLINE_MAX_NT, corpus


def cpu_model():
    """The host CPU's model name from /proc/cpuinfo; where the host hides
    it ("unknown", as some virtualised hosts say), its vendor, family,
    model number and clock; else platform's word."""
    info = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as fh:
        for line in fh:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    if "model" in info:
        return (f"{info.get('vendor_id')} family {info.get('cpu family')} "
                f"model {info['model']}, {info.get('cpu MHz')} MHz (the host "
                f"gives no model name)")
    return platform.processor() or platform.machine()


@contextlib.contextmanager
def one_core():
    """Pin this process to one of its cores, and restore its set after."""
    if not hasattr(os, "sched_setaffinity"):
        yield
        return
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {min(cores)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cores)


def sample(n_sample):
    """Every len // n_sample-th corpus sequence of at most 120 nt, the
    first n_sample of them (tools/measure_baseline.py:28-35)."""
    seqs = [s for s, _row in corpus() if len(s) <= HEADLINE_MAX_NT]
    return seqs[::max(1, len(seqs) // n_sample)][:n_sample]


def measure(n_sample=64):
    seqs = sample(n_sample)
    with one_core():
        t0 = time.perf_counter()
        for s in seqs:
            fold_cpu.fold(s, nb_mode=100, max_stack=50, max_branch=1000)
        wall = time.perf_counter() - t0
    return dict(seqs_per_s=len(seqs) / wall, n_seqs=len(seqs), wall_s=wall,
                config="-n 100 -ms 50 --max_branch 1000",
                population="corpus <=120 nt (the bench's headline population)",
                engine="rafft_tpu_torch.engine.fold_cpu (sequential, 1 core)",
                evaluator=fold_cpu.EVALUATOR, cpu=cpu_model())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_sample", nargs="?", type=int, default=64)
    ap.add_argument("--out", default=BASELINE)
    args = ap.parse_args(argv)
    art = measure(args.n_sample)
    with open(args.out, "w") as fh:
        json.dump(art, fh, indent=1)
        fh.write("\n")
    print(json.dumps(art))


if __name__ == "__main__":
    main()
