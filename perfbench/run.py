"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (rafft_tpu_torch) on a
machine with an NVIDIA card.  With --trace 0 the line holds the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from a
profiled slice of the window and from host spans.  Progress and every
compared number beside its limit go to standard error; the last line of
standard output is the result, one JSON object.  Without a card, or with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, the run prints no result and exits non-zero.
"""

import os
import sys
import time


def _process_age():
    """Seconds since this process started (Linux)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


T_START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench",
                                              "triton")
# one process with few threads: the program's host work is Python and
# small NumPy calls, and idle pool threads only add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
FORBIDDEN = ("jax", "jaxlib", "flax", "rafft_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import core
    torch.set_num_threads(1)
    bench = core.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no run falls back to the CPU)", file=sys.stderr)
        return 2
    tag = f"[perfbench {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}]"

    def log(msg):
        print(f"{tag} {msg}", file=sys.stderr, flush=True)

    result, compared = core.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), bench=bench,
                                     t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log("JAX or the JAX package was loaded: " + ", ".join(found))
        return 3
    for name, (value, limit) in compared.items():
        log(f"check {name}: {value} (limit {limit})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
