"""Start a multi-process sweep on this machine (rafft_tpu/parallel/launch.py).

Spawns N processes, each a member of one gloo process group, and runs
the sweep CLI in every one with its --process_id and its --device.  On
several machines each runs the same sweep command with its own
--process_id; this launcher is the one-machine form.

    python -m rafft_tpu_torch.parallel.launch --num_processes 2 \
        [--device cuda|cpu] -- --csv bench.csv --out out.csv -n 100 -ms 50

--device cuda gives process p the card p % (visible cards): on one card
every process shares cuda:0.  Any other device name is passed to every
process as it is.  The sweep refuses --devices beside that --device, so
a launched process folds on its one device.  If a process fails, the
others are stopped.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(num_processes: int, sweep_args, device: str = "cuda"):
    """Run the sweep in num_processes processes; returns the largest exit
    code.  A process that exits nonzero stops the others, which would
    otherwise wait for it in the process group."""
    coord = f"127.0.0.1:{free_port()}"
    count = torch.cuda.device_count() if device == "cuda" else 0
    devs = [f"cuda:{p % count}" if count else device
            for p in range(num_processes)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rafft_tpu_torch.parallel.sweep",
         "--coordinator", coord, "--num_processes", str(num_processes),
         "--process_id", str(pid), "--device", dev, *sweep_args], env=env)
        for pid, dev in enumerate(devs)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return max(p.returncode for p in procs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (process p on card p %% count) or a device "
                         "name every process folds on, such as cpu")
    ap.add_argument("sweep_args", nargs=argparse.REMAINDER,
                    help="arguments after -- go to the sweep CLI")
    args = ap.parse_args(argv)
    sweep_args = args.sweep_args
    if sweep_args and sweep_args[0] == "--":
        sweep_args = sweep_args[1:]
    raise SystemExit(launch(args.num_processes, sweep_args, args.device))


if __name__ == "__main__":
    main()
