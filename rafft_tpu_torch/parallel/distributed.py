"""Multi-process runtime (rafft_tpu/parallel/distributed.py).

Every process runs the same sweep; `init_multihost` joins them into one
`torch.distributed` process group, and each process folds its strided
share of the corpus (`shard_records`) on its own devices.  The fold
itself needs no communication between processes (SURVEY.md section
2.3): the only collective is the metric reduction at the end
(`global_mean`), a handful of CPU scalars, so the group uses the gloo
backend, which needs no NCCL and runs wherever PyTorch does.

Usage (one line per process, or via parallel/launch.py on one machine):

    python -m rafft_tpu_torch.parallel.sweep --csv ... --out out.csv \
        --coordinator HOST0:9911 --num_processes 4 --process_id $ID

Each process writes `<out>.part<process_id>` ending in a `#done` line;
process 0 waits for every part (`merge_parts`, on a shared filesystem,
the reference's CSV aggregation) and writes the merged CSV.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist


def _device(x) -> torch.device:
    return torch.device(f"cuda:{x}" if isinstance(x, int) else x)


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   local_device_ids=None):
    """Join this process to the group of `num_processes` processes.

    coordinator: 'host:port' where process 0 listens.  local_device_ids:
    the devices this process folds on, card indices (cuda:i) or device
    names ('cpu', 'cuda:1'); by default every visible card, or the CPU in
    a process that sees none.  Returns (process_index, process_count,
    local_devices, global_devices), the device lists as torch.device;
    the global list is every process's local list in process order.
    Raises if the group cannot be formed."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    if local_device_ids is None:
        count = torch.cuda.device_count()
        local_device_ids = list(range(count)) if count else ["cpu"]
    local = [_device(x) for x in local_device_ids]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in local])
    return (dist.get_rank(), dist.get_world_size(), local,
            [torch.device(d) for part in gathered for d in part])


def shutdown():
    """Leave the process group (every process, once its collectives are
    done), so that the processes exit cleanly."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_records(records, process_id: int, num_processes: int):
    """This process's slice of the corpus (strided so length buckets
    stay balanced across processes)."""
    return list(records)[process_id::num_processes]


def global_mean(value: float, count: int = 1):
    """Mean of a per-process scalar over all processes, each weighted by
    its count: an all-reduce of [value * count, count] in float64."""
    t = torch.tensor([value * count, count], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0] / max(t[1].item(), 1))


class PartTimeout(RuntimeError):
    """A process's part file never completed within the merge deadline."""


def merge_parts(out_path: str, num_processes: int, header: str,
                timeout_s: float = 120.0, poll_s: float = 0.5):
    """Process-0 merge of the per-process part files (shared filesystem,
    the reference's aggregation model).

    All parts are awaited against ONE shared deadline; a process that
    died raises PartTimeout naming every missing and unfinished part, so
    the failure is a diagnosis, not a hang.  Processes finish within
    seconds of each other in practice (strided corpus shard), so the
    default deadline covers filesystem lag, not compute skew: pass a
    larger timeout_s if processes start at very different times.
    """
    def complete(part):
        try:
            with open(part) as fh:
                fh.seek(max(os.path.getsize(part) - 16, 0))
                return fh.read().endswith("#done\n")
        except OSError:
            return False

    parts = [f"{out_path}.part{p}" for p in range(num_processes)]
    deadline = time.monotonic() + timeout_s
    pending = set(parts)
    while pending:
        pending = {p for p in pending if not complete(p)}
        if not pending:
            break
        if time.monotonic() >= deadline:
            missing = [p for p in sorted(pending) if not os.path.exists(p)]
            partial = sorted(pending - set(missing))
            raise PartTimeout(
                f"merge_parts: {len(pending)}/{num_processes} part files "
                f"incomplete after {timeout_s:.0f}s — "
                f"missing: {missing or 'none'}; "
                f"unfinished (no #done trailer): {partial or 'none'}. "
                f"The owning host(s) likely died; re-run those shards or "
                f"raise timeout_s.")
        time.sleep(poll_s)

    rows = []
    for part in parts:
        with open(part) as fh:
            for line in fh:
                if (line.startswith("#") or line == header
                        or not line.strip()):
                    continue
                rows.append(line)
    with open(out_path, "w") as fh:
        fh.write(header)
        fh.writelines(rows)
    return len(rows)
