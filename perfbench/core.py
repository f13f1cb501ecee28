"""The harness: one run of one cell, driven by data.

Everything that belongs to one cell is found by name:

- BENCHMARK.json (the checkout's root) gives the cell's configuration,
  its end-to-end metrics and its per-layer metrics;
- perfbench/workloads/<cell>.json its traffic (the length band, the draw,
  the batch, the window's trace slice, the check's sample and limits)
  and its entry driver;
- perfbench/drivers/<driver>.py drives the program's entry;
- the configuration's file (perfbench/configs/<config>.json) its
  settings, which the program and the reference both take;
- perfbench/metrics/<metric>.py reads one per-layer metric from what a
  traced run gathered.

A run: set up (import the program, build the engine, warm up every shape
the traffic uses), measure for `seconds`, read the device's peak memory,
free the program's state, then fold a sample of the answers again with
the plain reference and compare (perfbench/check.py).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import time

from perfbench import check, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Bench:
    """BENCHMARK.json and the files it names, under the checkout `root`."""

    def __init__(self, root=ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name):
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(cells: {sorted(cells)})")
        return cells[name]

    def workload(self, name):
        return load_json(os.path.join(self.root, "perfbench", "workloads",
                                      f"{name}.json"))

    def settings(self, config):
        files = {c["name"]: c["file"] for c in self.spec["configs"]}
        return load_json(os.path.join(self.root, files[config]))["settings"]

    def end_to_end(self, cell):
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def _module(self, kind, name):
        path = os.path.join(self.root, "perfbench", kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench.{kind}._" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric):
        """read(ctx) of perfbench/metrics/<metric>.py."""
        return self._module("metrics", metric).read

    def driver(self, name):
        """The module perfbench/drivers/<name>.py."""
        return self._module("drivers", name)


def draw(workload, seed, seconds):
    """The cell's sequences for `seed`: enough for `seconds` of window."""
    seqs = traffic.band(*workload["band"])
    count = math.ceil(workload["draw_per_second"] * seconds)
    return traffic.draw(seqs, count, workload["strata"], seed)


def run_cell(name, seed, seconds, trace, *, device="cuda", bench=None,
             t_start=None, log=None, workers=None):
    """One run of cell `name`.  Returns (result line as a dict, the
    compared numbers as {name: (value, limit)}).  `t_start` is the
    process's start on the perf_counter clock (set-up is counted from
    it); `log(msg)` reports progress; `workers` is the reference's
    process count (default: one a core)."""
    import torch

    from perfbench import trace as tr
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: None)
    cuda = torch.device(device).type == "cuda"
    bench = bench or Bench()
    spec = bench.cell(name)
    wl = bench.workload(name)
    settings = bench.settings(spec["config"])
    seqs = draw(wl, seed, seconds)
    spans = tr.Spans() if trace else None
    slice_ = tr.Slice(device) if trace else None

    drv = bench.driver(wl["driver"])
    cell = drv.Cell(settings, wl, device, spans)
    cell.warm(traffic.band(*wl["band"])[: wl["warmup"]])
    if trace:
        slice_.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set up in {setup_s:.3f} s; the window opens ({seconds} s)")
    win = cell.window(seqs, seconds, slice_)
    cell.close()
    del cell
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"window closed: {win.attempted} answers in {win.wall_s:.3f} s; "
        "the reference folds the check's sample")
    if win.wall_s < seconds:
        log(f"the draw of {len(seqs)} sequences ran out before {seconds} s: "
            "raise the workload's draw_per_second")
    stats = win.readings.get("slice")
    if stats is not None:
        log(f"traced slice: {stats.window_s:.3f} s, busy {stats.busy_s:.3f} s, "
            f"{stats.kernels} kernels ({stats.graph_kernels} from graphs)")

    # the check: a sample of the answers, every failed one in it, against
    # the plain reference
    answered = win.answered
    pick = traffic.check_sample(len(answered), wl["check_sample"],
                                check.lengths([s for s, _ in answered]), seed,
                                always=win.failed_at)
    sample = [answered[i] for i in pick]
    t_ref = time.perf_counter()
    expected = check.reference_answers([s for s, _ in sample], settings,
                                       drv.answer_form(settings),
                                       workers=workers)
    got = [a for _, a in sample]
    numbers = {"mismatched_answers": check.mismatches(got, expected),
               "refolded_calls": win.readings.get("refolded_calls")}
    compared = {k: (numbers[k], limit) for k, limit in wl["limits"].items()}
    # a window that answered nothing has no answer to judge: not correct
    correct = win.attempted > 0 and all(
        v is not None and v <= lim for v, lim in compared.values())
    log(f"reference: {len(sample)} answers in "
        f"{time.perf_counter() - t_ref:.3f} s")
    if not correct:
        log("first difference: " + str(check.first_mismatch(
            [s for s, _ in sample], got, expected)))

    e2e = dict(win.metrics, setup_s=(setup_s, "s"),
               peak_mem_mib=(win.peak_bytes / MIB, "MiB"))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec["chips"], "memory_peak_bytes": int(win.peak_bytes)}
    if trace:
        metrics = {}
        for m in bench.per_layer(name):
            value = bench.reader(m["name"])(win.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if stats is not None:
            dev.update(busy_s=stats.busy_s, window_s=stats.window_s)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": e2e[m["name"]][1]}
                   for m in bench.end_to_end(name)}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if stats is not None:
        result["breakdown"] = {"device_ops": stats.device_ops,
                               "idle_gaps": stats.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    return result, compared
