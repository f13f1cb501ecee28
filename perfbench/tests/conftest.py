"""Fixtures of the harness's own tests: a temporary copy of the
benchmark (BENCHMARK.json and perfbench/) into which two small cells are
dropped, as a later change would add them, without editing any file the
copy already has.  Their runs fold on the CPU, at a size a test can hold.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(nb_mode=20, max_stack=2, max_branch=100, min_hp=3, min_nrj=0.0,
            temp=37.0, gc_wei=3.0, au_wei=2.0, gu_wei=1.0)
TINY_CELLS = {
    "tiny-stream": ({"driver": "stream", "band": [33, 64], "bucket": 64,
                     "batch": 4, "rounds_per_replay": 4, "strata": 4,
                     "draw_per_second": 100, "warmup": 4, "trace_after_s": 0.0,
                     "trace_replays": 2, "check_sample": 6,
                     "control_answers": 12,
                     "limits": {"mismatched_answers": 0}},
                    dict(TINY, traj=False), ("seq_per_s",)),
    "tiny-api": ({"driver": "fold_api", "band": [33, 64], "strata": 4,
                  "draw_per_second": 10, "warmup": 1, "trace_after_s": 0.0,
                  "trace_calls": 1, "check_sample": None,
                  "control_answers": 6,
                  "limits": {"mismatched_answers": 0, "refolded_calls": 0}},
                 dict(TINY, traj=True), ("fold_p50_ms",)),
}
DROPPED_METRIC = "tiny_folds_traced"
WORKERS = 2                 # the reference's processes in a test's check


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if "__pycache__" not in d)


def drop_tiny_cells(root):
    """Add the tiny cells to the benchmark copy at `root`: new files, and
    new entries in its BENCHMARK.json."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        spec = json.load(fh)
    for name, (wl, settings, _) in TINY_CELLS.items():
        config = "cfg-" + name
        with open(os.path.join(root, "perfbench", "configs",
                               f"{config}.json"), "w") as fh:
            json.dump({"name": config, "settings": settings}, fh)
        with open(os.path.join(root, "perfbench", "workloads",
                               f"{name}.json"), "w") as fh:
            json.dump(dict(wl, config=config), fh)
        spec["configs"].append({"name": config, "source": "test",
                                "file": f"perfbench/configs/{config}.json",
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": name, "chips": 1, "why": "test"})
    # and one per-layer metric, with a reader of its own
    with open(os.path.join(root, "perfbench", "metrics",
                           f"{DROPPED_METRIC}.py"), "w") as fh:
        fh.write("def read(ctx):\n    return ctx.get('folds')\n")
    spec["per_layer"].append({"name": DROPPED_METRIC, "unit": "folds",
                              "better": "higher", "source": "program_counter",
                              "layer": "stream driver", "moves": "seq_per_s",
                              "workloads": ["tiny-stream"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        moves = m.get("moves", m["name"])
        for name, (_, _, cell_moves) in TINY_CELLS.items():
            if "workloads" in m and moves in cell_moves:
                m["workloads"].append(name)
    with open(path, "w") as fh:
        json.dump(spec, fh)


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory):
    """(root of a copy of the benchmark with the tiny cells dropped in,
    the copy's files before the drop)."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {f: open(os.path.join(root, "perfbench", f), "rb").read()
              for f in tree_files(os.path.join(root, "perfbench"))}
    drop_tiny_cells(root)
    return root, before


@pytest.fixture(scope="session")
def tiny_bench(bench_copy):
    from perfbench import core
    return core.Bench(bench_copy[0])


def run_tiny(bench, cell, seconds, trace=False, seed=2**33 + 5):
    from perfbench import core
    return core.run_cell(cell, seed, seconds, trace, device="cpu",
                         bench=bench, workers=WORKERS)
