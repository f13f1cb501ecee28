"""The harness finds what belongs to a cell by name, draws its traffic
from the seed, prints the line the contract asks for, refuses to run
without a card, and loads nothing of JAX."""

import ast
import json
import os
import subprocess
import sys

import pytest
from conftest import DROPPED_METRIC, ROOT, TINY_CELLS, run_tiny, tree_files

from perfbench import core, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "rafft_tpu"}
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_cells_configs_drivers_and_readers_are_found_by_name():
    bench = core.Bench()
    for cell in bench.spec["workloads"]:
        wl = bench.workload(cell["name"])
        assert wl["config"] == cell["config"]
        settings = bench.settings(cell["config"])
        drv = bench.driver(wl["driver"])
        assert drv.answer_form(settings) in ("rows", "structures",
                                             "trajectory")
        assert hasattr(drv, "Cell")
        assert bench.end_to_end(cell["name"])
        for m in bench.per_layer(cell["name"]):
            assert callable(bench.reader(m["name"]))
    for config in bench.spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, config["file"]))


def test_dropped_in_cells_and_metric_are_picked_up(bench_copy, tiny_bench):
    root, before = bench_copy
    after = tree_files(os.path.join(root, "perfbench"))
    for f, data in before.items():        # no file the copy had was edited
        with open(os.path.join(root, "perfbench", f), "rb") as fh:
            assert fh.read() == data, f
    assert set(after) - set(before) == {
        f"configs/cfg-{c}.json" for c in TINY_CELLS} | {
        f"workloads/{c}.json" for c in TINY_CELLS} | {
        f"metrics/{DROPPED_METRIC}.py"}
    assert [m["name"] for m in tiny_bench.per_layer("tiny-stream")][-1] \
        == DROPPED_METRIC
    assert tiny_bench.reader(DROPPED_METRIC)({"folds": 7}) == 7
    assert {m["name"] for m in tiny_bench.end_to_end("tiny-api")} == {
        "fold_p50_ms", "peak_mem_mib", "setup_s"}


@pytest.mark.parametrize("cell", ["n100ms50-b128", "ms20traj-api"])
def test_a_seed_repeats_its_draw_and_another_changes_it(cell):
    wl = core.Bench().workload(cell)
    big = 2**31 + 12345
    a, b = core.draw(wl, big, 45), core.draw(wl, big, 45)
    assert a == b
    assert core.draw(wl, big + 1, 45) != a
    assert core.draw(wl, -big, 45) != a
    # the draw of a shorter window is the start of a longer one's
    assert core.draw(wl, big, 10) == a[: len(core.draw(wl, big, 10))]
    # every cycle takes one row of every length stratum
    band = traffic.band(*wl["band"])
    order = sorted(range(len(band)), key=lambda i: (len(band[i]), i))
    import numpy as np
    groups = np.array_split(np.asarray(order), wl["strata"])
    edges = [len(band[g[0]]) for g in groups] + [wl["band"][1]]
    cycle = sorted(len(s) for s in a[: wl["strata"]])
    assert all(lo <= n <= hi for n, lo, hi in zip(cycle, edges, edges[1:]))
    assert all(wl["band"][0] <= len(s) <= wl["band"][1] for s in a)


def test_the_check_sample_holds_the_longest_and_the_failed_answers():
    import numpy as np
    lengths = np.array([70, 90, 128, 80] * 50)
    seed = 2**31 + 77
    a = traffic.check_sample(200, 10, lengths, seed)
    assert a == traffic.check_sample(200, 10, lengths, seed)
    assert 2 in a and len(a) <= 11
    failed = [5, 13, 199] + list(range(100, 150))
    b = traffic.check_sample(200, 10, lengths, seed, always=failed)
    assert set(a) | set(failed[:10]) == set(b)
    assert traffic.check_sample(200, None, lengths, seed) == list(range(200))


def test_the_corpus_copy_is_whole():
    rows = traffic.corpus()
    assert len(rows) == 2296
    assert len(traffic.band(65, 128)) == 1894


@pytest.mark.parametrize("cell,trace", [("tiny-stream", False),
                                        ("tiny-stream", True),
                                        ("tiny-api", True)])
def test_the_result_line_has_the_contracts_keys(tiny_bench, cell, trace):
    result, compared = run_tiny(tiny_bench, cell, 4.0, trace)
    keys = LINE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result["checks"]) == set(compared) == set(
        TINY_CELLS[cell][0]["limits"])
    json.dumps(result)
    names = set(result["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        if cell == "tiny-stream":
            assert names == {"stream_host_ms_per_fold", DROPPED_METRIC}
        else:
            assert names == {"api_engine_ms_per_fold", "api_traj_ms_per_fold"}
    else:
        assert names == {"seq_per_s", "peak_mem_mib", "setup_s"}


def test_without_a_card_a_run_prints_nothing_and_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "n100ms50-b128",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_module_of_the_harness_imports_jax_and_the_reference_nothing_of_the_program():
    here = os.path.join(ROOT, "perfbench")
    for f in tree_files(here):
        if not f.endswith(".py"):
            continue
        tops = {m.split(".")[0] for m in _imports(os.path.join(here, f))}
        assert not tops & FORBIDDEN, f
        if f.startswith("reference") or f in ("check.py", "work.py",
                                               "traffic.py"):
            assert "rafft_tpu_torch" not in tops, f


def test_a_process_running_the_harness_and_the_program_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.run as run\n"
        "from perfbench import core, check, control, trace, work\n"
        "import perfbench.reference.fold\n"
        "b = core.Bench()\n"
        "for d in ('stream', 'fold_api'): b.driver(d)\n"
        "import rafft_tpu_torch\n"
        "from rafft_tpu_torch.parallel.sweep import bucket_config\n"
        "print(run.forbidden_modules())\n"
        "sys.modules['jaxlib.fake'] = sys.modules['json']\n"
        "print(run.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "['jaxlib.fake']"]
