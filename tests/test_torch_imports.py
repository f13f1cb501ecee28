"""rafft_tpu_torch and chip_smoke.py fold without JAX.

Runs in a subprocess because this suite's conftest imports JAX.
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import rafft_tpu_torch
from rafft_tpu_torch import fold_one
from rafft_tpu_torch.engine import wavefront
from rafft_tpu_torch import convert, _build
from rafft_tpu_torch.parallel import sweep
from rafft_tpu_torch.cli import fold_cli
from rafft_tpu_torch.tools import measure
import chip_smoke
assert sweep.bucket_config(1024, 100, 50, 1000).R == 32
res = fold_one("GGGAAACCCAAAGGGAAACCC", nb_mode=8, max_stack=2,
               max_branch=16, device="cpu")
assert res and res[0].energy < 0, res
assert wavefront.LAUNCHES == 0
# non-integral weights (the FFT correlation) and the tree-keeping engine
res_w = fold_one("GGGAAACCCAAAGGGAAACCC", nb_mode=8, max_stack=2,
                 max_branch=16, gc_wei=2.5, device="cpu")
assert res_w and res_w[0].energy < 0, res_w
from rafft_tpu_torch.engine import fold_nono
tree, root = fold_nono.fold("GGGAAACCCAAAGGGAAACCC", 8, 2, 16)
assert tree[0].str_struct == res[0].str_struct and "level:1" in str(root)
assert sweep.bucket_config(4096, 200, 200, 1000).K == 200
from rafft_tpu_torch.engine import fold_cpu
beam = fold_cpu.fold("GGGAAACCCAAAGGGAAACCC", nb_mode=8, max_stack=2, max_branch=16)
assert [s.str_struct for s in beam] == [s.str_struct for s in res], beam
assert fold_cpu.EVALUATOR in ("native", "numpy")
i, rows, evaluator = sweep._cpu_refold((7, "GGGAAACCCAAAGGGAAACCC", 8, 2, 16))
assert i == 7 and rows[0][0] == res[0].str_struct and evaluator == fold_cpu.EVALUATOR
recs = [("GGGAAACCCAAAGGGAAACCC", "((((...))))..........", "a")]
stats = {}
out = sweep.sweep(recs, nb_mode=8, max_stack=2, max_branch=16, buckets=(32,),
                  stats=stats, device="cpu")
assert out[0]["struct"] == res[0].str_struct and stats["n_fallback"] == 0
# the MFE DP, the package root's fold / kinetics / mfe_fold and the host
# library modules
from rafft_tpu_torch import analysis, fold, kinetics, mfe_fold, mfe_batch
from rafft_tpu_torch.cli import kin_cli
from rafft_tpu_torch.energy import features, EnergyParams, eval_structure_int
from rafft_tpu_torch.kin import plot
from rafft_tpu_torch.tools import bench_mfe
from rafft_tpu_torch.tools import bench, bench_full, corpus, measure_baseline
_seqs, _counts, _ = corpus.by_bucket(corpus.corpus(), (128, 256, 512, 1024))
assert _counts[128] == 1938 and len(corpus.headline_rows(corpus.corpus())) == 256
assert bench.engine(128, "cpu").cfg == sweep.bucket_config(128, 100, 50, 1000)
from rafft_tpu_torch.parallel import distributed, dryrun, launch, mesh
from rafft_tpu_torch.viz import layout, plot_path, surface
seq = "GGGAAACCCAAAGGGAAACCC"
mfe = mfe_batch([seq, "ACGU"], device="cpu")
assert mfe == [mfe_fold(seq), ("....", 0.0)], mfe
assert mfe[0][1] == eval_structure_int(seq, mfe[0][0]) / 100
assert bench_mfe.mfe_records([(seq, "", "a")], device="cpu") == mfe[:1]
final, traj = fold(seq, 8, 2, 16, traj=True, device="cpu")
assert [s.str_struct for s in final] == [s.str_struct for s in res]
_, _, structs, equi = kinetics(traj + [final], 10, 20, method="expm")
assert abs(sum(p for _, _, p, _ in equi) - 1) < 1e-9 and structs
# the fold engine's exactness tools, the corpus pipeline and the
# evaluators' host APIs
from rafft_tpu_torch.tools import (bench_parity, debug_delta, debug_seq,
                                   fold_longtail, merge_corpus, perfcheck,
                                   rescore_bk)
from rafft_tpu_torch.energy import eval_torch
assert len(corpus.reference_order()) == 2296
rows = debug_delta.candidates_for(seq, "." * len(seq), device="cpu")
assert rows and all(r["ok"] for r in rows if not r["unsup"]), rows
import numpy as np
z = np.zeros((1, 32), np.int32)
assert eval_torch.eval_batch(z, z - 1, [0], device="cpu").tolist() == [0]
assert bench_parity.run_one((seq, "", "a"), 8, 2, 16)[1][0][2] == res[0].str_struct
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "rafft_tpu"))
assert not loaded, loaded
print("OK", res[0].str_struct, res[0].energy)
"""


def test_port_imports_and_folds_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK ")


OBS_SCRIPT = r"""
import sys
import types
# the package root imports the engine (rafft_tpu_torch.fold): stand in an
# empty root, so what loads is obs's own imports
root = types.ModuleType("rafft_tpu_torch")
root.__path__ = [sys.argv[1]]
sys.modules["rafft_tpu_torch"] = root
import rafft_tpu_torch.obs as obs
snap = obs.snapshot()
assert snap["process"] == {}, snap
loaded = sorted(m for m in sys.modules if m.startswith("rafft_tpu_torch."))
assert loaded == ["rafft_tpu_torch.obs"], loaded
print("OK")
"""


def test_obs_imports_nothing_of_the_engine():
    """The trace that every layer calls sits below them: importing obs
    and taking a snapshot loads no rafft_tpu_torch.engine module (each
    process counter registers from its own module)."""
    pkg = os.path.join(REPO, "rafft_tpu_torch")
    out = subprocess.run([sys.executable, "-c", OBS_SCRIPT, pkg], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _dirs, files in os.walk(os.path.join(REPO, "rafft_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py and every module of the port run where the JAX
    package is absent: none imports JAX or rafft_tpu itself, at top level
    or inside a function."""
    paths = sorted(_port_sources())
    assert len(paths) > 20
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        tops = {m.split(".")[0] for m in names}
        assert not tops & {"jax", "jaxlib", "rafft_tpu"}, (path, sorted(tops))
        if path.endswith("chip_smoke.py"):
            assert "rafft_tpu_torch" in tops
