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
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("OK", res[0].str_struct, res[0].energy)
"""


def test_port_imports_and_folds_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK ")


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where the JAX package is absent: it imports the
    port and the standard library, never JAX or rafft_tpu itself."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    tops = {m.split(".")[0] for m in names}
    assert "rafft_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "rafft_tpu"}, sorted(tops)
