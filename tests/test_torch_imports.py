"""rafft_tpu_torch folds without JAX.

Runs in a subprocess because this suite's conftest imports JAX.
"""

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
