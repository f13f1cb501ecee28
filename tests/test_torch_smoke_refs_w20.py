"""The max_stack 20 part of chip_smoke.py's non-integral-weight
references (see tests/test_torch_smoke_refs.py, which checks the rest):
kept in a file of its own because it costs one more compile of the JAX
engine on the CPU.
"""

import json

from test_torch_smoke_refs import REFS, WEIGHTS, ref_weights


def test_weights_refs_max_stack_20():
    with open(REFS) as fh:
        committed = json.load(fh)
    assert committed["weights"]["args"] == WEIGHTS
    want = ref_weights(20)
    assert committed["weights"]["fold_one"]["20"] == want
    assert len(want["final"]) == 20 and len(want["traj"]) >= 4
