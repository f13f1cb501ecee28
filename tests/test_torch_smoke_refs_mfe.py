"""The `mfe` entry of rafft_tpu_torch/testdata/chip_smoke_refs.json.

chip_smoke.py holds the card's batched MFE DP to it.  It was written by
the JAX package's batched DP (mfe_jax.mfe_batch, one batch at N=128; see
tests/test_torch_smoke_refs.py).  That DP takes about 8 s a sequence on
the CPU, so here it reruns on the README sequence and the first journal
row only; every row is checked against the JAX package's native DP,
which tests/test_mfe.py holds equal to its batched one.
"""

import json

import pytest

from tests.test_torch_smoke_refs import MFE_N, REFS, mfe_rows


@pytest.fixture(scope="module")
def committed():
    with open(REFS) as fh:
        return json.load(fh)["mfe"]


def test_mfe_refs_rows(committed):
    from rafft_tpu.mfe import mfe_fold
    assert committed["N"] == MFE_N
    rows = mfe_rows()
    assert [(r["row"], r["name"], r["seq"]) for r in committed["rows"]] == \
        rows
    for r in committed["rows"]:
        assert 64 < len(r["seq"]) <= MFE_N
        assert (r["struct"], r["nrj"]) == mfe_fold(r["seq"]), r["name"]


def test_mfe_refs_jax_dp(committed):
    from tests.test_torch_smoke_refs import ref_mfe
    assert ref_mfe(mfe_rows()[:2]) == committed["rows"][:2]
