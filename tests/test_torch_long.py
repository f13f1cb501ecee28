"""The PyTorch fold step at the long buckets, against the JAX engine.

One step at N=256 with R=32 slots, from a JAX mid-fold state of the
first two journal rows of the 256 bucket, carried across as numpy: every
state field must equal the JAX engine's third step.  The configuration
is cut (K=4, M=32, V=256, W=3, CPLX=32, S=1024) so that JAX compiles it
on the CPU in about half a minute; N and R are the bucket's.
"""

import gzip
import json
import os

import numpy as np
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu_torch.convert import state_from_numpy, state_to_numpy
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

JOURNAL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
STEP_KEYS = ("pt", "energy", "active", "rorder", "seen_h1", "seen_h2",
             "seen_cnt", "done", "cplx_dropped", "enum_suspect")
LONG_CFG = dict(N=256, K=4, R=32, M=32, V=256, W=3, CPLX=32, S=1024)


def bucket_seqs(lo, hi, count):
    """The first `count` journal sequences with lo < length <= hi."""
    out = []
    for line in gzip.open(JOURNAL, "rt"):
        seq = json.loads(line)["seq"]
        if lo < len(seq) <= hi:
            out.append(seq)
            if len(out) == count:
                break
    return out


def test_one_step_from_jax_state_n256():
    seqs = bucket_seqs(128, 256, 2)
    ej = FJ.FoldEngine(FJ.EngineConfig(**LONG_CFG), B=2)
    et = FT.FoldEngine(FT.EngineConfig(**LONG_CFG), B=2, device="cpu")
    st = ej.init_state(seqs)
    for _ in range(2):
        st = ej._step(st)
    st = {k: np.asarray(v) for k, v in st.items()}
    want = {k: np.asarray(v) for k, v in ej._step(st).items()}
    got = state_to_numpy(et.step(state_from_numpy(st, "cpu")))
    assert not want["done"].all()
    # the step added structures with several regions in use
    assert (want["rorder"] > -2).sum(-1).max() > 2
    for k in STEP_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
