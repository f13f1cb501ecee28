"""The PyTorch energy evaluator against the JAX one and the journal.

Inputs are made with numpy from a seed and go through
rafft_tpu.energy.eval_jax (JAX on the CPU) and
rafft_tpu_torch.energy.eval_torch (torch on the CPU).  Energies are
integers, so every comparison is exact.
"""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafft_tpu.energy import eval_jax as EJ
from rafft_tpu.energy.params import encode_sequence
from rafft_tpu_torch.convert import device_params_from_numpy
from rafft_tpu_torch.energy import eval_torch as ET

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

N = 128
JOURNAL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
PAIRS = [(1, 4), (4, 1), (2, 3), (3, 2), (3, 4), (4, 3)]


def _pt_from_db(db):
    pt = np.full(N, -1, np.int32)
    stack = []
    for i, ch in enumerate(db):
        if ch == "(":
            stack.append(i)
        elif ch == ")":
            j = stack.pop()
            pt[i], pt[j] = j, i
    return pt


def _random_batch(seed, count=64):
    """Random nested pair tables with canonical pairs (hairpins >= 3)."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((count, N), np.int32)
    pts = np.full((count, N), -1, np.int32)
    ns = rng.integers(20, N + 1, size=count).astype(np.int32)
    for b in range(count):
        n = ns[b]
        codes[b, :n] = rng.integers(1, 5, size=n)
        stack = []
        for i in range(n):
            u = rng.random()
            if stack and i - stack[-1] > 3 and u < 0.35:
                j = stack.pop()
                pts[b, i], pts[b, j] = j, i
                codes[b, j], codes[b, i] = PAIRS[rng.integers(len(PAIRS))]
            elif u > 0.7:
                stack.append(i)
    return codes, pts, ns


def _journal_batch(count=200):
    rows = [json.loads(line) for line in gzip.open(JOURNAL, "rt")]
    codes, pts, ns, want = [], [], [], []
    for r in rows:
        if len(r["seq"]) > N:
            continue
        c = np.zeros(N, np.int32)
        e = encode_sequence(r["seq"])
        c[: len(e)] = e
        for db, energy in r["beam"][:10]:
            codes.append(c)
            pts.append(_pt_from_db(db))
            ns.append(len(e))
            want.append(int(round(energy * 100)))
        if len(want) >= count:
            break
    return (np.stack(codes), np.stack(pts), np.asarray(ns, np.int32),
            np.asarray(want))


_DPJ = EJ.device_params(37.0, max_len=N)
_analyze_jax = jax.jit(jax.vmap(lambda c, p, n: EJ.analyze_pt(_DPJ, c, p, n)))
_eval_jax = jax.jit(jax.vmap(lambda c, p, n: EJ.eval_pt(_DPJ, c, p, n)))


def test_device_params_from_jax_equals_native():
    arrays = {k: np.asarray(v) for k, v in vars(_DPJ).items()}
    conv = device_params_from_numpy(arrays, 37.0, "cpu")
    native = ET.device_params(37.0, N, "cpu")
    for k in ET.TABLES:
        np.testing.assert_array_equal(getattr(conv, k).numpy(),
                                      getattr(native, k).numpy(), err_msg=k)
    for k in ET.SCALARS:
        assert getattr(conv, k) == getattr(native, k), k


@pytest.mark.parametrize("source", ["random0", "random1", "journal"])
def test_eval_and_analyze_match_jax(source):
    if source == "journal":
        codes, pts, ns, _ = _journal_batch()
    else:
        codes, pts, ns = _random_batch(int(source[-1]))
    want = {k: np.asarray(v) for k, v in _analyze_jax(
        jnp.asarray(codes), jnp.asarray(pts), jnp.asarray(ns)).items()}
    dp = ET.device_params(37.0, N, "cpu")
    args = [torch.as_tensor(x) for x in (codes, pts, ns)]
    got = ET.analyze_pt(dp, *args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(
        ET.eval_pt(dp, *args).numpy(),
        np.asarray(_eval_jax(*(jnp.asarray(x) for x in (codes, pts, ns)))))


def test_eval_matches_journal_energies():
    codes, pts, ns, want = _journal_batch()
    dp = ET.device_params(37.0, N, "cpu")
    got = ET.eval_pt(dp, *(torch.as_tensor(x) for x in (codes, pts, ns)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_eval_batched_leading_dims():
    """[B, X, N] inputs give the same energies as the flattened batch."""
    codes, pts, ns = _random_batch(5, count=24)
    dp = ET.device_params(37.0, N, "cpu")
    flat = ET.eval_pt(dp, *(torch.as_tensor(x) for x in (codes, pts, ns)))
    nested = ET.eval_pt(dp, torch.as_tensor(codes).view(4, 6, N),
                        torch.as_tensor(pts).view(4, 6, N),
                        torch.as_tensor(ns).view(4, 6))
    np.testing.assert_array_equal(nested.reshape(-1).numpy(), flat.numpy())
