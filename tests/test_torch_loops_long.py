"""The PyTorch loop analysis at the long buckets against JAX and the journal.

eval_torch builds no [N, N] relation (innermost enclosures by a sort
over (depth, position), children statistics by scatter), so it is held
here against eval_jax, which does, at N = 256, 512 and 1024: on seeded
random nested tables and on the first beam structure of the first 8
journal rows of each bucket.  Energies and loop caches are integers, so
every comparison is exact.
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
from rafft_tpu_torch.energy import eval_torch as ET

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

JOURNAL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
PAIRS = [(1, 4), (4, 1), (2, 3), (3, 2), (3, 4), (4, 3)]
BUCKETS = (256, 512, 1024)


def _pt_from_db(db, N):
    pt = np.full(N, -1, np.int32)
    stack = []
    for i, ch in enumerate(db):
        if ch == "(":
            stack.append(i)
        elif ch == ")":
            j = stack.pop()
            pt[i], pt[j] = j, i
    return pt


def random_tables(seed, N, count):
    """Random nested pair tables with canonical pairs (hairpins >= 3),
    lengths in (N/2, N]."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((count, N), np.int32)
    pts = np.full((count, N), -1, np.int32)
    ns = rng.integers(N // 2 + 1, N + 1, size=count).astype(np.int32)
    for b in range(count):
        n = ns[b]
        codes[b, :n] = rng.integers(1, 5, size=n)
        stack = []
        p_open = rng.uniform(0.1, 0.4)
        for i in range(n):
            u = rng.random()
            if stack and i - stack[-1] > 3 and u < 0.35:
                j = stack.pop()
                pts[b, i], pts[b, j] = j, i
                codes[b, j], codes[b, i] = PAIRS[rng.integers(len(PAIRS))]
            elif u > 1 - p_open:
                stack.append(i)
    return codes, pts, ns


def _journal_rows(N, count=8):
    lo = N // 2
    out = []
    for line in gzip.open(JOURNAL, "rt"):
        r = json.loads(line)
        if lo < len(r["seq"]) <= N:
            out.append(r)
            if len(out) == count:
                break
    return out


def journal_tables(N, count=8):
    """First beam structure of the first `count` journal rows of bucket N,
    with its energy in dekacal."""
    codes, pts, ns, want = [], [], [], []
    for r in _journal_rows(N, count):
        c = np.zeros(N, np.int32)
        e = encode_sequence(r["seq"])
        c[: len(e)] = e
        db, energy = r["beam"][0]
        codes.append(c)
        pts.append(_pt_from_db(db, N))
        ns.append(len(e))
        want.append(int(round(energy * 100)))
    return (np.stack(codes), np.stack(pts), np.asarray(ns, np.int32),
            np.asarray(want))


def _jax_analyze(N, codes, pts, ns):
    dp = EJ.device_params(37.0, max_len=N)
    fn = jax.jit(jax.vmap(lambda c, p, n: EJ.analyze_pt(dp, c, p, n)))
    return {k: np.asarray(v) for k, v in fn(
        jnp.asarray(codes), jnp.asarray(pts), jnp.asarray(ns)).items()}


def _jax_eval(N, codes, pts, ns):
    dp = EJ.device_params(37.0, max_len=N)
    fn = jax.jit(jax.vmap(lambda c, p, n: EJ.eval_pt(dp, c, p, n)))
    return np.asarray(fn(*(jnp.asarray(x) for x in (codes, pts, ns))))


@pytest.mark.parametrize("N", BUCKETS)
def test_analyze_and_eval_match_jax_long(N):
    rc, rp, rn = random_tables(N, N, 8)
    jc, jp, jn, want_e = journal_tables(N)
    codes, pts, ns = (np.concatenate(x) for x in ((rc, jc), (rp, jp), (rn, jn)))
    want = _jax_analyze(N, codes, pts, ns)
    dp = ET.device_params(37.0, N, "cpu")
    args = [torch.as_tensor(x) for x in (codes, pts, ns)]
    got = ET.analyze_pt(dp, *args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    e = ET.eval_pt(dp, *args).numpy()
    np.testing.assert_array_equal(e, _jax_eval(N, codes, pts, ns))
    # the journal's energies, rounded to dekacal
    np.testing.assert_array_equal(e[len(rc):], want_e)


def _enclose_relation(pt, n):
    """The [N, N] masked max-reduction of eval_jax.py:408-409."""
    N = pt.shape[-1]
    ii = np.arange(N)
    is_open = (ii < n[:, None]) & (pt > ii)
    enc = ((ii[None, :] < ii[:, None]) & is_open[:, None, :]
           & (pt[:, None, :] > ii[:, None]))
    return np.where(enc, ii, -1).max(-1)


@pytest.mark.parametrize("N", [8, 64, 256])
def test_enclose_equals_relation(N):
    """The sort form of the innermost enclosure equals the relation at
    every position: unpaired, opening, closing and padding (i >= n)."""
    codes, pts, ns = random_tables(100 + N, N, 64)
    pts[0] = -1                      # the unfolded root
    ns[1] = 0                        # an empty lane
    pts[1] = -1
    t_pt = torch.as_tensor(pts)
    n1 = torch.as_tensor(ns)[:, None]
    ii = torch.arange(N, dtype=torch.int32)
    got = ET._enclose(t_pt, (ii < n1) & (t_pt > ii), n1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _enclose_relation(pts, ns))


def test_eval_leading_dims_long():
    """[B, X, N] inputs at N = 1024 give the flattened batch's energies
    (the fold step's [B, n_on, N] complex-candidate tables)."""
    N = 1024
    codes, pts, ns = random_tables(5, N, 6)
    dp = ET.device_params(37.0, N, "cpu")
    flat = ET.eval_pt(dp, *(torch.as_tensor(x) for x in (codes, pts, ns)))
    nested = ET.eval_pt(dp, torch.as_tensor(codes).view(2, 3, N),
                        torch.as_tensor(pts).view(2, 3, N),
                        torch.as_tensor(ns).view(2, 3))
    np.testing.assert_array_equal(nested.reshape(-1).numpy(), flat.numpy())
