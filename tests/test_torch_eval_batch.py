"""The port's batch host API and sequential-walk evaluator against the
JAX package's (rafft_tpu/energy/eval_jax.py eval_batch, eval_pt_scan),
on the CPU, integers equal.

The inputs are seeded random nested structures (numpy), 8 rows at N=64
and at N=128: row 0 is the empty structure, row 1 a multiloop closed by
a stem with three branches, the rest random.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafft_tpu.energy import eval_jax as EJ
from rafft_tpu_torch.energy import eval_torch as ET
from rafft_tpu_torch.energy.eval_np import eval_structure_int
from rafft_tpu_torch.struct import dot_bracket
from rafft_tpu_torch.tools.measure import nested_tables

torch.set_num_threads(1)

MULTILOOP = "((((..((((...))))..((((...))))..((((...)))).))))"


def _inputs(N):
    codes, pt, n = nested_tables(np.random.default_rng(N), 8, N, N // 2, N)
    pt[0] = -1                                  # the empty structure
    m = len(MULTILOOP)
    stack, codes[1], pt[1], n[1] = [], 0, -1, m
    codes[1, :m] = 1                            # A
    for i, c in enumerate(MULTILOOP):
        if c == "(":
            stack.append(i)
        elif c == ")":
            j = stack.pop()
            pt[1, i], pt[1, j] = j, i
            codes[1, j], codes[1, i] = 3, 2     # G-C
    return codes, pt, n


def _host(codes, pt, n):
    """eval_structure_int of each row, the host oracle."""
    out = []
    for c, p, ln in zip(codes, pt, n):
        seq = "".join("NACGU"[x] for x in c[:ln])
        out.append(eval_structure_int(seq, dot_bracket(
            [(i, int(p[i])) for i in range(ln) if p[i] > i], int(ln))))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("N", [64, 128])
def test_eval_batch_matches_jax(N):
    codes, pt, n = _inputs(N)
    want = EJ.eval_batch(codes, pt, n)
    got = ET.eval_batch(codes, pt, n, device="cpu")
    assert got.dtype == np.int32 and got.shape == (8,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _host(codes, pt, n))
    assert got[0] == 0 and got[1] < 0


@pytest.mark.parametrize("N", [64, 128])
def test_eval_pt_scan_matches_jax(N):
    codes, pt, n = _inputs(N)
    dpj = EJ.device_params(37.0, max_len=N)
    scan = jax.jit(jax.vmap(lambda c, p, ln: EJ.eval_pt_scan(dpj, c, p, ln)))
    want = np.asarray(scan(jnp.asarray(codes), jnp.asarray(pt),
                           jnp.asarray(n)))
    dp = ET.device_params(37.0, N, "cpu")
    t = torch.as_tensor
    got = ET.eval_pt_scan(dp, t(codes), t(pt), t(n))
    assert got.dtype == torch.int32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _host(codes, pt, n))
    # one table without a batch dimension walks the same way
    assert int(ET.eval_pt_scan(dp, t(codes[1]), t(pt[1]), t(n[1]))) == want[1]


def test_eval_batch_runs_on_cuda_by_default():
    """No fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    codes, pt, n = _inputs(64)
    with pytest.raises((RuntimeError, AssertionError)):
        ET.eval_batch(codes, pt, n)
