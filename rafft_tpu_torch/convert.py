"""Carry energy tables and engine state between numpy (the JAX side) and torch.

uint32 state fields (the seen-set hashes) are held in int64 tensors with
the 32-bit pattern; `state_to_numpy` turns them back into uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from rafft_tpu_torch.energy.eval_torch import SCALARS, TABLES, DeviceParams


def device_params_from_numpy(arrays: dict, temp: float, device) -> DeviceParams:
    """DeviceParams from `{k: np.asarray(v) for k, v in vars(jax_dp).items()}`
    (only the tables and scalars the torch path reads are taken)."""
    keep = {k: np.asarray(arrays[k]) for k in TABLES + SCALARS}
    return DeviceParams(keep, temp).to(device)


def state_from_numpy(state: dict, device) -> dict:
    out = {}
    for k, v in state.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[k] = torch.as_tensor(a.copy(), device=device)
    return out


_UINT32_KEYS = ("seen_h1", "seen_h2")


def state_to_numpy(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        a = v.detach().cpu().numpy()
        if k in _UINT32_KEYS:
            a = a.astype(np.uint32)
        out[k] = a
    return out
