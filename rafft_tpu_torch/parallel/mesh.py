"""Device lists for data-parallel folds (rafft_tpu/parallel/mesh.py).

The JAX package places one batch on a 1-D ('data',) mesh and lets one
XLA program drive every chip.  Here a "mesh" is a plain list of
torch.devices, and a batch is split into one block per device, each
folded by its own engine: `split_state` is the counterpart of
`shard_state` (NamedSharding(P("data")): contiguous blocks of the batch
axis), `gather_state` its inverse.  `batch_sharding` and `replicated`
have no counterparts: they name XLA placements, and a block here is
simply a tensor on its device.
"""

from __future__ import annotations

import torch


def data_devices(n: int | None = None) -> list[torch.device]:
    """[cuda:0, ..., cuda:n-1]: the first n (or all) visible cards.

    Raises where fewer than n cards (or none) are visible: a card is
    never repeated and the CPU never stands in.  A caller that wants
    several workers on one device passes its own list, such as
    ["cuda:0", "cuda:0"]."""
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n < 1 or n > count:
        raise RuntimeError(f"data_devices({n}): {count} CUDA card(s) "
                           "visible")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def split_state(state: dict, devices) -> list[dict]:
    """A fold-engine state split into len(devices) contiguous blocks of
    its batch axis, block d moved to devices[d]; entries without a batch
    axis are copied to every device.  The batch must divide evenly, as
    for a NamedSharding over the 'data' axis."""
    devices = [torch.device(d) for d in devices]
    k = len(devices)
    out = [{} for _ in devices]
    for key, v in state.items():
        if v.dim() == 0:
            for d, dev in enumerate(devices):
                out[d][key] = v.to(dev, copy=True)
            continue
        if v.shape[0] % k:
            raise ValueError(f"split_state: {key} has batch {v.shape[0]}, "
                             f"not a multiple of {k} devices")
        for d, (dev, block) in enumerate(zip(devices, v.chunk(k))):
            out[d][key] = block.to(dev, copy=True)
    return out


def gather_state(states, device) -> dict:
    """The blocks of split_state joined on `device` along the batch
    axis (entries without one are taken from the first block)."""
    device = torch.device(device)
    return {key: (v.to(device) if v.dim() == 0 else
                  torch.cat([s[key].to(device) for s in states]))
            for key, v in states[0].items()}
