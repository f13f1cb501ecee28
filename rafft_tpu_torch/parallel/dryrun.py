"""Multi-device dry run (__graft_entry__.dryrun_multichip).

Folds one small batch twice: on one engine on the first device, and
split over a device list (mesh.split_state, one engine per block), and
requires the two folds to be bit-equal.  The fold needs no communication
between devices (SURVEY.md section 2.3), so the split fold is the whole
of data parallelism.

    python -m rafft_tpu_torch.parallel.dryrun N [--devices cuda:0,cuda:0]

The default device list is data_devices(N), N distinct cards.
"""

from __future__ import annotations

import argparse

import torch

from rafft_tpu_torch.engine.fold_torch import EngineConfig, FoldEngine
from rafft_tpu_torch.parallel.mesh import data_devices, gather_state, split_state

# __graft_entry__.dryrun_multichip's configuration and sequences
CFG = EngineConfig(N=32, K=2, R=4, M=8, V=16, CPLX=8, S=64, max_branch=16,
                   max_steps=4)
POOL = ["GGGAAACCCAAAGGGAAACCC",
        "GCGCUUCGGCGCGC",
        "AAGGCUAUCGCGGCGGAUGCCUAUGGCU",
        "GGGUUUGCGGUGUAAGUGCAGCCC",
        "GCGGAUUUAGCUCAGUUGGGAGAGC",
        "CCAGAUUGAGCCUGGGAGCUCUCUGG",
        "GGCGUAAGGAUUACCUAUGCC",
        "UUGGAGUACACAACCUGUACACUCUUUC"]
FIELDS = ("pt", "energy", "active", "done")


def split_fold(engines, states):
    """Step every block with its own engine until every lane of every
    block is done or max_steps is reached, as one engine steps one
    batch."""
    for _ in range(CFG.max_steps):
        if all(bool(s["done"].all()) for s in states):
            break
        states = [eng.step(s) for eng, s in zip(engines, states)]
    return states


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Fold n_devices sequences (B = n_devices, distinct sequences) on
    one engine on devices[0] and split over `devices` (default
    data_devices(n_devices)); raises unless pt, energy, active and done
    are bit-equal and every lane keeps its root beam active.  Returns
    the split fold's state, gathered on devices[0]."""
    devices = [torch.device(d) for d in (devices or data_devices(n_devices))]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for {n_devices}")
    B = n_devices
    seqs = [POOL[i % len(POOL)] for i in range(B)]
    eng = FoldEngine(CFG, B=B, device=devices[0])
    ref = split_fold([eng], [eng.init_state(seqs)])[0]
    blocks = split_state(eng.init_state(seqs), devices)
    engines = [FoldEngine(CFG, B=1, device=d) for d in devices]
    shd = gather_state(split_fold(engines, blocks), devices[0])
    for field in FIELDS:
        if not torch.equal(ref[field], shd[field]):
            raise AssertionError(f"split fold differs from the unsplit fold "
                                 f"in {field}")
    if not bool(shd["active"][:, 0].all()):
        raise AssertionError("inactive root beams in the split fold")
    print(f"dryrun_multichip: fold over {n_devices}-device list "
          f"{[str(d) for d in devices]} on {len(set(seqs))} distinct "
          f"sequences; sharded == unsharded bit-exact "
          f"(pt/energy/active/done)", flush=True)
    return shd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="devices, one sequence each (default 8)")
    ap.add_argument("--devices", help="comma-separated device list, e.g. "
                    "cuda:0,cuda:0 (default: cards 0 to n-1)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.devices.split(",") if args.devices else None)


if __name__ == "__main__":
    main()
