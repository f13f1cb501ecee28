"""Entry drivers: one module per entry of the program that a window
drives, found by the name a workload file gives under "driver".  Each
defines `answer_form(settings)`, the canonical form of its answers
(perfbench/check.py), and `Cell(settings, workload, device, spans)` with
`warm(seqs)`, `window(seqs, seconds, slice_) -> Window` and `close()`.
A driver imports the program only when a Cell is made."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Window:
    attempted: int
    failed: int
    answered: list          # [(sequence, canonical answer)] in answer order
    wall_s: float
    metrics: dict           # end-to-end name -> (value, unit)
    peak_bytes: int
    readings: dict = field(default_factory=dict)   # what metric readers read
    failed_at: list = field(default_factory=list)  # answers counted failed


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_allocated(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0
