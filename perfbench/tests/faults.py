"""Faults planted under a run's timed path, for the tests that see a
run's `correct` come out false.  Each patches the program's FoldEngine
at class level for the duration of a `with planted(kind):` block; plant
it before the run sets up, so that a CUDA graph captures it.

- "state_unchanged": a fold step returns its state unchanged;
- "half_batch": a fold step advances only the first half of the batch's
  lanes and leaves the others as they were (at B=1, none);
- "answer_altered": the best structure's energy of every answer is
  raised by 0.01 kcal/mol where the answer is read off the card
  (FoldEngine._rows_from for the stream, FoldEngine._structures for the
  public fold).

The cells run on one card, so no exchange between cards can be left out.
"""

from __future__ import annotations

from contextlib import contextmanager

KINDS = ("state_unchanged", "half_batch", "answer_altered")


@contextmanager
def planted(kind):
    import torch

    from rafft_tpu_torch.engine.fold_torch import FoldEngine as E
    saved = {}

    def patch(name, fn):
        saved[name] = getattr(E, name)
        setattr(E, name, fn)

    if kind == "state_unchanged":
        patch("step", lambda self, state: state)
    elif kind == "half_batch":
        step = E.step

        def half(self, state):
            nxt = step(self, state)
            lanes = torch.arange(self.B, device=self.device) < self.B // 2
            return {k: torch.where(lanes.view(-1, *[1] * (v.dim() - 1)), v,
                                   state[k]) for k, v in nxt.items()}
        patch("step", half)
    elif kind == "answer_altered":
        rows_from, structures = E._rows_from, E._structures

        def altered_rows(self, *args):
            rows = rows_from(self, *args)
            if rows:
                rows[0] = (rows[0][0], rows[0][1] + 0.01)
            return rows

        def altered_structures(self, *args):
            beams = structures(self, *args)
            for beam in beams:
                if beam:
                    beam[0].energy += 0.01
            return beams
        patch("_rows_from", altered_rows)
        patch("_structures", altered_structures)
    else:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(E, name, fn)
