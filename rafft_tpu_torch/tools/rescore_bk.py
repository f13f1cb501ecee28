"""Recompute the best-of-k (*_bk) fields of a sweep checkpoint journal
from saved beams with scoring.best_of (tools/rescore_bk.py's
counterpart, on the port's scoring).

The sweep journal caches both selections per row; when the best-of-k
rule changes, the journal is re-scored from the saved beams
(--save-beams jsonl, gzip allowed) without folding anything.  --truth
(the reference benchmark CSV) is required: best-of-k scores against its
truth column.  Rewrites --ckpt in place (atomically, through a .tmp
file and a rename).

    python -m rafft_tpu_torch.tools.rescore_bk --ckpt sweep.ckpt.jsonl \
        --beams beams.jsonl [beams2.jsonl ...] --truth <benchmark.csv>
"""

from __future__ import annotations

import argparse
import csv
import gzip
import json
import os

import numpy as np

from rafft_tpu_torch.scoring import best_of


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--beams", nargs="+", required=True)
    ap.add_argument("--truth", required=True)
    args = ap.parse_args(argv)

    truth = {}
    with open(args.truth) as fh:
        for r in csv.reader(fh):
            if len(r) >= 3:
                truth[(r[0], r[2])] = r[1]

    beams = {}
    for path in args.beams:
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            for line in fh:
                b = json.loads(line)
                beams[(b["seq"], b["name"])] = b["beam"]

    n = n_re = n_changed = 0
    out_path = args.ckpt + ".tmp"
    with open(args.ckpt) as fin, open(out_path, "w") as fout:
        for line in fin:
            row = json.loads(line)
            n += 1
            key = (row["seq"], row["name"])
            beam = beams.get(key)
            true_db = truth.get(key)
            if beam is not None and true_db is not None:
                ppv_bk, sens_bk, db_bk = best_of([d for d, _e in beam],
                                                 true_db)
                emap = {d: e for d, e in beam}
                if db_bk in emap:
                    e_bk = emap[db_bk]
                else:       # all-dots default: fall back to best-energy
                    db_bk, e_bk = row["struct"], row["nrj"]
                    ppv_bk, sens_bk = row["pvv"], row["sens"]
                n_re += 1
                if db_bk != row.get("struct_bk"):
                    n_changed += 1
                row.update(struct_bk=db_bk,
                           nrj_bk=float(np.float32(e_bk)),
                           pvv_bk=ppv_bk, sens_bk=sens_bk)
            fout.write(json.dumps(row) + "\n")
    os.replace(out_path, args.ckpt)
    print(f"{args.ckpt}: {n} rows, {n_re} re-scored, "
          f"{n_changed} best-of-k picks changed")


if __name__ == "__main__":
    main()
