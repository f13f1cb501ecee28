"""Assemble the full-corpus result CSVs from sweep and long-tail runs
(tools/merge_corpus.py's counterpart).

Reads the sweep's checkpoint journal (the buckets up to 1024,
rafft_tpu_torch/parallel/sweep.py) and the long-tail journal
(rafft_tpu_torch/tools/fold_longtail.py, the two 23S rRNAs over 1,024 nt)
and writes the two reference-schema result CSVs in corpus order:

  fft_100n_50ms_best_nrj_scores.csv  - the lowest-energy structure
  fft_100n_50ms_scores.csv           - the best-of-k pick of the saved beam

Rows are keyed by (seq, name); a corpus row with no result is an error
(the deliverable is every row, not a silent subset).  The corpus is
--corpus (the reference benchmark CSV) or, without it,
tools/corpus.py:reference_order(): the order is all that is read.

    python -m rafft_tpu_torch.tools.merge_corpus --ckpt sweep.ckpt.jsonl \
        longtail.ckpt.jsonl --out-best-nrj A.csv --out-best-of-k B.csv
"""

from __future__ import annotations

import argparse
import json
import sys

from rafft_tpu_torch.parallel.sweep import load_benchmark_csv
from rafft_tpu_torch.tools.corpus import reference_order

HEADER = "seq,len_seq,struct,nrj,nbp,pvv,sens,name\n"


def load_journals(paths):
    rows = {}
    for path in paths:
        with open(path) as fh:
            for line in fh:
                r = json.loads(line)
                rows[(r["seq"], r["name"])] = r
    return rows


def write_csv(path, corpus, rows, selection):
    with open(path, "w") as fh:
        fh.write(HEADER)
        for seq, _true, name in corpus:
            r = rows[(seq, name)]
            if selection == "best_of_k" and "struct_bk" in r:
                db, e = r["struct_bk"], r["nrj_bk"]
                ppv, sens = r["pvv_bk"], r["sens_bk"]
            else:
                db, e = r["struct"], r["nrj"]
                ppv, sens = r["pvv"], r["sens"]
            fh.write(f"{seq},{len(seq)},{db},{e},{db.count('(')},"
                     f"{ppv},{sens},{name}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", nargs="+", required=True,
                    help="journal jsonl files (sweep checkpoint + longtail)")
    ap.add_argument("--corpus", help="the reference benchmark CSV (default: "
                    "tools/corpus.py:reference_order())")
    ap.add_argument("--out-best-nrj", required=True)
    ap.add_argument("--out-best-of-k", required=True)
    ap.add_argument("--allow-missing", type=int, default=0, metavar="N",
                    help="tolerate up to N corpus rows without results "
                         "(each is named on stderr; the CSVs then hold "
                         "fewer rows)")
    args = ap.parse_args(argv)

    corpus = (load_benchmark_csv(args.corpus) if args.corpus
              else reference_order())
    rows = load_journals(args.ckpt)
    missing = [(name, len(seq)) for seq, _t, name in corpus
               if (seq, name) not in rows]
    if missing:
        for name, ln in missing[:20]:
            print(f"MISSING {name} ({ln} nt)", file=sys.stderr)
        if len(missing) > args.allow_missing:
            sys.exit(f"{len(missing)} corpus rows have no result — "
                     f"refusing to write a partial artifact")
        corpus = [r for r in corpus if (r[0], r[2]) in rows]
    write_csv(args.out_best_nrj, corpus, rows, "best_nrj")
    write_csv(args.out_best_of_k, corpus, rows, "best_of_k")
    print(f"{len(corpus)} rows -> {args.out_best_nrj}, "
          f"{args.out_best_of_k}")


if __name__ == "__main__":
    main()
