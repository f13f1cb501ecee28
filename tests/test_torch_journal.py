"""Where the committed journal disagrees with the reference semantics.

benchmarks/artifacts/beams_100n50.jsonl.gz came from the JAX engine on a
TPU.  On four unflagged rows of the 128 bucket (443, 567, 947 and 1262)
its beam differs from the sequential CPU parity oracle fold_cpu, which
defines the reference semantics; the JAX engine on the CPU and the port
(on the CPU and on the card) both give the oracle's beam there.  This
test folds row 443 with the port at the sweep's 128-bucket configuration
and holds it to the oracle, not to the journal.
"""

import gzip
import json
import os

import torch

from rafft_tpu.engine.fold_cpu import fold as cpu_fold
from rafft_tpu_torch.engine.fold_torch import FoldEngine
from rafft_tpu_torch.parallel.sweep import bucket_config

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

JOURNAL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
ROW = 443


def test_port_follows_oracle_where_journal_differs():
    with gzip.open(JOURNAL, "rt") as fh:
        row = next(json.loads(line) for i, line in enumerate(fh) if i == ROW)
    assert row["name"] == "5s_Hydrurus-foetidus-1" and not row["flagged"]
    want = [(s.str_struct, s.energy)
            for s in cpu_fold(row["seq"], nb_mode=100, max_stack=50,
                              max_branch=1000)]
    journal = [(db, float(e)) for db, e in row["beam"]]
    assert want != journal
    eng = FoldEngine(bucket_config(128, 100, 50, 1000), B=1, device="cpu")
    (_, got, flag), = eng.run_stream([row["seq"]])
    assert flag == 0
    assert got == want
