"""Corpus sweeps and data parallelism (rafft_tpu/parallel/).

sweep.py: length buckets, per-bucket engine configurations, the CPU
refold of flagged folds, and the split of each bucket over k devices
(one worker process each); mesh.py: device lists and the split of an
engine state over them; distributed.py: the multi-process runtime (a
gloo process group, the strided corpus shard, the mean-score reduction
and the part-file merge); launch.py: a multi-process sweep on one
machine; dryrun.py: the multi-device dry run (split fold bit-equal to
one engine)."""
