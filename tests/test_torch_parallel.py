"""The port's scale-out layer against the JAX package's, on the CPU.

rafft_tpu_torch.parallel.{mesh, dryrun, distributed, sweep(devices=)}
against rafft_tpu.parallel.{mesh, distributed, sweep} and
__graft_entry__.dryrun_multichip: the split fold equals the JAX engine
on a batch sharded over two of the suite's virtual CPU devices
(tests/conftest.py), the part-file merge behaves as the JAX one, and a
sweep whose buckets are folded by two worker processes on ["cpu", "cpu"]
equals the one-device sweep and the JAX sweep.  Every comparison is
exact.  The multi-process tests are in tests/test_torch_multihost.py.
"""

import csv
import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

from rafft_tpu.engine import fold_jax as FJ
from rafft_tpu.parallel import distributed as JD
from rafft_tpu.parallel import sweep as JS
from rafft_tpu.parallel.mesh import data_mesh, shard_state
from rafft_tpu_torch.convert import state_to_numpy
from rafft_tpu_torch.engine import fold_torch as FT
from rafft_tpu_torch.parallel import distributed as PD
from rafft_tpu_torch.parallel import dryrun, mesh
from rafft_tpu_torch.parallel import sweep as TS

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

JOURNAL = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "benchmarks", "artifacts", "beams_100n50.jsonl.gz")
ARGS = dict(nb_mode=20, max_stack=3, max_branch=1000, batch=4, workers=2)
HEADER = "a,b\n"


def _records(count=4):
    out = []
    for line in gzip.open(JOURNAL, "rt"):
        r = json.loads(line)
        out.append((r["seq"], r["beam"][0][0], r["name"]))
        if len(out) == count:
            break
    return out


def _write_parts(out, parts):
    """parts: per process, (rows, finished)."""
    for p, (rows, finished) in enumerate(parts):
        with open(f"{out}.part{p}", "w") as fh:
            fh.write(HEADER)
            fh.writelines(rows)
            if finished:
                fh.write("#done\n")


@pytest.mark.parametrize("merge", [JD.merge_parts, PD.merge_parts],
                         ids=["jax", "port"])
def test_merge_parts_ok(merge, tmp_path):
    out = tmp_path / "merged.csv"
    _write_parts(out, [(["1,2\n"], True), (["3,4\n", "5,6\n"], True)])
    assert merge(str(out), 2, HEADER, timeout_s=5) == 3
    assert out.read_text() == "a,b\n1,2\n3,4\n5,6\n"


@pytest.mark.parametrize("merge", [JD.merge_parts, PD.merge_parts],
                         ids=["jax", "port"])
def test_merge_parts_dead_host(merge, tmp_path):
    """An unfinished part 0 and a missing part 1: PartTimeout names both,
    in the JAX function's words, within the deadline."""
    out = tmp_path / "merged.csv"
    _write_parts(out, [(["1,2\n"], False)])
    errors = []
    for fn, exc in ((JD.merge_parts, JD.PartTimeout),
                    (merge, PD.PartTimeout if merge is PD.merge_parts
                     else JD.PartTimeout)):
        with pytest.raises(exc) as ei:
            fn(str(out), 2, HEADER, timeout_s=0.5, poll_s=0.1)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert f"missing: ['{out}.part1']" in errors[1]
    assert f"unfinished (no #done trailer): ['{out}.part0']" in errors[1]
    assert not out.exists()


def test_shard_records_matches_jax():
    recs = list(range(10))
    for p in range(3):
        assert PD.shard_records(recs, p, 3) == JD.shard_records(recs, p, 3)
    assert len(PD.shard_records(recs, 1, 2)) == 5


def _stepped_state():
    eng = FT.FoldEngine(dryrun.CFG, B=4, device="cpu")
    return eng.step(eng.init_state(dryrun.POOL[:4]))


def test_split_gather_round_trip():
    state = _stepped_state()
    state["scalar"] = torch.tensor(7)
    blocks = mesh.split_state(state, ["cpu", "cpu"])
    assert len(blocks) == 2
    for b in blocks:
        assert b["pt"].shape[0] == 2 and int(b["scalar"]) == 7
    # contiguous blocks, as a NamedSharding over the 'data' axis
    assert torch.equal(blocks[1]["codes"], state["codes"][2:])
    back = mesh.gather_state(blocks, "cpu")
    assert back.keys() == state.keys()
    for key, v in state.items():
        assert back[key].dtype == v.dtype and torch.equal(back[key], v), key
    # blocks are copies: a step of one leaves the original state alone
    blocks[0]["pt"].fill_(5)
    assert not torch.equal(state["pt"][:2], blocks[0]["pt"])
    with pytest.raises(ValueError, match="multiple"):
        mesh.split_state(state, ["cpu"] * 3)


def test_data_devices(monkeypatch):
    """data_devices never repeats a card and never stands in the CPU:
    without a card even data_devices(1) raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (1, None):
        with pytest.raises(RuntimeError, match="0 CUDA card"):
            mesh.data_devices(n)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = [torch.device("cuda:0"), torch.device("cuda:1")]
    assert mesh.data_devices(2) == mesh.data_devices() == two
    assert mesh.data_devices(1) == two[:1]
    with pytest.raises(RuntimeError, match="2 CUDA card"):
        mesh.data_devices(3)


def _jax_sharded_fold(n):
    """__graft_entry__.dryrun_multichip's sharded fold, on n of the
    suite's virtual CPU devices."""
    cfg = FJ.EngineConfig(**dataclasses.asdict(dryrun.CFG))
    eng = FJ.FoldEngine(cfg, B=n)
    seqs = [dryrun.POOL[i % len(dryrun.POOL)] for i in range(n)]
    state = shard_state(eng.init_state(seqs), data_mesh(n))
    for _ in range(cfg.max_steps):
        if bool(np.asarray(state["done"]).all()):
            break
        state = eng._step(state)
    return {k: np.asarray(v) for k, v in state.items()}


def test_split_fold_matches_jax_sharded_fold(capsys):
    """The dry run's split fold over ["cpu", "cpu"] (which it holds
    bit-equal to the unsplit fold) equals the JAX engine's fold of the
    same batch sharded over a 2-device mesh."""
    got = state_to_numpy(dryrun.dryrun_multichip(2, devices=["cpu", "cpu"]))
    assert "sharded == unsharded bit-exact" in capsys.readouterr().out
    want = _jax_sharded_fold(2)
    for field in dryrun.FIELDS:
        assert np.array_equal(got[field], want[field]), field
    assert got["active"][:, 0].all()


def test_dryrun_checks_its_devices():
    with pytest.raises(ValueError, match="3 devices given for 2"):
        dryrun.dryrun_multichip(2, devices=["cpu"] * 3)
    # the default list is data_devices(n), which raises with too few cards
    with pytest.raises(RuntimeError, match="CUDA card"):
        dryrun.dryrun_multichip(64)


def _sweep(fn, tmp_path, tag, **kw):
    ckpt, beams = tmp_path / f"{tag}.ckpt", tmp_path / f"{tag}.beams"
    stats = {}
    res = fn(_records(), checkpoint=str(ckpt), save_beams=str(beams),
             stats=stats, **ARGS, **kw)
    read = lambda p: [json.loads(line) for line in open(p)]
    return res, read(ckpt), read(beams), stats


def test_split_sweep_matches_one_device_and_jax(tmp_path):
    """Two worker processes on ["cpu", "cpu"], each folding half of the
    bucket at batch 2: results, checkpoint rows (by _idx) and beam rows
    (by name) equal one engine's at batch 4 and the JAX sweep's."""
    one = _sweep(TS.sweep, tmp_path, "one", device="cpu")
    two = _sweep(TS.sweep, tmp_path, "two", devices=["cpu", "cpu"])
    jax_res = _sweep(JS.sweep, tmp_path, "jax", engine="cpu")[0]
    assert two[0] == one[0] == jax_res
    by_idx = lambda rows: sorted(rows, key=lambda r: r["_idx"])
    assert by_idx(two[1]) == by_idx(one[1])
    by_name = lambda rows: sorted(rows, key=lambda r: r["name"])
    assert by_name(two[2]) == by_name(one[2])
    assert one[3]["devices"] == [dict(device="cpu", rows=4, launches=0)]
    # strided shares of 2 rows each; the plain wavefront launches nothing
    assert two[3]["devices"] == [dict(device="cpu", rows=2, launches=0)] * 2
    for key in ("n_fallback", "flag_causes"):
        assert two[3][key] == one[3][key]
    assert two[3]["buckets"]["128"]["batch"] == 4


def test_split_sweep_raises_when_a_worker_fails(monkeypatch):
    """A worker whose engine raises makes sweep() raise with its error;
    nothing is refolded in its place."""
    real = TS.bucket_config
    monkeypatch.setattr(TS, "bucket_config", lambda *a: dataclasses.replace(
        real(*a), K=256, V=4096))
    with pytest.raises(ValueError, match="K=256"):
        TS.sweep(_records(2), devices=["cpu", "cpu"], **ARGS)


def _manifest_argv(main, tmp_path, tag, extra):
    src = tmp_path / "bench.csv"
    with open(src, "w", newline="") as fh:
        csv.writer(fh).writerows(_records(1))
    out = tmp_path / f"{tag}.csv"
    main(["--csv", str(src), "--out", str(out), "--engine", "cpu",
          "-n", "20", "-ms", "3", "--fallback-workers", "1", *extra])
    return json.load(open(f"{out}.manifest.json"))["argv"]


def test_sweep_cli_flags_have_jax_defaults(tmp_path):
    """--devices, --coordinator, --num_processes and --process_id exist
    with the JAX sweep CLI's defaults (read back from each manifest)."""
    keys = ("devices", "coordinator", "num_processes", "process_id")
    want = _manifest_argv(JS.main, tmp_path, "jax", [])
    got = _manifest_argv(TS.main, tmp_path, "port", ["--device", "cpu"])
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys} == dict(
        devices=None, coordinator=None, num_processes=1, process_id=0)


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_sweep_cli_refuses_devices_beside_a_named_device(tmp_path, device):
    """--devices k takes cards 0 to k-1 in place of --device: beside a
    --device that names one, as the launcher gives every process, each
    process of a machine would fold on the same cards, so the CLI stops
    before it reads the CSV."""
    with pytest.raises(SystemExit) as e:
        TS.main(["--csv", str(tmp_path / "absent.csv"), "--out",
                 str(tmp_path / "out.csv"), "--device", device,
                 "--devices", "2"])
    assert e.value.code == 2
    assert not (tmp_path / "out.csv.manifest.json").exists()
