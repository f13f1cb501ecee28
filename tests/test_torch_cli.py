"""The port's fold CLI against the JAX package's CLI with its CPU engine.

Both print the same protocol (the reference CLI's); the port folds with
its FoldEngine on device="cpu", the reference with the sequential CPU
parity engine, so their standard outputs must be equal byte for byte.
"""

import dataclasses

import pytest
import torch

from rafft_tpu.cli import fold_cli as JCLI
from rafft_tpu_torch.cli import fold_cli as TCLI
from rafft_tpu_torch.engine import fold_torch as FT

# the suite runs in several worker processes at once: one intra-op
# thread per process keeps torch from oversubscribing the cores
torch.set_num_threads(1)

README_SEQ = ("GGGUUUGCGGUGUAAGUGCAGCCCGUCUUACACCGUGCGGCACAGGCACUAGUACUGAUGU"
              "CGUAUACAGGGCUUUUGACAU")


@pytest.mark.parametrize("flags", [["-ms", "5", "--traj"],
                                   ["-ms", "5", "--bench"]])
def test_cli_stdout_matches_reference(flags, capsys):
    JCLI.main(["-s", README_SEQ, *flags])
    want = capsys.readouterr().out
    TCLI.main(["--device", "cpu", "-s", README_SEQ, *flags])
    got = capsys.readouterr().out
    assert want.startswith(README_SEQ)
    assert got == want


def test_cli_non_integral_weights_exit_nonzero(capsys):
    """Non-integral weights made the port's CLI exit nonzero before the
    FFT correlation was ported; the same call now prints what the
    reference CLI prints."""
    flags = ["-s", README_SEQ, "-gc", "2.5"]
    JCLI.main(flags)
    want = capsys.readouterr().out
    TCLI.main(["--device", "cpu", *flags])
    assert capsys.readouterr().out == want and len(want.splitlines()) == 2


NON_INTEGRAL = ["-gc", "2.5", "-au", "1.7", "-gu", "0.8"]


@pytest.mark.parametrize("flags,port_flags", [
    (["-ms", "5", "--nono"], []),
    (["-ms", "3", "--nono", "--bench"], []),
    (["-ms", "5", "--traj"], ["--engine", "cpu"]),
    (["-ms", "5", "--bench", *NON_INTEGRAL], ["--engine", "cpu"]),
    (["-ms", "5", "--traj", *NON_INTEGRAL], ["--engine", "torch"]),
    (["-ms", "5", "--nono", *NON_INTEGRAL], []),
])
def test_cli_engines_and_weights_match_reference(flags, port_flags, capsys):
    """--nono, --engine cpu and non-integral weights: stdout equal to the
    reference CLI's (whose default engine is its CPU oracle)."""
    JCLI.main(["-s", README_SEQ, *flags])
    want = capsys.readouterr().out
    TCLI.main(["--device", "cpu", "-s", README_SEQ, *flags, *port_flags])
    got = capsys.readouterr().out
    assert got == want
    if "--nono" in flags:
        assert "Full Tree" in got


def test_cli_engine_choices():
    args = TCLI.parse_arguments(["-s", "ACGU"])
    assert args.engine == "torch" and not args.nono
    assert TCLI.parse_arguments(["-s", "ACGU", "--engine", "cpu"]).engine == "cpu"
    with pytest.raises(SystemExit):
        TCLI.parse_arguments(["-s", "ACGU", "--engine", "jax"])


@pytest.mark.parametrize("flags", [["-ms", "5"], ["-ms", "5", "--traj"]])
def test_cli_default_refolds_a_flagged_fold(flags, monkeypatch, capsys):
    """With a seen-set of 24 slots the engine flags the fold; the port's
    default engine answers it with the CPU parity engine, so its stdout
    equals the reference CLI's default (whose engine is that oracle)."""
    seq = README_SEQ[:46]
    cut = FT.fold_one_config
    monkeypatch.setattr(FT, "fold_one_config", lambda *a: dataclasses.replace(
        cut(*a), S=24))
    assert FT._fold_one(seq, 100, 5, 1000, 3, 0.0, False, 37.0, 3.0, 2.0, 1.0,
                        "cpu")[1] & FT.FLAG_SEEN
    JCLI.main(["-s", seq, *flags])
    want = capsys.readouterr().out
    before = FT.REFOLDS
    TCLI.main(["--device", "cpu", "-s", seq, *flags])
    assert capsys.readouterr().out == want
    assert FT.REFOLDS == before + 1


@pytest.mark.parametrize("name", ["rafft-torch", "rafft-kin-torch"])
def test_console_script_resolves(name):
    """setup.py's console scripts for the port's CLIs (the counterparts
    of bin/rafft and bin/rafft_kin) name a callable."""
    import ast
    import importlib
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "setup.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    kw = next(k for n in ast.walk(tree) if isinstance(n, ast.Call)
              for k in n.keywords if k.arg == "entry_points")
    scripts = dict(s.split(" = ") for s in
                   ast.literal_eval(kw.value)["console_scripts"])
    module, attr = scripts[name].split(":")
    assert module.startswith("rafft_tpu_torch.cli.")
    assert callable(getattr(importlib.import_module(module), attr))
