"""The port's fold CLI against the JAX package's CLI with its CPU engine.

Both print the same protocol (the reference CLI's); the port folds with
its FoldEngine on device="cpu", the reference with the sequential CPU
parity engine, so their standard outputs must be equal byte for byte.
"""

import pytest
import torch

from rafft_tpu.cli import fold_cli as JCLI
from rafft_tpu_torch.cli import fold_cli as TCLI

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
    with pytest.raises(SystemExit) as exc:
        TCLI.main(["--device", "cpu", "-s", README_SEQ, "-gc", "2.5"])
    assert exc.value.code not in (0, None)
    assert "FFT" in str(exc.value.code)
