"""The port must import and run where jax is not installed (the machine
with the card has none): import every port module and run two blocks of a
tiny FM+PL bank on the CPU in a subprocess where ``import jax`` fails."""

import subprocess
import sys
from pathlib import Path

_SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["jaxlib"] = None
import numpy as np
import torch
import ka9q_sdr_tpu_torch
from ka9q_sdr_tpu_torch import interop
from ka9q_sdr_tpu_torch.models.bank import ChannelBank, make_bank_config
from ka9q_sdr_tpu_torch.ops import _kernels, ffill

fs, L = 1.536e6, 30720
cfg = make_bank_config(2, "FM", samprate=fs, L=L, M=34817, enable_pl=True)
bank = ChannelBank(cfg, [-2e5, 3e5], device="cpu")
x = np.zeros((L, 2), np.int16)
for _ in range(2):
    pcm, diag = bank.process_i16_pcm(x)
assert pcm.shape == (2, 960) and pcm.dtype == torch.int16
assert ffill.launches == 0
assert not any(m.split(".")[0] in ("jax", "jaxlib")
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""


def test_port_runs_without_jax():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
