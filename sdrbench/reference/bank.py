"""The reference bank: one master FFT a block, then each group of
channels (one mode each) channelized and demodulated.

For each group it follows the `rows` it is asked to (every state of
their demodulator, block after block) and returns their audio; for every
channel of the group, which needs no demodulator state, it returns each
block's ``bb_power`` (sum |x|^2 / 2n of the baseband) and, for FM, the
squelch flag (open where the SNR of this block or the one before was
above 2, or in block 0).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .core import Channels, Master, Prec, ingest_f32, ingest_i16, mode_row


class Group:
    def __init__(self, mode: str, freqs, rows, fs, L, M, enable_pl, device,
                 prec: Prec):
        self.row = mode_row(mode)
        self.ch = Channels(freqs, fs, L, M, self.row.low, self.row.high,
                           device, prec)
        self.rows = np.asarray(rows, np.int64)
        self.all = np.arange(len(freqs))
        mod = importlib.import_module(f"{__package__}.{self.row.demod.lower()}")
        self.demod = mod.Demod(self.row, self.ch.dsamprate, self.ch.L_dec,
                               self.ch.M_dec, len(self.rows), enable_pl,
                               device, prec)
        self.snr_prev = None

    def step(self, spec: torch.Tensor, b: int) -> dict:
        bb = self.ch.baseband(spec, self.rows, b)
        audio, diag = self.demod.step(bb)
        power = self.ch.magnitude2(spec, self.all)
        out = {"audio": audio, "rows": self.rows,
               "bb_power": power.sum(dim=-1) / (2.0 * power.shape[-1])}
        out.update({k: v for k, v in diag.items() if k != "squelch_open"})
        if self.row.demod == "FM":
            from .fm import SNR_THRESH, FM

            snr = FM.snr(power)
            prev = (torch.full_like(snr, np.inf) if self.snr_prev is None
                    else self.snr_prev)
            out["squelch_open"] = (snr > SNR_THRESH) | (prev > SNR_THRESH)
            self.snr_prev = snr
        return out


class RefBank:
    """groups: [(mode, freqs, rows)]; ingest "i16" ((L, 2) int16 blocks)
    or "f32" ((L, 2) float blocks)."""

    def __init__(self, groups, fs: float, L: int, M: int, *, enable_pl=False,
                 ingest="i16", device="cpu", prec: Prec | None = None):
        self.prec = prec or Prec("float64")
        self.device = torch.device(device)
        self.master = Master(L, M, self.device, self.prec)
        self.groups = [Group(m, f, r, fs, L, M, enable_pl, self.device,
                             self.prec) for m, f, r in groups]
        self.ingest = ingest_i16 if ingest == "i16" else ingest_f32
        self.block = 0

    def step(self, x) -> list[dict]:
        """One wideband block; returns each group's outputs."""
        x = torch.as_tensor(x, device=self.device)
        spec = self.master.step(self.ingest(x, self.prec))
        out = [g.step(spec, self.block) for g in self.groups]
        self.block += 1
        return out
