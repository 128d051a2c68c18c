"""AM envelope demodulator on torch tensors (port of
``ka9q_sdr_tpu.models.demod_am``, the reference's am.c).

Per decimated sample (am.c:51-75): envelope = |s|, a one-pole DC (carrier)
tracker, a hang-AGC gain update driven by the DC estimate, and output
(envelope - DC) * gain.  The envelope is one block op, the DC tracker the
parallel scan of ops.iir, and the AGC ops.agc (the Hopper kernel on CUDA).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.agc import AGCParams, AGCState, agc_block, agc_init
from ..ops.iir import one_pole_lowpass

__all__ = ["AMConfig", "AMState", "am_init", "am_demod", "DC_FILTER_COEFF"]

#: Envelope DC tracker coefficient (am.c:34).
DC_FILTER_COEFF = 1e-4


class AMConfig(NamedTuple):
    """Static AM demod configuration (derived from the mode table row and
    the output sample rate, am.c:21-34)."""

    agc: AGCParams
    dc_coeff: float = DC_FILTER_COEFF

    @classmethod
    def make(cls, dsamprate: float, headroom_db: float = -15.0,
             recovery_rate_db_s: float = 50.0,
             hangtime_s: float = 0.0) -> "AMConfig":
        return cls(agc=AGCParams.from_mode(
            headroom_db, recovery_rate_db_s, hangtime_s, 1.0 / dsamprate))

    def to(self, device) -> "AMConfig":
        """Nothing to place: the configuration is host constants."""
        return self


class AMState(NamedTuple):
    dc: torch.Tensor   # float32, envelope DC estimate (am.c:33)
    agc: AGCState


def am_init(batch_shape=(), *, device) -> AMState:
    """Initial state: DC 0, gain 80 dB (am.c:30,33)."""
    return AMState(
        dc=torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device),
        agc=agc_init(80.0, batch_shape, device=device),
    )


def am_demod(cfg: AMConfig, state: AMState,
             baseband: torch.Tensor) -> tuple[AMState, torch.Tensor, dict]:
    """One block (am.c:51-78).

    baseband: (..., n) complex64 slave-filter output.  Returns
    (state, mono_audio, diag) with diag["bb_power"] as am.c:78."""
    sampsq = baseband.real ** 2 + baseband.imag ** 2
    envelope = torch.sqrt(sampsq)
    dc_last, dc = one_pole_lowpass(state.dc, envelope, cfg.dc_coeff)
    new_agc, gain = agc_block(state.agc, dc, cfg.agc)
    audio = (envelope - dc) * gain
    n = baseband.shape[-1]
    diag = {
        "bb_power": torch.sum(sampsq, dim=-1) / (2.0 * n),
        "gain": new_agc.gain,
    }
    return AMState(dc_last, new_agc), audio, diag
