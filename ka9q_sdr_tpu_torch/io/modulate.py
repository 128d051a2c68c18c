"""Test modulator / signal generator (modulate.c), on torch tensors.

Port of ``ka9q_sdr_tpu.io.modulate``: real baseband audio (48 kHz) is 4x
zero-stuff upsampled, filtered through the overlap-save engine with an
analytic (SSB) or double-sideband bandpass response (a REAL master and a
REAL -> COMPLEX slave at decimate 1), given an optional carrier, and
upconverted with a swept-capable NCO: the I/Q test vectors that close the
loop on the receiver (modulate -> receiver).

AM / USB / LSB / AME presets match modulate.c:75-95; the gain bookkeeping
(4/N for the FFT round trip and 4x upsampling, modulate.c:118) matches
exactly.  It runs on the device its caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fftfilt import (
    FilterType,
    MasterSpec,
    SlaveSpec,
    master_execute,
    master_init,
    slave_execute,
)
from ..ops.nco import osc_block, osc_init, set_osc
from ..ops.window import window_filter

__all__ = ["MODULATE_PRESETS", "Modulator"]

#: (carrier, low, high) per mode (modulate.c:75-95).
MODULATE_PRESETS = {
    "am": (1.0, -5000.0, +5000.0),
    "usb": (0.0, 0.0, +3000.0),
    "lsb": (0.0, -3000.0, 0.0),
    "ame": (1.0, 0.0, +3000.0),   # enhanced AM: USB + carrier (CHU)
}

UPSAMPLE = 4
BLOCKSIZE = 960   # modulate.c BLOCKSIZE (after 4x upsample = 240 in)


class Modulator:
    """Real audio blocks in (rate samprate/4), complex I/Q blocks out
    (rate samprate).  Defaults mirror modulate.c: 192 kHz out, 48 kHz in."""

    def __init__(
        self,
        mode: str = "am",
        frequency: float = 48000.0,   # IF carrier, Hz (modulate.c:43)
        amplitude_db: float = -20.0,
        sweep_hz_s: float = 0.0,
        samprate: int = 192000,
        blocksize: int = BLOCKSIZE,
        *,
        device,
    ):
        carrier, low, high = MODULATE_PRESETS[mode.lower()]
        self.carrier = carrier
        self.samprate = samprate
        self.device = torch.device(device)
        L = blocksize
        M = blocksize + 1
        N = L + M - 1
        self.L = L
        # brick-wall response at the *output* rate (modulate.c:115-129)
        i = np.arange(N)
        f = samprate * (i / N)
        f = np.where(f > samprate / 2, f - samprate, f)
        gain = 4.0 / N   # FFT scaling + 4x upsampling (modulate.c:118)
        resp = np.where((f >= low) & (f <= high), gain, 0.0).astype(np.complex128)
        resp = window_filter(L, M, resp, 3.0).astype(np.complex64)

        self.master = MasterSpec(L, M, FilterType.REAL)
        self.slave = SlaveSpec(self.master, 1, FilterType.COMPLEX)
        self.response = resp
        self._resp = torch.as_tensor(resp, device=self.device)
        self.overlap = master_init(self.master, device=self.device)
        self.amplitude = 10.0 ** (amplitude_db / 20.0)
        self.osc = set_osc(
            osc_init(device=self.device),
            frequency / samprate,
            sweep_hz_s / (samprate * samprate),
        )

    def process(self, audio) -> torch.Tensor:
        """audio: (L/4,) float in [-1,1] at samprate/4 (numpy or tensor).
        Returns (L,) complex64 I/Q at samprate on the modulator's device."""
        if len(audio) != self.L // UPSAMPLE:
            raise ValueError(f"need {self.L // UPSAMPLE} samples")
        up = torch.zeros(self.L, dtype=torch.float32, device=self.device)
        # zero-stuff (modulate.c:140-145)
        up[::UPSAMPLE] = torch.as_tensor(audio, dtype=torch.float32,
                                         device=self.device)
        self.overlap, fd = master_execute(self.master, self.overlap, up)
        bb = slave_execute(self.slave, fd, self._resp) + complex(self.carrier)
        self.osc, lo = osc_block(self.osc, self.L)
        return bb * lo * float(np.float32(self.amplitude))

    def to_int16(self, iq) -> bytes:
        """Interleaved s16 I/Q as iqplay expects (modulate.c:159-163)."""
        iq = np.asarray(iq.cpu() if isinstance(iq, torch.Tensor) else iq)
        out = np.empty(2 * len(iq), np.int16)
        out[0::2] = np.clip(iq.real * 32767, -32768, 32767).astype(np.int16)
        out[1::2] = np.clip(iq.imag * 32767, -32768, 32767).astype(np.int16)
        return out.tobytes()
