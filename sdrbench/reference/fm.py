"""FM demodulation, the reference (ka9q-radio's fm.c).

Per block of n samples at 48 kHz, for each channel:

1. squelch: the SNR from the amplitude's mean and spread,
   snr = max(avg^2 / (2 var) - 1, 0) with avg = mean|x| / sqrt 2 and
   var = mean((|x| - mean|x|)^2) / 2; a channel is open while the SNR was
   above 2 in this block or the one before (the flush block), and in a
   cold bank's first block;
2. the discriminator with threshold extension, sample by sample: a sample
   whose power is above 0.55^2 avg^2 is strong; a strong sample's output is
   arg(x[t] conj(x_prev)), x_prev the last strong sample (1 before any,
   0 after a shut block), a weak sample repeats the last strong output;
   a shut channel's samples are 0;
3. the audio: the discriminator samples through a real overlap-save
   filter at 48 kHz, a 300-6000 Hz 1/f de-emphasis (fm.c:51-67), times the
   gain headroom / pi * 48000 / bandwidth;
4. the PL tone (pltask, fm.c:189-285): the same samples through a < 300 Hz
   low-pass decimated to 1.5 kHz, into a ring of 16384; every 512 new
   samples the peak of the ring's spectrum (bins 1-8191) sets the tone,
   (bin + 1) * 1500/16384 Hz, when it holds 1% of the energy and lies in
   67-255 Hz, NaN when it holds less.

The sample-by-sample rule of step 2 is computed as its closed form (the
last strong index before each sample), which is the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import Prec, design_real

SNR_THRESH = 2.0
BLANK = 0.55
PL_DECIMATE = 32
PL_SIZE = 16384
PL_EVERY = 512


def _last_strong(strong: torch.Tensor) -> torch.Tensor:
    """Index of the last strong sample at or before each sample, -1 where
    there is none."""
    n = strong.shape[-1]
    i = torch.arange(n, device=strong.device)
    return torch.cummax(torch.where(strong, i, torch.full_like(i, -1)),
                        dim=-1).values


class FM:
    """The FM demodulator's state and step for a batch of channels."""

    def __init__(self, row, dsamprate: float, L_dec: int, M_dec: int,
                 n: int, enable_pl: bool, device, prec: Prec,
                 headroom_db: float = -15.0, beta: float = 3.0):
        self.p = prec
        self.dev = device
        self.fs = dsamprate
        self.L_dec = L_dec
        self.gain = (10.0 ** (headroom_db / 20.0) / np.pi * dsamprate
                     / abs(row.high - row.low))
        self.flat = row.flat
        self.AN = AN = L_dec + M_dec - 1
        self.M_dec = M_dec
        f = np.arange(AN // 2 + 1) * dsamprate / AN
        deemph = np.where((f >= 300.0) & (f <= 6000.0),
                          10.0 / AN * 300.0 / np.maximum(f, 1.0), 0.0)
        self.audio_resp = self._t(design_real(AN, M_dec, deemph, beta))
        self.pl = enable_pl and not row.flat
        if self.pl:
            pl_n = AN // PL_DECIMATE
            self.pl_n, self.pl_l = pl_n, L_dec // PL_DECIMATE
            lowpass = np.where((f[:pl_n // 2 + 1] > 0)
                               & (f[:pl_n // 2 + 1] < 300.0), 1.0, 0.0)
            self.pl_resp = self._t(design_real(
                pl_n, pl_n - self.pl_l + 1, lowpass, 2.0))
            self.ring = torch.zeros((n, PL_SIZE), dtype=prec.real,
                                    device=device)
            self.counter = torch.zeros(n, dtype=torch.int64, device=device)
            self.plfreq = torch.full((n,), float("nan"), dtype=prec.real,
                                     device=device)
        self.prev = torch.ones(n, dtype=prec.cplx, device=device)
        self.last = torch.zeros(n, dtype=prec.real, device=device)
        self.snr_prev = torch.full((n,), np.inf, dtype=prec.real,
                                   device=device)    # block 0 is open
        self.audio_in = torch.zeros((n, M_dec - 1), dtype=prec.real,
                                    device=device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return self.p.q(torch.as_tensor(a, device=self.dev).to(self.p.cplx))

    @staticmethod
    def snr(power: torch.Tensor) -> torch.Tensor:
        """The squelch's SNR of each row of |x|^2."""
        amp = torch.sqrt(power)
        mean = amp.mean(dim=-1)
        avg = mean / np.sqrt(2.0)
        var = ((amp - mean[:, None]) ** 2).mean(dim=-1) / 2.0
        return torch.clamp_min(avg * avg / torch.clamp_min(2.0 * var, 1e-300)
                               - 1.0, 0.0)

    def step(self, bb: torch.Tensor):
        """One block; bb (n, L_dec) complex.  Returns (audio (n, L_dec)
        real, diag {"squelch_open", "plfreq"})."""
        p = self.p
        power = bb.real ** 2 + bb.imag ** 2
        snr = self.snr(power)
        open_ = (snr > SNR_THRESH) | (self.snr_prev > SNR_THRESH)
        self.snr_prev = snr
        avg = torch.sqrt(power).mean(dim=-1) / np.sqrt(2.0)
        strong = power > (BLANK ** 2 * avg * avg)[:, None]
        last = _last_strong(strong)
        n = bb.shape[-1]
        # the strong sample before each sample (strictly), or the carry
        before = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]],
                           dim=-1)
        src = torch.gather(bb, 1, before.clamp(min=0))
        ref = torch.where(before >= 0, src, self.prev[:, None])
        disc = p.q(torch.angle(bb * torch.conj(ref)))
        dsrc = torch.gather(disc, 1, before.clamp(min=0))
        held = torch.where(before >= 0, dsrc, self.last[:, None])
        samples = torch.where(strong, disc, held)
        end = last[:, -1]
        new_prev = torch.where(end >= 0, bb[torch.arange(len(end)),
                                            end.clamp(min=0)], self.prev)
        new_last = torch.where(end >= 0, disc[torch.arange(len(end)),
                                              end.clamp(min=0)], self.last)
        zero = torch.zeros_like
        self.prev = torch.where(open_, new_prev, zero(new_prev))
        self.last = torch.where(open_, new_last, zero(new_last))
        samples = torch.where(open_[:, None], samples, zero(samples))
        buf = torch.cat([self.audio_in, samples], dim=-1)
        self.audio_in = buf[:, n:]
        spec = p.q(torch.fft.rfft(buf, dim=-1))
        if self.flat:
            audio = samples
        else:
            audio = p.q(torch.fft.irfft(spec * self.audio_resp[None, :],
                                        self.AN, dim=-1)
                        * self.AN)[:, self.AN - self.L_dec:] * self.gain
            audio = p.q(audio)
        diag = {"squelch_open": open_}
        if self.pl:
            h = self.pl_n // 2 + 1
            pl = p.q(torch.fft.irfft(spec[:, :h] * self.pl_resp[None, :],
                                     self.pl_n, dim=-1)
                     * self.pl_n)[:, self.pl_n - self.pl_l:]
            k = pl.shape[-1]
            self.ring = torch.cat([self.ring[:, k:], pl], dim=-1)
            self.counter += k
            due = self.counter >= PL_EVERY
            if bool(due.any()):
                self.plfreq = torch.where(due, self._measure(),
                                          self.plfreq)
                self.counter = torch.where(due, zero(self.counter),
                                           self.counter)
            diag["plfreq"] = self.plfreq.clone()
        return audio, diag

    def _measure(self) -> torch.Tensor:
        s = self.p.q(torch.fft.rfft(self.ring, dim=-1))
        e = (s.real ** 2 + s.imag ** 2)[:, 1:PL_SIZE // 2]
        peak_e, peak = torch.max(e, dim=-1)
        f = (peak + 1).to(e.dtype) * (self.fs / PL_DECIMATE / PL_SIZE)
        strong = peak_e > 0.01 * e.sum(dim=-1)
        in_range = (f > 67.0) & (f < 255.0)
        return torch.where(strong, torch.where(in_range, f, self.plfreq),
                           torch.full_like(f, float("nan")))


Demod = FM
