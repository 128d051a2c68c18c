"""Linear demodulation, the reference (ka9q-radio's linear.c): SSB, CW,
IQ and the coherent modes with their carrier PLL.

Per block of n samples at 48 kHz, for each channel:

1. with the PLL (linear.c:129-246):
   - the acquisition ring: the baseband (squared for ``square`` modes)
     through a cascade of 15-tap half-band decimators (decimate.c) down to
     the largest power-of-two rate, at most /64, that divides the block and
     stays at least 5x the search band, times 2^-stages; the ring holds
     65536 / decimation samples (1.37 s);
   - the lock detector: a count that moves by +n when the previous block's
     SNR was 3 dB or more and by -n otherwise, clamped to +-1 s of
     samples; lock at the top, unlock at the bottom;
   - while unlocked, once more than half a ring has come in since the last
     search: the ring's FFT, the strongest bin within +-300 Hz (+-600 Hz
     squared, halved) sets the coarse offset; a new offset zeroes the loop
     integrator;
   - the baseband mixed by the coarse and the fine oscillators (phase
     continuous); the block's mean phase (halved for square) drives a
     second-order loop of 1 Hz natural frequency, critically damped, which
     sets the fine oscillator's frequency for the next block;
2. the hang AGC, sample by sample on |x| (linear.c:251-281): if
   |x| * gain > headroom, gain = headroom / |x| and the hang count
   restarts; else while hanging hold, else gain *= the recovery factor;
3. the post-AGC shift (CW's offset), then I (mono) or (I, Q).

The AGC (step 2) runs on the host in float64 numpy, in closed form over
the block (``agc_gains``), the same function as the sample-by-sample
recurrence (``agc_serial``, which takes the rows the closed form cannot).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import Prec

PLL_FFT = 1 << 16
SNR_THRESH_DB = 3.0
SEARCH_HZ = 300.0
HB15 = np.array([-6.0, 0, 33.0, 0, -116.0, 0, 490.0, 802.0, 490.0, 0,
                 -116.0, 0, 33.0, 0, -6.0]) / 802.0


def acq_decimation(dsamprate: float, n: int, square: bool) -> int:
    """The acquisition ring's decimation (a power of two)."""
    band = (2.0 if square else 1.0) * SEARCH_HZ
    d = 1
    while d * 2 <= 64 and n % (d * 2) == 0 and dsamprate / (d * 2) >= 5 * band:
        d *= 2
    return d


def agc_serial(amp, g, hang, H, r, hm):
    """The hang AGC sample by sample: (gains, gain, hang)."""
    out = np.empty_like(amp)
    g, hang = g.copy(), hang.copy()
    with np.errstate(divide="ignore"):
        clamp = H / amp
    if hm == 0:                 # no hang: clamp, else grow (fewer steps)
        over = np.empty(g.shape, bool)
        lev_g = np.empty_like(g)
        for t in range(amp.shape[1]):
            np.multiply(amp[:, t], g, out=lev_g)
            np.greater(lev_g, H, out=over)
            np.multiply(g, r, out=g)
            np.copyto(g, clamp[:, t], where=over)
            out[:, t] = g
        return out, g, hang
    for t in range(amp.shape[1]):
        over = amp[:, t] * g > H
        g = np.where(over, clamp[:, t], np.where(hang > 0, g, g * r))
        hang = np.where(over, hm, np.maximum(hang - 1, 0))
        out[:, t] = g
    return out, g, hang


def agc_gains(amp, g0, h0, H, r, hm):
    """The hang AGC over a block in closed form, the same function as
    ``agc_serial``: (gains (n, T), gain, hang).

    A clamp at sample s sets the gain to C_s = H / |x_s|; with no clamp the
    gain holds while the hang runs and then grows by r a sample.  The
    newest clamp's path lies below every older one, so:

    - with no hang (hm = 0) the gain is min(g0 r^(t+1), min over s <= t of
      C_s r^(t-s)), a running minimum, except where some C_t falls in
      [G_(t-1), G_(t-1) r): there the minimum would take C_t where the
      recurrence, not clamping, grows; such rows are run sample by sample;
    - with a hang longer than the block, the gain follows the start's path
      (hold h0 samples, then grow) up to the first clamp and then holds
      the running minimum of C;
    - any other hang runs sample by sample.
    """
    n, T = amp.shape
    if n == 0:
        return amp.copy(), g0, h0
    t = np.arange(T)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        C = H / amp
        if hm == 0:
            lr = np.log(r)
            m = np.minimum.accumulate(np.log(C) - lr * t, axis=1) + lr * t
            G = np.exp(np.minimum(np.log(g0)[:, None] + lr * (t + 1), m))
            prev = np.concatenate([g0[:, None], G[:, :-1]], axis=1)
            near = (C >= prev * (1 - 1e-12)) & (C < prev * r * (1 + 1e-12))
            odd = near.any(axis=1)
            h = np.zeros_like(h0)
            if odd.any():
                # the closed form holds up to a row's first such sample:
                # from there on the recurrence, sample by sample
                t0 = int(np.argmax(near[odd], axis=1).min())
                start = G[odd, t0 - 1] if t0 else g0[odd]
                G[odd, t0:], _, _ = agc_serial(amp[odd, t0:], start,
                                               h0[odd], H, r, hm)
                odd[:] = False
        elif hm >= T:
            ramp = np.maximum(0, t[None, :] - h0[:, None] + 1)
            path = g0[:, None] * r ** ramp
            prev = np.concatenate([g0[:, None], path[:, :-1]], axis=1)
            hit = C < prev
            first = np.where(hit.any(axis=1), np.argmax(hit, axis=1), T)
            after = t[None, :] >= first[:, None]
            held = np.minimum.accumulate(np.where(after, C, np.inf), axis=1)
            G = np.where(after, held, path)
            gp = np.concatenate([g0[:, None], G[:, :-1]], axis=1)
            clamp = C < gp
            last = np.where(clamp.any(axis=1),
                            T - 1 - np.argmax(clamp[:, ::-1], axis=1), -1)
            h = np.where(last >= 0, hm - (T - 1 - last),
                         np.maximum(h0 - T, 0))
            odd = np.any(np.abs(C / gp - 1) < 1e-12, axis=1) | \
                ~np.isfinite(G).all(axis=1)
        else:
            odd = np.ones(n, bool)
            G, h = np.empty_like(amp), h0.copy()
    if odd.any():
        G[odd], g_odd, h_odd = agc_serial(amp[odd], g0[odd], h0[odd], H, r,
                                          hm)
        h = h.copy()
        h[odd] = h_odd
    return G, G[:, -1].copy(), h


class Linear:
    """The linear demodulator's state and step for a batch of channels."""

    def __init__(self, row, dsamprate: float, L_dec: int, M_dec: int,
                 n: int, enable_pl: bool, device, prec: Prec,
                 headroom_db: float = -15.0, beta: float = 3.0):
        del M_dec, enable_pl, beta
        if row.isb:
            raise NotImplementedError("the reference has no ISB combine")
        self.p, self.dev, self.row = prec, device, row
        self.n_out = L_dec
        self.T = 1.0 / dsamprate
        self.headroom = 10.0 ** (headroom_db / 20.0)
        self.recovery = 10.0 ** (row.recovery * self.T / 20.0)
        self.hangmax = int(row.hang / self.T)
        self.gain = np.full(n, 1e5)                  # 100 dB (linear.c:39)
        self.hang = np.zeros(n, np.int64)
        self.shift_f = row.shift / dsamprate
        self.shift_ph = 0.0
        if row.pll:
            self.decim = acq_decimation(dsamprate, L_dec, row.square)
            self.ring_n = PLL_FFT // self.decim
            self.binsize = 1.0 / (PLL_FFT * self.T)
            self.nb = round((2 if row.square else 1) * SEARCH_HZ
                            / self.binsize)
            self.limit = round(1.0 / self.T)
            stages = int(np.log2(self.decim))
            z = dict(dtype=prec.cplx, device=device)
            self.hb = [torch.zeros((n, 14), **z) for _ in range(stages)]
            self.ring = torch.zeros((n, self.ring_n), **z)
            self.filled = torch.zeros(n, dtype=torch.int64, device=device)
            r = dict(dtype=prec.real, device=device)
            self.count = torch.zeros(n, dtype=torch.int64, device=device)
            self.lock = torch.zeros(n, dtype=torch.bool, device=device)
            self.snr_prev = torch.zeros(n, **r)
            self.delta_f = torch.zeros(n, **r)
            self.integ = torch.zeros(n, **r)
            self.coarse_ph = torch.zeros(n, **r)
            self.coarse_f = torch.zeros(n, **r)
            self.fine_ph = torch.zeros(n, **r)
            self.fine_f = torch.zeros(n, **r)
            nat = 2.0 * np.pi
            tau1 = 2.0 * np.pi / (nat * nat)
            self.ig = 1.0 / tau1
            self.pg = (2.0 / np.sqrt(2.0) / nat) / tau1

    def _decimate(self, x: torch.Tensor) -> torch.Tensor:
        taps = torch.as_tensor(HB15, dtype=self.p.real, device=self.dev)
        for i, carry in enumerate(self.hb):
            xx = torch.cat([carry, x], dim=-1)
            self.hb[i] = xx[:, x.shape[-1]:]
            m = x.shape[-1] // 2
            win = xx.unfold(-1, 15, 2)[:, :m]          # (n, m, 15)
            x = self.p.q((win * taps.to(x.dtype)).sum(dim=-1))
        return x * (0.5 ** len(self.hb))

    def _osc(self, ph: torch.Tensor, f: torch.Tensor):
        i = torch.arange(self.n_out, dtype=self.p.real, device=self.dev)
        cyc = ph[:, None] + f[:, None] * i[None, :]
        lo = torch.polar(torch.ones_like(cyc), 2.0 * np.pi * cyc)
        return torch.remainder(ph + f * self.n_out, 1.0), lo

    def _pll(self, bb: torch.Tensor):
        p = self.p
        n = bb.shape[-1]
        feed = bb * bb if self.row.square else bb
        if self.hb:
            feed = self._decimate(feed)
        k = feed.shape[-1]
        self.ring = torch.cat([self.ring[:, k:], feed], dim=-1)
        self.filled = torch.clamp_max(self.filled + k, self.ring_n)
        up = self.snr_prev >= 10.0 ** (SNR_THRESH_DB / 10.0)
        self.count = torch.clamp(torch.where(up, self.count + n,
                                             self.count - n),
                                 -self.limit, self.limit)
        self.lock = torch.where(self.count >= self.limit,
                                torch.ones_like(self.lock),
                                torch.where(self.count <= -self.limit,
                                            torch.zeros_like(self.lock),
                                            self.lock))
        due = (~self.lock) & (self.filled > self.ring_n // 2)
        if bool(due.any()):
            s = p.q(torch.fft.fft(self.ring, dim=-1))
            e = s.real ** 2 + s.imag ** 2
            idx = torch.arange(-self.nb, self.nb + 1,
                               device=self.dev) % self.ring_n
            w = e[:, idx]
            df = self.binsize * (torch.argmax(w, dim=-1) - self.nb).to(p.real)
            if self.row.square:
                df = df / 2.0
            new = due & (w.amax(dim=-1) > 0) & (df != self.delta_f)
            self.delta_f = torch.where(new, df, self.delta_f)
            self.integ = torch.where(new, torch.zeros_like(self.integ),
                                     self.integ)
            self.coarse_f = torch.where(new, -self.T * df, self.coarse_f)
            self.filled = torch.where(due, torch.zeros_like(self.filled),
                                      self.filled)
        self.coarse_ph, lo_c = self._osc(self.coarse_ph, self.coarse_f)
        self.fine_ph, lo_f = self._osc(self.fine_ph, self.fine_f)
        mixed = p.q(bb * lo_c.to(p.cplx) * lo_f.to(p.cplx))
        ss = mixed * mixed if self.row.square else mixed
        cphase = torch.angle(ss.sum(dim=-1))
        if self.row.square:
            cphase = cphase / 2.0
        self.integ = self.integ + cphase * (self.T * n)
        self.fine_f = -(self.ig * self.integ + self.pg * cphase) * self.T
        return mixed

    def agc(self, amp: np.ndarray) -> np.ndarray:
        """The hang AGC over (n, T) amplitudes; returns the gains."""
        out, self.gain, self.hang = agc_gains(
            amp, self.gain, self.hang, self.headroom, self.recovery,
            self.hangmax)
        return out

    def step(self, bb: torch.Tensor):
        """One block; bb (n, L_dec) complex.  Returns (audio (n, L_dec) or
        (n, L_dec, 2), diag {"pll_lock"} with the PLL)."""
        p = self.p
        diag = {}
        if self.row.pll:
            bb = self._pll(bb)
            sig = (bb.real ** 2).sum(dim=-1)
            noise = (bb.imag ** 2).sum(dim=-1)
            self.snr_prev = torch.where(
                noise > 0, torch.clamp_min(sig / noise - 1.0, 0.0),
                torch.full_like(noise, np.inf))
            diag["pll_lock"] = self.lock.clone()
        amp = torch.sqrt(bb.real ** 2 + bb.imag ** 2)
        gains = self.agc(amp.double().cpu().numpy())
        out = bb * p.q(torch.as_tensor(gains, device=self.dev).to(p.real))
        if self.shift_f:
            i = np.arange(self.n_out)
            lo = np.exp(2j * np.pi * (self.shift_ph + self.shift_f * i))
            self.shift_ph = (self.shift_ph + self.shift_f * self.n_out) % 1.0
            out = out * torch.as_tensor(lo, device=self.dev).to(p.cplx)
        out = p.q(out)
        if self.row.channels == 1:
            return out.real, diag
        return torch.stack([out.real, out.imag], dim=-1), diag


Demod = Linear
