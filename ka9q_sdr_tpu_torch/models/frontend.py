"""Hardware front-end DSP: DC/gain/phase correction, Fs/4 shift, half-band
decimation (funcube.c:299-390, hackrf.c:129-318).

The reference corrects each A/D block inline in the USB callback; the
estimators (DC offset, I/Q gain imbalance, phase error sin(phi)) update
once per block and the per-sample corrections use the previous block's
coefficients — so the whole chain vectorises exactly (host numpy here:
this layer is the I/O shim in front of the device, SURVEY.md §2.3).

Also provides the front-end *simulator* used by the frontend daemon: a
replay source that honors TLV retune commands, models the Mirics MSi001
fractional-N synthesizer quantisation (fcd_actual, funcube.c:526-584), and
reports the resulting actual LO1 — closing the radio->command->status->LO2
loop without hardware.
"""

from __future__ import annotations

import numpy as np

from ..ops.decimate import hb15_coeffs

__all__ = [
    "FrontEndCorrector",
    "fs4_shift",
    "HalfBandCascade",
    "fcd_actual_frequency",
    "rffc5071_freq",
    "max2837_freq",
    "hackrf_actual_frequency",
    "FuncubeAGC",
    "HackRFAGC",
]

#: Estimator rates (funcube.c:65-66): DC ~1e-6/sample, power ~1 s.
DC_ALPHA = 1e-6
POWER_ALPHA_S = 1.0


class FrontEndCorrector:
    """Per-block DC offset removal + I/Q gain balance + phase correction
    (funcube.c:323-390; identical math inline in hackrf.c:129-196)."""

    def __init__(self, blocksize: int, samprate: float):
        self.blocksize = blocksize
        # rate_factor: blocksize / (Power_alpha * samprate) per block
        self.rate_factor = blocksize / (POWER_ALPHA_S * samprate)
        self.dc_alpha = DC_ALPHA
        self.dc = 0.0 + 0.0j
        self.imbalance = 1.0
        self.sinphi = 0.0
        self.in_power = 0.0
        # correction coefficients derived from the estimators
        self.gain_i = np.sqrt(0.5)
        self.gain_q = np.sqrt(0.5)
        self.secphi = 1.0
        self.tanphi = 0.0

    def process(self, iq: np.ndarray) -> np.ndarray:
        """One block of complex samples in, corrected samples out."""
        samp_sum = iq.sum()
        x = iq - self.dc
        i_energy = float(np.sum(x.real**2))
        q_energy = float(np.sum(x.imag**2))
        re = x.real * self.gain_i
        im = x.imag * self.gain_q
        dotprod = float(np.sum(re * im))
        im = self.secphi * im - self.tanphi * re
        out = (re + 1j * im).astype(np.complex64)

        # end-of-block estimator updates (funcube.c:377-391)
        self.dc += self.dc_alpha * (samp_sum - len(iq) * self.dc)
        block_energy = 0.5 * (i_energy + q_energy)
        if block_energy > 0:
            self.in_power = block_energy / len(iq)
            self.imbalance += self.rate_factor * (
                i_energy / max(q_energy, 1e-30) - self.imbalance
            )
            dpn = dotprod / block_energy
            self.sinphi += self.rate_factor * (dpn - self.sinphi)
            self.gain_q = np.sqrt(0.5 * (1.0 + self.imbalance))
            self.gain_i = np.sqrt(0.5 * (1.0 + 1.0 / self.imbalance))
            self.secphi = 1.0 / np.sqrt(
                max(1e-12, 1.0 - self.sinphi * self.sinphi)
            )
            self.tanphi = self.sinphi * self.secphi
        return out


def fs4_shift(iq: np.ndarray, phase: int = 0) -> tuple[np.ndarray, int]:
    """+Fs/4 spectral shift by 90-degree rotations (hackrf.c:270-291):
    multiply sample n by j^(n+phase), dodging the DC spike.  Returns
    (shifted, next_phase) so blocks chain continuously."""
    n = len(iq)
    k = (np.arange(n) + phase) & 3
    rot = np.array([1, 1j, -1, -1j], np.complex64)[k]
    return (iq * rot).astype(np.complex64), (phase + n) & 3


class HalfBandCascade:
    """Power-of-2 decimation cascade with carried overlap per stage
    (numpy mirror of ops.decimate / hackrf.c:295-318): cheap 3-tap (1,2,1)
    stages while the rate is high, 15-tap Goodman/Carey F8 for the final
    octaves; gain-compensated by 0.5 per stage (Filter_atten,
    hackrf.c:469)."""

    def __init__(self, log2_decimate: int, stage_threshold: int = 8):
        self.stages = []
        taps15 = hb15_coeffs().astype(np.float64)
        taps3 = np.array([1.0, 2.0, 1.0])
        for stage in range(log2_decimate - 1, -1, -1):
            taps = taps3 if stage >= stage_threshold else taps15
            self.stages.append(
                {"taps": taps, "state": np.zeros(len(taps) - 1, np.complex128)}
            )
        self.atten = 0.5**log2_decimate

    def process(self, iq: np.ndarray) -> np.ndarray:
        x = iq.astype(np.complex128)
        for st in self.stages:
            taps = st["taps"]
            xx = np.concatenate([st["state"], x])
            st["state"] = xx[-(len(taps) - 1):].copy()
            n_out = len(x) // 2
            # decimating FIR via correlate at stride 2
            y = np.zeros(n_out, np.complex128)
            for j, t in enumerate(taps):
                if t != 0.0:
                    y += t * xx[j : j + 2 * n_out : 2]
            x = y
        return (x * self.atten).astype(np.complex64)


class FuncubeAGC:
    """FUNcube hardware AGC: step LNA/mixer/IF gains to keep the A/D in
    range (doagc, funcube.c:588-620; thresholds AGC_upper=-15 /
    AGC_lower=-50 dBFS, funcube.c:61-62).

    One `step(power_dbfs)` call per invocation (the reference calls doagc
    from the status thread each cycle, funcube.c:753-755).  Stage order is
    the reference's exactly: decreasing — IF down in 10 dB steps to 0,
    then mixer off, then LNA off; increasing — LNA on (24 dB; 7 dB above
    420 MHz, funcube.c:737-741), then mixer on (19 dB), then IF up in
    10 dB steps to 20.  Gains are the dB values the status stream reports.
    """

    UPPER = -15.0
    LOWER = -50.0

    def __init__(self, lna_gain: int = 24, mixer_gain: int = 19,
                 if_gain: int = 0):
        self.lna_gain = lna_gain
        self.mixer_gain = mixer_gain
        self.if_gain = if_gain

    @property
    def total_db(self) -> int:
        return self.lna_gain + self.mixer_gain + self.if_gain

    @property
    def voltage_gain(self) -> float:
        """Analog gain the simulated A/D path applies; the receiver undoes
        it with gain_factor = 10^(-total/20) (radio_status.c:309-316)."""
        return float(10.0 ** (self.total_db / 20.0))

    def step(self, power_dbfs: float) -> bool:
        """One AGC decision from the current A/D power.  Returns True if a
        gain changed (one stage per call, as the hardware command does)."""
        if power_dbfs > self.UPPER:
            if self.if_gain > 0:
                self.if_gain = max(0, self.if_gain - 10)
            elif self.mixer_gain:
                self.mixer_gain = 0
            elif self.lna_gain:
                self.lna_gain = 0
            else:
                return False
            return True
        if power_dbfs < self.LOWER:
            if self.lna_gain == 0:
                self.lna_gain = 24
            elif self.mixer_gain == 0:
                self.mixer_gain = 19
            elif self.if_gain < 20:
                self.if_gain = min(20, self.if_gain + 10)
            else:
                return False
            return True
        return False


class HackRFAGC:
    """HackRF hysteresis AGC (agc thread, hackrf.c:679-749; limits
    Upper=-15 / Lower=-25 dBFS, hackrf.c:58-59), run at 10 Hz.

    change = limit - power (int, C truncation).  Increase: LNA first
    (antenna amp, 14 dB all-or-nothing), then mixer ("lna" API, 8 dB
    steps to 40), then IF (VGA, 2 dB steps to 62).  Decrease: IF first,
    then mixer, then LNA — each using the remaining change budget with
    C integer division (truncation toward zero)."""

    UPPER = -15.0
    LOWER = -25.0

    def __init__(self, lna_gain: int = 14, mixer_gain: int = 24,
                 if_gain: int = 20):
        self.lna_gain = lna_gain
        self.mixer_gain = mixer_gain
        self.if_gain = if_gain

    @property
    def total_db(self) -> int:
        return self.lna_gain + self.mixer_gain + self.if_gain

    @property
    def voltage_gain(self) -> float:
        return float(10.0 ** (self.total_db / 20.0))

    def step(self, power_dbfs: float) -> bool:
        if power_dbfs > self.UPPER:
            change = int(self.UPPER - power_dbfs)   # negative
        elif power_dbfs < self.LOWER:
            change = int(self.LOWER - power_dbfs)   # positive
        else:
            return False
        changed = False
        if change > 0:
            # Increase gain: LNA, then mixer, then IF (hackrf.c:698-720)
            if change >= 14 and self.lna_gain < 14:
                self.lna_gain = 14
                change -= 14
                changed = True
            new_mixer = min(40, self.mixer_gain + 8 * (change // 8))
            if new_mixer != self.mixer_gain:
                change -= new_mixer - self.mixer_gain
                self.mixer_gain = new_mixer
                changed = True
            new_if = min(62, self.if_gain + 2 * (change // 2))
            if new_if != self.if_gain:
                change -= new_if - self.if_gain
                self.if_gain = new_if
                changed = True
        elif change < 0:
            # Reduce gain: IF first, then mixer, then LNA (hackrf.c:721-745)
            # C int division truncates toward zero: -(−change // n) here.
            def trunc_div(a: int, n: int) -> int:
                return -((-a) // n) if a < 0 else a // n

            new_if = max(0, self.if_gain + 2 * trunc_div(change, 2))
            if new_if != self.if_gain:
                change -= new_if - self.if_gain
                self.if_gain = new_if
                changed = True
            new_mixer = max(0, self.mixer_gain + 8 * trunc_div(change, 8))
            if new_mixer != self.mixer_gain:
                change -= new_mixer - self.mixer_gain
                self.mixer_gain = new_mixer
                changed = True
            new_lna = max(0, self.lna_gain + 14 * trunc_div(change, 14))
            if new_lna != self.lna_gain:
                change -= new_lna - self.lna_gain
                self.lna_gain = new_lna
                changed = True
        return changed


#: MSi001 band table: (upper_freq, freq_offset, lo_divider)
#: (funcube.c:536-556; low bands upconvert through a 130 MHz IF).
_MSI001_BANDS = (
    (4_000_000, 130_000_000, 16),
    (8_000_000, 130_000_000, 16),
    (16_000_000, 130_000_000, 16),
    (32_000_000, 130_000_000, 16),
    (75_000_000, 130_000_000, 16),
    (125_000_000, 0, 32),
    (142_000_000, 0, 16),
    (148_000_000, 0, 16),
    (300_000_000, 0, 16),
    (430_000_000, 0, 4),
    (440_000_000, 0, 4),
    (875_000_000, 0, 4),
    (0xFFFFFFFF, 0, 2),
)


def fcd_actual_frequency(f_hz: float) -> float:
    """The FUNcube Pro+ Mirics MSi001 fractional-N synthesizer's *actual*
    tuned frequency for an integer request (fcd_actual, funcube.c:526-584
    — Howard Long's firmware formula, register-exact): the requested
    frequency (plus the band's 130 MHz low-band IF offset) times the
    band's LO divider is decomposed against 4 x 26 MHz into an integer
    divisor, a 12-bit FRAC and a 12-bit AFC register with threshold 3250;
    the quantised result is what the hardware tunes.  The software LO2
    absorbs the difference (radio_status.c:311-316)."""
    if f_hz <= 0:
        return f_hz
    u32_freq = int(round(f_hz)) & 0xFFFFFFFF
    thresh = 3250
    fref = 26_000_000
    for upper, freq_off, lodiv in _MSI001_BANDS:
        if u32_freq < upper:
            break
    fsynth = (u32_freq + freq_off) * lodiv
    u32_int = fsynth // (fref * 4)                       # integer divisor
    frac4096 = ((fsynth << 12) * thresh) // (fref * 4) - (u32_int << 12) * thresh
    frac = frac4096 >> 12                                # 12-bit FRAC
    afc = frac4096 - (frac << 12)                        # 12-bit AFC
    f_act = (4.0 * fref / lodiv) * (
        u32_int + (frac * 4096.0 + afc) / (thresh * 4096.0)
    ) - freq_off
    return f_act


# ---- HackRF synthesizer quantisation (hackrf.c:758-814 — extracted from
# the HackRF firmware's rffc5071.c/max2837.c; the composition below is the
# firmware set_freq() the reference carries at hackrf.c:820-900) ----

_RFFC5071_LO_MAX_MHZ = 5400.0   # hackrf.c:762
_RFFC5071_REF_MHZ = 50.0        # hackrf.c:763


def rffc5071_freq(lo_mhz: int) -> float:
    """Actual RFFC5071/5072 upconverter LO for an integer-MHz request
    (rffc5071_freq, hackrf.c:766-791): the VCO runs at lo*2^n_lo against a
    50 MHz reference through a /2 or /4 feedback divider with a 34-bit
    fractional-N word of which only the top bits survive (>>5 then the
    2^24 denominator) — the request lands on a ~298 Hz grid (fbkdiv 2,
    lodiv 2).  Returns Hz."""
    lo_mhz = int(lo_mhz) & 0xFFFF
    if lo_mhz == 0:
        return 0.0
    n_lo = 0
    x = int(_RFFC5071_LO_MAX_MHZ / lo_mhz) & 0xFFFF   # uint16 truncation
    while x > 1 and n_lo < 5:
        n_lo += 1
        x >>= 1
    lodiv = 1 << n_lo
    fvco = (lodiv * lo_mhz) & 0xFFFF                  # uint16
    fbkdiv = 4 if fvco > 3200 else 2
    # C: ((uint64)fvco << 29) / (fbkdiv * 50.0) — a DOUBLE division
    # truncated back into uint64 (fvco<<29 < 2^53, so the double is exact)
    tmp_n = int((fvco << 29) / (fbkdiv * _RFFC5071_REF_MHZ))
    return (_RFFC5071_REF_MHZ * (tmp_n >> 5) * fbkdiv * 1e6) / (
        lodiv * (1 << 24)
    )


def max2837_freq(freq_hz: int) -> int:
    """MAX2837 transceiver fractional-N *residual* for a Hz request
    (max2837_freq, hackrf.c:793-814): the synthesizer ratio is
    freq/30 MHz with 20 fractional bits filled by truncating binary
    search (strict >), and the function returns the leftover Hz the
    20-bit word cannot express — i.e. actual = freq - max2837_freq(freq),
    at most ~57 Hz low (30e6/2^19)."""
    div_rem = int(freq_hz) % 30_000_000
    div_cmp = 30_000_000
    for _ in range(20):
        div_cmp >>= 1
        if div_rem > div_cmp:
            div_rem -= div_cmp
    return div_rem


def hackrf_actual_frequency(f_hz: float) -> float:
    """The HackRF's *actual* tuned frequency for a request, composing the
    two synthesizer models exactly as the firmware's set_freq does
    (hackrf.c:820-900, carried in the reference for this purpose,
    hackrf.c:758-760 'for future use in determining exact tuning
    frequency'):

    - low path (< 2150 MHz, the SDR range): RFFC5071 upconverts to a
      nominal 2.3-2.65 GHz IF (integer-MHz LO, quantised ~298 Hz), the
      MAX2837 tunes to the quantised difference (truncating 20-bit
      fractional-N, <=57 Hz low) -> actual = f + max2837 residual;
    - bypass (2150-2750 MHz): MAX2837 direct -> actual = f - residual;
    - high path (2750-7250 MHz): RFFC5071 above the MAX2837 IF ->
      actual = f - residual.

    The receiver's LO2 absorbs the difference exactly as for the funcube
    (radio_status.c:311-316)."""
    freq = int(round(f_hz))
    if freq <= 0:
        return float(f_hz)
    freq_mhz = freq // 1_000_000
    if freq_mhz < 2150:
        # low path: IF glides 2650 -> ~2350 MHz as f rises (firmware's
        # max2837_freq_nominal_hz = 2650 MHz - freq/7)
        nominal_hz = 2_650_000_000 - freq // 7
        rffc_mhz = nominal_hz // 1_000_000 + freq_mhz
        real_rffc = rffc5071_freq(rffc_mhz)
        # firmware holds real_RFFC5071_freq_hz in a uint64 (truncated); the
        # analog LO keeps its fraction — received = LO1 - MAX2837_actual
        target = int(real_rffc) - freq
        return real_rffc - (target - max2837_freq(target))
    if freq_mhz < 2750:
        return float(freq - max2837_freq(freq))
    if freq_mhz <= 7250:
        if freq_mhz < 3600:
            nominal_hz = 2_150_000_000 + ((freq - 2_750_000_000) * 60) // 85
        elif freq_mhz < 5100:
            nominal_hz = 2_350_000_000 + (freq - 3_600_000_000) // 5
        else:
            nominal_hz = 2_500_000_000 + (freq - 5_100_000_000) // 9
        rffc_mhz = freq_mhz - nominal_hz // 1_000_000
        real_rffc = rffc5071_freq(rffc_mhz)
        target = freq - int(real_rffc)
        return real_rffc + (target - max2837_freq(target))
    return float(f_hz)   # out of range: firmware refuses; report request
