"""Parity of the port's FM demodulator (threshold extension, squelch,
de-emphasis and the PL-tone chain) against the JAX package on the CPU.

Four channels at the 48 kHz output rate (L_dec 960, M_dec 1089, the
serving geometry's per-channel shape), 24 blocks, state carried: FM with a
100 Hz PL tone, FM with a 151.4 Hz PL tone, FM with no tone, and noise only.
The inputs come from numpy with a fixed seed.

Tolerances, with their reasons:

- audio: max |diff| <= 1e-5 and RMS diff <= 1e-6 (full scale is 1.0).  The
  two sides sum means and FFTs in different orders in float32; the
  discriminator output is an angle, so those ulp-level input differences
  stay ulp-level.  The FM channels keep their amplitude far above the
  0.55x blanking threshold, so no sample's blanking decision can flip.
- snr: rtol 1e-4 — a ratio of float32 means over 960 samples;
- squelch_open and the PL counters: exact;
- plfreq: exact — a bin index times a constant, and the peak bin is clear;
- carried state: the PL ring within 1e-6 of its own scale (the PL slave's
  output is unnormalised, ~100), the other float leaves as the audio.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ka9q_sdr_tpu.models import demod_fm as JD
from ka9q_sdr_tpu_torch.models import demod_fm as TD

torch.set_num_threads(1)

FS, L_DEC, M_DEC, BLOCKS = 48000.0, 960, 1089, 24
PL_TONES = (100.0, 151.4, None)


def _blocks():
    rng = np.random.default_rng(17)
    n = np.arange(BLOCKS * L_DEC)
    t = n / FS
    rows = []
    for j, pl in enumerate(PL_TONES):
        ph = 2.5 * np.sin(2 * np.pi * 1000 * t + j)     # 2.5 kHz deviation
        if pl is not None:
            ph = ph + (600 / pl) * np.sin(2 * np.pi * pl * t)
        rows.append(0.3 * np.exp(1j * (2 * np.pi * 150 * t + ph)))
    rows.append(np.zeros_like(t, complex))
    x = np.stack(rows) + 0.01 * (rng.standard_normal((4, len(t)))
                                 + 1j * rng.standard_normal((4, len(t))))
    return x.astype(np.complex64).reshape(4, BLOCKS, L_DEC).transpose(1, 0, 2)


@pytest.fixture(scope="module")
def runs():
    jcfg = JD.FMConfig.make(FS, -8000, 8000, L_DEC, M_DEC, enable_pl=True)
    tcfg = TD.FMConfig.make(FS, -8000, 8000, L_DEC, M_DEC,
                            enable_pl=True).to("cpu")
    np.testing.assert_array_equal(tcfg.audio_response.numpy(),
                                  jcfg.audio_response)
    np.testing.assert_array_equal(tcfg.pl_response.numpy(), jcfg.pl_response)
    jstep = jax.jit(lambda s, x: JD.fm_demod(jcfg, s, x))
    js = JD.fm_init(jcfg, (4,))
    ts = TD.fm_init(tcfg, (4,), device="cpu")
    out = []
    for x in _blocks():
        js, ja, jd = jstep(js, jnp.asarray(x))
        ts, ta, td = TD.fm_demod(tcfg, ts, torch.as_tensor(x))
        out.append((np.asarray(ja), ta.numpy(),
                    {k: np.asarray(v) for k, v in jd.items()},
                    {k: v.numpy() for k, v in td.items()}))
    return out, js, ts


def test_audio_matches(runs):
    out, _, _ = runs
    for ja, ta, _, _ in out:
        assert ta.dtype == ja.dtype and ta.shape == ja.shape
        assert np.abs(ta - ja).max() <= 1e-5
        assert np.sqrt(np.mean((ta - ja) ** 2)) <= 1e-6
    # the FM channels carry real audio; the tone is 1 kHz
    ja = np.concatenate([o[0] for o in out[4:]], axis=-1)
    spec = np.abs(np.fft.rfft(ja[0]))
    assert abs(np.argmax(spec) * FS / ja.shape[-1] - 1000.0) < 5.0


def test_diagnostics_match(runs):
    out, _, _ = runs
    for _, _, jd, td in out:
        np.testing.assert_array_equal(td["squelch_open"], jd["squelch_open"])
        np.testing.assert_allclose(td["snr"], jd["snr"], rtol=1e-4)
        np.testing.assert_array_equal(td["plfreq"], jd["plfreq"])
    last = out[-1][3]
    assert list(last["squelch_open"]) == [True, True, True, False]
    assert abs(last["plfreq"][0] - 100.0) < 1.0
    assert abs(last["plfreq"][1] - 151.4) < 1.0
    assert np.isnan(last["plfreq"][3])


def test_state_matches(runs):
    _, js, ts = runs
    np.testing.assert_array_equal(ts.snr_below.numpy(), np.asarray(js.snr_below))
    np.testing.assert_array_equal(ts.pl_counter.numpy(),
                                  np.asarray(js.pl_counter))
    ring = np.asarray(js.pl_ring)          # unnormalised PL slave output
    np.testing.assert_allclose(ts.pl_ring.numpy(), ring,
                               atol=1e-6 * np.abs(ring).max())
    np.testing.assert_allclose(ts.audio_overlap.numpy(),
                               np.asarray(js.audio_overlap), atol=1e-5)
    np.testing.assert_allclose(ts.disc_state.numpy(),
                               np.asarray(js.disc_state), atol=1e-6)
    np.testing.assert_allclose(ts.lastaudio.numpy(), np.asarray(js.lastaudio),
                               atol=1e-5)
