"""The port's test modulator (``io/modulate.py``) against the JAX
package's on the CPU: every preset, with and without a frequency sweep,
over a few blocks of numpy-seeded audio, state carried.

Tolerance: rtol 1e-5 against the peak of the output, plus the int16 bytes
within 1 LSB.  The two sides run the REAL master's rFFT and the slave's
IFFT in different FFT libraries; the response (host numpy on both sides)
and the NCO words are exact.
"""

import numpy as np
import pytest
import torch

from ka9q_sdr_tpu.io.modulate import MODULATE_PRESETS as J_PRESETS
from ka9q_sdr_tpu.io.modulate import Modulator as JModulator
from ka9q_sdr_tpu_torch.interop import state_to_numpy
from ka9q_sdr_tpu_torch.io import MODULATE_PRESETS, Modulator

torch.set_num_threads(1)


def test_presets_equal():
    assert MODULATE_PRESETS == J_PRESETS


@pytest.mark.parametrize("sweep", [0.0, 250.0])
@pytest.mark.parametrize("mode", sorted(J_PRESETS))
def test_modulator_matches_jax(mode, sweep):
    kw = dict(frequency=48000.0, amplitude_db=-10.0, sweep_hz_s=sweep)
    jm = JModulator(mode, **kw)
    tm = Modulator(mode, device="cpu", **kw)
    np.testing.assert_array_equal(tm.response, jm.response)
    rng = np.random.default_rng(4)
    n = tm.L // 4
    for b in range(4):
        t = (b * n + np.arange(n)) / 48000.0
        audio = (0.5 * np.sin(2 * np.pi * 1000 * t)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        want = jm.process(audio)
        got = tm.process(audio if b % 2 else torch.as_tensor(audio))
        assert got.dtype == torch.complex64 and got.shape == (tm.L,)
        got = got.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
        a = np.frombuffer(tm.to_int16(got), np.int16).astype(np.int64)
        w = np.frombuffer(jm.to_int16(want), np.int16).astype(np.int64)
        assert np.abs(a - w).max() <= 1
    for a, b in zip(state_to_numpy(tm.osc), jm.osc):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tm.overlap.numpy(), np.asarray(jm.overlap))


def test_short_block_raises():
    with pytest.raises(ValueError):
        Modulator("usb", device="cpu").process(np.zeros(100, np.float32))
