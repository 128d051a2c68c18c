"""The traffic generator at a tiny size: the one-second loop is seamless,
every signal sits on its channel, and the seed changes the draw."""

import numpy as np
import torch

from sdrbench import generator, program
from sdrbench.tests import tiny


def signal_at(plan, n: np.ndarray) -> np.ndarray:
    """The signals' sum at sample indices `n` (any integers), evaluated
    directly in the time domain, in float64."""
    n = np.asarray(n, np.int64)
    out = np.zeros(n.shape, np.complex128)
    fs = plan.fs

    def cyc(f):                   # f n / fs in cycles, reduced exactly
        return ((int(f) * n) % fs) / fs

    for c in plan.carriers:
        ph = c.phase + 2 * np.pi * cyc(c.freq)
        if c.kind == "fm":
            for f, idx, p in c.tones:
                ph = ph + idx * np.sin(2 * np.pi * cyc(f) + p)
            out += c.amp * np.exp(1j * ph)
        elif c.kind == "ssb_pair":
            for f, _, p in c.tones:
                out += c.amp * np.exp(1j * (ph + 2 * np.pi * cyc(f) + p))
        else:
            f, m, p = c.tones[0]
            out += c.amp * (1 + m * np.cos(2 * np.pi * cyc(f) + p)) \
                * np.exp(1j * ph)
    return out


def _plan(seed, cfg_name="mixed6144_20ms"):
    cfg = tiny.config(cfg_name)
    groups = program.channel_freqs(cfg)
    return cfg, groups, generator.draw(groups, float(cfg["samprate"]),
                                       tiny.traffic("sat")["signals"], seed)


def test_loop_is_seamless_across_its_wrap():
    cfg, _, plan = _plan(2**31 + 11)
    blocks = generator.make_loop(plan, cfg["L"], 0.0, 1, "cpu", noise=False)
    flat = blocks.reshape(-1, 2).astype(np.float64)
    fs = plan.fs
    # samples just before and after the wrap, taken from the loop, against
    # the signals evaluated at those instants of an endless stream
    n = np.arange(fs - 40, fs + 40)
    want = signal_at(plan, n) * 32767.0
    got = flat[n % fs]
    assert np.max(np.abs(got[:, 0] - want.real)) < 1.5
    assert np.max(np.abs(got[:, 1] - want.imag)) < 1.5
    # and the stream is periodic: one second later the same samples
    assert np.allclose(signal_at(plan, n),
                       signal_at(plan, n + fs))


def test_signals_sit_on_their_channels():
    cfg, groups, plan = _plan(2**31 + 12)
    blocks = generator.make_loop(plan, cfg["L"], 0.01, 3, "cpu")
    x = blocks.reshape(-1, 2).astype(np.float64)
    spec = np.abs(np.fft.fft(x[:, 0] + 1j * x[:, 1])) ** 2
    fs = plan.fs
    for g, (mode, freqs) in enumerate(groups):
        on = set(plan.channels(g).tolist())
        for ch, f in enumerate(freqs):
            # a signal's whole offset range, or a quiet channel's middle
            # (an FM neighbour's sidebands reach past the channel's edge)
            w = 3000 if ch in on else 1000
            sel = np.arange(int(round(f)) - w, int(round(f)) + w) % fs
            band = spec[sel].sum() / (sel.size * np.median(spec))
            if ch in on:
                assert band > 5, (mode, ch, band)
            elif not ({ch - 1, ch + 1} & on):
                assert band < 2, (mode, ch, band)
    for c in plan.carriers:
        centre = int(round(groups[c.group][1][c.channel]))
        assert abs(c.freq - centre) <= 2000
        assert all(float(t[0]).is_integer() for t in c.tones)


def test_seed_changes_the_draw_and_not_the_work():
    _, _, a = _plan(2**31 + 21)
    _, _, b = _plan(2**31 + 22)
    _, _, a2 = _plan(2**31 + 21)
    key = lambda p: [(c.group, c.channel, c.freq) for c in p.carriers]
    assert key(a) == key(a2)
    assert key(a) != key(b)
    # the same number of signals of each kind, whatever the seed
    kinds = lambda p: sorted((c.group, c.kind) for c in p.carriers)
    assert kinds(a) == kinds(b)


def test_noise_level_and_int16_scale():
    cfg, _, plan = _plan(5)
    plan.carriers = []
    blocks = generator.make_loop(plan, cfg["L"], 0.01, 5, "cpu")
    assert blocks.dtype == np.int16 and blocks.shape == (50, cfg["L"], 2)
    rms = blocks.astype(np.float64).std() / 32767.0
    assert abs(rms - 0.01) < 0.0005
    other = generator.make_loop(plan, cfg["L"], 0.01, 6, "cpu")
    assert not np.array_equal(blocks, other)
    assert torch.initial_seed() is not None
