"""The plain reference: its control (every stage rounded to bfloat16)
fails the cells' limits at a tiny size, and (slow) the float64 reference
holds the JAX-made reference rows R2 and R3 of the port's data within
those files' own bounds."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sdrbench import cells, control
from sdrbench.reference.bank import RefBank
from sdrbench.tests import tiny

DATA = Path(__file__).resolve().parents[2] / "ka9q_sdr_tpu_torch" / "data" \
    / "reference"
# the files' own bounds (the port's tools/reference.py): kept PCM within
# 8 LSB and a difference RMS at most -85 dBFS; audio RMS within 0.1 dB
# above -90 dBFS; flags equal from block 1, and on the carriers in block 0
PCM_LSB, PCM_RMS_DBFS, RMS_DB, RMS_FLOOR_DBFS = 8, -85.0, 0.1, -90.0


@pytest.mark.parametrize("cfg_name,traffic,workload", [
    ("fm_pl_4096_20ms", "sat", "fm4096-sat"),
    ("mixed6144_20ms", "sat", "mixed6144-sat"),
    ("fm_pl_4094_mesh4_20ms", "live", "fm4094-mesh4-live"),
])
def test_bfloat16_control_fails_the_limits(cfg_name, traffic, workload):
    nums = control.control_numbers(tiny.config(cfg_name),
                                   tiny.traffic(traffic), 2**31 + 5, 8,
                                   torch.device("cpu"))
    broken = control.fails(nums, cells.limits(workload))
    assert "pcm_gap_lsb" in broken and "bb_power_rel_gap" in broken, nums
    if workload.startswith("mixed"):
        assert "hang_agc_shape_p95" in broken, nums


def _bench_block(n, fs, L):
    """The root bench.py's bank row input (bench.py:40-54), int16."""
    usable = 0.9 * fs
    freqs = list(np.linspace(-usable / 2, usable / 2, n, endpoint=False))
    rng = np.random.default_rng(1)
    tt = np.arange(L) / fs
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for ch in (3, n // 2, n - 5):
        x += 0.2 * np.exp(2j * np.pi * freqs[ch] * tt)
    x = x.astype(np.complex64)
    x_i = np.empty((L, 2), np.int16)
    x_i[:, 0] = np.clip(x.real * 32767, -32768, 32767)
    x_i[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
    return [("FM", freqs)], x_i


def _mixed_block(spec, fs, L):
    """The root bench.py's mixed row input (bench.py:144-157), float32."""
    total = sum(n for _, n in spec)
    usable = 0.9 * fs
    allf = np.linspace(-usable / 2, usable / 2, total, endpoint=False)
    groups, i = [], 0
    for mode, n in spec:
        groups.append((mode, list(allf[i:i + n])))
        i += n
    rng = np.random.default_rng(2)
    tt = np.arange(L) / fs
    x = 0.01 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    for _, freqs in groups:
        x += 0.2 * np.exp(2j * np.pi * freqs[len(freqs) // 2] * tt)
    return groups, np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _held(row: str):
    z = np.load(DATA / f"{row}.npz", allow_pickle=False)
    ref = {k: z[k] for k in z.files}
    meta = json.loads(str(ref["meta"]))
    g = meta["geometry"]
    fs, L, M = g["samprate"], g["L"], g["M"]
    if g["groups"]:
        groups, x = _mixed_block(g["groups"], fs, L)
        ingest, pl = "f32", False
    else:
        groups, x = _bench_block(g["n_channels"], fs, L)
        ingest, pl = "i16", bool(g["cfg"].get("enable_pl"))
    assert hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest() \
        == str(ref["sha256"]), "the input block is not the file's"
    kept = ref["kept"]
    offs = np.cumsum([0] + [len(f) for _, f in groups])
    bank = RefBank([(m, f, kept[(kept >= offs[i]) & (kept < offs[i + 1])]
                     - offs[i]) for i, (m, f) in enumerate(groups)],
                   fs, L, M, enable_pl=pl, ingest=ingest)
    # the groups' rows in order, back in the file's order of `kept`
    ids = np.concatenate([kept[(kept >= offs[i]) & (kept < offs[i + 1])]
                          for i in range(len(groups))])
    order = np.asarray([int(np.nonzero(ids == c)[0][0]) for c in kept])
    carriers = np.zeros(offs[-1], bool)
    carriers[ref["carriers"]] = True
    worst = {"pcm": 0.0, "pcm_rms_dbfs": -np.inf, "rms_db": 0.0,
             "flags": 0}
    for b in range(meta["K"]):
        out = bank.step(x)
        audio = np.concatenate([o["audio"].numpy() for o in out])[order]
        pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
        bound = b >= ref["first_pcm"][kept]
        d = pcm[bound].astype(np.float64) - ref["pcm"][b][bound]
        if d.size:
            worst["pcm"] = max(worst["pcm"], float(np.abs(d).max()))
            rms = np.sqrt(np.mean((d / 32767.0) ** 2, axis=-1)).max()
            worst["pcm_rms_dbfs"] = max(worst["pcm_rms_dbfs"],
                                        20 * np.log10(max(rms, 1e-12)))
        mine = np.sqrt(np.mean(audio.astype(np.float64) ** 2, axis=-1))
        theirs = ref["rms"][b][kept].astype(np.float64)
        ok = (b >= ref["first_rms"][kept]) & (
            20 * np.log10(np.maximum(theirs, 1e-30)) > RMS_FLOOR_DBFS)
        if ok.any():
            worst["rms_db"] = max(worst["rms_db"], float(np.abs(
                20 * np.log10(mine[ok] / theirs[ok])).max()))
        for i, o in enumerate(out):
            cols = np.arange(offs[i], offs[i + 1])
            if "squelch_open" in o:
                f, want = o["squelch_open"].numpy(), ref["flags"][b][cols]
                dom = np.ones_like(f) if b else carriers[cols]
                worst["flags"] += int(np.sum((f != want) & dom))
            if "pll_lock" in o:
                rows = kept[(kept >= offs[i]) & (kept < offs[i + 1])]
                worst["flags"] += int(np.sum(o["pll_lock"].numpy()
                                             != ref["flags"][b][rows]))
    return worst


@pytest.mark.slow
@pytest.mark.parametrize("row", ["R2", "R3"])
def test_reference_holds_the_jax_made_rows(row):
    w = _held(row)
    assert w["pcm"] <= PCM_LSB, w
    assert w["pcm_rms_dbfs"] <= PCM_RMS_DBFS, w
    assert w["rms_db"] <= RMS_DB, w
    assert w["flags"] == 0, w


@pytest.mark.parametrize("hangmax,rate_db_s", [(0, 50.0), (52800, 6.0),
                                               (300, 20.0)])
def test_closed_form_agc_is_the_recurrence(hangmax, rate_db_s):
    from sdrbench.reference.linear import agc_gains, agc_serial

    rng = np.random.default_rng(hangmax)
    H, r = 10 ** (-15 / 20), 10 ** (rate_db_s / 20 / 48000)
    g = np.full(32, 1e5)
    h = np.zeros(32, np.int64)
    g2, h2 = g.copy(), h.copy()
    for b in range(60):
        t = np.arange(960) + 960 * b
        f = rng.uniform(100, 3000, 32)[:, None]
        amp = np.abs(0.01 * (1 + 0.5 * np.cos(2 * np.pi * f * t / 48000))
                     + 0.002 * rng.standard_normal((32, 960)))
        if b % 20 == 7:
            amp *= 3                        # a burst: clamps, then a hang
        G1, g, h = agc_gains(amp, g, h, H, r, hangmax)
        G2, g2, h2 = agc_serial(amp, g2, h2, H, r, hangmax)
        assert np.max(np.abs(G1 / G2 - 1)) < 1e-12
        assert np.array_equal(h, h2)
