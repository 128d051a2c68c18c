"""The port must import and run where jax is not installed (the machine
with the card has none) and without the JAX package: import every port
module and run two blocks of a tiny bank of each demodulator family, a live
retune, a scan, the ``lax.cond`` twin, a mixed-mode MultiBank, a receiver
fed by the test modulator, a
column FFT, the ``bankd`` and ``radio`` daemons on a tiny recording, the
packet modem's session on an AFSK frame, two front-end blocks of a tiny
recording, ``modulate`` on a few blocks, a band-plan lookup, a Mixer read,
an Opus round trip (where libopus is present), the sharded bank, the
distributed FFT and ``bankd --mesh`` on CPU shards, the stage profile, the
``utils`` re-exports, a notch block, two blocks of ``dryrun.entry``, a
tiny ``--cpu`` pass of the benchmark runner (``bench``) and the reference
comparator (``tools.reference``: R5's and M1's input hashes, a tiny
row, a tiny multi-mode MultiBank row with stereo groups and tone records,
and a tiny padded mesh row on CPU shards with its active call),
on the CPU in a subprocess where ``import jax`` and ``import ka9q_sdr_tpu``
fail."""

import subprocess
import sys
from pathlib import Path

_SCRIPT = r"""
import os
import sys
import tempfile
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["jaxlib"] = None
sys.modules["ka9q_sdr_tpu"] = None  # ... and so does the JAX package
import numpy as np
import torch
import ka9q_sdr_tpu_torch
from ka9q_sdr_tpu_torch import interop
from ka9q_sdr_tpu_torch.models import demod_am, demod_fm, demod_linear
from ka9q_sdr_tpu_torch.models.bank import (ChannelBank, MultiBank,
                                            make_bank_config)
from ka9q_sdr_tpu_torch.models import noise, receiver
from ka9q_sdr_tpu_torch.io import Modulator
from ka9q_sdr_tpu_torch.ops import (_kernels, agc, decimate, ffill, iir,
                                    pstock)
from ka9q_sdr_tpu_torch import apps, native, net
from ka9q_sdr_tpu_torch.apps import bankd, radio
from ka9q_sdr_tpu_torch.io import (BlockAssembler, IQReader, IQRecorder,
                                   PCMOutput, write_metadata)
from ka9q_sdr_tpu_torch.models.doppler import DopplerSteerer
from ka9q_sdr_tpu_torch.net import multicast, rtcp, rtp, status
from ka9q_sdr_tpu_torch.utils import graphs, misc, modes, runtime, state, trace
from ka9q_sdr_tpu_torch import __main__ as listing, decode
from ka9q_sdr_tpu_torch.apps import (aprs, aprsfeed, frontend, iqplay,
                                     iqrecord, modulate, packetd, pcmsend)
from ka9q_sdr_tpu_torch.decode import afsk, ax25
from ka9q_sdr_tpu_torch.decode import aprs as aprs_decode
from ka9q_sdr_tpu_torch.models import frontend as frontend_model
from ka9q_sdr_tpu_torch.net import sdr_header

fs, L = 1.536e6, 30720
x = np.zeros((L, 2), np.int16)
for mode, shape in (("FM", (2, 960)), ("AM", (2, 960)), ("CAM", (2, 960)),
                    ("ISB", (2, 960, 2))):
    cfg = make_bank_config(2, mode, samprate=fs, L=L, M=34817,
                           enable_pl=True)
    bank = ChannelBank(cfg, [-2e5, 3e5], device="cpu")
    for _ in range(2):
        pcm, diag = bank.process_i16_pcm(x)
    bank.tune(1, 2.5e5)
    bank.set_doppler(0, 10.0, 5.0)
    bank.set_filter(-3000.0, 3000.0)
    assert pcm.shape == shape and pcm.dtype == torch.int16, mode
    interop.state_to_numpy(bank.state)
mb = MultiBank([("FM", [-2e5]), ("USB", [1e5, 3e5]), ("CAM", [0.0])],
               samprate=fs, L=L, M=34817, device="cpu")
for _ in range(2):
    outs = mb.process_i16_pcm(x)
assert [p.shape for p, _ in outs] == [(1, 960), (2, 960), (1, 960)]
mb.init_channel(1, 0, 1.5e5)
rx = receiver.make_receiver("USB", device="cpu")
rx.set_freq(30000.0)
mod = Modulator("usb", frequency=31000.0, device="cpu")
iq = torch.cat([mod.process(np.zeros(240, np.float32)) for _ in range(4)])
for _ in range(2):
    audio, diag = rx.process(iq)
assert audio.shape == (960,) and float(diag["n0"]) >= 0.0
rx.set_mode("FM")
assert rx.process_offline(np.zeros((2, 3840, 2), np.int16)).shape == (2, 960)
assert bank.process_scan_i16(np.stack([x, x])).shape == (2, 2, 960, 2)
assert not graphs.StepGraphs("cpu").capture
assert graphs.cond(torch.tensor(True), lambda v: v + 1, lambda v: v,
                   torch.zeros(2)).tolist() == [1.0, 1.0]
interop.state_to_numpy(rx.state)
yr, yi = pstock.make_fft_cols(8, 4, 4)(torch.ones(8, 4), torch.zeros(8, 4))
assert float(yr[0, 0]) == 8.0
assert ffill.launches == agc.launches == pstock.launches == 0
tmp = tempfile.mkdtemp()
rec = os.path.join(tmp, "in.iq")
rng = np.random.default_rng(1)
rng.integers(-300, 300, (2 * 30720, 2), dtype=np.int16).tofile(rec)
write_metadata(rec, {"samplerate": "1536000", "frequency": "0.0"})
for argv in (["--channels", "2", "-r", "1536000", "-m", "FM"],
             ["--channels", "2", "-r", "1536000", "-m", "USB"]):
    out = os.path.join(tmp, "bank.pcm")
    assert bankd.main(argv + ["--iq-file", rec, "--cpu",
                              "--pcm-raw", out]) == 0
    assert os.path.getsize(out) == 2 * 2 * 960 * 2, argv
out = os.path.join(tmp, "radio.pcm")
assert radio.main(["--iq-file", rec, "-r", "1536000", "-L", "30720",
                   "-M", "34817", "-f", "100k", "-m", "AM", "--cpu", "-S", "1",
                   "--pcm-raw", out]) == 0
assert 0 < os.path.getsize(out) <= 2 * 960 * 2
frame = ax25.append_crc(ax25.encode_callsign("APRS")
                        + ax25.encode_callsign("KA9Q-9", last=True)
                        + bytes([0x03, 0xF0]) + b"!3722.50N/12200.00W-")
pcm = np.concatenate([np.zeros(2000, np.float32), afsk.afsk_modulate(frame),
                      np.zeros(4000, np.float32)])
q = np.round(pcm * 32767).astype(">i2")
sent = []
session = packetd.PacketSession(1, sent.append)
for i in range(0, len(q), 480):
    session.feed(rtp.RTPHeader(type=11, seq=i // 480, timestamp=i, ssrc=1),
                 q[i:i + 480].tobytes())
assert [d[12:] for d in sent] == [frame]
info = aprs_decode.parse_aprs(ax25.ax25_parse(frame))
assert abs(info["latitude"] - 37.375) < 1e-9
fe_rec = os.path.join(tmp, "fe.iq")
rng.integers(-300, 300, (500, 2), dtype=np.int16).tofile(fe_rec)
fe = frontend.FrontEndDaemon(frontend.build_args(
    ["-R", "239.96.6.1:5740", "--iq-file", fe_rec]))
assert [fe.next_block().shape for _ in range(2)] == [(240,), (240,)]
fe.ctl_sock.close()
import io
out = io.BytesIO()
stdin, stdout = sys.stdin, sys.stdout
sys.stdin = type("In", (), {"buffer": io.BytesIO(bytes(2 * 240 * 3))})()
sys.stdout = type("Out", (), {"buffer": out})()
try:
    assert modulate.main(["-m", "usb", "--cpu"]) == 0
finally:
    sys.stdin, sys.stdout = stdin, stdout
assert len(out.getvalue()) == 3 * 960 * 4
from ka9q_sdr_tpu_torch import audio
from ka9q_sdr_tpu_torch.apps import (control, display, monitor, opusd,
                                     opussend, pcmcat)
from ka9q_sdr_tpu_torch.audio import opus_codec, playout, transcode
from ka9q_sdr_tpu_torch.utils import bandplan
assert bandplan.load_default().lookup(146.52e6) is not None
mixer = audio.Mixer()
tone = np.round(8000 * np.sin(np.arange(480) / 7.0)).astype(">i2")
mixer.feed_packet(rtp.RTPHeader(type=11, ssrc=1, marker=True).to_bytes()
                  + tone.tobytes())
mixer.read(playout.START_DELAY)
assert abs(mixer.read(480)[:, 0] * 32767 - tone * 0.5).max() < 0.01
if audio.OPUS_AVAILABLE:
    enc, dec = audio.OpusEncoder(), audio.OpusDecoder()
    frame = np.repeat(np.sin(np.arange(960) / 7.0)[:, None], 2, 1) * 0.3
    pkts = [enc.encode(frame.astype(np.float32)) for _ in range(3)]
    assert [dec.decode(p).shape for p in pkts] == [(960, 2)] * 3
from ka9q_sdr_tpu_torch import parallel, tools
from ka9q_sdr_tpu_torch.parallel import dryrun, mesh as pmesh
from ka9q_sdr_tpu_torch.tools import serve_soak, stage_profile
from ka9q_sdr_tpu_torch.utils import timing
mesh = pmesh.make_channel_mesh(4, cpu=True)
cfg = make_bank_config(4, "FM", samprate=fs, L=L, M=34817)
for shard_fft in (False, True):
    sb = ChannelBank(cfg, [-3e5, -1e5, 1e5, 3e5], mesh=mesh,
                     shard_fft=shard_fft)
    pcm, idx, _ = sb.process_active(x, max_active=4, n_valid=3)
    assert pcm.shape == (4, 960) and int(idx.max()) < 3
    assert sb.process_scan_i16(np.stack([x, x])).shape == (2, 4, 960)
spec = parallel.dfft(mesh, np.ones(64, np.complex64))
assert abs(spec[0] - 64) < 1e-4 and np.abs(spec[1:]).max() < 1e-4
out = os.path.join(tmp, "mesh.pcm")
assert bankd.main(["--channels", "3", "-r", "1536000", "-m", "FM",
                   "--iq-file", rec, "--cpu", "--mesh", "2",
                   "--pcm-raw", out]) == 0
assert os.path.getsize(out) == 2 * 3 * 960 * 2
import contextlib, json
with contextlib.redirect_stdout(io.StringIO()) as prof:
    assert stage_profile.main(["--cpu", "--iters", "1"]) == 0
assert json.loads(prof.getvalue())["full_ms"] > 0
from ka9q_sdr_tpu_torch import bench
os.environ.update(BENCH_CHANNELS="4", BENCH_SAMPRATE="1536000",
                  BENCH_L="30720", BENCH_M="34817", BENCH_WARMUP="1",
                  BENCH_ITERS="3", BENCH_REF_L="30720",
                  BENCH_SERVE_CHANNELS="4", BENCH_CHUNK="2",
                  BENCH_SCALING="0", BENCH_MIXED="FM:2,USB:1,CAM:1",
                  BENCH_PLL_CHANNELS="4", BENCH_PLL_SAMPRATE="1536000",
                  BENCH_PLL_L="30720", BENCH_PLL_M="34817",
                  BENCH_PLL_WIDE_CHANNELS="0", BENCH_DEADLINE_S="0")
with contextlib.redirect_stdout(io.StringIO()) as res:
    assert bench.main(["--cpu"]) == 0
res = json.loads(res.getvalue())
assert res["value"] > 0 and res["device"] == "cpu"
from ka9q_sdr_tpu_torch.utils import (DEFAULT_MODES, ModeDef, db2power,
                                      parse_frequency)
assert parse_frequency("146m52") == 146.52e6 and db2power(10.0) == 10.0
assert isinstance(DEFAULT_MODES["FM"], ModeDef)
from ka9q_sdr_tpu_torch.ops import notch_block, notch_init
nst, ny = notch_block(notch_init(0.1, 0.01, device="cpu"),
                      torch.ones(64, dtype=torch.complex64))
assert ny.shape == (64,) and nst.dcstate.dtype == torch.complex64
efn, (est, ex) = dryrun.entry("cpu")
for _ in range(2):
    est, eaudio, ediag = efn(est, ex)
assert eaudio.shape == (16, 120) and bool(torch.isfinite(eaudio).all())
from ka9q_sdr_tpu_torch.tools import reference
for name in ("R5", "M1"):
    row = reference.ROWS[name]
    reference.check_input(row, reference.load(name),
                          reference.row_input(row)[1])
tiny = reference.Row("T", "FM+PL 16 ch", 1.536e6, 3840, 4353, 2, mode="FM",
                     n_channels=16, cfg=(("enable_pl", True),))
a1, st = reference.run_port(tiny, "cpu", "step")
a2, _ = reference.run_port(tiny, "cpu", "scan")
assert reference.compare(a1, a2).ok and st["ms"] is None
modes = reference.Row("TM", "ISB:2 + IQ:2 + CWL:2", 1.536e6, 30720, 34817, 8,
                      groups=(("ISB", 2), ("IQ", 2), ("CWL", 2)),
                      signals=True, kept="carriers", pcm_blocks=(0, 7))
am, _ = reference.run_port(modes, "cpu", "step")
assert am["ears"].tolist() == [2, 2, 1] and am["pcm"].shape == (2, 5, 960)
assert reference.compare(am, am).ok and am["tone"][0].tolist() == [240, 160]
mesh = reference.Row("TS", "FM 6 ch on 4 shards", 1.536e6, 3840, 4353, 2,
                     mode="FM", n_channels=6, calls=("step", "active"),
                     mesh=(4, True), max_active=8)
m1, _ = reference.run_port(mesh, "cpu", "step")
m2, _ = reference.run_port(mesh, "cpu", "active")
assert m1["rms"].shape == (2, 6) and m2["idx"].shape == (2, 8)
assert m2["idx"].max() < 6 and m1["state.g0.k"].shape == (8,)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "ka9q_sdr_tpu")
               for m, mod in sys.modules.items() if mod is not None)
print("ok")
"""


def test_port_runs_without_jax():
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
