"""Multi-device dry run: the bank step sharded over an n-device mesh,
checked against the unsharded bank (the twin of the JAX package's
``__graft_entry__.dryrun_multichip``, with the same checks and bounds).

Checked: FM and CAM (PLL: acquisition rings, loop integrators and lock
counters split over the shards) with the channel axis sharded; an
N = 2^16 master; the distributed master FFT (comb gather) at N = 8192 and
2^16; ``fft_fourstep`` at 2^16 against numpy; the daemon path (``bankd
--mesh``, with padding and a wire retune); the mixed-mode MultiBank with a
retune and a filter swap; a Doppler sweep whose k re-centering hops bins;
CROSS_CONJ ISB under the distributed FFT; and a live FM -> USB migration on
the sharded MultiBank.

It runs on the first n cards, on n CPU shards when the caller asks for
the CPU, or on an explicit device list (a list that repeats one card runs
the sharded code on it):

    python -m ka9q_sdr_tpu_torch.parallel.dryrun 4          # the first 4 cards
    python -m ka9q_sdr_tpu_torch.parallel.dryrun 8 --cpu    # 8 CPU shards
    dryrun_multichip(4, devices=["cuda:0"] * 4)             # on one card

``entry()`` is the twin of ``__graft_entry__.entry()``: the flagship step
(the FM channel bank) on a reduced geometry, as ``(fn, example_args)``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..models.bank import (ChannelBank, MultiBank, bank_init, bank_step,
                           make_bank_config)
from ..ops.fftfilt import fft_fourstep
from ..utils.runtime import configure_torch
from .mesh import gather_bank_state, make_channel_mesh

__all__ = ["dryrun_multichip", "entry"]

#: ``entry()``'s bank, the geometry of ``__graft_entry__._bank(16)``: 16 FM
#: channels at 1.536 Msps, 48 kHz out, an N = 8192 master FFT
ENTRY = dict(n_channels=16, samprate=1.536e6, L=3840, M=4353)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _freqs(n_ch, samprate):
    usable = 0.9 * samprate
    return list(np.linspace(-usable / 2, usable / 2, n_ch, endpoint=False))


def _check_sharded(mesh, n_ch, mode, samprate, L, M, n_blocks, shard_fft,
                   atol, label):
    """n_blocks through the sharded bank (``ChannelBank(mesh=)``: on cards
    its captured graphs, the ``shard_fft`` chain included) and the
    unsharded bank step: raises on an audio divergence beyond atol, and
    cross-checks every carried state leaf.  Returns max |audio_sharded -
    audio_unsharded|."""
    dev = mesh.devices[0]
    cfg = make_bank_config(n_ch, mode, samprate=samprate, L=L, M=M)
    freqs = _freqs(n_ch, samprate)
    sharded = ChannelBank(cfg, freqs, mesh=mesh, shard_fft=shard_fft)
    ref_cfg, ref_state = cfg.to(dev), bank_init(cfg, freqs, device=dev)

    rng = np.random.default_rng(0)
    tt = np.arange(n_blocks * L) / samprate
    sig = 0.01 * (rng.standard_normal(len(tt))
                  + 1j * rng.standard_normal(len(tt)))
    for ch in (1, n_ch // 2):   # strong carriers so AGC/PLL do real work
        sig = sig + 0.3 * np.exp(2j * np.pi * freqs[ch] * tt)
    sig = torch.as_tensor(sig.astype(np.complex64), device=dev)

    max_err = 0.0
    for blk in range(n_blocks):
        x = sig[blk * L:(blk + 1) * L]
        audio, _ = sharded.process(x)
        ref_state, ref_audio, _ = bank_step(ref_cfg, ref_state, x)
        assert audio.shape[0] == n_ch
        err = float(torch.max(torch.abs(audio - ref_audio)))
        max_err = max(max_err, err)
        if err > atol:
            raise AssertionError(
                f"{label}: sharded/unsharded audio diverged at block {blk}: "
                f"max |err| = {err:.3e} > {atol:.1e}")
    # carried state must agree too (overlap, NCO phases, AGC gains, PLL
    # loop integrators, acquisition rings, lock counters)
    for a, b in zip(_leaves(gather_bank_state(sharded.state, dev)),
                    _leaves(ref_state)):
        np.testing.assert_allclose(
            a.cpu().numpy().astype(np.complex128),
            b.cpu().numpy().astype(np.complex128),
            atol=max(atol, 1e-5), rtol=1e-3)
    print(f"dryrun_multichip {label} OK: {mesh.size} devices, {n_ch} ch, "
          f"N={cfg.N}, {n_blocks} blocks, "
          f"max |sharded-unsharded| = {max_err:.3e}", flush=True)
    return max_err


def _check_daemon(mesh, tmpdir):
    """bankd with the mesh against bankd without, PCM files compared
    (includes a mid-run TLV retune on the sharded state)."""
    from ..apps.bankd import BankDaemon, build_parser
    from ..net import status as st
    from ..net.status import StatusType

    samprate, L, M = 1.536e6, 3840, 4353
    n_ch = mesh.size + 2     # forces padding
    freqs = _freqs(n_ch, samprate)
    cpu = mesh.devices[0].type == "cpu"

    def daemon(tag, with_mesh):
        argv = ["--iq-file", "unused", "-r", str(samprate), "-m", "AM",
                "--L", str(L), "--M", str(M), "--no-native",
                "--pcm-raw", os.path.join(tmpdir, f"{tag}.pcm")]
        if cpu:
            argv.append("--cpu")
        return BankDaemon(build_parser().parse_args(argv), list(freqs),
                          mesh=mesh if with_mesh else None)

    a = daemon("mesh", True)
    b = daemon("flat", False)
    assert a.cfg.n_channels % mesh.size == 0 and a.n_real == n_ch

    retune_pkt = bytearray([1])
    st.encode_int(retune_pkt, StatusType.OUTPUT_SSRC, 3)
    st.encode_double(retune_pkt, StatusType.RADIO_FREQUENCY,
                     freqs[5] + 1000.0)
    st.encode_eol(retune_pkt)

    for blk in range(6):
        t = (blk * L + np.arange(L)) / samprate
        x = (0.1 * (1 + 0.8 * np.sin(2 * np.pi * 400 * t))
             * np.exp(2j * np.pi * freqs[5] * t)).astype(np.complex64)
        if blk == 3:   # the command plane works on sharded state
            a.handle_command(bytes(retune_pkt))
            b.handle_command(bytes(retune_pkt))
        a.process_block(x)
        b.process_block(x)
    for d in (a, b):
        d.close()
    pa, pb = (np.fromfile(os.path.join(tmpdir, f"{t}.pcm"), "<i2")
              .astype(np.int32) for t in ("mesh", "flat"))
    assert pa.size == 6 * n_ch * a.cfg.L_dec and pa.shape == pb.shape
    max_lsb = int(np.abs(pa - pb).max())
    # the hang AGC can amplify float rounding to a few LSB: the 8-LSB
    # bound of PARITY.md #9
    assert max_lsb <= 8, f"daemon-path PCM diverged: {max_lsb} LSB"
    err = (pa - pb) / 32767.0
    rms_dbfs = 10 * np.log10(np.mean(err.astype(np.float64) ** 2) + 1e-30)
    assert rms_dbfs < -85.0, f"daemon-path PCM rms {rms_dbfs:.1f} dBFS"
    print(f"dryrun_multichip bankd --mesh {mesh.size} OK: {n_ch} channels "
          f"(padded to {a.cfg.n_channels}), mid-run wire retune, "
          f"PCM within {max_lsb} LSB of the single-device daemon", flush=True)


def _noise_and(n_blocks, L, samprate, seed, tones):
    """Noise plus complex tones (freq Hz, amplitude), (n_blocks*L,)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n_blocks * L) / samprate
    x = 0.01 * (rng.standard_normal(len(tt))
                + 1j * rng.standard_normal(len(tt)))
    for f, amp in tones:
        x += amp * np.exp(2j * np.pi * f * tt)
    return x.astype(np.complex64), tt


def _check_multibank(mesh):
    samprate, L, M = 1.536e6, 3840, 4353
    usable = 0.9 * samprate
    fm_freqs = list(np.linspace(-usable / 2, 0, 5, endpoint=False))
    usb_freqs = [1.0e4, 1.2e5, 2.2e5]
    groups = [("FM", fm_freqs), ("USB", usb_freqs)]
    a = MultiBank(groups, samprate=samprate, L=L, M=M, mesh=mesh)
    b = MultiBank(groups, samprate=samprate, L=L, M=M,
                  device=mesh.devices[0])
    f_new = 3.3e5
    x, _ = _noise_and(4, L, samprate, 5, [(fm_freqs[2], 0.3),
                                          (f_new + 1e3, 0.2)])
    worst = 0.0
    for blk in range(4):
        s = x[blk * L:(blk + 1) * L]
        if blk == 2:          # mid-run: retune + filter swap, both banks
            for mb in (a, b):
                mb.tune(1, 2, f_new)
                mb.set_filter(1, low=50.0, high=2800.0)
        for g, ((aud_a, _), (aud_b, _)) in enumerate(zip(a.process(s),
                                                         b.process(s))):
            n = a.group_real[g]
            worst = max(worst, float(torch.max(torch.abs(aud_a[:n]
                                                         - aud_b[:n]))))
    assert worst < 3e-4, f"MultiBank sharded diverged: {worst:.2e}"
    print(f"dryrun_multichip MultiBank OK: {mesh.size} devices, "
          f"FM({len(fm_freqs)})+USB({len(usb_freqs)}) groups, mid-run "
          f"retune+filter swap, max |sharded-unsharded| = {worst:.3e}",
          flush=True)


def _check_doppler(mesh):
    samprate, L, M = 1.536e6, 3840, 4353
    n_ch = max(mesh.size * 2, 8)
    freqs = _freqs(n_ch, samprate)
    cfg = make_bank_config(n_ch, "IQ", samprate=samprate, L=L, M=M)
    a = ChannelBank(cfg, freqs, mesh=mesh)
    b = ChannelBank(cfg, freqs, device=mesh.devices[0])
    # steep LEO-scale sweep: crosses a 187.5 Hz master bin every ~2 blocks
    for bank in (a, b):
        bank.set_doppler(1, 150.0, -20000.0)
    n_blocks = 6
    x, tt = _noise_and(n_blocks, L, samprate, 7, [])
    # a tone that follows the steered profile, so channel 1 stays lit
    phase = (freqs[1] + 150.0) * tt + 0.5 * -20000.0 * tt * tt
    x = (x + 0.3 * np.exp(2j * np.pi * phase)).astype(np.complex64)
    ks = [int(b.state.k[1])]
    worst = 0.0
    for blk in range(n_blocks):
        s = x[blk * L:(blk + 1) * L]
        aud_a, _ = a.process(s)
        aud_b, _ = b.process(s)
        worst = max(worst, float(torch.max(torch.abs(aud_a - aud_b))))
        ks.append(int(b.state.k[1]))
    assert len(set(ks)) >= 2, \
        f"sweep never re-centered k (recenter path dead): {ks}"
    assert worst < 3e-5, f"doppler sharded diverged: {worst:.2e}"
    print(f"dryrun_multichip doppler OK: {mesh.size} devices, swept "
          f"channel k path {sorted(set(ks))}, max |sharded-unsharded| = "
          f"{worst:.3e}", flush=True)


def _check_migration(mesh):
    samprate, L, M = 1.536e6, 3840, 4353
    fm_freqs = [-3.0e5, 1.5e5, -1.0e5]
    usb_freqs = [4.0e5, 2.0e5]        # slot 1 = the migration target
    groups = [("FM", fm_freqs), ("USB", usb_freqs)]
    dev = mesh.devices[0]
    a = MultiBank(groups, samprate=samprate, L=L, M=M, mesh=mesh)
    b = MultiBank(groups, samprate=samprate, L=L, M=M, device=dev)
    c = MultiBank(groups, samprate=samprate, L=L, M=M, device=dev)
    # FM slot 1 carries a carrier + 1 kHz USB tone: dull under FM, a clean
    # tone once migrated; plus an FM station and a USB station
    n_blocks, mig_at = 6, 3
    x, tt = _noise_and(n_blocks, L, samprate, 11,
                       [(fm_freqs[1] + 1e3, 0.3), (usb_freqs[0] + 7e2, 0.2)])
    x = (x + 0.3 * np.exp(1j * (2 * np.pi * fm_freqs[0] * tt + 3.0 * np.sin(
        2 * np.pi * 400.0 * tt)))).astype(np.complex64)
    worst = untouched = 0.0
    migrated = []
    for blk in range(n_blocks):
        s = x[blk * L:(blk + 1) * L]
        if blk == mig_at:
            # the daemon's migrate(): fresh demod row + retune in the
            # target group (the FM row it left is muted daemon-side)
            for mb in (a, b):
                mb.init_channel(1, 1, fm_freqs[1])
        outs_a, outs_b, outs_c = a.process(s), b.process(s), c.process(s)
        for g in range(2):
            n = a.group_real[g]
            au_a, au_b = outs_a[g][0][:n], outs_b[g][0][:n]
            worst = max(worst, float(torch.max(torch.abs(au_a - au_b))))
            if blk >= mig_at:
                # every row but the spliced one is bit-untouched by the
                # migration (unsharded migrating against control)
                rows = [r for r in range(au_b.shape[0])
                        if not (g == 1 and r == 1)]
                untouched = max(untouched, float(torch.max(torch.abs(
                    au_b[rows] - outs_c[g][0][:n][rows]))))
        if blk > mig_at:   # skip the splice block's transient
            migrated.append(outs_b[1][0][1].cpu().numpy())
    assert worst < 1e-3, f"sharded migration diverged: {worst:.2e}"
    assert untouched == 0.0, \
        f"migration touched other channels' PCM: {untouched:.2e}"
    # the spliced group is still split over the mesh
    assert isinstance(a.states[1], tuple) and len(a.states[1]) == mesh.size
    tone = np.concatenate(migrated).astype(np.float64).ravel()
    spec = np.abs(np.fft.rfft(tone - tone.mean()))
    k = int(np.argmax(spec))
    k0 = 1000.0 * len(tone) / 48000.0
    assert abs(k - k0) <= 2, \
        f"migrated row's tone at bin {k}, expected ~{k0:.1f} (1 kHz USB)"
    print(f"dryrun_multichip migrate OK: {mesh.size} devices, FM->USB "
          f"mid-run splice, max |sharded-unsharded| = {worst:.3e}, other "
          f"channels bit-untouched, 1 kHz tone at bin {k}/{k0:.1f}",
          flush=True)


def dryrun_multichip(n_devices: int, devices=None, cpu: bool = False) -> None:
    """Every sharded path of the bank over an n-device mesh, checked
    against the unsharded bank on the mesh's first device.  `devices`
    defaults to the first n cards, or to n CPU shards when `cpu`; without
    a card and without `cpu` it exits 2, as the daemons do."""
    if devices is None:
        configure_torch(cpu, "dryrun")
        devices = make_channel_mesh(n_devices, cpu=cpu).devices
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    mesh = make_channel_mesh(devices=devices)
    n_ch = max(n_devices * 2, 8)
    # 1) FM bank, channel-axis sharding (N = 8192 master)
    _check_sharded(mesh, n_ch, "FM", 1.536e6, 3840, 4353, n_blocks=3,
                   shard_fft=False, atol=1e-5, label="FM")
    # 2) CAM (PLL), the state-heaviest mode
    _check_sharded(mesh, n_ch, "CAM", 1.536e6, 3840, 4353, n_blocks=3,
                   shard_fft=False, atol=2e-5, label="CAM")
    # 3) an N = 2^16 master under channel sharding
    _check_sharded(mesh, n_ch, "FM", 6.144e6, 49152, 16385, n_blocks=2,
                   shard_fft=False, atol=3e-5, label="bigN")
    # 4) the distributed master FFT (comb gather) at N = 8192
    _check_sharded(mesh, n_ch, "FM", 1.536e6, 3840, 4353, n_blocks=2,
                   shard_fft=True, atol=3e-5, label="shard_fft")
    # 5) the distributed FFT at the 2^16 master
    _check_sharded(mesh, n_ch, "FM", 6.144e6, 49152, 16385, n_blocks=2,
                   shard_fft=True, atol=1e-4, label="shard_fft+bigN")
    # 6) the four-step decomposition against numpy at 2^16
    rng = np.random.default_rng(1)
    z = (rng.standard_normal(1 << 16)
         + 1j * rng.standard_normal(1 << 16)).astype(np.complex64)
    got = fft_fourstep(torch.as_tensor(z, device=mesh.devices[0]))
    ref = np.fft.fft(z)
    err = float(np.max(np.abs(got.cpu().numpy() - ref)) / np.max(np.abs(ref)))
    assert err < 2e-5, f"fft_fourstep diverged: rel err {err:.2e}"
    print(f"dryrun_multichip fft_fourstep OK: N=65536, rel err {err:.2e}",
          flush=True)
    # 7) the daemon path: bankd --mesh
    with tempfile.TemporaryDirectory() as td:
        _check_daemon(mesh, td)
    # 8) mixed-mode MultiBank with a retune and a group filter swap
    _check_multibank(mesh)
    # 9) Doppler steering through the sharded state (k re-centering)
    _check_doppler(mesh)
    # 10) CROSS_CONJ ISB under the distributed FFT.  The block-0 hang-AGC
    #     attack on the strong-carrier channel amplifies float rounding
    #     (PARITY.md #9 bound)
    _check_sharded(mesh, n_ch, "ISB", 1.536e6, 3840, 4353, n_blocks=3,
                   shard_fft=True, atol=1e-3, label="shard_fft+ISB")
    # 11) live FM -> USB migration on the sharded MultiBank
    _check_migration(mesh)


def entry(device=None):
    """The flagship step on a reduced geometry: returns ``(fn,
    example_args)``, and ``fn(*example_args)`` runs one block.

    The bank is ``ENTRY``'s, with the JAX package's default FM
    configuration and its channels spread over 90% of the band.  ``fn(state,
    x) -> (state, audio, diag)`` runs the block `x` ((L,) complex64) as the
    port serves it: `state` is written into a ``ChannelBank``'s static
    state and the block is one call of that bank, on a card one replay of
    its captured step (eager on the CPU).  The state, the (16, 120) audio
    and the diagnostics it returns are the caller's.  The example is the
    bank's initial state and the JAX package's block: real part 0.1,
    imaginary part 0.  ``fn.bank`` is the bank.

    It runs on the first card, or on `device` where the caller names one
    (``"cpu"`` included); with no card and no device it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("entry: no CUDA device; pass device='cpu' "
                               "to run on the host CPU")
        device = "cuda"
    n_ch, fs = ENTRY["n_channels"], ENTRY["samprate"]
    cfg = make_bank_config(n_ch, "FM", samprate=fs, L=ENTRY["L"],
                           M=ENTRY["M"])
    bank = ChannelBank(cfg, _freqs(n_ch, fs), device=device)

    def fn(state, x):
        bank.state = state
        audio, diag = bank.process(x)
        return bank.state, audio, diag

    fn.bank = bank
    x = torch.full((ENTRY["L"],), 0.1, dtype=torch.complex64,
                   device=bank.device)
    return fn, (bank.state, x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="shard over n CPU shards (default: the first n "
                         "CUDA cards)")
    args = ap.parse_args(argv)
    try:
        dryrun_multichip(args.n_devices, cpu=args.cpu)
    except ValueError as e:
        print(f"dryrun: {e}; pass --cpu for CPU shards, or call "
              "dryrun_multichip with devices=", file=sys.stderr, flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
