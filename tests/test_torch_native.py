"""The port's native RTP engine (``ka9q_sdr_tpu_torch/native``), built from
its own copy of ``rtp_engine.cc``, against the port's Python transport
(``io.assembler.BlockAssembler``, ``io.pcm.PCMOutput``) and the JAX
package's engine, on the same loopback multicast streams.  Blocks and
datagrams must be bit-equal."""

import select
import struct
import time

import numpy as np
import pytest

from ka9q_sdr_tpu_torch import native

pytestmark = pytest.mark.skipif(not native.NATIVE_AVAILABLE,
                                reason="no C++ toolchain")

SEED = 20261017
GRP = "239.96.2.{}"            # groups unique to this module
PORT = 5620


def _drain(sock, timeout=0.3):
    out = []
    while True:
        r, _, _ = select.select([sock], [], [], timeout)
        if not r:
            return out
        out.append(sock.recv(9000))


def test_engine_built_from_the_port_copy():
    import ka9q_sdr_tpu.native as jax_native

    assert native.build()
    so = native._so_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("librtp_engine-")
    assert native._SRC.parent.name == "native"
    assert "ka9q_sdr_tpu_torch" in str(native._SRC)
    # its own library, not the JAX package's
    assert str(so) != jax_native._SO
    assert native._load()._name == str(so)


def _receivers(group, L):
    import ka9q_sdr_tpu.native as jax_native
    from ka9q_sdr_tpu_torch.net.multicast import setup_mcast

    rx = {"port_f": native.RTPReceiver(group, PORT, block_len=L),
          "port_i": native.RTPReceiver(group, PORT, block_len=L),
          "jax_f": jax_native.RTPReceiver(group, PORT, block_len=L),
          "jax_i": jax_native.RTPReceiver(group, PORT, block_len=L)}
    sock = setup_mcast(f"{group}:{PORT}", output=False)
    return rx, sock


def _collect(rx, sock, L):
    """Every block the assembler made of the stream, and as many from each
    engine."""
    from ka9q_sdr_tpu_torch.io.assembler import BlockAssembler

    asm = BlockAssembler(L)
    for d in _drain(sock):
        asm.push(d)
    out = {"asm": list(asm.blocks())}
    n_blocks = len(out["asm"])
    for name, r in rx.items():
        get = r.get_block_i16 if name.endswith("_i") else r.get_block
        blocks = []
        for _ in range(n_blocks):
            b = get(2000)
            if b is None:
                break
            blocks.append(b)
        out[name] = blocks
        out[name + "_stats"] = r.stats()
        r.close()
    sock.close()
    return out


def _check(out, n_blocks):
    assert len(out["asm"]) == n_blocks
    for name in ("port_f", "port_i", "jax_f", "jax_i"):
        assert len(out[name]) == n_blocks, name
    for k in range(n_blocks):
        pf, pi = out["port_f"][k], out["port_i"][k]
        np.testing.assert_array_equal(pf, out["jax_f"][k])
        np.testing.assert_array_equal(pi, out["jax_i"][k])
        assert pf.dtype == np.float32 and pi.dtype == np.int16
        a = out["asm"][k]
        np.testing.assert_array_equal(pf[:, 0], a.real)
        np.testing.assert_array_equal(pf[:, 1], a.imag)
        np.testing.assert_array_equal(
            pi.astype(np.float32) * np.float32(1.0 / 32767.0), pf)
    assert out["port_f_stats"] == out["jax_f_stats"]


def test_paced_stream_from_the_port_sender():
    """The port's RTPSender paces a stream at the wire rate; the port's
    engine (float and int16 blocks), the JAX engine and BlockAssembler
    produce the same blocks."""
    group, L, n_blocks = GRP.format(1), 3840, 6
    rx, sock = _receivers(group, L)
    rng = np.random.default_rng(SEED)
    iq = rng.integers(-32768, 32768, 2 * L * n_blocks, dtype=np.int16)
    tx = native.RTPSender(group, PORT, samprate=192000, ttl=0, ssrc=77)
    assert tx.send(iq, pkt_samples=240, realtime=True) == L * n_blocks // 240
    tx.close()
    out = _collect(rx, sock, L)
    _check(out, n_blocks)
    got = np.concatenate(out["port_i"]).reshape(-1)
    np.testing.assert_array_equal(got, iq)
    assert out["port_f_stats"]["drops"] == 0


def test_impaired_stream_reorders_dupes_gaps():
    """A hand-made stream with reordered pairs, duplicates, lost packets
    and malformed datagrams: the engines and the assembler agree on the
    zero-filled, resequenced blocks."""
    from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
    from ka9q_sdr_tpu_torch.net.rtp import IQ_PT, RTPHeader

    group, L = GRP.format(2), 1200
    rx, sock = _receivers(group, L)
    tx = setup_mcast(f"{group}:{PORT}", output=True, ttl=0)
    rng = np.random.default_rng(SEED + 1)
    pkts = []
    for i in range(120):
        pay = rng.integers(-32768, 32768, 480, dtype=np.int16)
        h = RTPHeader(type=IQ_PT, seq=(65500 + i) & 0xFFFF,
                      timestamp=(2**32 - 2400 + 240 * i) & 0xFFFFFFFF,
                      ssrc=21)
        pkts.append(h.to_bytes() + b"\x00" * 24 + pay.astype("<i2").tobytes())
    order = []
    i = 0
    while i < len(pkts):
        r = rng.random()
        if r < 0.06 and i + 1 < len(pkts):
            order += [pkts[i + 1], pkts[i]]
            i += 2
            continue
        if r < 0.12:
            order += [pkts[i], pkts[i]]
        elif r < 0.18:
            pass
        elif r < 0.22:
            order += [pkts[i][:7], pkts[i]]
        else:
            order.append(pkts[i])
        i += 1
    for k, p in enumerate(order):
        tx.send(p)
        if k % 20 == 19:
            time.sleep(0.005)
    tx.close()
    out = _collect(rx, sock, L)
    _check(out, 120 * 240 // L)


def test_parser_probe_matches_the_jax_engine():
    import ka9q_sdr_tpu.native as jax_native

    rng = np.random.default_rng(SEED + 2)
    cases = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in list(range(30)) * 5]
    for _ in range(500):
        b0 = (2 << 6) | int(rng.integers(0, 64))
        hdr = struct.pack(">BBHII", b0, int(rng.integers(0, 256)),
                          int(rng.integers(0, 1 << 16)),
                          int(rng.integers(0, 1 << 32)),
                          int(rng.integers(0, 1 << 32)))
        body = rng.integers(0, 256, int(rng.integers(0, 60)),
                            dtype=np.uint8).tobytes()
        cases.append((hdr + body)[: int(rng.integers(0, 73))])
    for pkt in cases:
        assert native.parse_probe(pkt) == jax_native.parse_probe(pkt)


def _fan_blocks(rng, n_ch, L, nch=1):
    """Blocks of PCM rows: tones with silent rows and silent spans."""
    blocks = []
    for b in range(5):
        shape = (n_ch, L * nch)
        x = rng.integers(-3000, 3000, shape).astype(np.int16)
        x[(b + 1) % n_ch] = 0                  # a silent row
        x[:, : L * nch // 2][b % 2::2] = 0     # half-silent rows
        blocks.append(x)
    return blocks


def test_pcm_fanout_against_pcm_output():
    """The port's PCMFanoutSender against one PCMOutput per channel and
    against the JAX package's fan-out, mono: the same datagrams on the
    wire.  PCMOutput starts a stream without the talk-spurt marker, the
    fan-out with it; every other header field and every payload byte
    match."""
    import ka9q_sdr_tpu.native as jax_native
    from ka9q_sdr_tpu_torch.io.pcm import PCMOutput
    from ka9q_sdr_tpu_torch.net.multicast import setup_mcast
    from ka9q_sdr_tpu_torch.net.rtp import RTPHeader

    n_ch, L, base = 6, 960, 40
    rng = np.random.default_rng(SEED + 3)
    blocks = _fan_blocks(rng, n_ch, L)
    wire = {}
    for name, mod, g in (("port", native, GRP.format(3)),
                         ("jax", jax_native, GRP.format(4))):
        sock = setup_mcast(f"{g}:{PORT}", output=False)
        fan = mod.PCMFanoutSender(g, PORT, ttl=0, ssrc_base=base,
                                  max_channels=n_ch)
        pkts = []
        for x in blocks:
            fan.send_block(x, np.arange(n_ch, dtype=np.int32))
            pkts += _drain(sock, 0.2)
        fan.close()
        sock.close()
        wire[name] = pkts
    assert wire["port"] == wire["jax"]
    sent = []
    outs = [PCMOutput(send=sent.append, ssrc=base + c) for c in range(n_ch)]
    for x in blocks:
        for c in range(n_ch):
            outs[c].send_mono_i16(x[c])

    def by_ssrc(pkts):
        d = {}
        for p in pkts:
            h, off = RTPHeader.from_bytes(p)
            d.setdefault(h.ssrc, []).append(
                ((h.type, h.seq, h.timestamp), h.marker, p[off:]))
        return d
    got, want = by_ssrc(wire["port"]), by_ssrc(sent)
    assert sorted(got) == sorted(want) and len(got) == n_ch
    for ssrc in got:
        assert [(k, p) for k, _, p in got[ssrc]] == \
            [(k, p) for k, _, p in want[ssrc]]
        assert [m for _, m, _ in got[ssrc][1:]] == \
            [m for _, m, _ in want[ssrc][1:]]


def test_pcm_fanout_stereo_and_ssrc_override():
    """Stereo rows and a per-slot SSRC override (live migration): the
    port's fan-out sends what the JAX package's sends for (rows, frames,
    2) PCM, and the same for the rows flattened to (rows, 2 * frames), as
    the mixed-mode daemon passes them (the JAX wrapper takes the flattened
    width for the frame count and reads past each row)."""
    import ka9q_sdr_tpu.native as jax_native
    from ka9q_sdr_tpu_torch.net.multicast import setup_mcast

    n_ch, L = 4, 960
    rng = np.random.default_rng(SEED + 4)
    blocks = [x.reshape(n_ch, L, 2) for x in _fan_blocks(rng, n_ch, L, 2)]
    wire = {}
    for name, mod, g, flat in (("port", native, GRP.format(5), False),
                               ("port_flat", native, GRP.format(7), True),
                               ("jax", jax_native, GRP.format(6), False)):
        sock = setup_mcast(f"{g}:{PORT}", output=False)
        fan = mod.PCMFanoutSender(g, PORT, ttl=0, ssrc_base=9,
                                  max_channels=n_ch, channels=2)
        pkts = []
        for k, x in enumerate(blocks):
            ids = np.array([0, -1, 2, 3], np.int32)
            if k == 2:
                fan.set_ssrc(3, 500)
            if k == 4:
                fan.set_ssrc(3, 0)
            fan.send_block(x.reshape(n_ch, -1) if flat else x, ids)
            pkts += _drain(sock, 0.2)
        fan.close()
        sock.close()
        wire[name] = pkts
    assert len(wire["port"]) > 10
    assert wire["port"] == wire["jax"] == wire["port_flat"]
