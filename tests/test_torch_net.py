"""The port's copies of the host modules against the JAX package's
originals, on the same inputs, bit for bit: ``net/{rtp,status,multicast,
rtcp}``, ``io/{pcm,assembler,iqfile}`` and ``utils/{misc,state}``.  Inputs
come from a seeded numpy generator; packets, files and parsed values must
be byte-equal."""

import math
import os

import numpy as np
import pytest

import ka9q_sdr_tpu.io.assembler as asm_j
import ka9q_sdr_tpu.io.iqfile as iq_j
import ka9q_sdr_tpu.io.pcm as pcm_j
import ka9q_sdr_tpu.net.multicast as mc_j
import ka9q_sdr_tpu.net.rtcp as rtcp_j
import ka9q_sdr_tpu.net.rtp as rtp_j
import ka9q_sdr_tpu.net.status as st_j
import ka9q_sdr_tpu.utils.misc as misc_j
import ka9q_sdr_tpu.utils.state as state_j
import ka9q_sdr_tpu_torch.io.assembler as asm_t
import ka9q_sdr_tpu_torch.io.iqfile as iq_t
import ka9q_sdr_tpu_torch.io.pcm as pcm_t
import ka9q_sdr_tpu_torch.net.multicast as mc_t
import ka9q_sdr_tpu_torch.net.rtcp as rtcp_t
import ka9q_sdr_tpu_torch.net.rtp as rtp_t
import ka9q_sdr_tpu_torch.net.status as st_t
import ka9q_sdr_tpu_torch.utils.misc as misc_t
import ka9q_sdr_tpu_torch.utils.state as state_t

SEED = 20261016
GROUP = "239.96.1.1:5610"       # unique to this module


# ---- utils/misc ----

FREQS = ["147m435", "147.435m", "10k", "10k5", "1g2", "7074000", "14.074M",
         "0", "-3k", "2m5", "446.00625m", "1e6", "1.5", "k", "", "abc",
         "nan", "inf", "12.5kHz", "3MHz"]


@pytest.mark.parametrize("text", FREQS)
def test_parse_frequency(text):
    def run(f):
        try:
            return ("ok", f(text))
        except Exception as e:          # the same exception type, too
            return ("raise", type(e).__name__)
    got, want = run(misc_t.parse_frequency), run(misc_j.parse_frequency)
    assert got[0] == want[0]
    if got[0] == "ok" and isinstance(want[1], float) and math.isnan(want[1]):
        assert math.isnan(got[1])
    else:
        assert got == want


@pytest.mark.parametrize("fn", ["db2voltage", "voltage2db", "power2db",
                                "db2power"])
def test_db_helpers(fn):
    xs = [1e-6, 0.5, 1.0, 3.0, 100.0, -20.0]
    for x in xs:
        def run(mod):
            try:
                return getattr(mod, fn)(x)
            except ValueError as e:
                return type(e).__name__
        assert run(misc_t) == run(misc_j)


# ---- net/status ----

def _value(rng, k):
    if k == 0:
        return int(rng.integers(-2**40, 2**40)) if rng.random() < 0.5 \
            else int(rng.integers(0, 300))
    if k == 1:
        return float(np.float32(rng.standard_normal() * 1e3))
    if k == 2:
        return float(rng.standard_normal() * 1e9)
    return bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))


def _tlv_items(rng, n):
    """n (type, kind, value) items; kind 0 int, 1 float, 2 double, 3
    string."""
    kinds = [int(t) for t in st_j.StatusType if t != st_j.StatusType.EOL]
    items = []
    for _ in range(n):
        k = int(rng.integers(4))
        items.append((int(rng.choice(kinds)), k, _value(rng, k)))
    return items


def _encode(st, items):
    pkt = bytearray([0])
    for t, k, v in items:
        if k == 0:
            st.encode_int(pkt, t, v)
        elif k == 1:
            st.encode_float(pkt, t, v)
        elif k == 2:
            st.encode_double(pkt, t, v)
        else:
            st.encode_string(pkt, t, v)
    st.encode_eol(pkt)
    return bytes(pkt)


@pytest.mark.parametrize("seed", range(4))
def test_tlv_encode_decode(seed):
    rng = np.random.default_rng(SEED + seed)
    items = _tlv_items(rng, 40)
    pkt_t, pkt_j = _encode(st_t, items), _encode(st_j, items)
    assert pkt_t == pkt_j
    dec_t = list(st_t.decode_packet(pkt_t[1:]))
    dec_j = list(st_j.decode_packet(pkt_j[1:]))
    assert dec_t == dec_j
    for (t, v), (_, k, x) in zip(dec_t, items):
        if k == 0:
            assert st_t.decode_int(v) == st_j.decode_int(v)
        elif k == 1:
            assert st_t.decode_float(v) == st_j.decode_float(v)
        elif k == 2:
            assert st_t.decode_double(v) == st_j.decode_double(v)
    # truncated and garbage packets decode (or fail) alike
    for cut in (1, 5, len(pkt_t) // 2, len(pkt_t) - 2):
        junk = pkt_t[1:cut] + bytes(rng.integers(0, 256, 7, dtype=np.uint8))
        assert list(st_t.decode_packet(junk)) == list(st_j.decode_packet(junk))


def test_status_compactor():
    rng = np.random.default_rng(SEED)
    base = _tlv_items(rng, 25)
    ct, cj = st_t.StatusCompactor(), st_j.StatusCompactor()
    for i in range(30):
        items = [(t, k, v) if rng.random() < 0.7 else (t, k, _value(rng, k))
                 for t, k, v in base]
        if i % 4 == 0:
            items = [(t, 0, int(rng.integers(0, 10))) for t, _, _ in items]
        pkt = _encode(st_j, items)
        force = i % 10 == 1
        assert ct.compact(pkt, force) == cj.compact(pkt, force)


def test_status_type_table():
    assert {t.name: int(t) for t in st_t.StatusType} == \
        {t.name: int(t) for t in st_j.StatusType}


# ---- net/rtp, net/rtcp ----

@pytest.mark.parametrize("seed", range(3))
def test_rtp_header_round_trip(seed):
    rng = np.random.default_rng(SEED + 10 + seed)
    for _ in range(200):
        kw = dict(type=int(rng.integers(0, 128)),
                  seq=int(rng.integers(0, 2**16)),
                  timestamp=int(rng.integers(0, 2**32)),
                  ssrc=int(rng.integers(0, 2**32)),
                  marker=bool(rng.integers(2)))
        b = rtp_t.RTPHeader(**kw).to_bytes()
        assert b == rtp_j.RTPHeader(**kw).to_bytes()
        pay = bytes(rng.integers(0, 256, int(rng.integers(0, 30)),
                                 dtype=np.uint8))
        data = bytearray(b + pay)
        if rng.random() < 0.3:                     # mangle the header
            data[int(rng.integers(0, len(data)))] = int(rng.integers(256))
        data = bytes(data[: int(rng.integers(0, len(data) + 1))])

        def parse(rtp):
            try:
                h, off = rtp.RTPHeader.from_bytes(data)
            except ValueError:
                return None
            return (vars(h), off, rtp.rtp_payload(h, data, off))
        assert parse(rtp_t) == parse(rtp_j)


def test_rtp_process_sequences():
    rng = np.random.default_rng(SEED + 20)
    s_t, s_j = rtp_t.RTPState(), rtp_j.RTPState()
    seq, ts = 65500, 2**32 - 1000
    for _ in range(500):
        step = int(rng.choice([1, 1, 1, 2, 5, 0, -1, -3]))
        seq = (seq + step) & 0xFFFF
        ts = (ts + 240 * step) & 0xFFFFFFFF
        ssrc = 7 if rng.random() > 0.01 else 9
        h = dict(type=97, seq=seq, timestamp=ts, ssrc=ssrc)
        r_t = rtp_t.rtp_process(s_t, rtp_t.RTPHeader(**h), 240)
        r_j = rtp_j.rtp_process(s_j, rtp_j.RTPHeader(**h), 240)
        assert r_t == r_j and vars(s_t) == vars(s_j)


def test_rtcp_packets():
    rng = np.random.default_rng(SEED + 30)
    for _ in range(20):
        srk = dict(ssrc=int(rng.integers(2**32)),
                   ntp_timestamp=int(rng.integers(2**63)),
                   rtp_timestamp=int(rng.integers(2**32)),
                   packet_count=int(rng.integers(2**32)),
                   byte_count=int(rng.integers(2**32)))
        rrk = [dict(ssrc=int(rng.integers(2**32)),
                    lost_fract=int(rng.integers(256)),
                    lost_packets=int(rng.integers(2**23)),
                    highest_seq=int(rng.integers(2**32)),
                    jitter=int(rng.integers(2**32)),
                    lsr=int(rng.integers(2**32)),
                    dlsr=int(rng.integers(2**32)))
               for _ in range(int(rng.integers(0, 3)))]
        cname = bytes(rng.integers(32, 127, int(rng.integers(1, 40)),
                                   dtype=np.uint8))

        def build(m):
            rrs = [m.RTCPReceiverReport(**k) for k in rrk]
            return (m.gen_sr(m.RTCPSenderReport(**srk), rrs),
                    m.gen_rr(srk["ssrc"], rrs),
                    m.gen_sdes(srk["ssrc"],
                               [m.SDESItem(m.SDESType.CNAME, cname)]),
                    m.gen_bye([srk["ssrc"], 5]))
        assert build(rtcp_t) == build(rtcp_j)
    assert rtcp_t.NTP_EPOCH == rtcp_j.NTP_EPOCH


# ---- net/multicast ----

TARGETS = ["239.1.2.3:5004", "239.1.2.3", "ff02::1:5004,eth0",
           "[ff02::1]:5004", "ff05::2%lo", "hf.local:5004", "host,eth1",
           "127.0.0.1:6000"]


@pytest.mark.parametrize("target", TARGETS)
def test_parse_target(target):
    assert mc_t._parse_target(target) == mc_j._parse_target(target)


def test_multicast_loopback():
    """The port's setup_mcast sockets carry a datagram over loopback to a
    receiver made by the JAX package's, and back."""
    rx_j = mc_j.setup_mcast(GROUP, output=False)
    rx_t = mc_t.setup_mcast(GROUP, output=False, offset=2)
    tx_t = mc_t.setup_mcast(GROUP, output=True)
    tx_j = mc_j.setup_mcast(GROUP, output=True, offset=2)
    try:
        for s in (rx_j, rx_t):
            s.settimeout(2.0)
        tx_t.send(b"port->jax")
        tx_j.send(b"jax->port")
        assert rx_j.recv(100) == b"port->jax"
        assert rx_t.recv(100) == b"jax->port"
    finally:
        for s in (rx_j, rx_t, tx_t, tx_j):
            s.close()


# ---- io/pcm ----

def _audio_blocks(rng, stereo):
    shape = lambda n: (n, 2) if stereo else (n,)
    blocks = []
    for n in (960, 960, 1000, 480, 37):
        x = 0.3 * rng.standard_normal(shape(n)).astype(np.float32)
        x[: n // 3] = 0.0                      # silence: suppressed packets
        blocks.append(x)
    blocks.append(np.zeros(shape(960), np.float32))
    blocks.append(np.full(shape(100), 1.5, np.float32))   # clipping
    return blocks


@pytest.mark.parametrize("kind", ["mono", "stereo", "mono_i16"])
def test_pcm_output_streams(kind):
    rng = np.random.default_rng(SEED + 40)
    blocks = _audio_blocks(rng, kind == "stereo")
    streams = []
    for mod in (pcm_t, pcm_j):
        sent = []
        out = mod.PCMOutput(send=sent.append, ssrc=0x1234)
        for i, b in enumerate(blocks):
            if kind == "mono":
                out.send_mono(b)
            elif kind == "stereo":
                out.send_stereo(b)
            else:
                out.send_mono_i16(pcm_j.scaleclip_int16(b))
            if i == 2:
                out.advance(960)
        streams.append((sent, vars(out.state), out.silent))
    assert streams[0] == streams[1]
    assert len(streams[0][0]) > 5


def test_scaleclip_and_pcm_to_float():
    rng = np.random.default_rng(SEED + 41)
    x = (2.5 * rng.standard_normal(5000)).astype(np.float32)
    np.testing.assert_array_equal(pcm_t.scaleclip_int16(x),
                                  pcm_j.scaleclip_int16(x))
    raw = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(pcm_t.pcm_to_float(raw),
                                  pcm_j.pcm_to_float(raw))
    assert pcm_t.PCM_BUFSIZE == pcm_j.PCM_BUFSIZE


# ---- io/assembler ----

def _iq_packets(rng, n_pkts, pt=rtp_j.IQ_PT):
    """A wideband RTP stream with reorders, duplicates, gaps, an SSRC
    change and malformed datagrams."""
    pkts = []
    for i in range(n_pkts):
        n = 240
        if pt == rtp_j.IQ_PT:
            pay = rng.integers(-32768, 32768, 2 * n, dtype=np.int16)
            pay = pay.astype("<i2").tobytes()
        else:
            pay = rng.integers(-128, 128, 2 * n, dtype=np.int8).tobytes()
        ssrc = 7 if i < n_pkts - 20 else 8
        h = rtp_j.RTPHeader(type=pt, seq=(60000 + i) & 0xFFFF,
                            timestamp=(2**32 - 3000 + i * n) & 0xFFFFFFFF,
                            ssrc=ssrc)
        pkts.append(h.to_bytes() + b"\x00" * 24 + pay)
    out = []
    i = 0
    while i < len(pkts):
        r = rng.random()
        if r < 0.05 and i + 1 < len(pkts):       # reorder a pair
            out += [pkts[i + 1], pkts[i]]
            i += 2
            continue
        if r < 0.10:                              # duplicate
            out += [pkts[i], pkts[i]]
        elif r < 0.15:                            # gap: packet lost
            pass
        elif r < 0.20:                            # malformed datagram
            out += [pkts[i][: int(rng.integers(0, 12))], pkts[i]]
        else:
            out.append(pkts[i])
        i += 1
    out.append(b"\x80\x0b" + b"\x00" * 30)        # a PCM packet: ignored
    return out


@pytest.mark.parametrize("pt,block", [(rtp_j.IQ_PT, 3840), (rtp_j.IQ_PT, 1000),
                                      (rtp_j.IQ_PT8, 3840)])
def test_block_assembler(pt, block):
    rng = np.random.default_rng(SEED + 50 + block + pt)
    pkts = _iq_packets(rng, 300, pt)
    a_t, a_j = asm_t.BlockAssembler(block), asm_j.BlockAssembler(block)
    got, want = [], []
    for p in pkts:
        a_t.push(p)
        a_j.push(p)
        got += list(a_t.blocks())
        want += list(a_j.blocks())
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex64
        np.testing.assert_array_equal(g, w)
    assert (a_t.samples, a_t.malformed) == (a_j.samples, a_j.malformed)
    assert vars(a_t.rtp_state) == vars(a_j.rtp_state)


# ---- io/iqfile ----

@pytest.mark.parametrize("pt", [rtp_j.IQ_PT, rtp_j.IQ_PT8])
def test_iq_record_and_replay(tmp_path, pt):
    """IQRecorder files (gaps left as holes) and their metadata, then
    IQReader blocks of them, byte- and bit-equal."""
    rng = np.random.default_rng(SEED + 60 + pt)
    files = {}
    for name, mod in (("port", iq_t), ("jax", iq_j)):
        d = tmp_path / name
        d.mkdir()
        rec = mod.IQRecorder(directory=str(d), frequency=1.0e7,
                             samprate=192000, source="src", multicast=GROUP)
        n_written = []
        for i in range(40):
            if i in (7, 8, 20):
                continue                           # lost packets: holes
            seq = (i + (1 if i == 30 else 0)) & 0xFFFF
            h = rtp_j.RTPHeader(type=pt, seq=seq, timestamp=i * 240, ssrc=5)
            r = np.random.default_rng(i)
            width = 2 if pt == rtp_j.IQ_PT else 1
            pay = r.integers(0, 256, 240 * 2 * width, dtype=np.uint8)
            n_written.append(rec.write_packet(h, pay.tobytes()))
        path = rec.path
        rec.close()
        meta = mod.read_metadata(path)
        meta.pop("unixstarttime")
        blocks = list(mod.IQReader(path).blocks(1000))
        files[name] = (os.path.basename(path), open(path, "rb").read(), meta,
                       n_written, blocks)
    p, j = files["port"], files["jax"]
    assert p[:4] == j[:4]
    assert len(p[4]) == len(j[4]) > 5
    for a, b in zip(p[4], j[4]):
        np.testing.assert_array_equal(a, b)


def test_metadata_round_trip(tmp_path):
    attrs = {"samplerate": "24576000", "frequency": "146000000.000",
             "sampleformat": "s16le", "note": "x=y"}
    for mod, other in ((iq_t, iq_j), (iq_j, iq_t)):
        f = tmp_path / f"m-{mod.__name__.split('.')[0]}"
        f.write_bytes(b"\x00" * 16)
        mod.write_metadata(str(f), attrs)
        assert other.read_metadata(str(f)) == mod.read_metadata(str(f)) \
            == attrs


# ---- utils/state ----

def test_state_files(tmp_path):
    st = dict(source="239.1.1.1:5004", output="239.2.2.2:5004", ttl=2,
              blocksize=7680, impulse_len=7681, frequency=147435000.125,
              mode="USB", shift=-250.0, filter_low=100.0, filter_high=2800.0,
              kaiser_beta=6.5, tunestep=3, locale="C")
    pt, pj = str(tmp_path / "port.state"), str(tmp_path / "jax.state")
    state_t.savestate(state_t.RadioState(**st), pt)
    state_j.savestate(state_j.RadioState(**st), pj)
    assert open(pt).read() == open(pj).read()
    with open(pt, "a") as f:
        f.write("Kaiser Beta 7.25\nBogus line\nTTL notanumber\n")
    with open(pj, "a") as f:
        f.write("Kaiser Beta 7.25\nBogus line\nTTL notanumber\n")
    assert vars(state_t.loadstate(pt)) == vars(state_j.loadstate(pj))
    assert state_t.state_path("rel") == state_j.state_path("rel")
    assert state_t.state_path("/abs/x") == "/abs/x"
