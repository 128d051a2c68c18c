// High-rate RTP I/Q engine: the native runtime under the receiver daemons.
//
// The reference's hot network loop is C (rtp_recv/proc_samples,
// main.c:288-362, radio.c:41-149).  This is its equivalent here: a
// dedicated receive thread drains the socket with recvmmsg batching,
// parses RTP, resequences (dupe drop, gap zero-fill -- the semantics of
// rtp_process, multicast.c:305-340), and assembles dense L-sample blocks
// of int16 I/Q into a lock-protected ring; the Python side takes each
// block as raw int16 or as packed float32 pairs and hands it to the card.
// At 24.576 Msps the payload stream is ~100 MB/s / 100k pkt/s -- far
// beyond a Python recv loop, a few percent of one core here.
//
// A matching sender paces int16 I/Q packets (iqplay's loop, iqplay.c:35-108)
// at wire rate with the legacy 24-byte status header, a multichannel PCM
// fan-out packetises a whole bank's output per block (audio.c), and a
// PCM -> Opus transcoder runs opus.c's main loop on a thread of its own.
//
// Plain C ABI for ctypes; no Python headers needed.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <net/if.h>
#include <netdb.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <condition_variable>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int RTP_MIN_SIZE = 12;
constexpr int IQ_PT = 97;
constexpr int IQ_PT8 = 98;
constexpr int LEGACY_STATUS = 24;
constexpr int BATCH = 64;               // recvmmsg batch
constexpr int MAX_PKT = 9216;

struct RtpHeader {
  int version;
  int type;
  uint16_t seq;
  uint32_t timestamp;
  uint32_t ssrc;
  bool marker;
  int payload_offset;
  int pad_len;      // trailing RTP padding bytes (0 if pad bit clear)
};

// ntoh_rtp equivalent (multicast.c:242-277); returns false if malformed.
bool parse_rtp(const uint8_t* d, int len, RtpHeader* h) {
  if (len < RTP_MIN_SIZE) return false;
  h->version = d[0] >> 6;
  int cc = d[0] & 0xF;
  bool extension = (d[0] >> 4) & 1;
  bool pad = (d[0] >> 5) & 1;
  h->marker = d[1] >> 7;
  h->type = d[1] & 0x7F;
  h->seq = (uint16_t)((d[2] << 8) | d[3]);
  h->timestamp = ((uint32_t)d[4] << 24) | (d[5] << 16) | (d[6] << 8) | d[7];
  h->ssrc = ((uint32_t)d[8] << 24) | (d[9] << 16) | (d[10] << 8) | d[11];
  int off = 12 + 4 * cc;
  if (extension) {
    if (len < off + 4) return false;
    int ext_len = (d[off + 2] << 8) | d[off + 3];
    off += 4 + 4 + ext_len;  // matches multicast.c:269-275
  }
  if (off > len) return false;
  h->payload_offset = off;
  // RFC 3550 §5.1: with the pad bit set, the last octet counts the
  // padding (itself included).  The reference strips it before decode
  // (opus.c:190-194) and so does net/rtp.py rtp_payload — consumers
  // here subtract pad_len from the payload length.  A bogus pad count
  // (0 or more than the payload) yields an EMPTY payload, exactly
  // rtp_payload's tolerance, not a parse failure.
  h->pad_len = 0;
  if (pad && len > off) {
    int pl = d[len - 1];
    h->pad_len = (pl <= 0 || pl > len - off) ? (len - off) : pl;
  }
  return true;
}

// Resolve a numeric group literal (dotted quad, or an IPv6 literal with
// an optional RFC 4007 "%zone") + port to its sockaddr.  Dual-stack like
// the reference's PF_UNSPEC getaddrinfo loop (multicast.c:160-201); name
// resolution stays host-side in the Python wrappers.  Returns the
// address family, or -1.
int resolve_udp(const char* group, int port, sockaddr_storage* ss,
                socklen_t* slen) {
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_DGRAM;
  hints.ai_protocol = IPPROTO_UDP;
  hints.ai_flags = AI_NUMERICHOST | AI_NUMERICSERV;
  char ps[16];
  snprintf(ps, sizeof(ps), "%d", port);
  addrinfo* res = nullptr;
  if (getaddrinfo(group, ps, &hints, &res) != 0 || !res) return -1;
  memcpy(ss, res->ai_addr, res->ai_addrlen);
  *slen = (socklen_t)res->ai_addrlen;
  int fam = res->ai_family;
  freeaddrinfo(res);
  return fam;
}

// IGMP/MLD-snooping workaround join, both directions (multicast.c:208-217).
// Returns false only when the address IS multicast and the join failed
// (a receiver that can't join is silently deaf on a snooping switch).
bool join_own_group(int fd, const sockaddr_storage* ss) {
  if (ss->ss_family == AF_INET6) {
    auto* s6 = (const sockaddr_in6*)ss;
    if (!IN6_IS_ADDR_MULTICAST(&s6->sin6_addr)) return true;
    ipv6_mreq m{};
    m.ipv6mr_multiaddr = s6->sin6_addr;
    m.ipv6mr_interface = s6->sin6_scope_id;  // 0 = kernel default
    return setsockopt(fd, IPPROTO_IPV6, IPV6_JOIN_GROUP, &m, sizeof(m)) ==
           0;
  }
  auto* s4 = (const sockaddr_in*)ss;
  if (!IN_MULTICAST(ntohl(s4->sin_addr.s_addr))) return true;
  ip_mreq m{};
  m.imr_multiaddr = s4->sin_addr;
  m.imr_interface.s_addr = INADDR_ANY;
  return setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &m, sizeof(m)) == 0;
}

int make_mcast_rx(const char* group, int port) {
  sockaddr_storage ss{};
  socklen_t slen = 0;
  int fam = resolve_udp(group, port, &ss, &slen);
  if (fam < 0) return -1;
  int fd = socket(fam, SOCK_DGRAM, IPPROTO_UDP);
  if (fd < 0) return -1;
  int reuse = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &reuse, sizeof(reuse));
  int rcvbuf = 32 << 20;
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  // bind the group address itself (destination filter; multicast.c:197).
  // FAIL LOUDLY on a bad group string or bind failure — the old
  // INADDR_ANY fallback either left the daemon silently deaf (failed
  // group join) or cross-delivered every stream on the port, and the
  // Python net/multicast.py deliberately removed exactly this fallback.
  if (bind(fd, (sockaddr*)&ss, slen) < 0) {
    close(fd);
    return -1;
  }
  if (!join_own_group(fd, &ss)) {
    close(fd);
    return -1;
  }
  timeval tv{0, 200000};  // wake periodically to check shutdown
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  return fd;
}

// Connected multicast send socket with per-family TTL/hops + loopback and
// the own-group join (multicast.c:173-217, output branch).
int make_mcast_tx(const char* group, int port, int ttl) {
  sockaddr_storage ss{};
  socklen_t slen = 0;
  int fam = resolve_udp(group, port, &ss, &slen);
  if (fam < 0) return -1;
  int fd = socket(fam, SOCK_DGRAM, IPPROTO_UDP);
  if (fd < 0) return -1;
  if (fam == AF_INET6) {
    int hops = ttl, loop = 1;
    setsockopt(fd, IPPROTO_IPV6, IPV6_MULTICAST_HOPS, &hops, sizeof(hops));
    setsockopt(fd, IPPROTO_IPV6, IPV6_MULTICAST_LOOP, &loop, sizeof(loop));
    auto* s6 = (const sockaddr_in6*)&ss;
    if (s6->sin6_scope_id) {  // scoped (link-local) group: pin the egress
      unsigned idx = s6->sin6_scope_id;
      setsockopt(fd, IPPROTO_IPV6, IPV6_MULTICAST_IF, &idx, sizeof(idx));
    }
  } else {
    unsigned char t = (unsigned char)ttl, loop = 1;
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &t, sizeof(t));
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));
  }
  if (connect(fd, (sockaddr*)&ss, slen) < 0) {
    close(fd);
    return -1;
  }
  join_own_group(fd, &ss);  // best-effort on the send side
  return fd;
}

// Family-agnostic sender identity for session demux keys: the v4 address
// word, or an FNV-1a fold of the 16 v6 bytes.
inline uint32_t sender_hash(const sockaddr_storage& ss) {
  if (ss.ss_family == AF_INET6) {
    auto* s6 = (const sockaddr_in6*)&ss;
    uint32_t h = 2166136261u;
    for (int i = 0; i < 16; i++) {
      h ^= s6->sin6_addr.s6_addr[i];
      h *= 16777619u;
    }
    return h;
  }
  return ((const sockaddr_in*)&ss)->sin_addr.s_addr;
}

inline uint32_t sender_port(const sockaddr_storage& ss) {
  return ss.ss_family == AF_INET6 ? ((const sockaddr_in6*)&ss)->sin6_port
                                  : ((const sockaddr_in*)&ss)->sin_port;
}

struct RxEngine {
  int fd = -1;
  int block_len;        // samples per block
  int skip_legacy;
  int nblocks;          // ring depth in blocks
  // ring stores raw int16 pairs: half the memory and host-to-device bytes
  // of float, and the card converts them
  std::vector<int16_t> ring;  // nblocks * block_len * 2 int16
  std::atomic<long long> wseq{0};  // completed blocks
  long long rseq = 0;              // blocks consumed
  std::mutex mu;
  std::condition_variable cv;
  std::thread thread;
  std::atomic<bool> stop{false};

  // stream state (struct rtp_state, multicast.h:41-50)
  bool init = false;
  uint32_t ssrc = 0;
  uint16_t seq = 0;
  uint32_t timestamp = 0;
  std::atomic<long long> packets{0}, drops{0}, dupes{0}, gap_samples{0},
      overruns{0};

  int fill = 0;       // samples in the current block
  int16_t* cur() { return &ring[(wseq % nblocks) * (size_t)block_len * 2]; }

  void commit_block() {
    {
      std::lock_guard<std::mutex> lk(mu);
      long long w = wseq.load() + 1;
      // Keep ONE slot of gap (effective capacity nblocks-1): the writer
      // fills cur() = slot wseq OUTSIDE this mutex, so letting the ring
      // reach wseq-rseq == nblocks would alias the fill slot with the
      // slot the reader is memcpy-ing under the lock (torn blocks once
      // a consumer stalls >1.2 s, e.g. a first kernel build).
      if (w - rseq > nblocks - 1) {  // overrun: drop oldest
        rseq = w - (nblocks - 1);
        overruns++;
      }
      wseq.store(w);
    }
    cv.notify_one();
    fill = 0;
  }

  void push_zeros(int n) {
    while (n > 0) {
      int take = std::min(n, block_len - fill);
      memset(cur() + (size_t)fill * 2, 0, (size_t)take * 2 * sizeof(int16_t));
      fill += take;
      n -= take;
      if (fill == block_len) commit_block();
    }
  }

  void push_samples16(const int16_t* s, int n) {
    while (n > 0) {
      int take = std::min(n, block_len - fill);
      memcpy(cur() + (size_t)fill * 2, s, (size_t)take * 2 * sizeof(int16_t));
      s += 2 * take;
      fill += take;
      n -= take;
      if (fill == block_len) commit_block();
    }
  }

  void push_samples8(const int8_t* s, int n) {
    // preserve the reference scaling: v/127 full scale -> v*258 in int16
    while (n > 0) {
      int take = std::min(n, block_len - fill);
      int16_t* dst = cur() + (size_t)fill * 2;
      for (int i = 0; i < 2 * take; i++) dst[i] = (int16_t)(s[i] * 258);
      s += 2 * take;
      fill += take;
      n -= take;
      if (fill == block_len) commit_block();
    }
  }

  void handle(const uint8_t* data, int len) {
    RtpHeader h;
    if (!parse_rtp(data, len, &h)) return;
    if (h.type != IQ_PT && h.type != IQ_PT8) return;
    const uint8_t* payload = data + h.payload_offset;
    int plen = len - h.payload_offset - h.pad_len;  // strip RTP padding
    if (skip_legacy) {  // main.c:338-341: unconditional 24-byte skip
      if (plen < LEGACY_STATUS) return;
      payload += LEGACY_STATUS;
      plen -= LEGACY_STATUS;
    }
    int sampcnt = (h.type == IQ_PT) ? plen / 4 : plen / 2;

    // rtp_process (multicast.c:305-340)
    if (h.ssrc != ssrc) { init = false; ssrc = h.ssrc; }
    if (!init) {
      seq = h.seq;
      timestamp = h.timestamp;
      init = true;
    }
    packets++;
    int16_t seq_step = (int16_t)(h.seq - seq);
    if (seq_step != 0) {
      if (seq_step < 0) { dupes++; return; }
      drops += seq_step;
    }
    seq = h.seq + 1;
    int32_t time_step = (int32_t)(h.timestamp - timestamp);
    if (time_step < 0) return;  // old/dup: state untouched (multicast.c:334)
    // Re-sync the expected timestamp BEFORE the too-big-jump drop, exactly
    // like rtp_process (multicast.c:334-339): the caller discards the
    // packet (radio.c:77-79) but the stream recovers on the next one.  A
    // producer restart that keeps its SSRC but picks a new timestamp
    // origin must not black out ingest until int32 wrap.
    timestamp = h.timestamp + sampcnt;
    // Gap-fill sanity cap, ring-bounded: zero-filling more than the ring
    // holds just flushes every real sample for no benefit (the reference
    // caps at ~1 s, radio.c:77-79; one ring is 1.28 s at 20 ms blocks).
    // A single bit-flipped timestamp used to inject up to 2^24 zeros.
    if ((long long)time_step > (long long)nblocks * block_len) return;
    if (time_step > 0) {
      gap_samples += time_step;
      push_zeros(time_step);
    }
    if (h.type == IQ_PT)
      push_samples16((const int16_t*)payload, sampcnt);
    else
      push_samples8((const int8_t*)payload, sampcnt);
  }

  void run() {
    std::vector<std::vector<uint8_t>> bufs(BATCH,
                                           std::vector<uint8_t>(MAX_PKT));
    mmsghdr msgs[BATCH];
    iovec iovs[BATCH];
    for (int i = 0; i < BATCH; i++) {
      iovs[i] = {bufs[i].data(), (size_t)MAX_PKT};
      memset(&msgs[i], 0, sizeof(msgs[i]));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    // Some network stacks (user-space ones that sandboxed hosts run)
    // refuse MSG_WAITFORONE with EINVAL; the engine would then spin deaf.
    // There the same batch takes two calls: block for one datagram, then
    // take whatever else is queued without waiting.
    bool waitforone = true;
    while (!stop.load()) {
      int n;
      if (waitforone) {
        n = recvmmsg(fd, msgs, BATCH, MSG_WAITFORONE, nullptr);
        if (n < 0 && errno == EINVAL) waitforone = false;
      } else {
        n = recvmmsg(fd, msgs, 1, 0, nullptr);
        if (n == 1) {
          int more = recvmmsg(fd, msgs + 1, BATCH - 1, MSG_DONTWAIT, nullptr);
          if (more > 0) n += more;
        }
      }
      if (n <= 0) continue;
      for (int i = 0; i < n; i++)
        handle(bufs[i].data(), msgs[i].msg_len);
    }
  }
};

struct TxEngine {
  int fd = -1;
  uint16_t seq = 0;
  uint32_t timestamp = 0;
  uint32_t ssrc;
  int samprate;
  double frequency;
  long long t0_us = 0;   // pacing epoch
  long long sent_samples = 0;
};

// Multichannel PCM fan-out (audio.c:19-143 semantics per channel, batched
// for the bank): one socket, one RTP session per channel (SSRC = base+ch),
// big-endian int16 payloads, <=pkt_samples frames per packet, silence
// suppression (all-zero packets are not sent but the timestamp advances,
// audio.c:102-113) and the marker bit on the first packet of a talk spurt
// (audio.c:51-61).  Doing this in C instead of Python matters on small
// hosts: a 64-active-channel bank is ~128 packets of byte-swapped PCM
// every 20 ms.
struct PcmTxEngine {
  int fd = -1;
  uint32_t ssrc_base;
  int channels;  // 1 mono / 2 stereo (PT 11 / 10, multicast.h:19-24)
  struct Ch {
    uint16_t seq = 0;
    uint32_t timestamp = 0;
    bool silent = true;
    uint32_t ssrc_override = 0;  // 0 = ssrc_base + channel (the default)
  };
  std::vector<Ch> ch;
  std::atomic<long long> packets{0};
};

long long now_us() {
  timeval tv;
  gettimeofday(&tv, nullptr);
  return (long long)tv.tv_sec * 1000000 + tv.tv_usec;
}

// ---------------------------------------------------------------------
// Native Opus transcoder: the opus.c main loop (opus.c:246-397) in C++.
// Everything but libopus itself runs here on one thread: recvmmsg
// batching, session demux by (sender, SSRC), rtp_process resequencing,
// talk-spurt/gap encoder resets, DTX suppression, marker bits -- the
// semantics of audio/transcode.py, byte for byte.
//
// libopus may ship without its development headers; its stable ABI is
// declared here and resolved with dlopen("libopus.so.0").  opus_tx_create
// returns null if the library is absent.

constexpr int PCM_STEREO_PT = 10;   // multicast.h:19-24
constexpr int PCM_MONO_PT = 11;
constexpr int OPUS_PT = 111;
constexpr int OPUS_APPLICATION_AUDIO = 2049;
constexpr int OPUS_SET_BITRATE = 4002;
constexpr int OPUS_SET_COMPLEXITY = 4010;
constexpr int OPUS_SET_INBAND_FEC = 4012;
constexpr int OPUS_SET_PACKET_LOSS_PERC = 4014;
constexpr int OPUS_SET_DTX = 4016;
constexpr int OPUS_RESET_STATE = 4028;

struct OpusApi {
  void* dl = nullptr;
  void* (*encoder_create)(int32_t, int, int, int*) = nullptr;
  int32_t (*encode_float)(void*, const float*, int, unsigned char*,
                          int32_t) = nullptr;
  int (*encoder_ctl)(void*, int, ...) = nullptr;
  void (*encoder_destroy)(void*) = nullptr;

  bool load() {
    if (dl) return true;
    dl = dlopen("libopus.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!dl) dl = dlopen("libopus.so", RTLD_NOW | RTLD_GLOBAL);
    if (!dl) return false;
    encoder_create = (decltype(encoder_create))dlsym(dl, "opus_encoder_create");
    encode_float = (decltype(encode_float))dlsym(dl, "opus_encode_float");
    encoder_ctl = (decltype(encoder_ctl))dlsym(dl, "opus_encoder_ctl");
    encoder_destroy =
        (decltype(encoder_destroy))dlsym(dl, "opus_encoder_destroy");
    return encoder_create && encode_float && encoder_ctl && encoder_destroy;
  }
};

OpusApi g_opus;
std::mutex g_opus_mu;

// Per-(sender, SSRC) encoder state (struct session, opus.c:25-44; mirrors
// audio/transcode.py OpusSession so the two paths are differential-testable).
struct OpusTxSession {
  void* enc = nullptr;
  std::vector<float> buf;  // interleaved stereo accumulate
  // input rtp_process state (multicast.c:305-340)
  bool init = false;
  uint16_t seq_in = 0;
  uint32_t ts_in = 0;
  // output stream state
  uint16_t seq_out = 0;
  uint32_t ts_out = 0;
  bool silent = true;
  uint32_t ssrc = 0;
};

struct OpusTxEngine {
  int in_fd = -1, out_fd = -1;
  int bitrate, frame_len, fec;
  int complexity;  // -1 = libopus default (the reference never sets it)
  bool dtx;
  int max_sessions;
  std::map<std::array<uint32_t, 3>, OpusTxSession> sessions;
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<long long> pkts_in{0}, pkts_out{0}, frames_enc{0},
      n_sessions{0}, dupes{0}, resets{0}, rejected{0};

  void* make_encoder() {
    int err = 0;
    void* e = g_opus.encoder_create(48000, 2, OPUS_APPLICATION_AUDIO, &err);
    if (!e || err) return nullptr;
    g_opus.encoder_ctl(e, OPUS_SET_BITRATE, bitrate);
    g_opus.encoder_ctl(e, OPUS_SET_DTX, dtx ? 1 : 0);
    if (complexity >= 0)  // deployment knob (opus.c never sets it)
      g_opus.encoder_ctl(e, OPUS_SET_COMPLEXITY, complexity);
    if (fec) {  // expected-loss %, opus.c:62,232-239
      g_opus.encoder_ctl(e, OPUS_SET_INBAND_FEC, 1);
      g_opus.encoder_ctl(e, OPUS_SET_PACKET_LOSS_PERC, fec);
    }
    return e;
  }

  void emit(OpusTxSession& s) {
    // drain whole frames out of the accumulate buffer (opus.c:356-397)
    unsigned char pkt[RTP_MIN_SIZE + 4000];
    size_t off = 0;
    while (s.buf.size() - off >= (size_t)frame_len * 2) {
      int32_t n = g_opus.encode_float(s.enc, s.buf.data() + off, frame_len,
                                      pkt + RTP_MIN_SIZE, 4000);
      off += (size_t)frame_len * 2;
      uint32_t ts = s.ts_out;
      s.ts_out += (uint32_t)frame_len;
      frames_enc++;
      if (n < 0) continue;  // encoder error: drop the frame, keep the clock
      if (n <= 2) {  // DTX: no packet, timestamp advances (opus.c:372-379)
        s.silent = true;
        continue;
      }
      uint8_t* p = pkt;
      *p++ = 0x80;
      *p++ = (uint8_t)((s.silent ? 0x80 : 0) | OPUS_PT);
      *p++ = s.seq_out >> 8; *p++ = s.seq_out & 0xFF;
      s.seq_out++;
      *p++ = ts >> 24; *p++ = ts >> 16; *p++ = ts >> 8; *p++ = ts;
      uint32_t ss = s.ssrc;
      *p++ = ss >> 24; *p++ = ss >> 16; *p++ = ss >> 8; *p++ = ss;
      s.silent = false;
      if (send(out_fd, pkt, RTP_MIN_SIZE + n, 0) >= 0) pkts_out++;
    }
    if (off) s.buf.erase(s.buf.begin(), s.buf.begin() + off);
  }

  void handle(const uint8_t* data, int len, const sockaddr_storage& from) {
    RtpHeader h;
    if (!parse_rtp(data, len, &h)) return;
    if (h.type != PCM_MONO_PT && h.type != PCM_STEREO_PT) return;
    pkts_in++;
    std::array<uint32_t, 3> key{sender_hash(from), sender_port(from),
                                h.ssrc};
    auto it = sessions.find(key);
    if (it == sessions.end()) {
      if ((int)sessions.size() >= max_sessions) {  // hostile-SSRC flood cap
        rejected++;
        return;
      }
      void* enc = make_encoder();
      if (!enc) return;
      it = sessions.emplace(key, OpusTxSession{}).first;
      it->second.enc = enc;
      it->second.ssrc = h.ssrc;
      n_sessions++;
    }
    OpusTxSession& s = it->second;

    const int channels = (h.type == PCM_MONO_PT) ? 1 : 2;
    const uint8_t* payload = data + h.payload_offset;
    int plen = len - h.payload_offset - h.pad_len;  // strip RTP padding
    int frames = plen / (2 * channels);  // ragged tails truncated

    // rtp_process (multicast.c:305-340), per session
    if (!s.init) {
      s.seq_in = h.seq;
      s.ts_in = h.timestamp;
      s.init = true;
    }
    int16_t seq_step = (int16_t)(h.seq - s.seq_in);
    if (seq_step < 0) { dupes++; return; }
    s.seq_in = h.seq + 1;
    int32_t gap = (int32_t)(h.timestamp - s.ts_in);
    if (gap < 0) { dupes++; return; }
    s.ts_in = h.timestamp + (uint32_t)frames;

    if (h.marker || gap > 4 * frame_len) {
      // talk-spurt start or long gap: in-place reset (opus.c:251-255)
      g_opus.encoder_ctl(s.enc, OPUS_RESET_STATE);
      s.buf.clear();
      s.ts_out += (uint32_t)gap;
      s.silent = true;
      resets++;
    } else if (gap > 0) {
      s.buf.insert(s.buf.end(), (size_t)gap * 2, 0.0f);
    }
    // big-endian int16 -> float stereo, matching transcode.py's
    // float32(v)/32767.0 exactly (the differential test depends on it)
    size_t base = s.buf.size();
    s.buf.resize(base + (size_t)frames * 2);
    float* dst = s.buf.data() + base;
    if (channels == 1) {
      for (int i = 0; i < frames; i++) {
        int16_t v = (int16_t)((payload[2 * i] << 8) | payload[2 * i + 1]);
        float f = (float)v / 32767.0f;
        dst[2 * i] = f;
        dst[2 * i + 1] = f;
      }
    } else {
      for (int i = 0; i < 2 * frames; i++) {
        int16_t v = (int16_t)((payload[2 * i] << 8) | payload[2 * i + 1]);
        dst[i] = (float)v / 32767.0f;
      }
    }
    emit(s);
  }

  void run() {
    std::vector<std::vector<uint8_t>> bufs(BATCH,
                                           std::vector<uint8_t>(MAX_PKT));
    mmsghdr msgs[BATCH];
    iovec iovs[BATCH];
    sockaddr_storage addrs[BATCH];
    for (int i = 0; i < BATCH; i++) {
      iovs[i] = {bufs[i].data(), (size_t)MAX_PKT};
      memset(&msgs[i], 0, sizeof(msgs[i]));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    // Each call overwrites msg_namelen with the sender's address length,
    // so every slot a call may fill gets its name buffer back first.
    auto arm = [&](int first, int count) {
      for (int i = first; i < first + count; i++) {
        msgs[i].msg_hdr.msg_name = &addrs[i];
        msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_storage);
      }
    };
    // Where the network stack refuses MSG_WAITFORONE with EINVAL (as
    // RxEngine::run explains), block for one datagram, then take whatever
    // else is queued without waiting.  The socket's SO_RCVTIMEO
    // (make_mcast_rx) wakes the blocking call to check for a stop.
    bool waitforone = true;
    while (!stop.load()) {
      int n;
      if (waitforone) {
        arm(0, BATCH);
        n = recvmmsg(in_fd, msgs, BATCH, MSG_WAITFORONE, nullptr);
        if (n < 0 && errno == EINVAL) waitforone = false;
      } else {
        arm(0, 1);
        n = recvmmsg(in_fd, msgs, 1, 0, nullptr);
        if (n == 1) {
          arm(1, BATCH - 1);
          int more =
              recvmmsg(in_fd, msgs + 1, BATCH - 1, MSG_DONTWAIT, nullptr);
          if (more > 0) n += more;
        }
      }
      if (n <= 0) continue;
      for (int i = 0; i < n; i++)
        handle(bufs[i].data(), msgs[i].msg_len, addrs[i]);
    }
  }
};

}  // namespace

extern "C" {

// Test-only: run the wire parser on an arbitrary datagram so the Python
// suite can differentially fuzz it against net/rtp.py's parser.  out8 =
// {version, type, seq, timestamp, ssrc, marker, payload_offset, pad_len}.
int rtp_parse_probe(const uint8_t* data, int len, long long* out8) {
  RtpHeader h;
  if (!parse_rtp(data, len, &h)) return 0;
  out8[0] = h.version;
  out8[1] = h.type;
  out8[2] = h.seq;
  out8[3] = h.timestamp;
  out8[4] = h.ssrc;
  out8[5] = h.marker ? 1 : 0;
  out8[6] = h.payload_offset;
  out8[7] = h.pad_len;
  return 1;
}

void* rtp_rx_create(const char* group, int port, int block_len,
                    int skip_legacy, int ring_blocks) {
  int fd = make_mcast_rx(group, port);
  if (fd < 0) return nullptr;
  auto* e = new RxEngine();
  e->fd = fd;
  e->block_len = block_len;
  e->skip_legacy = skip_legacy;
  // floor of 2: the ring keeps one slot of writer/reader gap (effective
  // capacity nblocks-1, see commit_block), so a 1-block ring would be
  // permanently deaf — every commit would immediately drop itself
  e->nblocks = ring_blocks > 1 ? ring_blocks : (ring_blocks == 1 ? 2 : 64);
  e->ring.resize((size_t)e->nblocks * block_len * 2);
  e->thread = std::thread(&RxEngine::run, e);
  return e;
}

// Copy the next dense block into out (block_len*2 floats).  Returns 1 on
// success, 0 on timeout.
int rtp_rx_get_block(void* h, float* out, int timeout_ms) {
  auto* e = (RxEngine*)h;
  std::unique_lock<std::mutex> lk(e->mu);
  if (!e->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [e] { return e->wseq.load() > e->rseq; }))
    return 0;
  const int16_t* src =
      &e->ring[(e->rseq % e->nblocks) * (size_t)e->block_len * 2];
  constexpr float SCALE = 1.0f / 32767.0f;  // radio.c:38
  for (size_t i = 0; i < (size_t)e->block_len * 2; i++)
    out[i] = (float)src[i] * SCALE;
  e->rseq++;
  return 1;
}

// Raw int16 block (the card converts it; preferred ingest path).
int rtp_rx_get_block_i16(void* h, int16_t* out, int timeout_ms) {
  auto* e = (RxEngine*)h;
  std::unique_lock<std::mutex> lk(e->mu);
  if (!e->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [e] { return e->wseq.load() > e->rseq; }))
    return 0;
  const int16_t* src =
      &e->ring[(e->rseq % e->nblocks) * (size_t)e->block_len * 2];
  memcpy(out, src, (size_t)e->block_len * 2 * sizeof(int16_t));
  e->rseq++;
  return 1;
}

void rtp_rx_stats(void* h, long long* out6) {
  auto* e = (RxEngine*)h;
  out6[0] = e->packets.load();
  out6[1] = e->drops.load();
  out6[2] = e->dupes.load();
  out6[3] = e->gap_samples.load();
  out6[4] = e->overruns.load();
  out6[5] = e->wseq.load();
}

void rtp_rx_destroy(void* h) {
  auto* e = (RxEngine*)h;
  e->stop.store(true);
  if (e->thread.joinable()) e->thread.join();
  close(e->fd);
  delete e;
}

void* rtp_tx_create(const char* group, int port, int samprate,
                    double frequency, int ttl, unsigned int ssrc) {
  int fd = make_mcast_tx(group, port, ttl);
  if (fd < 0) return nullptr;
  auto* e = new TxEngine();
  e->fd = fd;
  e->samprate = samprate;
  e->frequency = frequency;
  e->ssrc = ssrc;
  e->t0_us = now_us();
  return e;
}

// Send int16 interleaved I/Q as IQ_PT packets of pkt_samples each, with the
// legacy status header.  realtime!=0 paces against the sample clock.
int rtp_tx_send(void* h, const int16_t* iq, int nsamples, int pkt_samples,
                int realtime) {
  auto* e = (TxEngine*)h;
  uint8_t pkt[MAX_PKT];
  // clamp to the stack buffer (12 RTP + 24 legacy status + 4 B/sample);
  // Python callers already cap -b at 2048, this guards the raw C ABI
  constexpr int kMaxChunk = (MAX_PKT - RTP_MIN_SIZE - LEGACY_STATUS) / 4;
  if (pkt_samples > kMaxChunk) pkt_samples = kMaxChunk;
  if (pkt_samples <= 0) return -1;
  int sent = 0;
  while (nsamples > 0) {
    int chunk = std::min(nsamples, pkt_samples);
    uint8_t* p = pkt;
    *p++ = 0x80;  // v2
    *p++ = IQ_PT;
    *p++ = e->seq >> 8; *p++ = e->seq & 0xFF;
    e->seq++;
    uint32_t ts = e->timestamp;
    *p++ = ts >> 24; *p++ = ts >> 16; *p++ = ts >> 8; *p++ = ts;
    uint32_t ss = e->ssrc;
    *p++ = ss >> 24; *p++ = ss >> 16; *p++ = ss >> 8; *p++ = ss;
    // legacy 24-byte status, host byte order (sdr.h:18-48)
    long long ts_ns = 0;
    memcpy(p, &ts_ns, 8);
    memcpy(p + 8, &e->frequency, 8);
    uint32_t sr = e->samprate;
    memcpy(p + 16, &sr, 4);
    memset(p + 20, 0, 4);
    p += LEGACY_STATUS;
    memcpy(p, iq, (size_t)chunk * 4);
    p += (size_t)chunk * 4;
    if (send(e->fd, pkt, p - pkt, 0) < 0) return sent;
    e->timestamp += chunk;
    e->sent_samples += chunk;
    iq += 2 * chunk;
    nsamples -= chunk;
    sent++;
    if (realtime) {
      long long due =
          e->t0_us + e->sent_samples * 1000000LL / e->samprate;
      long long delay = due - now_us();
      if (delay > 0) usleep((useconds_t)delay);
    }
  }
  return sent;
}

void rtp_tx_destroy(void* h) {
  auto* e = (TxEngine*)h;
  close(e->fd);
  delete e;
}

void* pcm_tx_create(const char* group, int port, int ttl,
                    unsigned int ssrc_base, int max_channels, int channels) {
  int fd = make_mcast_tx(group, port, ttl);
  if (fd < 0) return nullptr;
  auto* e = new PcmTxEngine();
  e->fd = fd;
  e->ssrc_base = ssrc_base;
  e->channels = channels == 2 ? 2 : 1;
  e->ch.resize(max_channels > 0 ? max_channels : 1);
  return e;
}

// One bank block: pcm holds n_rows x (block_len*channels) host-order
// int16 frames; ch_ids[i] is row i's logical channel (-1 = unused slot,
// the compacted active-set format of bank_step_active).  EVERY channel's
// RTP timestamp advances by block_len frames (silent channels keep
// sample-accurate clocks, audio.c:107-110); rows present are packetised
// and sent unless all-zero.  Returns packets sent.
long long pcm_tx_send_block(void* h, const int16_t* pcm,
                            const int32_t* ch_ids, int n_rows,
                            int block_len, int pkt_samples) {
  auto* e = (PcmTxEngine*)h;
  const int nch = e->channels;
  const int pt = nch == 2 ? 10 : 11;   // PCM stereo/mono (multicast.h:19-24)
  // clamp to what fits one datagram; reject nonsense (a too-large value
  // would overflow the stack buffer, <=0 would never advance)
  const int max_frames = (MAX_PKT - RTP_MIN_SIZE) / (2 * nch);
  if (pkt_samples > max_frames) pkt_samples = max_frames;
  if (pkt_samples <= 0 || block_len <= 0) return -1;
  uint8_t pkt[MAX_PKT];
  long long sent = 0;
  std::vector<uint32_t> base_ts(e->ch.size());
  for (size_t c = 0; c < e->ch.size(); c++) {
    base_ts[c] = e->ch[c].timestamp;
    e->ch[c].timestamp += (uint32_t)block_len;
  }
  // Channels absent from this block's active set were suppressed (the
  // compacted bank omits squelched channels entirely): mark them silent
  // so their next packet carries the talk-spurt marker (audio.c:51-61).
  {
    std::vector<bool> present(e->ch.size(), false);
    for (int r = 0; r < n_rows; r++)
      if (ch_ids[r] >= 0 && (size_t)ch_ids[r] < e->ch.size())
        present[ch_ids[r]] = true;
    for (size_t c = 0; c < e->ch.size(); c++)
      if (!present[c]) e->ch[c].silent = true;
  }
  for (int r = 0; r < n_rows; r++) {
    int32_t c = ch_ids[r];
    if (c < 0 || (size_t)c >= e->ch.size()) continue;
    auto& st = e->ch[c];
    const int16_t* row = pcm + (size_t)r * block_len * nch;
    int off = 0;   // frames consumed
    while (off < block_len) {
      int chunk = std::min(pkt_samples, block_len - off);
      const int16_t* s = row + (size_t)off * nch;
      bool all_zero = true;
      for (int i = 0; i < chunk * nch; i++)
        if (s[i] != 0) { all_zero = false; break; }
      if (all_zero) {           // silence suppression (audio.c:102-113)
        st.silent = true;
        off += chunk;
        continue;
      }
      uint8_t* p = pkt;
      *p++ = 0x80;
      *p++ = (uint8_t)((st.silent ? 0x80 : 0) | pt);  // marker on resume
      *p++ = st.seq >> 8; *p++ = st.seq & 0xFF;
      st.seq++;
      uint32_t ts = base_ts[c] + (uint32_t)off;
      *p++ = ts >> 24; *p++ = ts >> 16; *p++ = ts >> 8; *p++ = ts;
      uint32_t ss = st.ssrc_override ? st.ssrc_override
                                     : e->ssrc_base + (uint32_t)c;
      *p++ = ss >> 24; *p++ = ss >> 16; *p++ = ss >> 8; *p++ = ss;
      for (int i = 0; i < chunk * nch; i++) {  // big-endian samples
        uint16_t v = (uint16_t)s[i];
        *p++ = v >> 8;
        *p++ = v & 0xFF;
      }
      if (send(e->fd, pkt, p - pkt, 0) < 0) return sent;
      st.silent = false;
      sent++;
      off += chunk;
    }
  }
  e->packets += sent;
  return sent;
}

// Live mode migration (radio.c:322-374 as a state edit): a channel slot
// adopts the migrating channel's wire SSRC.  The output stream restarts
// (seq/timestamp reset, next packet marked) exactly like the reference's
// respawned demod thread.  ssrc=0 restores the default base+slot mapping.
void pcm_tx_set_ssrc(void* h, int ch, unsigned int ssrc) {
  auto* e = (PcmTxEngine*)h;
  if (ch < 0 || (size_t)ch >= e->ch.size()) return;
  auto& st = e->ch[ch];
  st.ssrc_override = ssrc;
  st.seq = 0;
  st.timestamp = 0;
  st.silent = true;
}

void pcm_tx_destroy(void* h) {
  auto* e = (PcmTxEngine*)h;
  close(e->fd);
  delete e;
}

// Native PCM->Opus transcoder (opus.c main loop).  frame_len is samples
// per Opus frame at 48 kHz (Python validates legality, opus.c option
// check); fec is the expected packet-loss percentage (0 = off).  Returns
// null if libopus cannot be loaded or sockets fail.
void* opus_tx_create(const char* in_group, int in_port, const char* out_group,
                     int out_port, int bitrate, int frame_len, int dtx,
                     int fec, int ttl, int max_sessions, int complexity) {
  {
    std::lock_guard<std::mutex> lk(g_opus_mu);
    if (!g_opus.load()) return nullptr;
  }
  int in_fd = make_mcast_rx(in_group, in_port);
  if (in_fd < 0) return nullptr;
  int out_fd = make_mcast_tx(out_group, out_port, ttl);
  if (out_fd < 0) {
    close(in_fd);
    return nullptr;
  }
  auto* e = new OpusTxEngine();
  e->in_fd = in_fd;
  e->out_fd = out_fd;
  e->bitrate = bitrate;
  e->frame_len = frame_len;
  e->dtx = dtx != 0;
  e->fec = fec;
  e->max_sessions = max_sessions > 0 ? max_sessions : 1024;
  e->complexity = complexity;
  e->thread = std::thread(&OpusTxEngine::run, e);
  return e;
}

void opus_tx_stats(void* h, long long* out7) {
  auto* e = (OpusTxEngine*)h;
  out7[0] = e->pkts_in.load();
  out7[1] = e->pkts_out.load();
  out7[2] = e->frames_enc.load();
  out7[3] = e->n_sessions.load();
  out7[4] = e->dupes.load();
  out7[5] = e->resets.load();
  out7[6] = e->rejected.load();
}

void opus_tx_destroy(void* h) {
  auto* e = (OpusTxEngine*)h;
  e->stop.store(true);
  if (e->thread.joinable()) e->thread.join();
  for (auto& kv : e->sessions)
    if (kv.second.enc) g_opus.encoder_destroy(kv.second.enc);
  close(e->in_fd);
  close(e->out_fd);
  delete e;
}

}  // extern "C"
