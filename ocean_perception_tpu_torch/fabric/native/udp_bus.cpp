// Native UDP-multicast transport for the fabric bus.
//
// TPU-native equivalent of the reference's LCM core (lcm_util; LCM itself is
// a C library doing exactly this: UDP multicast + fragmentation). The wire
// format is BYTE-COMPATIBLE with ocean_perception_tpu.fabric.pubsub
// UdpMulticastBus so native and Python peers interoperate on one bus:
//
//   unfragmented: [u16le 0][u16le ch_len][channel][payload]
//   fragment:     [u16le 0xF4A6][u32le seq][u16le idx][u16le total][chunk]
//     where the chunks concatenate to [u16le ch_len][channel][payload]
//     and every chunk is <= 60000 bytes.
//
// API is poll-based (ctypes-friendly): the Python wrapper runs the receive
// loop thread and dispatches callbacks; reassembly happens here.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr uint16_t kFragMagic = 0xF4A6;
constexpr size_t kMaxDgram = 60000;
constexpr size_t kMaxPacket = 65535;

// Real LCM wire constants (lcm-proj UDP Multicast Protocol): short messages
// are "LC02" datagrams, fragmented ones "LC03" with offset-based reassembly.
// All header fields big-endian.
constexpr uint32_t kLcmMagicShort = 0x4C433032;  // "LC02"
constexpr uint32_t kLcmMagicFrag = 0x4C433033;   // "LC03"
constexpr size_t kLcmMaxDgram = 65499;
constexpr size_t kLcmFragChunk = 60000;

struct Fragments {
  std::vector<std::vector<uint8_t>> chunks;
  // Duplicate detection must NOT use chunks[idx].empty(): a zero-length
  // fragment is legitimate wire data, and counting its duplicates would
  // let `received` reach `total` with another chunk still missing.
  std::vector<uint8_t> seen;
  uint16_t received = 0;
  uint16_t total = 0;
  uint64_t birth = 0;  // insertion counter, for stale-partial eviction
};

// Reassembly key: (sender ip, sender port, seq). Every publisher's seq
// counter starts at 1, so seq alone collides the moment two processes send
// fragmented messages concurrently — LCM keys reassembly per sender too.
using FragKey = std::pair<uint64_t, uint32_t>;  // {ip<<16|port, seq}

// LCM LC03 partial: payload buffer filled by byte offset (fragment sizes are
// sender-chosen), channel carried by fragment 0 only.
struct LcmPartial {
  std::vector<uint8_t> buf;
  std::vector<bool> seen;
  uint16_t remaining = 0;
  std::string channel;
  bool have_channel = false;
  uint64_t birth = 0;
};

struct Bus {
  int tx = -1;
  int rx = -1;
  bool lcm = false;  // frame with the real LCM wire protocol
  sockaddr_in dest{};
  uint32_t seq = 0;
  uint64_t rx_count = 0;
  std::map<FragKey, Fragments> frags;
  std::map<FragKey, LcmPartial> lcm_frags;
  std::vector<uint8_t> pkt = std::vector<uint8_t>(kMaxPacket);
};

// Assembled [ch_len][channel][payload] -> split out channel + payload.
int64_t deliver(const uint8_t* data, size_t n, uint8_t* out, uint32_t cap,
                char* out_channel, uint32_t ch_cap) {
  if (n < 2) return -1;
  uint16_t ch_len;
  std::memcpy(&ch_len, data, 2);
  if (n < 2u + ch_len) return -1;
  if (ch_len + 1u > ch_cap) return -1;
  std::memcpy(out_channel, data + 2, ch_len);
  out_channel[ch_len] = '\0';
  size_t payload = n - 2 - ch_len;
  if (payload > cap) return -2;
  std::memcpy(out, data + 2 + ch_len, payload);
  return static_cast<int64_t>(payload);
}

// One sendto; returns true iff the full packet went out.
bool send_pkt(Bus* b, const std::vector<uint8_t>& pkt) {
  ssize_t s = ::sendto(b->tx, pkt.data(), pkt.size(), 0,
                       reinterpret_cast<sockaddr*>(&b->dest), sizeof(b->dest));
  return s == static_cast<ssize_t>(pkt.size());
}

int lcm_send(Bus* b, const char* channel, const uint8_t* payload, uint32_t n) {
  const size_t ch_len = std::strlen(channel);
  b->seq++;
  const uint32_t seq_be = htonl(b->seq);
  if (8 + ch_len + 1 + n <= kLcmMaxDgram) {
    std::vector<uint8_t> pkt(8 + ch_len + 1 + n);
    const uint32_t magic_be = htonl(kLcmMagicShort);
    std::memcpy(pkt.data(), &magic_be, 4);
    std::memcpy(pkt.data() + 4, &seq_be, 4);
    std::memcpy(pkt.data() + 8, channel, ch_len + 1);
    std::memcpy(pkt.data() + 9 + ch_len, payload, n);
    return send_pkt(b, pkt) ? 0 : -1;
  }
  const size_t first_chunk = kLcmFragChunk - ch_len - 1;
  const size_t n_frags =
      1 + (n - first_chunk + kLcmFragChunk - 1) / kLcmFragChunk;
  const uint32_t size_be = htonl(n);
  size_t off = 0;
  for (size_t i = 0; i < n_frags; ++i) {
    const size_t len = std::min(i == 0 ? first_chunk : kLcmFragChunk,
                                static_cast<size_t>(n) - off);
    std::vector<uint8_t> pkt(20 + (i == 0 ? ch_len + 1 : 0) + len);
    const uint32_t magic_be = htonl(kLcmMagicFrag);
    const uint32_t off_be = htonl(static_cast<uint32_t>(off));
    const uint16_t no_be = htons(static_cast<uint16_t>(i));
    const uint16_t total_be = htons(static_cast<uint16_t>(n_frags));
    std::memcpy(pkt.data(), &magic_be, 4);
    std::memcpy(pkt.data() + 4, &seq_be, 4);
    std::memcpy(pkt.data() + 8, &size_be, 4);
    std::memcpy(pkt.data() + 12, &off_be, 4);
    std::memcpy(pkt.data() + 16, &no_be, 2);
    std::memcpy(pkt.data() + 18, &total_be, 2);
    uint8_t* body = pkt.data() + 20;
    if (i == 0) {
      std::memcpy(body, channel, ch_len + 1);
      body += ch_len + 1;
    }
    std::memcpy(body, payload + off, len);
    if (!send_pkt(b, pkt)) return -1;
    off += len;
  }
  return 0;
}

// Returns payload bytes on a completed message, -3 to keep polling.
int64_t lcm_handle_pkt(Bus* b, const sockaddr_in& from, ssize_t n,
                       uint8_t* out, uint32_t cap, char* out_channel,
                       uint32_t ch_cap) {
  if (n < 8) return -3;
  uint32_t magic;
  std::memcpy(&magic, b->pkt.data(), 4);
  magic = ntohl(magic);
  if (magic == kLcmMagicShort) {
    const uint8_t* body = b->pkt.data() + 8;
    const size_t body_n = static_cast<size_t>(n) - 8;
    const void* nul = std::memchr(body, 0, body_n);
    if (!nul) return -3;
    const size_t ch_len = static_cast<const uint8_t*>(nul) - body;
    if (ch_len + 1 > ch_cap) return -3;
    std::memcpy(out_channel, body, ch_len + 1);
    const size_t payload = body_n - ch_len - 1;
    if (payload > cap) return -2;
    std::memcpy(out, body + ch_len + 1, payload);
    return static_cast<int64_t>(payload);
  }
  if (magic != kLcmMagicFrag || n < 20) return -3;
  uint32_t seq, msg_size, frag_off;
  uint16_t frag_no, n_frags;
  std::memcpy(&seq, b->pkt.data() + 4, 4);
  std::memcpy(&msg_size, b->pkt.data() + 8, 4);
  std::memcpy(&frag_off, b->pkt.data() + 12, 4);
  std::memcpy(&frag_no, b->pkt.data() + 16, 2);
  std::memcpy(&n_frags, b->pkt.data() + 18, 2);
  seq = ntohl(seq);
  msg_size = ntohl(msg_size);
  frag_off = ntohl(frag_off);
  frag_no = ntohs(frag_no);
  n_frags = ntohs(n_frags);
  if (n_frags == 0 || msg_size > (64u << 20)) return -3;

  const uint64_t sender =
      (static_cast<uint64_t>(from.sin_addr.s_addr) << 16) | from.sin_port;
  const FragKey key{sender, seq};
  if (b->lcm_frags.find(key) == b->lcm_frags.end() &&
      b->lcm_frags.size() >= 64) {
    auto oldest = b->lcm_frags.begin();
    for (auto it = b->lcm_frags.begin(); it != b->lcm_frags.end(); ++it)
      if (it->second.birth < oldest->second.birth) oldest = it;
    b->lcm_frags.erase(oldest);
  }
  LcmPartial& f = b->lcm_frags[key];
  if (f.seen.empty()) {
    f.buf.resize(msg_size);
    f.seen.assign(n_frags, false);
    f.remaining = n_frags;
    f.birth = ++b->rx_count;
  }
  if (frag_no >= f.seen.size() || f.seen[frag_no]) return -3;
  const uint8_t* data = b->pkt.data() + 20;
  size_t len = static_cast<size_t>(n) - 20;
  if (frag_no == 0) {
    const void* nul = std::memchr(data, 0, len);
    if (!nul) return -3;
    const size_t ch_len = static_cast<const uint8_t*>(nul) - data;
    f.channel.assign(reinterpret_cast<const char*>(data), ch_len);
    f.have_channel = true;
    data += ch_len + 1;
    len -= ch_len + 1;
  }
  if (static_cast<size_t>(frag_off) + len > f.buf.size()) return -3;
  std::memcpy(f.buf.data() + frag_off, data, len);
  f.seen[frag_no] = true;
  if (--f.remaining == 0 && f.have_channel) {
    if (f.channel.size() + 1 > ch_cap) { b->lcm_frags.erase(key); return -3; }
    std::memcpy(out_channel, f.channel.c_str(), f.channel.size() + 1);
    if (f.buf.size() > cap) { b->lcm_frags.erase(key); return -2; }
    std::memcpy(out, f.buf.data(), f.buf.size());
    const int64_t total = static_cast<int64_t>(f.buf.size());
    b->lcm_frags.erase(key);
    return total;
  }
  return -3;
}

}  // namespace

extern "C" {

void* udp_bus_create(const char* group, uint16_t port, int ttl) {
  Bus* b = new Bus();
  b->tx = ::socket(AF_INET, SOCK_DGRAM, 0);
  b->rx = ::socket(AF_INET, SOCK_DGRAM, 0);
  if (b->tx < 0 || b->rx < 0) {
    if (b->tx >= 0) ::close(b->tx);
    if (b->rx >= 0) ::close(b->rx);
    delete b;
    return nullptr;
  }
  ::setsockopt(b->tx, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));
  int loop = 1;
  ::setsockopt(b->tx, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));

  int reuse = 1;
  ::setsockopt(b->rx, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  // Fragment bursts (images) overflow the default buffer, and plain
  // SO_RCVBUF is silently capped at net.core.rmem_max (4 MB here — below
  // one raw 720p stereo message). SO_RCVBUFFORCE lifts the cap when the
  // process has CAP_NET_ADMIN; fall back to the capped request otherwise.
  int rcvbuf = 32 << 20;
  if (::setsockopt(b->rx, SOL_SOCKET, SO_RCVBUFFORCE, &rcvbuf, sizeof(rcvbuf)) != 0) {
    rcvbuf = 8 << 20;
    ::setsockopt(b->rx, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  }

  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (::bind(b->rx, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(b->tx);
    ::close(b->rx);
    delete b;
    return nullptr;
  }
  ip_mreq mreq{};
  mreq.imr_multiaddr.s_addr = ::inet_addr(group);
  mreq.imr_interface.s_addr = htonl(INADDR_ANY);
  ::setsockopt(b->rx, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));

  b->dest.sin_family = AF_INET;
  b->dest.sin_addr.s_addr = ::inet_addr(group);
  b->dest.sin_port = htons(port);
  return b;
}

// Same transport, REAL LCM wire framing (LC02/LC03): interoperates with
// liblcm peers when the payloads are LCM-encoded (fabric/lcm_types.py).
void* udp_bus_create_lcm(const char* group, uint16_t port, int ttl) {
  Bus* b = static_cast<Bus*>(udp_bus_create(group, port, ttl));
  if (b) b->lcm = true;
  return b;
}

void udp_bus_close(void* handle) {
  Bus* b = static_cast<Bus*>(handle);
  if (!b) return;
  ::close(b->tx);
  ::close(b->rx);
  delete b;
}

// Publish one message; fragments transparently. Returns 0 ok, -1 error.
int udp_bus_send(void* handle, const char* channel, const uint8_t* payload,
                 uint32_t n) {
  Bus* b = static_cast<Bus*>(handle);
  if (!b) return -1;
  if (b->lcm) return lcm_send(b, channel, payload, n);
  const uint16_t ch_len = static_cast<uint16_t>(std::strlen(channel));
  std::vector<uint8_t> data(2 + ch_len + n);
  std::memcpy(data.data(), &ch_len, 2);
  std::memcpy(data.data() + 2, channel, ch_len);
  std::memcpy(data.data() + 2 + ch_len, payload, n);

  if (data.size() <= kMaxDgram) {
    std::vector<uint8_t> pkt(2 + data.size());
    pkt[0] = pkt[1] = 0;
    std::memcpy(pkt.data() + 2, data.data(), data.size());
    ssize_t s = ::sendto(b->tx, pkt.data(), pkt.size(), 0,
                         reinterpret_cast<sockaddr*>(&b->dest), sizeof(b->dest));
    return s == static_cast<ssize_t>(pkt.size()) ? 0 : -1;
  }
  b->seq++;
  const size_t n_frags = (data.size() + kMaxDgram - 1) / kMaxDgram;
  for (size_t i = 0; i < n_frags; ++i) {
    const size_t off = i * kMaxDgram;
    const size_t len = std::min(kMaxDgram, data.size() - off);
    std::vector<uint8_t> pkt(10 + len);
    std::memcpy(pkt.data(), &kFragMagic, 2);
    std::memcpy(pkt.data() + 2, &b->seq, 4);
    const uint16_t idx = static_cast<uint16_t>(i);
    const uint16_t total = static_cast<uint16_t>(n_frags);
    std::memcpy(pkt.data() + 6, &idx, 2);
    std::memcpy(pkt.data() + 8, &total, 2);
    std::memcpy(pkt.data() + 10, data.data() + off, len);
    ssize_t s = ::sendto(b->tx, pkt.data(), pkt.size(), 0,
                         reinterpret_cast<sockaddr*>(&b->dest), sizeof(b->dest));
    if (s != static_cast<ssize_t>(pkt.size())) return -1;
  }
  return 0;
}

// Receive the next fully-assembled message (handles reassembly internally).
// Returns payload bytes (>= 0), 0-with-empty-channel on timeout, -1 on
// error, -2 if `out` is too small.
int64_t udp_bus_poll(void* handle, uint8_t* out, uint32_t cap,
                     char* out_channel, uint32_t ch_cap, int timeout_ms) {
  Bus* b = static_cast<Bus*>(handle);
  if (!b) return -1;
  out_channel[0] = '\0';

  for (;;) {
    pollfd pfd{b->rx, POLLIN, 0};
    int pr = ::poll(&pfd, 1, timeout_ms);
    if (pr == 0) return 0;    // timeout
    if (pr < 0) return -1;
    sockaddr_in from{};
    socklen_t from_len = sizeof(from);
    ssize_t n = ::recvfrom(b->rx, b->pkt.data(), b->pkt.size(), 0,
                           reinterpret_cast<sockaddr*>(&from), &from_len);
    if (n < 0) return -1;  // closed/failed socket: never spin on POLLNVAL
    if (b->lcm) {
      int64_t r = lcm_handle_pkt(b, from, n, out, cap, out_channel, ch_cap);
      if (r != -3) return r;
      continue;
    }
    if (n < 2) continue;
    uint16_t tag;
    std::memcpy(&tag, b->pkt.data(), 2);
    if (tag == 0) {
      return deliver(b->pkt.data() + 2, static_cast<size_t>(n) - 2, out, cap,
                     out_channel, ch_cap);
    }
    if (tag != kFragMagic || n < 10) continue;
    uint32_t seq;
    uint16_t idx, total;
    std::memcpy(&seq, b->pkt.data() + 2, 4);
    std::memcpy(&idx, b->pkt.data() + 6, 2);
    std::memcpy(&total, b->pkt.data() + 8, 2);
    const uint64_t sender =
        (static_cast<uint64_t>(from.sin_addr.s_addr) << 16) | from.sin_port;
    const FragKey key{sender, seq};
    // Evict the OLDEST partial when the map is full — checked on insertion
    // (sustained fragment loss with no completions must not grow unbounded,
    // and live reassemblies from other senders must survive).
    if (b->frags.find(key) == b->frags.end() && b->frags.size() >= 64) {
      auto oldest = b->frags.begin();
      for (auto it = b->frags.begin(); it != b->frags.end(); ++it)
        if (it->second.birth < oldest->second.birth) oldest = it;
      b->frags.erase(oldest);
    }
    Fragments& f = b->frags[key];
    if (f.total == 0) {
      f.total = total;
      f.chunks.resize(total);
      f.seen.assign(total, 0);
      f.birth = ++b->rx_count;
    }
    if (idx >= f.total || f.seen[idx]) continue;
    f.seen[idx] = 1;
    f.chunks[idx].assign(b->pkt.data() + 10, b->pkt.data() + n);
    if (++f.received == f.total) {
      std::vector<uint8_t> data;
      for (auto& c : f.chunks) data.insert(data.end(), c.begin(), c.end());
      b->frags.erase(key);
      return deliver(data.data(), data.size(), out, cap, out_channel, ch_cap);
    }
  }
}

}  // extern "C"
