// turbo.cpp — native HTTP data plane ("turbo engine") for the volume server.
//
// The PyTorch port's own copy of the JAX package's engine
// (seaweedfs_tpu/native/turbo.cpp); the on-disk formats and the wire
// answers are the same byte for byte.  Build (storage/turbo.py does this at
// first use, into csrc/build/ under a name hashed from source and flags):
//   g++ -O3 -march=native -std=c++17 -fPIC -shared -fvisibility=hidden \
//       -o libturbo-<hash>.so turbo.cpp -lpthread -lz
// Only the C API below is exported, so the JAX package's engine can be
// loaded into the same process without any symbol of one binding to the
// other.
//
// The reference serves its small-file data plane from compiled Go
// (weed/server/volume_server_handlers_read.go:28,
//  weed/server/volume_server_handlers_write.go:19) and published
// 15k writes/s / 47k reads/s on one laptop core (README.md:504-538).  A
// Python ThreadingHTTPServer tops out ~50x lower, so this engine owns the
// volume server's public port with an epoll event loop and serves the hot
// needle ops (GET/HEAD/POST/PUT/DELETE on /<vid>,<fid>) directly against
// the .dat/.idx files; every other route (admin, status, metrics) is
// proxied verbatim to the Python daemon listening on an internal port.
//
// Ownership protocol: while a volume is "registered" here, THIS engine is
// the only writer of its .dat/.idx and the only authority on its needle
// map (the Python Volume delegates lookups/appends through the C API —
// see storage/turbo.py TurboNeedleMap).  Python detaches (unregister) before
// any operation that rewrites files (vacuum, tier move, destroy) and
// re-attaches after.  On-disk formats are bit-compatible with the Python
// writer (storage/needle.py, storage/idx.py), which is itself
// bit-compatible with the Go reference (weed/storage/needle/needle_read_write.go).
//
// Concurrency: one epoll worker per thread, each with its own SO_REUSEPORT
// listener.  Volume state is shared: per-volume mutex for map/append;
// reads drop the mutex before pread (the .dat prefix is immutable).
// Unregister marks the volume dead under its mutex; in-flight ops holding
// the shared_ptr observe `dead` and fall back to proxying.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>
#include <zlib.h>

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli), matching storage/crc.py / weed/storage/needle/crc.go.
// Hardware SSE4.2 path when available, slicing-by-8 fallback.

static uint32_t crc_tab[8][256];

static void crc_init_tables() {
  for (int i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    crc_tab[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (int i = 0; i < 256; i++)
      crc_tab[t][i] = (crc_tab[t - 1][i] >> 8) ^ crc_tab[0][crc_tab[t - 1][i] & 0xFF];
}

static uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t n) {
  crc ^= 0xFFFFFFFFu;
  while (n >= 8) {
    crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
    crc = crc_tab[7][crc & 0xFF] ^ crc_tab[6][(crc >> 8) & 0xFF] ^
          crc_tab[5][(crc >> 16) & 0xFF] ^ crc_tab[4][(crc >> 24) & 0xFF] ^
          crc_tab[3][p[4]] ^ crc_tab[2][p[5]] ^ crc_tab[1][p[6]] ^
          crc_tab[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc_tab[0][(crc ^ *p++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) static uint32_t crc32c_hw(uint32_t crc,
                                                            const uint8_t* p,
                                                            size_t n) {
  crc ^= 0xFFFFFFFFu;
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    c = __builtin_ia32_crc32di(c, v);
    p += 8;
    n -= 8;
  }
  crc = (uint32_t)c;
  while (n--) crc = __builtin_ia32_crc32qi(crc, *p++);
  return crc ^ 0xFFFFFFFFu;
}
static bool g_has_sse42 = false;
#endif

static uint32_t crc32c(const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  if (g_has_sse42) return crc32c_hw(0, p, n);
#endif
  return crc32c_sw(0, p, n);
}

// masked on-disk value (crc.go:24-26): rotr32(crc,15) + 0xa282ead8
static uint32_t crc_masked(uint32_t crc) {
  uint32_t rot = (crc >> 15) | (crc << 17);
  return rot + 0xA282EAD8u;
}

static inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}
static inline uint64_t be64(const uint8_t* p) {
  return ((uint64_t)be32(p) << 32) | be32(p + 4);
}
static inline void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
static inline void put_be64(uint8_t* p, uint64_t v) {
  put_be32(p, v >> 32);
  put_be32(p + 4, (uint32_t)v);
}

// ---------------------------------------------------------------------------
// SHA-256 + HMAC + base64url: enough crypto to verify the fid-scoped HS256
// JWTs (security/jwt.py gen_jwt / weed/security/jwt.go GenJwt) natively, so
// auth-enabled deployments keep the fast path instead of proxying.

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_len = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = ((uint32_t)p[i * 4] << 24) | ((uint32_t)p[i * 4 + 1] << 16) |
             ((uint32_t)p[i * 4 + 2] << 8) | p[i * 4 + 3];
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    len += n;
    while (n > 0) {
      size_t take = std::min(n, (size_t)64 - buf_len);
      memcpy(buf + buf_len, p, take);
      buf_len += take;
      p += take;
      n -= take;
      if (buf_len == 64) {
        block(buf);
        buf_len = 0;
      }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buf_len != 56) update(&zero, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = (bits >> (56 - 8 * i)) & 0xFF;
    update(lb, 8);
    for (int i = 0; i < 8; i++) put_be32(out + 4 * i, h[i]);
  }
};

static void hmac_sha256(const std::string& key, const std::string& msg,
                        uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (key.size() > 64) {
    Sha256 s;
    s.update((const uint8_t*)key.data(), key.size());
    s.final(k);
  } else {
    memcpy(k, key.data(), key.size());
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 si;
  si.update(ipad, 64);
  si.update((const uint8_t*)msg.data(), msg.size());
  si.final(inner);
  Sha256 so;
  so.update(opad, 64);
  so.update(inner, 32);
  so.final(out);
}

static bool b64url_decode(const std::string& in, std::string* out) {
  auto val = [](char c) -> int {
    if (c >= 'A' && c <= 'Z') return c - 'A';
    if (c >= 'a' && c <= 'z') return c - 'a' + 26;
    if (c >= '0' && c <= '9') return c - '0' + 52;
    if (c == '-') return 62;
    if (c == '_') return 63;
    return -1;
  };
  out->clear();
  int acc = 0, nbits = 0;
  for (char c : in) {
    if (c == '=') break;
    int v = val(c);
    if (v < 0) return false;
    acc = (acc << 6) | v;
    nbits += 6;
    if (nbits >= 8) {
      nbits -= 8;
      out->push_back((char)((acc >> nbits) & 0xFF));
    }
  }
  return true;
}

// Verify a compact HS256 JWT scoped to `fid` (security/jwt.py
// verify_fid_jwt): signature, expiry, and exact fid claim.
static bool verify_fid_jwt(const std::string& key, const std::string& token,
                           const std::string& fid) {
  size_t d1 = token.find('.');
  if (d1 == std::string::npos) return false;
  size_t d2 = token.find('.', d1 + 1);
  if (d2 == std::string::npos) return false;
  std::string msg = token.substr(0, d2);
  std::string sig;
  if (!b64url_decode(token.substr(d2 + 1), &sig) || sig.size() != 32)
    return false;
  uint8_t want[32];
  hmac_sha256(key, msg, want);
  uint8_t diff = 0;
  for (int i = 0; i < 32; i++) diff |= want[i] ^ (uint8_t)sig[i];
  if (diff) return false;
  std::string payload;
  if (!b64url_decode(token.substr(d1 + 1, d2 - d1 - 1), &payload))
    return false;
  // claims are our own compact json: {"exp":N,"fid":"..."}
  size_t ep = payload.find("\"exp\":");
  if (ep == std::string::npos) return false;
  long long exp = strtoll(payload.c_str() + ep + 6, nullptr, 10);
  if (exp < (long long)time(nullptr)) return false;
  size_t fp = payload.find("\"fid\":\"");
  if (fp == std::string::npos) return false;
  size_t fs = fp + 7;
  size_t fe = payload.find('"', fs);
  if (fe == std::string::npos) return false;
  std::string claim = payload.substr(fs, fe - fs);
  for (auto& ch : claim)
    if (ch == '/') ch = ',';  // normalize vid/key vs vid,key
  return claim == fid;
}

// ---------------------------------------------------------------------------
// Needle/idx format constants (storage/types.py, storage/needle.py).

static const int NEEDLE_HEADER = 16;   // cookie u32BE | id u64BE | size u32BE
static const int CHECKSUM_SIZE = 4;
static const int TS_SIZE = 8;          // v3 append_at_ns
static const int PAD = 8;
static const int32_t TOMBSTONE = -1;

static const uint8_t FLAG_IS_COMPRESSED = 0x01;
static const uint8_t FLAG_HAS_NAME = 0x02;
static const uint8_t FLAG_HAS_MIME = 0x04;
static const uint8_t FLAG_HAS_LAST_MODIFIED = 0x08;
static const uint8_t FLAG_HAS_TTL = 0x10;
static const uint8_t FLAG_HAS_PAIRS = 0x20;
static const uint8_t FLAG_IS_CHUNK_MANIFEST = 0x80;

// padding after the record — always 1..8 (needle_read_write.go:298-304)
static int padding_len(int64_t needle_size, int version) {
  int64_t used = NEEDLE_HEADER + needle_size + CHECKSUM_SIZE +
                 (version == 3 ? TS_SIZE : 0);
  return PAD - (used % PAD);
}
static int64_t body_len(int64_t needle_size, int version) {
  return needle_size + CHECKSUM_SIZE + (version == 3 ? TS_SIZE : 0) +
         padding_len(needle_size, version);
}
static int64_t actual_size(int64_t needle_size, int version) {
  return NEEDLE_HEADER + body_len(needle_size, version);
}

// TTL minutes (storage/ttl.py): units minute..year stored 1..6
static int64_t ttl_minutes(uint8_t count, uint8_t unit) {
  static const int64_t mult[] = {0, 1, 60, 60 * 24, 60 * 24 * 7, 60 * 24 * 31,
                                 60 * 24 * 365};
  if (unit > 6) return 0;
  return (int64_t)count * mult[unit];
}

// ---------------------------------------------------------------------------
// Per-volume needle map: open-addressing, linear probing, power-of-2 table.
// 24B/slot; EMPTY key sentinel 0xFFFF..FF (never issued by the sequencer).

struct Slot {
  uint64_t key;
  uint64_t off;    // actual byte offset
  int32_t size;    // negative = deleted (original size negated), -1 tombstone
};
static const uint64_t EMPTY_KEY = ~0ULL;

struct NeedleMap {
  std::vector<Slot> slots;
  size_t used = 0;

  NeedleMap() { slots.assign(1024, Slot{EMPTY_KEY, 0, 0}); }

  Slot* find(uint64_t key) {
    size_t mask = slots.size() - 1;
    size_t i = (key * 0x9E3779B97F4A7C15ULL) & mask;
    while (true) {
      Slot& s = slots[i];
      if (s.key == key) return &s;
      if (s.key == EMPTY_KEY) return nullptr;
      i = (i + 1) & mask;
    }
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{EMPTY_KEY, 0, 0});
    size_t mask = slots.size() - 1;
    for (const Slot& s : old) {
      if (s.key == EMPTY_KEY) continue;
      size_t i = (s.key * 0x9E3779B97F4A7C15ULL) & mask;
      while (slots[i].key != EMPTY_KEY) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  // returns pointer to the (possibly pre-existing) slot
  Slot* upsert(uint64_t key, uint64_t off, int32_t size, bool* existed) {
    if (used * 10 >= slots.size() * 7) grow();
    size_t mask = slots.size() - 1;
    size_t i = (key * 0x9E3779B97F4A7C15ULL) & mask;
    while (true) {
      Slot& s = slots[i];
      if (s.key == key) {
        *existed = true;
        s.off = off;
        s.size = size;
        return &s;
      }
      if (s.key == EMPTY_KEY) {
        *existed = false;
        s = Slot{key, off, size};
        used++;
        return &s;
      }
      i = (i + 1) & mask;
    }
  }
};

struct Vol {
  uint32_t vid;
  int dat_fd = -1;
  int idx_fd = -1;
  int version = 3;
  int offset_size = 4;  // 4 or 5 byte idx offsets
  bool writable_http = true;
  std::atomic<bool> read_only{false};
  std::atomic<bool> dead{false};

  std::mutex mu;
  NeedleMap map;
  uint64_t append_off = 0;
  uint64_t idx_size = 0;
  // mapMetric counters (storage/needle_map.py IdxLogMixin semantics)
  uint64_t file_count = 0, file_bytes = 0, del_count = 0, del_bytes = 0;
  uint64_t max_key = 0;
  uint64_t last_modified_s = 0;
  uint64_t last_append_ns = 0;

  ~Vol() {
    if (dat_fd >= 0) close(dat_fd);
    if (idx_fd >= 0) close(idx_fd);
  }

  int entry_size() const { return 8 + offset_size + 4; }

  // CompactNeedleMap.put counter semantics (needle_map.py:153-163)
  void apply_put(uint64_t key, uint64_t off, int32_t size) {
    bool existed;
    Slot* s = map.find(key);
    int32_t old_size = s ? s->size : 0;
    uint64_t old_off = s ? s->off : 0;
    map.upsert(key, off, size, &existed);
    if (key > max_key && key != EMPTY_KEY) max_key = key;
    file_count++;
    file_bytes += (uint32_t)size;
    if (existed && old_off != 0 && old_size > 0 && old_size != TOMBSTONE) {
      del_count++;
      del_bytes += (uint32_t)old_size;
    }
  }

  // CompactNeedleMap.delete semantics: keep original offset, negate size
  void apply_delete(uint64_t key) {
    Slot* s = map.find(key);
    del_count++;
    if (s && s->size > 0 && s->size != TOMBSTONE) {
      del_bytes += (uint32_t)s->size;
      s->size = -s->size;
    }
  }

  // max representable byte offset for this volume's idx flavor
  uint64_t max_offset() const {
    return (offset_size == 4 ? 0xFFFFFFFFull : 0xFFFFFFFFFFull) * PAD;
  }

  int write_idx_entry(uint64_t key, uint64_t off, int32_t size) {
    uint8_t e[17];
    put_be64(e, key);
    uint64_t scaled = off / PAD;
    if (scaled > (offset_size == 4 ? 0xFFFFFFFFull : 0xFFFFFFFFFFull))
      return -1;  // never persist a truncated offset (types.py raises here)
    if (offset_size == 4) {
      put_be32(e + 8, (uint32_t)scaled);
      put_be32(e + 12, (uint32_t)size);
    } else {
      put_be32(e + 8, (uint32_t)(scaled & 0xFFFFFFFFu));
      e[12] = (uint8_t)(scaled >> 32);
      put_be32(e + 13, (uint32_t)size);
    }
    int n = entry_size();
    if (pwrite(idx_fd, e, n, idx_size) != n) return -1;
    idx_size += n;
    return 0;
  }
};

// ---------------------------------------------------------------------------
// Engine: registry + HTTP workers.

struct Engine {
  std::shared_mutex reg_mu;
  std::unordered_map<uint32_t, std::shared_ptr<Vol>> vols;

  std::string backend_ip;
  int backend_port = 0;
  std::string bind_ip;
  int port = 0;
  // fid-scoped JWT keys (set before workers serve traffic; empty = open)
  std::string jwt_write_key, jwt_read_key;

  std::vector<std::thread> workers;
  std::vector<int> stop_fds;  // eventfd per worker
  std::atomic<bool> stopping{false};

  // counters for /metrics merge
  std::atomic<uint64_t> n_get{0}, n_post{0}, n_delete{0}, n_proxy{0};

  std::shared_ptr<Vol> get_vol(uint32_t vid) {
    std::shared_lock<std::shared_mutex> lk(reg_mu);
    auto it = vols.find(vid);
    return it == vols.end() ? nullptr : it->second;
  }
};

// ---------------------------------------------------------------------------
// HTTP plumbing.

struct Conn {
  int fd;
  std::string in;     // unparsed request bytes
  std::string out;    // pending response bytes (EAGAIN backlog)
  bool close_after = false;
};

struct Worker {
  Engine* eng;
  int epfd = -1;
  int listen_fd = -1;
  int stop_fd = -1;
  // Proxied requests run in detached threads (a blocking proxy inside the
  // event loop would deadlock when the Python handler calls back into the
  // public port — e.g. manifest delete cascading to chunk deletes).  The
  // thread reports completion here; notify_fd wakes the loop to finalize.
  int notify_fd = -1;
  std::mutex done_mu;
  std::vector<std::pair<Conn*, bool>> done;
  std::atomic<int> inflight{0};
  // set when teardown abandons a wedged proxy thread: the Worker must be
  // leaked, not freed (the thread will still touch done_mu/notify_fd)
  std::atomic<bool> leak{false};
  std::unordered_map<int, Conn*> conns;
};

static int set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  return fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

static int make_listener(const char* ip, int port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(port);
  if (strcmp(ip, "") == 0 || strcmp(ip, "0.0.0.0") == 0)
    a.sin_addr.s_addr = INADDR_ANY;
  else if (inet_pton(AF_INET, ip, &a.sin_addr) != 1) {
    // hostname like "localhost": fall back to loopback
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  }
  if (bind(fd, (sockaddr*)&a, sizeof(a)) < 0 || listen(fd, 1024) < 0) {
    close(fd);
    return -1;
  }
  set_nonblock(fd);
  return fd;
}

// best-effort immediate send; remainder buffered in conn->out
static bool conn_send(Worker* w, Conn* c, const char* data, size_t len) {
  if (c->out.empty()) {
    while (len > 0) {
      ssize_t n = send(c->fd, data, len, MSG_NOSIGNAL);
      if (n > 0) {
        data += n;
        len -= n;
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      return false;  // peer gone
    }
  }
  if (len > 0) {
    c->out.append(data, len);
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.fd = c->fd;
    epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
  return true;
}

// blocking send used inside proxy streaming (worker is committed anyway)
static bool send_all_blocking(int fd, const char* data, size_t len) {
  while (len > 0) {
    ssize_t n = send(fd, data, len, MSG_NOSIGNAL);
    if (n > 0) {
      data += n;
      len -= n;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      pollfd p{fd, POLLOUT, 0};
      poll(&p, 1, 10000);
      continue;
    }
    return false;
  }
  return true;
}

static const char* status_text(int code) {
  switch (code) {
    case 200: return "OK";
    case 201: return "Created";
    case 202: return "Accepted";
    case 204: return "No Content";
    case 206: return "Partial Content";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 411: return "Length Required";
    case 413: return "Payload Too Large";
    case 416: return "Range Not Satisfiable";
    case 500: return "Internal Server Error";
    case 502: return "Bad Gateway";
    case 503: return "Service Unavailable";
    default: return "OK";
  }
}

// header + body in ONE sendmsg (MSG_NOSIGNAL: no SIGPIPE on dead peers):
// two send()s per GET meant two packets on loopback and often two client
// select()+recv() rounds per request — measurable at small-file rps scale.
static bool conn_send2(Worker* w, Conn* c, const char* hdr, size_t hlen,
                       const char* body, size_t blen) {
  if (!c->out.empty()) {  // EPOLLOUT already armed; just queue
    c->out.append(hdr, hlen);
    c->out.append(body, blen);
    return true;
  }
  iovec iov[2] = {{(void*)hdr, hlen}, {(void*)body, blen}};
  int idx = 0;  // a zero-length body iov is harmless; skipping hdr is not
  while (idx < 2) {
    msghdr msg{};
    msg.msg_iov = iov + idx;
    msg.msg_iovlen = 2 - idx;
    ssize_t n = sendmsg(c->fd, &msg, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      return false;  // peer gone
    }
    size_t left = n;
    while (idx < 2 && left >= iov[idx].iov_len) {
      left -= iov[idx].iov_len;
      idx++;
    }
    if (idx < 2) {
      iov[idx].iov_base = (char*)iov[idx].iov_base + left;
      iov[idx].iov_len -= left;
    }
  }
  if (idx < 2) {
    for (int j = idx; j < 2; j++)
      c->out.append((const char*)iov[j].iov_base, iov[j].iov_len);
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.fd = c->fd;
    epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
  return true;
}

static bool reply(Worker* w, Conn* c, int code, const char* ctype,
                  const char* extra_headers, const char* body, size_t body_len,
                  bool head_only) {
  char hdr[512];
  int hn = snprintf(hdr, sizeof(hdr),
                    "HTTP/1.1 %d %s\r\nContent-Type: %s\r\nContent-Length: %zu\r\n%s%s\r\n",
                    code, status_text(code), ctype, body_len,
                    extra_headers ? extra_headers : "",
                    c->close_after ? "Connection: close\r\n" : "");
  if (head_only || body_len == 0) return conn_send(w, c, hdr, hn);
  return conn_send2(w, c, hdr, hn, body, body_len);
}

static bool reply_json(Worker* w, Conn* c, int code, const std::string& js,
                       bool head_only = false) {
  return reply(w, c, code, "application/json", nullptr, js.data(), js.size(),
               head_only);
}

// ---------------------------------------------------------------------------
// Request model.

struct Req {
  const char* method;   // points into buffer
  size_t method_len;
  std::string path;     // path without query
  std::string query;    // raw query string
  size_t header_end;    // offset just past \r\n\r\n
  int64_t content_length = 0;
  bool conn_close = false;
  bool has_te_chunked = false;
  std::string range, name, mime, content_encoding, bearer;
  bool accepts_gzip = false;
  bool chunk_manifest = false;
  size_t total_len;     // header + body length in the buffer
  const uint8_t* body;
};

static bool ieq(const char* a, size_t alen, const char* b) {
  size_t blen = strlen(b);
  if (alen != blen) return false;
  for (size_t i = 0; i < alen; i++)
    if (tolower((unsigned char)a[i]) != tolower((unsigned char)b[i])) return false;
  return true;
}

static std::string q_get(const std::string& query, const char* key) {
  size_t klen = strlen(key);
  size_t i = 0;
  while (i < query.size()) {
    size_t amp = query.find('&', i);
    if (amp == std::string::npos) amp = query.size();
    size_t eq = query.find('=', i);
    if (eq != std::string::npos && eq < amp && (eq - i) == klen &&
        memcmp(query.data() + i, key, klen) == 0)
      return query.substr(eq + 1, amp - eq - 1);
    if (eq == std::string::npos || eq >= amp) {  // bare key
      if (amp - i == klen && memcmp(query.data() + i, key, klen) == 0) return "";
    }
    i = amp + 1;
  }
  return std::string("\x01");  // sentinel: absent (distinct from empty)
}
static bool q_has(const std::string& query, const char* key) {
  std::string v = q_get(query, key);
  return !(v.size() == 1 && v[0] == '\x01');
}

// parse one request from buf; returns 0 = need more, 1 = ok, -1 = bad
static int parse_request(const std::string& buf, Req* r) {
  size_t he = buf.find("\r\n\r\n");
  if (he == std::string::npos) {
    if (buf.size() > 65536) return -1;
    return 0;
  }
  r->header_end = he + 4;
  // request line
  size_t eol = buf.find("\r\n");
  size_t sp1 = buf.find(' ');
  if (sp1 == std::string::npos || sp1 > eol) return -1;
  size_t sp2 = buf.find(' ', sp1 + 1);
  if (sp2 == std::string::npos || sp2 > eol) return -1;
  r->method = buf.data();
  r->method_len = sp1;
  std::string target = buf.substr(sp1 + 1, sp2 - sp1 - 1);
  size_t qm = target.find('?');
  if (qm == std::string::npos) {
    r->path = target;
    r->query.clear();
  } else {
    r->path = target.substr(0, qm);
    r->query = target.substr(qm + 1);
  }
  // headers
  size_t i = eol + 2;
  while (i < he) {
    size_t lend = buf.find("\r\n", i);
    if (lend == std::string::npos || lend > he) lend = he;
    size_t colon = buf.find(':', i);
    if (colon != std::string::npos && colon < lend) {
      const char* k = buf.data() + i;
      size_t klen = colon - i;
      size_t vstart = colon + 1;
      while (vstart < lend && buf[vstart] == ' ') vstart++;
      std::string v = buf.substr(vstart, lend - vstart);
      if (ieq(k, klen, "content-length"))
        r->content_length = strtoll(v.c_str(), nullptr, 10);
      else if (ieq(k, klen, "connection")) {
        for (auto& ch : v) ch = tolower((unsigned char)ch);
        if (v.find("close") != std::string::npos) r->conn_close = true;
      } else if (ieq(k, klen, "transfer-encoding")) {
        r->has_te_chunked = true;
      } else if (ieq(k, klen, "range"))
        r->range = v;
      else if (ieq(k, klen, "x-sweed-name"))
        r->name = v;
      else if (ieq(k, klen, "x-sweed-mime"))
        r->mime = v;
      else if (ieq(k, klen, "x-sweed-chunk-manifest"))
        r->chunk_manifest = (v == "true");
      else if (ieq(k, klen, "content-encoding"))
        r->content_encoding = v;
      else if (ieq(k, klen, "authorization")) {
        if (v.compare(0, 7, "Bearer ") == 0) r->bearer = v.substr(7);
      } else if (ieq(k, klen, "accept-encoding")) {
        if (v.find("gzip") != std::string::npos) r->accepts_gzip = true;
      }
    }
    i = lend + 2;
  }
  if (r->has_te_chunked) return -1;  // CL-framed only (411 upstream)
  // Reject oversize bodies at header-parse time, BEFORE the read loop
  // buffers them: needles are bounded at 1 GiB (handle_post's 413) and no
  // inbound endpoint takes more (volume copy is pull-based), so anything
  // past 1 GiB + multipart/header slack can only be a memory-bloat attack.
  static const int64_t MAX_BODY = ((int64_t)1 << 30) + (16 << 20);
  if (r->content_length < 0 || r->content_length > MAX_BODY) return -1;
  if (buf.size() < r->header_end + (size_t)r->content_length) return 0;
  r->total_len = r->header_end + (size_t)r->content_length;
  r->body = (const uint8_t*)buf.data() + r->header_end;
  return 1;
}

// ---------------------------------------------------------------------------
// fid parsing: /<vid>,<idhex><cookie8>[_delta][.ext]  (file_id.py)

struct Fid {
  uint32_t vid;
  uint64_t key;
  uint32_t cookie;
  std::string str;  // "vid,hex[_delta]" — the JWT claim form (_auth_ok)
};

static bool parse_fid_path(const std::string& path, Fid* f) {
  size_t i = 1;  // skip leading /
  if (i >= path.size() || !isdigit((unsigned char)path[i])) return false;
  uint64_t vid = 0;
  while (i < path.size() && isdigit((unsigned char)path[i])) {
    vid = vid * 10 + (path[i] - '0');
    if (vid > 0xFFFFFFFFull) return false;
    i++;
  }
  if (i >= path.size() || (path[i] != ',' && path[i] != '/')) return false;
  i++;
  std::string fid = path.substr(i);
  if (fid.find('/') != std::string::npos) return false;
  // strip extension (volume server strips from rindex('.'))
  size_t dot = fid.rfind('.');
  if (dot != std::string::npos) fid = fid.substr(0, dot);
  // JWT claim form BEFORE the delta split (volume_server._auth_ok builds
  // "vid,hex[_delta]" the same way — ext stripped, first sep → comma)
  f->str = std::to_string(vid) + "," + fid;
  // _delta suffix (chunked uploads, needle.go:120-142)
  uint64_t delta = 0;
  size_t us = fid.rfind('_');
  if (us != std::string::npos) {
    for (size_t k = us + 1; k < fid.size(); k++) {
      if (!isdigit((unsigned char)fid[k])) return false;
      delta = delta * 10 + (fid[k] - '0');
    }
    fid = fid.substr(0, us);
  }
  if (fid.size() <= 8 || fid.size() > 24) return false;
  for (char ch : fid)
    if (!isxdigit((unsigned char)ch)) return false;
  size_t split = fid.size() - 8;
  uint64_t base = strtoull(fid.substr(0, split).c_str(), nullptr, 16);
  if (delta > ~0ULL - base) return false;  // key+delta would wrap
  uint64_t key = base + delta;
  // ~0ULL is the needle map's EMPTY_KEY slot sentinel; a record stored under
  // it would vanish on the next table grow. Fall through to the Python proxy,
  // whose dict-backed map has no sentinel.
  if (key == EMPTY_KEY) return false;
  f->vid = (uint32_t)vid;
  f->key = key;
  f->cookie = (uint32_t)strtoul(fid.substr(split).c_str(), nullptr, 16);
  return true;
}

// fid-scoped auth gate (volume_server._auth_ok): query `auth` wins, then
// the Bearer header; empty key = open.
static bool auth_ok(const std::string& key, const Req& r, const Fid& f) {
  if (key.empty()) return true;
  std::string token = q_get(r.query, "auth");
  if (token.size() == 1 && token[0] == '\x01') token.clear();  // absent
  if (token.empty()) token = r.bearer;
  return verify_fid_jwt(key, token, f.str);
}

static std::string hexkey(uint64_t key) {
  char b[20];
  snprintf(b, sizeof(b), "%llx", (unsigned long long)key);
  return b;
}

// ---------------------------------------------------------------------------
// Proxy: forward the raw request to the Python backend, stream the response.

static int backend_connect(Engine* e) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(e->backend_port);
  if (inet_pton(AF_INET, e->backend_ip.c_str(), &a.sin_addr) != 1)
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (connect(fd, (sockaddr*)&a, sizeof(a)) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

static bool send_502(int cfd, const char* msg) {
  char b[256];
  int blen = snprintf(b, sizeof(b),
                      "HTTP/1.1 502 Bad Gateway\r\nContent-Type: application/json\r\n"
                      "Content-Length: %zu\r\n\r\n%s",
                      strlen(msg), msg);
  return send_all_blocking(cfd, b, blen);
}

// Blocking proxy, runs in its own detached thread with its own backend
// connection.  Returns true if the client connection is still usable.
static bool proxy_blocking(Engine* e, int cfd, const std::string& raw,
                           bool is_head) {
  e->n_proxy++;
  int bfd = backend_connect(e);
  if (bfd < 0) return send_502(cfd, "{\"error\": \"backend unreachable\"}");
  bool client_ok = true;
  bool done = false;
  // forward raw request bytes
  size_t off = 0;
  while (off < raw.size()) {
    ssize_t n = send(bfd, raw.data() + off, raw.size() - off, MSG_NOSIGNAL);
    if (n <= 0) {
      client_ok = send_502(cfd, "{\"error\": \"backend send failed\"}");
      done = true;
      break;
    }
    off += n;
  }
  std::string rh;
  char buf[65536];
  size_t he = 0;
  while (!done) {  // response headers
    he = rh.find("\r\n\r\n");
    if (he != std::string::npos) break;
    if (rh.size() > 65536) {
      client_ok = send_502(cfd, "{\"error\": \"backend header overflow\"}");
      done = true;
      break;
    }
    ssize_t n = recv(bfd, buf, sizeof(buf), 0);
    if (n <= 0) {
      client_ok = send_502(cfd, "{\"error\": \"backend closed\"}");
      done = true;
      break;
    }
    rh.append(buf, n);
  }
  if (!done) {
    he += 4;
    int64_t cl = -1;
    {
      size_t i = rh.find("\r\n") + 2;
      while (i < he - 2) {
        size_t lend = rh.find("\r\n", i);
        size_t colon = rh.find(':', i);
        if (colon != std::string::npos && colon < lend) {
          const char* k = rh.data() + i;
          size_t klen = colon - i;
          size_t vs = colon + 1;
          while (vs < lend && rh[vs] == ' ') vs++;
          if (ieq(k, klen, "content-length"))
            cl = strtoll(rh.c_str() + vs, nullptr, 10);
        }
        i = lend + 2;
      }
    }
    if (!send_all_blocking(cfd, rh.data(), rh.size())) {
      client_ok = false;
    } else {
      int64_t have = rh.size() - he;
      int64_t remaining = is_head ? 0 : (cl >= 0 ? cl - have : -1);
      while (remaining != 0) {
        ssize_t n = recv(bfd, buf,
                         remaining < 0 ? sizeof(buf)
                                       : (size_t)std::min<int64_t>(
                                             remaining, sizeof(buf)),
                         0);
        if (n <= 0) {
          // close-delimited body done, or truncated CL body (framing broken)
          client_ok = remaining < 0;
          break;
        }
        if (!send_all_blocking(cfd, buf, n)) {
          client_ok = false;
          break;
        }
        if (remaining > 0) remaining -= n;
      }
      if (cl < 0) client_ok = false;  // close-delimited: framing consumed
    }
  }
  close(bfd);
  return client_ok;
}

// ---------------------------------------------------------------------------
// Data-plane handlers.

static uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

// Parse a needle record body; returns data pointer/len + flags (v2/v3).
struct ParsedNeedle {
  const uint8_t* data;
  int64_t data_len;
  uint8_t flags;
  uint64_t last_modified = 0;
  uint8_t ttl_count = 0, ttl_unit = 0;
  bool ok;
};

static ParsedNeedle parse_needle_record(const uint8_t* rec, int64_t size,
                                        int version) {
  ParsedNeedle p{nullptr, 0, 0, 0, 0, 0, false};
  if (version == 1) {
    p.data = rec + NEEDLE_HEADER;
    p.data_len = size;
    p.flags = 0;
    p.ok = true;
    return p;
  }
  const uint8_t* b = rec + NEEDLE_HEADER;
  int64_t n = size;
  int64_t idx = 0;
  if (idx < n) {
    if (idx + 4 > n) return p;
    int64_t dlen = be32(b + idx);
    idx += 4;
    if (dlen + idx >= n) return p;  // flags byte must follow
    p.data = b + idx;
    p.data_len = dlen;
    idx += dlen;
    p.flags = b[idx];
    idx += 1;
  }
  if (idx < n && (p.flags & FLAG_HAS_NAME)) {
    int64_t l = b[idx];
    idx += 1 + l;
    if (idx > n) return p;
  }
  if (idx < n && (p.flags & FLAG_HAS_MIME)) {
    int64_t l = b[idx];
    idx += 1 + l;
    if (idx > n) return p;
  }
  if (idx < n && (p.flags & FLAG_HAS_LAST_MODIFIED)) {
    if (idx + 5 > n) return p;
    for (int k = 0; k < 5; k++) p.last_modified = (p.last_modified << 8) | b[idx + k];
    idx += 5;
  }
  if (idx < n && (p.flags & FLAG_HAS_TTL)) {
    if (idx + 2 > n) return p;
    p.ttl_count = b[idx];
    p.ttl_unit = b[idx + 1];
    idx += 2;
  }
  p.ok = true;
  return p;
}

// single-range parser matching http_util.parse_byte_range
// ret: 0 = serve full, 1 = range [start,end], 2 = unsatisfiable
static int parse_range(const std::string& spec, int64_t total, int64_t* start,
                       int64_t* end) {
  if (spec.compare(0, 6, "bytes=") != 0) return 0;
  if (spec.find(',') != std::string::npos) return 0;
  std::string s = spec.substr(6);
  size_t dash = s.find('-');
  if (dash == std::string::npos) return 0;
  std::string a = s.substr(0, dash), b = s.substr(dash + 1);
  int64_t st, en;
  auto is_num = [](const std::string& x) {
    if (x.empty()) return false;
    for (char c : x) if (!isdigit((unsigned char)c)) return false;
    return true;
  };
  if (a.empty()) {
    if (!is_num(b)) return 0;
    st = total - strtoll(b.c_str(), nullptr, 10);
    if (st < 0) st = 0;
    en = total - 1;
  } else {
    if (!is_num(a) || (!b.empty() && !is_num(b))) return 0;
    st = strtoll(a.c_str(), nullptr, 10);
    en = b.empty() ? total - 1 : strtoll(b.c_str(), nullptr, 10);
  }
  if (en > total - 1) en = total - 1;
  if (st > en || st >= total) return 2;
  *start = st;
  *end = en;
  return 1;
}

// GET/HEAD on a fid.  Returns: 0 handled, 1 proxy-me, -1 client dead.
static int handle_get(Worker* w, Conn* c, const Req& r, const Fid& f,
                      bool head_only) {
  Engine* e = w->eng;
  auto vol = e->get_vol(f.vid);
  if (!vol || vol->dead.load()) return 1;
  if (!auth_ok(e->jwt_read_key, r, f))
    return reply_json(w, c, 401, "{\"error\": \"unauthorized read\"}",
                      head_only) ? 0 : -1;
  if (q_has(r.query, "width") || q_has(r.query, "height") || q_has(r.query, "cm"))
    return 1;  // image resize / manifest-control paths stay in Python

  uint64_t off;
  int32_t size;
  {
    std::lock_guard<std::mutex> lk(vol->mu);
    if (vol->dead.load()) return 1;
    Slot* s = vol->map.find(f.key);
    if (!s || s->off == 0) {
      e->n_get++;
      return reply_json(w, c, 404,
                        "{\"error\": \"needle " + hexkey(f.key) + " not found\"}",
                        head_only) ? 0 : -1;
    }
    if (s->size < 0) {
      e->n_get++;
      return reply_json(w, c, 404,
                        "{\"error\": \"needle " + hexkey(f.key) + " deleted\"}",
                        head_only) ? 0 : -1;
    }
    off = s->off;
    size = s->size;
  }
  e->n_get++;
  if (size == 0)
    return reply(w, c, 200, "application/octet-stream",
                 "Accept-Ranges: bytes\r\n", "", 0, head_only) ? 0 : -1;

  int64_t rec_len = actual_size(size, vol->version);
  // per-worker scratch for the common small-needle case: no per-request
  // malloc + zero-fill. Big records get a one-off buffer instead so a
  // single large GET can't pin megabytes of worker RSS forever.
  static const int64_t SCRATCH_MAX = 4 << 20;
  static thread_local std::vector<uint8_t> scratch;
  std::vector<uint8_t> big;
  std::vector<uint8_t>& rec = rec_len <= SCRATCH_MAX ? scratch : big;
  if (rec.size() < (size_t)rec_len) rec.resize(rec_len);
  ssize_t got = pread(vol->dat_fd, rec.data(), rec_len, off);
  if (got != rec_len)
    return reply_json(w, c, 500, "{\"error\": \"short read from .dat\"}",
                      head_only) ? 0 : -1;
  uint32_t disk_cookie = be32(rec.data());
  if (disk_cookie != f.cookie)
    return reply_json(w, c, 404, "{\"error\": \"cookie mismatch\"}", head_only)
               ? 0 : -1;
  ParsedNeedle p = parse_needle_record(rec.data(), size, vol->version);
  if (!p.ok)
    return reply_json(w, c, 500, "{\"error\": \"corrupt needle body\"}",
                      head_only) ? 0 : -1;
  if (p.flags & FLAG_IS_CHUNK_MANIFEST)
    return 1;  // manifest resolution (cross-needle assembly) lives in Python
  // CRC (read_needle verifies on every read; covers the stored bytes)
  uint32_t stored = be32(rec.data() + NEEDLE_HEADER + size);
  if (stored != crc_masked(crc32c(p.data, p.data_len)))
    return reply_json(w, c, 500,
                      "{\"error\": \"CrcError: CRC error! data on disk corrupted\"}",
                      head_only) ? 0 : -1;
  // TTL expiry (volume.py read_needle:414-424) — checked BEFORE any
  // decompression work: an expired needle must cost nothing but a 404
  if ((p.flags & FLAG_HAS_TTL) && (p.flags & FLAG_HAS_LAST_MODIFIED)) {
    int64_t mins = ttl_minutes(p.ttl_count, p.ttl_unit);
    if (mins > 0 && (int64_t)time(nullptr) >= (int64_t)p.last_modified + mins * 60)
      return reply_json(w, c, 404,
                        "{\"error\": \"needle " + hexkey(f.key) + " expired\"}",
                        head_only) ? 0 : -1;
  }
  // gzip'd needles (volume_server.py _h_get:176-188): clients that accept
  // gzip get the stored bytes verbatim + Content-Encoding (ranges are then
  // NOT applied — they would address the plaintext); everyone else gets an
  // inflate right here instead of a proxy hop to Python
  std::string inflated;
  bool serving_gzip = false;
  if (p.flags & FLAG_IS_COMPRESSED) {
    if (r.accepts_gzip) {
      serving_gzip = true;
    } else {
      // bounded + exception-safe: a gzip bomb must 500 this request, not
      // bad_alloc-terminate the process; multi-member streams (legal per
      // RFC 1952, decoded fully by Python's gzip.decompress) reset and
      // continue until the input is consumed
      const size_t MAX_PLAIN = (size_t)1 << 30;
      z_stream zs{};
      if (inflateInit2(&zs, 15 + 32) != Z_OK)  // gzip or zlib wrapper
        return reply_json(w, c, 500, "{\"error\": \"inflate init failed\"}",
                          head_only) ? 0 : -1;
      zs.next_in = (Bytef*)p.data;
      zs.avail_in = (uInt)p.data_len;
      size_t out_len = 0;
      bool bad = false, too_big = false;
      try {
        inflated.resize(std::min<size_t>(
            MAX_PLAIN, std::max<size_t>((size_t)p.data_len * 4, 4096)));
        while (true) {
          if (out_len == inflated.size()) {
            if (inflated.size() >= MAX_PLAIN) { too_big = true; break; }
            inflated.resize(std::min(MAX_PLAIN, inflated.size() * 2));
          }
          zs.next_out = (Bytef*)inflated.data() + out_len;
          zs.avail_out = (uInt)(inflated.size() - out_len);
          int ret = inflate(&zs, Z_NO_FLUSH);
          out_len = inflated.size() - zs.avail_out;
          if (ret == Z_STREAM_END) {
            if (zs.avail_in == 0) break;       // fully consumed
            if (inflateReset2(&zs, 15 + 32) != Z_OK) { bad = true; break; }
            continue;                           // next gzip member
          }
          if (ret != Z_OK) { bad = true; break; }
        }
      } catch (const std::exception&) {
        bad = true;  // length_error / bad_alloc from resize
      }
      inflateEnd(&zs);
      if (too_big)
        return reply_json(w, c, 500,
                          "{\"error\": \"decompressed needle too large\"}",
                          head_only) ? 0 : -1;
      if (bad)
        return reply_json(w, c, 500, "{\"error\": \"corrupt gzip needle\"}",
                          head_only) ? 0 : -1;
      inflated.resize(out_len);
      p.data = (const uint8_t*)inflated.data();
      p.data_len = (int64_t)inflated.size();
    }
  }
  if (serving_gzip)
    return reply(w, c, 200, "application/octet-stream",
                 "Content-Encoding: gzip\r\nAccept-Ranges: bytes\r\n",
                 (const char*)p.data, p.data_len, head_only) ? 0 : -1;
  if (!r.range.empty()) {
    int64_t st = 0, en = 0;
    int kind = parse_range(r.range, p.data_len, &st, &en);
    if (kind == 2) {
      char xh[64];
      snprintf(xh, sizeof(xh), "Content-Range: bytes */%lld\r\n",
               (long long)p.data_len);
      return reply(w, c, 416, "application/octet-stream", xh, "", 0, head_only)
                 ? 0 : -1;
    }
    if (kind == 1) {
      char xh[128];
      snprintf(xh, sizeof(xh),
               "Content-Range: bytes %lld-%lld/%lld\r\nAccept-Ranges: bytes\r\n",
               (long long)st, (long long)en, (long long)p.data_len);
      return reply(w, c, 206, "application/octet-stream", xh,
                   (const char*)p.data + st, en - st + 1, head_only) ? 0 : -1;
    }
  }
  return reply(w, c, 200, "application/octet-stream", "Accept-Ranges: bytes\r\n",
               (const char*)p.data, p.data_len, head_only) ? 0 : -1;
}

// POST/PUT on a fid.  Returns: 0 handled, 1 proxy-me, -1 client dead.
static int handle_post(Worker* w, Conn* c, const Req& r, const Fid& f) {
  Engine* e = w->eng;
  auto vol = e->get_vol(f.vid);
  if (!vol || vol->dead.load()) return 1;
  if (!auth_ok(e->jwt_write_key, r, f))
    return reply_json(w, c, 401, "{\"error\": \"unauthorized write\"}")
               ? 0 : -1;
  if (!vol->writable_http || vol->version != 3) return 1;  // replication/old fmt
  if (q_has(r.query, "ttl")) return 1;  // needle-level TTL writes stay in Python
  if (vol->read_only.load())
    return reply_json(w, c, 500,
                      "{\"error\": \"VolumeError: volume " +
                          std::to_string(f.vid) + " is read only\"}") ? 0 : -1;

  const uint8_t* data = r.body;
  int64_t dlen = r.content_length;
  // the needle `size` field is int32; bound bodies well below it (the
  // Python path fails loudly at struct-pack time — silently casting here
  // would poison the map/idx with a negative size). Big objects go
  // through chunking (operation.submit -maxMB / the filer) anyway.
  if (dlen > ((int64_t)1 << 30))
    return reply_json(w, c, 413,
                      "{\"error\": \"body too large for a single needle\"}")
               ? 0 : -1;
  uint8_t flags = FLAG_HAS_LAST_MODIFIED;  // volume_server.py _h_post always sets
  std::string name = r.name.substr(0, 255);
  std::string mime = r.mime.substr(0, 255);
  if (!name.empty()) flags |= FLAG_HAS_NAME;
  if (!mime.empty()) flags |= FLAG_HAS_MIME;
  if (r.content_encoding == "gzip") flags |= FLAG_IS_COMPRESSED;
  if (r.chunk_manifest) flags |= FLAG_IS_CHUNK_MANIFEST;

  // needle `size` field (needle.py _computed_size)
  int64_t size = 0;
  if (dlen > 0) {
    size = 4 + dlen + 1;
    if (flags & FLAG_HAS_NAME) size += 1 + name.size();
    if (flags & FLAG_HAS_MIME) size += 1 + mime.size();
    size += 5;  // last_modified
  }
  uint32_t crc = crc32c(data, dlen);
  uint64_t lm = (uint64_t)time(nullptr);
  uint64_t ns = now_ns();
  int pad = padding_len(size, 3);
  int64_t rec_len = NEEDLE_HEADER + size + CHECKSUM_SIZE + TS_SIZE + pad;

  std::vector<uint8_t> rec(rec_len);
  uint8_t* o = rec.data();
  put_be32(o, f.cookie);
  put_be64(o + 4, f.key);
  put_be32(o + 12, (uint32_t)size);
  int64_t i = NEEDLE_HEADER;
  if (dlen > 0) {
    put_be32(o + i, (uint32_t)dlen);
    i += 4;
    memcpy(o + i, data, dlen);
    i += dlen;
    o[i++] = flags;
    if (flags & FLAG_HAS_NAME) {
      o[i++] = (uint8_t)name.size();
      memcpy(o + i, name.data(), name.size());
      i += name.size();
    }
    if (flags & FLAG_HAS_MIME) {
      o[i++] = (uint8_t)mime.size();
      memcpy(o + i, mime.data(), mime.size());
      i += mime.size();
    }
    for (int k = 4; k >= 0; k--) o[i++] = (lm >> (8 * k)) & 0xFF;
  }
  put_be32(o + i, crc_masked(crc));
  i += 4;
  put_be64(o + i, ns);
  i += 8;
  // v3 padding quirk: first pad bytes alias [size u32BE, zeros]
  uint8_t pad_src[8] = {0};
  put_be32(pad_src, (uint32_t)size);
  memcpy(o + i, pad_src, pad);

  char js[96];
  {
    std::lock_guard<std::mutex> lk(vol->mu);
    if (vol->dead.load()) return 1;
    // volume cap scaled to the idx offset flavor: 32 GB for 4-byte offsets,
    // 8 EB-class for 5-byte (volume.py write_needle:326 checks content
    // bytes; the binding native invariant is offset representability)
    uint64_t cap = vol->max_offset();
    if (vol->file_bytes + (uint64_t)actual_size(size, 3) > cap ||
        vol->append_off + (uint64_t)rec_len > cap)
      return reply_json(w, c, 500,
                        "{\"error\": \"VolumeError: volume " +
                            std::to_string(f.vid) + " size limit exceeded\"}")
                 ? 0 : -1;
    Slot* s = vol->map.find(f.key);
    if (s && s->off != 0) {
      // existing needle: cookie check + unchanged check (write_needle:333-345)
      uint8_t hdr[NEEDLE_HEADER];
      if (pread(vol->dat_fd, hdr, NEEDLE_HEADER, s->off) == NEEDLE_HEADER) {
        if (be32(hdr) != f.cookie) {
          e->n_post++;
          char cb[16];
          snprintf(cb, sizeof(cb), "%x", f.cookie);
          return reply_json(w, c, 500,
                            "{\"error\": \"VolumeError: mismatching cookie " +
                                std::string(cb) + "\"}") ? 0 : -1;
        }
        if (s->size > 0 && s->size != TOMBSTONE) {
          // same data already stored? (volume.py _is_file_unchanged)
          int64_t old_rec = actual_size(s->size, vol->version);
          std::vector<uint8_t> oldb(old_rec);
          if (pread(vol->dat_fd, oldb.data(), old_rec, s->off) == old_rec) {
            ParsedNeedle op = parse_needle_record(oldb.data(), s->size,
                                                  vol->version);
            if (op.ok && op.data_len == dlen &&
                memcmp(op.data, data, dlen) == 0) {
              e->n_post++;
              snprintf(js, sizeof(js),
                       "{\"size\": %lld, \"eTag\": \"%08x\", \"unchanged\": true}",
                       (long long)dlen, crc);
              return reply_json(w, c, 201, js) ? 0 : -1;
            }
          }
        }
      }
    }
    uint64_t off = vol->append_off;
    if (pwrite(vol->dat_fd, rec.data(), rec_len, off) != rec_len)
      return reply_json(w, c, 500, "{\"error\": \"dat append failed\"}") ? 0 : -1;
    vol->append_off += rec_len;
    if (vol->write_idx_entry(f.key, off, (int32_t)size) != 0)
      return reply_json(w, c, 500, "{\"error\": \"idx append failed\"}") ? 0 : -1;
    vol->apply_put(f.key, off, (int32_t)size);
    vol->last_append_ns = ns;
    if (lm > vol->last_modified_s) vol->last_modified_s = lm;
    std::string fs = q_get(r.query, "fsync");
    if (fs == "true") {
      fsync(vol->dat_fd);
      fsync(vol->idx_fd);
    }
  }
  e->n_post++;
  snprintf(js, sizeof(js),
           "{\"size\": %lld, \"eTag\": \"%08x\", \"unchanged\": false}",
           (long long)dlen, crc);
  return reply_json(w, c, 201, js) ? 0 : -1;
}

// DELETE on a fid.  Returns: 0 handled, 1 proxy-me, -1 client dead.
static int handle_delete(Worker* w, Conn* c, const Req& r, const Fid& f) {
  Engine* e = w->eng;
  auto vol = e->get_vol(f.vid);
  if (!vol || vol->dead.load()) return 1;
  if (!auth_ok(e->jwt_write_key, r, f))
    return reply_json(w, c, 401, "{\"error\": \"unauthorized delete\"}")
               ? 0 : -1;
  if (!vol->writable_http || vol->version != 3) return 1;
  if (vol->read_only.load())
    return reply_json(w, c, 500,
                      "{\"error\": \"VolumeError: volume " +
                          std::to_string(f.vid) + " is read only\"}") ? 0 : -1;

  // peek flags first: chunk-manifest deletes cascade in Python
  {
    uint64_t off = 0;
    int32_t size = 0;
    {
      std::lock_guard<std::mutex> lk(vol->mu);
      if (vol->dead.load()) return 1;
      Slot* s = vol->map.find(f.key);
      if (!s || s->off == 0 || s->size <= 0 || s->size == TOMBSTONE) {
        e->n_delete++;
        return reply_json(w, c, 202, "{\"size\": 0}") ? 0 : -1;
      }
      off = s->off;
      size = s->size;
    }
    int64_t rec_len = actual_size(size, vol->version);
    std::vector<uint8_t> rec(rec_len);
    if (pread(vol->dat_fd, rec.data(), rec_len, off) == rec_len) {
      ParsedNeedle p = parse_needle_record(rec.data(), size, vol->version);
      if (p.ok && (p.flags & FLAG_IS_CHUNK_MANIFEST)) return 1;
    }
  }
  // tombstone: empty v3 needle (header + checksum + ts + pad = 32B)
  uint64_t ns = now_ns();
  int pad = padding_len(0, 3);
  int64_t rec_len = NEEDLE_HEADER + CHECKSUM_SIZE + TS_SIZE + pad;
  std::vector<uint8_t> rec(rec_len, 0);
  uint8_t* o = rec.data();
  put_be32(o, f.cookie);
  put_be64(o + 4, f.key);
  put_be32(o + 12, 0);
  put_be32(o + NEEDLE_HEADER, crc_masked(crc32c(nullptr, 0)));
  put_be64(o + NEEDLE_HEADER + 4, ns);
  // v3 pad aliases size bytes (all zero here) — already zeroed

  int32_t old_size = 0;
  {
    std::lock_guard<std::mutex> lk(vol->mu);
    if (vol->dead.load()) return 1;
    Slot* s = vol->map.find(f.key);
    if (!s || s->off == 0 || s->size <= 0 || s->size == TOMBSTONE) {
      e->n_delete++;
      return reply_json(w, c, 202, "{\"size\": 0}") ? 0 : -1;
    }
    old_size = s->size;
    uint64_t off = vol->append_off;
    if (pwrite(vol->dat_fd, rec.data(), rec_len, off) != rec_len)
      return reply_json(w, c, 500, "{\"error\": \"dat append failed\"}") ? 0 : -1;
    vol->append_off += rec_len;
    if (vol->write_idx_entry(f.key, off, TOMBSTONE) != 0)
      return reply_json(w, c, 500, "{\"error\": \"idx append failed\"}") ? 0 : -1;
    vol->apply_delete(f.key);
    vol->last_append_ns = ns;
  }
  e->n_delete++;
  char js[48];
  snprintf(js, sizeof(js), "{\"size\": %d}", old_size);
  return reply_json(w, c, 202, js) ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Worker event loop.

enum HandleResult { H_OK = 0, H_DROP = 1, H_PROXY = 2 };

static HandleResult handle_one(Worker* w, Conn* c, const Req& r,
                               const std::string& raw) {
  bool is_get = ieq(r.method, r.method_len, "GET");
  bool is_head = ieq(r.method, r.method_len, "HEAD");
  bool is_post = ieq(r.method, r.method_len, "POST") ||
                 ieq(r.method, r.method_len, "PUT");
  bool is_del = ieq(r.method, r.method_len, "DELETE");

  Fid f;
  if (r.path.size() > 1 && isdigit((unsigned char)r.path[1]) &&
      parse_fid_path(r.path, &f)) {
    int rc;
    if (is_get || is_head)
      rc = handle_get(w, c, r, f, is_head);
    else if (is_post)
      rc = handle_post(w, c, r, f);
    else if (is_del)
      rc = handle_delete(w, c, r, f);
    else
      rc = 1;
    if (rc == 0) return H_OK;
    if (rc == -1) return H_DROP;
    // rc == 1: fall through to proxy
  }
  return H_PROXY;
}

static void close_conn(Worker* w, Conn* c) {
  epoll_ctl(w->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  w->conns.erase(c->fd);
  delete c;
}

// serve complete pipelined requests from c->in; true = keep connection
static bool process_requests(Worker* w, Conn* c) {
  while (c->out.empty()) {
    Req r{};
    int pr = parse_request(c->in, &r);
    if (pr == 0) return true;
    if (pr < 0) {
      reply_json(w, c, 400, "{\"error\": \"bad request\"}");
      return false;
    }
    c->close_after = r.conn_close;
    std::string raw = c->in.substr(0, r.total_len);
    Req r2{};  // re-parse against the stable copy (pointers into raw)
    if (parse_request(raw, &r2) != 1) return false;
    c->in.erase(0, r.total_len);
    HandleResult hr = handle_one(w, c, r2, raw);
    if (hr == H_DROP) return false;
    if (hr == H_PROXY) {
      // hand the connection to a proxy thread; the epoll loop forgets the
      // fd until the completion queue returns it (re-entrant backend
      // requests to this port keep being served meanwhile)
      epoll_ctl(w->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
      w->conns.erase(c->fd);
      w->inflight++;
      Engine* e = w->eng;
      bool is_head = ieq(r2.method, r2.method_len, "HEAD");
      std::thread([w, e, c, raw, is_head] {
        bool ok = proxy_blocking(e, c->fd, raw, is_head);
        {
          std::lock_guard<std::mutex> lk(w->done_mu);
          w->done.emplace_back(c, ok && !c->close_after);
        }
        uint64_t one = 1;
        (void)!write(w->notify_fd, &one, 8);
      }).detach();
      return true;  // conn ownership transferred
    }
    if (c->close_after) return c->out.empty() ? false : true;
  }
  return true;
}

static void worker_loop(Worker* w) {
  epoll_event evs[128];
  char rbuf[262144];
  while (!w->eng->stopping.load()) {
    int n = epoll_wait(w->epfd, evs, 128, 1000);
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == w->stop_fd) {
        uint64_t v;
        (void)!read(w->stop_fd, &v, 8);
        continue;
      }
      if (fd == w->notify_fd) {
        uint64_t v;
        (void)!read(w->notify_fd, &v, 8);
        std::vector<std::pair<Conn*, bool>> done;
        {
          std::lock_guard<std::mutex> lk(w->done_mu);
          done.swap(w->done);
        }
        for (auto& [c, ok] : done) {
          w->inflight--;
          if (!ok) {
            close(c->fd);
            delete c;
            continue;
          }
          w->conns[c->fd] = c;
          epoll_event ev{};
          // EPOLLOUT fires immediately on a writable socket, so leftover
          // pipelined requests in c->in get processed promptly
          ev.events = EPOLLIN | EPOLLOUT;
          ev.data.fd = c->fd;
          epoll_ctl(w->epfd, EPOLL_CTL_ADD, c->fd, &ev);
        }
        continue;
      }
      if (fd == w->listen_fd) {
        while (true) {
          int cfd = accept4(w->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* c = new Conn{cfd};
          w->conns[cfd] = c;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(w->epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      auto it = w->conns.find(fd);
      if (it == w->conns.end()) continue;
      Conn* c = it->second;
      bool drop = false;
      bool transferred = false;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(w, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) {
        while (!c->out.empty()) {
          ssize_t sn = send(c->fd, c->out.data(), c->out.size(), MSG_NOSIGNAL);
          if (sn > 0) {
            c->out.erase(0, sn);
            continue;
          }
          if (sn < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
          drop = true;
          break;
        }
        if (!drop && c->out.empty()) {
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = c->fd;
          epoll_ctl(w->epfd, EPOLL_CTL_MOD, c->fd, &ev);
          if (c->close_after) drop = true;
        }
      }
      if (!drop && (evs[i].events & EPOLLIN)) {
        size_t pass_start = c->in.size();
        while (true) {
          ssize_t rn = recv(fd, rbuf, sizeof(rbuf), 0);
          if (rn > 0) {
            c->in.append(rbuf, rn);
            // backstop matching parse_request's MAX_BODY: body cap + header
            // slack; a conn can never legitimately buffer more than this
            if (c->in.size() > ((size_t)1 << 30) + (17 << 20)) {
              drop = true;
              break;
            }
            // read at most 4 MB per pass so process_requests gets to
            // reject bogus framing (oversize Content-Length, unterminated
            // headers) early — a fast sender must not be able to keep this
            // loop spinning until the gigabyte backstop; level-triggered
            // epoll re-fires for the rest
            if (c->in.size() - pass_start > (4u << 20)) break;
            continue;
          }
          if (rn == 0) {
            drop = true;  // peer closed
            break;
          }
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          drop = true;
          break;
        }
      }
      if (!drop) {
        size_t before = w->conns.count(fd);
        bool keep = process_requests(w, c);
        transferred = before && !w->conns.count(fd);  // proxy took it
        if (!transferred && !keep) drop = true;
      }
      if (drop && !transferred) close_conn(w, c);
    }
  }
  // teardown: wait for proxy threads still holding our Conn pointers.
  // Completions queued after the loop exited must be drained HERE (the
  // notify handler no longer runs) or inflight never reaches zero and
  // turbo_stop deadlocks. Bounded: a proxy thread wedged on a dead
  // backend is abandoned (conn leaked) rather than hanging shutdown.
  for (int spins = 0; w->inflight.load() > 0 && spins < 1500; spins++) {
    std::vector<std::pair<Conn*, bool>> done;
    {
      std::lock_guard<std::mutex> lk(w->done_mu);
      done.swap(w->done);
    }
    for (auto& [c, ok] : done) {
      w->inflight--;
      close(c->fd);
      delete c;
    }
    if (w->inflight.load() > 0) usleep(10000);
  }
  if (w->inflight.load() > 0) w->leak.store(true);
  {
    std::lock_guard<std::mutex> lk(w->done_mu);
    for (auto& [c, ok] : w->done) {
      w->inflight--;
      close(c->fd);
      delete c;
    }
    w->done.clear();
  }
  for (auto& kv : w->conns) {
    close(kv.first);
    delete kv.second;
  }
  w->conns.clear();
  if (w->listen_fd >= 0) close(w->listen_fd);
  // stop_fd is NOT closed here: turbo_stop may still be fanning the wake
  // write out to other workers' stop_fds — closing ours concurrently
  // races that write (and a recycled fd number would take the 8-byte wake
  // into an unrelated file). The engine owns stop_fds and closes them
  // after joining every worker (turbo_stop).
  // a leaked worker keeps notify_fd open: the wedged proxy thread will
  // still write it, and the fd number must not be recycled under it
  if (w->notify_fd >= 0 && !w->leak.load()) close(w->notify_fd);
  if (w->epfd >= 0) close(w->epfd);
}

// ---------------------------------------------------------------------------
// C API.

extern "C" {
#pragma GCC visibility push(default)

// returns engine handle (opaque pointer) or 0 on failure
long long turbo_start(const char* bind_ip, int port, const char* backend_ip,
                      int backend_port, int threads) {
  static std::once_flag once;
  std::call_once(once, [] {
    crc_init_tables();
#if defined(__x86_64__)
    g_has_sse42 = __builtin_cpu_supports("sse4.2");
#endif
    signal(SIGPIPE, SIG_IGN);
  });
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  Engine* e = new Engine();
  e->bind_ip = bind_ip ? bind_ip : "";
  e->port = port;
  e->backend_ip = backend_ip ? backend_ip : "127.0.0.1";
  e->backend_port = backend_port;
  std::vector<Worker*> ws;
  for (int t = 0; t < threads; t++) {
    Worker* w = new Worker();
    w->eng = e;
    w->listen_fd = make_listener(e->bind_ip.c_str(), port);
    if (w->listen_fd < 0) {
      delete w;
      for (Worker* pw : ws) {
        close(pw->listen_fd);
        close(pw->stop_fd);
        close(pw->epfd);
        delete pw;
      }
      delete e;
      return 0;
    }
    w->epfd = epoll_create1(0);
    w->stop_fd = eventfd(0, EFD_NONBLOCK);
    w->notify_fd = eventfd(0, EFD_NONBLOCK);
    for (int lfd : {w->listen_fd, w->stop_fd, w->notify_fd}) {
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = lfd;
      epoll_ctl(w->epfd, EPOLL_CTL_ADD, lfd, &ev);
    }
    ws.push_back(w);
  }
  for (Worker* w : ws) {
    e->stop_fds.push_back(w->stop_fd);
    e->workers.emplace_back([w] {
      worker_loop(w);
      if (!w->leak.load()) delete w;  // leaked workers outlive wedged proxies
    });
  }
  return (long long)(intptr_t)e;
}

// Install fid-JWT keys. Call BEFORE volumes are registered (keys are read
// without locks on the hot path; the engine serves only proxied traffic
// until registration anyway).
void turbo_set_jwt(long long handle, const char* write_key,
                   const char* read_key) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return;
  e->jwt_write_key = write_key ? write_key : "";
  e->jwt_read_key = read_key ? read_key : "";
}

void turbo_stop(long long handle) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return;
  e->stopping.store(true);
  for (int fd : e->stop_fds) {
    uint64_t one = 1;
    (void)!write(fd, &one, 8);
  }
  for (auto& t : e->workers) t.join();
  for (int fd : e->stop_fds) close(fd);  // workers joined: safe to close
  {
    std::unique_lock<std::shared_mutex> lk(e->reg_mu);
    e->vols.clear();
  }
  delete e;
}

// 0 ok; -1 io error; -2 already registered; -3 bad idx
int turbo_register(long long handle, unsigned vid, const char* dat_path,
                   const char* idx_path, int version, int offset_size,
                   int writable_http, int read_only) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  {
    std::shared_lock<std::shared_mutex> lk(e->reg_mu);
    if (e->vols.count(vid)) return -2;
  }
  auto v = std::make_shared<Vol>();
  v->vid = vid;
  v->version = version;
  v->offset_size = offset_size;
  v->writable_http = writable_http != 0;
  v->read_only.store(read_only != 0);
  v->dat_fd = open(dat_path, O_RDWR);
  v->idx_fd = open(idx_path, O_RDWR);
  if (v->dat_fd < 0 || v->idx_fd < 0) return -1;
  struct stat st;
  if (fstat(v->dat_fd, &st) != 0) return -1;
  v->append_off = st.st_size;
  if (fstat(v->idx_fd, &st) != 0) return -1;
  v->idx_size = st.st_size;
  // replay the .idx with CompactNeedleMap.load semantics
  int es = v->entry_size();
  uint64_t healthy = v->idx_size - (v->idx_size % es);
  std::vector<uint8_t> buf(1 << 20);
  uint64_t pos = 0;
  while (pos < healthy) {
    size_t chunk = std::min<uint64_t>(buf.size() - (buf.size() % es),
                                      healthy - pos);
    ssize_t got = pread(v->idx_fd, buf.data(), chunk, pos);
    if (got != (ssize_t)chunk) return -3;
    for (size_t i = 0; i + es <= chunk; i += es) {
      const uint8_t* p = buf.data() + i;
      uint64_t key = be64(p);
      uint64_t scaled = be32(p + 8);
      const uint8_t* szp = p + 12;
      if (offset_size == 5) {
        scaled |= (uint64_t)p[12] << 32;
        szp = p + 13;
      }
      uint64_t off = scaled * PAD;
      int32_t size = (int32_t)be32(szp);
      if (key == EMPTY_KEY) return -3;  // sentinel collision: stay in Python
      if (key > v->max_key) v->max_key = key;  // load counts deletes too
      if (off != 0 && size > 0 && size != TOMBSTONE)
        v->apply_put(key, off, size);
      else
        v->apply_delete(key);
    }
    pos += chunk;
  }
  std::unique_lock<std::shared_mutex> lk(e->reg_mu);
  if (e->vols.count(vid)) return -2;
  e->vols[vid] = v;
  return 0;
}

int turbo_unregister(long long handle, unsigned vid) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  std::shared_ptr<Vol> v;
  {
    std::unique_lock<std::shared_mutex> lk(e->reg_mu);
    auto it = e->vols.find(vid);
    if (it == e->vols.end()) return -2;
    v = it->second;
    e->vols.erase(it);
  }
  {
    // wait for the in-flight op (if any) and fence future ones
    std::lock_guard<std::mutex> lk(v->mu);
    v->dead.store(true);
  }
  return 0;
}

int turbo_lookup(long long handle, unsigned vid, unsigned long long key,
                 unsigned long long* off, int* size) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  auto v = e->get_vol(vid);
  if (!v) return -2;
  std::lock_guard<std::mutex> lk(v->mu);
  Slot* s = v->map.find(key);
  if (!s) return 0;
  *off = s->off;
  *size = s->size;
  return 1;
}

// Append a fully-built record (Python writes exotic needles through here).
// is_delete: record is a tombstone; size_field is the idx entry size value.
int turbo_append(long long handle, unsigned vid, unsigned long long key,
                 const unsigned char* rec, unsigned long long rec_len,
                 int size_field, int is_delete, unsigned long long* out_off) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  if (key == EMPTY_KEY) return -5;  // needle-map slot sentinel; unstorable
  auto v = e->get_vol(vid);
  if (!v) return -2;
  std::lock_guard<std::mutex> lk(v->mu);
  if (v->dead.load()) return -2;
  uint64_t off = v->append_off;
  if (off > v->max_offset()) return -4;  // unrepresentable in this idx flavor
  if (pwrite(v->dat_fd, rec, rec_len, off) != (ssize_t)rec_len) return -1;
  v->append_off += rec_len;
  if (is_delete) {
    if (v->write_idx_entry(key, off, TOMBSTONE) != 0) return -1;
    v->apply_delete(key);
  } else {
    if (v->write_idx_entry(key, off, size_field) != 0) return -1;
    v->apply_put(key, off, size_field);
  }
  if (rec_len >= NEEDLE_HEADER + CHECKSUM_SIZE + TS_SIZE &&
      v->version == 3) {
    // trailer timestamp sits before padding; recover it for stats
    int32_t nsize = is_delete ? 0 : size_field;
    int64_t ts_off = NEEDLE_HEADER + nsize + CHECKSUM_SIZE;
    if ((uint64_t)(ts_off + TS_SIZE) <= rec_len)
      v->last_append_ns = be64(rec + ts_off);
  }
  *out_off = off;
  return 0;
}

// out[9]: file_count, file_bytes, del_count, del_bytes, max_key,
//         dat_size, idx_size, last_modified_s, last_append_ns
int turbo_stats(long long handle, unsigned vid, unsigned long long* out) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  auto v = e->get_vol(vid);
  if (!v) return -2;
  std::lock_guard<std::mutex> lk(v->mu);
  out[0] = v->file_count;
  out[1] = v->file_bytes;
  out[2] = v->del_count;
  out[3] = v->del_bytes;
  out[4] = v->max_key;
  out[5] = v->append_off;
  out[6] = v->idx_size;
  out[7] = v->last_modified_s;
  out[8] = v->last_append_ns;
  return 0;
}

int turbo_set_readonly(long long handle, unsigned vid, int ro) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  auto v = e->get_vol(vid);
  if (!v) return -2;
  v->read_only.store(ro != 0);
  return 0;
}

int turbo_sync(long long handle, unsigned vid) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return -1;
  auto v = e->get_vol(vid);
  if (!v) return -2;
  std::lock_guard<std::mutex> lk(v->mu);
  fsync(v->dat_fd);
  fsync(v->idx_fd);
  return 0;
}

// out[4]: native gets, posts, deletes, proxied
void turbo_counters(long long handle, unsigned long long* out) {
  Engine* e = (Engine*)(intptr_t)handle;
  if (!e) return;
  out[0] = e->n_get.load();
  out[1] = e->n_post.load();
  out[2] = e->n_delete.load();
  out[3] = e->n_proxy.load();
}

#pragma GCC visibility pop
}  // extern "C"
