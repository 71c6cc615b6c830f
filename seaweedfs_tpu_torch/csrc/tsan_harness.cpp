// ThreadSanitizer stress harness for the turbo engine (SURVEY §5.2 asks
// for TSan-equivalent coverage where native code exists).
//
// Links turbo.cpp directly and exercises every concurrency seam at once:
// epoll workers serving HTTP GET/POST/DELETE, the Python-delegation C API
// (turbo_append / turbo_lookup) racing the HTTP writers on the same
// volume, stats/counters/sync readers, and a readonly-flag toggler. Any
// data race TSan sees makes the process exit non-zero (default TSan
// exitcode=66), which tests/torch_port/test_torch_tsan.py treats as failure.
//
// The PyTorch port's copy of the JAX package's harness, linked against the
// port's engine (csrc/turbo.cpp). Build (storage/turbo.py build_tsan_harness
// does this at first use, into csrc/build/):
//   g++ -O3 -march=native -std=c++17 -fPIC -Wall -fsanitize=thread -O1 -g \
//       -o tsan_harness-<hash> turbo.cpp tsan_harness.cpp -lpthread -lz
// Run: tsan_harness-<hash> <workdir>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {
long long turbo_start(const char* bind_ip, int port, const char* backend_ip,
                      int backend_port, int threads);
void turbo_stop(long long handle);
void turbo_set_jwt(long long handle, const char* wk, const char* rk);
int turbo_register(long long handle, unsigned vid, const char* dat_path,
                   const char* idx_path, int version, int offset_size,
                   int writable_http, int read_only);
int turbo_append(long long handle, unsigned vid, unsigned long long key,
                 const unsigned char* rec, unsigned long long rec_len,
                 int size_field, int is_delete, unsigned long long* out_off);
int turbo_lookup(long long handle, unsigned vid, unsigned long long key,
                 unsigned long long* off, int* size);
int turbo_stats(long long handle, unsigned vid, unsigned long long* out);
int turbo_sync(long long handle, unsigned vid);
int turbo_set_readonly(long long handle, unsigned vid, int ro);
void turbo_counters(long long handle, unsigned long long* out);
}

namespace {

int http_roundtrip(int port, const std::string& req) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(port);
  inet_pton(AF_INET, "127.0.0.1", &a.sin_addr);
  timeval tv{2, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (connect(fd, (sockaddr*)&a, sizeof(a)) < 0) {
    close(fd);
    return -1;
  }
  (void)!send(fd, req.data(), req.size(), MSG_NOSIGNAL);
  char buf[4096];
  ssize_t n = recv(fd, buf, sizeof(buf), 0);
  close(fd);
  if (n < 12) return -1;
  return (buf[9] - '0') * 100 + (buf[10] - '0') * 10 + (buf[11] - '0');
}

// one valid v3 needle record for turbo_append (cookie|key|size|data|crc|ts|pad)
std::vector<uint8_t> make_record(uint64_t key, uint32_t size_field) {
  // header 16 + [4B dlen + data + 1B flags] + crc4 + ts8 + pad→8
  uint32_t dlen = size_field - 5;  // size = 4 + dlen + 1 for plain data
  size_t body = size_field;
  size_t raw = 16 + body + 4 + 8;
  size_t padded = (raw + 7) & ~size_t(7);
  std::vector<uint8_t> r(padded, 0);
  auto be32 = [&](size_t off, uint32_t v) {
    r[off] = v >> 24; r[off + 1] = v >> 16; r[off + 2] = v >> 8; r[off + 3] = v;
  };
  auto be64 = [&](size_t off, uint64_t v) {
    for (int i = 0; i < 8; i++) r[off + i] = v >> (56 - 8 * i);
  };
  be32(0, 0xC00C1Eu);       // cookie
  be64(4, key);
  be32(12, size_field);
  be32(16, dlen);
  for (uint32_t i = 0; i < dlen; i++) r[20 + i] = (uint8_t)(key + i);
  r[20 + dlen] = 0;          // flags
  // crc over data bytes — harness uses 0; readers through the C API don't
  // verify, and HTTP readers only read HTTP-written needles
  be64(16 + body + 4, 1234567890ull);  // timestamp ns
  return r;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: tsan_harness <workdir>\n");
    return 2;
  }
  std::string dir = argv[1];
  std::string dat = dir + "/1.dat", idx = dir + "/1.idx";
  FILE* f = fopen(dat.c_str(), "wb");
  if (!f) {
    fprintf(stderr, "cannot create %s\n", dat.c_str());
    return 2;
  }
  uint8_t sb[8] = {3, 0, 0, 0, 0, 0, 0, 0};  // v3 superblock
  fwrite(sb, 1, 8, f);
  fclose(f);
  FILE* fi = fopen(idx.c_str(), "wb");
  if (!fi) {
    fprintf(stderr, "cannot create %s\n", idx.c_str());
    return 2;
  }
  fclose(fi);

  long long h = 0;
  int port = 0;
  std::mt19937 seed_rng(12345);
  for (int attempt = 0; attempt < 20 && !h; attempt++) {
    port = 20000 + (int)(seed_rng() % 20000);
    h = turbo_start("127.0.0.1", port, "127.0.0.1", 1, 2);  // 2 workers
  }
  if (!h) {
    fprintf(stderr, "turbo_start failed\n");
    return 2;
  }
  if (turbo_register(h, 1, dat.c_str(), idx.c_str(), 3, 4, 1, 0) != 0) {
    fprintf(stderr, "turbo_register failed\n");
    return 2;
  }

  std::atomic<bool> stop{false};
  std::atomic<int> http_posts{0}, http_gets{0}, api_appends{0};
  std::vector<std::thread> ts;

  // HTTP writers (distinct key ranges per thread)
  for (int t = 0; t < 3; t++) {
    ts.emplace_back([&, t] {
      std::mt19937 rng(t);
      int i = 0;
      while (!stop.load()) {
        char path[64];
        snprintf(path, sizeof(path), "/1,%xdeadbeef",
                 0x1000 * (t + 1) + (i++ % 512));
        std::string body(64 + rng() % 512, 'x');
        std::string req = std::string("POST ") + path +
                          " HTTP/1.1\r\nHost: x\r\nContent-Length: " +
                          std::to_string(body.size()) + "\r\n\r\n" + body;
        if (http_roundtrip(port, req) == 201) http_posts++;
      }
    });
  }
  // HTTP readers
  for (int t = 0; t < 3; t++) {
    ts.emplace_back([&, t] {
      std::mt19937 rng(100 + t);
      while (!stop.load()) {
        char path[64];
        snprintf(path, sizeof(path), "/1,%xdeadbeef",
                 (unsigned)(0x1000 * (1 + rng() % 3) + rng() % 512));
        std::string req = std::string("GET ") + path +
                          " HTTP/1.1\r\nHost: x\r\n\r\n";
        int st = http_roundtrip(port, req);
        if (st == 200 || st == 404) http_gets++;
      }
    });
  }
  // C-API appender + lookups (the Python-delegation seam) on its own keys
  ts.emplace_back([&] {
    uint64_t key = 0x900000;
    while (!stop.load()) {
      auto rec = make_record(key, 64);
      unsigned long long off = 0;
      if (turbo_append(h, 1, key, rec.data(), rec.size(), 64, 0, &off) == 0)
        api_appends++;
      unsigned long long o;
      int sz;
      turbo_lookup(h, 1, key - (key % 7), &o, &sz);
      key++;
    }
  });
  // stats / counters / sync reader
  ts.emplace_back([&] {
    while (!stop.load()) {
      unsigned long long st[11], c4[4];
      turbo_stats(h, 1, st);
      turbo_counters(h, c4);
      turbo_sync(h, 1);
    }
  });
  // readonly toggler (writers then see 500s; flag races are the point)
  ts.emplace_back([&] {
    int i = 0;
    while (!stop.load()) {
      turbo_set_readonly(h, 1, (i++ % 8) == 7 ? 1 : 0);
      std::this_thread::sleep_for(std::chrono::milliseconds(20));
    }
  });

  std::this_thread::sleep_for(std::chrono::seconds(3));
  stop.store(true);
  for (auto& t : ts) t.join();
  // the per-volume heat counts: every native GET answered 200/404 is a
  // read, every 201 POST a write
  unsigned long long fin[11];
  turbo_stats(h, 1, fin);
  turbo_stop(h);
  fprintf(stderr, "harness done: posts=%d gets=%d api_appends=%d reads=%llu writes=%llu\n",
          http_posts.load(), http_gets.load(), api_appends.load(), fin[9], fin[10]);
  if (http_posts.load() < 50 || http_gets.load() < 50 ||
      api_appends.load() < 50) {
    fprintf(stderr, "too little traffic exercised\n");
    return 3;
  }
  if (fin[9] < (unsigned long long)http_gets.load() ||
      fin[10] < (unsigned long long)http_posts.load()) {
    fprintf(stderr, "heat counts below the replies served\n");
    return 3;
  }
  return 0;
}
