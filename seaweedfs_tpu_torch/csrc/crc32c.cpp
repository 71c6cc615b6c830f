// CRC-32C (Castagnoli), slicing-by-8, for needle checksums on the host.
//
// The same function as the JAX package's native `sweed_crc32c_update`
// (seaweedfs_tpu/native/sweed_native.cpp:82) and the reference's
// klauspost/crc32 Castagnoli table (weed/storage/needle/crc.go): Go's
// crc32.Update semantics, pre- and post-inverted.
//
// Build: g++ -O3 -shared -fPIC -o libcrc32c.so crc32c.cpp (storage/crc.py does
// this at first use). ABI: one plain C function, bound with ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    constexpr uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t crc = i;
      for (int k = 0; k < 8; k++) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      t[0][i] = crc;
    }
    for (int k = 1; k < 8; k++)
      for (uint32_t i = 0; i < 256; i++)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const CrcTables& crc_tables() {
  static CrcTables t;
  return t;
}

}  // namespace

extern "C" {

uint32_t crc32c_update(uint32_t crc, const uint8_t* data, size_t n) {
  const CrcTables& ct = crc_tables();
  crc ^= 0xFFFFFFFFu;
  size_t i = 0;
  while (n - i >= 8) {
    uint32_t lo;
    std::memcpy(&lo, data + i, 4);
    crc ^= lo;  // little-endian host (x86-64, arm64)
    crc = ct.t[7][crc & 0xFF] ^ ct.t[6][(crc >> 8) & 0xFF] ^
          ct.t[5][(crc >> 16) & 0xFF] ^ ct.t[4][(crc >> 24) & 0xFF] ^
          ct.t[3][data[i + 4]] ^ ct.t[2][data[i + 5]] ^
          ct.t[1][data[i + 6]] ^ ct.t[0][data[i + 7]];
    i += 8;
  }
  for (; i < n; i++) crc = (crc >> 8) ^ ct.t[0][(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
