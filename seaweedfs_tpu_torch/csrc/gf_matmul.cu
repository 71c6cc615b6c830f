// GF(2^8) matrix product for Reed-Solomon erasure coding, for Hopper (sm_90a).
//
//   out[r, c] = XOR_d  gf_mul(M[r, d], data[d, c])      over GF(2^8), poly 0x11D
//
// Replaces the TPU kernel build_pallas_gf_matmul (seaweedfs_tpu/ec/codec.py,
// pallas_call at :246). The TPU kernel unpacks bytes into bit planes and runs
// an int8 MXU product against an 8R x 8k bit matrix. This kernel keeps the
// bytes packed, four to a 32-bit word, and runs on the CUDA cores.
//
// Algebra: multiplication by a constant is GF(2)-linear and doubling
// ("xtime") distributes over XOR, so with
//
//   S[r][j] = XOR over the d with bit j of M[r, d] set, of data[d]
//
// each output row is a Horner evaluation over the coefficient bits:
//
//   out[r] = xtime(... xtime(xtime(S[r][7]) ^ S[r][6]) ...) ^ S[r][0].
//
// Four bytes double at once (SWAR): xtime(v) = ((v << 1) & 0xfefefefe) ^
// (sign(v) & 0x1d1d1d1d), where sign(v) sets a byte to 0xff when its top bit
// is set (one PRMT in sign-replicate mode).
//
// Layout: each thread owns kBytes = 32 consecutive columns; blocks are 128
// threads. It loads its columns of all the chunk's data rows into registers
// first (two 16-byte __ldg loads a row), then for each output row runs the
// Horner chain, XORing in the data words picked by that row's coefficient
// bits, and stores the row before starting the next: the data is read once
// whatever R is. The coefficient bits come as per-(r, j) masks (bit d = bit j
// of M[r, d]) built on the host and passed by value as a __grid_constant__
// parameter, so every test is warp-uniform and no thread reads coefficients
// from device memory. Data rows are taken in chunks of at most kChunk, which
// bounds the registers; a matrix with k > kChunk runs one launch per chunk,
// and every chunk after the first XORs its partial rows into out (Horner is
// linear). The ragged tail and rows that are not 16-byte aligned take a small
// word-at-a-time path with byte loads and stores, kept apart so that its
// addresses do not hold registers in the vector path.
//
// Integer instructions per input byte for RS(10,4) (R = 4, k = 10; the parity
// matrix has 156 set coefficient bits of 320):
//   the earlier SWAR kernel, seven doublings per input row: ~14.7, of which
//     ~8.8 in doublings (0.387 ms per 32 MiB-column launch, H100 SXM 700 W);
//   this kernel: doublings 7 * R per word instead of 7 * k, 3 integer ops each
//     (PRMT, two LOP3; the shift is an IMAD.SHL on the FMA pipe): 2.1; XORs
//     only for set bits: 3.9; one bit test each (LOP3 into a predicate): 1.0.
//     7.0 in all, beside 0.7 IMAD.SHL and 1.0 uniform branch.
// What the compiler makes of the tests decides this. In the SASS of
// gf_matmul_kernel<10> (cuobjdump -sass), each (r, j) loads its mask with one
// LDC; each bit d is a LOP3 into a predicate and a warp-uniform @!P BRA over
// the row's eight XORs, so an unset bit costs two issue slots and no XOR. With
// 16 columns a thread (kWords = 4) the compiler if-converts the same tests
// into predicated XORs that issue for every bit, set or not (~11 integer ops
// per input byte), which is why the tile is 32 columns.
//
// Bound: memory. The product moves (k + R) bytes per column, 1.4 bytes per
// input byte for RS(10,4): 0.140 ms per 32 MiB-column launch at 3.35 TB/s. At
// ~15 T integer ops/s (64 INT32 lanes per clock per SM, 132 SMs) the 7.0 ops
// per input byte take ~0.16 ms, so integer issue still sits just above the
// memory bound. Measured on an H100 SXM (700 W): 0.178 ms per launch back to
// back in a 30 GiB encode, 79 % of the memory bound.
//
// Compiled (nvcc -Xptxas -v, CUDA 12.8, sm_90a): gf_matmul_kernel<10> uses
// 106 registers, <16> 154, no spills, no shared memory: 16 warps per SM for
// RS(10,4). Phase 0 of chip_smoke.py prints the registers and a summary of
// the SASS above.
//
// Binding: a plain C entry point (gf_matmul_launch) loaded with ctypes. It
// takes the masks from host memory, launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch. With accumulate set, the first chunk also XORs
// into out, as every later chunk does: the multi-device codec
// (ec/sharded.py) sums the partial products of a split contraction so.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

constexpr int kThreads = 128;  // 4 blocks of 106-register threads per SM at k = 10
constexpr int kMaxRows = 64;  // R and k limits
constexpr int kMaxCols = 64;
constexpr int kChunk = 16;    // data rows held in registers per launch
constexpr int kWords = 8;     // 32-bit words per thread per row: 32 columns
constexpr int kBytes = 4 * kWords;
static_assert(kWords % 4 == 0, "a thread's columns are whole 16-byte vectors");

// The coefficient bits of one chunk of data rows: bit d of m[r][j] is bit j
// of M[r, d0 + d].
struct ChunkMasks {
  uint16_t m[kMaxRows][8];
};

__device__ __forceinline__ uint32_t xtime4(uint32_t v) {
  uint32_t sign;  // 0xff in each byte whose top bit is set
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(sign) : "r"(v), "r"(0u), "r"(0xba98u));
  return ((v << 1) & 0xfefefefeu) ^ (sign & 0x1d1d1d1du);
}

// Output row r of the chunk over NW words of columns: Horner over the
// coefficient bits j from 7 down to 0, acc = xtime(acc) ^ S[r][j].
template <int KC, int NW>
__device__ __forceinline__ void horner_row(const ChunkMasks& masks, int r,
                                           const uint32_t (&x)[KC][NW], uint32_t (&acc)[NW]) {
#pragma unroll
  for (int q = 0; q < NW; ++q) acc[q] = 0u;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (j < 7) {
#pragma unroll
      for (int q = 0; q < NW; ++q) acc[q] = xtime4(acc[q]);
    }
    const uint32_t m = masks.m[r][j];
#pragma unroll
    for (int d = 0; d < KC; ++d) {
      if ((m >> d) & 1u) {  // a warp-uniform branch over the row's XORs
#pragma unroll
        for (int q = 0; q < NW; ++q) acc[q] ^= x[d][q];
      }
    }
  }
}

// Bytes [c, min(c + 4, n)) of a row as one little-endian word, 0 past n.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, long long c, long long n) {
  uint32_t w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (c + b < n) w |= uint32_t(row[c + b]) << (8 * b);
  }
  return w;
}

__device__ __forceinline__ void store_word(uint8_t* row, long long c, long long n, uint32_t w) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (c + b < n) row[c + b] = uint8_t(w >> (8 * b));
  }
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const __grid_constant__ ChunkMasks masks, int R,
                 const uint8_t* __restrict__ data, long long data_ld,
                 uint8_t* __restrict__ out, long long out_ld,
                 long long n, bool vec, bool accumulate) {
  const long long c0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  if (c0 >= n) return;

  if (vec && c0 + kBytes <= n) {
    // every load is issued before the first Horner chain
    uint32_t x[KC][kWords];
#pragma unroll
    for (int d = 0; d < KC; ++d) {
      const uint4* p = reinterpret_cast<const uint4*>(data + d * data_ld + c0);
#pragma unroll
      for (int v = 0; v < kWords / 4; ++v) {
        const uint4 t = __ldg(p + v);
        x[d][4 * v] = t.x; x[d][4 * v + 1] = t.y; x[d][4 * v + 2] = t.z; x[d][4 * v + 3] = t.w;
      }
    }
    for (int r = 0; r < R; ++r) {
      uint32_t acc[kWords];
      horner_row<KC, kWords>(masks, r, x, acc);
      uint4* p = reinterpret_cast<uint4*>(out + r * out_ld + c0);
#pragma unroll
      for (int v = 0; v < kWords / 4; ++v) {
        uint4 t = make_uint4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
        if (accumulate) {  // a later chunk: XOR into the partial rows already there
          const uint4 prev = p[v];
          t.x ^= prev.x; t.y ^= prev.y; t.z ^= prev.z; t.w ^= prev.w;
        }
        p[v] = t;
      }
    }
    return;
  }

  // The ragged tail, or rows not 16-byte aligned: one word at a time through
  // byte loads and stores. Rare, so it is kept small rather than fast.
  const long long end = c0 + kBytes < n ? c0 + kBytes : n;
#pragma unroll 1
  for (long long c = c0; c < end; c += 4) {
    uint32_t x[KC][1];
#pragma unroll
    for (int d = 0; d < KC; ++d) x[d][0] = load_word(data + d * data_ld, c, n);
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      uint32_t acc[1];
      horner_row<KC, 1>(masks, r, x, acc);
      uint8_t* row = out + r * out_ld;
      store_word(row, c, n, accumulate ? acc[0] ^ load_word(row, c, n) : acc[0]);
    }
  }
}

using ChunkLaunch = void (*)(dim3, cudaStream_t, const ChunkMasks&, int, const uint8_t*,
                             long long, uint8_t*, long long, long long, bool, bool);

template <int KC>
void launch_chunk(dim3 grid, cudaStream_t stream, const ChunkMasks& masks, int R,
                  const uint8_t* data, long long data_ld, uint8_t* out, long long out_ld,
                  long long n, bool vec, bool accumulate) {
  gf_matmul_kernel<KC><<<grid, kThreads, 0, stream>>>(masks, R, data, data_ld, out, out_ld,
                                                      n, vec, accumulate);
}

template <int... K>
constexpr std::array<ChunkLaunch, sizeof...(K)> chunk_launches(std::integer_sequence<int, K...>) {
  return {&launch_chunk<K + 1>...};
}

// kLaunch[kc - 1] launches the kernel for a chunk of kc data rows
constexpr auto kLaunch = chunk_launches(std::make_integer_sequence<int, kChunk>{});

}  // namespace

// masks: host uint64[R][8], bit d of masks[r][j] = bit j of M[r, d]; read
// during the call only (each launch takes its chunk's masks by value).
// accumulate != 0: out ^= M (x) data instead of out = M (x) data.
extern "C" int gf_matmul_launch(const unsigned long long* masks, int R, int k,
                                const void* data, long long data_ld,
                                void* out, long long out_ld,
                                long long n, int accumulate, void* stream) {
  if (masks == nullptr || R < 1 || R > kMaxRows || k < 1 || k > kMaxCols || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  // the 16-byte vector path needs every row start 16-byte aligned
  const bool vec = (reinterpret_cast<uintptr_t>(data) % 16 == 0) && (data_ld % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (out_ld % 16 == 0);
  const long long threads = (n + kBytes - 1) / kBytes;
  const dim3 grid(static_cast<unsigned int>((threads + kThreads - 1) / kThreads));
  for (int d0 = 0; d0 < k; d0 += kChunk) {
    const int kc = k - d0 < kChunk ? k - d0 : kChunk;
    ChunkMasks cm{};
    for (int r = 0; r < R; ++r) {
      for (int j = 0; j < 8; ++j) cm.m[r][j] = static_cast<uint16_t>(masks[r * 8 + j] >> d0);
    }
    kLaunch[kc - 1](grid, static_cast<cudaStream_t>(stream), cm, R,
                    static_cast<const uint8_t*>(data) + d0 * data_ld, data_ld,
                    static_cast<uint8_t*>(out), out_ld, n, vec, accumulate != 0 || d0 > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
