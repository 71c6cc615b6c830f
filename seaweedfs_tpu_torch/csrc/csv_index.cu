// CSV structural index of one /_query segment, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds this index on the host with
// numpy (seaweedfs_tpu/query/scan.py:632, ScanPlan._csv_segment and
// _field_vectors) and ships the field vectors to the device per batch; the
// port's plain version is the same numpy index (ScanPlan._host_index and
// _field_vectors in seaweedfs_tpu_torch/query/scan.py). This kernel builds
// the index from the segment's bytes after they are staged on the card, so
// the host neither scans the 32 MiB nor copies the vectors over.
//
// What it computes, for a quote- and CR-free body of n bytes (the bytes past
// n are read as one newline): the non-blank rows in order (a row is the
// bytes between two newlines; DictReader skips empty ones), each row's
// [start, end), and for each referenced field f at header column col[f]
// (-1 when the header lacks it) the triple (start, len, present):
//   present  column col[f] < the row's field count (its commas + 1);
//   start    the byte after the col[f]-th comma, or the row's start;
//   len      up to the next comma, or to the row's end for the last field;
//   a field longer than kMaxFieldW bytes gets len 0, present 0, and marks
//   its row exact (the row goes to the row-at-a-time lane).
// A row's field that is not present gets start = the row's end and len 0; a
// field whose column the header lacks gets (0, 0, 0). Besides, for each batch
// of row_batch rows, each field's largest len (the tree's gather width), and
// the count of exact rows.
//
// Row starts are local: a start is a byte that is not a newline, below n,
// whose previous byte is a newline (or that is byte 0). So the segment is
// cut into tiles of kTile bytes (one block, 16 bytes a thread from one
// 16-byte load), and
//   count_kernel  counts each tile's row starts;
//   scan_kernel   turns the counts into each tile's first row number (one
//                 block) and the row count;
//   walk_kernel   finds the starts again, numbers them by a block scan, packs
//                 them into shared memory, and walks each row from its start
//                 with 16-byte loads, one thread a row (the tile's rows on its
//                 first threads), stopping at the row's end (or, for the
//                 widths, at the highest referenced column).
// walk_kernel runs twice. First for the widths: each row's field lengths go
// into a block's shared maxima for the (at most two) batches its rows fall in,
// then one atomicMax a field a batch per block. The host reads the row count,
// the widths and the exact count in one small copy, its one wait for the card
// a segment, and only then allocates outputs of the exact size (an upper
// bound would be (n + 1) / 2 rows, 4.5 bytes of output per byte of input).
// Then for the rows: it writes the starts, ends and exact flags (int32 [3,
// rows], copied back once) and the field vectors (int32 [fields, 3, rows],
// read on the card by the tree). A row longer than a tile, or crossing tile
// edges, is walked whole by the thread that found its start.
//
// Bound: memory. The index has to read the segment once and write its
// outputs: 12 bytes a row (start, end, exact) and 12 bytes a field a row (the
// vectors). For lineitem's 32 MiB body, ~270 000 rows and 3 fields that is
// ~46 MB, 14 us at 3.35 TB/s. This design reads the segment three times (the
// count pass and both walks; a walk reads up to the highest referenced column,
// or the whole row). A walk is bound by issue, not bytes: it tests every byte
// of a row one at a time (~8 integer ops a byte), one thread a row. Lineitem
// has ~33 rows a tile, so a walk found its rows where they start, 1 to 4 lanes
// of each warp, and issued 8x the instructions it needed (walks 129 and 233 us
// of 389 us a 32 MiB index, H100 SXM 700 W); it packs them onto the block's
// first threads (walks 63 and 77 us of 167 us, 8 % of the bound). It is far
// below the host's ~130-180 ms either way.
//
// Binding: two plain C entry points loaded with ctypes (csv_index_widths,
// csv_index_rows). They take the referenced columns from host memory, launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                // bytes a thread in the tile passes
constexpr int kTile = kThreads * kVec;  // 4096 bytes a block
constexpr int kMaxFields = 256;         // referenced fields (the wrapper's MAX_FIELDS)
constexpr int kMaxFieldW = 512;         // scan.py's _MAX_FIELD_W
constexpr int kScanThreads = 1024;

// The referenced columns: col[f] for each field f, and the fields with a
// column sorted by it (order[0 .. nvalid)), so a walk meets them in order.
struct Cols {
  int nf;
  int nvalid;
  int max_col;
  int col[kMaxFields];
  int order[kMaxFields];
};

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int k) {
  const uint32_t w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> (8 * (k & 3))) & 0xffu;
}

// Bit k set where byte pos + k starts a non-blank row. pos is 16-aligned.
__device__ __forceinline__ uint32_t start_mask(const uint8_t* __restrict__ buf, int n, int pos) {
  if (pos >= n) return 0u;
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(buf + pos));
  uint32_t nl = 0u;
#pragma unroll
  for (int k = 0; k < kVec; ++k) nl |= uint32_t(byte_of(v, k) == '\n') << k;
  const uint32_t prev_nl = pos == 0 ? 1u : uint32_t(__ldg(buf + pos - 1) == '\n');
  const uint32_t below_n = n - pos >= kVec ? 0xffffu : (1u << (n - pos)) - 1u;
  return ~nl & ((nl << 1) | prev_nl) & below_n & 0xffffu;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block must call it.
template <int kBlock>
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = (warp == 0 ? 0 : warp_sums[warp - 1]) + x - v;
  *total = warp_sums[kBlock / 32 - 1];
  __syncthreads();  // warp_sums may be reused by a later call
  return before;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ buf, int n, int* __restrict__ counts) {
  const int pos = static_cast<int>(blockIdx.x) * kTile + static_cast<int>(threadIdx.x) * kVec;
  int total;
  block_exclusive_scan<kThreads>(__popc(start_mask(buf, n, pos)), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// counts[0 .. tiles) -> off[0 .. tiles]: each tile's first row number and,
// last, the row count (also into meta[0]). In place: off aliases counts.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ off, int tiles, int* __restrict__ meta) {
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, tiles), hi = min(lo + per, tiles);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += off[i];
  int total;
  int run = block_exclusive_scan<kScanThreads>(sum, &total);
  for (int i = lo; i < hi; ++i) {
    const int c = off[i];
    off[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    off[tiles] = total;
    meta[0] = total;
  }
}

struct WalkOut {
  int* vecs;      // kWrite: int32 [nf, 3, nrows]
  int* rows;      // kWrite: int32 [3, nrows]: start, end, exact
  int nrows;
  int* widths;    // !kWrite: shared int [2, nf], the block's two batches
  int* exact;     // !kWrite: shared count of exact rows
  int slot;       // !kWrite: the row's batch less the block's first
};

// Field f of row r is [fs, q): its triple, or its length into the widths.
template <bool kWrite>
__device__ __forceinline__ void emit(const WalkOut& o, int nf, int f, int r, int fs, int q,
                                     int* row_exact) {
  int len = q - fs, present = 1;
  if (len > kMaxFieldW) {
    *row_exact = 1;
    len = 0;
    present = 0;
  }
  if (kWrite) {
    int* v = o.vecs + static_cast<long long>(f) * 3 * o.nrows + r;
    v[0] = fs;
    v[o.nrows] = len;
    v[2 * o.nrows] = present;
  } else if (len > 0) {
    atomicMax(&o.widths[o.slot * nf + f], len);
  }
}

// Walk row r from its start s: fields in column order, up to the row's end
// (kWrite) or to the highest referenced column.
template <bool kWrite>
__device__ void walk_row(const uint8_t* __restrict__ buf, int n, int s, int r,
                         const Cols& c, const WalkOut& o) {
  int col = 0, fs = s, p = 0, row_exact = 0, e = -1;
  for (int a = s & ~(kVec - 1); e < 0; a += kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(buf + a));
    uint32_t delim = 0u, nl = 0u;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const uint32_t ch = byte_of(v, k);
      const uint32_t is_nl = uint32_t(a + k >= n || ch == '\n');
      nl |= is_nl << k;
      delim |= (is_nl | uint32_t(ch == ',')) << k;
    }
    if (a < s) {  // the first chunk: bytes before the row's start
      const uint32_t keep = ~((1u << (s - a)) - 1u);
      delim &= keep;
      nl &= keep;
    }
    while (delim) {
      const int k = __ffs(delim) - 1;
      delim &= delim - 1u;
      const int q = a + k;
      while (p < c.nvalid && c.col[c.order[p]] == col) {  // column col is [fs, q)
        emit<kWrite>(o, c.nf, c.order[p], r, fs, q, &row_exact);
        ++p;
      }
      if ((nl >> k) & 1u) {
        e = q;
        break;
      }
      ++col;
      fs = q + 1;
      if (!kWrite && col > c.max_col) {
        e = q;  // every referenced column seen: the widths need no more
        break;
      }
    }
  }
  if (kWrite) {
    for (; p < c.nvalid; ++p) {  // columns past the row's last field
      int* v = o.vecs + static_cast<long long>(c.order[p]) * 3 * o.nrows + r;
      v[0] = e;
      v[o.nrows] = 0;
      v[2 * o.nrows] = 0;
    }
    for (int f = 0; f < c.nf; ++f) {
      if (c.col[f] < 0) {
        int* v = o.vecs + static_cast<long long>(f) * 3 * o.nrows + r;
        v[0] = 0;
        v[o.nrows] = 0;
        v[2 * o.nrows] = 0;
      }
    }
    o.rows[r] = s;
    o.rows[o.nrows + r] = e;
    o.rows[2 * o.nrows + r] = row_exact;
  } else if (row_exact) {
    atomicAdd(o.exact, 1);
  }
}

// kWrite: the rows and field vectors. !kWrite: the widths of each batch
// (meta[2 + b * nf + f], b < max_batches) and the exact count (meta[1]).
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint8_t* __restrict__ buf, int n, const int* __restrict__ off,
            const __grid_constant__ Cols c, int row_batch, int* __restrict__ meta,
            int max_batches, int* __restrict__ vecs, int* __restrict__ rows, int nrows) {
  __shared__ int starts[kTile / 2];  // a start's next byte is not one
  __shared__ int widths[kWrite ? 1 : 2 * kMaxFields];
  __shared__ int exact;
  if (!kWrite) {
    for (int i = threadIdx.x; i < 2 * c.nf; i += kThreads) widths[i] = 0;
    if (threadIdx.x == 0) exact = 0;
  }
  const int pos = static_cast<int>(blockIdx.x) * kTile + static_cast<int>(threadIdx.x) * kVec;
  uint32_t m = start_mask(buf, n, pos);
  int total;
  int j = block_exclusive_scan<kThreads>(__popc(m), &total);  // syncs the zeroing
  while (m) {
    starts[j++] = pos + __ffs(m) - 1;
    m &= m - 1u;
  }
  __syncthreads();
  // the tile's rows packed onto its first threads: a warp walks 32 rows at
  // once, not the few that start in its 512 bytes
  const int first = off[blockIdx.x];
  const int b0 = first / row_batch;
  WalkOut o{vecs, rows, nrows, widths, &exact, 0};
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = first + i;
    if (kWrite && r >= nrows) break;  // cannot happen: the counts are the same starts
    o.slot = r / row_batch - b0;
    walk_row<kWrite>(buf, n, starts[i], r, c, o);
  }
  if (!kWrite) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * c.nf; i += kThreads) {
      const int b = b0 + i / c.nf;
      if (widths[i] > 0 && b < max_batches) atomicMax(&meta[2 + b * c.nf + i % c.nf], widths[i]);
    }
    if (threadIdx.x == 0 && exact) atomicAdd(&meta[1], exact);
  }
}

int make_cols(const int* cols, int nf, Cols* c) {
  if (cols == nullptr || nf < 1 || nf > kMaxFields) return static_cast<int>(cudaErrorInvalidValue);
  c->nf = nf;
  c->nvalid = 0;
  c->max_col = -1;
  for (int f = 0; f < nf; ++f) {
    c->col[f] = cols[f];
    if (cols[f] >= 0) {
      int i = c->nvalid++;  // insertion sort by column
      while (i > 0 && cols[c->order[i - 1]] > cols[f]) {
        c->order[i] = c->order[i - 1];
        --i;
      }
      c->order[i] = f;
      if (cols[f] > c->max_col) c->max_col = cols[f];
    }
  }
  return static_cast<int>(cudaSuccess);
}

bool args_ok(const void* buf, long long n, int row_batch) {
  // int32 offsets, 16-byte loads from an aligned base, and at most two
  // batches a tile (a tile holds at most kTile / 2 row starts)
  return buf != nullptr && reinterpret_cast<uintptr_t>(buf) % 16 == 0 && n >= 1 &&
         n <= 0x7fffffffLL - 2 * kTile && row_batch >= kTile / 2;
}

}  // namespace

// The index's first half, on `stream`: off (int32 [tiles + 1], tiles =
// ceil(n / 4096)) gets each tile's first row number; meta (int32 [2 +
// max_batches * nf], zeroed here) gets the row count, the exact count and
// each batch's field widths. buf holds n bytes and at least 16 more after
// them (the staged pad), 16-byte aligned.
extern "C" int csv_index_widths(const void* buf, long long n, const int* cols, int nf,
                                int row_batch, void* off, void* meta, int max_batches,
                                void* stream) {
  Cols c;
  if (!args_ok(buf, n, row_batch) || off == nullptr || meta == nullptr || max_batches < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bad = make_cols(cols, nf, &c);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  int* o = static_cast<int*>(off);
  int* m = static_cast<int*>(meta);
  cudaError_t err = cudaMemsetAsync(m, 0, sizeof(int) * (2 + static_cast<size_t>(max_batches) * nf), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<tiles, kThreads, 0, s>>>(b, static_cast<int>(n), o);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(o, tiles, m);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  walk_kernel<false><<<tiles, kThreads, 0, s>>>(b, static_cast<int>(n), o, c, row_batch, m,
                                                max_batches, nullptr, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// The index's second half, after the host has read the row count: rows
// (int32 [3, nrows]: start, end, exact) and vecs (int32 [nf, 3, nrows]:
// start, len, present of each referenced field), from the same buf, cols
// and the off that csv_index_widths filled.
extern "C" int csv_index_rows(const void* buf, long long n, const int* cols, int nf,
                              int row_batch, const void* off, void* vecs, void* rows,
                              int nrows, void* stream) {
  Cols c;
  if (!args_ok(buf, n, row_batch) || off == nullptr || vecs == nullptr || rows == nullptr ||
      nrows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bad = make_cols(cols, nf, &c);
  if (bad) return bad;
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  walk_kernel<true><<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<int>(n), static_cast<const int*>(off), c,
      row_batch, nullptr, 0, static_cast<int*>(vecs), static_cast<int*>(rows), nrows);
  return static_cast<int>(cudaGetLastError());
}
