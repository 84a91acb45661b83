// Row gather out[i] = table[clamp(idx[i], 0, S - 1)] for Hopper (sm_90a).
//
// Replaces scripts/bench_gather_pallas.py::make_gather(...).run, the TPU
// probe of the deformable convolution's row gather (its take / index /
// one-hot / loop modes all compute this function), and with it the XLA
// gathers of da_detect_tpu/layers/deform_conv.py::_gather_tap. The port's
// DeformConv2d launches it once a kernel tap with the four bilinear corners'
// indices as one index vector (TPU.DCN_GATHER "four"); the deformable
// PS-ROI pooling (layers/deform_pool.py) once a pool, on rows of 9 floats.
//
// table: S rows of C elements, row r at table + r * row_stride (row_stride
// >= C, so a deformable group can gather its column slice of a wider map
// without a copy); idx [P] int32; out [P, C] contiguous.
//
// Bound: bytes. Each gathered row is read once, each index once and each
// output row written once. The output dominates: at res3 one tap writes
// 4 * 11552 * 512 * 4 B = 94.6 MB; the deform pool's launch writes
// 802,816 rows of 36 B = 28.9 MB from a 5.1 MB table. The tables are read
// through the caches: the DCN tables are 5.9-47 MB in float32 (res3 block
// 0: 94.6 MB), so most stay in the 50 MB L2, and the four corners of one
// sample are neighbouring rows.
//
// Design. The TPU probe keeps the table resident in VMEM and gathers along
// sublanes. On Hopper a row is a contiguous run in device memory, so the
// gather is a copy, and what matters is that every lane moves bytes, that
// a warp's loads fall on few lines and that the output goes out as whole
// 16-byte stores. The launch picks one of two mappings from the row's
// bytes, the row stride and the alignment:
// - Wide rows: a warp a row, a block of 8 warps covers 8 rows, and the
//   warp's lanes move the row in 16-byte vectors (uint4) when C *
//   sizeof(T), the row stride and both pointers allow it ("words"), else
//   element by element. A row fills the lanes.
// - Narrow rows: a warp a row would leave most lanes idle (9 of 32 on a
//   36-byte row), keep one short read in flight a warp and write in short
//   partial stores. Threads map over the flat output [P * C] instead, so
//   every lane works and a warp's stores are one contiguous run. Rows of
//   words: a thread copies kUnroll 16-byte words, each found from its flat
//   position (one division), a block's threads on consecutive words. Other
//   rows: a warp fills a tile of 512 output bytes; its load k reads
//   elements k * 32 + lane of the tile (a few neighbouring table rows a
//   load, each thread's row found by one division and stepped from there),
//   and the tile is turned in shared memory so that each lane writes one
//   16-byte run. The ragged last tile, and an output not 16-byte aligned,
//   are stored element by element. Flat positions are 32-bit where the
//   output allows it (the division is then a 32-bit one), 64-bit beyond.
// The crossovers are where a width sweep on the card (chip_smoke.py phase
// gather_sweep; PERF.md) puts them: rows of words take a warp a row from
// kWideWordRowBytes (1024 B: the flat mapping 5% faster at 512 B, even at
// 1024 and 2048), other rows from kWideRowBytes (512 B: the flat mapping
// faster at 260 B, 20% slower at 516 B in bfloat16). The DCN taps' rows
// (512 channels and up, 1024-8192 B) keep a warp a row; the deform pool's
// (9 floats, 36 B) go flat.
//
// Numerics: a copy, bit for bit equal to the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// 16-byte words a thread, narrow rows of whole words
constexpr int kUnroll = 4;
// rows of at least these many bytes take a warp a row: rows of whole
// 16-byte words, and other rows (the width sweep's crossovers)
constexpr long long kWideWordRowBytes = 1024;
constexpr long long kWideRowBytes = 512;

// the mappings; row_gather_mapped_* names one, row_gather_* lets the shapes
// pick (kAuto)
enum Mapping { kAuto = 0, kRows = 1, kFlat = 2, kFlat64 = 3 };

__device__ __forceinline__ int clamp_row(int r, int s) {
  return r < 0 ? 0 : (r >= s ? s - 1 : r);
}

// wide rows: a warp a row
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    T* __restrict__ out, long long p, int s, int c, long long row_stride) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps
                        + threadIdx.x / 32;
  if (row >= p) return;
  const int lane = threadIdx.x % 32;
  const int r = clamp_row(__ldg(idx + row), s);
  const T* src = table + static_cast<long long>(r) * row_stride;
  T* dst = out + row * c;
  if (kVector) {
    const int n16 = c * static_cast<int>(sizeof(T)) / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(src);
    uint4* d16 = reinterpret_cast<uint4*>(dst);
    for (int j = lane; j < n16; j += 32) d16[j] = __ldg(s16 + j);
  } else {
    for (int j = lane; j < c; j += 32) dst[j] = src[j];
  }
}

// narrow rows of whole 16-byte words: a thread kUnroll words of the flat
// output [P * row_words], kThreads apart
template <typename Flat>
__global__ void __launch_bounds__(kThreads) row_gather_kernel_words(
    const uint4* __restrict__ table, const int* __restrict__ idx,
    uint4* __restrict__ out, Flat words, int s, int row_words,
    long long stride_words) {
  const Flat first = static_cast<Flat>(blockIdx.x) * (kThreads * kUnroll)
                     + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Flat q = first + static_cast<Flat>(k) * kThreads;
    if (q < words) {
      const Flat row = q / static_cast<Flat>(row_words);
      const int j = static_cast<int>(q - row * row_words);
      const int r = clamp_row(__ldg(idx + row), s);
      v[k] = __ldg(table + static_cast<long long>(r) * stride_words + j);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const Flat q = first + static_cast<Flat>(k) * kThreads;
    if (q < words) out[q] = v[k];
  }
}

// other narrow rows: a warp one tile of 32 * kV elements (512 bytes) of
// the flat output [P * C], elements moved as raw bits (Bits: the element's
// width). Load k reads elements k * 32 + lane: a warp's loads fall on a
// few neighbouring table rows. The tile is turned in shared memory, so
// that each lane stores 16 contiguous bytes (kV elements)
template <typename Bits, typename Flat>
__global__ void __launch_bounds__(kThreads) row_gather_kernel_elems(
    const Bits* __restrict__ table, const int* __restrict__ idx,
    Bits* __restrict__ out, Flat total, int s, int c, long long row_stride,
    int step_rows, int step_cols, bool word_stores) {
  constexpr int kV = 16 / sizeof(Bits);
  constexpr int kTile = 32 * kV;
  __shared__ uint4 stage[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const Flat base = (static_cast<Flat>(blockIdx.x) * kWarps + warp) * kTile;
  if (base >= total) return;
  // element e = base + k * 32 + lane at (row, col); 32 elements on is
  // step_rows rows and step_cols columns on (32 = step_rows * c +
  // step_cols), so one division serves all kV
  Flat e = base + lane;
  Flat row = e / static_cast<Flat>(c);
  int col = static_cast<int>(e - row * c);
  Bits v[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    if (e < total) {
      const int r = clamp_row(__ldg(idx + row), s);
      v[k] = __ldg(table + static_cast<long long>(r) * row_stride + col);
    }
    e += 32;
    row += step_rows;
    col += step_cols;
    if (col >= c) {
      col -= c;
      ++row;
    }
  }
  if (word_stores && base + kTile <= total) {
    Bits* tile = reinterpret_cast<Bits*>(stage[warp]);
#pragma unroll
    for (int k = 0; k < kV; ++k) tile[k * 32 + lane] = v[k];
    __syncwarp();
    reinterpret_cast<uint4*>(out)[base / kV + lane] = stage[warp][lane];
    return;
  }
  // the ragged last tile, or an output not 16-byte aligned
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const Flat f = base + k * 32 + lane;
    if (f < total) out[f] = v[k];
  }
}

template <typename Kernel, typename... Args>
int run(Kernel kernel, long long blocks, cudaStream_t stream,
        Args... args) {
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

// a 32-bit flat position covers n units and the last block's overhang
bool fits32(long long n, long long block_units) {
  return n + block_units <= static_cast<long long>(UINT_MAX);
}

template <typename T, typename Bits>
int launch(const void* table, const int* idx, void* out, long long p, int s,
           int c, long long row_stride, int mapping, cudaStream_t stream) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const long long row_bytes = static_cast<long long>(c) * sizeof(T);
  const bool words = row_bytes % 16 == 0
                     && (row_stride * static_cast<long long>(sizeof(T))) % 16
                            == 0
                     && aligned16(table) && aligned16(out);
  if (mapping == kAuto)
    mapping = row_bytes >= (words ? kWideWordRowBytes : kWideRowBytes)
                  ? kRows : kFlat;
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (mapping == kRows) {
    const long long blocks = (p + kWarps - 1) / kWarps;
    return words ? run(row_gather_kernel<T, true>, blocks, stream, t, idx, o,
                       p, s, c, row_stride)
                 : run(row_gather_kernel<T, false>, blocks, stream, t, idx,
                       o, p, s, c, row_stride);
  }
  if (mapping != kFlat && mapping != kFlat64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (words) {
    const int row_words = static_cast<int>(row_bytes / 16);
    const long long n = p * row_words;
    const long long per_block = static_cast<long long>(kThreads) * kUnroll;
    const long long blocks = (n + per_block - 1) / per_block;
    const long long stride_words = row_stride * sizeof(T) / 16;
    const uint4* t16 = static_cast<const uint4*>(table);
    uint4* o16 = static_cast<uint4*>(out);
    if (mapping == kFlat && fits32(n, per_block))
      return run(row_gather_kernel_words<unsigned int>, blocks, stream, t16,
                 idx, o16, static_cast<unsigned int>(n), s, row_words,
                 stride_words);
    return run(row_gather_kernel_words<unsigned long long>, blocks, stream,
               t16, idx, o16, static_cast<unsigned long long>(n), s,
               row_words, stride_words);
  }
  constexpr int kV = 16 / sizeof(T);
  const long long n = p * c;
  const long long per_block = static_cast<long long>(kThreads) * kV;
  const long long blocks = (n + per_block - 1) / per_block;
  const Bits* tb = static_cast<const Bits*>(table);
  Bits* ob = static_cast<Bits*>(out);
  const bool word_stores = aligned16(out);
  if (mapping == kFlat && fits32(n, 2 * per_block))
    return run(row_gather_kernel_elems<Bits, unsigned int>, blocks, stream,
               tb, idx, ob, static_cast<unsigned int>(n), s, c, row_stride,
               32 / c, 32 % c, word_stores);
  return run(row_gather_kernel_elems<Bits, unsigned long long>, blocks,
             stream, tb, idx, ob, static_cast<unsigned long long>(n), s, c,
             row_stride, 32 / c, 32 % c, word_stores);
}

}  // namespace

// table: s rows of c elements at row_stride elements apart; idx [p] int32
// (clamped to [0, s - 1]); out [p, c] contiguous. The mapping follows from
// the shapes. Returns a cudaError_t.
extern "C" int row_gather_f32(const void* table, const int* idx, void* out,
                              long long p, int s, int c, long long row_stride,
                              cudaStream_t stream) {
  return launch<float, unsigned int>(table, idx, out, p, s, c, row_stride,
                                     kAuto, stream);
}

extern "C" int row_gather_bf16(const void* table, const int* idx, void* out,
                               long long p, int s, int c,
                               long long row_stride, cudaStream_t stream) {
  return launch<__nv_bfloat16, unsigned short>(table, idx, out, p, s, c,
                                               row_stride, kAuto, stream);
}

// The same gather through a named mapping (1 a warp a row, 2 flat, 3 flat
// with 64-bit positions whatever the size; 0 as the shapes pick): the width
// sweep times both mappings at each width with it, and the card tests hold
// each to the plain version. The port's wrappers do not call it.
extern "C" int row_gather_mapped_f32(const void* table, const int* idx,
                                     void* out, long long p, int s, int c,
                                     long long row_stride, int mapping,
                                     cudaStream_t stream) {
  return launch<float, unsigned int>(table, idx, out, p, s, c, row_stride,
                                     mapping, stream);
}

extern "C" int row_gather_mapped_bf16(const void* table, const int* idx,
                                      void* out, long long p, int s, int c,
                                      long long row_stride, int mapping,
                                      cudaStream_t stream) {
  return launch<__nv_bfloat16, unsigned short>(
      table, idx, out, p, s, c, row_stride, mapping, stream);
}
