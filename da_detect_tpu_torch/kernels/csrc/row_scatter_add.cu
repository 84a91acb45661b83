// Row scatter-add dst[clamp(idx[i], 0, S - 1)] += grad[i] for Hopper
// (sm_90a): the adjoint of the row gather (row_gather.cu,
// row_gather_bulk.cu), as a sum that each destination row owns.
//
// No TPU kernel stands behind it: the JAX package differentiates its
// gathers (da_detect_tpu/layers/deform_conv.py::_gather_tap and
// _gather_tap_quad) with XLA's autodiff, which makes this scatter-add. The
// port's DeformConv2d launches it once a kernel tap in the backward ("four":
// the four corners' gradient rows as one index vector into the [B*H*W, C]
// map; "quad": one 4C-wide row a sample into the overlapped corner table).
//
// The indices come as CSR (ops/gather.py::row_csr): the source positions
// sorted stably by their clamped destination row, perm [P] int32, and
// row_ptr [S + 1] int32, so that row r's sources are perm[row_ptr[r]] ..
// perm[row_ptr[r + 1] - 1], in ascending order. The DCN layer sorts once a
// layer in its training forward; a bare call sorts itself.
//
// grad [P, C] float32 contiguous; dst: S rows of C floats, row r at
// dst + r * row_stride (row_stride >= C: a deformable group's column slice
// of a wider map). accumulate = 1 adds into dst's values; accumulate = 0
// writes the sums over whatever dst holds (a fresh torch.empty): every row
// is written, a row with no source as zeros, so no zero-fill is needed.
//
// Design. A row launch gives a warp a (destination row, chunk of 128
// columns): each lane a float4 of the chunk when C, the row stride and the
// pointers allow 16-byte vectors, else one float of a 32-column chunk. The
// lanes load 32 of the row's perm entries at once and pass them round
// with shuffles; the warp issues the loads of up to 8 source rows before
// it adds them, so bytes stay in flight, and adds in perm order into a
// register. The row is written once.
// A row of more than kLongRow sources (clamped indices pile onto a border
// row when offsets are large: 44844 of a tap's 46208 sources onto one at
// res3 in a diverged training step) would be one warp's sequential loop,
// so it is summed in pieces. A piece launch before the row launch cuts the
// sorted sources into tiles of kLongRow and gives a warp a (tile, chunk):
// it sums each long row's run in the tile from zero into scratch (at most
// two runs a tile, its first and last rows: a long row cannot fit in one)
// and notes the long row that starts in the tile. In the row launch the
// first blocks, one a (tile, chunk), each sum the pieces of the long row
// that starts in their tile, 8 warps on 8 groups of pieces at once.
// No atomics; the order of every addition is fixed by the CSR alone, so
// the result does not depend on which warp runs first.
// Bound: bytes. Each gradient row read once and each output row written
// once; perm, row_ptr and the pieces (2 * C floats and an int a tile of
// kLongRow sources) are the bookkeeping.
//
// Numerics: a row of at most kLongRow sources is ((dst or 0) + g[s0]) +
// g[s1] + ... in ascending source order, the order of the CPU's
// index_add_, equal to it bit for bit. A longer row is (dst or 0) +
// group_0 + group_1 + ... + group_7, each group a sum from zero of
// ceil(m / 8) consecutive pieces of its m, each piece a sum from zero of
// the row's sources in one tile, in source order: another rounding than
// index_add_, the same from run to run (ops/gather.py::row_scatter_add_csr_
// is this order in plain PyTorch).
//
// Element types: grad and dst float32 (row_scatter_add_f32) or bfloat16
// (row_scatter_add_bf16, the JAX package's compute dtype). A bfloat16 row's
// sources are widened and summed in float32 registers in the same order,
// the pieces' scratch is float32, and each destination value is rounded to
// bfloat16 once, after the last addition (accumulate: the old bfloat16
// value widened and the sum added to it). So a bfloat16 call equals the
// float32 order of its widened inputs, rounded once: not the CPU's bfloat16
// index_add_, which rounds after every addition, nor XLA's bfloat16
// scatter-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// a row of more sources than this is summed in pieces (ops/gather.py's
// LONG_ROW, by which the wrapper sizes the pieces' scratch)
constexpr int kLongRow = 64;

__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void add_to(float& a, const float& b) { a += b; }

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a lane's columns of one row: E (float or __nv_bfloat16) in memory, T
// (float4 or float) in registers
template <typename E, bool kVector>
struct Lane {
  using T = typename std::conditional<kVector, float4, float>::type;
  static constexpr int kWidth = kVector ? 4 : 1;
  __device__ static T zero() {
    if constexpr (kVector) {
      return make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      return 0.f;
    }
  }
  // float32 memory (a gradient, the pieces' scratch), through the
  // read-only cache
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const T*>(p));
  }
  // bfloat16 memory, widened
  __device__ static T load(const __nv_bfloat16* p) {
    if constexpr (kVector) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    } else {
      return widen(*p);
    }
  }
  // the destination's old value (accumulate)
  __device__ static T read(const E* p) {
    if constexpr (std::is_same<E, float>::value) {
      return *reinterpret_cast<const T*>(p);
    } else if constexpr (kVector) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    } else {
      return widen(*p);
    }
  }
  // the destination's new value, rounded once to E
  __device__ static void write(E* p, const T& v) {
    if constexpr (std::is_same<E, float>::value) {
      *reinterpret_cast<T*>(p) = v;
    } else if constexpr (kVector) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(p) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      *p = __float2bfloat16_rn(v);
    }
  }
};

// acc += grad[perm[j]][col..] for j in [from, to), in that order; from and
// to are the same in every lane of the warp
template <typename E, bool kVector, int kUnroll>
__device__ __forceinline__ void add_sources(
    typename Lane<E, kVector>::T& acc, const E* __restrict__ grad,
    const int* __restrict__ perm, int from, int to, int c, int col,
    bool live, int lane) {
  using L = Lane<E, kVector>;
  using T = typename L::T;
  static_assert(32 % kUnroll == 0, "kUnroll divides a warp");
  for (int base = from; base < to; base += 32) {
    const int n = min(32, to - base);
    const int mine = lane < n ? __ldg(perm + base + lane) : 0;
    for (int k = 0; k < n; k += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = __shfl_sync(0xffffffffu, mine, k + u);
        v[u] = L::zero();
        if (live && k + u < n) {
          v[u] = L::load(grad + static_cast<long long>(src) * c + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < n) add_to(acc, v[u]);
      }
    }
  }
}

__device__ __forceinline__ int clamp_row(int r, int s) {
  return r < 0 ? 0 : (r >= s ? s - 1 : r);
}

// The piece launch: warp (tile, chunk) over the sorted sources, a tile
// being kLongRow of them. scratch is [tiles, 2, c]: slot 0 the tile's
// first row's run, slot 1 its last row's (when another row), each written
// only for a long row (more than kLongRow sources, so it cannot lie inside
// one tile). long_start[tile]: the long row that starts in the tile (at
// most one: it runs past the tile's end), else -1.
template <typename E, bool kVector>
__global__ void __launch_bounds__(kThreads) row_scatter_add_pieces_kernel(
    const E* __restrict__ grad, const int* __restrict__ idx,
    const int* __restrict__ perm, const int* __restrict__ row_ptr,
    float* __restrict__ scratch, int* __restrict__ long_start, int p, int s,
    int c, int chunks, int tiles) {
  using L = Lane<E, kVector>;
  using T = typename L::T;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps
                         + threadIdx.x / 32;
  if (warp >= static_cast<long long>(tiles) * chunks) return;
  const int lane = threadIdx.x % 32;
  const int tile = static_cast<int>(warp / chunks);
  const int chunk = static_cast<int>(warp % chunks);
  const int col = (chunk * 32 + lane) * L::kWidth;
  const bool live = col < c;
  const int lo = tile * kLongRow;
  const int hi = min(lo + kLongRow, p);
  const int first = clamp_row(__ldg(idx + __ldg(perm + lo)), s);
  const int last = clamp_row(__ldg(idx + __ldg(perm + hi - 1)), s);
  const int first_begin = __ldg(row_ptr + first);
  const int first_end = __ldg(row_ptr + first + 1);
  const int last_begin = __ldg(row_ptr + last);
  const bool first_long = first_end - first_begin > kLongRow;
  const bool last_long =
      last != first && __ldg(row_ptr + last + 1) - last_begin > kLongRow;
  float* out = scratch + static_cast<long long>(tile) * 2 * c + col;
  if (first_long) {
    T acc = L::zero();
    add_sources<E, kVector, 16>(acc, grad, perm, lo, min(first_end, hi), c,
                                col, live, lane);
    if (live) *reinterpret_cast<T*>(out) = acc;
  }
  if (last_long) {
    T acc = L::zero();
    add_sources<E, kVector, 16>(acc, grad, perm, last_begin, hi, c, col,
                                live, lane);
    if (live) *reinterpret_cast<T*>(out + c) = acc;
  }
  if (chunk == 0 && lane == 0) {
    long_start[tile] = first_long && first_begin == lo ? first
                       : last_long                     ? last
                                                       : -1;
  }
}

// The row launch. Its first long_blocks blocks are (tile, chunk) pairs:
// the block of a tile in which a long row starts sums that row's pieces
// (tiles t0..t1, in order; slot 1 of t0 when the row starts inside it, as
// that tile's last row, else slot 0), its 8 warps each a contiguous group
// of ceil(m / 8) of the m pieces from zero, then warp 0 adds the groups to
// the row's start value in order. Every other warp owns a (destination
// row, chunk) of a row of at most kLongRow sources and adds them in perm
// order. Blocks are dispatched in index order, so the long rows' sums
// overlap the short rows instead of trailing them.
template <typename E, bool kVector, bool kAccumulate>
__global__ void __launch_bounds__(kThreads) row_scatter_add_kernel(
    const E* __restrict__ grad, const int* __restrict__ perm,
    const int* __restrict__ row_ptr, const int* __restrict__ long_start,
    const float* __restrict__ scratch, E* __restrict__ dst, int s, int c,
    long long row_stride, int chunks, int long_blocks) {
  using L = Lane<E, kVector>;
  using T = typename L::T;
  const int lane = threadIdx.x % 32;
  const int wid = threadIdx.x / 32;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int tile = blockIdx.x / chunks;
    const int row = __ldg(long_start + tile);
    if (row < 0) return;  // the whole block
    const int col = (static_cast<int>(blockIdx.x % chunks) * 32 + lane)
                    * L::kWidth;
    const bool live = col < c;
    const int beg = __ldg(row_ptr + row);
    const int m = (__ldg(row_ptr + row + 1) - 1) / kLongRow - tile + 1;
    const bool mid = beg % kLongRow != 0;
    const int per = (m + kWarps - 1) / kWarps;
    const int q_end = min((wid + 1) * per, m);
    T acc = L::zero();
    for (int q = wid * per; q < q_end; q += 8) {
      T v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = L::zero();
        if (live && q + u < q_end) {
          const int slot = (q + u == 0 && mid) ? 1 : 0;
          v[u] = L::load(scratch + (static_cast<long long>(tile + q + u) * 2
                                    + slot) * c + col);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (q + u < q_end) add_to(acc, v[u]);
      }
    }
    __shared__ T groups[kWarps][32];
    groups[wid][lane] = acc;
    __syncthreads();
    if (wid == 0 && live) {
      E* out = dst + static_cast<long long>(row) * row_stride + col;
      T total = kAccumulate ? L::read(out) : L::zero();
      for (int w = 0; w < kWarps && w * per < m; ++w) {
        add_to(total, groups[w][lane]);
      }
      L::write(out, total);
    }
    return;
  }
  const long long warp =
      static_cast<long long>(blockIdx.x - long_blocks) * kWarps + wid;
  if (warp >= static_cast<long long>(s) * chunks) return;
  const int row = static_cast<int>(warp / chunks);
  const int col = (static_cast<int>(warp % chunks) * 32 + lane) * L::kWidth;
  const bool live = col < c;
  const int beg = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  if (end - beg > kLongRow) return;  // its tile's block writes it
  E* out = dst + static_cast<long long>(row) * row_stride + col;
  T acc = L::zero();
  if (kAccumulate && live) acc = L::read(out);
  add_sources<E, kVector, 8>(acc, grad, perm, beg, end, c, col, live, lane);
  if (live) L::write(out, acc);
}

template <typename E, bool kVector>
cudaError_t launch(const E* grad, const int* idx, const int* perm,
                   const int* row_ptr, float* scratch, int* long_start,
                   E* dst, int p, int s, int c, long long row_stride,
                   bool accumulate, cudaStream_t stream) {
  const int per_warp = 32 * Lane<E, kVector>::kWidth;
  const int chunks = (c + per_warp - 1) / per_warp;
  int long_blocks = 0;
  if (p > kLongRow) {
    const int tiles = (p + kLongRow - 1) / kLongRow;
    const long long warps = static_cast<long long>(tiles) * chunks;
    row_scatter_add_pieces_kernel<E, kVector>
        <<<static_cast<unsigned int>((warps + kWarps - 1) / kWarps),
           kThreads, 0, stream>>>(grad, idx, perm, row_ptr, scratch,
                                  long_start, p, s, c, chunks, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    long_blocks = tiles * chunks;
  }
  const long long warps = static_cast<long long>(s) * chunks;
  const unsigned int blocks = static_cast<unsigned int>(
      long_blocks + (warps + kWarps - 1) / kWarps);
  if (accumulate) {
    row_scatter_add_kernel<E, kVector, true><<<blocks, kThreads, 0, stream>>>(
        grad, perm, row_ptr, long_start, scratch, dst, s, c, row_stride,
        chunks, long_blocks);
  } else {
    row_scatter_add_kernel<E, kVector, false>
        <<<blocks, kThreads, 0, stream>>>(
        grad, perm, row_ptr, long_start, scratch, dst, s, c, row_stride,
        chunks, long_blocks);
  }
  return cudaGetLastError();
}

template <typename E>
int dispatch(const void* grad, const int* idx, const int* perm,
             const int* row_ptr, void* scratch, int* long_start, void* dst,
             int p, int s, int c, long long row_stride, int accumulate,
             cudaStream_t stream) {
  if (s <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  // 4 columns a lane: 16 bytes of float32, 8 of bfloat16
  const std::uintptr_t align = 4 * sizeof(E);
  const bool vector =
      c % 4 == 0 && row_stride % 4 == 0
      && reinterpret_cast<std::uintptr_t>(grad) % align == 0
      && reinterpret_cast<std::uintptr_t>(scratch) % 16 == 0
      && reinterpret_cast<std::uintptr_t>(dst) % align == 0;
  const E* g = static_cast<const E*>(grad);
  float* w = static_cast<float*>(scratch);
  E* d = static_cast<E*>(dst);
  const cudaError_t err =
      vector ? launch<E, true>(g, idx, perm, row_ptr, w, long_start, d, p, s,
                               c, row_stride, accumulate != 0, stream)
             : launch<E, false>(g, idx, perm, row_ptr, w, long_start, d, p,
                                s, c, row_stride, accumulate != 0, stream);
  return static_cast<int>(err);
}

}  // namespace

// grad [p, c] contiguous, float32 (row_scatter_add_f32) or bfloat16
// (row_scatter_add_bf16); idx [p] int32, the indices themselves; perm [p]
// and row_ptr [s + 1] int32, their CSR; scratch (2 * c floats, float32 in
// both) and long_start (one int) a tile of kLongRow (64) sources, unused
// when p <= 64; dst: s rows of c elements of grad's type at row_stride
// elements apart, added into (accumulate != 0) or overwritten. Two
// launches when p > 64, else one. Returns a cudaError_t.
extern "C" int row_scatter_add_f32(const void* grad, const int* idx,
                                   const int* perm, const int* row_ptr,
                                   void* scratch, int* long_start, void* dst,
                                   int p, int s, int c, long long row_stride,
                                   int accumulate, cudaStream_t stream) {
  return dispatch<float>(grad, idx, perm, row_ptr, scratch, long_start, dst,
                         p, s, c, row_stride, accumulate, stream);
}

extern "C" int row_scatter_add_bf16(const void* grad, const int* idx,
                                    const int* perm, const int* row_ptr,
                                    void* scratch, int* long_start,
                                    void* dst, int p, int s, int c,
                                    long long row_stride, int accumulate,
                                    cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(grad, idx, perm, row_ptr, scratch,
                                 long_start, dst, p, s, c, row_stride,
                                 accumulate, stream);
}
