// ROIAlign forward (original non-aligned variant) for Hopper (sm_90a), one
// level or up to four FPN levels in one launch.
//
// Replaces da_detect_tpu/ops/roi_align_pallas.py::_pool_fwd_impl (body
// _fwd_kernel, entry roi_align_pallas), and with it the einsum formulation
// the JAX package runs in its place (ops/roi_align.py::roi_align_image) and
// the every-level-then-mask form of its FPN pooler
// (models/poolers.py::pool_rois). Same function: features [B, H, W, C]
// (channels-last) on each level, rois [B, R, 4] xyxy in image coordinates
// and, with more than one level, each ROI's level [B, R] -> out
// [B, R, P, P, C], each ROI pooled from its own level (a level index outside
// the levels gives zeros, as the mask sum does).
//
// Semantics: roi_align_common.cuh, shared with the backward kernel
// (roi_align_bwd.cu), so the two sample the same points.
//
// What bounds it on this card. The bytes: the output (C4 eval, 1000 ROIs at
// P = 14, C = 1024: 0.80 GB) is written once and is nearly all the traffic
// to device memory; the maps (C4: 11.8 MB; FPN P2-P5: 62 MB) stay in the
// 50 MB L2 or nearly. A gather that reads each sample's four corners from L2
// for every output vector moves 4 * gh * gw times the output bytes through
// L2, and one thread per output vector that recomputes the ROI's grid (IEEE
// divides under -fmad=false) spends more on geometry than on the sum.
//
// Design. One 256-thread block per (ROI, image, run of `slices` 32-channel
// slices); 8 threads span a slice as float4s, so the map is read and the
// output written in coalesced 16-byte words, the output with streaming
// stores. The main paths' ROIs are small (~33 footprint pixels at C4), so
// a slice's own work is short: the block's setup (1, 2) is shared by its
// slices, and the wrapper sizes the run so that a launch still has a few
// waves of blocks.
//   1. The block reads its ROI's level and computes the ROI's samples on
//      each axis once into shared memory (two corners and their weights
//      each), then each bin's span: the first and last map row (column) its
//      in-bounds samples' corners reach.
//   2. The bins are walked in steps: a band of bin rows times a group of
//      bin columns whose footprint (the rows times the columns their spans
//      cover) fits a tile of `tile` pixels, grown greedily. A small ROI's
//      whole footprint is one step; a larger one is cut into bands of bin
//      rows, and into column groups where one bin row is wider than the
//      tile.
//   3. Each step's footprint is staged in shared memory by cp.async, in two
//      buffers: the next step's pixels (or the next slice's first step's)
//      are in flight while this step is computed. A footprint pixel is
//      read from L2 once per ROI and slice, again only where two steps
//      share a row or column.
//   4. One thread a (bin, 4 channels) sums its samples' corners from shared
//      memory in the order of the per-thread gather this kernel replaced
//      (rows, then columns, then the four corners), so the outputs are
//      bitwise those of that kernel. A corner outside the staged tile (a
//      single bin taller or wider than the tile) is read from L2.
// Shared memory: the layout in the kernel; the wrapper
// (ops/roi_align_cuda.py::fwd_tiling) sizes the tile to 48 KB a block, and
// the launcher sets the kernel's limit to what it asks.
//
// Numerics: coordinates are computed in the plain version's operation order
// with -fmad=false, so the in-bounds tests agree exactly; the sums run in
// another order than the plain version's matrix products, so outputs agree
// to ~1e-6, not bitwise.
//
// Element types. float32 maps, or bfloat16 maps (the JAX package's compute
// dtype) with a bfloat16 output: a 16-byte word is 4 channels in float32 and
// 8 in bfloat16, so a 32-channel slice is 8 or 4 lanes of a thread each
// (Elem<T> below) and a staged pixel of a slice 128 or 64 bytes. The
// interpolation weights and the sums stay float32 in both; each bfloat16
// output is rounded once (round to nearest even) from the float32 sum.
// The TPU kernel (_fwd_kernel) and the JAX package's einsum also round the
// weights and the first contraction to bfloat16; this kernel does not, so
// in bfloat16 it is the more exact of the two, and agrees with the plain
// version (ops/roi_align.py, which rounds as the JAX package does) to a few
// bfloat16 ulps of the output's magnitude.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "roi_align_common.cuh"

namespace {

using roi_align::Corners;
using roi_align::cp_async16;

constexpr int kChannels = 32;               // a block's channel slice
constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;
constexpr int kEmpty = 1 << 30;             // span.x of a bin with no sample

// a thread's 16-byte word of channels: float4 (4 float32) or uint4 (8
// bfloat16), widened to float32 to be summed and narrowed to be stored
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Word = float4;
  static constexpr int kPer = 4;
  __device__ static void widen(const Word& w, float* f) {
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  }
  __device__ static Word narrow(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Word = uint4;
  static constexpr int kPer = 8;
  __device__ static void widen(const Word& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static Word narrow(const float* f) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <typename T>
struct Level {
  const T* features;
  int h, w;
  float scale;
};

template <typename T>
struct Levels {
  Level<T> level[kMaxLevels];
  int count;
};

// bins [ph0, ph1] x [pw0, pw1]; the staged map pixels [y0, y0 + rows) x
// [x0, x0 + cols), row-major with pitch cols
struct Step {
  int ph0, ph1, pw0, pw1, y0, rows, x0, cols;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// acc[i] += w * word[i], in channel order (float32: the x, y, z, w order
// of the float4 kernel this one generalises)
template <typename T>
__device__ __forceinline__ void fma_word(float* acc, float w,
                                        const typename Elem<T>::Word& word) {
  float v[Elem<T>::kPer];
  Elem<T>::widen(word, v);
#pragma unroll
  for (int i = 0; i < Elem<T>::kPer; ++i) acc[i] += w * v[i];
}

// the bins first.. grown while their spans' union stays within `limit`
// map rows (columns); bins with no sample in bounds join freely. Returns
// the last bin; *lo, *hi the union (lo > hi when empty).
__device__ __forceinline__ int grow(const int2* spans, int first, int p,
                                    int limit, int* lo, int* hi) {
  int a = kEmpty, z = -1, last = first;
  for (int i = first; i < p; ++i) {
    const int2 s = spans[i];
    if (s.x <= s.y) {
      const int na = min(a, s.x), nz = max(z, s.y);
      if (a <= z && nz - na + 1 > limit) break;
      a = na;
      z = nz;
    }
    last = i;
  }
  *lo = a;
  *hi = z;
  return last;
}

// the step whose band starts at bin row ph0 in the column group starting at
// bin column pw0. col_limit: a group's columns at most; tile: pixels.
__device__ __forceinline__ Step make_step(const int2* row_span,
                                          const int2* col_span, int p,
                                          int ph0, int pw0, int col_limit,
                                          int tile) {
  Step s;
  int clo, chi, rlo, rhi;
  s.ph0 = ph0;
  s.pw0 = pw0;
  s.pw1 = grow(col_span, pw0, p, col_limit, &clo, &chi);
  s.cols = clo <= chi ? min(chi - clo + 1, tile) : 0;
  s.x0 = clo;
  s.ph1 = grow(row_span, ph0, p, tile / max(s.cols, 1), &rlo, &rhi);
  s.rows = (rlo <= rhi && s.cols) ? min(rhi - rlo + 1, tile / s.cols) : 0;
  s.y0 = rlo;
  return s;
}

// stage lane v of the step's pixels (word cv of C); each thread commits
// one group
template <typename T>
__device__ __forceinline__ void load_step(typename Elem<T>::Word* buf,
                                          const Step& s, const T* fmap, int w,
                                          int c, int cv, int v, bool live,
                                          int tid) {
  constexpr int kVec = kChannels / Elem<T>::kPer;
  constexpr int kItems = kThreads / kVec;
  if (live) {
    for (int e = tid / kVec; e < s.rows * s.cols; e += kItems) {
      const int y = s.y0 + e / s.cols;
      const int x = s.x0 + e % s.cols;
      cp_async16(buf + e * kVec + v, fmap
                 + (static_cast<size_t>(y) * w + x) * c + cv * Elem<T>::kPer);
    }
  }
  cp_async_commit();
}

// map pixel (y, x), lane v: from the staged tile, else from L2
template <typename T>
__device__ __forceinline__ typename Elem<T>::Word fetch(
    const typename Elem<T>::Word* buf, const Step& s,
    const typename Elem<T>::Word* fmapw, int w, int cw, int y, int x, int v) {
  constexpr int kVec = kChannels / Elem<T>::kPer;
  const int dy = y - s.y0, dx = x - s.x0;
  if (static_cast<unsigned>(dy) < static_cast<unsigned>(s.rows)
      && static_cast<unsigned>(dx) < static_cast<unsigned>(s.cols)) {
    return buf[(dy * s.cols + dx) * kVec + v];
  }
  return __ldg(fmapw + (static_cast<size_t>(y) * w + x) * cw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roi_align_fwd_kernel(
    Levels<T> levels, const long long* __restrict__ roi_levels,
    const float* __restrict__ rois, T* __restrict__ out, int c, int r, int p,
    int sampling_ratio, int max_samples, int samples, int tile, int slices) {
  using E = Elem<T>;
  using Word = typename E::Word;
  constexpr int kVec = kChannels / E::kPer;  // 16-byte lanes of a slice
  constexpr int kItems = kThreads / kVec;    // (pixel or bin) items a pass
  // layout: 2 buffers [tile][kVec] words | y samples [p * samples] |
  // x samples [p * samples] | row spans [p] int2 | column spans [p] int2
  extern __shared__ __align__(16) uint4 smem_words[];
  Word* bufs = reinterpret_cast<Word*>(smem_words);
  Corners* ys = reinterpret_cast<Corners*>(bufs + 2 * tile * kVec);
  Corners* xs = ys + p * samples;
  int2* row_span = reinterpret_cast<int2*>(xs + p * samples);
  int2* col_span = row_span + p;

  const int tid = threadIdx.x;
  const int v = tid % kVec;
  const int cw = c / E::kPer;  // 16-byte words a pixel
  // this block's channel slices [first_slice, end_slice)
  const int first_slice = blockIdx.x * slices;
  const int end_slice = min(first_slice + slices, (cw + kVec - 1) / kVec);
  const size_t n = static_cast<size_t>(blockIdx.z) * r + blockIdx.y;
  Word* outw = reinterpret_cast<Word*>(out) + n * p * p * cw + v;

  const int lvl = roi_levels ? static_cast<int>(roi_levels[n]) : 0;
  if (lvl < 0 || lvl >= levels.count) {  // no level: zeros, as the mask sum
    const float zeros[E::kPer] = {};
    for (int sl = first_slice; sl < end_slice; ++sl) {
      if (sl * kVec + v >= cw) continue;
      for (int e = tid / kVec; e < p * p; e += kItems) {
        __stcs(outw + static_cast<size_t>(e) * cw + sl * kVec,
               E::narrow(zeros));
      }
    }
    return;
  }
  Level<T> lv = levels.level[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (lvl == i) lv = levels.level[i];
  }
  const int h = lv.h, w = lv.w;
  const T* fmap = lv.features + blockIdx.z * static_cast<size_t>(h) * w * c;

  // 1. samples on each axis, then each bin's span
  const roi_align::RoiGrid g = roi_align::roi_grid(
      rois + n * 4, lv.scale, p, sampling_ratio, max_samples);
  const int nx = p * g.gw;
  for (int s = tid; s < nx + p * g.gh; s += kThreads) {
    const bool on_x = s < nx;
    const int t = on_x ? s : s - nx;
    const int grid = on_x ? g.gw : g.gh;
    const float coord =
        on_x ? roi_align::sample_coord(g.start_w, g.bin_w, g.grid_w, t / grid,
                                       t % grid)
             : roi_align::sample_coord(g.start_h, g.bin_h, g.grid_h, t / grid,
                                       t % grid);
    Corners k{-1, -1, 0.0f, 0.0f};  // left so when out of bounds
    roi_align::axis_weights(coord, on_x ? w : h, &k.lo, &k.hi, &k.w_lo,
                            &k.w_hi);
    (on_x ? xs : ys)[t] = k;
  }
  __syncthreads();
  for (int e = tid; e < 2 * p; e += kThreads) {
    const bool on_x = e < p;
    const int bin = on_x ? e : e - p;
    const int grid = on_x ? g.gw : g.gh;
    const Corners* tab = (on_x ? xs : ys) + bin * grid;
    int2 span = make_int2(kEmpty, -1);
    for (int i = 0; i < grid; ++i) {
      if (tab[i].lo >= 0) {
        span.x = min(span.x, tab[i].lo);
        span.y = max(span.y, tab[i].hi);
      }
    }
    (on_x ? col_span : row_span)[bin] = span;
  }
  __syncthreads();

  // 2. a column group's width: as many columns as leave room for the
  // tallest bin row; all of them when the footprint fits
  int tallest = 1;
  for (int i = 0; i < p; ++i) {
    const int2 s = row_span[i];
    if (s.x <= s.y) tallest = max(tallest, s.y - s.x + 1);
  }
  const int col_limit = max(tile / tallest, 1);

  // 3.-4. the steps of each channel slice in turn, the next one's pixels
  // in flight while one is summed
  const float inv = 1.0f / (g.grid_h * g.grid_w);
  const Step first = make_step(row_span, col_span, p, 0, 0, col_limit, tile);
  Step cur = first;
  int slice = first_slice;
  load_step<T>(bufs, cur, fmap, w, c, slice * kVec + v, v,
               slice * kVec + v < cw, tid);
  for (int stage = 0;; stage ^= 1) {
    const bool slice_done = cur.ph1 + 1 >= p && cur.pw1 + 1 >= p;
    const bool last = slice_done && slice + 1 >= end_slice;
    Step next;
    int next_slice = slice;
    if (!last) {
      if (slice_done) {
        next = first;
        ++next_slice;
      } else {
        next = cur.ph1 + 1 < p
                   ? make_step(row_span, col_span, p, cur.ph1 + 1, cur.pw0,
                               col_limit, tile)
                   : make_step(row_span, col_span, p, 0, cur.pw1 + 1,
                               col_limit, tile);
      }
      const int next_cv = next_slice * kVec + v;
      load_step<T>(bufs + (stage ^ 1) * tile * kVec, next, fmap, w, c,
                   next_cv, v, next_cv < cw, tid);
      cp_async_wait<1>();  // this thread's copies of the current step
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // everyone's copies of the current step

    const int cv = slice * kVec + v;  // this thread's word of C
    const bool live = cv < cw;
    const Word* fmapw = reinterpret_cast<const Word*>(fmap) + cv;
    Word* dst = outw + slice * kVec;
    const Word* buf = bufs + stage * tile * kVec;
    const int ng = cur.pw1 - cur.pw0 + 1;
    const int bins = (cur.ph1 - cur.ph0 + 1) * ng;
    for (int e = tid / kVec; e < bins; e += kItems) {
      if (!live) continue;
      const int ph = cur.ph0 + e / ng;
      const int pw = cur.pw0 + e % ng;
      float acc[E::kPer] = {};
      for (int iy = 0; iy < g.gh; ++iy) {
        const Corners ky = ys[ph * g.gh + iy];
        if (ky.lo < 0) continue;
        for (int ix = 0; ix < g.gw; ++ix) {
          const Corners kx = xs[pw * g.gw + ix];
          if (kx.lo < 0) continue;
          fma_word<T>(acc, ky.w_lo * kx.w_lo,
                      fetch<T>(buf, cur, fmapw, w, cw, ky.lo, kx.lo, v));
          fma_word<T>(acc, ky.w_lo * kx.w_hi,
                      fetch<T>(buf, cur, fmapw, w, cw, ky.lo, kx.hi, v));
          fma_word<T>(acc, ky.w_hi * kx.w_lo,
                      fetch<T>(buf, cur, fmapw, w, cw, ky.hi, kx.lo, v));
          fma_word<T>(acc, ky.w_hi * kx.w_hi,
                      fetch<T>(buf, cur, fmapw, w, cw, ky.hi, kx.hi, v));
        }
      }
#pragma unroll
      for (int i = 0; i < E::kPer; ++i) acc[i] *= inv;
      __stcs(dst + static_cast<size_t>(ph * p + pw) * cw, E::narrow(acc));
    }
    if (last) break;
    __syncthreads();  // the next step's copies go into this buffer
    cur = next;
    slice = next_slice;
  }
}

// bytes of the dynamic shared memory layout in the kernel
long long smem_bytes(int p, int samples, int tile, int elem_bytes) {
  return 2LL * tile * kChannels * elem_bytes
         + 2LL * p * samples * sizeof(Corners) + 2LL * p * sizeof(int2);
}

template <typename T>
int launch(const void* const* features, const int* heights, const int* widths,
           const float* scales, int count, const long long* roi_levels,
           const float* rois, void* out, int batch, int c, int r, int p,
           int sampling_ratio, int max_samples, int tile, int smem,
           int slices, cudaStream_t stream) {
  const int samples = sampling_ratio > 0 ? sampling_ratio : max_samples;
  if (count < 1 || count > kMaxLevels || (count > 1 && !roi_levels)
      || tile < 1 || samples < 1 || slices < 1 || r > 65535
      || batch > 65535 || c % Elem<T>::kPer
      || smem < smem_bytes(p, samples, tile, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels<T> levels{};
  levels.count = count;
  for (int i = 0; i < count; ++i) {
    levels.level[i] = Level<T>{static_cast<const T*>(features[i]),
                               heights[i], widths[i], scales[i]};
  }
  const cudaError_t err = cudaFuncSetAttribute(
      roi_align_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVec = kChannels / Elem<T>::kPer;
  const int n_slices = (c / Elem<T>::kPer + kVec - 1) / kVec;
  const dim3 grid((n_slices + slices - 1) / slices, r, batch);
  roi_align_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      levels, roi_levels, rois, static_cast<T*>(out), c, r, p,
      sampling_ratio, max_samples, samples, tile, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// count levels (1..4): features[l] [batch, heights[l], widths[l], c] f32
// (roi_align_fwd_f32; c % 4 == 0) or bf16 (roi_align_fwd_bf16; c % 8 == 0),
// 16-byte aligned, pooled at scales[l]; roi_levels [batch, r] int64 on the
// device (null with one level: every ROI on level 0); rois [batch, r, 4]
// f32 -> out [batch, r, p, p, c] in the features' type. samples =
// sampling_ratio if > 0 else max_samples; tile (pixels) and smem from the
// wrapper's sizing; slices: the 32-channel slices a block pools. Returns a
// cudaError_t (cudaErrorInvalidValue if an argument is out of range or smem
// does not hold the layout).
extern "C" int roi_align_fwd_f32(const void* const* features,
                                 const int* heights, const int* widths,
                                 const float* scales, int count,
                                 const long long* roi_levels,
                                 const float* rois, void* out, int batch,
                                 int c, int r, int p, int sampling_ratio,
                                 int max_samples, int tile, int smem,
                                 int slices, cudaStream_t stream) {
  return launch<float>(features, heights, widths, scales, count, roi_levels,
                       rois, out, batch, c, r, p, sampling_ratio, max_samples,
                       tile, smem, slices, stream);
}

extern "C" int roi_align_fwd_bf16(const void* const* features,
                                  const int* heights, const int* widths,
                                  const float* scales, int count,
                                  const long long* roi_levels,
                                  const float* rois, void* out, int batch,
                                  int c, int r, int p, int sampling_ratio,
                                  int max_samples, int tile, int smem,
                                  int slices, cudaStream_t stream) {
  return launch<__nv_bfloat16>(features, heights, widths, scales, count,
                               roi_levels, rois, out, batch, c, r, p,
                               sampling_ratio, max_samples, tile, smem,
                               slices, stream);
}
