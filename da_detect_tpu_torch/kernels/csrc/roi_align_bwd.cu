// ROIAlign backward (d features) for Hopper (sm_90a).
//
// Replaces da_detect_tpu/ops/roi_align_pallas.py::_pool_bwd (body
// _bwd_kernel), the backward of the custom VJP around _pool_fwd_impl, and
// with it the einsum adjoint XLA derives for ops/roi_align.py::roi_align.
// Same function: the upstream gradient g [B, R, P, P, C] -> dF [B, H, W, C]
// in float32 (channels-last). The ROIs take no gradient: the proposals they
// come from are stop-gradient, and _pool_bwd returns zeros for them.
//
// It is the adjoint of roi_align_fwd.cu: the same samples (geometry in
// roi_align_common.cuh: the same [-1, size] out-of-bounds rule, edge clamp
// and 1 / (grid_h * grid_w) mean), each scattering w * g into the corners it
// interpolated from. Bilinear sampling is separable, so with
// out = inv * Ay F Ax^T per ROI and channel (Ay [P, H], Ax [P, W] the
// per-bin sums of the samples' corner weights on each axis),
//
//     dF[y, x, c] = sum_roi inv * sum_ph Ay[ph, y] * sum_pw Ax[pw, x]
//                   * g[roi, ph, pw, c]
//
// as the TPU kernel computes it (two matrix products a ROI block).
//
// Deterministic: every dF value is owned by one thread, which sums the ROIs
// in index order, each ROI's terms in a fixed order, and stores the sum
// once. No atomics, so dF is the same bit for bit from run to run (training
// from scratch amplifies a last-bit difference in one step into another
// model after a few hundred), and the caller need not zero it.
//
// What bounds it on this card. The bytes: g (train step, 256 ROIs at P = 14,
// C = 1024: 205.5 MB) is read about once, dF (11.8 MB) written once.
//
// Design. One 256-thread block per (32-channel slice, 16 x 16 pixel tile of
// the map, image); 8 threads span the slice as float4s, so g is read and dF
// written in coalesced 16-byte words, and each thread holds 8 pixels' float4
// sums in registers for the whole launch.
//   0. The block tests the ROIs' footprints (the first and last row and
//      column their samples' corners reach) against its tile, a chunk of
//      kChunk ROIs at a time, into shared memory.
//   1. For each ROI that reaches the tile, in index order: its samples on
//      each axis (two corners and their weights each); Ay over the tile's
//      rows and Ax over its columns, dense [P, 16], and each row's and
//      column's range of bins with a non-zero weight.
//   2. The ROI's gradient for the bins that reach the tile (a P^2 x 32
//      slice at most, 25 KB at P = 14) staged in shared memory with
//      cp.async, every 16-byte copy in flight at once: a bin is read by the
//      one tile its corners fall in, rarely by two or four.
//   3. U[ph, x, c] = sum_pw Ax[pw, x] g[ph, pw, c] into shared memory, one
//      thread a (ph, x, 4 channels); then each thread adds
//      inv * sum_ph Ay[ph, y] U[ph, x, c] to its pixels' sums.
// After the last ROI each thread stores its sums: every pixel of the tile,
// zero where no sample reaches it. Shared memory: the layout below, sized
// by the wrapper (ops/roi_align_cuda.py::bwd_tiling); the launcher sets the
// kernel's limit to it (needed past 48 KB).
//
// The gradient may come in any strides with the channels contiguous
// (strides in elements, multiples of 4, 16-byte aligned base): autograd's
// channels-last gradient is read in place.
//
// Numerics: within a ROI the sums run in a fixed order (over pw, then ph),
// not the forward's sample order, and across ROIs in index order. dF agrees
// with the plain version to float32 rounding (~1e-6 relative), not bitwise,
// and is bitwise reproducible.
//
// Element types. The gradient g is float32 (roi_align_bwd_f32) or bfloat16
// (roi_align_bwd_bf16, the JAX package's compute dtype): a bfloat16 g is
// staged as it is (a 16-byte copy is 8 channels, so the slice's P^2 x 32
// values take half the shared memory) and widened to float32 where it is
// read. U, the weights and the sums are float32 in both, and so is dF: the
// wrapper casts it to bfloat16 once after the launch, as the TPU kernel's
// caller casts its float32 accumulator (roi_align_pallas.py:168).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "roi_align_common.cuh"

namespace {

using roi_align::Corners;
using roi_align::cp_async16;
using roi_align::cp_async_wait_all;

constexpr int kChannels = 32;               // a block's channel slice
constexpr int kVec = kChannels / 4;         // float4 lanes across the slice
constexpr int kThreads = 256;
constexpr int kItems = kThreads / kVec;     // (pixel or (bin, column)) a pass
constexpr int kTile = 16;                   // a block's tile: kTile^2 pixels
constexpr int kPix = kTile * kTile / kItems;  // pixels a thread sums
constexpr int kChunk = 1024;                // ROIs tested against the tile
                                            // at a time

// weight of axis position `pos` in bin `bin`: its samples' corner weights
__device__ __forceinline__ float bin_weight(const Corners* samples, int grid,
                                            int bin, int pos) {
  float sum = 0.0f;
  for (int i = 0; i < grid; ++i) {
    const Corners s = samples[bin * grid + i];
    if (s.lo == pos) sum += s.w_lo;
    if (s.hi == pos) sum += s.w_hi;
  }
  return sum;
}

// whether any sample of `p` bins of `grid` samples along an axis of `size`
// has a corner in [first, last]; the samples' coordinates, and so their
// corners, do not decrease along the axis
__device__ __forceinline__ bool axis_reaches(float start, float bin_size,
                                             float grid_f, int grid, int p,
                                             int size, int first, int last) {
  for (int t = 0; t < p * grid; ++t) {
    int lo, hi;
    float w_lo, w_hi;
    if (roi_align::axis_weights(
            roi_align::sample_coord(start, bin_size, grid_f, t / grid,
                                    t % grid),
            size, &lo, &hi, &w_lo, &w_hi)) {
      if (lo > last) return false;
      if (hi >= first) return true;
    }
  }
  return false;
}

__device__ __forceinline__ void add4(float4* acc, float w, const float4& v) {
  acc->x += w * v.x;
  acc->y += w * v.y;
  acc->z += w * v.z;
  acc->w += w * v.w;
}

// 4 channels of the staged gradient (element offset i, a multiple of 4) as
// float32
__device__ __forceinline__ float4 staged4(const float* gs, int i) {
  return *reinterpret_cast<const float4*>(gs + i);
}

__device__ __forceinline__ float4 staged4(const __nv_bfloat16* gs, int i) {
  const uint2 u = *reinterpret_cast<const uint2*>(gs + i);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roi_align_bwd_kernel(
    const T* __restrict__ grad, long long stride_b, long long stride_r,
    long long stride_ph, long long stride_pw, const float* __restrict__ rois,
    float* __restrict__ dfeat, int h, int w, int c, int r, int p,
    float spatial_scale, int sampling_ratio, int max_samples, int samples,
    int tiles_x) {
  // layout: g [p * p][kChannels] T | U [p][kTile][kVec] float4 |
  // x samples [p * samples] | y samples [p * samples] | Ax [p][kTile] |
  // Ay [p][kTile] | column bins [kTile] int2 | row bins [kTile] int2 |
  // hits [kChunk] bytes
  extern __shared__ __align__(16) float4 smem[];
  T* gs = reinterpret_cast<T*>(smem);
  float4* u = reinterpret_cast<float4*>(gs + p * p * kChannels);
  Corners* xs = reinterpret_cast<Corners*>(u + p * kTile * kVec);
  Corners* ys = xs + p * samples;
  float* ax = reinterpret_cast<float*>(ys + p * samples);
  float* ay = ax + p * kTile;
  int2* col_bins = reinterpret_cast<int2*>(ay + p * kTile);
  int2* row_bins = col_bins + kTile;
  unsigned char* hits = reinterpret_cast<unsigned char*>(row_bins + kTile);

  const int b = blockIdx.z;
  const int y0 = (blockIdx.y / tiles_x) * kTile;
  const int x0 = (blockIdx.y % tiles_x) * kTile;
  const int rows = min(kTile, h - y0);
  const int cols = min(kTile, w - x0);
  const int tid = threadIdx.x;
  const int v = tid % kVec;
  const int cv = blockIdx.x * kVec + v;  // this thread's float4 of C
  const bool live = cv < c / 4;
  const int c0 = blockIdx.x * kChannels;
  const float* box0 = rois + static_cast<size_t>(b) * r * 4;

  float4 acc[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int chunk = 0; chunk < r; chunk += kChunk) {
    const int n = min(kChunk, r - chunk);
    // 0. which ROIs of the chunk reach the tile
    for (int i = tid; i < n; i += kThreads) {
      const roi_align::RoiGrid g = roi_align::roi_grid(
          box0 + (chunk + i) * 4, spatial_scale, p, sampling_ratio,
          max_samples);
      hits[i] = axis_reaches(g.start_h, g.bin_h, g.grid_h, g.gh, p, h, y0,
                             y0 + rows - 1)
                && axis_reaches(g.start_w, g.bin_w, g.grid_w, g.gw, p, w,
                                x0, x0 + cols - 1);
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      if (!hits[i]) continue;  // the same for every thread
      const int roi = chunk + i;
      const roi_align::RoiGrid g = roi_align::roi_grid(
          box0 + roi * 4, spatial_scale, p, sampling_ratio, max_samples);

      // 1. samples, Ay and Ax over the tile, each row's and column's bins
      const int nx = p * g.gw;
      for (int s = tid; s < nx + p * g.gh; s += kThreads) {
        const bool on_x = s < nx;
        const int t = on_x ? s : s - nx;
        const int grid = on_x ? g.gw : g.gh;
        const float coord =
            on_x ? roi_align::sample_coord(g.start_w, g.bin_w, g.grid_w,
                                           t / grid, t % grid)
                 : roi_align::sample_coord(g.start_h, g.bin_h, g.grid_h,
                                           t / grid, t % grid);
        Corners k{-1, -1, 0.0f, 0.0f};
        roi_align::axis_weights(coord, on_x ? w : h, &k.lo, &k.hi, &k.w_lo,
                                &k.w_hi);
        (on_x ? xs : ys)[t] = k;
      }
      __syncthreads();
      for (int e = tid; e < p * (rows + cols); e += kThreads) {
        if (e < p * rows) {
          ay[e] = bin_weight(ys, g.gh, e / rows, y0 + e % rows);
        } else {
          const int f = e - p * rows;
          ax[f] = bin_weight(xs, g.gw, f / cols, x0 + f % cols);
        }
      }
      __syncthreads();
      for (int e = tid; e < rows + cols; e += kThreads) {
        const bool is_row = e < rows;
        const int pos = is_row ? e : e - rows;
        const int len = is_row ? rows : cols;
        const float* wt = is_row ? ay : ax;
        int2 bins = make_int2(p, -1);
        for (int k = 0; k < p; ++k) {
          if (wt[k * len + pos] != 0.0f) {
            bins.x = min(bins.x, k);
            bins.y = k;
          }
        }
        (is_row ? row_bins : col_bins)[pos] = bins;
      }
      __syncthreads();
      int ph0 = p, ph1 = -1, pw0 = p, pw1 = -1;
      for (int y = 0; y < rows; ++y) {
        ph0 = min(ph0, row_bins[y].x);
        ph1 = max(ph1, row_bins[y].y);
      }
      for (int x = 0; x < cols; ++x) {
        pw0 = min(pw0, col_bins[x].x);
        pw1 = max(pw1, col_bins[x].y);
      }
      if (ph0 > ph1 || pw0 > pw1) continue;  // the same for every thread
      const int nph = ph1 - ph0 + 1;
      const int npw = pw1 - pw0 + 1;

      // 2. stage g[ph0..ph1, pw0..pw1] of the slice, 16-byte copies of
      // `per` channels
      {
        constexpr int per = 16 / sizeof(T);
        constexpr int lanes = kChannels / per;
        const T* src = grad + b * stride_b + roi * stride_r + c0;
        for (int j = tid; j < nph * npw * lanes; j += kThreads) {
          const int e = j / lanes, lane = j % lanes;
          const int ph = ph0 + e / npw, pw = pw0 + e % npw;
          if (c0 + lane * per < c) {
            cp_async16(gs + (ph * p + pw) * kChannels + lane * per,
                       src + ph * stride_ph + pw * stride_pw + lane * per);
          }
        }
      }
      cp_async_wait_all();  // this thread's copies; the barrier: everyone's
      __syncthreads();

      // 3. U[ph, x] = sum_pw Ax[pw, x] g[ph, pw], then the pixels' sums
      for (int e = tid / kVec; e < nph * cols; e += kItems) {
        const int ph = ph0 + e / cols;
        const int x = e % cols;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (live) {
          const int2 bins = col_bins[x];
          for (int pw = bins.x; pw <= bins.y; ++pw) {
            add4(&a, ax[pw * cols + x],
                 staged4(gs, (ph * p + pw) * kChannels + v * 4));
          }
        }
        u[e * kVec + v] = a;
      }
      __syncthreads();
      const float inv = 1.0f / (g.grid_h * g.grid_w);
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int pix = tid / kVec + k * kItems;
        const int y = pix / kTile;
        const int x = pix % kTile;
        if (!live || y >= rows || x >= cols) continue;
        const int2 bins = row_bins[y];
        if (bins.x > bins.y || col_bins[x].x > col_bins[x].y) continue;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int ph = bins.x; ph <= bins.y; ++ph) {
          add4(&a, ay[ph * rows + y], u[((ph - ph0) * cols + x) * kVec + v]);
        }
        acc[k].x += inv * a.x;
        acc[k].y += inv * a.y;
        acc[k].z += inv * a.z;
        acc[k].w += inv * a.w;
      }
      __syncthreads();  // U, the tables and g are rewritten next ROI
    }
    __syncthreads();  // the hits are rewritten next chunk
  }

  if (!live) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int pix = tid / kVec + k * kItems;
    const int y = pix / kTile;
    const int x = pix % kTile;
    if (y < rows && x < cols) {
      *reinterpret_cast<float4*>(
          dfeat + ((static_cast<size_t>(b) * h + y0 + y) * w + x0 + x) * c
          + cv * 4) = acc[k];
    }
  }
}

// bytes of the dynamic shared memory layout in the kernel
long long smem_bytes(int p, int samples, int elem_bytes) {
  return static_cast<long long>(p) * p * kChannels * elem_bytes
         + static_cast<long long>(p) * kTile * kVec * sizeof(float4)
         + 2LL * p * samples * sizeof(Corners)
         + 2LL * p * kTile * sizeof(float) + 2LL * kTile * sizeof(int2)
         + kChunk;
}

template <typename T>
int launch(const void* grad, long long stride_b, long long stride_r,
           long long stride_ph, long long stride_pw, const float* rois,
           float* dfeat, int batch, int h, int w, int c, int r, int p,
           float spatial_scale, int sampling_ratio, int max_samples,
           int smem, cudaStream_t stream) {
  const int samples = sampling_ratio > 0 ? sampling_ratio : max_samples;
  const int tiles_x = (w + kTile - 1) / kTile;
  const long long tiles =
      static_cast<long long>((h + kTile - 1) / kTile) * tiles_x;
  if (samples < 1 || tiles > 65535 || batch > 65535 || c % 4
      || smem < smem_bytes(p, samples, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c / 4 + kVec - 1) / kVec, static_cast<unsigned>(tiles),
                  batch);
  roi_align_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(grad), stride_b, stride_r, stride_ph, stride_pw,
      rois, dfeat, h, w, c, r, p, spatial_scale, sampling_ratio, max_samples,
      samples, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad: [batch, r, p, p, c] f32 (roi_align_bwd_f32) or bf16
// (roi_align_bwd_bf16) at element strides (stride_b, stride_r, stride_ph,
// stride_pw, 1), each 16 bytes' worth of elements a multiple (4 f32, 8
// bf16), 16-byte aligned, c % 4 == 0 (bf16: c % 8 == 0); rois [batch, r,
// 4] f32 -> dfeat [batch, h, w, c] f32, every value written (16-byte
// aligned). samples = sampling_ratio if > 0 else max_samples; smem from the
// wrapper's sizing. Returns a cudaError_t (cudaErrorInvalidValue if smem
// does not hold the layout).
extern "C" int roi_align_bwd_f32(const void* grad, long long stride_b,
                                 long long stride_r, long long stride_ph,
                                 long long stride_pw, const float* rois,
                                 float* dfeat, int batch, int h, int w, int c,
                                 int r, int p, float spatial_scale,
                                 int sampling_ratio, int max_samples,
                                 int smem, cudaStream_t stream) {
  return launch<float>(grad, stride_b, stride_r, stride_ph, stride_pw, rois,
                       dfeat, batch, h, w, c, r, p, spatial_scale,
                       sampling_ratio, max_samples, smem, stream);
}

extern "C" int roi_align_bwd_bf16(const void* grad, long long stride_b,
                                  long long stride_r, long long stride_ph,
                                  long long stride_pw, const float* rois,
                                  float* dfeat, int batch, int h, int w,
                                  int c, int r, int p, float spatial_scale,
                                  int sampling_ratio, int max_samples,
                                  int smem, cudaStream_t stream) {
  return launch<__nv_bfloat16>(grad, stride_b, stride_r, stride_ph,
                               stride_pw, rois, dfeat, batch, h, w, c, r, p,
                               spatial_scale, sampling_ratio, max_samples,
                               smem, stream);
}
