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
//     dF[y, x, c] += inv * sum_ph Ay[ph, y] * sum_pw Ax[pw, x] * g[ph, pw, c]
//
// as the TPU kernel computes it (two matrix products a ROI block).
//
// What bounds it on this card. The bytes: g (train step, 256 ROIs at P = 14,
// C = 1024: 205.5 MB) is read once, dF (11.8 MB) written. The sum across
// ROIs lands in dF by atomics in L2, whose count sets the time unless it is
// kept near the number of touched pixels: a ROI touches only its footprint,
// (rows and columns its samples' corners reach, ~22 x 22 for a ROI 20
// feature pixels wide), against P^2 * grid_h * grid_w * 4 corner updates
// (3,136 at P = 14 and a 2 x 2 grid) when each sample scatters itself.
//
// Design. One 256-thread block per (32-channel slice, ROI, image); 8
// threads span the slice as float4s, so g is read and dF updated in
// coalesced 16-byte words.
//   0. The block stages its slice of the ROI's g (P^2 x 32 floats, 25 KB at
//      P = 14) in shared memory with cp.async, every 16-byte copy in flight
//      at once: g is read from device memory once, in one round trip, while
//      the block computes its tables.
//   1. The block computes the ROI's samples on each axis (two corners and
//      their weights each) into shared memory, and the footprint: the first
//      and last row and column a corner reaches.
//   2. Ay over the footprint rows, dense in shared memory [P, rows], and for
//      each row the range of bins with a non-zero weight.
//   3. The footprint's columns in tiles of tile_cols (the wrapper sizes the
//      tile to the shared memory). For each tile: Ax [P, cols] and each
//      column's range of bins; then U[ph, x, c] = sum_pw Ax[pw, x] g[ph, pw, c]
//      into shared memory, one thread a (ph, x, 4 channels), a gather over
//      the bins that reach x from the staged g; then, one thread a (y, x, 4
//      channels), inv * sum_ph Ay[ph, y] U[ph, x, c] in registers and one
//      float4 atomicAdd (a vector reduction in L2 on sm_90) into dF. So each
//      (ROI, footprint pixel, 4 channels) takes exactly one global atomic,
//      and a pixel no sample reaches takes none.
// Shared memory: the layout below; the wrapper (ops/roi_align_cuda.py::
// bwd_tiling) sizes it, within 48 KB unless the map is so tall that Ay
// alone passes that, and the launcher sets the kernel's limit to it (needed
// past 48 KB).
//
// The gradient may come in any strides with the channels contiguous
// (strides in elements, multiples of 4, 16-byte aligned base): autograd's
// channels-last gradient is read in place. The caller zeroes dF first.
//
// Numerics: within a ROI the sums run in a fixed order (over pw, then ph),
// not the forward's sample order; across ROIs the atomics add in an order
// that changes from run to run. dF agrees with the plain version to float32
// rounding (~1e-6 relative), not bitwise, and is not bitwise reproducible.
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
constexpr int kItems = kThreads / kVec;     // (row or bin, column) items a pass

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
    int tile_cols) {
  // layout: g [p * p][kChannels] T | U [p][tile_cols][kVec] float4 |
  // x samples [p * samples] | y samples [p * samples] | column bins
  // [tile_cols] int2 | row bins [h] int2 | Ax [p][tile_cols] | Ay [p][h]
  extern __shared__ __align__(16) float4 smem[];
  T* gs = reinterpret_cast<T*>(smem);
  float4* u = reinterpret_cast<float4*>(gs + p * p * kChannels);
  Corners* xs = reinterpret_cast<Corners*>(u + p * tile_cols * kVec);
  Corners* ys = xs + p * samples;
  int2* col_bins = reinterpret_cast<int2*>(ys + p * samples);
  int2* row_bins = col_bins + tile_cols;
  float* ax = reinterpret_cast<float*>(row_bins + h);
  float* ay = ax + p * tile_cols;
  __shared__ int x_first, x_last, y_first, y_last;

  const int b = blockIdx.z;
  const int roi = blockIdx.y;
  const int tid = threadIdx.x;
  const int v = tid % kVec;
  const int cv = blockIdx.x * kVec + v;  // this thread's float4 of C
  const bool live = cv < c / 4;

  // 0. stage g[ph, pw] of the slice, 16-byte copies of `per` channels
  {
    constexpr int per = 16 / sizeof(T);
    constexpr int lanes = kChannels / per;
    const int c0 = blockIdx.x * kChannels;
    const T* src = grad + b * stride_b + roi * stride_r + c0;
    for (int j = tid; j < p * p * lanes; j += kThreads) {
      const int e = j / lanes, lane = j % lanes;
      if (c0 + lane * per < c) {
        cp_async16(gs + e * kChannels + lane * per,
                   src + (e / p) * stride_ph + (e % p) * stride_pw
                       + lane * per);
      }
    }
  }

  const roi_align::RoiGrid g = roi_align::roi_grid(
      rois + (static_cast<size_t>(b) * r + roi) * 4, spatial_scale, p,
      sampling_ratio, max_samples);

  // 1. samples and footprint
  if (tid == 0) {
    x_first = w;
    x_last = -1;
    y_first = h;
    y_last = -1;
  }
  __syncthreads();
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
    Corners k{-1, -1, 0.0f, 0.0f};
    if (roi_align::axis_weights(coord, on_x ? w : h, &k.lo, &k.hi, &k.w_lo,
                                &k.w_hi)) {
      atomicMin(on_x ? &x_first : &y_first, k.lo);
      atomicMax(on_x ? &x_last : &y_last, k.hi);
    }
    (on_x ? xs : ys)[t] = k;
  }
  __syncthreads();
  if (x_first > x_last || y_first > y_last) {  // no sample in bounds
    cp_async_wait_all();  // shared memory must outlive the copies
    return;
  }
  const int rows = y_last - y_first + 1;

  // 2. Ay over the footprint rows, and each row's bins
  for (int e = tid; e < p * rows; e += kThreads) {
    ay[e] = bin_weight(ys, g.gh, e / rows, y_first + e % rows);
  }
  cp_async_wait_all();  // this thread's copies of g; the barrier: everyone's
  __syncthreads();
  for (int y = tid; y < rows; y += kThreads) {
    int2 bins = make_int2(p, -1);
    for (int ph = 0; ph < p; ++ph) {
      if (ay[ph * rows + y] != 0.0f) {
        bins.x = min(bins.x, ph);
        bins.y = ph;
      }
    }
    row_bins[y] = bins;
  }

  const float inv = 1.0f / (g.grid_h * g.grid_w);
  float* fmap = dfeat + static_cast<size_t>(b) * h * w * c + cv * 4;

  // 3. column tiles
  for (int x0 = x_first; x0 <= x_last; x0 += tile_cols) {
    const int cols = min(tile_cols, x_last - x0 + 1);
    for (int e = tid; e < p * cols; e += kThreads) {
      ax[e] = bin_weight(xs, g.gw, e / cols, x0 + e % cols);
    }
    __syncthreads();
    for (int x = tid; x < cols; x += kThreads) {
      int2 bins = make_int2(p, -1);
      for (int pw = 0; pw < p; ++pw) {
        if (ax[pw * cols + x] != 0.0f) {
          bins.x = min(bins.x, pw);
          bins.y = pw;
        }
      }
      col_bins[x] = bins;
    }
    __syncthreads();

    // U[ph, x] = sum_pw Ax[pw, x] g[ph, pw]
    for (int e = tid / kVec; e < p * cols; e += kItems) {
      const int ph = e / cols;
      const int x = e % cols;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live) {
        const int2 bins = col_bins[x];
        for (int pw = bins.x; pw <= bins.y; ++pw) {
          add4(&acc, ax[pw * cols + x],
               staged4(gs, (ph * p + pw) * kChannels + v * 4));
        }
      }
      u[e * kVec + v] = acc;
    }
    __syncthreads();

    // dF[y, x] += inv * sum_ph Ay[ph, y] U[ph, x]
    for (int e = tid / kVec; e < rows * cols; e += kItems) {
      const int y = e / cols;
      const int x = e % cols;
      const int2 bins = row_bins[y];
      const int2 xbins = col_bins[x];
      if (!live || bins.x > bins.y || xbins.x > xbins.y) continue;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int ph = bins.x; ph <= bins.y; ++ph) {
        add4(&acc, ay[ph * rows + y], u[(ph * cols + x) * kVec + v]);
      }
      float* dst =
          fmap + (static_cast<size_t>(y_first + y) * w + x0 + x) * c;
      atomicAdd(reinterpret_cast<float4*>(dst),
                make_float4(inv * acc.x, inv * acc.y, inv * acc.z,
                            inv * acc.w));
    }
    __syncthreads();  // U, Ax and the column bins are rewritten next tile
  }
}

// bytes of the dynamic shared memory layout in the kernel
long long smem_bytes(int h, int p, int samples, int tile_cols,
                     int elem_bytes) {
  return static_cast<long long>(p) * p * kChannels * elem_bytes
         + static_cast<long long>(tile_cols) * p * kVec * sizeof(float4)
         + 2LL * p * samples * sizeof(Corners)
         + static_cast<long long>(tile_cols + h) * sizeof(int2)
         + static_cast<long long>(p) * (tile_cols + h) * sizeof(float);
}

template <typename T>
int launch(const void* grad, long long stride_b, long long stride_r,
           long long stride_ph, long long stride_pw, const float* rois,
           float* dfeat, int batch, int h, int w, int c, int r, int p,
           float spatial_scale, int sampling_ratio, int max_samples,
           int tile_cols, int smem, cudaStream_t stream) {
  const int samples = sampling_ratio > 0 ? sampling_ratio : max_samples;
  if (tile_cols < 1 || samples < 1 || r > 65535 || batch > 65535 || c % 4
      || smem < smem_bytes(h, p, samples, tile_cols, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      roi_align_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c / 4 + kVec - 1) / kVec, r, batch);
  roi_align_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(grad), stride_b, stride_r, stride_ph, stride_pw,
      rois, dfeat, h, w, c, r, p, spatial_scale, sampling_ratio, max_samples,
      samples, tile_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad: [batch, r, p, p, c] f32 (roi_align_bwd_f32) or bf16
// (roi_align_bwd_bf16) at element strides (stride_b, stride_r, stride_ph,
// stride_pw, 1), each 16 bytes' worth of elements a multiple (4 f32, 8
// bf16), 16-byte aligned, c % 4 == 0 (bf16: c % 8 == 0); rois [batch, r,
// 4] f32 -> dfeat [batch, h, w, c] f32, which the caller has zeroed
// (16-byte aligned). samples = sampling_ratio if > 0 else max_samples;
// tile_cols and smem from the wrapper's sizing. Returns a cudaError_t
// (cudaErrorInvalidValue if smem does not hold the layout).
extern "C" int roi_align_bwd_f32(const void* grad, long long stride_b,
                                 long long stride_r, long long stride_ph,
                                 long long stride_pw, const float* rois,
                                 float* dfeat, int batch, int h, int w, int c,
                                 int r, int p, float spatial_scale,
                                 int sampling_ratio, int max_samples,
                                 int tile_cols, int smem,
                                 cudaStream_t stream) {
  return launch<float>(grad, stride_b, stride_r, stride_ph, stride_pw, rois,
                       dfeat, batch, h, w, c, r, p, spatial_scale,
                       sampling_ratio, max_samples, tile_cols, smem, stream);
}

extern "C" int roi_align_bwd_bf16(const void* grad, long long stride_b,
                                  long long stride_r, long long stride_ph,
                                  long long stride_pw, const float* rois,
                                  float* dfeat, int batch, int h, int w,
                                  int c, int r, int p, float spatial_scale,
                                  int sampling_ratio, int max_samples,
                                  int tile_cols, int smem,
                                  cudaStream_t stream) {
  return launch<__nv_bfloat16>(grad, stride_b, stride_r, stride_ph,
                               stride_pw, rois, dfeat, batch, h, w, c, r, p,
                               spatial_scale, sampling_ratio, max_samples,
                               tile_cols, smem, stream);
}
