// ROIAlign forward (original non-aligned variant) for Hopper (sm_90a).
//
// Replaces da_detect_tpu/ops/roi_align_pallas.py::_pool_fwd_impl (body
// _fwd_kernel, entry roi_align_pallas), and with it the einsum formulation
// the JAX package runs in its place (ops/roi_align.py::roi_align_image).
// Same function: features [B, H, W, C] (channels-last), rois [B, R, 4] xyxy
// in image coordinates -> out [B, R, P, P, C].
//
// Semantics: roi_align_common.cuh, shared with the backward kernel
// (roi_align_bwd.cu), so the two sample the same points.
//
// Design. The TPU kernel contracts separable interpolation matrices on the
// MXU. On Hopper a gather is the natural form: one thread per
// (roi, ph, pw, 4-channel vector). It computes the ROI's grid itself, loops
// over its up to max_samples^2 samples and reads four float4 corners per
// sample from the channels-last map, so neighbouring threads read
// neighbouring 16-byte words. The map (C4 at 608x1216: 38x76x1024 f32,
// 11.8 MB) stays in the 50 MB L2, so the repeated corner reads mostly hit L2.
// Bound: bytes. The output (1000 ROIs: 1000*14*14*1024*4 B = 0.80 GB) is
// written once and dominates the traffic to device memory.
//
// Numerics: coordinates are computed in the plain version's operation order
// with -fmad=false, so the in-bounds tests agree exactly; the sums run in
// another order, so outputs agree to ~1e-6, not bitwise.

#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void fma4(float4* acc, float w, const float4& v) {
  acc->x += w * v.x;
  acc->y += w * v.y;
  acc->z += w * v.z;
  acc->w += w * v.w;
}

__global__ void roi_align_fwd_kernel(const float4* __restrict__ features,
                                     const float* __restrict__ rois,
                                     float4* __restrict__ out, int h, int w,
                                     int c4, int r, int p, long long total,
                                     float spatial_scale, int sampling_ratio,
                                     int max_samples) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cv = static_cast<int>(idx % c4);
  long long t = idx / c4;
  const int pw = static_cast<int>(t % p);
  t /= p;
  const int ph = static_cast<int>(t % p);
  t /= p;
  const int roi = static_cast<int>(t % r);
  const int b = static_cast<int>(t / r);

  const roi_align::RoiGrid g = roi_align::roi_grid(
      rois + (static_cast<size_t>(b) * r + roi) * 4, spatial_scale, p,
      sampling_ratio, max_samples);

  const float4* fmap = features + static_cast<size_t>(b) * h * w * c4 + cv;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int iy = 0; iy < g.gh; ++iy) {
    const float y = roi_align::sample_coord(g.start_h, g.bin_h, g.grid_h, ph, iy);
    int y0, y1;
    float wy0, wy1;
    if (!roi_align::axis_weights(y, h, &y0, &y1, &wy0, &wy1)) continue;
    for (int ix = 0; ix < g.gw; ++ix) {
      const float x = roi_align::sample_coord(g.start_w, g.bin_w, g.grid_w, pw, ix);
      int x0, x1;
      float wx0, wx1;
      if (!roi_align::axis_weights(x, w, &x0, &x1, &wx0, &wx1)) continue;
      fma4(&acc, wy0 * wx0, fmap[(static_cast<size_t>(y0) * w + x0) * c4]);
      fma4(&acc, wy0 * wx1, fmap[(static_cast<size_t>(y0) * w + x1) * c4]);
      fma4(&acc, wy1 * wx0, fmap[(static_cast<size_t>(y1) * w + x0) * c4]);
      fma4(&acc, wy1 * wx1, fmap[(static_cast<size_t>(y1) * w + x1) * c4]);
    }
  }
  const float inv = 1.0f / (g.grid_h * g.grid_w);
  out[idx] = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

}  // namespace

// features [batch, h, w, c] f32 (c % 4 == 0, 16-byte aligned),
// rois [batch, r, 4] f32 -> out [batch, r, p, p, c] f32.
// Returns a cudaError_t.
extern "C" int roi_align_fwd(const float* features, const float* rois,
                             float* out, int batch, int h, int w, int c, int r,
                             int p, float spatial_scale, int sampling_ratio,
                             int max_samples, cudaStream_t stream) {
  const int c4 = c / 4;
  const long long total = static_cast<long long>(batch) * r * p * p * c4;
  const long long blocks = (total + kThreads - 1) / kThreads;
  roi_align_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(features), rois,
      reinterpret_cast<float4*>(out), h, w, c4, r, p, total, spatial_scale,
      sampling_ratio, max_samples);
  return static_cast<int>(cudaGetLastError());
}
