// ROIAlign backward (d features) for Hopper (sm_90a).
//
// Replaces da_detect_tpu/ops/roi_align_pallas.py::_pool_bwd (body
// _bwd_kernel), the backward of the custom VJP around _pool_fwd_impl, and
// with it the einsum adjoint XLA derives for ops/roi_align.py::roi_align.
// Same function: the upstream gradient g [B, R, P, P, C] -> dF [B, H, W, C]
// in float32 (channels-last). The ROIs take no gradient: the proposals they
// come from are stop-gradient, and _pool_bwd returns zeros for them.
//
// It is the adjoint of roi_align_fwd.cu, not a copy of the TPU kernel: each
// sample the forward reads (same geometry, roi_align_common.cuh: the same
// [-1, size] out-of-bounds rule, edge clamp and 1 / (grid_h * grid_w) mean)
// scatters w * g into the four corners it interpolated from.
//
// Design. The TPU kernel accumulates dF in a VMEM block across the
// sequential ROI grid axis, as two matrix products per ROI block. Hopper's
// blocks run in parallel and in no order, so the sum across ROIs is made with
// atomics: one thread per (roi, ph, pw, 4-channel vector) reads its float4
// of g (neighbouring threads, neighbouring 16-byte words) and adds
// w * g / (grid_h * grid_w) into the four corners of every in-bounds sample
// with one float4 atomicAdd each (a vector reduction in L2 on sm_90). dF
// (C4 at 608x1216: 38x76x1024 f32, 11.8 MB) stays in the 50 MB L2 while the
// atomics land. The caller zeroes dF first.
// Bound: bytes. g (256 ROIs: 256*14*14*1024*4 B = 205.5 MB) is read once
// and dominates the traffic to device memory.
//
// Numerics: the atomics add in an order that changes from run to run, so dF
// agrees with the plain version to float32 rounding (~1e-6 relative), not
// bitwise, and is not bitwise reproducible itself.

#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

constexpr int kThreads = 256;

// dst += w * v, for the 4 channels at dst (16-byte aligned, global memory)
__device__ __forceinline__ void scatter4(float* dst, float w, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(dst),
            make_float4(w * v.x, w * v.y, w * v.z, w * v.w));
}

__global__ void roi_align_bwd_kernel(const float4* __restrict__ grad,
                                     const float* __restrict__ rois,
                                     float* __restrict__ dfeat, int h, int w,
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
  const float inv = 1.0f / (g.grid_h * g.grid_w);
  const float4 gv = grad[idx];
  const float4 gs = make_float4(gv.x * inv, gv.y * inv, gv.z * inv, gv.w * inv);

  const int c = c4 * 4;
  float* fmap = dfeat + static_cast<size_t>(b) * h * w * c + cv * 4;
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
      scatter4(fmap + (static_cast<size_t>(y0) * w + x0) * c, wy0 * wx0, gs);
      scatter4(fmap + (static_cast<size_t>(y0) * w + x1) * c, wy0 * wx1, gs);
      scatter4(fmap + (static_cast<size_t>(y1) * w + x0) * c, wy1 * wx0, gs);
      scatter4(fmap + (static_cast<size_t>(y1) * w + x1) * c, wy1 * wx1, gs);
    }
  }
}

}  // namespace

// grad [batch, r, p, p, c] f32 (c % 4 == 0, 16-byte aligned),
// rois [batch, r, 4] f32 -> dfeat [batch, h, w, c] f32, which the caller
// has zeroed (16-byte aligned). Returns a cudaError_t.
extern "C" int roi_align_bwd(const float* grad, const float* rois,
                             float* dfeat, int batch, int h, int w, int c,
                             int r, int p, float spatial_scale,
                             int sampling_ratio, int max_samples,
                             cudaStream_t stream) {
  const int c4 = c / 4;
  const long long total = static_cast<long long>(batch) * r * p * p * c4;
  const long long blocks = (total + kThreads - 1) / kThreads;
  roi_align_bwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(grad), rois, dfeat, h, w, c4, r, p,
      total, spatial_scale, sampling_ratio, max_samples);
  return static_cast<int>(cudaGetLastError());
}
