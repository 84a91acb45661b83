// ROIAlign forward (original non-aligned variant) for Hopper (sm_90a).
//
// Replaces da_detect_tpu/ops/roi_align_pallas.py::_pool_fwd_impl (body
// _fwd_kernel, entry roi_align_pallas), and with it the einsum formulation
// the JAX package runs in its place (ops/roi_align.py::roi_align_image).
// Same function: features [B, H, W, C] (channels-last), rois [B, R, 4] xyxy
// in image coordinates -> out [B, R, P, P, C].
//
// Semantics are those of ops/roi_align.py::_roi_grid and _interp_matrix:
// ROI sizes clamped to >= 1; sampling_ratio > 0 gives that many samples a
// bin side, 0 gives ceil(roi / P) capped at max_samples; a sample whose
// coordinate on an axis lies outside [-1, size] weighs 0, otherwise the
// coordinate is clamped to [0, size - 1] and interpolated bilinearly; each
// bin is the mean over grid_h * grid_w samples.
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

namespace {

constexpr int kThreads = 256;

// bilinear corner indices and weights of one sample coordinate on one axis;
// false when the sample lies out of bounds (weight 0)
__device__ __forceinline__ bool axis_weights(float coord, int size, int* lo,
                                             int* hi, float* w_lo,
                                             float* w_hi) {
  if (coord < -1.0f || coord > static_cast<float>(size)) return false;
  const float c = fminf(fmaxf(coord, 0.0f), static_cast<float>(size - 1));
  const int l = static_cast<int>(floorf(c));
  *lo = l;
  *w_lo = 1.0f - (c - static_cast<float>(l));
  if (l + 1 <= size - 1) {
    *hi = l + 1;
    *w_hi = 1.0f - (static_cast<float>(l + 1) - c);
  } else {
    *hi = l;
    *w_hi = 0.0f;
  }
  return true;
}

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

  // _roi_grid
  const float* box = rois + (static_cast<size_t>(b) * r + roi) * 4;
  const float start_w = box[0] * spatial_scale;
  const float start_h = box[1] * spatial_scale;
  const float roi_w = fmaxf(box[2] * spatial_scale - start_w, 1.0f);
  const float roi_h = fmaxf(box[3] * spatial_scale - start_h, 1.0f);
  const float pf = static_cast<float>(p);
  const float bin_w = roi_w / pf;
  const float bin_h = roi_h / pf;
  float grid_h, grid_w;
  if (sampling_ratio > 0) {
    grid_h = grid_w = static_cast<float>(sampling_ratio);
  } else {
    const float cap = static_cast<float>(max_samples);
    grid_h = fminf(fmaxf(ceilf(roi_h / pf), 1.0f), cap);
    grid_w = fminf(fmaxf(ceilf(roi_w / pf), 1.0f), cap);
  }
  const int gh = static_cast<int>(grid_h);
  const int gw = static_cast<int>(grid_w);

  const float4* fmap = features + static_cast<size_t>(b) * h * w * c4 + cv;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int iy = 0; iy < gh; ++iy) {
    const float y = start_h + static_cast<float>(ph) * bin_h
                    + (static_cast<float>(iy) + 0.5f) * bin_h / grid_h;
    int y0, y1;
    float wy0, wy1;
    if (!axis_weights(y, h, &y0, &y1, &wy0, &wy1)) continue;
    for (int ix = 0; ix < gw; ++ix) {
      const float x = start_w + static_cast<float>(pw) * bin_w
                      + (static_cast<float>(ix) + 0.5f) * bin_w / grid_w;
      int x0, x1;
      float wx0, wx1;
      if (!axis_weights(x, w, &x0, &x1, &wx0, &wx1)) continue;
      fma4(&acc, wy0 * wx0, fmap[(static_cast<size_t>(y0) * w + x0) * c4]);
      fma4(&acc, wy0 * wx1, fmap[(static_cast<size_t>(y0) * w + x1) * c4]);
      fma4(&acc, wy1 * wx0, fmap[(static_cast<size_t>(y1) * w + x0) * c4]);
      fma4(&acc, wy1 * wx1, fmap[(static_cast<size_t>(y1) * w + x1) * c4]);
    }
  }
  const float inv = 1.0f / (grid_h * grid_w);
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
