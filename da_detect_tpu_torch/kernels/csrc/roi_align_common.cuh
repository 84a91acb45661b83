// Sampling geometry shared by the ROIAlign forward and backward kernels, so
// that the backward scatters to exactly the samples the forward reads.
//
// Semantics are those of ops/roi_align.py::_roi_grid and _interp_matrix: ROI
// sizes clamped to >= 1; sampling_ratio > 0 gives that many samples a bin
// side, 0 gives ceil(roi / P) capped at max_samples; a sample whose
// coordinate on an axis lies outside [-1, size] weighs 0, otherwise the
// coordinate is clamped to [0, size - 1] and interpolated bilinearly; each
// bin is the mean over grid_h * grid_w samples. Coordinates are computed in
// the plain version's operation order (the library is built with
// -fmad=false), so the in-bounds tests agree with it exactly.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace roi_align {

struct RoiGrid {
  float start_h, start_w, bin_h, bin_w, grid_h, grid_w;
  int gh, gw;
};

// one sample on one axis: its two corners and their weights; lo = -1 when
// the sample lies out of bounds
struct Corners {
  int lo, hi;
  float w_lo, w_hi;
};

// 16 bytes global -> shared, asynchronously (L2 only: no reuse in L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// _roi_grid of one xyxy box in image coordinates
__device__ __forceinline__ RoiGrid roi_grid(const float* box,
                                            float spatial_scale, int p,
                                            int sampling_ratio,
                                            int max_samples) {
  RoiGrid g;
  g.start_w = box[0] * spatial_scale;
  g.start_h = box[1] * spatial_scale;
  const float roi_w = fmaxf(box[2] * spatial_scale - g.start_w, 1.0f);
  const float roi_h = fmaxf(box[3] * spatial_scale - g.start_h, 1.0f);
  const float pf = static_cast<float>(p);
  g.bin_w = roi_w / pf;
  g.bin_h = roi_h / pf;
  if (sampling_ratio > 0) {
    g.grid_h = g.grid_w = static_cast<float>(sampling_ratio);
  } else {
    const float cap = static_cast<float>(max_samples);
    g.grid_h = fminf(fmaxf(ceilf(roi_h / pf), 1.0f), cap);
    g.grid_w = fminf(fmaxf(ceilf(roi_w / pf), 1.0f), cap);
  }
  g.gh = static_cast<int>(g.grid_h);
  g.gw = static_cast<int>(g.grid_w);
  return g;
}

// coordinate of sample i of bin b along an axis
__device__ __forceinline__ float sample_coord(float start, float bin_size,
                                              float grid, int b, int i) {
  return start + static_cast<float>(b) * bin_size
         + (static_cast<float>(i) + 0.5f) * bin_size / grid;
}

// bilinear corner indices and weights of one sample coordinate on one axis;
// false when the sample lies out of bounds (weight 0). A corner clamped at
// the far edge gets w_hi = 0.
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

}  // namespace roi_align
