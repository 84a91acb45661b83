// Row scatter-add dst[clamp(idx[i], 0, S - 1)] += grad[i] for Hopper
// (sm_90a): the adjoint of the row gather (row_gather.cu,
// row_gather_bulk.cu).
//
// No TPU kernel stands behind it: the JAX package differentiates its
// gathers (da_detect_tpu/layers/deform_conv.py::_gather_tap and
// _gather_tap_quad) with XLA's autodiff, which makes this scatter-add. The
// port's DeformConv2d launches it once a kernel tap in the backward ("four":
// the four corners' gradient rows as one index vector into the [B*H*W, C]
// map; "quad": one 4C-wide row a sample into the overlapped corner table).
//
// grad [P, C] float32 contiguous; idx [P] int32; dst: S rows of C floats,
// row r at dst + r * row_stride (row_stride >= C: a deformable group's
// column slice of a wider map), added into in place; the caller zeroes it.
//
// Design. One warp a gradient row, a block of 8 warps covers 8 rows. The
// warp's lanes read the row in 16-byte vectors and add each into the
// destination row with one vector atomic (float4 atomicAdd, sm_90's
// red.global.add.v4.f32), when C, the row stride and both pointers allow
// 16-byte vectors; else element by element with scalar atomics (red.f32).
// Rows that several samples share (neighbouring samples' corners, clamped
// indices) meet in L2's atomic units; a row is 2-8 KB at the DCN widths, so
// the warps of one block rarely collide.
// Bound: bytes. grad read once, idx read once, each distinct destination
// row read and written once (the zero-fill is the caller's memset, apart).
//
// Numerics: float32 adds in the order the atomics land, which changes from
// run to run: compare with index_add_ (itself atomic on the card) to a
// tolerance, not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <bool kVector>
__global__ void row_scatter_add_kernel(const float* __restrict__ grad,
                                       const int* __restrict__ idx,
                                       float* __restrict__ dst, long long p,
                                       int s, int c, long long row_stride) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps
                        + threadIdx.x / 32;
  if (row >= p) return;
  const int lane = threadIdx.x % 32;
  int r = __ldg(idx + row);
  r = r < 0 ? 0 : (r >= s ? s - 1 : r);
  const float* src = grad + row * c;
  float* out = dst + static_cast<long long>(r) * row_stride;
  if (kVector) {
    const int n4 = c / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(out);
    for (int j = lane; j < n4; j += 32) atomicAdd(d4 + j, __ldg(s4 + j));
  } else {
    for (int j = lane; j < c; j += 32) atomicAdd(out + j, __ldg(src + j));
  }
}

}  // namespace

// grad [p, c] float32 contiguous; idx [p] int32 (clamped to [0, s - 1]);
// dst: s rows of c floats at row_stride floats apart. Returns a cudaError_t.
extern "C" int row_scatter_add_f32(const void* grad, const int* idx,
                                   void* dst, long long p, int s, int c,
                                   long long row_stride,
                                   cudaStream_t stream) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks =
      static_cast<unsigned int>((p + kWarps - 1) / kWarps);
  const bool vector =
      c % 4 == 0 && row_stride % 4 == 0
      && reinterpret_cast<std::uintptr_t>(grad) % 16 == 0
      && reinterpret_cast<std::uintptr_t>(dst) % 16 == 0;
  const float* g = static_cast<const float*>(grad);
  float* d = static_cast<float*>(dst);
  if (vector) {
    row_scatter_add_kernel<true><<<blocks, kThreads, 0, stream>>>(
        g, idx, d, p, s, c, row_stride);
  } else {
    row_scatter_add_kernel<false><<<blocks, kThreads, 0, stream>>>(
        g, idx, d, p, s, c, row_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
