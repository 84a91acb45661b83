// Row gather out[i] = table[clamp(idx[i], 0, S - 1)] for Hopper (sm_90a).
//
// Replaces scripts/bench_gather_pallas.py::make_gather(...).run, the TPU
// probe of the deformable convolution's row gather (its take / index /
// one-hot / loop modes all compute this function), and with it the XLA
// gathers of da_detect_tpu/layers/deform_conv.py::_gather_tap. The port's
// DeformConv2d launches it once a kernel tap with the four bilinear corners'
// indices as one index vector (TPU.DCN_GATHER "four").
//
// table: S rows of C elements, row r at table + r * row_stride (row_stride
// >= C, so a deformable group can gather its column slice of a wider map
// without a copy); idx [P] int32; out [P, C] contiguous.
//
// Design. The TPU probe keeps the table resident in VMEM and gathers along
// sublanes. On Hopper a row is a contiguous run in device memory, so the
// gather is a copy: one warp per output row, a block of 8 warps covers 8
// rows, and the warp's lanes move the row in 16-byte vectors (uint4) when
// C * sizeof(T), the row stride and both pointers allow it, else element by
// element. The table is read through the caches: the DCN tables are
// 5.9-47 MB in float32 (res3 block 0: 94.6 MB), so most stay in the 50 MB
// L2, and the four corners of one sample are neighbouring rows.
// Bound: bytes. Each gathered row is read once and each output row written
// once; at res3 one tap writes 4 * 11552 * 512 * 4 B = 94.6 MB.
//
// Numerics: a copy, bit for bit equal to the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T, bool kVector>
__global__ void row_gather_kernel(const T* __restrict__ table,
                                  const int* __restrict__ idx,
                                  T* __restrict__ out, long long p, int s,
                                  int c, long long row_stride) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps
                        + threadIdx.x / 32;
  if (row >= p) return;
  const int lane = threadIdx.x % 32;
  int r = __ldg(idx + row);
  r = r < 0 ? 0 : (r >= s ? s - 1 : r);
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

template <typename T>
int launch(const void* table, const int* idx, void* out, long long p, int s,
           int c, long long row_stride, cudaStream_t stream) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const unsigned int blocks =
      static_cast<unsigned int>((p + kWarps - 1) / kWarps);
  const bool vector =
      (c * sizeof(T)) % 16 == 0 && (row_stride * sizeof(T)) % 16 == 0
      && reinterpret_cast<std::uintptr_t>(table) % 16 == 0
      && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (vector) {
    row_gather_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        t, idx, o, p, s, c, row_stride);
  } else {
    row_gather_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        t, idx, o, p, s, c, row_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: s rows of c elements at row_stride elements apart; idx [p] int32
// (clamped to [0, s - 1]); out [p, c] contiguous. Returns a cudaError_t.
extern "C" int row_gather_f32(const void* table, const int* idx, void* out,
                              long long p, int s, int c, long long row_stride,
                              cudaStream_t stream) {
  return launch<float>(table, idx, out, p, s, c, row_stride, stream);
}

extern "C" int row_gather_bf16(const void* table, const int* idx, void* out,
                               long long p, int s, int c,
                               long long row_stride, cudaStream_t stream) {
  return launch<__nv_bfloat16>(table, idx, out, p, s, c, row_stride, stream);
}
