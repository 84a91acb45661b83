// Greedy NMS keep mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces da_detect_tpu/ops/nms_pallas.py::_nms_kernel (entry
// nms_mask_pallas_sorted). Same function: boxes [B, N, 4] f32 in descending
// score order, valid [B, N]; box i is suppressed when a kept j < i has
// IoU(j, i) > threshold, with legacy +1 widths; invalid rows neither keep nor
// suppress. Output keep [B, N] (uint8).
//
// Design. The TPU kernel resolves 512-box chunks by fixpoint matmuls on one
// core. Here the work splits into two launches:
//   1. nms_mask_kernel: one 64-thread block per (column block, row block,
//      image), upper triangle only. Thread i tests its box against the
//      block's 64 column boxes (held in shared memory) and writes one 64-bit
//      word of suppression bits into mask [B, N, ceil(N/64)]. Rows of invalid
//      boxes get no bits.
//   2. nms_reduce_kernel: one block per image walks the boxes in score order,
//      64 at a time. The removed-bitmap lives in shared memory (N=6000: 94
//      words). For each 64-box block the threads first stage the block's
//      diagonal mask words and valid flags in shared memory; one thread then
//      resolves the 64 boxes in order from shared memory alone; finally the
//      threads OR the rows of the boxes kept there into the later words,
//      each thread owning a strided set of words, so the loads of all kept
//      rows are independent and overlap.
// Bound: the IoU tests are at most N^2/2 pairs of ~16 flops each (N=6000:
// 0.29 GFLOP an image), far below the card's rate, and the mask is 4.5 MB an
// image; the sequential walk in step 2 (N/64 steps of one block, each a
// chain of shared-memory reads) sets the time.
//
// Numerics: the IoU keeps the operation order of box_ops.box_iou and the
// library is compiled with -fmad=false, so that no FMA contraction moves an
// IoU across the threshold: the keep mask equals the plain version's exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;         // boxes per mask word
constexpr int kReduceThreads = 128;

__device__ __forceinline__ float iou_plus1(const float* a, const float* b) {
  const float area_a = (a[2] - a[0] + 1.0f) * (a[3] - a[1] + 1.0f);
  const float area_b = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  const float iw = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]) + 1.0f, 0.0f);
  const float ih = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]) + 1.0f, 0.0f);
  const float inter = iw * ih;
  return inter / fmaxf(area_a + area_b - inter, 1e-10f);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                float threshold, int n, int col_blocks,
                                unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  const int b = blockIdx.z;
  if (row_block > col_block) return;  // only later boxes are suppressed
  const int row_size = min(n - row_block * kBlock, kBlock);
  const int col_size = min(n - col_block * kBlock, kBlock);
  const float* img = boxes + static_cast<size_t>(b) * n * 4;

  __shared__ float col_boxes[kBlock * 4];
  if (threadIdx.x < col_size) {
    const float* src = img + (static_cast<size_t>(col_block) * kBlock + threadIdx.x) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) col_boxes[threadIdx.x * 4 + k] = src[k];
  }
  __syncthreads();
  if (threadIdx.x >= row_size) return;

  const int i = row_block * kBlock + threadIdx.x;
  unsigned long long bits = 0;
  if (valid[static_cast<size_t>(b) * n + i]) {
    float a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = img[static_cast<size_t>(i) * 4 + k];
    const int start = (row_block == col_block) ? threadIdx.x + 1 : 0;
    for (int j = start; j < col_size; ++j) {
      if (iou_plus1(a, col_boxes + j * 4) > threshold) bits |= 1ULL << j;
    }
  }
  mask[(static_cast<size_t>(b) * n + i) * col_blocks + col_block] = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ valid, int n,
                                  int col_blocks, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];  // col_blocks words
  __shared__ unsigned long long diag[kBlock];      // this block's own words
  __shared__ unsigned long long valid_bits;
  __shared__ unsigned long long kept_bits;
  const int b = blockIdx.x;
  mask += static_cast<size_t>(b) * n * col_blocks;
  valid += static_cast<size_t>(b) * n;
  keep += static_cast<size_t>(b) * n;
  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) removed[w] = 0;
  if (threadIdx.x == 0) valid_bits = 0;
  __syncthreads();

  for (int cb = 0; cb < col_blocks; ++cb) {
    const int i0 = cb * kBlock;
    const int size = min(n - i0, kBlock);
    if (threadIdx.x < size) {
      const int i = i0 + threadIdx.x;
      diag[threadIdx.x] = mask[static_cast<size_t>(i) * col_blocks + cb];
      if (valid[i]) atomicOr(&valid_bits, 1ULL << threadIdx.x);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // greedy walk over the block's boxes, in shared memory only
      unsigned long long rem = removed[cb];
      unsigned long long kept = 0;
      const unsigned long long vb = valid_bits;
      for (int k = 0; k < size; ++k) {
        if (((vb >> k) & 1ULL) && !((rem >> k) & 1ULL)) {
          kept |= 1ULL << k;
          rem |= diag[k];
        }
      }
      kept_bits = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_bits;
    if (threadIdx.x < size) keep[i0 + threadIdx.x] = (kept >> threadIdx.x) & 1ULL;
    // the kept boxes suppress later boxes: OR their rows into later words
    for (int w = cb + 1 + threadIdx.x; w < col_blocks; w += blockDim.x) {
      unsigned long long acc = removed[w];
      for (unsigned long long rest = kept; rest; rest &= rest - 1) {
        const int k = __ffsll(static_cast<long long>(rest)) - 1;
        acc |= mask[static_cast<size_t>(i0 + k) * col_blocks + w];
      }
      removed[w] = acc;
    }
    if (threadIdx.x == 0) valid_bits = 0;
    __syncthreads();  // later words are complete before the next block reads
  }
}

}  // namespace

// boxes [batch, n, 4] f32, valid [batch, n] u8 -> keep [batch, n] u8.
// mask is scratch of batch * n * ceil(n / 64) words. Returns a cudaError_t.
extern "C" int nms_keep_mask(const float* boxes, const uint8_t* valid,
                             float threshold, int batch, int n,
                             unsigned long long* mask, uint8_t* keep,
                             cudaStream_t stream) {
  const int col_blocks = (n + kBlock - 1) / kBlock;
  const dim3 grid(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid, kBlock, 0, stream>>>(boxes, valid, threshold, n,
                                               col_blocks, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_reduce_kernel<<<batch, kReduceThreads,
                      col_blocks * sizeof(unsigned long long), stream>>>(
      mask, valid, n, col_blocks, keep);
  return static_cast<int>(cudaGetLastError());
}
