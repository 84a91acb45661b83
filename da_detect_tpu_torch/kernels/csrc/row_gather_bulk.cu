// Row gather with one bulk copy a row, for Hopper (sm_90a):
// out[i] = table[clamp(idx[i], 0, S - 1)].
//
// Replaces scripts/bench_gather_pallas.py::make_dma_gather(...).run, the TPU
// probe that leaves the table in HBM and issues one async row copy
// (pltpu.make_async_copy) per output row, starting all of a block's copies
// and then waiting for all of them. The port's DeformConv2d launches it once
// a kernel tap in TPU.DCN_GATHER "quad" mode, where each row is the
// overlapped four-corner row [f[i], f[i+1], f[i+w], f[i+w+1]] of width 4C
// (da_detect_tpu/layers/deform_conv.py::_gather_tap_quad): 8 KB at res3 in
// float32.
//
// Design. The counterpart of the TPU's row DMA is the bulk copy engine
// (cp.async.bulk, the non-tensor form of TMA). A block owns a chunk of
// consecutive output rows, as many as fit in its shared memory (at most 32).
// Lane i of its single warp issues row i's copy global -> shared, completing
// on one mbarrier whose expected transaction bytes are the chunk's total
// (start-all); every lane waits on the barrier (wait-all); lane 0 then writes
// the whole chunk, which is contiguous in the output, with one bulk copy
// shared -> global and waits until it has read shared memory. Threads spend
// no registers on the data. Several blocks share an SM, so one block's loads
// overlap another's stores.
// Bound: bytes, as for the plain row gather (row_gather.cu).
//
// Requires 16-byte aligned rows: C * sizeof(T), the row stride in bytes and
// both pointers multiples of 16 (the wrapper raises otherwise).
//
// Numerics: a copy, bit for bit equal to the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 32;                  // one lane issues one row
constexpr int kSmemBudget = 96 * 1024;        // two blocks an SM at most
constexpr int kSmemMax = 227 * 1024;          // a block's limit on sm_90

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void row_gather_bulk_kernel(const char* __restrict__ table,
                                       const int* __restrict__ idx,
                                       char* __restrict__ out, long long p,
                                       int s, int row_bytes,
                                       long long stride_bytes,
                                       int rows_per_block) {
  extern __shared__ __align__(128) char rows[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n = static_cast<int>(
      p - first < rows_per_block ? p - first : rows_per_block);
  const uint32_t bar_addr = smem_addr(&bar);

  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr));
    // make the initialised barrier visible to the bulk copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t total = static_cast<uint32_t>(n) * row_bytes;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            bar_addr),
        "r"(total)
        : "memory");
  }
  __syncwarp();

  // start all: one bulk copy a row, each completing on the barrier
  if (lane < n) {
    int r = __ldg(idx + first + lane);
    r = r < 0 ? 0 : (r >= s ? s - 1 : r);
    const char* src = table + static_cast<long long>(r) * stride_bytes;
    const uint32_t dst = smem_addr(rows + static_cast<long long>(lane)
                                              * row_bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(dst),
        "l"(src), "r"(row_bytes), "r"(bar_addr)
        : "memory");
  }

  // wait all: phase 0 of the barrier completes when every byte has landed
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar_addr)
        : "memory");
  }

  if (lane == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    char* dst = out + first * row_bytes;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            dst),
        "r"(smem_addr(rows)), "r"(n * row_bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // shared memory must outlive the copy's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <typename T>
int launch(const void* table, const int* idx, void* out, long long p, int s,
           int c, long long row_stride, cudaStream_t stream) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const long long row_bytes = static_cast<long long>(c) * sizeof(T);
  const long long stride_bytes = row_stride * static_cast<long long>(sizeof(T));
  if (row_bytes % 16 || stride_bytes % 16
      || reinterpret_cast<std::uintptr_t>(table) % 16
      || reinterpret_cast<std::uintptr_t>(out) % 16 || row_bytes > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long rows = kSmemBudget / row_bytes;
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const int smem = static_cast<int>(rows * row_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      row_gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>((p + rows - 1) / rows);
  row_gather_bulk_kernel<<<blocks, 32, smem, stream>>>(
      static_cast<const char*>(table), idx, static_cast<char*>(out), p, s,
      static_cast<int>(row_bytes), stride_bytes, static_cast<int>(rows));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: s rows of c elements at row_stride elements apart; idx [p] int32
// (clamped to [0, s - 1]); out [p, c] contiguous; rows 16-byte aligned.
// Returns a cudaError_t (cudaErrorInvalidValue for unaligned rows).
extern "C" int row_gather_bulk_f32(const void* table, const int* idx,
                                   void* out, long long p, int s, int c,
                                   long long row_stride, cudaStream_t stream) {
  return launch<float>(table, idx, out, p, s, c, row_stride, stream);
}

extern "C" int row_gather_bulk_bf16(const void* table, const int* idx,
                                    void* out, long long p, int s, int c,
                                    long long row_stride,
                                    cudaStream_t stream) {
  return launch<__nv_bfloat16>(table, idx, out, p, s, c, row_stride, stream);
}
