// Greedy NMS keep mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces da_detect_tpu/ops/nms_pallas.py::_nms_kernel (entry
// nms_mask_pallas_sorted). Same function: boxes [B, N, 4] f32 in descending
// score order, valid [B, N]; box i is suppressed when a kept j < i has
// IoU(j, i) > threshold, with legacy +1 widths; invalid rows neither keep nor
// suppress. Output keep [B, N] (uint8). With max_keep > 0 the walk stops
// once max_keep boxes are kept and every later box is not kept: the full
// mask truncated after its max_keep-th kept box, which is all a top-k caller
// (nms_topk) reads.
//
// What bounds it on this card. The IoU tests (at most N^2/2 pairs of ~16
// flops, 72 M pairs at N = 12000) and the bit mask (N^2/8 bytes, 18 MB) are
// spread over every SM and take well under a millisecond. The greedy walk is
// a chain of N/64 dependent steps on one SM per image (188 at N = 12000):
// its time is the latency of one step times their number, so the design
// keeps device memory, block barriers and single-thread loops off that
// chain.
//
// Design. Two launches.
//   1. nms_mask_kernel: one 64-thread block per (column block, row block,
//      image), upper triangle only. Thread k tests box rb*64+k against the
//      block's 64 column boxes (held in shared memory) and writes one 64-bit
//      word of suppression bits. The mask is tiled: the 64 words of one
//      (row block, column block) pair are contiguous, so each block writes
//      512 contiguous bytes, and the diagonal tile of row block cb is
//      followed by the tile right of it. A diagonal word also carries its own
//      box's validity in its own bit (which suppression never sets: it only
//      sets bits of later boxes). Rows of invalid boxes are 0.
//   2. nms_walk_kernel: one 1024-thread block per image walks the row blocks
//      in order, one __syncthreads a step.
//      - Warp 0 resolves block cb. Its two tiles (diagonal and next, 1 KB)
//        were brought into one half of a double buffer by a cp.async.bulk on
//        an mbarrier started a step earlier, so the step does not wait on
//        device memory. Lane l holds the diagonal words of boxes l and l+32.
//        The removed word is a register: the workers' word for cb (below)
//        and the carry. Each round keeps every candidate that no other
//        candidate can suppress (the lowest candidate always qualifies) and
//        removes what they suppress: two warp OR-reductions
//        (__reduce_or_sync) a round, as many rounds as the longest chain of
//        suppressions inside the block, no block barrier. Then it ORs the
//        kept boxes' words of the next tile into the carry: block cb+1's
//        removed bits from block cb, ready for the next step.
//      - Warps 1..31 meanwhile build block cb+2's word from every row block
//        walked so far (0..cb; cb+1's part is the next carry): a warp takes
//        every 31st row block, lane l loads the words of boxes l and l+32
//        when they are kept (coalesced 8-byte loads of one 512-byte tile),
//        4 tiles in flight a lane, and one warp OR-reduction gives the
//        warp's part, which lane 0 stores in a slot of its own (no atomic);
//        warp 0 ORs the 31 parts two steps later. The step after does not
//        wait for this phase, and its loads run beside warp 0's next
//        resolve, so the chain reads no device memory.
//        Computing each word when the walk nears it (lazily), rather than
//        ORing each block's kept rows into every later word (eagerly), reads
//        cb tiles at step cb instead of N/64 - cb: the same in total for a
//        whole walk, but the callers stop early (max_keep: the train RPN
//        keeps 2000 of 12000, after ~32 of 188 blocks), and then the eager
//        form's reads of words the walk never reaches set the step's time.
// Memory: the mask is batch * ceil(N/64)^2 * 512 bytes of scratch (only the
// upper triangle is written and read); the walk keeps each row block's kept
// bits (ceil(N/64) words) in shared memory.
//
// Numerics: the IoU keeps the operation order of box_ops.box_iou and the
// library is compiled with -fmad=false, so that no FMA contraction moves an
// IoU across the threshold: the keep mask equals the plain version's exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kBlock = 64;                       // boxes per mask word
constexpr int kWalkWarps = 32;                   // warp 0 resolves, 1.. OR
constexpr int kWalkThreads = kWalkWarps * 32;
constexpr int kWorkers = kWalkWarps - 1;
constexpr int kUnroll = 4;                       // tiles a worker lane loads
constexpr int kTileBytes = kBlock * sizeof(u64);

__device__ __forceinline__ float iou_plus1(const float* a, const float* b) {
  const float area_a = (a[2] - a[0] + 1.0f) * (a[3] - a[1] + 1.0f);
  const float area_b = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  const float iw = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]) + 1.0f, 0.0f);
  const float ih = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]) + 1.0f, 0.0f);
  const float inter = iw * ih;
  return inter / fmaxf(area_a + area_b - inter, 1e-10f);
}

// first word of tile (row block, column block) of one image's mask
__device__ __forceinline__ size_t tile_offset(int row_block, int col_block,
                                              int col_blocks) {
  return (static_cast<size_t>(row_block) * col_blocks + col_block) * kBlock;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi =
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// OR over the boxes set in `boxes` of their words; lane l holds the words of
// boxes l (w_lo) and l + 32 (w_hi). Every lane gets the result.
__device__ __forceinline__ u64 or_of(u64 boxes, int lane, u64 w_lo,
                                     u64 w_hi) {
  u64 v = 0;
  if ((boxes >> lane) & 1ULL) v |= w_lo;
  if ((boxes >> (lane + 32)) & 1ULL) v |= w_hi;
  return warp_or(v);
}

// the lowest `count` set bits of x (count >= 1)
__device__ __forceinline__ u64 lowest_bits(u64 x, int count) {
  u64 out = 0;
  for (int j = 0; j < count && x; ++j) {
    const u64 low = x & (0ULL - x);
    out |= low;
    x ^= low;
  }
  return out;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One thread: bring row block cb's diagonal tile, and the tile right of it
// when there is one, into buf (2 tiles), completing on bar.
__device__ __forceinline__ void prefetch_tiles(const u64* mask, int cb,
                                               int col_blocks, u64* buf,
                                               uint32_t bar) {
  const uint32_t bytes = (cb + 1 < col_blocks ? 2 : 1) * kTileBytes;
  // buf was last read by generic loads; order them before the async write
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(buf)),
      "l"(mask + tile_offset(cb, cb, col_blocks)), "r"(bytes), "r"(bar)
      : "memory");
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                float threshold, int n, int col_blocks,
                                u64* __restrict__ mask) {
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

  const int k = threadIdx.x;
  const int i = row_block * kBlock + k;
  u64 bits = 0;
  if (k < row_size && valid[static_cast<size_t>(b) * n + i]) {
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = img[static_cast<size_t>(i) * 4 + q];
    const bool diagonal = row_block == col_block;
    for (int j = diagonal ? k + 1 : 0; j < col_size; ++j) {
      if (iou_plus1(a, col_boxes + j * 4) > threshold) bits |= 1ULL << j;
    }
    if (diagonal) bits |= 1ULL << k;  // the box's own bit: valid
  }
  mask[static_cast<size_t>(b) * col_blocks * col_blocks * kBlock
       + tile_offset(row_block, col_block, col_blocks) + k] = bits;
}

// Warps 1..31: block `word`'s removed bits from the kept boxes of row
// blocks 0..last; worker w takes row blocks w, w + 31, ... Every lane gets
// the warp's part.
__device__ __forceinline__ u64 removed_part(const u64* __restrict__ mask,
                                            const u64* kept_rows, int word,
                                            int last, int col_blocks,
                                            int worker, int lane) {
  u64 acc = 0;
  for (int rb0 = worker; rb0 <= last; rb0 += kWorkers * kUnroll) {
    u64 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // all loads first, then the ORs
      const int rb = rb0 + u * kWorkers;
      v[u] = 0;
      if (rb <= last) {
        const u64 kept = kept_rows[rb];
        const u64* tile = mask + tile_offset(rb, word, col_blocks);
        if ((kept >> lane) & 1ULL) v[u] |= tile[lane];
        if ((kept >> (lane + 32)) & 1ULL) v[u] |= tile[lane + 32];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc |= v[u];
  }
  return warp_or(acc);
}

__global__ void __launch_bounds__(kWalkThreads, 1)
    nms_walk_kernel(const u64* __restrict__ mask, int n, int col_blocks,
                    int max_keep, uint8_t* __restrict__ keep) {
  extern __shared__ u64 kept_rows[];                  // col_blocks words
  __shared__ __align__(128) u64 tiles[2][2 * kBlock];  // double buffer
  __shared__ __align__(8) u64 bars[2];
  // parts of block w's removed word from row blocks <= w - 2, one a worker,
  // in slot w % 3 (written at step w - 2, read at step w)
  __shared__ u64 parts[3][32];
  __shared__ int last_s;                              // the walk's last block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  mask += static_cast<size_t>(blockIdx.x) * col_blocks * col_blocks * kBlock;
  keep += static_cast<size_t>(blockIdx.x) * n;
  const uint32_t bar0 = smem_addr(&bars[0]);
  const uint32_t bar1 = smem_addr(&bars[1]);

  for (int i = threadIdx.x; i < 3 * 32; i += kWalkThreads) {
    parts[i / 32][i % 32] = 0;
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar1));
    // make the initialised barriers visible to the bulk copy engine
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    last_s = col_blocks - 1;
    prefetch_tiles(mask, 0, col_blocks, tiles[0], bar0);
  }
  __syncthreads();

  u64 carry = 0;       // warp 0: block cb's removed bits from block cb - 1
  int kept_total = 0;  // warp 0
  int cb = 0;
  for (;; ++cb) {
    const int buf = cb & 1;
    if (warp == 0) {
      if (lane == 0 && cb + 1 < col_blocks) {
        prefetch_tiles(mask, cb + 1, col_blocks, tiles[buf ^ 1],
                       buf ? bar0 : bar1);
      }
      const u64 removed = warp_or(parts[cb % 3][lane]) | carry;
      mbar_wait(buf ? bar1 : bar0, (cb >> 1) & 1);
      const u64* diag = tiles[buf];
      u64 d_lo = diag[lane];
      u64 d_hi = diag[lane + 32];
      const u64 valid_bits =
          static_cast<u64>(__ballot_sync(0xffffffffu, (d_lo >> lane) & 1ULL))
          | (static_cast<u64>(__ballot_sync(0xffffffffu,
                                            (d_hi >> (lane + 32)) & 1ULL))
             << 32);
      d_lo &= ~(1ULL << lane);
      d_hi &= ~(1ULL << (lane + 32));

      // greedy over the block: keep the candidates no candidate suppresses
      u64 cand = valid_bits & ~removed;
      u64 kept = 0;
      while (cand) {
        const u64 sure = cand & ~or_of(cand, lane, d_lo, d_hi);
        kept |= sure;
        cand &= ~(sure | or_of(sure, lane, d_lo, d_hi));
      }
      bool last = cb + 1 == col_blocks;
      if (max_keep > 0 && __popcll(kept) >= max_keep - kept_total) {
        kept = lowest_bits(kept, max_keep - kept_total);
        last = true;
      }
      kept_total += __popcll(kept);

      const int i0 = cb * kBlock;
      if (i0 + lane < n) keep[i0 + lane] = (kept >> lane) & 1ULL;
      if (i0 + lane + 32 < n) keep[i0 + lane + 32] = (kept >> (lane + 32)) & 1ULL;
      if (!last) {
        carry = or_of(kept, lane, diag[kBlock + lane], diag[kBlock + lane + 32]);
      }
      if (lane == 0) {
        kept_rows[cb] = kept;
        if (last) last_s = cb;
      }
    }
    // kept_rows[cb] is published, and the parts of block cb + 1 (from the
    // previous step) are complete
    __syncthreads();
    if (last_s == cb) break;
    if (warp > 0 && cb + 2 < col_blocks) {
      const u64 part = removed_part(mask, kept_rows, cb + 2, cb, col_blocks,
                                    warp - 1, lane);
      if (lane == 0) parts[(cb + 2) % 3][warp - 1] = part;
    }
  }

  // boxes after the block where the walk stopped are not kept
  for (int i = (cb + 1) * kBlock + threadIdx.x; i < n; i += kWalkThreads) {
    keep[i] = 0;
  }
  // shared memory must outlive a prefetch still in flight
  if (warp == 0 && cb + 1 < col_blocks) {
    mbar_wait((cb + 1) & 1 ? bar1 : bar0, ((cb + 1) >> 1) & 1);
  }
}

}  // namespace

// boxes [batch, n, 4] f32, valid [batch, n] u8 -> keep [batch, n] u8.
// max_keep > 0 stops each image's walk after max_keep kept boxes; 0 gives
// the full mask. mask is scratch of batch * ceil(n / 64)^2 * 64 words.
// Returns a cudaError_t.
extern "C" int nms_keep_mask(const float* boxes, const uint8_t* valid,
                             float threshold, int batch, int n, int max_keep,
                             unsigned long long* mask, uint8_t* keep,
                             cudaStream_t stream) {
  const int col_blocks = (n + kBlock - 1) / kBlock;
  const dim3 grid(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid, kBlock, 0, stream>>>(boxes, valid, threshold, n,
                                               col_blocks, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = col_blocks * static_cast<int>(sizeof(u64));
  err = cudaFuncSetAttribute(nms_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<batch, kWalkThreads, smem, stream>>>(
      mask, n, col_blocks, max_keep, keep);
  return static_cast<int>(cudaGetLastError());
}
