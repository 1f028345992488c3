// compact_rows: pack variable-sized encoder chunks into one dense buffer.
//
// Replaces aocl_compression_tpu/ops/compact.py::_pallas_compact, which
// issued one async DMA of ROWS full rows per chunk and relied on the TPU
// grid running in order (chunk i+1 overwrote chunk i's garbage tail). GPU
// blocks run in parallel and in no order, so here only each chunk's own
// ceil(size/512) rows are copied, to row offset row_offs[i]: destination
// ranges are disjoint and no ordering is needed.
//
// Bound: HBM bytes. The function must read and write used_rows * 512 bytes
// and does no arithmetic, so its floor is 2 * used_rows * 512 bytes over
// the card's memory rate. Two launches, no host sync between them:
//
// 1. compact_layout_kernel (one block, a warp per 128 sizes up to 1024
//    threads, looping over rounds of up to 4096 sizes with coalesced
//    loads and stores through a shared tile): reads the encoder's raw
//    sizes (any stride, possibly > OUTCAP or 0), clamps them, scans the
//    row counts and writes meta = [used, row_offs[0..N), sz[0..N),
//    slab_owner[...]]. slab_owner[k] is the chunk that holds dense row
//    k * kSlabRows. Every size is read once, so the scan is linear in N.
// 2. compact_copy_bulk_kernel: the dense output is cut into slabs of
//    kSlabRows rows (16 KB). A persistent grid of a few blocks per SM
//    walks the slabs, so no block's work depends on how large its chunk
//    is, and a small chunk costs no more than its rows. A slab's source is
//    a few contiguous runs (one per chunk it crosses), found by one warp
//    from slab_owner; its destination is one contiguous range. Rows move
//    as 1-D bulk async copies (cp.async.bulk): global -> shared completed
//    on an mbarrier, shared -> global tracked by bulk groups, kStages
//    slabs of shared memory per block with kAhead loads in flight ahead of
//    the slab being stored.
//    The copy is launched with programmatic dependent launch, so its
//    blocks are resident and waiting (griddepcontrol.wait) while the
//    layout kernel runs.
//
// Addressing is in size_t: byte offsets reach 1 GiB at N = 16,384 chunks
// of 64 KiB. Row counts are int32 (the wrapper checks N * ROWS < 2^31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 512;
constexpr int kVecPerRow = kRowBytes / 16;
constexpr int kSlabRows = 32;                 // 16 KB per slab
constexpr int kStages = 2;                    // slabs of shared per block
constexpr int kAhead = 1;                     // slabs loaded ahead, < kStages
constexpr int kCopySmem = kStages * kSlabRows * kRowBytes;
constexpr int kLayoutThreads = 1024;
constexpr int kLayoutItems = 4;               // sizes per thread per round

__device__ __forceinline__ int rows_of(int sz) {
  return (sz + kRowBytes - 1) / kRowBytes;
}

// Slot of element j of a round's tile in shared memory, padded by one
// word per 32 so that a warp touching 32 consecutive elements and a thread
// touching its kLayoutItems consecutive elements are both free of bank
// conflicts.
__device__ __forceinline__ int tile_slot(int j) { return j + (j >> 5); }

__global__ void __launch_bounds__(kLayoutThreads)
compact_layout_kernel(const int32_t* __restrict__ sizes, long long stride,
                      int32_t* __restrict__ meta, int n, int outcap) {
  // let the copy kernel's blocks launch now; they wait for this grid in
  // griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  constexpr int kTile = kLayoutThreads * kLayoutItems;
  __shared__ int warp_incl[kLayoutThreads / 32];
  __shared__ int tile[kTile + kTile / 32];
  int32_t* offs = meta + 1;
  int32_t* szs = meta + 1 + n;
  int32_t* owner = meta + 1 + 2 * n;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int T = blockDim.x;
  int carry = 0;
  // Each round covers T * kLayoutItems sizes. Global loads and stores go
  // element u * T + t to thread t, so a warp's accesses are contiguous
  // (one store transaction per 32 elements, where a thread-contiguous
  // layout costs one per thread); the scan goes element
  // t * kLayoutItems + u to thread t, through the tile.
  for (int base = 0; base < n; base += T * kLayoutItems) {
#pragma unroll
    for (int u = 0; u < kLayoutItems; ++u) {
      const int i = base + u * T + t;
      int s = 0;
      if (i < n) {
        s = min(max(sizes[(long long)i * stride], 0), outcap);
        szs[i] = s;
      }
      tile[tile_slot(u * T + t)] = s;
    }
    __syncthreads();
    int r[kLayoutItems];
    int tsum = 0;
#pragma unroll
    for (int u = 0; u < kLayoutItems; ++u) {
      r[u] = rows_of(tile[tile_slot(t * kLayoutItems + u)]);
      tsum += r[u];
    }
    // block-wide exclusive scan of the per-thread row sums
    int x = tsum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_incl[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      if (lane < nwarps) warp_incl[lane] = w;
    }
    __syncthreads();
    int off = carry + (warp ? warp_incl[warp - 1] : 0) + x - tsum;
#pragma unroll
    for (int u = 0; u < kLayoutItems; ++u) {
      const int i = base + t * kLayoutItems + u;
      tile[tile_slot(t * kLayoutItems + u)] = off;
      // the slabs whose first row lies in this chunk (none past n: r = 0)
      for (int k = (off + kSlabRows - 1) / kSlabRows;
           k * kSlabRows < off + r[u]; ++k)
        owner[k] = i;
      off += r[u];
    }
    carry += warp_incl[nwarps - 1];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kLayoutItems; ++u) {
      const int i = base + u * T + t;
      if (i < n) offs[i] = tile[tile_slot(u * T + t)];
    }
    __syncthreads();  // tile and warp_incl are rewritten by the next round
  }
  if (t == 0) meta[0] = carry;
}

// One slab's source runs, found by one warp: lane l looks at chunk
// owner + l + 32 j. fn(src_row, slab_row, nrows) is called by the lane
// that owns each nonempty run. Row offsets are nondecreasing, so the walk
// stops at the first batch that holds a chunk starting at or after r1.
template <typename Fn>
__device__ __forceinline__ void slab_runs(const int32_t* offs,
                                          const int32_t* szs, int n,
                                          int used, int rows_per_chunk,
                                          int first, int r0, int r1,
                                          Fn&& fn) {
  const int lane = threadIdx.x & 31;
  for (int c0 = first;; c0 += 32) {
    const int c = c0 + lane;
    const int off = c < n ? offs[c] : used;
    const bool live = off < r1;
    if (live) {
      const int a = max(off, r0);
      const int b = min(off + rows_of(szs[c]), r1);
      if (a < b)
        fn((size_t)c * rows_per_chunk + (a - off), a - r0, b - a);
    }
    if (__ballot_sync(0xffffffffu, !live)) break;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// One warp per block. Stage s of the dynamic shared memory (kCopySmem
// bytes) holds one slab.
__global__ void __launch_bounds__(32)
compact_copy_bulk_kernel(const int4* __restrict__ src,
                         const int32_t* meta,
                         int4* __restrict__ dst, int n, int rows_per_chunk) {
  extern __shared__ __align__(128) int4 buf[];
  __shared__ __align__(8) uint64_t bar[kStages];
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  // meta is written by the layout kernel while this grid may already be
  // running, so it is not __restrict__: its loads stay ordinary loads after
  // this wait, not read-only-cache loads that the compiler may hoist above
  // it (which read a stale meta and leave an mbarrier waiting forever)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int32_t* offs = meta + 1;
  const int32_t* szs = meta + 1 + n;
  const int32_t* owner = meta + 1 + 2 * n;
  const int used = meta[0];
  // the grid has at most one block per slab of capacity, so this owner
  // exists; loaded beside `used`, it costs no round trip of its own
  const int first = owner[blockIdx.x];
  const int n_slabs = (used + kSlabRows - 1) / kSlabRows;

  auto load = [&](int k, int s, int first) {
    const int r0 = k * kSlabRows;
    const int r1 = min(r0 + kSlabRows, used);
    const uint32_t b = smem_addr(&bar[s]);
    if (lane == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
          "r"((r1 - r0) * kRowBytes)
          : "memory");
    __syncwarp();
    const uint32_t base = smem_addr(buf + s * kSlabRows * kVecPerRow);
    slab_runs(offs, szs, n, used, rows_per_chunk, first, r0, r1,
              [&](size_t src_row, int slab_row, int nrows) {
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::"
                    "complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                        base + slab_row * kRowBytes),
                    "l"(src + src_row * kVecPerRow), "r"(nrows * kRowBytes),
                    "r"(b)
                    : "memory");
              });
  };

  uint32_t phase = 0;  // bit s: parity of stage s's next completion
  for (int a = 0; a < kAhead; ++a) {
    const int k = blockIdx.x + a * gridDim.x;
    if (k < n_slabs) load(k, a, a ? owner[k] : first);
  }
  int k = blockIdx.x;
  for (int j = 0; k < n_slabs; ++j, k += gridDim.x) {
    const int s = j % kStages;
    const int k_pre = k + kAhead * gridDim.x;
    if (k_pre < n_slabs) {
      // stage (j + kAhead) % kStages was last read by the store of slab
      // j + kAhead - kStages; kStages - kAhead - 1 stores were committed
      // after it. Wait until that store has read its shared memory.
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(
                         kStages - kAhead - 1)
                     : "memory");
      __syncwarp();
      load(k_pre, (j + kAhead) % kStages, owner[k_pre]);
    }
    mbar_wait(smem_addr(&bar[s]), (phase >> s) & 1);
    phase ^= 1u << s;
    if (lane == 0) {
      const int r0 = k * kSlabRows;
      const int r1 = min(r0 + kSlabRows, used);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
              dst + (size_t)r0 * kVecPerRow),
          "r"(smem_addr(buf + s * kSlabRows * kVecPerRow)),
          "r"((r1 - r0) * kRowBytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // stores must finish before the block's shared memory is released
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// Length in int32 of the meta buffer both kernels use: [used,
// row_offs[0..n), sz[0..n)] and then the slab owners, one per slab of
// capacity (at least one). The caller returns meta[0 .. 1 + 2 n).
extern "C" long long atpu_compact_meta_len(int n_chunks, int rows_per_chunk) {
  const long long slabs =
      ((long long)n_chunks * rows_per_chunk + kSlabRows - 1) / kSlabRows;
  return 1 + 2LL * n_chunks + (slabs < 1 ? 1 : slabs);
}

// Launches the layout kernel on `stream`. meta must hold
// atpu_compact_meta_len(n_chunks, outcap / 512) int32.
extern "C" int atpu_compact_layout(const void* sizes, long long stride,
                                   void* meta, int n_chunks, int outcap,
                                   void* stream) {
  // a warp per 32 * kLayoutItems sizes, up to kLayoutThreads threads
  int threads = (n_chunks + 32 * kLayoutItems - 1) / (32 * kLayoutItems) * 32;
  threads = threads < 32 ? 32 : threads > kLayoutThreads ? kLayoutThreads
                                                          : threads;
  compact_layout_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sizes, stride, (int32_t*)meta, n_chunks, outcap);
  return (int)cudaGetLastError();
}

// Launches the copy kernel on `stream`, after the layout kernel that wrote
// `meta`. Rows of dst past meta[0] are left unwritten.
extern "C" int atpu_compact_copy(const void* src, const void* meta, void* dst,
                                 int n_chunks, int rows_per_chunk,
                                 void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      compact_copy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kCopySmem);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the card at once (shared memory bounds it)
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, compact_copy_bulk_kernel, 32, kCopySmem);
  if (err != cudaSuccess) return (int)err;
  const long long cap =
      ((long long)n_chunks * rows_per_chunk + kSlabRows - 1) / kSlabRows;
  long long grid = (long long)sms * per_sm;
  if (cap < grid) grid = cap;
  if (grid < 1) grid = 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = kCopySmem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, compact_copy_bulk_kernel, (const int4*)src, (const int32_t*)meta,
      (int4*)dst, n_chunks, rows_per_chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
