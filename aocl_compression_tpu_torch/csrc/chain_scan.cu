// The parse's and the decoders' chain marking, as walks in shared memory.
//
// Replace the JAX package's reachability squarings and its chain scan (XLA
// code there, not Pallas kernels):
//   subchain_reach  aocl_compression_tpu/ops/lz4_device.py:516 (_grid_select)
//                   and :352 (_grid_parse): a fori_loop of ceil(log2(SUBM))
//                   int8 (SUBM, SUBM) matrix squarings, of which row 0 marks
//                   the tiles each sub-chain reaches from its local 0;
//   chain_marks     aocl_compression_tpu/ops/lz4_device.py:832 (7 squarings
//                   of (128, 128) segment matrices) and :849 (the lax.scan
//                   that threads the chain through the segments in order):
//                   _chain_marks, the positions the chain p -> nxt[p] visits
//                   from 0 (the exact parse's greedy chain, the decoders'
//                   token chains).
//
// The squarings move each matrix through HBM once a round (the port's plain
// versions, ops/lz4_device._reach_from_start_plain / _chain_marks_plain, do
// the same with fp16 bmm), while the function reads one int32 a position and
// writes one byte. The graph is functional (one edge out of each position),
// so the set a position reaches inside a segment is one path: a walk that
// stops at a missing edge or a revisit finds it in at most 128 steps, which
// is what 7 squarings guarantee. Both kernels stage their positions' targets
// in shared memory and walk there. A walk is a chain of dependent
// shared-memory loads; the designs keep those chains short and keep the
// memory system busy while they run.
//
// subchain_reach: each warp takes 32 sub-chains, one a lane, on its own (no
// block barrier): a bulk copy a lane (cp.async.bulk under the warp's
// mbarrier) brings their targets into shared memory, all of them in flight
// at once; the warp walks them there and writes its marks, so one warp's
// walks run while the other warps' copies are still out. While the path
// from 0 leads forward (every real one does), a step is one shared load
// and a test; at an edge back or to itself the walk starts again with a
// 128-bit visited mask in registers. At most SUBM steps either way.
//
// chain_marks: the segments of a row (128 positions each) are shared out
// among the K CTAs of a thread-block cluster (K = 8 for a lone row, fewer as
// rows fill the card: N * K stays within its SMs, so 1 from 67 rows on on
// an H100), each CTA taking its share in windows of up to 32,768 positions
// (256 segments, one a thread). Per window:
//   1. stage each position's own exit as a uint16 (its target's place in
//      the window's table where the target lies in a later segment of the
//      window, kBeyond past the window but inside the row's live part, else
//      kEnd: a target in the same or an earlier segment, outside [0, C),
//      or past the segment that holds clen, where the chain marks nothing
//      and never comes back), its in-segment target as a byte, and flag a
//      segment with an edge back or to itself;
//   2. per segment, one sweep from its end turns the own exits, in place,
//      into the exit table: for each position the chain's next entry
//      after the segment (x[p] = x[j] over a forward edge p -> j, else p's
//      own exit); a flagged segment gets kIrr;
//   3. one thread threads the chain through the window in order, one
//      dependent shared load a segment: entry -> x[entry] -> the next
//      entry. An exit into a segment not past the current one ends the
//      chain (JAX's in-order scan never enters a segment twice); a flagged
//      segment is walked with a visited mask for its largest reachable
//      column;
//   4. per segment, the walk from its entry (at most 128 steps) marks the
//      segment, all segments in parallel;
//   5. the window's marks, ANDed with idx < clen, go out coalesced.
// Across a cluster, every CTA stages and sweeps its first window at once;
// a CTA other than the first then threads a guess (the chain from its
// first position) while it waits for the true entry, which the CTA before
// it writes into its shared memory (distributed shared memory) when the
// chain leaves its share. The true chain is threaded only until it meets
// the guess: from there on the two are one chain (each position has one
// exit), so the guess's entries and exit stand. A real chain meets it
// within a few segments, so the row's serial work shrinks from all its
// segments to about one share plus a few steps a CTA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSeg = 128;           // chain_marks' segment (JAX's SEG)
constexpr int kNoEdge = 255;        // a staged local target with no edge
constexpr int kMaxDevices = 64;

// A 128-bit visited mask in two registers.
struct Mask {
  uint64_t lo = 0, hi = 0;
  __device__ __forceinline__ bool has(int j) const {
    return (((j & 64) ? hi : lo) >> (j & 63)) & 1;
  }
  __device__ __forceinline__ void set(int j) {
    if (j & 64) hi |= 1ull << (j & 63); else lo |= 1ull << (j & 63);
  }
  // bytes 4w .. 4w+3 of the mask as 0/1 bytes of one little-endian word
  __device__ __forceinline__ uint32_t word(int w) const {
    const uint32_t nib = (uint32_t)(((w & 16) ? hi : lo) >> ((4 * w) & 63))
                         & 0xF;
    return (nib & 1) | ((nib & 2) << 7) | ((nib & 4) << 14) |
           ((nib & 8) << 21);
  }
};

// The walk over local targets `ls` (kNoEdge: none) from `e` that may meet
// a back edge or a cycle: the set it reaches, its largest index returned.
__device__ __forceinline__ int walk(const uint8_t* ls, int e, Mask& seen) {
  int cur = e, last = e;
  for (int step = 0; step < kSeg; ++step) {
    seen.set(cur);
    last = max(last, cur);
    const int j = ls[cur];
    if (j == kNoEdge || seen.has(j)) break;
    cur = j;
  }
  return last;
}

// The walk from `e` where every edge leads forward: one load a step.
__device__ __forceinline__ void walk_forward(const uint8_t* ls, int e,
                                             Mask& seen) {
  int cur = e;
  int j = ls[cur];
  for (;;) {
    seen.set(cur);
    if (j == kNoEdge) break;
    cur = j;
    j = ls[cur];
  }
}

// --- subchain_reach ----------------------------------------------------------

constexpr int kReachThreads = 128;  // 4 warps, each on its own sub-chains
constexpr int kReachGroup = 32;     // sub-chains a warp, one a lane

// Bytes between two sub-chains' marks: an odd number of words, so the 32
// lanes of a warp writing the same word hit 32 banks.
__host__ __device__ constexpr int reach_stride(int subm) {
  return 4 * (((subm + 3) / 4) | 1);
}

// Words between two sub-chains' targets in shared memory: 16-byte rows (a
// bulk copy's alignment) that start in different banks.
__host__ __device__ constexpr int reach_rstride(int subm) {
  return (subm + 3) / 4 * 4 + 4;
}

// A warp's shared memory: its mbarrier, its sub-chains' targets as read
// (32 rows of reach_rstride int32), then their marks (32 rows of
// reach_stride bytes).
__host__ __device__ constexpr int reach_warp_smem(int subm) {
  return 16 + kReachGroup * reach_rstride(subm) * 4 +
         kReachGroup * reach_stride(subm);
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

// The walk of one sub-chain over its targets as read (`row`, tiles from
// `base`): an edge p -> j for j - base in [0, subm). While every edge on
// the path leads forward, a step is one shared load and a test; at an
// edge back or to itself, the walk starts again with a visited mask.
__device__ __forceinline__ void walk_targets(const int32_t* row, int base,
                                             int subm, Mask& seen) {
  int cur = 0;
  uint32_t j = (uint32_t)row[0] - (uint32_t)base;
  for (;;) {
    seen.set(cur);
    if (j >= (uint32_t)subm) return;
    if ((int)j <= cur) break;
    cur = (int)j;
    j = (uint32_t)row[cur] - (uint32_t)base;
  }
  seen = Mask();
  cur = 0;
  for (int step = 0; step < subm; ++step) {
    seen.set(cur);
    j = (uint32_t)row[cur] - (uint32_t)base;
    if (j >= (uint32_t)subm || seen.has((int)j)) return;
    cur = (int)j;
  }
}

// nxt (N, M) int32 on the tile domain, cut into sub-chains of subm tiles
// (M % subm == 0, 1 <= subm <= 128); reach (N, M) bytes 0/1. The sub-chains
// are contiguous in the flattened (N * M) array: a warp's 32 come into
// shared memory by one bulk copy a lane where `vec` (subm % 4 == 0, nxt
// 16-byte aligned; a word a lane otherwise), and its marks go out as one
// run, a word a lane.
__global__ void __launch_bounds__(kReachThreads)
subchain_reach_kernel(const int32_t* __restrict__ nxt,
                      uint8_t* __restrict__ reach, long long nsub, int m,
                      int subm, bool vec) {
  extern __shared__ __align__(16) uint8_t s_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rstride = reach_rstride(subm);
  const int stride = reach_stride(subm);
  uint8_t* s_warp = s_all + warp * reach_warp_smem(subm);
  int32_t* s_raw = reinterpret_cast<int32_t*>(s_warp + 16);
  uint8_t* s_mark = s_warp + 16 + kReachGroup * rstride * 4;
  const long long g0 =
      ((long long)blockIdx.x * (kReachThreads / 32) + warp) * kReachGroup;
  if (g0 >= nsub) return;
  const int rows = (int)min((long long)kReachGroup, nsub - g0);
  const int spr = m / subm;                   // sub-chains a row
  const int total = rows * subm;              // the warp's targets
  const float inv = 1.0f / (float)subm;
  // element e of the run: sub-chain k = e / subm (exact for e < 32 * 128
  // with the half offset) and its place p
  auto split = [&](int e, int& k, int& p) {
    k = (int)(((float)e + 0.5f) * inv);
    p = e - k * subm;
  };
  if (vec) {
    // every lane's copy in flight at once: a warp whose rows arrive early
    // walks while the others' copies are still out
    const uint32_t bar = smem_addr(s_warp);
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(total * 4)
                   : "memory");
    }
    __syncwarp();
    if (lane < rows) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(s_raw + lane * rstride)),
          "l"(nxt + (g0 + lane) * subm), "r"(subm * 4), "r"(bar)
          : "memory");
    }
    mbar_wait(bar, 0);
  } else {
    const int32_t* src = nxt + g0 * subm;
    for (int e = lane; e < total; e += 32) {
      int k, p;
      split(e, k, p);
      s_raw[k * rstride + p] = src[e];
    }
    __syncwarp();
  }
  if (lane < rows) {
    int q = (int)((g0 + lane) % spr);          // its place in the row
    Mask seen;
    walk_targets(s_raw + lane * rstride, q * subm, subm, seen);
    uint32_t* words = reinterpret_cast<uint32_t*>(s_mark + lane * stride);
    for (int w = 0; w < (subm + 3) / 4; ++w) words[w] = seen.word(w);
  }
  __syncwarp();
  uint8_t* dst = reach + g0 * subm;
  if ((subm & 3) == 0) {
    for (int i = lane; i < total / 4; i += 32) {
      int k, p;
      split(4 * i, k, p);
      reinterpret_cast<uint32_t*>(dst)[i] =
          *reinterpret_cast<const uint32_t*>(s_mark + k * stride + p);
    }
  } else {
    for (int e = lane; e < total; e += 32) {
      int k, p;
      split(e, k, p);
      dst[e] = s_mark[k * stride + p];
    }
  }
}

// --- chain_marks -------------------------------------------------------------

constexpr int kWinSegs = 256;              // segments a window, one a thread
constexpr int kWin = kWinSegs * kSeg;      // positions a window
constexpr int kMarkThreads = kWinSegs;
constexpr int kStageBatch = 8;             // loads in flight a thread
constexpr int kTStride = kSeg + 2;         // uint16s between segments: 65 words
constexpr int kLStride = kSeg + 4;         // bytes between segments: 33 words
constexpr int kMaxCluster = 8;             // CTAs a row (portable size)
// the exit table (staged as each position's own exit in step 1, made the
// segment's in step 2): the next entry as its place in the table (s *
// kTStride + e, so a threading step needs no index arithmetic), or
constexpr uint16_t kPend = 0xFD00;         // | j: x[j], j in a later quarter
constexpr uint16_t kBeyond = 0xFE00;       // | column: read the exit from nxt
constexpr uint16_t kIrr = 0xFFFE;          // a flagged segment: walk it
constexpr uint16_t kEnd = 0xFFFF;          // the chain ends
// a CTA's entry, written by the CTA before it in the cluster
constexpr int kUnset = -2;                 // not written yet
constexpr int kNone = -1;                  // the chain does not come here

// A window-local position's place in the exit table.
__device__ __forceinline__ int place(int p) { return p + 2 * (p >> 7); }

// Dynamic shared memory for windows of `wsegs` segments: two ints (the
// CTA's entry, the chain's next position), then the targets / exit table,
// the in-segment targets / marks, each segment's entry and its flag.
__host__ __device__ constexpr int marks_smem(int wsegs) {
  return 16 + wsegs * (2 * kTStride + kLStride + 2);
}

// Threads the chain through one window from the window-local entry lp and
// returns the row-level position it goes on at past the window, c where it
// ends. Records each segment's entry. kGuess: the entries hold a guessed
// chain whose exit is guess_exit; stop where the chain meets it, and clear
// the guessed entries the chain does not take.
template <bool kGuess>
__device__ int thread_window(const uint16_t* tx, const uint8_t* tl,
                             uint8_t* entry, const int32_t* rn, int wb,
                             int wend, int lim, int c, int live, int lp,
                             int guess_exit) {
  int prev = -1;                                 // the last segment entered
  int at = place(lp);                            // the entry's place
  for (;;) {
    const uint16_t x = tx[at];
    const int s = at / kTStride;
    const int e = at - s * kTStride;
    if (kGuess) {
      for (int q = prev + 1; q < s; ++q) entry[q] = kNoEdge;
      if (entry[s] == e) return guess_exit;     // the same chain from here
    }
    entry[s] = (uint8_t)e;
    prev = s;
    if (x < kPend) {
      at = x;
      continue;
    }
    int v = c;                                   // the chain ends
    if (x == kIrr) {
      Mask seen;
      const int col = walk(tl + s * kLStride, e, seen);
      const int t = rn[wb + s * kSeg + col];
      if (t >= wb && t < wend) {
        if (((t - wb) >> 7) > s) {
          at = place(t - wb);
          continue;
        }
      } else if (t >= wend && t < lim) {
        v = t;
      }
    } else if (x != kEnd) {
      v = rn[wb + s * kSeg + (x & (kSeg - 1))];  // in [wend, lim)
    }
    if (kGuess) {
      for (int q = prev + 1; q < live; ++q) entry[q] = kNoEdge;
    }
    return v;
  }
}

// nxt (N, C) int32 (16-byte aligned), clen (N,) int32, C % 128 == 0; mark
// (N, C) bytes 0/1. A cluster of K CTAs a row (blockIdx.x / K); CTA r takes
// segments [S r / K, S (r + 1) / K) of the row's S, in windows of up to
// wsegs segments.
__global__ void __launch_bounds__(kMarkThreads)
chain_marks_kernel(const int32_t* __restrict__ nxt,
                   const int32_t* __restrict__ clen, uint8_t* __restrict__ mark,
                   int c, int wsegs) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  int* in = reinterpret_cast<int*>(smem_raw);   // the CTA's entry
  int* pos_s = in + 1;                          // the chain's next position
  uint16_t* tx = reinterpret_cast<uint16_t*>(smem_raw + 16);
  uint8_t* tl = smem_raw + 16 + wsegs * kTStride * 2;
  uint8_t* entry = tl + wsegs * kLStride;
  uint8_t* irr = entry + wsegs;

  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int row = blockIdx.x / K;
  const int tid = threadIdx.x;
  const int S = c / kSeg;
  const int rb = (int)((long long)S * r / K) * kSeg;
  const int re = (int)((long long)S * (r + 1) / K) * kSeg;
  const int32_t* rn = nxt + (size_t)row * c;
  uint32_t* out = reinterpret_cast<uint32_t*>(mark + (size_t)row * c);
  const int len = clen[row];
  // The segments from the one past clen on hold no mark, and the chain
  // never comes back from them (it only moves to later segments): it ends
  // where it reaches `lim`.
  const int lim = (min(max(len, 0), c) + kSeg - 1) / kSeg * kSeg;
  int pos = c;            // thread 0: the chain's next position (c: ends)
  bool owner = r == 0;    // thread 0: this CTA holds the chain
  bool handed = false;    // thread 0: the chain has been handed on
  if (tid == 0) {
    if (r == 0) pos = len > 0 ? 0 : c;
    *in = kUnset;
    *pos_s = pos;
  }
  if (tid < wsegs) irr[tid] = 0;
  if (K > 1) cluster.sync();   // every `in` set before any CTA writes one
  else __syncthreads();

  for (int wb = rb; wb < re; wb += kWin) {
    const bool first = wb == rb;
    const int wlen = min(kWin, re - wb);
    const int nseg = wlen / kSeg;
    const int wend = min(wb + wlen, lim);     // the window's live part
    const int live = wend > wb ? (wend - wb) / kSeg : 0;
    const int pos0 = *pos_s;
    // a CTA after the first guesses on its first window
    const bool guess = first && r > 0;
    const bool go = guess ? live > 0 : (pos0 >= wb && pos0 < wend);
    if (go) {
      // 1. stage the targets, four a thread a step: kStageBatch 16-byte
      // loads in flight a thread, then their own exits and in-segment
      // targets
      for (int p0 = 4 * tid; p0 < wend - wb;
           p0 += 4 * kMarkThreads * kStageBatch) {
        int4 v[kStageBatch];
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int p = p0 + 4 * kMarkThreads * b;
          if (p < wend - wb) v[b] = *reinterpret_cast<const int4*>(rn + wb + p);
        }
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int p = p0 + 4 * kMarkThreads * b;
          if (p >= wend - wb) break;
          const int segw = wb + (p & ~(kSeg - 1));  // the segment's start
          const int col = p & (kSeg - 1);
          const int vs[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
          uint32_t t[4], j[4];
          bool back = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // the position's own exit: the target's place where it lies in
            // a later segment of the window, kBeyond | column past the
            // window (below lim), else the chain ends
            const int u = vs[k];
            const uint32_t q = (uint32_t)u - (uint32_t)wb;
            t[k] = q < (uint32_t)(wend - wb)
                   ? ((int)(q >> 7) > (p >> 7) ? (uint32_t)place((int)q)
                                               : (uint32_t)kEnd)
                   : (u >= wend && u < lim) ? (uint32_t)(kBeyond | (col + k))
                   : (uint32_t)kEnd;
            const uint32_t jj = (uint32_t)u - (uint32_t)segw;
            j[k] = jj < kSeg ? jj : (uint32_t)kNoEdge;
            back |= j[k] != kNoEdge && (int)j[k] <= col + k;
          }
          uint32_t* dst = reinterpret_cast<uint32_t*>(
              tx + (p >> 7) * kTStride + col);
          dst[0] = t[0] | t[1] << 16;
          dst[1] = t[2] | t[3] << 16;
          *reinterpret_cast<uint32_t*>(tl + (p >> 7) * kLStride + col) =
              j[0] | j[1] << 8 | j[2] << 16 | j[3] << 24;
          if (back) irr[p >> 7] = 1;
        }
      }
      if (tid < nseg) entry[tid] = kNoEdge;
      __syncthreads();

      // 2. the exit table, in place of the targets, by a sweep from each
      // segment's end
      if (tid < live) {
        uint16_t* xs = tx + tid * kTStride;
        const uint8_t* ls = tl + tid * kLStride;
        if (irr[tid]) {
          uint32_t* xw = reinterpret_cast<uint32_t*>(xs);
          for (int w = 0; w < kSeg / 2; ++w) xw[w] = 0x10001u * kIrr;
        } else {
          // four independent sweeps, one a quarter of 32 positions, in
          // step (a step waits on one round of four loads, not four):
          // an edge into a later quarter leaves kPend | j, resolved once
          // the later quarters are final
          const uint32_t* lw = reinterpret_cast<const uint32_t*>(ls);
          const uint32_t* tw = reinterpret_cast<const uint32_t*>(xs);
          for (int c0 = 24; c0 >= 0; c0 -= 8) {
            uint32_t jw[4][2], tv[4][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
#pragma unroll
              for (int k = 0; k < 2; ++k) jw[q][k] = lw[8 * q + c0 / 4 + k];
#pragma unroll
              for (int k = 0; k < 4; ++k) tv[q][k] = tw[16 * q + c0 / 2 + k];
            }
#pragma unroll
            for (int i = 7; i >= 0; --i) {
              uint32_t got[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int jl = (jw[q][i >> 2] >> (8 * (i & 3))) & 0xFF;
                got[q] = xs[jl < 32 * q + 32 ? jl : 0];  // jl > p in quarter
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int p = 32 * q + c0 + i;
                const int jl = (jw[q][i >> 2] >> (8 * (i & 3))) & 0xFF;
                const uint32_t own = (tv[q][i >> 1] >> (16 * (i & 1))) & 0xFFFF;
                xs[p] = (uint16_t)(jl == kNoEdge ? own
                                   : jl >= 32 * q + 32 ? (uint32_t)(kPend | jl)
                                   : got[q]);
              }
            }
          }
          // eight at a time: eight independent loads, then eight stores
#pragma unroll
          for (int q = 2; q >= 0; --q) {
#pragma unroll
            for (int c = 32 * q; c < 32 * q + 32; c += 8) {
              uint32_t x[8];
#pragma unroll
              for (int k = 0; k < 8; ++k) x[k] = xs[c + k];
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                x[k] = xs[(x[k] & 0xFF80) == kPend ? x[k] & (kSeg - 1)
                                                   : c + k];
              }
#pragma unroll
              for (int k = 0; k < 8; ++k) xs[c + k] = (uint16_t)x[k];
            }
          }
        }
      }
      __syncthreads();

      // 3. thread the chain through the window's segments in order
      if (tid == 0) {
        if (guess) {
          const int gx = thread_window<false>(tx, tl, entry, rn, wb, wend,
                                              lim, c, live, 0, c);
          // (a wait of seconds means a broken hand-over: fail, not hang)
          int v;
          for (long long spin = 0;
               (v = *reinterpret_cast<volatile int*>(in)) == kUnset;) {
            if (++spin > (1ll << 28)) __trap();
          }
          owner = v >= 0;
          if (v >= wb && v < wend) {
            pos = thread_window<true>(tx, tl, entry, rn, wb, wend, lim, c,
                                      live, v - wb, gx);
          } else {
            for (int q = 0; q < live; ++q) entry[q] = kNoEdge;
            pos = owner ? v : c;
          }
        } else {
          pos = thread_window<false>(tx, tl, entry, rn, wb, wend, lim, c,
                                     live, pos0 - wb, c);
        }
      }
    }
    // hand the chain on once it leaves this CTA's share: its entry to the
    // CTA that holds it, kNone to those it skips (or all, if it ends)
    if (tid == 0) {
      if (owner && !handed && (pos < rb || pos >= re)) {
        handed = true;
        const int dst = pos < lim
            ? (int)(((long long)K * ((pos >> 7) + 1) - 1) / S) : K;
        for (int q = r + 1; q < K && q <= dst; ++q) {
          *reinterpret_cast<volatile int*>(cluster.map_shared_rank(in, q)) =
              q == dst ? pos : kNone;
        }
      }
      *pos_s = pos;
    }
    __syncthreads();

    // 4. each entered segment's marks, from its entry
    if (tid < nseg) {
      Mask seen;
      if (go && tid < live && entry[tid] != kNoEdge) {
        if (irr[tid]) walk(tl + tid * kLStride, entry[tid], seen);
        else walk_forward(tl + tid * kLStride, entry[tid], seen);
      }
      uint32_t* lw = reinterpret_cast<uint32_t*>(tl + tid * kLStride);
      for (int w = 0; w < kSeg / 4; ++w) lw[w] = seen.word(w);
    }
    __syncthreads();

    // 5. the window's marks below clen, coalesced
    const uint32_t* lw = reinterpret_cast<const uint32_t*>(tl);
    for (int i = tid; i < wlen / 4; i += kMarkThreads) {
      uint32_t v = lw[(i >> 5) * (kLStride / 4) + (i & 31)];
      const int room = len - (wb + 4 * i);
      if (room <= 0) v = 0;
      else if (room < 4) v &= (1u << (8 * room)) - 1;
      out[wb / 4 + i] = v;
    }
    if (tid < wsegs) irr[tid] = 0;
    __syncthreads();
  }
  // no CTA leaves while another may still write its `in`
  if (K > 1) cluster.sync();
}

// Above 48 KB a kernel needs the opt-in, once per device and kernel (set
// outside any stream capture: the first call of a process is eager).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, bool* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int atpu_subchain_reach(const void* nxt, void* reach, int n, int m,
                                   int subm, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (subm < 1 || subm > kSeg || m % subm) return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(subchain_reach_kernel,
                           (kReachThreads / 32) * reach_warp_smem(kSeg),
                           opted);
  if (err != cudaSuccess) return (int)err;
  const long long nsub = (long long)n * (m / subm);
  const long long blocks = (nsub + kReachThreads - 1) / kReachThreads;
  const int smem = (kReachThreads / 32) * reach_warp_smem(subm);
  const bool vec = subm % 4 == 0 && (uintptr_t)nxt % 16 == 0;
  subchain_reach_kernel<<<(unsigned)blocks, kReachThreads, smem,
                          (cudaStream_t)stream>>>(
      (const int32_t*)nxt, (uint8_t*)reach, nsub, m, subm, vec);
  return (int)cudaGetLastError();
}

extern "C" int atpu_chain_marks(const void* nxt, const void* clen, void* mark,
                                int n, int c, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (c % kSeg || (uintptr_t)nxt % 16) return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(chain_marks_kernel, marks_smem(kWinSegs), opted);
  if (err != cudaSuccess) return (int)err;
  // the SM count sets the cluster size
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  // CTAs a row: the largest power of two up to kMaxCluster with n * K CTAs
  // on at most one per SM, and at least one segment a CTA
  const int nseg = c / kSeg;
  int k = 1;
  while (2 * k <= kMaxCluster && (long long)n * 2 * k <= sms[dev] &&
         2 * k <= nseg) {
    k *= 2;
  }
  const int share = (nseg + k - 1) / k;        // the largest CTA's segments
  const int wsegs = min(kWinSegs, share);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * k));
  cfg.blockDim = dim3(kMarkThreads);
  cfg.dynamicSmemBytes = (size_t)marks_smem(wsegs);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, chain_marks_kernel, (const int32_t*)nxt,
                           (const int32_t*)clen, (uint8_t*)mark, c, wsegs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
