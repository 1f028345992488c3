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
// in shared memory as small local indices and walk there.
//
// subchain_reach: one thread a sub-chain, 128 sub-chains a CUDA block; each
// walks from its local 0 with a 128-bit visited mask in registers (at most
// SUBM steps), writes its marks over its own staged row, and the block
// writes its rows back coalesced.
//
// chain_marks: one CUDA block a row, in windows of 32,768 positions (256
// segments of 128, one thread each). Per window:
//   1. stage each position's target as a window-local uint16: the target
//      itself inside the window, kBeyond past it (inside the row), and the
//      position itself where the target ends the chain (before the window,
//      outside [0, C), or past the segment that holds clen: the chain marks
//      nothing there and never comes back, so a row's work stops there);
//   2. per segment, the largest column each position reaches, by one sweep
//      from the segment's end (last[p] = last[nxt[p]] over a forward edge);
//      a segment with a backward in-segment edge is flagged (kIrregular in
//      every last[p]), and the walk of step 3 computes it instead;
//   3. one thread threads the chain through the window's segments in order:
//      entry e of segment s, exit = target of (s, last[e]); an exit into a
//      segment not past s ends the chain (JAX's in-order scan never enters
//      a segment twice), kBeyond reads the exit from global memory and
//      carries it to a later window. At most 256 steps a window, each two
//      dependent shared-memory loads (last, then the target), whatever the
//      chain's length inside the segments;
//   4. per segment, the walk from its entry (at most 128 steps) marks the
//      segment, all segments in parallel;
//   5. the window's marks, ANDed with idx < clen, go out coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;           // chain_marks' segment (JAX's SEG)
constexpr int kNoEdge = 255;        // a staged local target with no edge

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

// --- subchain_reach ----------------------------------------------------------

constexpr int kReachThreads = 128;  // sub-chains a CUDA block, one a thread

// Bytes between two staged sub-chains: an odd number of words, so the 32
// threads of a warp reading the same local index hit 32 banks.
__host__ __device__ constexpr int reach_stride(int subm) {
  return 4 * (((subm + 3) / 4) | 1);
}

// A target as a staged local index: nxt less the sub-chain's first tile,
// kNoEdge outside [0, subm).
__device__ __forceinline__ uint32_t local_target(int32_t v, int base,
                                                 int subm) {
  const long long j = (long long)v - base;
  return (j >= 0 && j < subm) ? (uint32_t)j : (uint32_t)kNoEdge;
}

// nxt (N, M) int32 on the tile domain, cut into sub-chains of subm tiles
// (M % subm == 0, 1 <= subm <= 128); reach (N, M) bytes 0/1. The sub-chains
// are contiguous in the flattened (N * M) array; a warp stages and writes
// back whole sub-chains, 16 bytes a lane where `vec` (subm % 4 == 0, nxt
// 16-byte aligned).
__global__ void __launch_bounds__(kReachThreads)
subchain_reach_kernel(const int32_t* __restrict__ nxt,
                      uint8_t* __restrict__ reach, long long nsub, int m,
                      int subm, bool vec) {
  extern __shared__ __align__(16) uint8_t s_row[];  // rows of `stride`
  constexpr int kWarps = kReachThreads / 32;
  const int stride = reach_stride(subm);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g0 = (long long)blockIdx.x * kReachThreads;
  const int rows = (int)min((long long)kReachThreads, nsub - g0);
  const int spr = m / subm;                   // sub-chains a row
  const int q0 = (int)(g0 % spr);             // the first one's place
  if (vec) {
    // subm / 4 <= 32 words a sub-chain: one 16-byte load a lane, with
    // kBatch sub-chains' loads in flight at once
    constexpr int kBatch = 8;
    const bool on = lane < subm / 4;
    for (int r0 = warp; r0 < rows; r0 += kWarps * kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = r0 + k * kWarps;
        if (on && r < rows) {
          v[k] = reinterpret_cast<const int4*>(nxt + (g0 + r) * subm)[lane];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = r0 + k * kWarps;
        if (on && r < rows) {
          const int base = ((q0 + r) % spr) * subm;  // its first tile
          reinterpret_cast<uint32_t*>(s_row + r * stride)[lane] =
              local_target(v[k].x, base, subm) |
              local_target(v[k].y, base, subm) << 8 |
              local_target(v[k].z, base, subm) << 16 |
              local_target(v[k].w, base, subm) << 24;
        }
      }
    }
  } else {
    for (int r = warp; r < rows; r += kWarps) {
      const int base = ((q0 + r) % spr) * subm;
      const int32_t* src = nxt + (g0 + r) * subm;
      for (int l = lane; l < subm; l += 32) {
        s_row[r * stride + l] = (uint8_t)local_target(src[l], base, subm);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    uint8_t* row = s_row + threadIdx.x * stride;
    Mask seen;
    int cur = 0;
    for (int step = 0; step < subm; ++step) {
      seen.set(cur);
      const int j = row[cur];
      if (j == kNoEdge || seen.has(j)) break;
      cur = j;
    }
    uint32_t* words = reinterpret_cast<uint32_t*>(row);
    for (int w = 0; w < (subm + 3) / 4; ++w) words[w] = seen.word(w);
  }
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    uint8_t* dst = reach + (g0 + r) * subm;
    const uint8_t* src = s_row + r * stride;
    if ((subm & 3) == 0) {
      for (int q = lane; q < subm / 4; q += 32) {
        reinterpret_cast<uint32_t*>(dst)[q] =
            reinterpret_cast<const uint32_t*>(src)[q];
      }
    } else {
      for (int l = lane; l < subm; l += 32) dst[l] = src[l];
    }
  }
}

// --- chain_marks -------------------------------------------------------------

constexpr int kWinSegs = 256;              // segments a window, one a thread
constexpr int kWin = kWinSegs * kSeg;      // positions a window
constexpr int kMarkThreads = kWinSegs;
constexpr int kTStride = kSeg + 2;         // uint16s between segments: 65 words
constexpr int kLStride = kSeg + 4;         // bytes between segments: 33 words
constexpr uint16_t kBeyond = 0xFFFF;       // a target past the window
constexpr int kIrregular = 255;            // last[] of a segment to walk
constexpr int kMaxDevices = 64;

struct MarkSmem {
  uint16_t t[kWinSegs * kTStride];  // window-local targets (see step 1)
  uint8_t lm[kWinSegs * kLStride];  // last[p] in steps 2-3, marks in 4-5
  uint8_t entry[kWinSegs];          // the chain's entry, or kNoEdge
  int pos;                          // the chain's next position in the row
};

// The walk inside segment `s` (window-local) from `e`: the set it reaches,
// its largest column returned.
__device__ __forceinline__ int walk(const uint16_t* ts, int s, int e,
                                    Mask& seen) {
  const int base = s * kSeg;
  int cur = e, last = e;
  for (int step = 0; step < kSeg; ++step) {
    seen.set(cur);
    last = max(last, cur);
    const int j = (int)ts[cur] - base;
    if (j < 0 || j >= kSeg || seen.has(j)) break;
    cur = j;
  }
  return last;
}

// nxt (N, C) int32 (16-byte aligned), clen (N,) int32, C % 128 == 0; mark
// (N, C) bytes 0/1.
__global__ void __launch_bounds__(kMarkThreads)
chain_marks_kernel(const int32_t* __restrict__ nxt,
                   const int32_t* __restrict__ clen, uint8_t* __restrict__ mark,
                   int c) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  MarkSmem& sm = *reinterpret_cast<MarkSmem*>(smem_raw);
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* rn = nxt + (size_t)row * c;
  uint32_t* out = reinterpret_cast<uint32_t*>(mark + (size_t)row * c);
  const int len = clen[row];
  // The segments from the one past clen on hold no mark, and the chain
  // never comes back from them (it only moves to later segments): it ends
  // where it reaches `lim`.
  const int lim = (min(max(len, 0), c) + kSeg - 1) / kSeg * kSeg;
  if (tid == 0) sm.pos = len > 0 ? 0 : c;
  __syncthreads();

  for (int wb = 0; wb < c; wb += kWin) {
    const int wlen = min(kWin, c - wb);
    const int nseg = wlen / kSeg;
    const int wend = min(wb + wlen, lim);     // the window's live part
    const int pos0 = sm.pos;
    const bool visited = pos0 >= wb && pos0 < wend;
    const int live = visited ? (wend - wb) / kSeg : 0;
    if (visited) {
      // 1. stage the targets, four a thread a step (16-byte loads)
      auto target = [&](int v, int p) -> uint32_t {
        if (v >= wb && v < wend) return (uint32_t)(v - wb);
        if (v >= wend && v < lim) return kBeyond;
        return (uint32_t)p;
      };
#pragma unroll 8
      for (int p = 4 * tid; p < wend - wb; p += 4 * kMarkThreads) {
        const int4 v = *reinterpret_cast<const int4*>(rn + wb + p);
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            sm.t + (p >> 7) * kTStride + (p & (kSeg - 1)));
        dst[0] = target(v.x, p) | target(v.y, p + 1) << 16;
        dst[1] = target(v.z, p + 2) | target(v.w, p + 3) << 16;
      }
      if (tid < live) sm.entry[tid] = kNoEdge;
      __syncthreads();

      // 2. last[p] per segment, by a sweep from its end
      if (tid < live) {
        const uint16_t* ts = sm.t + tid * kTStride;
        uint8_t* ls = sm.lm + tid * kLStride;
        const int base = tid * kSeg;
        bool back = false;
        for (int p = kSeg - 1; p >= 0; --p) {
          const int j = (int)ts[p] - base;
          int l = p;
          if (j > p && j < kSeg) l = ls[j];
          else if (j >= 0 && j < p) back = true;
          ls[p] = (uint8_t)l;
        }
        if (back) {  // step 3 walks this segment instead
          uint32_t* lw = reinterpret_cast<uint32_t*>(ls);
          for (int w = 0; w < kSeg / 4; ++w) lw[w] = 0x01010101u * kIrregular;
        }
      }
      __syncthreads();

      // 3. thread the chain through the window's segments in order
      if (tid == 0) {
        int pos = pos0;
        while (pos >= wb && pos < wend) {
          const int lp = pos - wb;
          const int s = lp >> 7;
          const int e = lp & (kSeg - 1);
          sm.entry[s] = (uint8_t)e;
          int last = sm.lm[s * kLStride + e];
          if (last == kIrregular) {
            Mask seen;
            last = walk(sm.t + s * kTStride, s, e, seen);
          }
          const int x = sm.t[s * kTStride + last];
          if (x == kBeyond) {
            pos = rn[wb + s * kSeg + last];  // in [wend, lim)
          } else {
            pos = (x >> 7) > s ? wb + x : c;  // c: the chain ends
          }
        }
        sm.pos = pos;
      }
      __syncthreads();
    }

    // 4. each visited segment's marks, from its entry
    if (tid < nseg) {
      Mask seen;
      if (tid < live && sm.entry[tid] != kNoEdge) {
        walk(sm.t + tid * kTStride, tid, sm.entry[tid], seen);
      }
      uint32_t* lw = reinterpret_cast<uint32_t*>(sm.lm + tid * kLStride);
      for (int w = 0; w < kSeg / 4; ++w) lw[w] = seen.word(w);
    }
    __syncthreads();

    // 5. the window's marks below clen, coalesced
    const uint32_t* lw = reinterpret_cast<const uint32_t*>(sm.lm);
    for (int i = tid; i < wlen / 4; i += kMarkThreads) {
      uint32_t v = lw[(i >> 5) * (kLStride / 4) + (i & 31)];
      const int room = len - (wb + 4 * i);
      if (room <= 0) v = 0;
      else if (room < 4) v &= (1u << (8 * room)) - 1;
      out[wb / 4 + i] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int atpu_subchain_reach(const void* nxt, void* reach, int n, int m,
                                   int subm, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (subm < 1 || subm > kSeg || m % subm) return (int)cudaErrorInvalidValue;
  const long long nsub = (long long)n * (m / subm);
  const long long blocks = (nsub + kReachThreads - 1) / kReachThreads;
  const int smem = kReachThreads * reach_stride(subm);
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
  const int smem = (int)sizeof(MarkSmem);
  // above 48 KB a kernel needs the opt-in, once per device (set outside any
  // stream capture: the first call of a process is eager)
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(chain_marks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  chain_marks_kernel<<<n, kMarkThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)nxt, (const int32_t*)clen, (uint8_t*)mark, c);
  return (int)cudaGetLastError();
}
