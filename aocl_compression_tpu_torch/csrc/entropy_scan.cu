// The encoders' two entropy-table scans, one warp a block (row) of the codec.
//
// Replace lax.scans of the JAX package (not Pallas kernels there):
//   kraft_absorb        aocl_compression_tpu/ops/deflate_device.py:221-229
//                       (_kraft_lengths, MAXLEN 15, 288 and 32 symbols) and
//                       aocl_compression_tpu/ops/zstd_device.py:107-115
//                       (_block_huffman, huffLog 11, 256 symbols): the Kraft
//                       deficit D absorbed over the frequency-sorted code
//                       lengths;
//   weights_fse_encode  aocl_compression_tpu/ops/zstd_device.py:140-166
//                       (_encode_weights): the two-state FSE encode of a
//                       block's 255 Huffman weights with the static weight
//                       table, and the bit packing after it.
//
// Each row is a serial chain (D, or the two FSE states, carried from step
// to step); the port's plain PyTorch loops launch every op of every step
// from the host. Bound: a row's chain of dependent steps, not HBM bytes (a
// few hundred KB a call). Both kernels give each row a warp of its own, so
// N = 256 rows spread over the card's SMs, and shorten the chain:
//
// kraft_absorb walks runs of equal lengths, not symbols. Within a run of
// length nb > 0 (sh = MAXLEN - nb, c = 2^sh, cap = nb - 1), write D = a*c + r
// with 0 <= r < c: a step changes only a. With b = a + 1 it takes
// k = min(floor(log2 b), cap) and sets b -= 2^k - 1, so k does not rise
// along the run: a prefix of steps at k = cap (each subtracting 2^cap - 1,
// counted by one division), then a few steps with k < cap until b = 1, then
// nothing. A run of nb <= 1 changes nothing, and neither does any run once
// D <= 0. The warp stages its row in shared memory (cp.async copies of 16
// bytes where the row allows, all in flight at once), lists the runs'
// starts with a ballot a 32 symbols, walks the runs in order (every lane
// the same walk, so no lane waits on another: about a division and a
// handful of steps a run; callers' rows are sorted, so at most MAXLEN + 1
// runs) leaving each position's k in a byte (the lanes mark a capped prefix
// together, lane 0 the few steps after it), and the lanes then write
// nb - k for every position in parallel.
//
// weights_fse_encode: the block's warps first turn the static table into a
// next-state table by symbol and state (12 x 64 bytes: the state after
// encoding a symbol from a state, less 64), off the chain, and each warp
// turns its row's 255 weights into their rows of that table. Then lane 0
// runs state 1 (127 steps) and lane 1 state 2 (126) side by side, each step
// one add and one dependent shared-memory byte load, straight-line, keeping
// the states it starts from in registers. Then the warp lays out the 256 fields in the
// JAX order (the step at 252, the pairs from 251 down, state 2 and state 1
// less 64 in WEIGHT_LOG bits each, the closing 1 bit): each lane takes 8
// consecutive fields, computes their widths and values from the saved
// states, finds its bit offset by a warp prefix sum and ORs its bits into
// the row's 128 words in shared memory, which go out as one 16-byte store
// a lane. The wrapper proves the table closed (every state in [64, 127]
// and symbol give a table index in [0, 63], the init index too, nxt lies
// in [64, 127], every width in [0, 9]) before it launches, so the chain
// carries no clamp; the table build keeps one, off the chain.
//
// The arithmetic follows the plain versions (ops/deflate_device.
// _kraft_absorb_plain, ops/zstd_device._encode_weights_plain), which follow
// the JAX package: int32 throughout; D may be negative (the JAX package's
// share wraps in int32 for a 65,536-count symbol), and D >> sh is an
// arithmetic shift, JAX's floor division by the power of two c; where
// (D >> sh) + 1 wraps (sh = 0, D = 2^31 - 1) the step takes k = 0, as the
// plain version's int32 does. JAX's floor_log2 ladder saturates at MAXLEN;
// floor(log2 b) equals it here because k is capped at nb - 1 <= MAXLEN - 1.

#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks for scripts/entropy_phases.py, which defines them in an
// instrumented copy; nothing here.
#ifndef ATPU_PHASES
#define ATPU_PHASE_BEGIN(K)
#define ATPU_PHASE(I, NAME)
#endif

namespace {

// Asynchronous copies of 16 and 4 bytes from global into shared memory
// (cp.async: no register holds the data, so a lane's copies are all in
// flight at once), and the wait for the lane's own copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// --- kraft_absorb ------------------------------------------------------------

constexpr int kKraftWarps = 2;          // rows (one a warp) a CUDA block
constexpr int kKraftSmem = 48 * 1024;   // shared memory a block, at most

// int32 words of one warp's shared memory at nsym symbols (a multiple of 4,
// so each warp's row and its k bytes are 16-byte aligned): the row, a byte
// a position for the k the walk leaves (rounded up to 16 bytes), the run
// starts (two past the last run) and the runs' lengths.
__host__ __device__ constexpr int kraft_words(int nsym) {
  return (((nsym + 3) & ~3) + ((nsym + 15) & ~15) / 4 + (nsym + 2)
          + (nsym + 1) + 3) & ~3;
}

// Per row, over the code lengths nb = nbs[s], s = 0..nsym-1 (sorted by the
// callers):
//   c = nb > 0 ? 1 << (MAXLEN - max(nb, 1)) : 0
//   q = max(c > 0 ? (D >> (MAXLEN - max(nb, 1))) + 1 : 1, 1)
//   k = min(floor_log2(q), max(nb - 1, 0))
//   D -= c * ((1 << k) - 1);  nbs2[s] = nb - k
// nbs must lie in [0, maxlen] (the callers' lengths do); any order.
__global__ void __launch_bounds__(kKraftWarps * 32)
kraft_absorb_kernel(const int32_t* __restrict__ nbs,
                    const int32_t* __restrict__ d0, int32_t* __restrict__ nbs2,
                    int32_t* __restrict__ dout, int n, int nsym, int maxlen,
                    int words, bool vec) {
  extern __shared__ __align__(16) int32_t s_kraft[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n) return;
  ATPU_PHASE_BEGIN(0);
  int32_t* nb = s_kraft + warp * words;
  uint8_t* kk = reinterpret_cast<uint8_t*>(nb + ((nsym + 3) & ~3));
  int32_t* rs = nb + ((nsym + 3) & ~3) + ((nsym + 15) & ~15) / 4;
  int32_t* rnb = rs + nsym + 2;           // run lengths
  const int32_t* src = nbs + (size_t)row * nsym;
  if (vec) {
    for (int i = 4 * lane; i < nsym; i += 128) cp_async16(nb + i, src + i);
  } else {
    for (int i = lane; i < nsym; i += 32) cp_async4(nb + i, src + i);
  }
  int D = d0[row];
  for (int i = 16 * lane; i < nsym; i += 512) {
    *reinterpret_cast<int4*>(kk + i) = make_int4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncwarp();
  ATPU_PHASE(1, "staging");

  // the runs: a start wherever the length changes, listed in order; 4
  // tiles of 32 positions a round, their loads ahead of the round's stores
  const unsigned below = (1u << lane) - 1u;
  int nrun = 0;
  for (int j0 = 0; j0 < nsym; j0 += 128) {
    int cur[4], prev[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 32 * q + lane;
      cur[q] = j < nsym ? nb[j] : 0;
      prev[q] = j > 0 && j < nsym ? nb[j - 1] : ~cur[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 32 * q + lane;
      const bool in = j < nsym;
      const bool start = in && prev[q] != cur[q];
      const unsigned m = __ballot_sync(0xffffffffu, start);
      const int before = nrun + __popc(m & below);
      if (start) {
        rs[before] = j;
        rnb[before] = cur[q];
      }
      nrun += __popc(m);
    }
  }
  if (lane == 0) {
    rs[nrun] = nsym;
    rs[nrun + 1] = nsym;
    rnb[nrun] = 0;
  }
  __syncwarp();
  ATPU_PHASE(2, "runs");

  // the walk, the same in every lane; run r's next values are read a run
  // ahead, off D's chain. The lanes mark a capped prefix together.
  int s = rs[0], e = rs[1], v = rnb[0];
  for (int r = 0; r < nrun && D > 0; ++r) {
    const int e_next = rs[r + 2];
    const int v_next = rnb[r + 1];
    const int cap = v - 1;
    const int sh = maxlen - v;
    const int a = D >> sh;
    if (cap > 0 && a != 0x7fffffff) {
      unsigned b = (unsigned)a + 1u;
      const unsigned top = 1u << cap;
      const unsigned step = top - 1u;
      int j = s;
      if (b >= top) {
        const unsigned m = min((b - top) / step + 1u, (unsigned)(e - s));
        b -= m * step;
        j += (int)m;
        for (int q = s + lane; q < j; q += 32) kk[q] = (uint8_t)cap;
      }
      for (; j < e && b > 1u; ++j) {
        const int k = 31 - __clz((int)b);
        if (lane == 0) kk[j] = (uint8_t)k;
        b -= (1u << k) - 1u;
      }
      D = (int)((b - 1u) << sh) + (D & ((1 << sh) - 1));
    }
    s = e;
    e = e_next;
    v = v_next;
  }
  __syncwarp();
  ATPU_PHASE(3, "walk");

  int32_t* dst = nbs2 + (size_t)row * nsym;
#pragma unroll 4
  for (int j = lane; j < nsym; j += 32) {
    dst[j] = nb[j] - kk[j];
  }
  if (lane == 0) dout[row] = D;
  ATPU_PHASE(4, "write-back");
}

// --- weights_fse_encode ------------------------------------------------------

constexpr int kWWarps = 2;      // rows (one a warp) a CUDA block
constexpr int kWNum = 255;      // weights a row (symbol 255's is implicit)
constexpr int kWCap = 512;      // output bytes a row
constexpr int kWWords = kWCap / 4;
constexpr int kWStates = 64;    // 1 << WEIGHT_LOG
constexpr int kWLog = 6;        // WEIGHT_LOG
constexpr int kWSymMax = 16;    // room for the table's symbols (12)
constexpr int kWSteps = 126;    // pair steps (state 2 at 251 - 2t, 1 at 250 - 2t)
static_assert(kWWarps * 32 >= kWStates, "a thread a state builds the table");

// Per row: init(w[254]) into state 1 and init(w[253]) into state 2, one enc
// of state 1 at 252, then 126 pairs: state 2 at 251 - 2t, state 1 at
// 250 - 2t; the fields in that order, then both final states less 64 in
// WEIGHT_LOG bits each (state 2 first) and one closing 1 bit. The fields
// never overlap, so ORing them equals the plain version's scatter-add
// packing. size = (total + 1 + 7) >> 3. Weights are clamped to the table's
// symbols (the plain version takes weights in [0, nsym) only, where the
// clamp does not act). buf must be 16-byte aligned.
__global__ void __launch_bounds__(kWWarps * 32)
weights_fse_encode_kernel(const int32_t* __restrict__ weights,
                          const int32_t* __restrict__ nxt,
                          const int32_t* __restrict__ dnb,
                          const int32_t* __restrict__ dfs,
                          uint8_t* __restrict__ buf,
                          int32_t* __restrict__ size, int n, int nsym) {
  __shared__ int32_t s_nxt[kWStates];
  __shared__ int32_t s_dnb[kWSymMax];
  __shared__ int32_t s_dfs[kWSymMax];
  __shared__ uint8_t s_next[kWSymMax * kWStates];  // [sym][state - 64]
  __shared__ uint8_t s_init[kWSymMax];
  __shared__ uint16_t s_base[kWWarps][kWNum + 1];   // sym * 64 a position
  // state - 64 before each step of state 1 ([0]) and state 2 ([1])
  __shared__ __align__(16) uint8_t s_st[kWWarps][2][128];
  __shared__ uint8_t s_fin[kWWarps][2];             // final states - 64
  __shared__ __align__(16) uint32_t s_out[kWWarps][kWWords];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x * kWWarps + warp;
  const bool live = row < n;
  ATPU_PHASE_BEGIN(1);
  // every global load first (the table, the row), then the shared stores
  const int32_t* src = weights + (size_t)row * kWNum;
  const int nx = tid < kWStates ? nxt[tid] : 0;
  const bool sym_in = tid < nsym;
  const int dn = sym_in ? dnb[tid] : 0;
  const int df = sym_in ? dfs[tid] : 0;
  int w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    w[k] = live && i < kWNum ? src[i] : 0;
  }
  if (tid < kWStates) s_nxt[tid] = nx;
  if (tid < kWSymMax) {
    s_dnb[tid] = dn;
    s_dfs[tid] = df;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    if (i < kWNum) {
      s_base[warp][i] = (uint16_t)(min(max(w[k], 0), nsym - 1) << kWLog);
    }
  }
  reinterpret_cast<uint4*>(s_out[warp])[lane] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  ATPU_PHASE(1, "loads");
  // the next-state table: thread st - 64 takes state st for every symbol,
  // its index loads all ahead of its stores
  if (tid < kWStates) {
    const int st = kWStates + tid;
    int x[kWSymMax];
#pragma unroll
    for (int sym = 0; sym < kWSymMax; ++sym) {
      const int nb = (st + s_dnb[sym]) >> 16;
      x[sym] = min(max((st >> nb) + s_dfs[sym], 0), kWStates - 1);
    }
#pragma unroll
    for (int sym = 0; sym < kWSymMax; ++sym) x[sym] = s_nxt[x[sym]];
#pragma unroll
    for (int sym = 0; sym < kWSymMax; ++sym) {
      if (sym < nsym) {
        s_next[sym * kWStates + tid] =
            (uint8_t)((x[sym] - kWStates) & (kWStates - 1));
      }
    }
  }
  if (sym_in) {
    const int nbout = (dn + (1 << 15)) >> 16;
    const int x = min(max((((nbout << 16) - dn) >> nbout) + df, 0),
                      kWStates - 1);
    s_init[tid] = (uint8_t)((s_nxt[x] - kWStates) & (kWStates - 1));
  }
  __syncthreads();
  if (!live) return;
  ATPU_PHASE(2, "table");

  // the chains: lane 0 state 1 (252, 250, ..., 0), lane 1 state 2 (251,
  // ..., 1), one add and one dependent byte load a step, straight-line;
  // the states each step starts from are kept in registers, 4 a word (no
  // shared store among the steps, so the table rows' loads run ahead)
  const uint16_t* base = s_base[warp];
  if (lane < 2) {
    uint32_t rec[32] = {};
    int st = s_init[base[254 - lane] >> kWLog];
    const int top = 252 - lane;
#pragma unroll
    for (int t = 0; t < kWSteps; ++t) {
      rec[t >> 2] |= (uint32_t)st << (8 * (t & 3));
      st = s_next[base[top - 2 * t] + st];
    }
    rec[kWSteps >> 2] |= (uint32_t)st << (8 * (kWSteps & 3));
    const int last = s_next[base[0] + st];   // state 1's step at 0
    s_fin[warp][lane] = (uint8_t)(lane == 0 ? last : st);
    uint4* out = reinterpret_cast<uint4*>(s_st[warp][lane]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      out[q] = make_uint4(rec[4 * q], rec[4 * q + 1], rec[4 * q + 2],
                          rec[4 * q + 3]);
    }
  }
  __syncwarp();
  ATPU_PHASE(3, "chain");

  // the fields, 8 a lane in stream order: f <= 252 the step at 252 - f
  // (state 1's step f / 2 for an even f, state 2's (f - 1) / 2 for an odd
  // one), 253 state 2, 254 state 1, 255 the closing bit
  uint32_t val[8];
  int width[8];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = min(lane * 8 + i, 252);
    const int st = kWStates + s_st[warp][f & 1][f >> 1];
    const int nb = (st + s_dnb[base[252 - f] >> kWLog]) >> 16;
    uint32_t x = (uint32_t)st & ((1u << nb) - 1u);
    int wd = nb;
    if (i >= 5 && lane == 31) {   // f = 253, 254, 255
      x = i == 7 ? 1u : s_fin[warp][6 - i];
      wd = i == 7 ? 1 : kWLog;
    }
    val[i] = x;
    width[i] = wd;
    sum += wd;
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int pos = incl - sum;
  unsigned long long lo = 0, hi = 0;
  int rel = pos & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned long long x = val[i];
    if (rel < 64) {
      lo |= x << rel;
      if (rel > 0) hi |= x >> (64 - rel);
    } else {
      hi |= x << (rel - 64);
    }
    rel += width[i];
  }
  uint32_t* out = s_out[warp] + (pos >> 5);
  const int nw = (rel + 31) >> 5;
  if (nw > 0) atomicOr(out, (uint32_t)lo);
  if (nw > 1) atomicOr(out + 1, (uint32_t)(lo >> 32));
  if (nw > 2) atomicOr(out + 2, (uint32_t)hi);
  if (nw > 3) atomicOr(out + 3, (uint32_t)(hi >> 32));
  if (lane == 31) size[row] = (incl + 7) >> 3;   // incl = total + 1
  __syncwarp();
  ATPU_PHASE(4, "packing");
  reinterpret_cast<uint4*>(buf + (size_t)row * kWCap)[lane] =
      reinterpret_cast<const uint4*>(s_out[warp])[lane];
  ATPU_PHASE(5, "write-back");
}

}  // namespace

extern "C" int atpu_kraft_absorb(const void* nbs, const void* d0, void* nbs2,
                                 void* dout, int n, int nsym, int maxlen,
                                 void* stream) {
  if (n <= 0) return 0;
  if (nsym < 1 || maxlen < 1 || maxlen > 30) return (int)cudaErrorInvalidValue;
  const int words = kraft_words(nsym);
  const int warps = min(kKraftWarps, kKraftSmem / (words * 4));
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const bool vec = (nsym & 3) == 0 && ((uintptr_t)nbs & 15) == 0;
  kraft_absorb_kernel<<<(n + warps - 1) / warps, warps * 32,
                        warps * words * (int)sizeof(int32_t),
                        (cudaStream_t)stream>>>(
      (const int32_t*)nbs, (const int32_t*)d0, (int32_t*)nbs2,
      (int32_t*)dout, n, nsym, maxlen, words, vec);
  return (int)cudaGetLastError();
}

extern "C" int atpu_weights_fse_encode(const void* weights, const void* nxt,
                                       const void* dnb, const void* dfs,
                                       void* buf, void* size, int n, int nsym,
                                       void* stream) {
  if (n <= 0) return 0;
  if (nsym < 1 || nsym > kWSymMax || ((uintptr_t)buf & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  weights_fse_encode_kernel<<<(n + kWWarps - 1) / kWWarps, kWWarps * 32, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)weights, (const int32_t*)nxt, (const int32_t*)dnb,
      (const int32_t*)dfs, (uint8_t*)buf, (int32_t*)size, n, nsym);
  return (int)cudaGetLastError();
}
