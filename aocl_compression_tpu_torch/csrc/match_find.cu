// The match finder of every device encoder, as three kernels.
//
// Replaces the JAX package's _find_matches (XLA code there, not a Pallas
// kernel): aocl_compression_tpu/ops/lz4_device.py:138-243. For each block
// of a batch and each position p it finds the best earlier match: the
// `depth` previous positions with p's hash (nearest first; a candidate whose
// 4-byte window differs from p's, or that lies past max_off, is skipped but
// counts), the common prefix of the row from the candidate and from p (the
// row read as B bytes followed by zeros) capped at 4 + 4*nw bytes, a
// strictly longer match winning; then exact run lengths at the small
// offsets, the saturated-match ladder and the end-of-block rules.
//
// The port's plain version (ops/lz4_device._match_*_plain) sorts each row's
// keys with torch.sort and carries nw+1 window-word tensors of the whole
// batch through the sort, shifting them once per candidate: several hundred
// passes over N x B int32 tensors. The function itself needs the input
// bytes, the keys and the outputs. So:
//   match_keys        a thread-block cluster a row (8 CTAs for a lone row,
//                     one from 67 rows on) gives the row's keys (hash << 16
//                     | p, the JAX package's int32) already in ascending
//                     order, as torch.sort of them would: a stable LSD
//                     counting sort of the positions by the hash's 8-bit
//                     digits (one pass at hash_bits <= 8, two above) in
//                     shared memory (each CTA: the row's bytes, its share of
//                     the positions between the passes as 16-bit words,
//                     per-warp digit counts); each warp counts and then
//                     places a run of consecutive 32-element tiles, a lane
//                     at its digit's next slot plus its rank among the
//                     lanes of its tile with the same digit (nine ballots),
//                     the CTAs' digit counts combined through distributed
//                     shared memory, so equal hashes keep position order
//                     without any sort;
//   match_candidates  a CTA a (row, slice of sorted entries) stages the row's
//                     bytes and 4*nw+8 zero bytes in shared memory (65,680
//                     B at B = 65,536, nw = 32); a warp takes consecutive
//                     sorted entries, one a lane, behind a halo of the
//                     min(depth, 16) entries before them, so candidate s of
//                     the entry in lane l is the entry in lane l - s; each
//                     lane loads its own window once, word by word as the
//                     warp's compares first reach it (kept in registers:
//                     the kernel is instantiated for nw <= 8, 16 and 32),
//                     and compares it with candidate s's window taken by
//                     __shfl_up_sync, while a warp vote says some lane is
//                     still equal (words past 32 and candidates past the
//                     halo are compared in shared memory); it writes
//                     (offset << 16 | length) at position p, one word a
//                     position (the sorted positions are a permutation);
//   match_runs        a thread-block cluster a row (16 CTAs up to 8 rows,
//                     one from 67 rows on; with the ladder at least 2 at
//                     B = 65,536), each CTA a slice of the positions with its
//                     bytes in shared memory and each warp a run of
//                     32-position tiles: a disagreement mask per tile and
//                     offset from one ballot, the first disagreement of each
//                     warp and CTA, a suffix minimum over the CTAs
//                     (distributed shared memory) and the warps, then each
//                     warp walks its tiles backwards carrying the next
//                     disagreement, so every lane gets its run length from
//                     its tile's mask; the best candidate is replaced by a
//                     longer run; then (ext_passes > 0) the ladder on chip:
//                     the combined results as one 32-bit word a position in
//                     shared memory, the link bitmap and its doublings at
//                     strides CAPV * 2^p (CAPV = 4 + 4*nw), each position's
//                     descent over them; the end-of-block rules write the
//                     outputs.
// What bounds them: bytes (each reads the input once and writes its outputs
// once). match_keys' passes are warp instructions on shared memory;
// match_candidates' compares are shuffles between registers, its result
// stores are scattered (one 4-byte word at each position of the
// permutation), and so are match_keys' last pass's key stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks of match_runs for scripts/match_runs_phases.py, which
// defines them in an instrumented copy; nothing here.
#ifndef ATPU_PHASES
#define ATPU_PHASE_BEGIN()
#define ATPU_PHASE(I, NAME)
#endif

namespace {

namespace cg = cooperative_groups;

constexpr uint32_t kHashMul = 2654435761u;
constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;
constexpr int kMaxOffsets = 8;       // small offsets match_runs takes
constexpr int kKeyThreads = 1024;    // match_keys: a CTA of a row's cluster
constexpr int kKeyWarps = kKeyThreads / 32;
constexpr int kMaxCluster = 8;       // match_keys' CTAs a row
constexpr int kDigits = 256;          // 8-bit digits of the hash
// a digit's count in each warp, then (column kKeyWarps) in the CTA
constexpr int kHistStride = kKeyWarps + 1;
constexpr int kHistWords = kDigits * kHistStride;
constexpr int kCandThreads = 512;
constexpr int kMaxHalo = 16;         // candidates a lane takes by shuffles
constexpr int kMinSlice = 256;       // sorted entries a CTA at the least
constexpr int kMaxRunThreads = 1024;
constexpr int kMaxRunCluster = 16;   // match_runs' CTAs a row by the SMs
constexpr int kMaxClusterHw = 16;    // a cluster's most CTAs (non-portable)
// tiles of best candidates in flight a warp (twice as many in the ladder's
// instantiation, which has registers to spare at one CTA an SM)
constexpr int kRunAhead = 4;
constexpr int kMaxSmem = 232448;     // a block's most dynamic shared memory
constexpr int kMaxDevices = 64;

struct SmallOffsets {
  int o[kMaxOffsets];
};

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// dst[0, B) = the row, dst[B, total) = 0.
__device__ void stage_row(uint8_t* dst, const uint8_t* __restrict__ src,
                          int B, int total) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (B & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < B / 16; i += blockDim.x)
      d[i] = __ldg(s + i);
  } else {
    for (int i = threadIdx.x; i < B; i += blockDim.x) dst[i] = src[i];
  }
  for (int i = B + threadIdx.x; i < total; i += blockDim.x) dst[i] = 0;
}

// The little-endian word at byte x of the staged row.
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int x) {
  return __funnelshift_r(w[x >> 2], w[(x >> 2) + 1], (x & 3) * 8);
}

// Common prefix, in bytes, of the staged row from a and from b, at most
// 4 * nwords (the JAX package's word-chain compare: a mismatching word adds
// its count of low equal bytes).
__device__ __forceinline__ int common_bytes(const uint32_t* w, int a, int b,
                                            int nwords) {
  const int wa = a >> 2, sa = (a & 3) * 8;
  const int wb = b >> 2, sb = (b & 3) * 8;
  uint32_t la = w[wa], lb = w[wb];
  for (int k = 0; k < nwords; ++k) {
    const uint32_t ha = w[wa + k + 1], hb = w[wb + k + 1];
    const uint32_t x =
        __funnelshift_r(la, ha, sa) ^ __funnelshift_r(lb, hb, sb);
    if (x) return 4 * k + ((__ffs(x) - 1) >> 3);
    la = ha;
    lb = hb;
  }
  return 4 * nwords;
}

// The lanes of a warp whose 8-bit digit d equals this lane's (lanes with
// valid false match only each other): nine ballots, which beat one
// __match_any_sync a tile on the main shape on an H100 (PERF.md §6).
__device__ __forceinline__ unsigned same_digit(uint32_t d, bool valid) {
  unsigned m = __ballot_sync(~0u, valid);
  m = valid ? m : ~m;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned x = __ballot_sync(~0u, (d >> b) & 1);
    m &= (d >> b) & 1 ? x : ~x;
  }
  return m;
}

// Inclusive prefix sum over a warp.
__device__ __forceinline__ uint32_t warp_scan(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// One stable counting pass by an 8-bit digit over this CTA's elements
// [e0, e1) of a row whose elements the cluster's CTAs share in order. Each
// warp takes a run of consecutive 32-element tiles and counts its digits:
// the lanes of a tile with one digit form a group, whose lowest lane adds
// the group's size to the warp's count. Each digit's first slot in this CTA
// is the count of smaller digits in the whole cluster plus the count of the
// digit in the CTAs before this one (read from their shared memory), and
// each warp's is that plus the warps' before it; the warp then places its
// tiles in order, a lane at its digit's next slot plus its rank in its
// group: equal digits keep their order. elem(e, d, v) gives element e's
// digit d and value v; put(slot, v).
template <typename Elem, typename Put>
__device__ void counting_pass(cg::cluster_group& cluster, int e0,
                              int e1, uint32_t* hist, uint32_t* sums,
                              Elem elem, Put put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (e1 - e0 + 31) >> 5;
  const int per = (ntiles + kKeyWarps - 1) / kKeyWarps;
  const int t0 = min(ntiles, warp * per), t1 = min(ntiles, t0 + per);
  uint32_t* col = hist + warp;
  for (int i = threadIdx.x; i < kHistWords; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const int e = e0 + t * 32 + lane;
    uint32_t d = 0, v = 0;
    if (e < e1) elem(e, d, v);
    const unsigned peers = same_digit(d, e < e1);
    if (e < e1 && lane == __ffs(peers) - 1)
      col[d * kHistStride] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  uint32_t* total = hist + kKeyWarps;    // column kKeyWarps: the CTA's count
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    uint32_t c = 0;
    for (int w = 0; w < kKeyWarps; ++w) c += hist[d * kHistStride + w];
    total[d * kHistStride] = c;
  }
  cluster.sync();
  // thread d: the digit's count in the cluster and in the CTAs before this
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int d = threadIdx.x;
  uint32_t all = 0, before = 0;
  if (d < kDigits) {
    for (int q = 0; q < K; ++q) {
      const uint32_t c = *cluster.map_shared_rank(total + d * kHistStride, q);
      all += c;
      before += q < rank ? c : 0;
    }
  }
  const uint32_t incl = warp_scan(all);   // over the digits (warps 0-7)
  if (lane == 31) sums[warp] = incl;
  cluster.sync();    // every CTA has read the totals before they change
  if (d < kDigits) {
    uint32_t below = incl - all;
    for (int w = 0; w < warp; ++w) below += sums[w];
    total[d * kHistStride] = below + before;
  }
  __syncthreads();
  for (int dd = warp; dd < kDigits; dd += kKeyWarps) {
    const uint32_t c = hist[dd * kHistStride + lane];
    const uint32_t x = warp_scan(c);
    hist[dd * kHistStride + lane] = total[dd * kHistStride] + x - c;
  }
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const int e = e0 + t * 32 + lane;
    uint32_t d = 0, v = 0;
    if (e < e1) elem(e, d, v);
    const unsigned peers = same_digit(d, e < e1);
    const uint32_t slot = e < e1 ? col[d * kHistStride] : 0;
    __syncwarp();
    if (e < e1) {
      put(slot + __popc(peers & ((1u << lane) - 1)), v);
      if (lane == __ffs(peers) - 1) col[d * kHistStride] = slot + __popc(peers);
    }
    __syncwarp();
  }
  cluster.sync();    // the slots written, in this CTA and in the others
}

// A cluster of K CTAs a row; CTA c takes the row's elements [c*E, (c+1)*E)
// in each pass, E a whole number of tiles.
__global__ void __launch_bounds__(kKeyThreads)
match_keys_kernel(const uint8_t* __restrict__ data, int32_t* __restrict__ key,
                  int B, int hash_bits, int E) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int stage = round16(B + 8);
  const bool two = hash_bits > 8;
  uint16_t* pos = reinterpret_cast<uint16_t*>(smem + stage);
  uint32_t* hist = reinterpret_cast<uint32_t*>(
      smem + stage + (two ? round16(2 * E) : 0));
  uint32_t* sums = hist + kHistWords;
  const long long r = blockIdx.x / K;
  const int e0 = min(B, rank * E), e1 = min(B, e0 + E);
  stage_row(smem, data + r * B, B, stage);
  __syncthreads();
  const uint32_t* w = reinterpret_cast<const uint32_t*>(smem);
  const int shift = 32 - hash_bits;
  // the keys' order as int32: at 16 bits the wrap puts h >= 32,768 first
  const uint32_t flip = hash_bits == 16 ? 0x8000u : 0u;
  int32_t* out = key + r * B;
  const auto bucket = [&](int p) {
    return ((word_at(w, p) * kHashMul) >> shift) ^ flip;
  };
  const auto key_of = [&](int p, uint32_t b) {
    return ((b ^ flip) << 16) | (uint32_t)p;
  };
  const auto store = [&](uint32_t slot, uint32_t v) {
    out[slot] = (int32_t)v;
  };
  if (!two) {
    counting_pass(cluster, e0, e1, hist, sums,
                  [&](int e, uint32_t& d, uint32_t& v) {
                    d = bucket(e);
                    v = key_of(e, d);
                  }, store);
    return;
  }
  // the low digit into the positions in shared memory (slot s in CTA s / E),
  // then the high one
  counting_pass(cluster, e0, e1, hist, sums,
                [&](int e, uint32_t& d, uint32_t& v) {
                  d = bucket(e) & 255;
                  v = e;
                }, [&](uint32_t slot, uint32_t v) {
                  if (K == 1) {
                    pos[slot] = (uint16_t)v;
                  } else {
                    const int q = (int)slot / E;
                    cluster.map_shared_rank(pos, q)[slot - q * E] =
                        (uint16_t)v;
                  }
                });
  counting_pass(cluster, e0, e1, hist, sums,
                [&](int e, uint32_t& d, uint32_t& v) {
                  const int p = pos[e - e0];
                  const uint32_t b = bucket(p);
                  d = b >> 8;
                  v = key_of(p, b);
                }, store);
}

// A warp takes the sorted entries [t0, t0 + 32 - halo) of its row, one a
// lane from lane `halo` on; lanes 0..halo-1 hold the halo entries before
// them, so candidate s <= halo of the entry in lane l sits in lane l - s.
// Each lane's window win[i] = the word at p + 4i is loaded from the staged
// row when the warp's compares first reach word i, and candidate s's words
// come by __shfl_up_sync(..., s); a warp vote stops the candidates once no
// lane's entries still share its hash, and a candidate's words once no lane
// is still equal. Words past kNw (nw > 32) and candidates past the halo
// (depth > 16) are compared in shared memory by the lane alone.
template <int kNw>
__global__ void __launch_bounds__(kCandThreads)
match_candidates_kernel(const uint8_t* __restrict__ data,
                        const int32_t* __restrict__ skey,
                        int32_t* __restrict__ best, int B, int slices,
                        int slice, int stage, int depth, int nw, int nw_deep,
                        int max_off) {
  extern __shared__ __align__(16) uint8_t row[];
  const long long r = blockIdx.x / slices;
  const int j0 = (blockIdx.x % slices) * slice;
  const int j1 = min(B, j0 + slice);
  stage_row(row, data + r * B, B, stage);
  __syncthreads();
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int32_t* sk = skey + r * B;
  int32_t* out = best + r * B;
  const int nw_far = nw_deep ? min(nw, nw_deep) : nw;
  const int lane = threadIdx.x & 31;
  const int halo = min(depth, kMaxHalo);
  const int fresh = 32 - halo;    // new entries a tile
  const int stride = (blockDim.x >> 5) * fresh;
  for (int t0 = j0 + (threadIdx.x >> 5) * fresh; t0 < j1; t0 += stride) {
    const int j = t0 - halo + lane;
    const bool mine = lane >= halo && j < j1;
    const uint32_t k = j >= 0 && j < B ? (uint32_t)sk[j] : 0u;
    const uint32_t h = j >= 0 && j < B ? k >> 16 : ~0u;   // ~0u: no entry
    const int p = k & 0xFFFF;
    const int sh = (p & 3) * 8;
    const uint32_t* pw = w + (p >> 2);
    uint32_t win[kNw + 1];
    uint32_t lo = pw[1];
    win[0] = __funnelshift_r(pw[0], lo, sh);
    int loaded = 1;
    int blen = 0, boff = 1;
    bool alive = mine;    // the entries between this one and s share its hash
    for (int s = 1; s <= halo; ++s) {
      const uint32_t ch = __shfl_up_sync(~0u, h, s);
      const int q = __shfl_up_sync(~0u, p, s);
      const uint32_t c0 = __shfl_up_sync(~0u, win[0], s);
      alive = alive && ch == h;
      if (!__any_sync(~0u, alive)) break;
      const int off = p - q;
      const bool ok = alive && !(max_off && off > max_off) && c0 == win[0];
      const int nws = s == 1 ? nw : nw_far;
      // word `at` (0: none) is the first that differs, by x; the warp
      // votes every 4 words, where it also loads the next 4 of its window
      bool live = ok;
      int at = 0;
      uint32_t xm = 0;
#pragma unroll
      for (int i = 1; i <= kNw; ++i) {
        if (i > nws) break;
        if ((i & 3) == 1) {
          if (!__any_sync(~0u, live)) break;
          if (i >= loaded) {    // the warp's first compare of words i..i+3
#pragma unroll
            for (int u = i; u < i + 4 && u <= kNw; ++u) {
              if (u > nw) break;    // the row is staged to 4*nw+8 past B
              const uint32_t hi = pw[u + 1];
              win[u] = __funnelshift_r(lo, hi, sh);
              lo = hi;
            }
            loaded = i + 4;
          }
        }
        const uint32_t x = win[i] ^ __shfl_up_sync(~0u, win[i], s);
        const bool miss = live && x;
        at = miss ? i : at;
        xm = miss ? x : xm;
        live = live && !x;
      }
      int len = at ? 4 * at + ((__ffs(xm) - 1) >> 3)
                   : kMinMatch + 4 * min(nws, kNw);
      if (live && nws > kNw)
        len += common_bytes(w, p + 4 * (kNw + 1), q + 4 * (kNw + 1),
                            nws - kNw);
      if (ok && len > blen) {
        blen = len;
        boff = off;
      }
    }
    for (int s = halo + 1; s <= depth && alive && j - s >= 0; ++s) {
      const uint32_t k2 = (uint32_t)sk[j - s];
      if ((k2 >> 16) != h) break;
      const int q = k2 & 0xFFFF;
      const int off = p - q;
      if (max_off && off > max_off) continue;
      if (word_at(w, q) != win[0]) continue;
      const int len = kMinMatch + common_bytes(w, p + 4, q + 4, nw_far);
      if (len > blen) {
        blen = len;
        boff = off;
      }
    }
    if (mine) out[p] = (int32_t)(((uint32_t)boff << 16) | (uint32_t)blen);
  }
}

__device__ __forceinline__ void finish(int i, int blen, int boff, int n,
                                       int32_t* mlen, int32_t* moff,
                                       bool* valid) {
  const int len = min(blen, n - kLastLiterals - i);
  const bool v = len >= kMinMatch && i <= n - kMfLimit - 1 && i < n;
  mlen[i] = v ? len : 1;
  moff[i] = max(boff, 1);
  valid[i] = v;
}

// The split halves of cluster.sync(): this CTA's threads are done reading
// the other CTAs' shared memory; the wait before exit keeps this CTA's own
// shared memory alive until the others are done with it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// A cluster of K CTAs a row; CTA c takes the positions [c*E, (c+1)*E), E a
// whole number of 32-position tiles, with its bytes and the `halo` bytes
// before them (the largest small offset) staged in shared memory. Each
// warp takes a run of consecutive tiles.
//
// Runs: per small offset, one ballot a tile gives the tile's disagreement
// mask; each warp finds its first disagreement, the CTA's first goes to
// shared memory, and after a cluster barrier each CTA takes the minimum of
// the CTAs after it (distributed shared memory) and of the warps after it:
// the next disagreement past the warp's tiles. Each warp then walks its
// tiles backwards carrying it, so every lane has its run length from its
// tile's mask; the best candidate (read a few tiles ahead, the first
// group before the staging barrier) is replaced by a longer run. Without
// the ladder two CTAs of 1,024 threads share an SM (32 registers), as a
// CTA a row of 65,536 needs at 256 rows to take one wave.
//
// The ladder (kLadder, `levels` = P > 0) keeps everything on chip: the
// combined (off << 16 | len) of each position in shared memory (off <
// 65,536; a run at i >= 1 is at most 65,535, at i = 0 it is 0), then the
// link bitmap link_0[i] = i + CAPV < B, len[i] >= CAPV, off[i + CAPV] ==
// off[i] (one ballot a tile; i + CAPV may lie in a later CTA), the doubled
// bitmaps link_{p+1}[i] = link_p[i] & link_p[i + CAPV * 2^p] built word by
// word with funnel shifts (a cluster barrier a level), and each position's
// descent from p = P - 1 to 0, jumping CAPV * 2^p wherever link_p holds at
// the current j: min(links, 2^P - 1) links in P shared loads, the JAX
// package's pointer doubling (aocl_compression_tpu/ops/lz4_device.py:
// 229-237) unrolled. The landing j may lie in any CTA of the cluster.
template <bool kLadder>
__global__ void
__launch_bounds__(kMaxRunThreads, kLadder ? 1 : 2)
match_runs_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ best,
                  const int32_t* __restrict__ nlen, int32_t* __restrict__ mlen,
                  int32_t* __restrict__ moff, bool* __restrict__ valid, int B,
                  SmallOffsets offs, int noffs, int halo, int E, int stage,
                  int levels, int capv) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int first[kMaxOffsets][32];   // each warp's first disagreement
  __shared__ int cta_first[kMaxOffsets];   // this CTA's, for the CTAs before
  __shared__ int after[kMaxOffsets];       // the CTAs' after this one
  ATPU_PHASE_BEGIN();
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long r = blockIdx.x / K;
  const int base = rank * E;
  const int e1 = min(B, base + E), e0 = min(base, e1);
  const int lo = max(0, e0 - halo);
  const uint8_t* src = data + r * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ntiles = (e1 - e0 + 31) >> 5;
  const int per = (ntiles + nwarps - 1) / nwarps;
  const int t0 = min(ntiles, warp * per), t1 = min(ntiles, t0 + per);
  const int n = nlen[r];
  best += r * B;
  mlen += r * B;
  moff += r * B;
  valid += r * B;

  // bytes [lo, e1) of the row into row[0, e1 - lo)
  uint8_t* row = smem;
  {
    const uint8_t* s = src + lo;
    const int len = e1 - lo;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      for (int i = threadIdx.x; i < len / 16; i += blockDim.x)
        reinterpret_cast<uint4*>(row)[i] =
            __ldg(reinterpret_cast<const uint4*>(s) + i);
      done = len & ~15;
    }
    for (int i = done + threadIdx.x; i < len; i += blockDim.x)
      row[i] = __ldg(s + i);
  }
  // the best candidates of the warp's last `kAhead` tiles, in flight
  // through the staging and the first-disagreement pass
  constexpr int kAhead = kLadder ? 2 * kRunAhead : kRunAhead;
  uint32_t ahead[kAhead];
  const auto fetch = [&](int top) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = top - 1 - u;
      const int i = e0 + t * 32 + lane;
      ahead[u] = t >= t0 && i < B ? (uint32_t)__ldg(best + i) : 1u << 16;
    }
  };
  fetch(t1);
  const auto disagrees = [&](int i, int o) {
    return i < B && (i < o || row[i - lo] != row[i - o - lo]);
  };
  __syncthreads();
  ATPU_PHASE(1, "staging");

  // the first disagreement of each warp's tiles, per offset (B if none)
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    if (k >= noffs) break;
    int f = B;
    for (int t = t0; t < t1; ++t) {
      const unsigned m =
          __ballot_sync(~0u, disagrees(e0 + t * 32 + lane, offs.o[k]));
      if (m) {
        f = e0 + t * 32 + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) first[k][warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < noffs; ++k) {
      const int m = __reduce_min_sync(~0u, lane < nwarps ? first[k][lane] : B);
      if (lane == 0) cta_first[k] = m;
    }
  }
  ATPU_PHASE(2, "first disagreement");
  cluster.sync();
  if ((int)threadIdx.x < noffs) {
    int m = B;
    for (int q = rank + 1; q < K; ++q)
      m = min(m, *cluster.map_shared_rank(&cta_first[threadIdx.x], q));
    after[threadIdx.x] = m;
  }
  if (!kLadder) cluster_arrive();    // the last read of another CTA
  __syncthreads();
  // the next disagreement after this warp's tiles
  int carry[kMaxOffsets];
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    if (k >= noffs) break;
    const int f = (lane > warp && lane < nwarps) ? first[k][lane] : B;
    carry[k] = min(after[k], __reduce_min_sync(~0u, f));
  }
  ATPU_PHASE(3, "cluster and warp carries");

  uint32_t* pk = reinterpret_cast<uint32_t*>(smem + stage);    // E words
  for (int top = t1; top > t0; top -= kAhead) {
    if (top < t1) fetch(top);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = top - 1 - u;
      if (t < t0) break;
      const int i = e0 + t * 32 + lane;
      int blen = ahead[u] & 0xFFFF, boff = ahead[u] >> 16;
#pragma unroll
      for (int k = 0; k < kMaxOffsets; ++k) {
        if (k >= noffs) break;
        const unsigned m = __ballot_sync(~0u, disagrees(i, offs.o[k]));
        const unsigned at = m & (~0u << lane);
        const int nxt = at ? e0 + t * 32 + __ffs(at) - 1 : carry[k];
        if (m) carry[k] = e0 + t * 32 + __ffs(m) - 1;
        const int run = nxt - i;
        if (run >= kMinMatch && run > blen) {
          blen = run;
          boff = offs.o[k];
        }
      }
      if (i >= e1) continue;
      if (kLadder)
        pk[i - base] = (uint32_t)boff << 16 | (uint32_t)blen;
      else
        finish(i, blen, boff, n, mlen, moff, valid);
    }
  }
  if (!kLadder) {
    cluster_wait();
    ATPU_PHASE(4, "backward pass");
    return;
  }
  cluster.sync();
  ATPU_PHASE(4, "backward pass");

  // The combined result at any position x < B of the row, and word g of a
  // bitmap level (0 past the row), from this CTA or another of the cluster.
  const int W = E >> 5;
  uint32_t* lk = pk + E;    // levels x W words
  const auto packed = [&](int x) -> uint32_t {
    const unsigned d = (unsigned)(x - base);
    if (d < (unsigned)E) return pk[d];
    const int q = x / E;
    return *cluster.map_shared_rank(pk + (x - q * E), q);
  };
  const auto word = [&](const uint32_t* level, int g) -> uint32_t {
    const unsigned d = (unsigned)(g - rank * W);
    if (d < (unsigned)W) return level[d];
    if (g >= K * W) return 0u;
    const int q = g / W;
    return *cluster.map_shared_rank(level + (g - q * W), q);
  };
  for (int t = warp; t < W; t += nwarps) {
    const int i = base + t * 32 + lane;
    bool link = false;
    if (i + capv < B) {
      const uint32_t v = pk[i - base];
      link = (int)(v & 0xFFFF) >= capv && (packed(i + capv) >> 16) == v >> 16;
    }
    const unsigned m = __ballot_sync(~0u, link);
    if (lane == 0) lk[t] = m;
  }
  cluster.sync();
  ATPU_PHASE(5, "links");
  for (int p = 1; p < levels; ++p) {
    const uint32_t* prev = lk + (p - 1) * W;
    const int s = capv << (p - 1);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const int g = rank * W + w + (s >> 5);
      lk[p * W + w] = prev[w] & __funnelshift_r(word(prev, g),
                                                word(prev, g + 1), s & 31);
    }
    cluster.sync();
  }
  ATPU_PHASE(6, "doubling");
  for (int i = base + (int)threadIdx.x; i < e1; i += blockDim.x) {
    const uint32_t v = pk[i - base];
    int len = v & 0xFFFF;
    if (lk[(i - base) >> 5] >> (i & 31) & 1) {    // link_p[i] needs link_0[i]
      int j = i;
      for (int p = levels - 1; p >= 0; --p)
        if (word(lk + p * W, j >> 5) >> (j & 31) & 1) j += capv << p;
      len = (j - i) + (int)(packed(j) & 0xFFFF);
    }
    finish(i, len, (int)(v >> 16), n, mlen, moff, valid);
  }
  cluster.sync();
  ATPU_PHASE(7, "descent and finish");
}

// Above 48 KB a kernel needs the opt-in, once per device and kernel (set
// outside any stream capture: the first call of a process is eager): all
// the dynamic shared memory the block's static share leaves.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, bool* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

// How match_runs lays a batch out on the current device: K CTAs a row (a
// cluster) of `threads` threads, E positions and `halo` bytes before them a
// CTA, `stage` bytes of the staged span, `smem` bytes of dynamic shared
// memory a CTA (the span; with the ladder also E combined words and
// `levels` bitmaps of E / 32 words), `levels` = P doubled link bitmaps (0:
// no ladder).
struct RunsPlan {
  SmallOffsets offs;
  int k, e, halo, stage, smem, threads, levels, capv;
};

// K: the largest power of two up to kMaxRunCluster with n * K CTAs on at
// most one per SM and a tile a CTA; with the ladder, doubled while a CTA's
// share does not fit in shared memory (a row of 65,536 needs K >= 2).
cudaError_t runs_plan(int n, int b, const int* offsets, int noffs,
                      int ext_passes, int nw, RunsPlan* p) {
  if (b > 65536 || noffs < 0 || noffs > kMaxOffsets || ext_passes < 0 ||
      nw < 0)
    return cudaErrorInvalidValue;
  p->offs = {};
  int maxo = 1;
  for (int k = 0; k < noffs; ++k) {
    if (offsets[k] < 1) return cudaErrorInvalidValue;
    p->offs.o[k] = offsets[k];
    maxo = max(maxo, offsets[k]);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // the SMs, and the most dynamic shared memory a CTA can take (the two
  // instantiations' static share is the same)
  static int sms[kMaxDevices] = {}, limit[kMaxDevices] = {};
  if (!limit[dev]) {
    int s = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, match_runs_kernel<true>);
    if (err != cudaSuccess) return err;
    sms[dev] = s;
    limit[dev] = kMaxSmem - (int)attr.sharedSizeBytes;
  }
  const long long capv = kMinMatch + 4LL * nw;
  // P = #{p < ext_passes : CAPV * 2^p < B}: the passes the JAX package runs
  int levels = 0;
  while (levels < ext_passes && (capv << levels) < b) ++levels;
  const int ntiles = (b + 31) / 32;
  int k = 1;
  while (2 * k <= kMaxRunCluster && (long long)n * 2 * k <= sms[dev] &&
         2 * k <= ntiles)
    k *= 2;
  const int halo = round16(min(maxo, b));    // an offset past B: no compare
  for (;;) {
    p->e = (ntiles + k - 1) / k * 32;
    p->stage = round16(min(b, p->e + halo));
    p->smem = p->stage + (levels ? 4 * p->e + 4 * levels * (p->e / 32) : 0);
    if (p->smem <= limit[dev] || 2 * k > kMaxClusterHw || 2 * k > ntiles)
      break;
    k *= 2;
  }
  if (p->smem > limit[dev]) return cudaErrorInvalidValue;
  p->k = k;
  p->halo = halo;
  p->threads = min(kMaxRunThreads, p->e);
  p->levels = levels;
  p->capv = (int)min(capv, (long long)b);
  return cudaSuccess;
}

}  // namespace

extern "C" int atpu_match_keys(const void* data, void* key, int n, int b,
                               int hash_bits, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (b > 65536 || hash_bits < 1 || hash_bits > 16)
    return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(match_keys_kernel, opted);
  if (err != cudaSuccess) return (int)err;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !sms[dev])
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return (int)err;
  // CTAs a row: the largest power of two up to kMaxCluster with n * K CTAs
  // on at most one per SM and a tile a warp
  const int ntiles = (b + 31) / 32;
  int k = 1;
  while (2 * k <= kMaxCluster && (long long)n * 2 * k <= sms[dev] &&
         2 * k * kKeyWarps <= ntiles)
    k *= 2;
  const int e = (ntiles + k - 1) / k * 32;
  // the row, this CTA's positions between two passes, the counts, sums
  const int smem = round16(b + 8) + (hash_bits > 8 ? round16(2 * e) : 0) +
                   4 * (kHistWords + 32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * (unsigned)k);
  cfg.blockDim = dim3(kKeyThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((long long)n * k > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg, match_keys_kernel, (const uint8_t*)data,
                           (int32_t*)key, b, hash_bits, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int atpu_match_candidates(const void* data, const void* skey,
                                     void* best, int n, int b, int depth,
                                     int nw, int nw_deep, int max_off,
                                     void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (b > 65536 || depth < 0 || nw < 0 || nw_deep < 0)
    return (int)cudaErrorInvalidValue;
  if (b + 4LL * nw + 8 > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int stage = round16(b + 4 * nw + 8);
  // the window words a lane holds in registers
  const int which = nw <= 8 ? 0 : nw <= 16 ? 1 : 2;
  const auto kernel = which == 0   ? match_candidates_kernel<8>
                      : which == 1 ? match_candidates_kernel<16>
                                   : match_candidates_kernel<32>;
  static bool opted[3][kMaxDevices] = {};
  cudaError_t err = opt_in(kernel, opted[which]);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // enough CTAs to fill the card, each with at least kMinSlice entries
  int slices = 1;
  while (2 * slices * kMinSlice <= b && (long long)n * slices < 4LL * sms)
    slices *= 2;
  const int slice = (b + slices - 1) / slices;
  const long long grid = (long long)n * slices;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kCandThreads, stage, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)skey, (int32_t*)best, b, slices,
      slice, stage, depth, nw, nw_deep, max_off);
  return (int)cudaGetLastError();
}

extern "C" int atpu_match_runs(const void* data, const void* best,
                               const void* nlen, void* mlen, void* moff,
                               void* valid, int n, int b, const int* offsets,
                               int noffs, int ext_passes, int nw,
                               void* stream) {
  if (n <= 0 || b <= 0) return 0;
  RunsPlan p;
  cudaError_t err = runs_plan(n, b, offsets, noffs, ext_passes, nw, &p);
  if (err != cudaSuccess) return (int)err;
  const bool ladder = p.levels > 0;
  const auto kernel =
      ladder ? match_runs_kernel<true> : match_runs_kernel<false>;
  static bool opted[2][kMaxDevices] = {};
  err = opt_in(kernel, opted[ladder]);
  if (err == cudaSuccess && p.k > 8)    // past the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  if ((long long)n * p.k > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * (unsigned)p.k);
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.k > 1;    // one CTA a row: a plain launch
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)data,
                           (const int32_t*)best, (const int32_t*)nlen,
                           (int32_t*)mlen, (int32_t*)moff, (bool*)valid, b,
                           p.offs, noffs, p.halo, p.e, p.stage, p.levels,
                           p.capv);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The CTAs a row match_runs launches for these arguments on the current
// device (a negative CUDA error where it would refuse them).
extern "C" int atpu_match_runs_ctas(int n, int b, const int* offsets,
                                    int noffs, int ext_passes, int nw) {
  if (n <= 0 || b <= 0) return -(int)cudaErrorInvalidValue;
  RunsPlan p;
  const cudaError_t err = runs_plan(n, b, offsets, noffs, ext_passes, nw, &p);
  return err == cudaSuccess ? p.k : -(int)err;
}
