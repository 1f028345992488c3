// The match finder of every device encoder, as three kernels around one
// library sort.
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
// The port's plain version (ops/lz4_device._match_*_plain) carries nw+1
// window-word tensors of the whole batch through the sort and shifts them
// once per candidate: several hundred passes over N x B int32 tensors. The
// function itself needs the input bytes, the keys and the outputs. So:
//   match_keys        one thread a position: the key (hash << 16 | p) as the
//                     JAX package's int32; the caller sorts each row of
//                     keys (torch.sort), which groups a hash's positions in
//                     increasing order;
//   match_candidates  a CTA a (row, slice of sorted entries) stages the row's
//                     bytes and 4*nw+8 zero bytes in shared memory (65,680
//                     B at B = 65,536, nw = 32) and gives each sorted entry
//                     to one thread, which walks the entries before it
//                     until the hash changes or depth is reached and
//                     compares bytes in place, a word at a time (two aligned
//                     shared words and a funnel shift per word); it writes
//                     (offset << 16 | length) at position p, one word a
//                     position (the sort's positions are a permutation);
//   match_runs        a CTA a row: the row in shared memory, each warp a
//                     run of 32-position tiles; a disagreement mask per tile
//                     and offset from one ballot, the first disagreement of
//                     each warp's run, a suffix minimum over the warps, then
//                     each warp walks its tiles backwards carrying the next
//                     disagreement, so every lane gets its run length from
//                     its tile's mask; the best candidate is replaced by a
//                     longer run, then (ext_passes > 0) the ladder walks
//                     forward at stride CAPV = 4 + 4*nw over a bitmap of
//                     the row's links in shared memory, and the
//                     end-of-block rules write the outputs.
// What bounds them: bytes for match_keys and match_runs (each reads the
// input once and writes its outputs once, coalesced); match_candidates'
// compares run in shared memory and its result stores are scattered (one
// 4-byte word at each position of the permutation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHashMul = 2654435761u;
constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;
constexpr int kMaxOffsets = 8;       // small offsets match_runs takes
constexpr int kKeyThreads = 256;
constexpr int kCandThreads = 512;
constexpr int kMinSlice = 512;       // sorted entries a CTA at the least
constexpr int kMaxRunThreads = 1024;
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

__global__ void __launch_bounds__(kKeyThreads)
match_keys_kernel(const uint8_t* __restrict__ data, int32_t* __restrict__ key,
                  long long total, int B, int shift) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / B;
    const int p = (int)(i - r * B);
    const uint8_t* row = data + r * B;
    uint32_t w = row[p];
    if (p + 1 < B) w |= (uint32_t)row[p + 1] << 8;
    if (p + 2 < B) w |= (uint32_t)row[p + 2] << 16;
    if (p + 3 < B) w |= (uint32_t)row[p + 3] << 24;
    const uint32_t h = (w * kHashMul) >> shift;
    key[i] = (int32_t)((h << 16) | (uint32_t)p);
  }
}

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
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const uint32_t key = (uint32_t)sk[j];
    const int p = key & 0xFFFF;
    const uint32_t h = key >> 16;
    const uint32_t w0 = word_at(w, p);
    int blen = 0, boff = 1;
    for (int s = 1; s <= depth && j - s >= 0; ++s) {
      const uint32_t k2 = (uint32_t)sk[j - s];
      if ((k2 >> 16) != h) break;    // sorting groups a hash's entries
      const int q = k2 & 0xFFFF;
      const int off = p - q;
      if (max_off && off > max_off) continue;
      if (word_at(w, q) != w0) continue;
      const int len = kMinMatch + common_bytes(w, p + 4, q + 4,
                                               s == 1 ? nw : nw_far);
      if (len > blen) {
        blen = len;
        boff = off;
      }
    }
    out[p] = (int32_t)(((uint32_t)boff << 16) | (uint32_t)blen);
  }
}

__device__ __forceinline__ bool disagrees(const uint8_t* row, int i, int o,
                                          int B) {
  return i < B && (i < o || row[i] != row[i - o]);
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

template <bool kLadder>
__global__ void __launch_bounds__(kMaxRunThreads)
match_runs_kernel(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ best,
                  const int32_t* __restrict__ nlen, int32_t* mlen,
                  int32_t* moff, bool* valid, int B, SmallOffsets offs,
                  int noffs, int ladder_steps, int capv) {
  extern __shared__ __align__(16) uint8_t row[];
  __shared__ int first[kMaxOffsets][32];
  const long long r = blockIdx.x;
  stage_row(row, data + r * B, B, round16(B));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ntiles = (B + 31) >> 5;
  const int per = (ntiles + nwarps - 1) / nwarps;
  const int t0 = min(ntiles, warp * per), t1 = min(ntiles, t0 + per);
  const int n = nlen[r];
  best += r * B;
  mlen += r * B;
  moff += r * B;
  valid += r * B;
  __syncthreads();

  // first disagreement of each warp's tiles, per offset (B if none)
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    if (k >= noffs) break;
    int f = B;
    for (int t = t0; t < t1; ++t) {
      const unsigned m = __ballot_sync(~0u, disagrees(row, t * 32 + lane,
                                                      offs.o[k], B));
      if (m) {
        f = t * 32 + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) first[k][warp] = f;
  }
  __syncthreads();

  // the next disagreement after this warp's tiles: the warps' suffix min
  int carry[kMaxOffsets];
#pragma unroll
  for (int k = 0; k < kMaxOffsets; ++k) {
    if (k >= noffs) break;
    const int f = (lane > warp && lane < nwarps) ? first[k][lane] : B;
    carry[k] = __reduce_min_sync(~0u, f);
  }

  for (int t = t1 - 1; t >= t0; --t) {
    const int i = t * 32 + lane;
    int blen = 0, boff = 1;
    if (i < B) {
      const uint32_t b = (uint32_t)best[i];
      blen = b & 0xFFFF;
      boff = b >> 16;
    }
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k) {
      if (k >= noffs) break;
      const unsigned m = __ballot_sync(~0u, disagrees(row, i, offs.o[k], B));
      const unsigned at = m & (~0u << lane);
      const int nxt = at ? t * 32 + __ffs(at) - 1 : carry[k];
      if (m) carry[k] = t * 32 + __ffs(m) - 1;
      const int run = nxt - i;
      if (run >= kMinMatch && run > blen) {
        blen = run;
        boff = offs.o[k];
      }
    }
    if (i >= B) continue;
    if (kLadder) {    // the combined results, for the ladder below
      mlen[i] = blen;
      moff[i] = max(boff, 1);
    } else {
      finish(i, blen, boff, n, mlen, moff, valid);
    }
  }
  if (!kLadder) return;

  // The saturated-match ladder: a position whose match reaches CAPV and
  // whose successor CAPV bytes on carries the same offset links to it; the
  // JAX package's ext_passes pointer-doubling passes follow at most
  // 2^ext_passes - 1 such links (ladder_steps). The links go into a bitmap
  // in shared memory (one ballot a tile), so a walk step is one shared
  // load. The walk reads forward only, so the rounds of blockDim positions
  // go in increasing order and each writes after all of its reads.
  uint32_t* links = reinterpret_cast<uint32_t*>(row + round16(B));
  __syncthreads();
  for (int t = warp; t < ntiles; t += nwarps) {
    const int i = t * 32 + lane;
    const bool link = i + capv < B && mlen[i] >= capv &&
                      moff[i + capv] == moff[i];
    const unsigned m = __ballot_sync(~0u, link);
    if (lane == 0) links[t] = m;
  }
  __syncthreads();
  for (int base = 0; base < B; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int len = 0, off = 1;
    if (i < B) {
      int j = i;
      for (int m = 0; m < ladder_steps && (links[j >> 5] >> (j & 31) & 1);
           ++m)
        j += capv;
      len = (j - i) + mlen[j];
      off = moff[i];
    }
    __syncthreads();
    if (i < B) finish(i, len, off, n, mlen, moff, valid);
  }
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

}  // namespace

extern "C" int atpu_match_keys(const void* data, void* key, int n, int b,
                               int hash_bits, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (b > 65536 || hash_bits < 1 || hash_bits > 16)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * b;
  const long long blocks = (total + kKeyThreads - 1) / kKeyThreads;
  const unsigned grid = (unsigned)(blocks < 65536 ? blocks : 65536);
  match_keys_kernel<<<grid, kKeyThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (int32_t*)key, total, b, 32 - hash_bits);
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
  static bool opted[kMaxDevices] = {};
  cudaError_t err = opt_in(match_candidates_kernel, opted);
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
  match_candidates_kernel<<<(unsigned)grid, kCandThreads, stage,
                            (cudaStream_t)stream>>>(
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
  if (b > 65536 || noffs < 0 || noffs > kMaxOffsets || ext_passes < 0 ||
      nw < 0)
    return (int)cudaErrorInvalidValue;
  SmallOffsets offs = {};
  for (int k = 0; k < noffs; ++k) {
    if (offsets[k] < 1) return (int)cudaErrorInvalidValue;
    offs.o[k] = offsets[k];
  }
  static bool opted[2][kMaxDevices] = {};
  cudaError_t err = opt_in(match_runs_kernel<false>, opted[0]);
  if (err == cudaSuccess) err = opt_in(match_runs_kernel<true>, opted[1]);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (b + 31) / 32;
  const int threads = tiles * 32 < kMaxRunThreads ? tiles * 32
                                                   : kMaxRunThreads;
  const long long capv = kMinMatch + 4LL * nw;
  // 2^ext_passes - 1 links at most, and fewer than b / capv fit in a row
  const long long steps = ext_passes == 0 ? 0
                          : ext_passes >= 17 ? b
                                             : (1LL << ext_passes) - 1;
  const int smem = round16(b) + (steps ? 4 * tiles : 0);   // row, links
  const auto kernel =
      steps ? match_runs_kernel<true> : match_runs_kernel<false>;
  kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)best, (const int32_t*)nlen,
      (int32_t*)mlen, (int32_t*)moff, (bool*)valid, b, offs, noffs,
      (int)(steps < b ? steps : b), (int)(capv < b ? capv : b));
  return (int)cudaGetLastError();
}
