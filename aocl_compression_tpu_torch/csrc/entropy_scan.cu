// The encoders' two entropy-table scans, one thread per block (row).
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
// to step), so a row's steps cannot be split; the port's plain PyTorch loop
// launches every op of every step from the host. Bound: the chain of one
// row, a few hundred steps of integer ALU work and one shared-memory load,
// not HBM bytes (a few hundred KB a call). Design: rows run in parallel,
// one thread a row, 32 rows to a CUDA block (one warp runs the chains in
// lockstep: the steps have no data-dependent branch). The block's 128
// threads stage its rows into shared memory with coalesced loads (an odd
// word stride between rows, so the warp's 32 reads of one step fall in 32
// banks), the chains read and write only shared memory and registers, and
// the block writes its rows back coalesced.
//
// The arithmetic follows the plain versions (ops/deflate_device.
// _kraft_absorb_plain, ops/zstd_device._encode_weights_plain), which follow
// the JAX package: int32 throughout; D may be negative (the JAX package's
// share wraps in int32 for a 65,536-count symbol), and D >> sh is an
// arithmetic shift, JAX's floor division by the power of two c. JAX's
// floor_log2 ladder saturates at MAXLEN; 31 - clz(q) equals it here because
// k is capped at nb - 1 <= MAXLEN - 1 before it is used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows (blocks of the codec) a CUDA block takes
constexpr int kThreads = 128;  // threads that stage and write back

// --- kraft_absorb ------------------------------------------------------------
//
// Per row, over the sorted code lengths nb = nbs[s], s = 0..nsym-1:
//   c = nb > 0 ? 1 << (MAXLEN - max(nb, 1)) : 0
//   q = max(c > 0 ? (D >> (MAXLEN - max(nb, 1))) + 1 : 1, 1)
//   k = min(floor_log2(q), max(nb - 1, 0))
//   D -= c * ((1 << k) - 1);  nbs2[s] = nb - k
// nbs must lie in [0, maxlen] (the callers' lengths do).
__global__ void __launch_bounds__(kThreads)
kraft_absorb_kernel(const int32_t* __restrict__ nbs,
                    const int32_t* __restrict__ d0, int32_t* __restrict__ nbs2,
                    int32_t* __restrict__ dout, int n, int nsym, int maxlen) {
  extern __shared__ int32_t s_nb[];  // kRows rows of `stride` words
  const int stride = nsym | 1;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int cells = rows * nsym;
  const int32_t* src = nbs + (size_t)row0 * nsym;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int r = i / nsym;
    s_nb[r * stride + (i - r * nsym)] = src[i];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    int32_t* row = s_nb + threadIdx.x * stride;
    int D = d0[row0 + threadIdx.x];
    for (int j = 0; j < nsym; ++j) {
      const int nb = row[j];
      const int sh = maxlen - max(nb, 1);
      const int c = nb > 0 ? 1 << sh : 0;
      const int q = max(c > 0 ? (D >> sh) + 1 : 1, 1);
      const int k = min(31 - __clz(q), max(nb - 1, 0));
      D -= c * ((1 << k) - 1);
      row[j] = nb - k;
    }
    dout[row0 + threadIdx.x] = D;
  }
  __syncthreads();
  int32_t* dst = nbs2 + (size_t)row0 * nsym;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int r = i / nsym;
    dst[i] = s_nb[r * stride + (i - r * nsym)];
  }
}

// --- weights_fse_encode ------------------------------------------------------

constexpr int kWNum = 255;      // weights a row (symbol 255's is implicit)
constexpr int kWStride = 260;   // bytes between staged rows: 65 words, odd
constexpr int kWCap = 512;      // output bytes a row
constexpr int kWWords = kWCap / 4;
constexpr int kOutStride = kWWords + 1;  // words between output rows, odd
constexpr int kWStates = 64;    // 1 << WEIGHT_LOG
constexpr int kWLog = 6;        // WEIGHT_LOG
constexpr int kWSymMax = 16;    // room for the table's symbols (12)

// LSB-first bit writer into a row of 32-bit words in shared memory.
struct BitWriter {
  uint32_t* out;
  uint64_t acc = 0;
  int nacc = 0;
  int word = 0;
  int total = 0;
  __device__ __forceinline__ void put(uint32_t val, int nbits) {
    acc |= (uint64_t)val << nacc;
    nacc += nbits;
    total += nbits;
    if (nacc >= 32) {
      out[word++] = (uint32_t)acc;
      acc >>= 32;
      nacc -= 32;
    }
  }
  __device__ __forceinline__ void flush() {
    if (nacc > 0) out[word] = (uint32_t)acc;
  }
};

// Per row: init(w[254]) into state 1 and init(w[253]) into state 2, one enc
// of state 1 at 252, then 126 pairs: state 2 at 251 - 2t, state 1 at
// 250 - 2t; the fields in that order, then both final states less 64 in
// WEIGHT_LOG bits each (state 2 first) and one closing 1 bit. The fields
// never overlap, so this sequential writer equals the plain version's
// scatter-add packing. size = (total + 1 + 7) >> 3. Weights are clamped to
// the table's symbols and state indices to the table (the plain version
// takes weights in [0, nsym) only, where neither clamp acts).
__global__ void __launch_bounds__(kThreads)
weights_fse_encode_kernel(const int32_t* __restrict__ weights,
                          const int32_t* __restrict__ nxt,
                          const int32_t* __restrict__ dnb,
                          const int32_t* __restrict__ dfs,
                          uint8_t* __restrict__ buf,
                          int32_t* __restrict__ size, int n, int nsym) {
  __shared__ int32_t s_nxt[kWStates];
  __shared__ int2 s_tt[kWSymMax];
  __shared__ uint8_t s_w[kRows * kWStride];
  __shared__ uint32_t s_out[kRows * kOutStride];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int i = threadIdx.x; i < kWStates; i += kThreads) s_nxt[i] = nxt[i];
  if (threadIdx.x < nsym) s_tt[threadIdx.x] = make_int2(dnb[threadIdx.x],
                                                        dfs[threadIdx.x]);
  const int32_t* src = weights + (size_t)row0 * kWNum;
  for (int i = threadIdx.x; i < rows * kWNum; i += kThreads) {
    const int r = i / kWNum;
    s_w[r * kWStride + (i - r * kWNum)] =
        (uint8_t)min(max(src[i], 0), nsym - 1);
  }
  for (int i = threadIdx.x; i < kRows * kOutStride; i += kThreads) {
    s_out[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const uint8_t* w = s_w + threadIdx.x * kWStride;
    BitWriter bw;
    bw.out = s_out + threadIdx.x * kOutStride;
    auto init = [&](int c) {
      const int2 tt = s_tt[w[c]];
      const int nbout = (tt.x + (1 << 15)) >> 16;
      const int i = (((nbout << 16) - tt.x) >> nbout) + tt.y;
      return s_nxt[min(max(i, 0), kWStates - 1)];
    };
    auto enc = [&](int& st, int c) {
      const int2 tt = s_tt[w[c]];
      const int nb = (st + tt.x) >> 16;
      bw.put((uint32_t)(st & ((1 << nb) - 1)), nb);
      const int i = (st >> nb) + tt.y;
      st = s_nxt[min(max(i, 0), kWStates - 1)];
    };
    int st1 = init(254);
    int st2 = init(253);
    enc(st1, 252);
    for (int t = 0; t < 126; ++t) {
      enc(st2, 251 - 2 * t);
      enc(st1, 250 - 2 * t);
    }
    bw.put((uint32_t)(st2 - kWStates) & (kWStates - 1), kWLog);
    bw.put((uint32_t)(st1 - kWStates) & (kWStates - 1), kWLog);
    const int total = bw.total;
    bw.put(1u, 1);
    bw.flush();
    size[row0 + threadIdx.x] = (total + 1 + 7) >> 3;
  }
  __syncthreads();
  uint32_t* dst = reinterpret_cast<uint32_t*>(buf + (size_t)row0 * kWCap);
  for (int i = threadIdx.x; i < rows * kWWords; i += kThreads) {
    const int r = i / kWWords;
    dst[i] = s_out[r * kOutStride + (i - r * kWWords)];
  }
}

}  // namespace

extern "C" int atpu_kraft_absorb(const void* nbs, const void* d0, void* nbs2,
                                 void* dout, int n, int nsym, int maxlen,
                                 void* stream) {
  if (n <= 0) return 0;
  const int smem = kRows * (nsym | 1) * (int)sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  kraft_absorb_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const int32_t*)nbs, (const int32_t*)d0, (int32_t*)nbs2,
      (int32_t*)dout, n, nsym, maxlen);
  return (int)cudaGetLastError();
}

extern "C" int atpu_weights_fse_encode(const void* weights, const void* nxt,
                                       const void* dnb, const void* dfs,
                                       void* buf, void* size, int n, int nsym,
                                       void* stream) {
  if (n <= 0) return 0;
  if (nsym < 1 || nsym > kWSymMax) return (int)cudaErrorInvalidValue;
  weights_fse_encode_kernel<<<(n + kRows - 1) / kRows, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)weights, (const int32_t*)nxt, (const int32_t*)dnb,
      (const int32_t*)dfs, (uint8_t*)buf, (int32_t*)size, n, nsym);
  return (int)cudaGetLastError();
}
