// The device inflate's symbol scan, one thread per chunk lane.
//
// Replaces a lax.scan of the JAX package (not a Pallas kernel there):
//   aocl_compression_tpu/ops/inflate_device.py:121-180 (_symbol_scan, with
//   _read_fwd :74-85, _bitrev15 :91-97 and _huff_step :100-118), and the
//   compaction of its slots that follows, :183-212 (_compact).
//
// Deflate is one serial LSB-first bitstream per chunk: a symbol's position
// is known only after every earlier symbol is decoded, so a lane's steps
// cannot be split. The JAX package runs B + 4 masked steps over all lanes;
// the port's plain PyTorch loop launches every op of every step from the
// host. Here one thread runs a lane to its own end-of-block or bad code
// (one CUDA block per lane; the block's other threads load the lane's
// canonical-code parameters into shared memory and write the fixed values
// past the lane's counts). The scan meets literals and matches in slot
// order, so the thread writes the compaction's outputs directly: the
// literal buffer and the (ll, ml, off) sequence list with their counts.
// The (kind, val, dist) slots (3 x 4 x N x (B + 4) bytes) never reach
// device memory, and no sort is needed.
//
// Bound: the serial chain of dependent bit reads and code lookups of the
// longest lane (a random 64 KiB block in a static-Huffman chunk is 65,537
// literal steps), not HBM bytes: the chunk bytes are read once (through
// the read-only cache, two words per read), and the outputs written once.
//
// The arithmetic follows the plain versions (ops/inflate_device.
// _symbol_scan_plain and _compact_plain), which follow the JAX package:
// word indices clamped to the last word; no hit at any code length is a
// bad code; length symbols 286 and 287 are length 258 with no extra bits;
// a match with no distance code or a distance symbol >= 30 is bad; a bad
// code ends the lane; the literal buffer past the literal count is 0; the
// counts are not capped; offsets are clipped to [1, B].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCanon = 16;   // first code / limit / rank base per length
constexpr int kPermL = 288;  // litlen symbol permutation
constexpr int kPermD = 32;   // distance symbol permutation

__constant__ int kLenBase[29] = {3,  4,  5,  6,  7,  8,   9,   10,  11, 13,
                                 15, 17, 19, 23, 27, 31,  35,  43,  51, 59,
                                 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int kLenXbits[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
__constant__ int kDistXbits[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                   4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                   9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// Bits [pos, pos + nbits) of the lane's stream (nbits <= 15), each word
// index clamped to the lane's last word.
__device__ __forceinline__ int read_fwd(const uint32_t* __restrict__ words,
                                        int last, int pos, int nbits) {
  const int wi = pos >> 5;
  const unsigned sh = (unsigned)(pos & 31);
  const uint32_t w0 = __ldg(words + (wi < last ? wi : last));
  const uint32_t w1 = __ldg(words + (wi + 1 < last ? wi + 1 : last));
  const uint32_t v = (w0 >> sh) | (sh == 0 ? 0u : (w1 << (32 - sh)));
  return (int)(v & ((1u << nbits) - 1u));
}

// One canonical code from a 15-bit peek: the first length l whose
// first-code / limit pair holds the l-bit prefix bitrev(peek) >> (15 - l).
// Returns l (0: no length holds it, a bad code) and the symbol at the
// clipped rank.
__device__ __forceinline__ int huff(const int* fc, const int* lim,
                                    const int* rkb, const int* perm, int cap,
                                    int peek, int* sym) {
  const int rev = (int)(__brev((unsigned)peek) >> 17);  // low 15 bits
  for (int l = 1; l < kCanon; ++l) {
    const int code = rev >> (15 - l);
    if (code >= fc[l] && code < lim[l]) {
      int rank = rkb[l] + code - fc[l];
      rank = rank < 0 ? 0 : (rank >= cap ? cap - 1 : rank);
      *sym = perm[rank];
      return l;
    }
  }
  return 0;
}

// One CUDA block per lane. cbytes (n, c) chunk bytes, bitoff (n,), the
// canonical parameters fc / lim / rkb (n, 16) and perm (n, 288 | 32) of the
// litlen (L) and distance (D) alphabets. Writes litbuf (n, b), ll / ml /
// off (n, maxseq), nbseq (n,) and litregen (n,) for a scan of b + 4 slots.
__global__ void __launch_bounds__(kThreads)
inflate_symbol_scan_kernel(const uint8_t* __restrict__ cbytes,
                           const int32_t* __restrict__ bitoff,
                           const int32_t* __restrict__ fcL,
                           const int32_t* __restrict__ limL,
                           const int32_t* __restrict__ rkbL,
                           const int32_t* __restrict__ permL,
                           const int32_t* __restrict__ fcD,
                           const int32_t* __restrict__ limD,
                           const int32_t* __restrict__ rkbD,
                           const int32_t* __restrict__ permD,
                           uint8_t* __restrict__ litbuf,
                           int32_t* __restrict__ ll_out,
                           int32_t* __restrict__ ml_out,
                           int32_t* __restrict__ off_out,
                           int32_t* __restrict__ nbseq_out,
                           int32_t* __restrict__ litregen_out, int c, int b,
                           int maxseq) {
  __shared__ int s_L[3 * kCanon + kPermL];
  __shared__ int s_D[3 * kCanon + kPermD];
  __shared__ int s_nlit, s_nseq;
  const size_t lane = blockIdx.x;
  for (int i = threadIdx.x; i < kCanon; i += blockDim.x) {
    s_L[i] = fcL[lane * kCanon + i];
    s_L[kCanon + i] = limL[lane * kCanon + i];
    s_L[2 * kCanon + i] = rkbL[lane * kCanon + i];
    s_D[i] = fcD[lane * kCanon + i];
    s_D[kCanon + i] = limD[lane * kCanon + i];
    s_D[2 * kCanon + i] = rkbD[lane * kCanon + i];
  }
  for (int i = threadIdx.x; i < kPermL; i += blockDim.x)
    s_L[3 * kCanon + i] = permL[lane * kPermL + i];
  for (int i = threadIdx.x; i < kPermD; i += blockDim.x)
    s_D[3 * kCanon + i] = permD[lane * kPermD + i];
  __syncthreads();

  uint8_t* lit = litbuf + lane * b;
  int32_t* llo = ll_out + lane * maxseq;
  int32_t* mlo = ml_out + lane * maxseq;
  int32_t* offo = off_out + lane * maxseq;
  if (threadIdx.x == 0) {
    const uint32_t* words = (const uint32_t*)(cbytes + lane * c);
    const int last = c / 4 - 1;
    const int* L = s_L;
    const int* D = s_D;
    int pos = bitoff[lane];
    int nlit = 0, nseq = 0, prev_lb = 0;
    const int maxs = b + 4;
    for (int s = 0; s < maxs; ++s) {
      int sym;
      const int ln = huff(L, L + kCanon, L + 2 * kCanon, L + 3 * kCanon,
                          kPermL, read_fwd(words, last, pos, 15), &sym);
      if (ln == 0) break;  // bad code
      const int pos_l = pos + ln;
      if (sym < 256) {  // literal
        if (nlit < b) lit[nlit] = (uint8_t)sym;
        ++nlit;
        pos = pos_l;
        continue;
      }
      if (sym == 256) break;  // end of block
      const int lc = sym - 257 < 28 ? sym - 257 : 28;
      const int xb = kLenXbits[lc];
      const int mlen = kLenBase[lc] + read_fwd(words, last, pos_l, xb);
      const int pos_x = pos_l + xb;
      int dsym;
      const int dln = huff(D, D + kCanon, D + 2 * kCanon, D + 3 * kCanon,
                           kPermD, read_fwd(words, last, pos_x, 15), &dsym);
      if (dln == 0 || dsym >= 30) break;  // bad distance code
      const int dxb = kDistXbits[dsym];
      const int dist =
          kDistBase[dsym] + read_fwd(words, last, pos_x + dln, dxb);
      pos = pos_x + dln + dxb;
      if (nseq < maxseq) {
        llo[nseq] = nlit - prev_lb;
        mlo[nseq] = mlen;
        offo[nseq] = dist < 1 ? 1 : (dist > b ? b : dist);
      }
      prev_lb = nlit;
      ++nseq;
    }
    s_nlit = nlit;
    s_nseq = nseq;
    nbseq_out[lane] = nseq;
    litregen_out[lane] = nlit;
  }
  __syncthreads();
  const int nl = s_nlit < b ? s_nlit : b;
  const int ns = s_nseq < maxseq ? s_nseq : maxseq;
  for (int i = nl + threadIdx.x; i < b; i += blockDim.x) lit[i] = 0;
  for (int i = ns + threadIdx.x; i < maxseq; i += blockDim.x) {
    llo[i] = 0;
    mlo[i] = 0;
    offo[i] = 1;
  }
}

}  // namespace

extern "C" int atpu_inflate_symbol_scan(
    const void* cbytes, const void* bitoff, const void* fcL, const void* limL,
    const void* rkbL, const void* permL, const void* fcD, const void* limD,
    const void* rkbD, const void* permD, void* litbuf, void* ll, void* ml,
    void* off, void* nbseq, void* litregen, int n, int c, int b, int maxseq,
    void* stream) {
  if (n <= 0) return 0;
  inflate_symbol_scan_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cbytes, (const int32_t*)bitoff, (const int32_t*)fcL,
      (const int32_t*)limL, (const int32_t*)rkbL, (const int32_t*)permL,
      (const int32_t*)fcD, (const int32_t*)limD, (const int32_t*)rkbD,
      (const int32_t*)permD, (uint8_t*)litbuf, (int32_t*)ll, (int32_t*)ml,
      (int32_t*)off, (int32_t*)nbseq, (int32_t*)litregen, c, b, maxseq);
  return (int)cudaGetLastError();
}
