// The device inflate's symbol scan: one thread decodes one chunk lane from
// root decode tables in shared memory over a bit buffer in registers.
//
// Replaces a lax.scan of the JAX package (not a Pallas kernel there):
//   aocl_compression_tpu/ops/inflate_device.py:121-180 (_symbol_scan, with
//   _read_fwd :74-85, _bitrev15 :91-97 and _huff_step :100-118), and the
//   compaction of its slots that follows, :183-212 (_compact).
//
// Deflate is one serial LSB-first bitstream per chunk: a symbol's position
// is known only after every earlier symbol is decoded, so a lane's steps
// cannot be split, and the kernel's time is the latency of the longest
// lane's chain of steps (a random 64 KiB block in a static-Huffman chunk is
// 65,537 literal steps), not HBM bytes: the chunk bytes are read once and
// the outputs written once. The design shortens each step's chain to one
// shared-memory load and a few ALU operations:
//
// - Root tables. At block start all 128 threads fill a litlen table of
//   2^kRootL entries and a distance table of 2^kRootD entries from the
//   lane's canonical parameters (fc / lim / rank base / permutation). Entry
//   i is what the code-length walk returns for a peek whose low bits are i:
//   the walk takes the first length l whose first-code / limit pair holds
//   the l-bit prefix, and for l <= kRoot that prefix lies in the entry's
//   bits, so the table answers every peek as the walk does, for any
//   parameters (incomplete, over-subscribed or not canonical at all). An
//   entry with no hit at a length <= kRoot is 0 ("long"): only then does the
//   step walk lengths kRoot+1..15 in shared memory (huff_long), and no hit
//   there is a bad code. Entries hold the step's next facts pre-folded: the
//   literal byte, end of block, or the length base and extra-bit count
//   (286 and 287 are length 258, no extras); the distance base and extra
//   bits (a negative symbol clamps to code 0; >= 30 is flagged bad).
// - A 64-bit bit buffer in registers, topped up by one word whenever it
//   holds fewer than 32 bits (a literal step needs 15 bits of peek, a
//   length step 15 + 5, a distance 15 + 13). No global load sits on the
//   step's chain: the lane's words stream into a small shared ring by
//   cp.async, kAhead words ahead, and a top-up takes its word from a
//   shared load issued one step earlier (see the decode loop for why a
//   register loaded from global memory may not feed it). Word indices
//   clamp to the lane's last word in the copy's address, which is exactly
//   what read_fwd of the plain version does (a read past the end sees the
//   last word again), so the buffer is exact up to and past the end of
//   the row with no separate slow path there.
// - One thread decodes; the block's 128 threads fill the tables and write
//   the fixed values past the lane's counts. The common step, a literal,
//   is straight-line code whose only branch is the loop's back edge (a
//   taken branch costs a lone warp its fetch bubble); literal bytes and
//   the sequence triples are stored as they are decoded, off the chain.
//
// The arithmetic follows the plain versions (ops/inflate_device.
// _symbol_scan_plain and _compact_plain), which follow the JAX package: at
// most b + 4 steps; no hit at any code length is a bad code; a match with
// no distance code or a distance symbol >= 30 is bad; a bad code ends the
// lane; literal bytes are written only below b and matches only below
// maxseq, but both counts go on; the literal buffer past the literal count
// is 0; offsets are clipped to [1, b]; ranks are clipped to the
// permutation, in 64-bit arithmetic as the plain version's int64.
// Preconditions (as for the plain version): c >= 4, 0 <= bitoff.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCanon = 16;   // first code / limit / rank base per length
constexpr int kPermL = 288;  // litlen symbol permutation
constexpr int kPermD = 32;   // distance symbol permutation
constexpr int kRootL = 11;   // litlen root table: 2^11 entries
constexpr int kRootD = 9;    // distance root table: 2^9 entries
constexpr int kRing = 32;    // stream words in the shared ring
constexpr int kAhead = 16;   // words fetched ahead of the refills

// litlen entry: bits 0-3 code length (0: long or bad), 4-7 extra bits,
// 8-9 kind, 16-31 the literal byte or the length base
constexpr uint32_t kLit = 1u << 8;
constexpr uint32_t kEob = 2u << 8;
constexpr uint32_t kLen = 3u << 8;
constexpr uint32_t kKind = 3u << 8;
// distance entry: bits 0-3 code length (0: long or bad), 4-7 extra bits,
// bit 8 bad symbol (>= 30), 16-31 the distance base
constexpr uint32_t kBadDist = 1u << 8;

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

__device__ __forceinline__ uint32_t fold_lit(int sym, int ln) {
  if (sym < 256) return (uint32_t)ln | kLit | ((uint32_t)(sym & 0xFF) << 16);
  if (sym == 256) return (uint32_t)ln | kEob;
  const int lc = sym - 257 < 28 ? sym - 257 : 28;
  return (uint32_t)ln | ((uint32_t)kLenXbits[lc] << 4) | kLen |
         ((uint32_t)kLenBase[lc] << 16);
}

__device__ __forceinline__ uint32_t fold_dist(int dsym, int dln) {
  if (dsym >= 30) return (uint32_t)dln | kBadDist;
  const int dc = dsym < 0 ? 0 : dsym;
  return (uint32_t)dln | ((uint32_t)kDistXbits[dc] << 4) |
         ((uint32_t)kDistBase[dc] << 16);
}

// A shared-memory load at a 32-bit shared address (the table's base is
// converted once, outside the decode loop).
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A 4-byte copy from global to shared memory that writes no register, as
// its own commit group.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4;\n"
      "cp.async.commit_group;" ::"r"(dst),
      "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Waits until at most kAhead - 2 groups are pending.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kAhead - 2) : "memory");
}

// The symbol at rank rkb[l] + code - fc[l], clipped to the permutation.
__device__ __forceinline__ int sym_at(const int* p, int cap, int l,
                                      int code) {
  long long rank = (long long)p[2 * kCanon + l] + code - p[l];
  rank = rank < 0 ? 0 : (rank >= cap ? cap - 1 : rank);
  return p[3 * kCanon + rank];
}

// The cold path: lengths lo..15 of the walk on a 15-bit peek, over the
// lane's parameters p = [fc | lim | rkb | perm] in shared memory. Returns
// the folded entry, or 0 where no length holds the code (a bad code).
template <bool kLitTable>
__device__ __noinline__ uint32_t huff_long(const int* p, int cap, int peek,
                                           int lo) {
  const int rev = (int)(__brev((unsigned)peek) >> 17);  // low 15 bits
  for (int l = lo; l < kCanon; ++l) {
    const int code = rev >> (15 - l);
    if (code >= p[l] && code < p[kCanon + l]) {
      const int sym = sym_at(p, cap, l, code);
      return kLitTable ? fold_lit(sym, l) : fold_dist(sym, l);
    }
  }
  return 0;
}

// Fills the root table of R bits for parameters p (shared memory), all
// threads of the block: entry i is the walk over lengths 1..R on peek i,
// folded by fold_lit or fold_dist, or 0 where no length <= R holds it.
template <int R, bool kLitTable>
__device__ __forceinline__ void fill_root(const int* p, int cap,
                                          uint32_t* tab) {
  int fc[R + 1], lim[R + 1];
#pragma unroll
  for (int l = 1; l <= R; ++l) {
    fc[l] = p[l];
    lim[l] = p[kCanon + l];
  }
  for (int i = threadIdx.x; i < (1 << R); i += blockDim.x) {
    const int rev = (int)(__brev((unsigned)i) >> 17);
    int ln = 0;
#pragma unroll
    for (int l = 1; l <= R; ++l) {
      const int code = rev >> (15 - l);
      if (ln == 0 && code >= fc[l] && code < lim[l]) ln = l;
    }
    uint32_t e = 0;
    if (ln) {
      const int sym = sym_at(p, cap, ln, rev >> (15 - ln));
      e = kLitTable ? fold_lit(sym, ln) : fold_dist(sym, ln);
    }
    tab[i] = e;
  }
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
  __shared__ uint32_t s_tabL[1 << kRootL];
  __shared__ uint32_t s_tabD[1 << kRootD];
  __shared__ uint32_t s_ring[kRing];
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
  fill_root<kRootL, true>(s_L, kPermL, s_tabL);
  fill_root<kRootD, false>(s_D, kPermD, s_tabD);
  __syncthreads();

  uint8_t* lit = litbuf + lane * b;
  int32_t* llo = ll_out + lane * maxseq;
  int32_t* mlo = ml_out + lane * maxseq;
  int32_t* offo = off_out + lane * maxseq;
  if (threadIdx.x == 0) {
    const uint32_t* words = (const uint32_t*)(cbytes + lane * c);
    const int last = c / 4 - 1;
    auto word = [&](int k) -> uint32_t {
      return __ldg(words + (k < last ? k : last));
    };
    const int pos0 = bitoff[lane];
    int kn = pos0 >> 5;
    uint64_t bb = (uint64_t)word(kn) | ((uint64_t)word(kn + 1) << 32);
    bb >>= (pos0 & 31);
    int nb = 64 - (pos0 & 31);  // valid bits in bb, from the lane's position
    kn += 2;                     // the word in wnext, the next one bb takes
    // The words ahead stream into a shared ring by cp.async, which writes
    // no register. A register that is the target of a global load in flight
    // stalls any instruction that reads it, even one predicated off, and a
    // word loaded at one refill and read at the next (about 170 cycles
    // later) would stall every refill on the L2's latency; and a taken
    // branch costs a single warp its fetch bubble. So every step runs the
    // same straight-line code: top_up adds the word a shared load brought
    // one step earlier when bb holds fewer than 32 bits; after the step's
    // table lookup is issued, ahead copies word kn + kAhead - 1 into the
    // ring (again, while kn stands) as one commit group, waits until word
    // kn's last copy (at least kAhead - 1 groups old) has landed, and loads
    // word kn from the ring for the next step.
    const uint32_t ring = smem(s_ring);
    auto slot = [&](int k) { return ring + ((k & (kRing - 1)) << 2); };
    auto fetch = [&](int k) {  // word k, clamped to the row, into its slot
      cp_async4(slot(k), words + (k < last ? k : last));
    };
    for (int j = 0; j < kAhead; ++j) fetch(kn + j);
    cp_async_wait_all();
    uint32_t wnext = lds(slot(kn));
    auto top_up = [&]() {
      const bool need = nb < 32;
      bb |= (uint64_t)(need ? wnext : 0u) << nb;
      nb += need ? 32 : 0;
      kn += need ? 1 : 0;
    };
    auto ahead = [&]() {
      fetch(kn + kAhead - 1);
      cp_async_wait_ahead();
      wnext = lds(slot(kn));
    };
    auto consume = [&](int n) {
      bb >>= n;
      nb -= n;
    };
    const uint32_t tabL = smem(s_tabL), tabD = smem(s_tabD);
    int nlit = 0, nseq = 0, prev_lb = 0, s = 0;
    const int maxs = b + 4;
    while (s < maxs) {
      // Literals run straight through this loop: its only branch is the
      // back edge, and a literal's effects are predicated on the kind.
      // Anything else (a long or bad code, end of block, a match) leaves
      // it unconsumed.
      uint32_t e;
      bool is_lit;
      do {
        top_up();
        e = lds(tabL + (((uint32_t)bb & ((1u << kRootL) - 1)) << 2));
        ahead();
        ++s;
        is_lit = (e & kKind) == kLit;
        consume(is_lit ? (int)(e & 15) : 0);
        if (is_lit && nlit < b) lit[nlit] = (uint8_t)(e >> 16);
        nlit += is_lit ? 1 : 0;
      } while (is_lit && s < maxs);
      if (is_lit) break;  // the step cap, after a literal
      if ((e & 15) == 0) {  // a long code, or a bad one
        e = huff_long<true>(s_L, kPermL, (int)(bb & 0x7FFF), kRootL + 1);
        if (e == 0) break;  // bad code
      }
      consume(e & 15);
      if ((e & kKind) == kLit) {
        if (nlit < b) lit[nlit] = (uint8_t)(e >> 16);
        ++nlit;
        continue;
      }
      if ((e & kKind) == kEob) break;  // end of block
      const int xb = (e >> 4) & 15;
      const int mlen = (int)(e >> 16) + (int)(bb & ((1u << xb) - 1u));
      consume(xb);
      top_up();
      uint32_t d = lds(tabD + (((uint32_t)bb & ((1u << kRootD) - 1)) << 2));
      ahead();
      if ((d & 15) == 0) {
        d = huff_long<false>(s_D, kPermD, (int)(bb & 0x7FFF), kRootD + 1);
        if (d == 0) break;  // no distance code holds it
      }
      if (d & kBadDist) break;  // distance symbol >= 30
      consume(d & 15);
      const int dxb = (d >> 4) & 15;
      const int dist = (int)(d >> 16) + (int)(bb & ((1u << dxb) - 1u));
      consume(dxb);
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
