// The three serial scans of the zstd device tiers, one CUDA block per zstd
// block.
//
// Replaces lax.scans of the JAX package (not Pallas kernels there):
//   fse_encode_scan   aocl_compression_tpu/ops/zstd_device.py:491-557 (the
//                     3-state reverse FSE scan over a block's sequences);
//   huf_literal_scan  aocl_compression_tpu/ops/zstd_decode_device.py:114-140
//                     (Huffman literal decode, one lane per stream);
//   fse_sequence_scan aocl_compression_tpu/ops/zstd_decode_device.py:143-219
//                     (FSE sequence decode with the repeat-offset update).
//
// Each lane is a serial state machine of table lookups and bit reads, so a
// lane's steps cannot be split; the port's plain PyTorch loop launches every
// op of every step from the host. Bound: the serial chain of the longest
// lane, not HBM bytes (the inputs and outputs are read and written once).
// Each design shortens a step's chain to one dependent shared-memory load
// and a few ALU operations, with no global load whose result the step uses:
// - fse_encode_scan: three threads of warp 0 run the ll, ml and of state
//   chains in step; the block's other warps stage the sequences' table
//   pairs into shared memory a chunk ahead, write the rows a chunk behind
//   and zero the rows past the count meanwhile (see there);
// - huf_literal_scan and fse_sequence_scan: one thread a lane decodes from
//   tables in shared memory through a register bit buffer that a shared
//   ring, filled by cp.async ahead of the position, feeds (BackRing).
//
// The arithmetic follows the plain versions (ops/zstd_device._fse_scan_plain,
// ops/zstd_decode_device._literal_scan_plain / _sequence_scan_plain), which
// follow the JAX package: XLA's shifts (amounts outside [0, 32) give 0, or
// the sign for a right shift), its gathers (clamped; a negative index of a
// vmapped table counts from the end first; take_along_axis past the end
// reads the type's fill: INT_MIN for int32, UINT_MAX for the uint32 stream
// words) and _read_back's zero-fill below bit 0. Sums that can wrap
// on corrupt input are done in unsigned arithmetic, as int32 wraps in XLA;
// the decoders keep their bit positions in 64 bits, as their plain
// versions' int64 tensors do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNxt = 512;    // next-state table width of one field
constexpr int kSym = 64;     // symbol-transform width of one field
constexpr int kHuf = 2048;   // Huffman decode table of one block
constexpr int kHufLog = 11;  // its index width
constexpr int kFse = 512;    // FSE decode table of one field

// XLA's shifts. PTX reads the amount as unsigned and clamps it to 32, so a
// negative amount or one of 32 or more gives 0 (left) or the sign (right).
__device__ __forceinline__ int shl(int x, int n) {
  int r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

__device__ __forceinline__ int sra(int x, int n) {
  int r;
  asm("shr.s32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// The high word of (b:a) << (n mod 32): a funnel shift of a 64-bit value
// held in two words.
__device__ __forceinline__ uint32_t shf_l(uint32_t a, uint32_t b, uint32_t n) {
  uint32_t r;
  asm("shf.l.wrap.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(n));
  return r;
}

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// a lane's own table of `size`: negative indices count from the end, then
// the index is clamped
__device__ __forceinline__ int tab_index(int i, int size) {
  if (i < 0) i += size;
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// --- shared memory and cp.async ----------------------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A shared-memory load at a 32-bit shared address (a table's base is
// converted once, outside the decode loops).
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// A 4-byte copy from global to shared memory that writes no register.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Waits until at most N commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

constexpr int kRing = 32;      // stream words in a lane's shared ring
constexpr int kFetchLow = 16;  // prime fills the ring down to word kn - 16

// A backward reader's words in shared memory: word k of the lane's row sits
// in slot k mod kRing of a ring that cp.async fills ahead of the position.
// cp.async writes no register: an instruction that reads the register of a
// global load in flight waits for it, even predicated off, so a word loaded
// from global memory at one refill and read at the next would stall every
// refill on the L2's latency. A reader copies the words below its position
// some steps ahead, waits for the copies old enough to have landed, and
// reads a word from the ring one step before it needs it.
struct BackRing {
  uint32_t base;          // shared address of the ring
  const uint32_t* words;  // the lane's row
  int nwords;

  __device__ __forceinline__ uint32_t slot(int k) const {
    return base + ((k & (kRing - 1)) << 2);
  }

  // word k, clamped to the row, into its slot
  __device__ __forceinline__ void fetch(int k) const {
    const int kc = k < 0 ? 0 : (k >= nwords ? nwords - 1 : k);
    cp_async4(slot(k), words + kc);
  }

  // Fills words kn - kFetchLow .. kn (kn = the word of bit pos - 1) and
  // waits for them; false where pos lies outside (0, 32 * nwords], where a
  // read would see the row's end (the fast paths cannot run).
  __device__ __forceinline__ bool prime(long long pos) const {
    if (pos < 1 || pos > 32LL * nwords) return false;
    const int kn = (int)((pos - 1) >> 5);
    cp_async_wait_all();  // no copy of an earlier prime still in flight
    for (int j = 0; j <= kFetchLow; ++j) fetch(kn - j);
    cp_async_commit();
    cp_async_wait_all();
    return true;
  }
};

// --- encode ------------------------------------------------------------------

constexpr int kChunk = 128;            // encode steps per staged chunk
constexpr int kProd = kThreads - 32;   // producer threads (warps 1-3)

// next-state index of a doubled table (s_nxt below): tab_index(i, 512) is
// entry clamp(i, -512, 511) + 512 of the table written twice
__device__ __forceinline__ int nxt_index(int i) {
  return max(min(i, kNxt - 1), -kNxt);
}

// Zeroes the ints [0, cnt) of p (4-byte aligned), 16 bytes a store where
// aligned; thread t of nt.
__device__ __forceinline__ void zero_ints(int32_t* p, size_t cnt, int t,
                                          int nt) {
  size_t lead = ((16 - ((uintptr_t)p & 15)) & 15) >> 2;
  lead = lead < cnt ? lead : cnt;
  const size_t nq = (cnt - lead) >> 2;
  int4* q = (int4*)(p + lead);
  for (size_t i = t; i < lead; i += nt) p[i] = 0;
  for (size_t i = t; i < nq; i += nt) q[i] = make_int4(0, 0, 0, 0);
  for (size_t i = lead + 4 * nq + t; i < cnt; i += nt) p[i] = 0;
}

// xs (n, maxseq, 8): [llc, llx, llb, mlc, mlx, mlb, ofc, ofx] per sequence,
// in block order; nxt (n, 3, 512), dnb / dfs (n, 3, 64) for [ll, ml, of].
// Step r encodes sequence nseq - 1 - r: pv / pn (n, maxseq, 6) in that
// processing order, [of, ml, ll states, ll, ml, of extras]; rows past nseq
// are zero. fin (n, 3): the final [ll, ml, of] states.
//
// The three fields' states are independent chains, so threads 0-2 of warp 0
// run them in step, thread f field f. A step of a chain is fse_enc's
// arithmetic: nb = (st + dnb[c]) >> 16, the value st & (2^nb - 1), and st =
// nxt[tab_index((st >> nb) + dfs[c])]; its only load is the next state,
// from shared memory. The steps come in chunks of kChunk, double-buffered
// in shared memory, and the chain threads meet the others only at a chunk's
// end (one block barrier): in the phase where the chains run chunk p, warps
// 1-3 (the producers)
//   - write the rows of chunk p - 1 from the staged (value, nb) pairs and
//     the staged extras, one row per thread with 8-byte stores;
//   - stage chunk p + 1: each step's xs row (sequence ns - 1 - r; rows in
//     reverse order, read with 16-byte loads) and, per field, the (dnb,
//     dfs) pair at tab_index(code, 64), so that a chain step reads its pair
//     from shared memory at an address that does not depend on the state;
//   - zero a slice of the rows past ns, 16 bytes a store.
// The chain is exact for any input, with no separate cold path: XLA's
// shifts are PTX's (see shl and sra), sums wrap as int32, and the next-state
// table is written twice so that tab_index(i, 512) is one clamp of i.
__global__ void __launch_bounds__(kThreads)
fse_encode_scan_kernel(const int32_t* __restrict__ xs,
                       const int32_t* __restrict__ nseq,
                       const int32_t* __restrict__ nxt,
                       const int32_t* __restrict__ dnb,
                       const int32_t* __restrict__ dfs,
                       int32_t* __restrict__ pv, int32_t* __restrict__ pn,
                       int32_t* __restrict__ fin, int maxseq) {
  __shared__ int32_t s_nxt[3][2 * kNxt];  // each field's table, twice
  __shared__ int32_t s_dnb[3 * kSym];
  __shared__ int32_t s_dfs[3 * kSym];
  __shared__ __align__(16) int32_t s_xs[2][kChunk][8];
  __shared__ int2 s_pair[2][kChunk][3];  // (dnb, dfs) per step and field
  __shared__ int2 s_vn[2][kChunk][3];    // (value, nb) per step and field
  const size_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * kNxt; i += kThreads) {
    const int v = nxt[lane * 3 * kNxt + i];
    s_nxt[i / kNxt][i % kNxt] = v;
    s_nxt[i / kNxt][kNxt + i % kNxt] = v;
  }
  for (int i = tid; i < 3 * kSym; i += kThreads) {
    s_dnb[i] = dnb[lane * 3 * kSym + i];
    s_dfs[i] = dfs[lane * 3 * kSym + i];
  }
  int ns = nseq[lane];
  ns = ns < 0 ? 0 : (ns > maxseq ? maxseq : ns);
  const int nchunk = (ns + kChunk - 1) / kChunk;
  const int32_t* xl = xs + lane * maxseq * 8;
  int32_t* pvl = pv + lane * maxseq * 6;
  int32_t* pnl = pn + lane * maxseq * 6;
  const int t = tid - 32;  // producer index
  const bool vec = ((uintptr_t)xl & 15) == 0;
  __syncthreads();

  auto stage = [&](int q) {
    const int b = q & 1, r0 = q * kChunk;
    const int len = min(kChunk, ns - r0);
    for (int j = t; j < len; j += kProd) {
      const int32_t* x = xl + (size_t)(ns - 1 - r0 - j) * 8;
      int4 lo, hi;
      if (vec) {
        lo = __ldg((const int4*)x);
        hi = __ldg((const int4*)x + 1);
      } else {
        lo = make_int4(x[0], x[1], x[2], x[3]);
        hi = make_int4(x[4], x[5], x[6], x[7]);
      }
      *(int4*)s_xs[b][j] = lo;
      *(int4*)(s_xs[b][j] + 4) = hi;
      const int code[3] = {lo.x, lo.w, hi.z};
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int ci = f * kSym + tab_index(code[f], kSym);
        s_pair[b][j][f] = make_int2(s_dnb[ci], s_dfs[ci]);
      }
    }
  };
  auto drain = [&](int q) {
    const int b = q & 1, r0 = q * kChunk;
    const int len = min(kChunk, ns - r0);
    for (int j = t; j < len; j += kProd) {
      const int32_t* x = s_xs[b][j];
      const int2 ll = s_vn[b][j][0], ml = s_vn[b][j][1], of = s_vn[b][j][2];
      int2* v = (int2*)(pvl + (size_t)(r0 + j) * 6);
      int2* n = (int2*)(pnl + (size_t)(r0 + j) * 6);
      v[0] = make_int2(of.x, ml.x);
      v[1] = make_int2(ll.x, x[1]);
      v[2] = make_int2(x[4], x[7]);
      n[0] = make_int2(of.y, ml.y);
      n[1] = make_int2(ll.y, x[2]);
      n[2] = make_int2(x[5], x[6]);
    }
  };

  if (t >= 0 && nchunk > 0) stage(0);
  __syncthreads();
  const size_t zfill = (size_t)(maxseq - ns) * 6;  // ints past the rows
  const int nphase = nchunk + 1;
  int st = 0;
  for (int p = 0; p < nphase; ++p) {
    if (tid < 3) {
      if (p < nchunk) {
        const int b = p & 1, len = min(kChunk, ns - p * kChunk);
        const int32_t* tab = s_nxt[tid] + kNxt;
        const int2* pr = &s_pair[b][0][tid];
        int2* vo = &s_vn[b][0][tid];
        int j = 0;
        if (p == 0) {  // the last sequence initializes the state
          const int2 pd = pr[0];
          const int nbout = sra(wadd(pd.x, 1 << 15), 16);
          st = tab[nxt_index(
              wadd(sra(wsub(shl(nbout, 16), pd.x), nbout), pd.y))];
          vo[0] = make_int2(0, 0);
          j = 1;
        }
#pragma unroll 4
        for (; j < len; ++j) {
          const int2 pd = pr[3 * j];
          const int nb = sra(wadd(st, pd.x), 16);
          vo[3 * j] = make_int2(st & wsub(shl(1, nb), 1), nb);
          st = tab[nxt_index(wadd(sra(st, nb), pd.y))];
        }
      }
    } else if (t >= 0) {
      if (p > 0) drain(p - 1);
      if (p + 1 < nchunk) stage(p + 1);
      const size_t z0 = zfill * p / nphase, z1 = zfill * (p + 1) / nphase;
      zero_ints(pvl + (size_t)ns * 6 + z0, z1 - z0, t, kProd);
      zero_ints(pnl + (size_t)ns * 6 + z0, z1 - z0, t, kProd);
    }
    __syncthreads();
  }
  if (tid < 3) fin[lane * 3 + tid] = st;
}

// --- decode ------------------------------------------------------------------

// Bits [pos - nbits, pos) of a backward bitstream of nwords little-endian
// words, zero-filled below bit 0, as read_back of the plain versions in
// 64-bit positions (they do not wrap); *bp = pos - nbits.
__device__ __forceinline__ int read_back64(const uint32_t* __restrict__ words,
                                           int nwords, long long pos,
                                           int nbits, long long* bp) {
  const long long b = pos - nbits;
  *bp = b;
  const long long pre = b >= 0 ? 0 : (b < -31 ? 31 : -b);
  const long long bpc = b > 0 ? b : 0;
  const long long wi = bpc >> 5;
  const unsigned sh = (unsigned)(bpc & 31);
  const uint32_t w0 = wi < nwords ? words[wi] : 0xFFFFFFFFu;
  const uint32_t w1 = wi + 1 < nwords ? words[wi + 1] : 0u;
  uint32_t v = (w0 >> sh) | (sh == 0 ? 0u : (w1 << (32 - sh)));
  v <<= (unsigned)pre;
  const uint32_t mask =
      (nbits >= 0 && nbits < 32) ? ((1u << nbits) - 1u) : 0xFFFFFFFFu;
  const int r = pre >= nbits ? 0 : (int)(v & mask);
  return nbits > 0 ? r : 0;
}

// Start of a backward reader: (len - 1) * 8 + the last byte's high bit.
__device__ __forceinline__ long long init_pos64(
    const uint8_t* __restrict__ bytes, int cap, int len) {
  const int li = len - 1 > 0 ? len - 1 : 0;
  const int last = li < cap ? (int)bytes[li] : 1;  // past the end: INT_MIN
  const int hb = 31 - __clz(last > 1 ? last : 1);
  return len > 0 ? (long long)(len - 1) * 8 + hb : 0;
}


// Four lanes (the streams) per zstd block, one warp each. sbytes (n*4, sb)
// bytes, slens / scounts / huflog (n*4,), huftab (n, 2048) entries sym << 4
// | nbits; syms (n*4, maxl): the symbol of every slot below the lane's
// count (the slots past it are not written).
//
// The block's 128 threads fill the table (16-byte loads) as two byte
// tables, the entries' bit counts and symbols; then thread 0 of warp w
// decodes stream w. The fast path keeps a 64-bit register bit buffer h of
// the bits below the position (bit 63 the stream's bit pos - 1), fed from
// the lane's BackRing one word at a time. One step: v = the top hlog bits
// of h; n = the bit count at v (a shared-memory load; the symbol's load
// beside it feeds only the output); while it is in flight, a word is added
// below the buffer's bits if it holds fewer than 32 (a select, no branch)
// and the next word is read from the ring; then h shifts by n. No global
// load is on a step: the ring is topped up once before each run of at
// most 16 steps. The common step is straight-line code; symbols are packed into
// registers and stored 16 bytes at a time (single steps, with byte stores,
// align the row and finish it).
//
// The fast path is exactly read_back wherever it runs: 1 <= hlog <= 11 (so
// v < 2048 is the lane's own table), the start lies inside the row (no
// word past it is read) and pos - hlog >= 0 before each step (no zero-fill);
// the buffer holds at least 17 bits at each step and a step consumes at
// most 15, so a run of steps whose starts provably stay at or above bit
// hlog needs no check. Everything else takes the cold path, the exact
// read_back and the flat table's clip of the plain version: hlog of 0,
// negative or above 11, rows read past their end, and the tail that reaches
// below bit 0.
__global__ void __launch_bounds__(kThreads)
huf_literal_scan_kernel(const uint8_t* __restrict__ sbytes,
                        const int32_t* __restrict__ slens,
                        const int32_t* __restrict__ scounts,
                        const int32_t* __restrict__ huftab,
                        const int32_t* __restrict__ huflog,
                        uint8_t* __restrict__ syms, int nblocks, int sb,
                        int maxl) {
  // an entry sym << 4 | nbits as two bytes: the bit count and the symbol
  // (bits 4-11, as the plain version's uint8 cast keeps)
  __shared__ __align__(4) uint8_t s_nb[kHuf];
  __shared__ __align__(4) uint8_t s_sym[kHuf];
  __shared__ uint32_t s_ring[4][kRing];
  const int blk = blockIdx.x;
  const int32_t* tab = huftab + (size_t)blk * kHuf;
  const bool vec = ((uintptr_t)tab & 15) == 0;
  for (int i = threadIdx.x; i < kHuf / 4; i += kThreads) {  // 4 entries
    const int4 q = vec ? __ldg((const int4*)tab + i)
                       : make_int4(tab[4 * i], tab[4 * i + 1],
                                   tab[4 * i + 2], tab[4 * i + 3]);
    ((uchar4*)s_nb)[i] = make_uchar4(q.x & 15, q.y & 15, q.z & 15, q.w & 15);
    ((uchar4*)s_sym)[i] = make_uchar4(q.x >> 4, q.y >> 4, q.z >> 4, q.w >> 4);
  }
  __syncthreads();
  if (threadIdx.x & 31) return;
  const int w = threadIdx.x >> 5;
  const size_t lane = (size_t)blk * 4 + w;
  const uint8_t* bytes = sbytes + lane * sb;
  const uint32_t* words = (const uint32_t*)bytes;
  const int nwords = sb / 4;
  long long pos = init_pos64(bytes, sb, slens[lane]);
  int cnt = scounts[lane];
  cnt = cnt > maxl ? maxl : cnt;
  const int hlog = huflog[lane];
  uint8_t* out = syms + lane * maxl;
  const BackRing ring = {smem(s_ring[w]), words, nwords};
  int k = 0;
  if (hlog >= 1 && hlog <= kHufLog && cnt > 0 && ring.prime(pos)) {
    const int kn = (int)((pos - 1) >> 5);
    const int r = (int)(pos - 32LL * kn);  // bits of word kn below pos
    // h = hi:lo holds the stream's bits [32 * kw, pos) at its top and zeros
    // below them; c = 64 - their count, the bits consumed from the window
    uint32_t hi = lds(ring.slot(kn)), lo = lds(ring.slot(kn - 1));
    hi = shf_l(lo, hi, 32 - r);
    lo = shf_l(0, lo, 32 - r);
    int c = 32 - r;
    int kw = kn - 1;
    int kf = kn - kFetchLow;  // the lowest word copied into the ring
    uint32_t wnext = 0;
    const unsigned vsh = 32 - hlog;
    // Before each run of at most 16 steps (8 refills at most): copy the
    // words down to kw - 16, then wait for every copy but this run's own,
    // which covers the words a run can take (they lie above kw - 8 and were
    // copied by an earlier run or by prime).
    auto refresh = [&]() {
      while (kf > kw - kFetchLow) ring.fetch(--kf);
      cp_async_commit();
      cp_async_wait_group<1>();
      wnext = lds(ring.slot(kw - 1));
    };
    // one step; returns the symbol
    auto step = [&]() -> uint32_t {
      const uint32_t v = hi >> vsh;
      const uint32_t n = s_nb[v];
      const bool need = c > 32;  // fewer than 32 bits: add word kw - 1
      const uint32_t w = need ? wnext : 0u;
      lo |= shf_l(0, w, c);  // w << (c - 32), c - 32 in [1, 15]
      hi |= shf_l(w, 0, c);
      c -= need ? 32 : 0;
      kw -= need ? 1 : 0;
      wnext = lds(ring.slot(kw - 1));
      hi = shf_l(lo, hi, n);
      lo = shf_l(0, lo, n);
      c += n;
      return s_sym[v];
    };
    for (;;) {
      const long long p = 32LL * kw + 64 - c;  // the position
      if (p < hlog || k >= cnt) break;
      // the next m steps all start at or above bit hlog
      const long long safe = (p - hlog) / 15 + 1;
      const int m = (int)(safe < cnt - k ? safe : cnt - k);
      const int lead = (int)((0u - (uint32_t)(uintptr_t)(out + k)) & 15u);
      if (lead > 0 || m < 16) {  // to the next 16-byte boundary, or the end
        const int s = lead > 0 && lead < m ? lead : m;
        refresh();
        for (int j = 0; j < s; ++j) out[k++] = (uint8_t)step();
        continue;
      }
      for (int nblk = m >> 4; nblk > 0; --nblk) {
        refresh();
        uint32_t a[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < 16; ++q)
          a[q >> 2] = __byte_perm(a[q >> 2], step(), 0x4321);
        *(uint4*)(out + k) = make_uint4(a[0], a[1], a[2], a[3]);
        k += 16;
      }
    }
    pos = 32LL * kw + 64 - c;
  }
  const long long base = (long long)blk * kHuf;
  const long long last = (long long)nblocks * kHuf - 1;
  for (; k < cnt; ++k) {
    long long bp;
    const int v = read_back64(words, nwords, pos, hlog, &bp);
    int sym, n;
    if (v >= 0 && v < kHuf) {
      sym = s_sym[v];
      n = s_nb[v];
    } else {  // the flat table's clip, as jnp.take(mode="clip")
      long long f = base + v;
      f = f < 0 ? 0 : (f > last ? last : f);
      sym = huftab[f] >> 4;
      n = huftab[f] & 15;
    }
    out[k] = (uint8_t)sym;
    pos -= n;
  }
}

__constant__ int kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22,
    24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
    32768, 65536};
__constant__ int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
__constant__ int kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16};

constexpr int kFastBits = 16;  // widest state read of the fast path

// What a sequence needs of field f's raw entry e beside e itself: the
// value base << 5 | the extra-bit count of its (clipped) code.
__device__ __forceinline__ uint32_t fold_value(int f, int e) {
  const int code = e & 0xFF;
  if (f == 0) {
    const int c = code < 35 ? code : 35;
    return ((uint32_t)kLLBase[c] << 5) | (uint32_t)kLLBits[c];
  }
  if (f == 1) {
    const int c = code < 16 ? code : 16;  // the 64 KiB gate: ofc <= 16
    return ((1u << c) << 5) | (uint32_t)c;
  }
  const int c = code < 52 ? code : 52;
  return ((uint32_t)kMLBase[c] << 5) | (uint32_t)kMLBits[c];
}

__device__ __forceinline__ int sat32(long long v) {
  return v < INT32_MIN ? INT32_MIN : (v > INT32_MAX ? INT32_MAX : (int)v);
}

// A folded entry (raw, fold_value) at a 32-bit shared address.
__device__ __forceinline__ uint2 lds2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// One thread decodes each zstd block (the block's other threads fold the
// table and write the fixed values past the count). fsetab (n, 3, 512) for
// [ll, of, ml] with entries base << 16 | nbits << 8 | symbol; logs (n, 3)
// the [ll, of, ml] table logs. ll / ml / off (n, maxseq): every slot, (0,
// 0, 1) past nbseq.
//
// The lane's table is folded into shared memory at block start: each
// entry beside its value base and extra-bit count, so a sequence's three
// lookups (issued together, one 8-byte shared load each) give everything
// its reads need. The stream is read backward, and the six reads of a
// sequence (the OF, ML, LL extras, then the LL, ML, OF state refills) are
// cut in parallel from one 64-bit window of the bits below the position,
// built from words that a shared ring, filled by cp.async ahead of the
// position, holds (see the window below), so no global load sits on the
// sequence's chain. The common sequence is straight-line code whose only
// branch is the loop's back edge.
//
// The fast path is exactly read_back wherever no read reaches below bit 0
// and the position lies inside the row (pos <= 32 * nwords), since then
// every read sees real words: it is taken for a sequence whose six reads
// fit above bit 0 and in 64 bits and whose state reads are at most 16
// bits. Everything else takes the cold path, the exact read_back against
// global memory: the three initial state reads, sequences that reach bit 0
// (zero-fill) or read more than 64 bits, rows read from past their end
// (UINT_MAX words), state reads wider than 16 bits (corrupt tables), and
// states outside [0, 512) for the lookups (the flat table's clip).
// Positions are clamped to >= 0 only after the third initial read and
// after each OF state read, as in the plain version.
__global__ void __launch_bounds__(kThreads)
fse_sequence_scan_kernel(const uint8_t* __restrict__ qbytes,
                         const int32_t* __restrict__ qlens,
                         const int32_t* __restrict__ nbseq,
                         const int32_t* __restrict__ fsetab,
                         const int32_t* __restrict__ logs,
                         int32_t* __restrict__ ll_out,
                         int32_t* __restrict__ ml_out,
                         int32_t* __restrict__ off_out, int nblocks, int qb,
                         int maxseq) {
  __shared__ uint2 s_fold[3 * kFse];
  __shared__ uint32_t s_ring[kRing];
  const size_t lane = blockIdx.x;
  for (int i = threadIdx.x; i < 3 * kFse; i += blockDim.x) {
    const int e = fsetab[lane * 3 * kFse + i];
    s_fold[i] = make_uint2((uint32_t)e, fold_value(i / kFse, e));
  }
  int cnt = nbseq[lane];
  cnt = cnt < 0 ? 0 : (cnt > maxseq ? maxseq : cnt);
  int32_t* llo = ll_out + lane * maxseq;
  int32_t* mlo = ml_out + lane * maxseq;
  int32_t* offo = off_out + lane * maxseq;
  for (int i = cnt + threadIdx.x; i < maxseq; i += blockDim.x) {
    llo[i] = 0;
    mlo[i] = 0;
    offo[i] = 1;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const uint8_t* bytes = qbytes + lane * qb;
  const uint32_t* words = (const uint32_t*)bytes;
  const int nwords = qb / 4;
  const long long last = (long long)nblocks * kFse - 1;
  const uint32_t fold = smem(s_fold);
  // field f's folded entry at state s: the lane's shared table, else the
  // clip of the flat (n * 512) table of that field, as jnp.take(mode="clip")
  auto entry = [&](int f, int s) -> uint2 {
    if (s >= 0 && s < kFse) return s_fold[f * kFse + s];
    long long e = (long long)lane * kFse + s;
    e = e < 0 ? 0 : (e > last ? last : e);
    const int raw = fsetab[(e / kFse) * 3 * kFse + f * kFse + e % kFse];
    return make_uint2((uint32_t)raw, fold_value(f, raw));
  };
  long long pos = init_pos64(bytes, qb, qlens[lane]);
  long long bp;
  // states stay in int32: saturating a wider sum changes no lookup, as
  // lane * 512 + s clips to the same end of the flat table either way
  int llS = read_back64(words, nwords, pos, logs[lane * 3 + 0], &bp);
  pos = bp;
  int ofS = read_back64(words, nwords, pos, logs[lane * 3 + 1], &bp);
  pos = bp;
  int mlS = read_back64(words, nwords, pos, logs[lane * 3 + 2], &bp);
  pos = bp > 0 ? bp : 0;

  // The window. A sequence's six reads end at pos and their sizes are
  // known once its three lookups return, so each is cut at its own fixed
  // offset from one 64-bit window of the stream's bits [pos - 64, pos):
  // the reads do not wait on one another. The window is built from the
  // three words holding those bits, read from a shared ring that cp.async
  // fills ahead of pos (it writes no register: an instruction that reads
  // the register of a global load in flight waits for it, even predicated
  // off). Each fast sequence copies words kn - 13 .. kn - 16 (kn = the
  // word of bit pos - 1) as one commit group; a word it reads was copied
  // at least six sequences earlier (pos falls at most 64 bits a
  // sequence), which the wait for all but the 4 newest groups covers.
  const BackRing ring = {smem(s_ring), words, nwords};
  bool fast = ring.prime(pos);

  int r0 = 1, r1 = 4, r2 = 8;
  int s = 0;
  // sequence s from its three entries and its extras: the values, the
  // repeat offsets (selects, no branch) and the outputs
  auto finish = [&](uint2 le, uint2 oe, uint2 me, int ofx, int mlx,
                    int llx) {
    const int ofv = wadd((int)(oe.y >> 5), ofx);
    const int mlv = wadd((int)(me.y >> 5), mlx);
    const int llv = wadd((int)(le.y >> 5), llx);
    const bool is_code = ofv > 3;
    const int rep = ofv - 1 + (llv == 0 ? 1 : 0);
    int off_rep = r0 - 1 > 1 ? r0 - 1 : 1;
    off_rep = rep == 2 ? r2 : off_rep;
    off_rep = rep == 1 ? r1 : off_rep;
    off_rep = rep == 0 ? r0 : off_rep;
    const int offset = is_code ? ofv - 3 : off_rep;
    const bool upd = is_code || rep >= 1;
    const int nr2 = (is_code || rep >= 2) ? r1 : r2;
    const int nr1 = upd ? r0 : r1;
    const int nr0 = upd ? offset : r0;
    r0 = nr0;
    r1 = nr1;
    r2 = nr2;
    llo[s] = llv;
    mlo[s] = mlv;
    offo[s] = offset;
    ++s;
  };
  while (s < cnt) {
    // Sequences on the fast path run straight through this loop: its only
    // branch is the back edge; any other sequence leaves it.
    do {
      // the three lookups from the shared table and the window's three
      // words from the ring, issued together
      const uint2 le = lds2(fold + ((llS & (kFse - 1)) << 3));
      const uint2 oe = lds2(fold + ((kFse + (ofS & (kFse - 1))) << 3));
      const uint2 me = lds2(fold + ((2 * kFse + (mlS & (kFse - 1))) << 3));
      const int kn = (int)((pos - 1) >> 5);
      cp_async_wait_group<4>();
      const uint32_t w2 = lds(ring.slot(kn)), w1 = lds(ring.slot(kn - 1)),
                     w0 = lds(ring.slot(kn - 2));
      for (int j = kFetchLow - 3; j <= kFetchLow; ++j) ring.fetch(kn - j);
      cp_async_commit();
      const int ofb = oe.y & 31, mlb = me.y & 31, llb = le.y & 31;
      const int lnb_n = (le.x >> 8) & 0xFF, mnb_n = (me.x >> 8) & 0xFF,
                onb_n = (oe.x >> 8) & 0xFF;
      // end offsets of the reads below pos: extras OF, ML, LL, then the
      // LL, ML, OF state refills
      const int e1 = ofb, e2 = e1 + mlb, e3 = e2 + llb, e4 = e3 + lnb_n,
                e5 = e4 + mnb_n, total = e5 + onb_n;
      if (((unsigned)(llS | ofS | mlS) >= (unsigned)kFse) | !fast |
          ((lnb_n | mnb_n | onb_n) > kFastBits) | (pos < total) |
          (total > 64))
        break;
      // bit 63 of h is the stream's bit pos - 1
      const unsigned sh = (unsigned)(32LL * kn + 32 - pos);  // 0..31
      const uint64_t hw = ((uint64_t)w2 << 32) | w1;
      const uint64_t h = (hw << sh) | (sh ? (uint64_t)(w0 >> (32 - sh)) : 0);
      auto cut = [&](int e, int n) -> int {  // bits [pos - e, pos - e + n)
        return (int)((h >> ((64 - e) & 63)) & ((1u << n) - 1u));
      };
      const int ofx = cut(e1, ofb), mlx = cut(e2, mlb), llx = cut(e3, llb);
      const int lnb = cut(e4, lnb_n), mnb = cut(e5, mnb_n),
                onb = cut(total, onb_n);
      pos -= total;
      // state reads are <= 16 bits here: the sums fit in int32
      llS = ((int)le.x >> 16) + lnb;
      mlS = ((int)me.x >> 16) + mnb;
      ofS = ((int)oe.x >> 16) + onb;
      finish(le, oe, me, ofx, mlx, llx);
    } while (s < cnt);
    if (s >= cnt) break;
    // one sequence on the cold path: a state outside [0, 512) takes the
    // flat table's clip, and the reads are read_back's
    const uint2 le = entry(0, llS), oe = entry(1, ofS), me = entry(2, mlS);
    const int ofx = read_back64(words, nwords, pos, oe.y & 31, &bp);
    pos = bp;
    const int mlx = read_back64(words, nwords, pos, me.y & 31, &bp);
    pos = bp;
    const int llx = read_back64(words, nwords, pos, le.y & 31, &bp);
    pos = bp;
    const int lnb = read_back64(words, nwords, pos, (le.x >> 8) & 0xFF, &bp);
    pos = bp;
    const int mnb = read_back64(words, nwords, pos, (me.x >> 8) & 0xFF, &bp);
    pos = bp;
    const int onb = read_back64(words, nwords, pos, (oe.x >> 8) & 0xFF, &bp);
    pos = bp > 0 ? bp : 0;
    fast = ring.prime(pos);
    llS = sat32((long long)((int)le.x >> 16) + lnb);
    mlS = sat32((long long)((int)me.x >> 16) + mnb);
    ofS = sat32((long long)((int)oe.x >> 16) + onb);
    finish(le, oe, me, ofx, mlx, llx);
  }
}

}  // namespace

extern "C" int atpu_fse_encode_scan(const void* xs, const void* nseq,
                                    const void* nxt, const void* dnb,
                                    const void* dfs, void* pv, void* pn,
                                    void* fin, int n, int maxseq,
                                    void* stream) {
  if (n <= 0) return 0;
  fse_encode_scan_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)nseq, (const int32_t*)nxt,
      (const int32_t*)dnb, (const int32_t*)dfs, (int32_t*)pv, (int32_t*)pn,
      (int32_t*)fin, maxseq);
  return (int)cudaGetLastError();
}

extern "C" int atpu_huf_literal_scan(const void* sbytes, const void* slens,
                                     const void* scounts, const void* huftab,
                                     const void* huflog, void* syms,
                                     int nblocks, int sb, int maxl,
                                     void* stream) {
  if (nblocks <= 0) return 0;
  huf_literal_scan_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sbytes, (const int32_t*)slens, (const int32_t*)scounts,
      (const int32_t*)huftab, (const int32_t*)huflog, (uint8_t*)syms,
      nblocks, sb, maxl);
  return (int)cudaGetLastError();
}

extern "C" int atpu_fse_sequence_scan(const void* qbytes, const void* qlens,
                                      const void* nbseq, const void* fsetab,
                                      const void* logs, void* ll, void* ml,
                                      void* off, int n, int qb, int maxseq,
                                      void* stream) {
  if (n <= 0) return 0;
  fse_sequence_scan_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qbytes, (const int32_t*)qlens, (const int32_t*)nbseq,
      (const int32_t*)fsetab, (const int32_t*)logs, (int32_t*)ll,
      (int32_t*)ml, (int32_t*)off, n, qb, maxseq);
  return (int)cudaGetLastError();
}
