// The three serial scans of the zstd device tiers, one CUDA block per lane.
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
// op of every step from the host. Here one CUDA block per zstd block runs
// each lane to its own count with the lane's tables in shared memory: one
// thread per lane in fse_encode_scan and huf_literal_scan, one warp reading
// through a register bit buffer in fse_sequence_scan (see there); the
// block's other threads load the tables and write the fixed values of the
// slots past the count. Bound: the serial chain of dependent shared-memory
// loads of the longest lane, not HBM bytes (the inputs and outputs are read
// and written once).
//
// The arithmetic follows the plain versions (ops/zstd_device._fse_scan_plain,
// ops/zstd_decode_device._literal_scan_plain / _sequence_scan_plain), which
// follow the JAX package: XLA's shifts (amounts outside [0, 32) give 0, or
// the sign for a right shift), its gathers (clamped; a negative index of a
// vmapped table counts from the end first; take_along_axis past the end
// reads INT_MIN) and _read_back's zero-fill below bit 0. Sums that can wrap
// on corrupt input are done in unsigned arithmetic, as int32 wraps in XLA;
// fse_sequence_scan keeps its bit positions and states in 64 bits, as its
// plain version's int64 tensors do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNxt = 512;   // next-state table width of one field
constexpr int kSym = 64;    // symbol-transform width of one field
constexpr int kHuf = 2048;  // Huffman decode table of one block
constexpr int kFse = 512;   // FSE decode table of one field

__device__ __forceinline__ int shl(int x, int n) {
  return (n < 0 || n >= 32) ? 0 : (int)((unsigned)x << n);
}

__device__ __forceinline__ int sra(int x, int n) {
  return (n < 0 || n >= 32) ? (x < 0 ? -1 : 0) : (x >> n);
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

// --- encode ------------------------------------------------------------------

struct FseTab {
  const int32_t* nxt;
  const int32_t* dnb;
  const int32_t* dfs;
};

__device__ __forceinline__ int fse_init(const FseTab& t, int c) {
  const int ci = tab_index(c, kSym);
  const int d = t.dnb[ci];
  const int nbout = sra(wadd(d, 1 << 15), 16);
  const int i = wadd(sra(wsub(shl(nbout, 16), d), nbout), t.dfs[ci]);
  return t.nxt[tab_index(i, kNxt)];
}

__device__ __forceinline__ int fse_enc(const FseTab& t, int state, int c,
                                       int* val, int* nbits) {
  const int ci = tab_index(c, kSym);
  const int nb = sra(wadd(state, t.dnb[ci]), 16);
  *nbits = nb;
  *val = state & wsub(shl(1, nb), 1);
  const int i = wadd(sra(state, nb), t.dfs[ci]);
  return t.nxt[tab_index(i, kNxt)];
}

// xs (n, maxseq, 8): [llc, llx, llb, mlc, mlx, mlb, ofc, ofx] per sequence,
// in block order; nxt (n, 3, 512), dnb / dfs (n, 3, 64) for [ll, ml, of].
// Step r encodes sequence nseq - 1 - r: pv / pn (n, maxseq, 6) in that
// processing order, [of, ml, ll states, ll, ml, of extras]; rows past nseq
// are zero. fin (n, 3): the final [ll, ml, of] states.
__global__ void __launch_bounds__(kThreads)
fse_encode_scan_kernel(const int32_t* __restrict__ xs,
                       const int32_t* __restrict__ nseq,
                       const int32_t* __restrict__ nxt,
                       const int32_t* __restrict__ dnb,
                       const int32_t* __restrict__ dfs,
                       int32_t* __restrict__ pv, int32_t* __restrict__ pn,
                       int32_t* __restrict__ fin, int maxseq) {
  __shared__ int32_t s_nxt[3 * kNxt];
  __shared__ int32_t s_dnb[3 * kSym];
  __shared__ int32_t s_dfs[3 * kSym];
  const size_t lane = blockIdx.x;
  for (int i = threadIdx.x; i < 3 * kNxt; i += blockDim.x)
    s_nxt[i] = nxt[lane * 3 * kNxt + i];
  for (int i = threadIdx.x; i < 3 * kSym; i += blockDim.x) {
    s_dnb[i] = dnb[lane * 3 * kSym + i];
    s_dfs[i] = dfs[lane * 3 * kSym + i];
  }
  int ns = nseq[lane];
  ns = ns < 0 ? 0 : (ns > maxseq ? maxseq : ns);
  int32_t* pvl = pv + lane * maxseq * 6;
  int32_t* pnl = pn + lane * maxseq * 6;
  for (size_t i = (size_t)ns * 6 + threadIdx.x; i < (size_t)maxseq * 6;
       i += blockDim.x) {
    pvl[i] = 0;
    pnl[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const FseTab ll = {s_nxt, s_dnb, s_dfs};
  const FseTab ml = {s_nxt + kNxt, s_dnb + kSym, s_dfs + kSym};
  const FseTab of = {s_nxt + 2 * kNxt, s_dnb + 2 * kSym, s_dfs + 2 * kSym};
  const int32_t* xl = xs + lane * maxseq * 8;
  int st_ll = 0, st_ml = 0, st_of = 0;
  for (int r = 0; r < ns; ++r) {
    const int32_t* x = xl + (size_t)(ns - 1 - r) * 8;
    const int c_ll = x[0], x_ll = x[1], b_ll = x[2];
    const int c_ml = x[3], x_ml = x[4], b_ml = x[5];
    const int c_of = x[6], x_of = x[7];
    int v_of = 0, n_of = 0, v_ml = 0, n_ml = 0, v_ll = 0, n_ll = 0;
    if (r == 0) {  // the last sequence initializes the states
      st_of = fse_init(of, c_of);
      st_ml = fse_init(ml, c_ml);
      st_ll = fse_init(ll, c_ll);
    } else {
      st_of = fse_enc(of, st_of, c_of, &v_of, &n_of);
      st_ml = fse_enc(ml, st_ml, c_ml, &v_ml, &n_ml);
      st_ll = fse_enc(ll, st_ll, c_ll, &v_ll, &n_ll);
    }
    int32_t* v = pvl + (size_t)r * 6;
    int32_t* n = pnl + (size_t)r * 6;
    v[0] = v_of; v[1] = v_ml; v[2] = v_ll; v[3] = x_ll; v[4] = x_ml;
    v[5] = x_of;
    n[0] = n_of; n[1] = n_ml; n[2] = n_ll; n[3] = b_ll; n[4] = b_ml;
    n[5] = c_of;
  }
  fin[lane * 3 + 0] = st_ll;
  fin[lane * 3 + 1] = st_ml;
  fin[lane * 3 + 2] = st_of;
}

// --- decode ------------------------------------------------------------------

// Bits [pos - nbits, pos) of a backward bitstream of nwords little-endian
// words, zero-filled below bit 0; *bp = pos - nbits.
__device__ __forceinline__ int read_back(const uint32_t* __restrict__ words,
                                         int nwords, int pos, int nbits,
                                         int* bp) {
  const int b = wsub(pos, nbits);
  *bp = b;
  int pre = wsub(0, b);  // clip(-b, 0, 31) of the wrapped negation
  pre = pre < 0 ? 0 : (pre > 31 ? 31 : pre);
  const int bpc = b > 0 ? b : 0;
  const int wi = bpc >> 5;
  const unsigned sh = (unsigned)(bpc & 31);
  const uint32_t w0 = wi < nwords ? words[wi] : 0x80000000u;
  const uint32_t w1 = wi + 1 < nwords ? words[wi + 1] : 0u;
  uint32_t v = (w0 >> sh) | (sh == 0 ? 0u : (w1 << (32 - sh)));
  v <<= pre;
  const uint32_t mask =
      (nbits >= 0 && nbits < 32) ? ((1u << nbits) - 1u) : 0xFFFFFFFFu;
  const int r = pre >= nbits ? 0 : (int)(v & mask);
  return nbits > 0 ? r : 0;
}

// Start of a backward reader: (len - 1) * 8 + the last byte's high bit.
__device__ __forceinline__ int init_pos(const uint8_t* __restrict__ bytes,
                                        int cap, int len) {
  const int li = len - 1 > 0 ? len - 1 : 0;
  const int last = li < cap ? (int)bytes[li] : 1;  // past the end: INT_MIN
  const int hb = 31 - __clz(last > 1 ? last : 1);
  return len > 0 ? wadd(shl(len - 1, 3), hb) : 0;
}

// Four lanes (the streams) per zstd block. sbytes (n*4, sb) bytes, slens /
// scounts / huflog (n*4,), huftab (n, 2048) entries sym << 4 | nbits;
// syms (n*4, maxl): the symbol of every slot below the lane's count.
__global__ void __launch_bounds__(32)
huf_literal_scan_kernel(const uint8_t* __restrict__ sbytes,
                        const int32_t* __restrict__ slens,
                        const int32_t* __restrict__ scounts,
                        const int32_t* __restrict__ huftab,
                        const int32_t* __restrict__ huflog,
                        uint8_t* __restrict__ syms, int nblocks, int sb,
                        int maxl) {
  __shared__ uint16_t s_huf[kHuf];
  const int blk = blockIdx.x;
  for (int i = threadIdx.x; i < kHuf; i += blockDim.x)
    s_huf[i] = (uint16_t)huftab[(size_t)blk * kHuf + i];
  __syncthreads();
  if (threadIdx.x >= 4) return;
  const size_t lane = (size_t)blk * 4 + threadIdx.x;
  const uint8_t* bytes = sbytes + lane * sb;
  const uint32_t* words = (const uint32_t*)bytes;
  const int nwords = sb / 4;
  int pos = init_pos(bytes, sb, slens[lane]);
  int cnt = scounts[lane];
  cnt = cnt > maxl ? maxl : cnt;
  const int hlog = huflog[lane];
  const long long base = (long long)blk * kHuf;
  const long long last = (long long)nblocks * kHuf - 1;
  uint8_t* out = syms + lane * maxl;
  for (int k = 0; k < cnt; ++k) {
    int bp;
    const int v = read_back(words, nwords, pos, hlog, &bp);
    int entry;
    if (v >= 0 && v < kHuf) {
      entry = s_huf[v];
    } else {  // the flat table's clip, as jnp.take(mode="clip")
      long long e = base + v;
      e = e < 0 ? 0 : (e > last ? last : e);
      entry = huftab[e];
    }
    out[k] = (uint8_t)(entry >> 4);
    pos = wsub(pos, entry & 15);
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

// fse_sequence_scan's cold path: read_back and init_pos in 64-bit
// positions, as the plain version's int64 (positions do not wrap).
__device__ __forceinline__ int read_back64(const uint32_t* __restrict__ words,
                                           int nwords, long long pos,
                                           int nbits, long long* bp) {
  const long long b = pos - nbits;
  *bp = b;
  const long long pre = b >= 0 ? 0 : (b < -31 ? 31 : -b);
  const long long bpc = b > 0 ? b : 0;
  const long long wi = bpc >> 5;
  const unsigned sh = (unsigned)(bpc & 31);
  const uint32_t w0 = wi < nwords ? words[wi] : 0x80000000u;
  const uint32_t w1 = wi + 1 < nwords ? words[wi + 1] : 0u;
  uint32_t v = (w0 >> sh) | (sh == 0 ? 0u : (w1 << (32 - sh)));
  v <<= (unsigned)pre;
  const uint32_t mask =
      (nbits >= 0 && nbits < 32) ? ((1u << nbits) - 1u) : 0xFFFFFFFFu;
  const int r = pre >= nbits ? 0 : (int)(v & mask);
  return nbits > 0 ? r : 0;
}

__device__ __forceinline__ long long init_pos64(
    const uint8_t* __restrict__ bytes, int cap, int len) {
  const int li = len - 1 > 0 ? len - 1 : 0;
  const int last = li < cap ? (int)bytes[li] : 1;  // past the end: INT_MIN
  const int hb = 31 - __clz(last > 1 ? last : 1);
  return len > 0 ? (long long)(len - 1) * 8 + hb : 0;
}

constexpr int kFastBits = 16;  // widest state read of the fast path
constexpr int kRing = 32;      // stream words in the shared ring
constexpr int kFetchLow = 16;  // the ring is filled down to word kn - 16

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

// Waits until at most 4 commit groups are pending.
__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group 4;" ::: "memory");
}

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
// (INT_MIN words), state reads wider than 16 bits (corrupt tables), and
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
  const uint32_t fold = (uint32_t)__cvta_generic_to_shared(s_fold);
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
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(s_ring);
  auto slot = [&](int k) { return ring + ((k & (kRing - 1)) << 2); };
  auto fetch = [&](int k) {  // word k, clamped to the row, into its slot
    const int kc = k < 0 ? 0 : (k >= nwords ? nwords - 1 : k);
    cp_async4(slot(k), words + kc);
  };
  // fill the ring below pos; false where the fast path cannot run
  auto prime = [&]() -> bool {
    if (pos < 1 || pos > 32LL * nwords) return false;
    const int kn = (int)((pos - 1) >> 5);
    cp_async_wait_all();  // no copy of an earlier prime still in flight
    for (int j = 0; j <= kFetchLow; ++j) fetch(kn - j);
    cp_async_commit();
    cp_async_wait_all();
    return true;
  };
  bool fast = prime();

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
      cp_async_wait_groups();
      const uint32_t w2 = lds(slot(kn)), w1 = lds(slot(kn - 1)),
                     w0 = lds(slot(kn - 2));
      for (int j = kFetchLow - 3; j <= kFetchLow; ++j) fetch(kn - j);
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
    fast = prime();
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
  huf_literal_scan_kernel<<<nblocks, 32, 0, (cudaStream_t)stream>>>(
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
