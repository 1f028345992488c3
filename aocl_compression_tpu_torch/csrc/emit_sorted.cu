// The sort-emit serializers of the lz4 and snappy tile encoders, as two
// kernels: emit_lz4 and emit_snappy.
//
// Replace the JAX package's _emit_sorted (XLA code there, not a Pallas
// kernel): aocl_compression_tpu/ops/lz4_device.py:533-660, and
// _emit_snappy_sorted, aocl_compression_tpu/ops/snappy_device.py:192-320.
// For each block of a batch they take the tile parse (sel, cpos, cml, coff
// on the M = B / G tile domain) and the block's bytes, and give the
// serialized body: every input byte i has an output position op(i) and a
// value (its own byte for a literal, a header byte for a matched "spare"),
// and out[j] is the low byte of the j-th smallest key (op << 8 | value) of
// the row (op >= 1 << 17 sorting last as the key 1 << 26), for j < body.
//
// The port's plain version (ops/lz4_device._emit_sorted_plain,
// ops/snappy_device._emit_snappy_sorted_plain) is about forty passes over
// (N, B) tensors (int64 packs, repeat_interleave of the tile fields to the
// byte domain, cummax / cummin fills) and one torch.sort of the keys a
// row. The function needs the bytes and the tile fields read once and the
// body written once, so each row is one CTA of 1,024 threads:
//   tile phase  the row's tiles in chunks of 4,096, 4 consecutive tiles a
//               thread; two block scans a chunk carry, from chunk to
//               chunk, the cummax of the ends (each literal run's start,
//               the tail), the inclusive sum of the sequence sizes, the
//               fields of the last selected sequence (F) and of its
//               predecessor (P) as the plain version's cummax of 64-bit
//               packs (one associative scan: P over a segment is the max
//               of F before each selected tile), and the next selected
//               position (N) as a suffix minimum, whose carry from later
//               chunks a first pass over the row gives;
//   byte phase  each thread computes (op, value) for the G bytes of each
//               of its tiles with the plain version's formulas and writes
//               the value at op in a row buffer in shared memory, setting
//               op's bit in an occupancy bitmap;
//   placement   a key's rank is the occupied slots below its op (a prefix
//               count over the bitmap), so each value goes to its rank in
//               a second row buffer, which one coalesced store writes out.
// In a row that is not flagged the ops cover [0, body) exactly, so rank
// equals op. A flagged row (some sequence's header needs more bytes than
// its match has spares) leaves holes, which the prefix count closes. A key
// that the bitmap cannot hold (a second key at an occupied op, an op below
// 0 or past the buffer, a value outside a byte: none of them occurs for
// the tile parse _grid_select gives) goes to a list of up to kXCap keys,
// which is sorted and merged by rank, so the row still gets the sort's
// bytes; a row with more traps.
// What bounds them: bytes (each input read once, the body written once:
// 13 B a tile and 2 B a byte position, about 0.03 ms for the smoke's 256
// rows of 64 KiB at G = 4). No sort, no (N, B) temporary: the row's
// buffers live in shared memory (about 170 KB at B = 65,536, one CTA an
// SM). This design runs at ~8.5x that bound: a row is one CTA's
// instruction stream (about 9,000 instructions a thread), so the scans'
// warp totals are scanned once by warp 0 and each tile's sequence sizes
// computed once, not per byte. The fields of the tile scan are 16-bit (positions below 2^16), but
// the packs stay 64-bit as the plain version's, so every row whose
// selected tiles hold non-negative positions, lengths and offsets gets the
// plain version's bytes, not just the rows _grid_select gives.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesPerThread = 4;
constexpr int kChunk = kThreads * kTilesPerThread;   // tiles a chunk
constexpr int kMaxChunks = 16;                       // M <= 65,536
constexpr int kDummyPos = 1 << 17;   // > any real out position
constexpr int kBigPos = 1 << 20;     // "no next sequence"
constexpr int kXCap = 2048;          // irregular keys a row (see above)
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// The output-position buffer a row: B plus the most a flagged row's
// headers can add (a sequence adds at most (lit + 1) / 255 + 2 bytes past
// its input span and needs lit >= 61 to add any), in whole bitmap words.
__host__ __device__ constexpr int row_cap(int b) {
  return (b + b / 16 + 256 + 1023) & ~1023;
}

// int32 arithmetic that wraps as the plain version's tensors do
__device__ __forceinline__ int shl(int x, int s) {
  return (int)((unsigned)x << s);
}

// --- the two element formats --------------------------------------------

struct Lz4Fmt {
  static __device__ __forceinline__ int nlx(int lit) {
    return lit < 15 ? 0 : 1 + (lit - 15) / 255;
  }
  static __device__ __forceinline__ int nmx(int ml) {
    return ml - 4 < 15 ? 0 : 1 + (ml - 19) / 255;
  }
  // (sequence bytes, header bytes) of a selected tile
  static __device__ __forceinline__ void size(int lit, int ml, int off,
                                              int& sz, int& hdr) {
    hdr = 3 + nlx(lit) + nmx(ml);
    sz = hdr + lit;
  }
  static __device__ __forceinline__ int seq_size(int lit, int ml, int off) {
    int sz, hdr;
    size(lit, ml, off, sz, hdr);
    return sz;
  }
  // literal byte i of the next sequence, its literal run from endF
  static __device__ __forceinline__ int op_next(int incl, int litN, int i,
                                                int endF) {
    return incl + 1 + nlx(litN) + (i - endF);
  }
  // (op, value) of byte i covered by the sequence (pos, off, lit, end)
  // whose body starts at excl; d is the byte
  static __device__ __forceinline__ void covered(int i, int d, int pos,
                                                 int off, int lit, int end,
                                                 int excl, int& op,
                                                 int& val) {
    const int ml = end - pos;
    const int nl = nlx(lit), nm = nmx(ml);
    const int k = i - pos;
    if (k < 0) {                                   // a literal
      op = excl + 1 + nl + (i - (pos - lit));
      val = d;
      return;
    }
    if (k >= 3 + nl + nm) {                        // a spare past the header
      op = kDummyPos;
      val = 0;
      return;
    }
    const int base = excl + 1 + nl + lit;          // the offset field
    if (k == 0) {
      op = excl;
      val = shl(min(lit, 15), 4) | min(ml - 4, 15);
    } else if (k <= nl) {
      op = excl + k;
      val = max(0, min(lit - 15 - 255 * (k - 1), 255));
    } else if (k == nl + 1) {
      op = base;
      val = off & 255;
    } else if (k == nl + 2) {
      op = base + 1;
      val = off >> 8;
    } else {
      const int j = k - nl - 3;
      op = base + 2 + j;
      val = max(0, min(ml - 19 - 255 * j, 255));
    }
  }
};

struct SnappyFmt {
  static __device__ __forceinline__ int lit_hdr(int lit) {
    return lit == 0 ? 0 : lit <= 60 ? 1 : lit <= 256 ? 2 : 3;
  }
  // the reference's EmitCopy split: (n64, l3, qual, ncopy, copy bytes)
  static __device__ __forceinline__ void copy(int ml, int off, int& n64,
                                              int& l3, bool& qual,
                                              int& ncopy, int& cb) {
    n64 = max(ml - 4, 0) >> 6;
    const int l2 = ml - 64 * n64;
    const int has60 = l2 > 64 ? 1 : 0;
    l3 = l2 - 60 * has60;
    qual = l3 < 12 && off < 2048 && l3 >= 4;
    ncopy = n64 + has60 + 1;
    cb = 3 * (ncopy - 1) + (qual ? 2 : 3);
  }
  static __device__ __forceinline__ void size(int lit, int ml, int off,
                                              int& sz, int& hdr) {
    int n64, l3, ncopy, cb;
    bool qual;
    copy(ml, off, n64, l3, qual, ncopy, cb);
    hdr = lit_hdr(lit) + cb;
    sz = hdr + lit;
  }
  static __device__ __forceinline__ int seq_size(int lit, int ml, int off) {
    int sz, hdr;
    size(lit, ml, off, sz, hdr);
    return sz;
  }
  static __device__ __forceinline__ int op_next(int incl, int litN, int i,
                                                int endF) {
    return incl + lit_hdr(litN) + (i - endF);
  }
  static __device__ __forceinline__ void covered(int i, int d, int pos,
                                                 int off, int lit, int end,
                                                 int excl, int& op,
                                                 int& val) {
    const int ml = end - pos;
    const int hdr = lit_hdr(lit);
    int n64, l3, ncopy, cb;
    bool qual;
    copy(ml, off, n64, l3, qual, ncopy, cb);
    const int k = i - pos;
    if (k < 0) {                                   // a literal
      op = excl + hdr + (i - (pos - lit));
      val = d;
      return;
    }
    const int k2 = k - hdr;
    if (k2 >= cb) {                                // a spare past the ops
      op = kDummyPos;
      val = 0;
      return;
    }
    if (k < hdr) {                                 // the literal header
      const int lm1 = lit - 1;
      op = excl + k;
      val = k == 0 ? (lit <= 60 ? shl(lm1, 2) : lit <= 256 ? 60 << 2
                                                            : 61 << 2)
          : k == 1 ? (lm1 & 0xFF)
                   : ((lm1 >> 8) & 0xFF);
      return;
    }
    op = excl + hdr + lit + k2;                    // the copy ops
    // divide-by-3 by the JAX package's magic multiply on a clamped domain
    const int k2c = max(0, min(k2, 1023));
    const int jop = (k2c * 43691) >> 17;
    const int r = k2c - 3 * jop;
    const int relf = k2 - 3 * (ncopy - 1);
    if (k2 < 3 * (ncopy - 1)) {
      const int mid = jop < n64 ? (0x02 | (63 << 2)) : (0x02 | (59 << 2));
      val = r == 0 ? mid : r == 1 ? (off & 0xFF) : (off >> 8);
    } else {
      const int fin = qual ? (0x01 | shl(l3 - 4, 2) | shl(off >> 8, 5))
                           : (0x02 | shl(l3 - 1, 2));
      val = relf == 0 ? fin : relf == 1 ? (off & 0xFF) : (off >> 8);
    }
  }
};

// --- the tile scan ----------------------------------------------------------

// A segment of tiles: the sum of its sequence sizes, the max of its F
// packs (q1 = pos << 16 | off, q2 = (end - 1) << 16 | lit; an unselected
// tile gives 0, the plain version's fill), and the max over its selected
// tiles of the F pack before each (from 0 at the segment's start): with
// F_in the packs before the segment, P = max(P_in, any ? max(F_in, pin) :
// 0).
struct Seg {
  int sum;
  int any;
  long long f1, f2, p1, p2;
};

__device__ __forceinline__ Seg seg_id() { return Seg{0, 0, 0, 0, 0, 0}; }

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  Seg c;
  c.sum = a.sum + b.sum;
  c.any = a.any | b.any;
  c.f1 = max(a.f1, b.f1);
  c.f2 = max(a.f2, b.f2);
  c.p1 = b.any ? max(a.p1, max(a.f1, b.p1)) : a.p1;
  c.p2 = b.any ? max(a.p2, max(a.f2, b.p2)) : a.p2;
  return c;
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  Seg o;
  o.sum = __shfl_up_sync(0xffffffffu, s.sum, d);
  o.any = __shfl_up_sync(0xffffffffu, s.any, d);
  o.f1 = __shfl_up_sync(0xffffffffu, s.f1, d);
  o.f2 = __shfl_up_sync(0xffffffffu, s.f2, d);
  o.p1 = __shfl_up_sync(0xffffffffu, s.p1, d);
  o.p2 = __shfl_up_sync(0xffffffffu, s.p2, d);
  return o;
}

// Shared state of a CTA besides the dynamic row buffers. Each block scan
// writes its warps' totals, warp 0 scans them (with the chunk's carry) into
// the warps' exclusive prefixes and the chunk's total.
struct Shared {
  int amax[kWarps];      // warp totals of the ends' max
  int amin[kWarps];      // warp totals of the next positions' min
  int amax_ex[kWarps];   // max of the ends before each warp, carry included
  int amin_ex[kWarps];   // min of the next positions after each warp
  int atot;              // the ends' max through the chunk
  Seg seg[kWarps];       // warp totals of the size / F / P scan
  Seg seg_ex[kWarps];    // the scan before each warp, carry included
  Seg seg_tot;           // the scan through the chunk
  int isum[kWarps];      // warp totals of the bitmap's popcounts
  int chunk_min[kMaxChunks];
  int nx;                // irregular keys
};

// The tile fields each byte of a tile needs; szF and szP are the sizes of
// F and P (P's fields as the plain version unpacks them).
struct Tile {
  int incl, posN;
  bool hasF;
  int posF, offF, endF, litF;
  int posP, offP, endP1, litP;
  int szF, szP;
};

template <class Fmt>
__device__ __forceinline__ void byte_key(const Tile& T, int i, int d,
                                         int& op, int& val) {
  if (T.hasF && i < T.endF) {
    const bool useP = i < T.posF - T.litF;   // a spare of F's predecessor
    const int pos = useP ? T.posP : T.posF;
    const int off = useP ? T.offP : T.offF;
    const int lit = useP ? T.litP : T.litF;
    const int end = useP ? T.endP1 + 1 : T.endF;
    const int excl = useP ? T.incl - T.szF - T.szP : T.incl - T.szF;
    Fmt::covered(i, d, pos, off, lit, end, excl, op, val);
  } else if (T.posN >= kBigPos) {            // the trailing literals
    op = kDummyPos;
    val = 0;
  } else {                                   // the next sequence's literal
    op = Fmt::op_next(T.incl, T.posN - T.endF, i, T.endF);
    val = d;
  }
}

// Exclusive block sum of v; *total gets the whole block's sum. Uses
// sh->isum; the caller keeps a barrier between two calls.
__device__ __forceinline__ int block_excl_sum(int v, Shared* sh,
                                              int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) sh->isum[w] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int k = 0; k < kWarps; ++k) {
    const int s = sh->isum[k];
    before += k < w ? s : 0;
    all += s;
  }
  *total = all;
  return before + inc - v;
}

template <class Fmt>
__device__ void emit_row(const uint8_t* __restrict__ data,
                         const int32_t* __restrict__ nlen,
                         const uint8_t* __restrict__ sel,
                         const int32_t* __restrict__ cpos,
                         const int32_t* __restrict__ cml,
                         const int32_t* __restrict__ coff,
                         long long ss0, long long ss1, long long sp0,
                         long long sp1, long long sl0, long long sl1,
                         long long so0, long long so1,
                         uint8_t* __restrict__ out, int32_t* body_out,
                         int32_t* tail_out, uint8_t* flag_out, int B, int G,
                         int cap) {
  __shared__ Shared sh;
  extern __shared__ uint4 smem[];
  uint8_t* outbuf = reinterpret_cast<uint8_t*>(smem);       // B bytes
  uint8_t* vals = outbuf + round16(B);                       // cap bytes
  uint32_t* bm = reinterpret_cast<uint32_t*>(vals + cap);    // cap / 32
  uint32_t* wpre = bm + cap / 32;                            // cap / 32
  int32_t* xl = reinterpret_cast<int32_t*>(wpre + cap / 32);  // kXCap
  int32_t* xs = xl + kXCap;                                  // kXCap

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long row = blockIdx.x;
  const int M = B / G;
  const int nch = (M + kChunk - 1) / kChunk;
  const int n = nlen[row];
  const uint8_t* drow = data + row * B;
  const uint8_t* srow = sel + row * ss0;
  const int32_t* prow = cpos + row * sp0;
  const int32_t* lrow = cml + row * sl0;
  const int32_t* orow = coff + row * so0;

  for (int j = tid; j < round16(B) / 16; j += kThreads)
    smem[j] = make_uint4(0, 0, 0, 0);
  for (int j = tid; j < cap / 32; j += kThreads) bm[j] = 0;
  if (tid < kMaxChunks) sh.chunk_min[tid] = INT_MAX;
  if (tid == 0) sh.nx = 0;
  __syncthreads();

  // each chunk's least next-position value: selected tiles give cpos,
  // the others kBigPos (the plain version's fill)
  for (int c = 0; c < nch; ++c) {
    int m = INT_MAX;
    const int t0 = c * kChunk + tid * kTilesPerThread;
#pragma unroll
    for (int r = 0; r < kTilesPerThread; ++r) {
      const int t = t0 + r;
      if (t < M) m = min(m, srow[t * ss1] ? prow[t * sp1] : kBigPos);
    }
    for (int d = 16; d; d >>= 1)
      m = min(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) atomicMin(&sh.chunk_min[c], m);
  }
  __syncthreads();

  int ce_carry = INT_MIN;     // cummax of the ends before the chunk
  Seg carry = seg_id();       // sizes, F and P before the chunk
  bool flag = false;
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * kChunk + tid * kTilesPerThread;
    bool s[kTilesPerThread];
    int p[kTilesPerThread], l[kTilesPerThread], o[kTilesPerThread];
#pragma unroll
    for (int r = 0; r < kTilesPerThread; ++r) {
      const int t = t0 + r;
      const bool real = t < M;
      s[r] = real && srow[t * ss1];
      p[r] = real ? prow[t * sp1] : 0;
      l[r] = real ? lrow[t * sl1] : 0;
      o[r] = real ? orow[t * so1] : 0;
    }

    // scan A: the ends' cummax forward, the next position backward
    int emax = INT_MIN, vmin = INT_MAX;
#pragma unroll
    for (int r = 0; r < kTilesPerThread; ++r) {
      if (t0 + r < M) {
        emax = max(emax, s[r] ? p[r] + l[r] : 0);
        vmin = min(vmin, s[r] ? p[r] : kBigPos);
      }
    }
    int emax_inc = emax, vmin_inc = vmin;
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, emax_inc, d);
      const int b = __shfl_down_sync(0xffffffffu, vmin_inc, d);
      if (lane >= d) emax_inc = max(emax_inc, a);
      if (lane + d < 32) vmin_inc = min(vmin_inc, b);
    }
    __syncthreads();          // the last chunk's readers of sh are done
    if (lane == 31) sh.amax[w] = emax_inc;
    if (lane == 0) sh.amin[w] = vmin_inc;
    __syncthreads();
    if (w == 0) {
      int a = lane < kWarps ? sh.amax[lane] : INT_MIN;
      int b = lane < kWarps ? sh.amin[lane] : INT_MAX;
      for (int d = 1; d < 32; d <<= 1) {
        const int ua = __shfl_up_sync(0xffffffffu, a, d);
        const int db = __shfl_down_sync(0xffffffffu, b, d);
        if (lane >= d) a = max(a, ua);
        if (lane + d < 32) b = min(b, db);
      }
      const int ea = __shfl_up_sync(0xffffffffu, a, 1);
      const int eb = __shfl_down_sync(0xffffffffu, b, 1);
      if (lane < kWarps) {
        sh.amax_ex[lane] = lane == 0 ? ce_carry : max(ce_carry, ea);
        sh.amin_ex[lane] = lane == 31 ? INT_MAX : eb;
      }
      if (lane == 31) sh.atot = max(ce_carry, a);
    }
    __syncthreads();
    int ce = __shfl_up_sync(0xffffffffu, emax_inc, 1);
    int nx_pos = __shfl_down_sync(0xffffffffu, vmin_inc, 1);
    if (lane == 0) ce = INT_MIN;
    if (lane == 31) nx_pos = INT_MAX;
    ce = max(ce, sh.amax_ex[w]);
    nx_pos = min(nx_pos, sh.amin_ex[w]);
    for (int k = c + 1; k < nch; ++k) nx_pos = min(nx_pos, sh.chunk_min[k]);
    ce_carry = sh.atot;

    // each tile's literal run start (the cummax of the ends before it)
    int lit[kTilesPerThread];
    {
      int run = ce;
#pragma unroll
      for (int r = 0; r < kTilesPerThread; ++r) {
        const int t = t0 + r;
        const int pe = t == 0 ? 0 : run;
        lit[r] = s[r] ? p[r] - pe : 0;
        if (t < M) run = max(run, s[r] ? p[r] + l[r] : 0);
      }
    }

    // scan B: sizes, F and P
    Seg loc = seg_id();
#pragma unroll
    for (int r = 0; r < kTilesPerThread; ++r) {
      if (!s[r]) continue;
      int sz, hdr;
      Fmt::size(lit[r], l[r], o[r], sz, hdr);
      flag |= hdr > l[r];
      const long long q1 = ((long long)p[r] << 16) | (long long)o[r];
      const long long q2 =
          ((long long)(int)((unsigned)p[r] + (unsigned)l[r] - 1u) << 16) |
          (long long)lit[r];
      loc.p1 = max(loc.p1, loc.f1);
      loc.p2 = max(loc.p2, loc.f2);
      loc.f1 = max(loc.f1, q1);
      loc.f2 = max(loc.f2, q2);
      loc.sum += sz;
      loc.any = 1;
    }
    Seg inc = loc;
    for (int d = 1; d < 32; d <<= 1) {
      const Seg a = shfl_up(inc, d);
      if (lane >= d) inc = combine(a, inc);
    }
    if (lane == 31) sh.seg[w] = inc;
    __syncthreads();
    if (w == 0) {
      Seg a = lane < kWarps ? sh.seg[lane] : seg_id();
      for (int d = 1; d < 32; d <<= 1) {
        const Seg u = shfl_up(a, d);
        if (lane >= d) a = combine(u, a);
      }
      Seg e = shfl_up(a, 1);
      if (lane == 0) e = seg_id();
      if (lane < kWarps) sh.seg_ex[lane] = combine(carry, e);
      if (lane == 31) sh.seg_tot = combine(carry, a);
    }
    __syncthreads();
    Seg ex = shfl_up(inc, 1);
    if (lane == 0) ex = seg_id();
    const Seg pre = combine(sh.seg_ex[w], ex);
    carry = sh.seg_tot;

    // byte phase: each tile's fields, then its G bytes
    int incl = pre.sum;
    long long f1 = pre.f1, f2 = pre.f2, p1 = pre.p1, p2 = pre.p2;
#pragma unroll
    for (int r = 0; r < kTilesPerThread; ++r) {
      const int t = t0 + r;
      if (t >= M) break;
      if (s[r]) {
        const long long q1 = ((long long)p[r] << 16) | (long long)o[r];
        const long long q2 =
            ((long long)(int)((unsigned)p[r] + (unsigned)l[r] - 1u) << 16) |
            (long long)lit[r];
        p1 = max(p1, f1);
        p2 = max(p2, f2);
        f1 = max(f1, q1);
        f2 = max(f2, q2);
        incl += Fmt::seq_size(lit[r], l[r], o[r]);
      }
      // the next selected position after t
      int posN = nx_pos;
#pragma unroll
      for (int r2 = kTilesPerThread - 1; r2 > r; --r2)
        if (t0 + r2 < M) posN = min(posN, s[r2] ? p[r2] : kBigPos);
      Tile T;
      T.incl = incl;
      T.posN = posN == INT_MAX ? kBigPos : posN;
      T.hasF = f1 != 0;
      T.posF = (int)(f1 >> 16);
      T.offF = (int)(f1 & 0xFFFF);
      T.endF = T.hasF ? (int)(f2 >> 16) + 1 : 0;
      T.litF = (int)(f2 & 0xFFFF);
      T.posP = (int)(p1 >> 16);
      T.offP = (int)(p1 & 0xFFFF);
      T.endP1 = (int)(p2 >> 16);
      T.litP = (int)(p2 & 0xFFFF);
      T.szF = Fmt::seq_size(T.litF, T.endF - T.posF, T.offF);
      T.szP = Fmt::seq_size(T.litP, T.endP1 + 1 - T.posP, T.offP);
      for (int g = 0; g < G; ++g) {
        const int i = t * G + g;
        int op, val;
        byte_key<Fmt>(T, i, drow[i], op, val);
        if (i >= n || op >= kDummyPos) continue;   // sorts last, byte 0
        if (op >= 0 && op < cap && (unsigned)val <= 255u) {
          const uint32_t bit = 1u << (op & 31);
          if (!(atomicOr(&bm[op >> 5], bit) & bit)) {
            vals[op] = (uint8_t)val;
            continue;
          }
        }
        const int k = atomicAdd(&sh.nx, 1);
        if (k < kXCap) xl[k] = (int)(((unsigned)op << 8) | (unsigned)val);
      }
    }
  }
  __syncthreads();

  // placement: the occupied slots' prefix count, word by word
  const int nx = sh.nx;
  if (nx > kXCap) __trap();
  const int words = cap / 32;
  const int wpt = (words + kThreads - 1) / kThreads;
  int cnt = 0;
  for (int k = 0; k < wpt; ++k) {
    const int wd = tid * wpt + k;
    if (wd < words) cnt += __popc(bm[wd]);
  }
  int nr;
  int run = block_excl_sum(cnt, &sh, &nr);
  for (int k = 0; k < wpt; ++k) {
    const int wd = tid * wpt + k;
    if (wd < words) {
      wpre[wd] = run;
      run += __popc(bm[wd]);
    }
  }
  // the irregular keys in order (ties by list index)
  for (int a = tid; a < nx; a += kThreads) {
    const int x = xl[a];
    int rank = 0;
    for (int b2 = 0; b2 < nx; ++b2) {
      const int y = xl[b2];
      rank += (y < x || (y == x && b2 < a)) ? 1 : 0;
    }
    xs[rank] = x;
  }
  __syncthreads();

  const int body = carry.sum;
  const int lim = max(0, min(body, B));
  const int nd = B - nr - nx;       // keys that sort last (1 << 26)
  // the occupied slots: rank = slots below + irregular keys below
  for (int op = tid; op < cap; op += kThreads) {
    const uint32_t wd = bm[op >> 5];
    if (!((wd >> (op & 31)) & 1u)) continue;
    int rank = (int)wpre[op >> 5] + __popc(wd & ((1u << (op & 31)) - 1u));
    if (nx) {
      const int key = (op << 8) | vals[op];
      int lo = 0, hi = nx;              // irregular keys < key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (xs[mid] < key) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    if (rank < lim) outbuf[rank] = vals[op];
  }
  // the irregular keys: rank = slots with keys <= x + their own order
  // (+ the last-sorting keys when x >= 1 << 26)
  for (int a = tid; a < nx; a += kThreads) {
    const int x = xs[a];
    int below = 0;
    if (x >= 0) {
      const int op = x >> 8;
      if (op >= cap) {
        below = nr;
      } else {
        const uint32_t wd = bm[op >> 5];
        below = (int)wpre[op >> 5] + __popc(wd & ((1u << (op & 31)) - 1u));
        if (((wd >> (op & 31)) & 1u) && vals[op] <= (x & 255)) ++below;
      }
    }
    const int rank = below + a + (x >= (1 << 26) ? nd : 0);
    if (rank < lim) outbuf[rank] = (uint8_t)(x & 0xFF);
  }
  const int any = __syncthreads_or(flag ? 1 : 0);

  // the store: the row buffer holds zeros from lim on
  uint8_t* orow_out = out + row * B;
  if ((B & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    uint4* dst = reinterpret_cast<uint4*>(orow_out);
    for (int j = tid; j < B / 16; j += kThreads) dst[j] = smem[j];
  } else {
    for (int j = tid; j < B; j += kThreads) orow_out[j] = outbuf[j];
  }
  if (tid == 0) {
    body_out[row] = body;
    tail_out[row] = n - ce_carry;
    flag_out[row] = any ? 1 : 0;
  }
}

#define ATPU_EMIT_ARGS                                                      \
  const uint8_t *__restrict__ data, const int32_t *__restrict__ nlen,      \
      const uint8_t *__restrict__ sel, const int32_t *__restrict__ cpos,   \
      const int32_t *__restrict__ cml, const int32_t *__restrict__ coff,   \
      long long ss0, long long ss1, long long sp0, long long sp1,          \
      long long sl0, long long sl1, long long so0, long long so1,          \
      uint8_t *__restrict__ out, int32_t *body, int32_t *tail,             \
      uint8_t *flag, int B, int G, int cap
#define ATPU_EMIT_PASS                                                      \
  data, nlen, sel, cpos, cml, coff, ss0, ss1, sp0, sp1, sl0, sl1, so0, so1, \
      out, body, tail, flag, B, G, cap

__global__ void __launch_bounds__(kThreads, 1) emit_lz4(ATPU_EMIT_ARGS) {
  emit_row<Lz4Fmt>(ATPU_EMIT_PASS);
}

__global__ void __launch_bounds__(kThreads, 1) emit_snappy(ATPU_EMIT_ARGS) {
  emit_row<SnappyFmt>(ATPU_EMIT_PASS);
}

int smem_bytes(int b) {
  const int cap = row_cap(b);
  return round16(b) + cap + 2 * (cap / 32) * 4 + 2 * kXCap * 4;
}

// Above 48 KB a kernel needs the opt-in, once per device and kernel (set
// outside any stream capture: the first call of a process is eager).
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

// fmt 0: lz4, 1: snappy. strides[8]: (row, tile) element strides of sel,
// cpos, cml and coff. Returns a CUDA error code (0 on success).
extern "C" int atpu_emit_sorted(int fmt, const void* data, const void* nlen,
                                const void* sel, const void* cpos,
                                const void* cml, const void* coff,
                                const long long* strides, void* out,
                                void* body, void* tail, void* flag, int n,
                                int b, int g, void* stream) {
  if (n <= 0) return 0;
  if (b <= 0 || b > 65536 || g <= 0 || b % g || b / g > kMaxChunks * kChunk ||
      (fmt != 0 && fmt != 1))
    return (int)cudaErrorInvalidValue;
  static bool opted[2][kMaxDevices] = {};
  const auto kernel = fmt == 0 ? emit_lz4 : emit_snappy;
  cudaError_t err = opt_in(kernel, opted[fmt]);
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(b);
  if (smem + (int)sizeof(Shared) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  kernel<<<(unsigned)n, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)nlen, (const uint8_t*)sel,
      (const int32_t*)cpos, (const int32_t*)cml, (const int32_t*)coff, s[0],
      s[1], s[2], s[3], s[4], s[5], s[6], s[7], (uint8_t*)out,
      (int32_t*)body, (int32_t*)tail, (uint8_t*)flag, b, g, row_cap(b));
  return (int)cudaGetLastError();
}
