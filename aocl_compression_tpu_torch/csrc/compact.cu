// compact_rows: pack variable-sized encoder chunks into one dense buffer.
//
// Replaces aocl_compression_tpu/ops/compact.py::_pallas_compact, which
// issued one async DMA of ROWS full rows per chunk and relied on the TPU
// grid running in order (chunk i+1 overwrote chunk i's garbage tail). GPU
// blocks run in parallel and in no order, so here each block copies ONLY
// its chunk's own ceil(size/512) rows to row offset row_offs[i]: the
// destination ranges are disjoint and no ordering is needed.
//
// Bound: HBM bytes. The function must read and write used_rows * 512 bytes
// (2 * used_rows * 512 bytes of traffic) and does no arithmetic, so its
// floor is that traffic over the card's memory rate. The design moves
// exactly those bytes, as 16-byte vector loads and stores by neighbouring
// threads on neighbouring addresses (fully coalesced), with several
// independent loads in flight per thread and no shared memory.
//
// Layout: src is the padded (N, rows_per_chunk * 512) encoder output,
// dst holds at least sum(ceil(sizes/512)) rows of 512 bytes. row_offs is
// the exclusive cumsum of ceil(sizes/512), computed by the caller on the
// device. Every row is 512 bytes = 32 int4 vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecPerRow = 512 / 16;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const int4* __restrict__ src,
                    const int32_t* __restrict__ row_offs,
                    const int32_t* __restrict__ sizes,
                    int4* __restrict__ dst, int rows_per_chunk) {
  const int i = blockIdx.x;
  const int rows = (sizes[i] + 511) >> 9;
  const int nvec = rows * kVecPerRow;
  const int4* s = src + (size_t)i * rows_per_chunk * kVecPerRow;
  int4* d = dst + (size_t)row_offs[i] * kVecPerRow;
  for (int base = 0; base < nvec; base += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads + threadIdx.x;
      if (k < nvec) v[u] = __ldg(s + k);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * kThreads + threadIdx.x;
      if (k < nvec) d[k] = v[u];
    }
  }
}

}  // namespace

// Launches one block per chunk on `stream`; returns cudaGetLastError().
extern "C" int atpu_compact_rows(const void* src, const void* row_offs,
                                 const void* sizes, void* dst, int n_chunks,
                                 int rows_per_chunk, void* stream) {
  if (n_chunks > 0) {
    compact_rows_kernel<<<n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)src, (const int32_t*)row_offs, (const int32_t*)sizes,
        (int4*)dst, rows_per_chunk);
  }
  return (int)cudaGetLastError();
}
