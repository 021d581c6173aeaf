// estimate_scan_tiled: the FastPQ full-scan estimate, for Hopper.
//
// Replaces the Pallas TPU kernel estimate_scan_tiled / _estimate_T_kernel in
// tinyknn_tpu/ops/kernels.py (pallas_call at line 162). It computes
//
//   out[q, t * 128 + lane] = sum over blocks b of tables[q, b, code(t, lane, b)]
//
// for every query q and every point of every 128-point code tile t, with no
// fold and no selection: the whole (Q, T * 128) estimate matrix is written.
// Tables are int8 (summed in int32, bit for bit what the TPU kernel gives),
// or bf16 / f32 (summed in f32 in logical block order 2sb, 2sb + 1, the
// order of the plain version estimate_scan_tiled_reference; the TPU kernel
// is int8-only and the JAX package sends float tables to XLA).
//
// Design. The TPU kernel contracts a one-hot expansion of kt code tiles
// with the tables on the MXU; here the estimate is a shared-memory table
// lookup, as in K1 (scan_fold_csr.cu). A block owns BQ queries: it stages
// their tables once in shared memory, laid out [q][packed byte sb]
// [lo 16 | hi 16] (a warp's 32 lookups for one (q, sb) touch at most 16
// distinct words, one per bank: conflict-free), then walks tiles
// t = blockIdx.x, blockIdx.x + gridDim.x, ... with 128 threads, one per
// point of a tile, and writes BQ rows of 128 estimates per tile (each a
// coalesced 512-byte store).
//
// What bounds it on the H100. Per point and query it does B_pad lookups. At
// the GloVe corpus (1,183,514 codes, B_pad = 64, 1,000 queries) that is
// ~7.6e10 lookups against a 4.7 GB output (~1.4 ms at 3.35 TB/s) and ~38 MB
// of codes. At K1's measured 3.1e12 lookups/s the lookups take ~25 ms, so
// K3 is bound by shared-memory lookups, as K1 is (prediction written before
// the first card run). Measured (one H100 80GB HBM3, 700 W): 12.2 ms,
// 6.2e12 lookups/s, twice K1's rate: K1's count includes round 0's empty
// query slots and K1 also folds and encodes, while K3 stages its tables
// once per block and walks ~140 tiles with them. Still lookup-bound: the
// output write alone would take ~1.4 ms.
//
// Interface: plain C, called through ctypes. The kernel launches on the
// caller's stream and allocates nothing; the C function returns
// cudaGetLastError() so a refused launch is reported.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
// Blocks in flight the launch aims at (16 blocks of 128 threads per SM of
// the H100's 132): the grid's tile stride is this over the query blocks.
constexpr int kTargetBlocks = 132 * 16;

struct Int8Tables {
  using storage = int8_t;
  using acc = int32_t;
  static __device__ __forceinline__ int32_t widen(storage v) { return v; }
};

struct Bf16Tables {
  using storage = uint16_t;  // raw bf16 bits
  using acc = float;
  static __device__ __forceinline__ float widen(storage v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);  // exact
  }
};

struct F32Tables {
  using storage = float;
  using acc = float;
  static __device__ __forceinline__ float widen(storage v) { return v; }
};

// Grid: x = tile stride (each block walks tiles x, x + gridDim.x, ...),
// y = query block of BQ queries. Block: 128 threads.
template <class Tb, int BQ>
__global__ void __launch_bounds__(kLane)
estimate_scan_tiled_kernel(const typename Tb::storage* __restrict__ tables,
                           const uint8_t* __restrict__ codes,
                           typename Tb::acc* __restrict__ out, int n_queries,
                           int n_tiles, int bs_pad) {
  using S = typename Tb::storage;
  using A = typename Tb::acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tbl = reinterpret_cast<S*>(smem_raw);  // [BQ][bs_pad][32]

  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x;
  const int b_pad = 2 * bs_pad;
  const int m_cols = 16 * b_pad;
  const int row = bs_pad * 32;  // one query's staged tables

  // Stage: input column v * B_pad + s (storage order: s < bs_pad is the low
  // nibble of packed byte s, s >= bs_pad the high nibble of byte
  // s - bs_pad) goes to [q][sb][hi * 16 + v]. Queries q >= n_queries stage
  // zeros.
  const S* src = tables + static_cast<size_t>(q0) * m_cols;
  for (int i = lane; i < BQ * m_cols; i += kLane) {
    const int q = i / m_cols;
    const int m = i - q * m_cols;
    const int v = m / b_pad;
    const int s = m - v * b_pad;
    const int hi = s >= bs_pad;
    const int sb = hi ? s - bs_pad : s;
    tbl[q * row + sb * 32 + hi * 16 + v] = (q0 + q < n_queries) ? src[i]
                                                                : S(0);
  }
  __syncthreads();

  const size_t n_points = static_cast<size_t>(n_tiles) * kLane;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // codes[t, sb, lane]: a warp reads 32 consecutive bytes per sb
    const uint8_t* col =
        codes + static_cast<size_t>(t) * bs_pad * kLane + lane;
    A acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = A(0);
    // logical block order (2sb, then 2sb + 1), as the plain version adds
    for (int sb = 0; sb < bs_pad; ++sb) {
      const uint32_t byte = __ldg(col + sb * kLane);
      const S* tb = tbl + sb * 32;
      const int lo = byte & 15;
      const int hi = 16 + (byte >> 4);
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        acc[q] += Tb::widen(tb[q * row + lo]);
        acc[q] += Tb::widen(tb[q * row + hi]);
      }
    }
    A* dst = out + static_cast<size_t>(q0) * n_points +
             static_cast<size_t>(t) * kLane + lane;
#pragma unroll
    for (int q = 0; q < BQ; ++q)
      if (q0 + q < n_queries) dst[q * n_points] = acc[q];
  }
}

template <class Tb, int BQ>
cudaError_t launch(const void* tables, const void* codes, void* out,
                   int n_queries, int n_tiles, int bs_pad, size_t smem,
                   cudaStream_t stream) {
  auto kernel = estimate_scan_tiled_kernel<Tb, BQ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int q_blocks = (n_queries + BQ - 1) / BQ;
  const int grid_x =
      std::max(1, std::min(n_tiles, kTargetBlocks / q_blocks));
  const dim3 grid(static_cast<unsigned>(grid_x), q_blocks);
  kernel<<<grid, kLane, smem, stream>>>(
      static_cast<const typename Tb::storage*>(tables),
      static_cast<const uint8_t*>(codes),
      static_cast<typename Tb::acc*>(out), n_queries, n_tiles, bs_pad);
  return cudaGetLastError();
}

template <class Tb>
cudaError_t dispatch(int bq, const void* tables, const void* codes,
                     void* out, int n_queries, int n_tiles, int bs_pad,
                     size_t smem, cudaStream_t stream) {
  switch (bq) {
    case 32:
      return launch<Tb, 32>(tables, codes, out, n_queries, n_tiles, bs_pad,
                            smem, stream);
    case 16:
      return launch<Tb, 16>(tables, codes, out, n_queries, n_tiles, bs_pad,
                            smem, stream);
    default:
      return launch<Tb, 8>(tables, codes, out, n_queries, n_tiles, bs_pad,
                           smem, stream);
  }
}

// Queries per block: the largest of 32, 16, 8 whose staged tables fit 48 KB
// of shared memory, else 8 (up to the 227 KB a block may opt into).
// Returns 0 when even 8 queries do not fit.
int query_block(int elem_bytes, int bs_pad) {
  const size_t row = static_cast<size_t>(bs_pad) * 32 * elem_bytes;
  int bq = 32;
  while (bq > 8 && bq * row > 48 * 1024) bq /= 2;
  return bq * row <= 227 * 1024 ? bq : 0;
}

}  // namespace

extern "C" {

// tables: [n_queries, 32 * bs_pad] (permute_tables_csr layout) of int8
// (kind 0), bf16 (kind 1) or f32 (kind 2); codes: uint8 [n_tiles, bs_pad,
// 128]; out: [n_queries, n_tiles * 128], int32 for int8 tables and f32
// otherwise, written in full.
int estimate_scan_tiled_launch(const void* tables, int kind,
                               const void* codes, void* out, int n_queries,
                               int n_tiles, int bs_pad, void* stream) {
  const int elem = kind == 0 ? 1 : (kind == 1 ? 2 : 4);
  const int bq = query_block(elem, bs_pad);
  if (bq == 0 || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(bq) * bs_pad * 32 * elem;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (kind == 0)
    e = dispatch<Int8Tables>(bq, tables, codes, out, n_queries, n_tiles,
                             bs_pad, smem, s);
  else if (kind == 1)
    e = dispatch<Bf16Tables>(bq, tables, codes, out, n_queries, n_tiles,
                             bs_pad, smem, s);
  else
    e = dispatch<F32Tables>(bq, tables, codes, out, n_queries, n_tiles,
                            bs_pad, smem, s);
  return static_cast<int>(e);
}

const char* estimate_scan_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
