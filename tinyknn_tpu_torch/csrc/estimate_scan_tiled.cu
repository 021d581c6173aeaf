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
// Design. The TPU kernel's one-hot product, on the tensor cores
// (onehot_mma.cuh), for int8 and bf16 tables. A block stages the tables of
// its queries once in shared memory and walks code tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ...: a persistent grid of as many blocks as the
// SMs hold at once. int8: one warpgroup per 64 queries; per packed code
// byte it builds the one-hot of its 128 points in registers and issues two
// wgmma m64n64k32 s8 products (A from registers, B the staged tables).
// bf16: 4 warps per 32 queries, two mma.sync m16n8k16 per byte and 16
// points x 8 queries, each product added in f32 in block order. Each
// thread holds 4 neighbouring points of a query row, which leave as one
// 16-byte streaming store, 8 threads to a 128-byte line, so the output
// needs no staging. Code bytes past the real block count (n_blocks) are
// skipped: their table rows are zero. f32 tables keep a shared-memory
// lookup (a TF32 product would round the entries): one load per (point,
// query, block) against tables staged [q][sb][lo 16 | hi 16].
//
// What bounds it on the H100. At the GloVe corpus (1,183,514 codes, 28
// real code bytes, 1,000 queries) the output is 4.73 GB, 1.42 ms at 3.35
// TB/s, against 1.1e12 one-hot MACs (2.1e12 int8 ops, 1.07 ms at the int8
// peak): the write binds, the products close behind. Measured by
// chip_smoke.py (one H100 80GB HBM3, 700 W): the first design, one
// shared-memory lookup per (point, query, block), 12.0-12.4 ms; the same
// one-hot on mma.sync m16n8k32, 8.0 ms; on wgmma, 2.4 ms (bound 1.42 ms,
// torch._int_mm over the one-hot 3.5 ms). Each step waits for its two
// products before the next one-hot is built: that latency, and the write
// it does not overlap, is what is left.
//
// Interface: plain C, called through ctypes. The kernel launches on the
// caller's stream and allocates nothing; the C function returns
// cudaGetLastError() so a refused launch is reported.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kMaxSmem = 227 * 1024;
// Blocks in flight the f32 launch aims at (16 blocks of 128 threads per SM
// of the H100's 132): its grid's tile stride is this over the query blocks.
constexpr int kTargetBlocks = 132 * 16;

// Grid: x = tile stride, y = query block of 8G queries. Block: 4 warps.
template <class Acc, int G>
__global__ void __launch_bounds__(kLane)
estimate_mma_kernel(const typename onehot::TableOf<Acc>::type* __restrict__
                        tables,
                    const uint8_t* __restrict__ codes, Acc* __restrict__ out,
                    int n_queries, int n_tiles, int bs_pad, int n_bytes) {
  extern __shared__ __align__(16) uint32_t tbl[];
  using S = typename onehot::TableOf<Acc>::type;
  const int rw = onehot::row_words<S>(bs_pad);
  const int q0 = blockIdx.y * 8 * G;
  const int n_act = min(n_queries - q0, 8 * G);
  const int n_groups = (n_act + 7) / 8;
  onehot::stage_rows(tbl, tables + static_cast<size_t>(q0) * 32 * bs_pad,
                     n_act, bs_pad, n_bytes, rw);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t n_points = static_cast<size_t>(n_tiles) * kLane;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    Acc acc[G][2][4] = {};
    onehot::scan_tile<G>(
        acc, tbl,
        reinterpret_cast<const uint32_t*>(
            codes + static_cast<size_t>(tile) * bs_pad * kLane + warp * 32) +
            g,
        n_bytes, n_groups, rw);
    Acc* dst = out + static_cast<size_t>(tile) * kLane + warp * 32 + 4 * g;
#pragma unroll
    for (int n = 0; n < G; ++n) {
      if (n >= n_groups) break;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = q0 + 8 * n + 2 * t + p;
        if (q < n_queries) {
          auto v = onehot::points_of(acc[n], p);
          __stcs(reinterpret_cast<decltype(v)*>(dst + q * n_points), v);
        }
      }
    }
  }
}

template <class Acc, int G>
cudaError_t launch_mma(const void* tables, const void* codes, void* out,
                       int n_queries, int n_tiles, int bs_pad, int n_bytes,
                       cudaStream_t stream) {
  using S = typename onehot::TableOf<Acc>::type;
  auto kernel = estimate_mma_kernel<Acc, G>;
  const size_t smem = static_cast<size_t>(8 * G) *
                      onehot::row_words<S>(bs_pad) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLane,
                                                      smem);
  if (e != cudaSuccess) return e;
  // persistent: the query blocks share the blocks the SMs hold at once,
  // rounded down (a block more would run in a second wave)
  const int q_blocks = (n_queries + 8 * G - 1) / (8 * G);
  const int resident = sms * std::max(per_sm, 1);
  const int grid_x = std::max(1, std::min(n_tiles, resident / q_blocks));
  kernel<<<dim3(static_cast<unsigned>(grid_x), q_blocks), kLane, smem,
           stream>>>(static_cast<const S*>(tables),
                     static_cast<const uint8_t*>(codes),
                     static_cast<Acc*>(out), n_queries, n_tiles, bs_pad,
                     n_bytes);
  return cudaGetLastError();
}

// int8 tables on wgmma. Grid: x = tile stride, y = query block of 64
// queries. Block: one warpgroup (4 warps), 128 points of a tile per step.
constexpr int kGmmaRows = 64;

__global__ void __launch_bounds__(kLane)
estimate_gmma_kernel(const int8_t* __restrict__ tables,
                     const uint8_t* __restrict__ codes,
                     int32_t* __restrict__ out, int n_queries, int n_tiles,
                     int bs_pad, int n_bytes) {
  extern __shared__ __align__(128) uint32_t gtbl[];
  constexpr int sb_bytes = kGmmaRows * 32;
  const int q0 = blockIdx.y * kGmmaRows;
  const int n_act = min(n_queries - q0, kGmmaRows);
  onehot::stage_rows(gtbl, tables + static_cast<size_t>(q0) * 32 * bs_pad,
                     n_act, bs_pad, n_bytes, onehot::GmmaRows{sb_bytes / 4});
  // the products read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t desc = onehot::gmma_desc(gtbl);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const size_t n_points = static_cast<size_t>(n_tiles) * kLane;
  int32_t acc[2][32] = {};
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    onehot::scan_tile_gmma(
        acc, desc,
        reinterpret_cast<const uint32_t*>(
            codes + static_cast<size_t>(tile) * bs_pad * kLane + warp * 32) +
            g,
        n_bytes, sb_bytes);
    int32_t* dst =
        out + static_cast<size_t>(tile) * kLane + warp * 32 + 4 * g;
#pragma unroll
    for (int n = 0; n < kGmmaRows / 8; ++n)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = q0 + 8 * n + 2 * t + p;
        if (q < n_queries)
          __stcs(reinterpret_cast<int4*>(dst + q * n_points),
                 onehot::points_of(acc, n, p));
      }
  }
}

cudaError_t launch_gmma(const void* tables, const void* codes, void* out,
                        int n_queries, int n_tiles, int bs_pad, int n_bytes,
                        cudaStream_t stream) {
  auto kernel = estimate_gmma_kernel;
  // the staging writes whole groups of 4 bytes
  const size_t smem = static_cast<size_t>((n_bytes + 3) / 4 * 4) *
                      kGmmaRows * 32;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLane,
                                                      smem);
  if (e != cudaSuccess) return e;
  const int q_blocks = (n_queries + kGmmaRows - 1) / kGmmaRows;
  const int resident = sms * std::max(per_sm, 1);
  const int grid_x = std::max(1, std::min(n_tiles, resident / q_blocks));
  kernel<<<dim3(static_cast<unsigned>(grid_x), q_blocks), kLane, smem,
           stream>>>(static_cast<const int8_t*>(tables),
                     static_cast<const uint8_t*>(codes),
                     static_cast<int32_t*>(out), n_queries, n_tiles, bs_pad,
                     n_bytes);
  return cudaGetLastError();
}

// The largest of 8G queries per block (G <= g_max) whose staged tables fit
// the shared memory a block may opt into.
template <class Acc, int G>
cudaError_t dispatch_mma(const void* tables, const void* codes, void* out,
                         int n_queries, int n_tiles, int bs_pad, int n_bytes,
                         cudaStream_t stream) {
  using S = typename onehot::TableOf<Acc>::type;
  if constexpr (G > 1) {
    if (static_cast<size_t>(8 * G) * onehot::row_words<S>(bs_pad) * 4 >
        kMaxSmem)
      return dispatch_mma<Acc, G / 2>(tables, codes, out, n_queries, n_tiles,
                                      bs_pad, n_bytes, stream);
  }
  if (static_cast<size_t>(8 * G) * onehot::row_words<S>(bs_pad) * 4 >
      kMaxSmem)
    return cudaErrorInvalidValue;  // too wide for one group of 8
  return launch_mma<Acc, G>(tables, codes, out, n_queries, n_tiles, bs_pad,
                            n_bytes, stream);
}

// f32 tables: the lookup kernel. Grid: x = tile stride (each block walks
// tiles x, x + gridDim.x, ...), y = query block of BQ queries. Block: 128
// threads, one per point of a tile.
template <int BQ>
__global__ void __launch_bounds__(kLane)
estimate_lookup_kernel(const float* __restrict__ tables,
                       const uint8_t* __restrict__ codes,
                       float* __restrict__ out, int n_queries, int n_tiles,
                       int bs_pad, int n_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tbl = reinterpret_cast<float*>(smem_raw);  // [BQ][bs_pad][32]

  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x;
  const int b_pad = 2 * bs_pad;
  const int m_cols = 16 * b_pad;
  const int row = bs_pad * 32;  // one query's staged tables

  // Stage: input column v * B_pad + s (storage order: s < bs_pad is the low
  // nibble of packed byte s, s >= bs_pad the high nibble of byte
  // s - bs_pad) goes to [q][sb][hi * 16 + v]. Queries q >= n_queries stage
  // zeros.
  const float* src = tables + static_cast<size_t>(q0) * m_cols;
  for (int i = lane; i < BQ * m_cols; i += kLane) {
    const int q = i / m_cols;
    const int m = i - q * m_cols;
    const int v = m / b_pad;
    const int s = m - v * b_pad;
    const int hi = s >= bs_pad;
    const int sb = hi ? s - bs_pad : s;
    tbl[q * row + sb * 32 + hi * 16 + v] =
        (q0 + q < n_queries) ? src[i] : 0.0f;
  }
  __syncthreads();

  const size_t n_points = static_cast<size_t>(n_tiles) * kLane;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    // codes[t, sb, lane]: a warp reads 32 consecutive bytes per sb
    const uint8_t* col =
        codes + static_cast<size_t>(t) * bs_pad * kLane + lane;
    float acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = 0.0f;
    // logical block order (2sb, then 2sb + 1), as the plain version adds
    for (int sb = 0; sb < n_bytes; ++sb) {
      const uint32_t byte = __ldg(col + sb * kLane);
      const float* tb = tbl + sb * 32;
      const int lo = byte & 15;
      const int hi = 16 + (byte >> 4);
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        acc[q] += tb[q * row + lo];
        acc[q] += tb[q * row + hi];
      }
    }
    float* dst = out + static_cast<size_t>(q0) * n_points +
                 static_cast<size_t>(t) * kLane + lane;
#pragma unroll
    for (int q = 0; q < BQ; ++q)
      if (q0 + q < n_queries) dst[q * n_points] = acc[q];
  }
}

template <int BQ>
cudaError_t launch_lookup(const void* tables, const void* codes, void* out,
                          int n_queries, int n_tiles, int bs_pad,
                          int n_bytes, cudaStream_t stream) {
  auto kernel = estimate_lookup_kernel<BQ>;
  const size_t smem = static_cast<size_t>(BQ) * bs_pad * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int q_blocks = (n_queries + BQ - 1) / BQ;
  const int grid_x =
      std::max(1, std::min(n_tiles, kTargetBlocks / q_blocks));
  kernel<<<dim3(static_cast<unsigned>(grid_x), q_blocks), kLane, smem,
           stream>>>(static_cast<const float*>(tables),
                     static_cast<const uint8_t*>(codes),
                     static_cast<float*>(out), n_queries, n_tiles, bs_pad,
                     n_bytes);
  return cudaGetLastError();
}

// f32 queries per block: the largest of 32, 16, 8 whose staged tables fit
// 48 KB of shared memory, else 8 (up to the 227 KB a block may opt into).
cudaError_t dispatch_lookup(const void* tables, const void* codes, void* out,
                            int n_queries, int n_tiles, int bs_pad,
                            int n_bytes, cudaStream_t stream) {
  const size_t row = static_cast<size_t>(bs_pad) * 32 * sizeof(float);
  int bq = 32;
  while (bq > 8 && bq * row > 48 * 1024) bq /= 2;
  if (bq * row > kMaxSmem) return cudaErrorInvalidValue;
  switch (bq) {
    case 32:
      return launch_lookup<32>(tables, codes, out, n_queries, n_tiles,
                               bs_pad, n_bytes, stream);
    case 16:
      return launch_lookup<16>(tables, codes, out, n_queries, n_tiles,
                               bs_pad, n_bytes, stream);
    default:
      return launch_lookup<8>(tables, codes, out, n_queries, n_tiles, bs_pad,
                              n_bytes, stream);
  }
}

}  // namespace

extern "C" {

// tables: [n_queries, 32 * bs_pad] (permute_tables_csr layout) of int8
// (kind 0), bf16 (kind 1) or f32 (kind 2); codes: uint8 [n_tiles, bs_pad,
// 128], bs_pad a multiple of 8; n_blocks: the real table blocks (<= 2 * bs_pad; the rows past it
// are zero and their code bytes are skipped); out: [n_queries,
// n_tiles * 128], int32 for int8 tables and f32 otherwise, written in full.
int estimate_scan_tiled_launch(const void* tables, int kind,
                               const void* codes, void* out, int n_queries,
                               int n_tiles, int bs_pad, int n_blocks,
                               void* stream) {
  // the staging moves whole groups of 4 bytes of a row padded to 8
  if (kind < 0 || kind > 2 || bs_pad % 8 || n_blocks < 1 ||
      n_blocks > 2 * bs_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bytes = (n_blocks + 1) / 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (kind == 0 &&
      static_cast<size_t>((n_bytes + 3) / 4 * 4) * kGmmaRows * 32 <= kMaxSmem)
    e = launch_gmma(tables, codes, out, n_queries, n_tiles, bs_pad, n_bytes,
                    s);
  else if (kind == 0)
    e = dispatch_mma<int32_t, 8>(tables, codes, out, n_queries, n_tiles,
                                 bs_pad, n_bytes, s);
  else if (kind == 1)
    e = dispatch_mma<float, 4>(tables, codes, out, n_queries, n_tiles,
                               bs_pad, n_bytes, s);
  else
    e = dispatch_lookup(tables, codes, out, n_queries, n_tiles, bs_pad,
                        n_bytes, s);
  return static_cast<int>(e);
}

const char* estimate_scan_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
