// scan_fold_csr: the IVF list scan with an encoded min-fold, for Hopper.
//
// Replaces the Pallas TPU kernel scan_fold_csr / _scan_fold_csr_kernel in
// tinyknn_tpu/ops/kernels.py (pallas_call at line 413). It computes the same
// int32 fold buffer, bit for bit for int8 tables:
//
//   enc[c, q, (ti mod W) * 128 + lane] =
//       min over tiles ti of list c of  (est + 128 * B_pad) << col_bits | pos
//
// where pos = ti * 128 + lane is the point's position in list c, est the
// point's PQ estimate for query slot q (a sum of B_pad table entries), and a
// position >= counts[c] (or a class with no point) holds 2^31 - 1. With bf16
// tables est is summed in f32, rounded to bf16 (round to nearest even) and
// encoded as bf16_bits << 16 | pos.
//
// Design. The TPU kernel walks a flat sequential grid (csr_scan_map) and
// carries the fold in VMEM scratch from one grid step to the next; CUDA
// blocks run in parallel, so here each block owns one output row segment
// outright: block (list c, fold segment w, query block) walks tiles
// ti = w, w + W, w + 2W, ... of list c and keeps its BQ running minima in
// registers. No atomics, no step maps, no carry between blocks. 128 threads,
// one per lane, i.e. one per point of a tile. The estimate is a
// shared-memory table lookup (what PQ scanning is on a GPU) rather than the
// TPU's one-hot matmul: the block stages its BQ query rows of the tables in
// shared memory, laid out [q][packed byte sb][lo 16 | hi 16], so the 32
// lookups of a warp for one (q, sb) touch at most 8 (int8) or 16 (bf16)
// distinct words, one per bank: conflict-free.
//
// What bounds it on the H100. Per point and query slot it does B_pad
// lookups; at the GloVe shape (B_pad = 64, ~1.3M padded list slots, 32
// query slots per list in round 0) that is ~2.7e9 shared-memory loads,
// against ~42 MB of codes and ~36 MB of tables read from device memory
// (about 25 us at 3.35 TB/s). So the kernel is bound by shared-memory load
// issue, not by device memory, and by the empty query slots it scans
// (round 0 sizes qc at ~2.5x the mean list load). Packing several lookups
// per load, skipping empty slots and a one-hot MMA are later work.
//
// Interface: plain C, called through ctypes. The kernel launches on the
// caller's stream and allocates nothing; the C function returns
// cudaGetLastError() so a refused launch is reported.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kEncInvalid = INT_MAX;

struct Int8Tables {
  using storage = int8_t;
  using acc = int32_t;
  static __device__ __forceinline__ int32_t widen(storage v) { return v; }
  static __device__ __forceinline__ int32_t encode(int32_t est, int col_bits,
                                                   int enc_bias) {
    // est + bias lies in [0, 255 * B_pad]; the wrapper checks that it fits
    // the value field once shifted.
    return static_cast<int32_t>(static_cast<uint32_t>(est + enc_bias)
                                << col_bits);
  }
};

struct Bf16Tables {
  using storage = uint16_t;  // raw bf16 bits
  using acc = float;
  static __device__ __forceinline__ float widen(storage v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);  // exact
  }
  static __device__ __forceinline__ int32_t encode(float est, int, int) {
    const uint16_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(est));
    return static_cast<int32_t>(static_cast<uint32_t>(bits) << 16);
  }
};

// Grid: x = list * fold_tiles + fold segment (the W blocks of one list are
// neighbours, so its tables are read from L2 after the first), y = query
// block of BQ slots. Block: 128 threads.
template <class Tb, int BQ>
__global__ void __launch_bounds__(kLane)
scan_fold_csr_kernel(const typename Tb::storage* __restrict__ tables,
                     const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ tile_offsets,
                     const int32_t* __restrict__ counts,
                     int32_t* __restrict__ enc, int qc, int bs_pad,
                     int fold_tiles, int max_tiles, int col_bits,
                     int enc_bias) {
  using S = typename Tb::storage;
  using A = typename Tb::acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tbl = reinterpret_cast<S*>(smem_raw);  // [BQ][bs_pad][32]

  const int c = blockIdx.x / fold_tiles;
  const int w = blockIdx.x - c * fold_tiles;
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x;
  const int b_pad = 2 * bs_pad;
  const int m_cols = 16 * b_pad;
  const int row = bs_pad * 32;  // one query's staged tables

  // Stage: input column v * B_pad + s (storage order: s < bs_pad is the low
  // nibble of packed byte s, s >= bs_pad the high nibble of byte
  // s - bs_pad) goes to [q][sb][hi * 16 + v]. Slots q >= qc stage zeros.
  const S* src = tables + (static_cast<size_t>(c) * qc + q0) * m_cols;
  for (int i = lane; i < BQ * m_cols; i += kLane) {
    const int q = i / m_cols;
    const int m = i - q * m_cols;
    const int v = m / b_pad;
    const int s = m - v * b_pad;
    const int hi = s >= bs_pad;
    const int sb = hi ? s - bs_pad : s;
    tbl[q * row + sb * 32 + hi * 16 + v] = (q0 + q < qc) ? src[i] : S(0);
  }
  __syncthreads();

  const int count = counts[c];
  const int ntiles = min((count + kLane - 1) / kLane, max_tiles);
  const size_t toff = static_cast<size_t>(tile_offsets[c]);
  int32_t best[BQ];
#pragma unroll
  for (int q = 0; q < BQ; ++q) best[q] = kEncInvalid;

  for (int ti = w; ti < ntiles; ti += fold_tiles) {
    // codes[t, sb, lane]: a warp reads 32 consecutive bytes per sb
    const uint8_t* col =
        codes + (toff + ti) * static_cast<size_t>(bs_pad) * kLane + lane;
    A acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = A(0);
    // Sum in logical block order (2sb, then 2sb + 1): the plain version,
    // scan_fold_csr_reference, adds in the same order, so f32 sums of bf16
    // tables agree bit for bit.
    for (int sb = 0; sb < bs_pad; ++sb) {
      const uint32_t byte = __ldg(col + sb * kLane);
      const S* t = tbl + sb * 32;
      const int lo = byte & 15;
      const int hi = 16 + (byte >> 4);
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        acc[q] += Tb::widen(t[q * row + lo]);
        acc[q] += Tb::widen(t[q * row + hi]);
      }
    }
    const int pos = ti * kLane + lane;
    if (pos < count) {
#pragma unroll
      for (int q = 0; q < BQ; ++q)
        best[q] = min(best[q], Tb::encode(acc[q], col_bits, enc_bias) | pos);
    }
  }

  // A list with no tiles (or a segment past its last tile) writes the
  // invalid sentinel, as the TPU kernel's dummy step does.
  const size_t s_width = static_cast<size_t>(fold_tiles) * kLane;
  int32_t* out = enc + (static_cast<size_t>(c) * qc + q0) * s_width +
                 static_cast<size_t>(w) * kLane + lane;
#pragma unroll
  for (int q = 0; q < BQ; ++q)
    if (q0 + q < qc) out[q * s_width] = best[q];
}

template <class Tb, int BQ>
cudaError_t launch(const void* tables, const void* codes,
                   const void* tile_offsets, const void* counts, void* enc,
                   int n_lists, int qc, int bs_pad, int fold_tiles,
                   int max_tiles, int col_bits, int enc_bias, size_t smem,
                   cudaStream_t stream) {
  auto kernel = scan_fold_csr_kernel<Tb, BQ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(n_lists) * fold_tiles,
                  (qc + BQ - 1) / BQ);
  kernel<<<grid, kLane, smem, stream>>>(
      static_cast<const typename Tb::storage*>(tables),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(enc), qc,
      bs_pad, fold_tiles, max_tiles, col_bits, enc_bias);
  return cudaGetLastError();
}

template <class Tb>
cudaError_t dispatch(int bq, const void* tables, const void* codes,
                     const void* tile_offsets, const void* counts, void* enc,
                     int n_lists, int qc, int bs_pad, int fold_tiles,
                     int max_tiles, int col_bits, int enc_bias, size_t smem,
                     cudaStream_t stream) {
  switch (bq) {
    case 32:
      return launch<Tb, 32>(tables, codes, tile_offsets, counts, enc,
                            n_lists, qc, bs_pad, fold_tiles, max_tiles,
                            col_bits, enc_bias, smem, stream);
    case 16:
      return launch<Tb, 16>(tables, codes, tile_offsets, counts, enc,
                            n_lists, qc, bs_pad, fold_tiles, max_tiles,
                            col_bits, enc_bias, smem, stream);
    default:
      return launch<Tb, 8>(tables, codes, tile_offsets, counts, enc, n_lists,
                           qc, bs_pad, fold_tiles, max_tiles, col_bits,
                           enc_bias, smem, stream);
  }
}

// Query slots per block: the largest of 32, 16, 8 whose staged tables fit
// 48 KB of shared memory, else 8 (up to the 227 KB a block may opt into).
// Returns 0 when even 8 slots do not fit.
int query_block(int bf16, int bs_pad) {
  const size_t row = static_cast<size_t>(bs_pad) * 32 * (bf16 ? 2 : 1);
  int bq = 32;
  while (bq > 8 && bq * row > 48 * 1024) bq /= 2;
  return bq * row <= 227 * 1024 ? bq : 0;
}

}  // namespace

extern "C" {

// tables: int8 or bf16 [n_lists, qc, 32 * bs_pad] (permute_tables_csr
// layout); codes: uint8 [T, bs_pad, 128]; tile_offsets, counts: int32
// [n_lists]; enc: int32 [n_lists, qc, fold_tiles * 128], written in full.
int scan_fold_csr_launch(const void* tables, int bf16, const void* codes,
                         const void* tile_offsets, const void* counts,
                         void* enc, int n_lists, int qc, int bs_pad,
                         int fold_tiles, int max_tiles, int col_bits,
                         int enc_bias, void* stream) {
  const int bq = query_block(bf16, bs_pad);
  if (bq == 0) return static_cast<int>(cudaErrorInvalidValue);  // too wide
  const size_t smem =
      static_cast<size_t>(bq) * bs_pad * 32 * (bf16 ? 2 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? dispatch<Bf16Tables>(bq, tables, codes, tile_offsets, counts,
                                  enc, n_lists, qc, bs_pad, fold_tiles,
                                  max_tiles, col_bits, enc_bias, smem, s)
           : dispatch<Int8Tables>(bq, tables, codes, tile_offsets, counts,
                                  enc, n_lists, qc, bs_pad, fold_tiles,
                                  max_tiles, col_bits, enc_bias, smem, s);
  return static_cast<int>(e);
}

const char* scan_fold_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
