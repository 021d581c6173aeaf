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
// encoded as bf16_bits << 16 | pos. Slots q >= slot_counts[c] (when given)
// hold 2^31 - 1 too: they are empty and are not scanned.
//
// Design. The TPU kernel walks a flat sequential grid (csr_scan_map) and
// carries the fold in VMEM scratch from one grid step to the next; CUDA
// blocks run in parallel, so here each block owns one output row segment
// outright: block (list c, fold segment w, slot block of 32) walks tiles
// ti = w, w + W, w + 2W, ... of list c. No atomics, no step maps, no carry
// between blocks. The estimate is the TPU kernel's one-hot product, on the
// tensor cores (onehot_mma.cuh): per packed code byte one mma.sync
// m16n8k32 (int8) or two m16n8k16 (bf16) give 16 points x 8 slots. The
// block stages only its occupied slots' tables, and only groups of 8 slots
// that hold an occupied one are multiplied; a block with none writes the
// sentinel and stops. Its 4 warps take 32 points of each tile; a thread's
// accumulators hold the same (slot, point) pairs in every tile of the
// segment, so the epilogue encodes each with its position and keeps the
// running minima in registers; they leave as 16-byte stores.
//
// What bounds it on the H100. At the GloVe shape (1,087 lists, ~10,150 code
// tiles, 28 real code bytes) round 0 reads the tables of the occupied slots
// (~10k of 34,784) and 40 MB of codes and writes a 107 MB fold (W = 6); its
// one-hot products over occupied slots are ~1e10 int8 MACs, microseconds of
// tensor-core time. So bytes bind: 0.045 ms at 3.35 TB/s. Measured by
// chip_smoke.py (one H100 80GB HBM3, 700 W): 0.18 ms (the first design,
// one shared-memory lookup per (point, slot, block) over every slot, 0.87
// ms); the retry at 128 slots 0.26-0.27 ms against a bound of 0.14 ms,
// most of it the sentinel-filled fold; bf16 round 0 0.39-0.41 ms (0.82 ms
// before) against 0.026 ms, as each product is also added in f32. What is
// left is the short walk of each block (~1.5 tiles per fold segment)
// behind its table staging, and mma.sync's latency; wgmma, as in K3, is
// the next step.
//
// Interface: plain C, called through ctypes. The kernel launches on the
// caller's stream and allocates nothing; the C function returns
// cudaGetLastError() so a refused launch is reported.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "onehot_mma.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kEncInvalid = INT_MAX;
constexpr int kMaxSmem = 227 * 1024;

// est + bias lies in [0, 255 * B_pad]; the wrapper checks that it fits the
// value field once shifted.
__device__ __forceinline__ int32_t encode(int32_t est, int col_bits,
                                          int enc_bias) {
  return static_cast<int32_t>(static_cast<uint32_t>(est + enc_bias)
                              << col_bits);
}

__device__ __forceinline__ int32_t encode(float est, int, int) {
  const uint16_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(est));
  return static_cast<int32_t>(static_cast<uint32_t>(bits) << 16);
}

// Grid: x = list * fold_tiles + fold segment (the W blocks of one list are
// neighbours, so its tables are read from L2 after the first), y = slot
// block of 8G slots. Block: 4 warps.
template <class Acc, int G>
__global__ void __launch_bounds__(kLane)
scan_fold_csr_kernel(const typename onehot::TableOf<Acc>::type* __restrict__
                         tables,
                     const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ tile_offsets,
                     const int32_t* __restrict__ counts,
                     const int32_t* __restrict__ slot_counts,
                     int32_t* __restrict__ enc, int qc, int bs_pad,
                     int n_bytes, int fold_tiles, int max_tiles, int col_bits,
                     int enc_bias) {
  extern __shared__ __align__(16) uint32_t tbl[];
  using S = typename onehot::TableOf<Acc>::type;
  const int c = blockIdx.x / fold_tiles;
  const int w = blockIdx.x - c * fold_tiles;
  const int q0 = blockIdx.y * 8 * G;
  const int occupied =
      slot_counts ? min(max(slot_counts[c], 0), qc) : qc;
  const int n_act = max(0, min(occupied - q0, 8 * G));
  const int n_groups = (n_act + 7) / 8;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;

  int32_t best[G][2][4];
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int i = 0; i < 8; ++i) best[n][i >> 2][i & 3] = kEncInvalid;

  if (n_act > 0) {
    const int rw = onehot::row_words<S>(bs_pad);
    onehot::stage_rows(
        tbl, tables + (static_cast<size_t>(c) * qc + q0) * 32 * bs_pad,
        n_act, bs_pad, n_bytes, rw);
    __syncthreads();
    const int count = counts[c];
    const int ntiles = min((count + kLane - 1) / kLane, max_tiles);
    const size_t toff = static_cast<size_t>(tile_offsets[c]);
    for (int ti = w; ti < ntiles; ti += fold_tiles) {
      Acc acc[G][2][4] = {};
      onehot::scan_tile<G>(
          acc, tbl,
          reinterpret_cast<const uint32_t*>(
              codes + (toff + ti) * bs_pad * kLane + warp * 32) +
              g,
          n_bytes, n_groups, rw);
      const int pos0 = ti * kLane + warp * 32 + 4 * g;
#pragma unroll
      for (int n = 0; n < G; ++n) {
        if (n >= n_groups) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pos = pos0 + 2 * (i >> 2) + ((i & 3) >> 1);
          if (pos < count)
            best[n][i >> 2][i & 3] =
                min(best[n][i >> 2][i & 3],
                    encode(acc[n][i >> 2][i & 3], col_bits, enc_bias) | pos);
        }
      }
    }
  }

  // Every slot of the block is written: empty slots, lists with no tiles
  // and segments past a list's last tile hold the sentinel, as the TPU
  // kernel's dummy step gives.
  const size_t s_width = static_cast<size_t>(fold_tiles) * kLane;
  int32_t* out = enc + static_cast<size_t>(c) * qc * s_width +
                 static_cast<size_t>(w) * kLane + warp * 32 + 4 * g;
  const int4 invalid =
      make_int4(kEncInvalid, kEncInvalid, kEncInvalid, kEncInvalid);
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int q = q0 + 8 * n + 2 * t + p;
      if (q < qc)
        *reinterpret_cast<int4*>(out + q * s_width) =
            q < occupied ? onehot::points_of(best[n], p) : invalid;
    }
}

template <class Acc, int G>
cudaError_t launch(const void* tables, const void* codes,
                   const void* tile_offsets, const void* counts,
                   const void* slot_counts, void* enc, int n_lists, int qc,
                   int bs_pad, int n_bytes, int fold_tiles, int max_tiles,
                   int col_bits, int enc_bias, cudaStream_t stream) {
  using S = typename onehot::TableOf<Acc>::type;
  if constexpr (G > 1) {
    // fewer slots per block when the staged tables do not fit
    if (static_cast<size_t>(8 * G) * onehot::row_words<S>(bs_pad) * 4 >
        kMaxSmem)
      return launch<Acc, G / 2>(tables, codes, tile_offsets, counts,
                                slot_counts, enc, n_lists, qc, bs_pad,
                                n_bytes, fold_tiles, max_tiles, col_bits,
                                enc_bias, stream);
  }
  const size_t smem = static_cast<size_t>(8 * G) *
                      onehot::row_words<S>(bs_pad) * sizeof(uint32_t);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // too wide
  auto kernel = scan_fold_csr_kernel<Acc, G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(n_lists) * fold_tiles,
                  (qc + 8 * G - 1) / (8 * G));
  kernel<<<grid, kLane, smem, stream>>>(
      static_cast<const S*>(tables), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(slot_counts), static_cast<int32_t*>(enc),
      qc, bs_pad, n_bytes, fold_tiles, max_tiles, col_bits, enc_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tables: int8 or bf16 [n_lists, qc, 32 * bs_pad] (permute_tables_csr
// layout); codes: uint8 [T, bs_pad, 128], bs_pad a multiple of 8;
// tile_offsets, counts: int32
// [n_lists]; slot_counts: int32 [n_lists], list c's occupied slots (the
// first slot_counts[c]), or null for all qc; n_blocks: the real table
// blocks (<= 2 * bs_pad; the rows past it are zero and their code bytes
// are skipped); enc: int32 [n_lists, qc, fold_tiles * 128], written in
// full.
int scan_fold_csr_launch(const void* tables, int bf16, const void* codes,
                         const void* tile_offsets, const void* counts,
                         const void* slot_counts, void* enc, int n_lists,
                         int qc, int bs_pad, int n_blocks, int fold_tiles,
                         int max_tiles, int col_bits, int enc_bias,
                         void* stream) {
  // the staging moves whole groups of 4 bytes of a row padded to 8
  if (bs_pad % 8 || n_blocks < 1 || n_blocks > 2 * bs_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_bytes = (n_blocks + 1) / 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch<float, 4>(tables, codes, tile_offsets, counts,
                              slot_counts, enc, n_lists, qc, bs_pad, n_bytes,
                              fold_tiles, max_tiles, col_bits, enc_bias, s)
           : launch<int32_t, 4>(tables, codes, tile_offsets, counts,
                                slot_counts, enc, n_lists, qc, bs_pad,
                                n_bytes, fold_tiles, max_tiles, col_bits,
                                enc_bias, s);
  return static_cast<int>(e);
}

const char* scan_fold_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
