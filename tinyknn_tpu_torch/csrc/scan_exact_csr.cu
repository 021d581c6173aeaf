// scan_exact_csr: the exact IVF engine's list scan with an encoded min-fold,
// for Hopper.
//
// Replaces the Pallas TPU kernel scan_exact_csr / _scan_exact_csr_kernel in
// tinyknn_tpu/ops/kernels.py (pallas_call at line 527). It computes
//
//   enc[c, q, (ti mod W) * 128 + lane] =
//       min over tiles ti of list c of  bf16_bits(max(d, 0)) << 16 | pos
//
// where pos = ti * 128 + lane is the point's position in list c and
// d = sum_j q_sel[c, q, j] * vecs[t, j, lane] is the dot product of the
// augmented query [-2q, 1, 1, |q|^2, 0...] with the augmented point
// [x, hi(|x|^2), lo(|x|^2), 1, 0...], i.e. the squared distance |q - x|^2.
// d is summed in f32 in dimension order and rounded to bf16 with
// round-to-nearest-even; a position >= counts[c] (or a class with no point)
// holds 2^31 - 1. Lists are at most 65,536 points (16-bit positions).
//
// Design. The grid is K1's (scan_fold_csr.cu): block (list c, fold segment
// w, query block) walks tiles ti = w, w + W, ... of list c with its BQ
// running minima in registers, so no atomics and no carry between blocks.
// 128 threads, one per lane, i.e. one per point of a tile. The block stages
// its BQ augmented query rows in shared memory as f32; each thread reads its
// point's d_aug values from vecs[t, :, lane] (a warp reads 64 contiguous
// bytes per dimension) and does BQ fused multiply-adds per dimension against
// a broadcast shared-memory read (one 16-byte read per 4 dimensions).
// A bf16 x bf16 product is exact in f32, so the f32 sum in dimension order is
// what the plain version (scan_exact_csr_reference) computes too.
//
// What bounds it on the H100. Per point and query slot it does d_aug FMAs;
// at the GloVe shape (d_aug = 112, ~1.3M padded list slots, 32 query slots
// per list in round 0) that is ~4.7e9 FMAs, ~0.16 ms at the card's ~2.9e13
// f32 FMA/s, against ~290 MB of vector tiles read and a (C, qc, S) int32
// fold of ~460 MB written (~0.14 ms at 3.35 TB/s). Predicted before the
// first card run: 0.3-0.5 ms, bound about equally by FMA issue and the
// write. Measured (one H100 80GB HBM3, 700 W): 0.81 ms per round-0 call,
// ~5.8e12 FMA/s, a fifth of the FMA peak; each 4 FMAs per query also
// issue one 16-byte shared-memory load, which may double the issue time
// (not verified: the card has no profiler of instructions). A bf16
// mma.sync / wgmma form and a narrower fold are later work.
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

__device__ __forceinline__ float bf16_bits_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);  // exact
}

// Grid: x = list * fold_tiles + fold segment, y = query block of BQ slots.
// Block: 128 threads. Shared memory: BQ * d4 floats, d4 = round_up(d_aug, 4).
template <int BQ>
__global__ void __launch_bounds__(kLane)
scan_exact_csr_kernel(const uint16_t* __restrict__ q_sel,
                      const uint16_t* __restrict__ vecs,
                      const int32_t* __restrict__ tile_offsets,
                      const int32_t* __restrict__ counts,
                      int32_t* __restrict__ enc, int qc, int d_aug,
                      int fold_tiles, int max_tiles) {
  extern __shared__ __align__(16) float qs[];  // [BQ][d4]
  const int d4 = (d_aug + 3) & ~3;
  const int c = blockIdx.x / fold_tiles;
  const int w = blockIdx.x - c * fold_tiles;
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x;

  // Stage the block's query rows; slots q >= qc and the pad columns are 0.
  const uint16_t* src = q_sel + (static_cast<size_t>(c) * qc + q0) * d_aug;
  for (int i = lane; i < BQ * d4; i += kLane) {
    const int q = i / d4;
    const int j = i - q * d4;
    qs[i] = (q0 + q < qc && j < d_aug)
                ? bf16_bits_to_float(src[static_cast<size_t>(q) * d_aug + j])
                : 0.f;
  }
  __syncthreads();

  const int count = counts[c];
  const int ntiles = min((count + kLane - 1) / kLane, max_tiles);
  const size_t toff = static_cast<size_t>(tile_offsets[c]);
  const int d_main = d_aug & ~3;
  int32_t best[BQ];
#pragma unroll
  for (int q = 0; q < BQ; ++q) best[q] = kEncInvalid;

  for (int ti = w; ti < ntiles; ti += fold_tiles) {
    // vecs[t, j, lane]: row j of the tile, this thread's point
    const uint16_t* col =
        vecs + (toff + ti) * static_cast<size_t>(d_aug) * kLane + lane;
    float acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = 0.f;
    for (int j = 0; j < d_main; j += 4) {
      const float x0 = bf16_bits_to_float(__ldg(col + (j + 0) * kLane));
      const float x1 = bf16_bits_to_float(__ldg(col + (j + 1) * kLane));
      const float x2 = bf16_bits_to_float(__ldg(col + (j + 2) * kLane));
      const float x3 = bf16_bits_to_float(__ldg(col + (j + 3) * kLane));
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + q * d4 + j);
        acc[q] = fmaf(qv.x, x0, acc[q]);
        acc[q] = fmaf(qv.y, x1, acc[q]);
        acc[q] = fmaf(qv.z, x2, acc[q]);
        acc[q] = fmaf(qv.w, x3, acc[q]);
      }
    }
    for (int j = d_main; j < d_aug; ++j) {
      const float x = bf16_bits_to_float(__ldg(col + j * kLane));
#pragma unroll
      for (int q = 0; q < BQ; ++q) acc[q] = fmaf(qs[q * d4 + j], x, acc[q]);
    }
    const int pos = ti * kLane + lane;
    if (pos < count) {
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        // clamp at 0 (bf16 input rounding can push a ~0 distance below);
        // non-negative floats keep their order as integer bits
        const float d = acc[q] > 0.f ? acc[q] : 0.f;
        const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(d));
        best[q] = min(best[q], static_cast<int32_t>(bits << 16) | pos);
      }
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

template <int BQ>
cudaError_t launch(const void* q_sel, const void* vecs,
                   const void* tile_offsets, const void* counts, void* enc,
                   int n_lists, int qc, int d_aug, int fold_tiles,
                   int max_tiles, size_t smem, cudaStream_t stream) {
  auto kernel = scan_exact_csr_kernel<BQ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(n_lists) * fold_tiles,
                  (qc + BQ - 1) / BQ);
  kernel<<<grid, kLane, smem, stream>>>(
      static_cast<const uint16_t*>(q_sel), static_cast<const uint16_t*>(vecs),
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(enc), qc,
      d_aug, fold_tiles, max_tiles);
  return cudaGetLastError();
}

// Query slots per block: the largest of 32, 16, 8 whose staged rows fit
// 48 KB of shared memory, else 8 (up to the 227 KB a block may opt into).
// Returns 0 when even 8 slots do not fit.
int query_block(int d_aug) {
  const size_t row = static_cast<size_t>((d_aug + 3) & ~3) * sizeof(float);
  int bq = 32;
  while (bq > 8 && bq * row > 48 * 1024) bq /= 2;
  return bq * row <= 227 * 1024 ? bq : 0;
}

}  // namespace

extern "C" {

// q_sel: bf16 [n_lists, qc, d_aug]; vecs: bf16 [T, d_aug, 128];
// tile_offsets, counts: int32 [n_lists]; enc: int32
// [n_lists, qc, fold_tiles * 128], written in full.
int scan_exact_csr_launch(const void* q_sel, const void* vecs,
                          const void* tile_offsets, const void* counts,
                          void* enc, int n_lists, int qc, int d_aug,
                          int fold_tiles, int max_tiles, void* stream) {
  const int bq = query_block(d_aug);
  if (bq == 0) return static_cast<int>(cudaErrorInvalidValue);  // too wide
  const size_t smem =
      static_cast<size_t>(bq) * ((d_aug + 3) & ~3) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bq) {
    case 32:
      e = launch<32>(q_sel, vecs, tile_offsets, counts, enc, n_lists, qc,
                     d_aug, fold_tiles, max_tiles, smem, s);
      break;
    case 16:
      e = launch<16>(q_sel, vecs, tile_offsets, counts, enc, n_lists, qc,
                     d_aug, fold_tiles, max_tiles, smem, s);
      break;
    default:
      e = launch<8>(q_sel, vecs, tile_offsets, counts, enc, n_lists, qc,
                    d_aug, fold_tiles, max_tiles, smem, s);
  }
  return static_cast<int>(e);
}

const char* scan_exact_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
