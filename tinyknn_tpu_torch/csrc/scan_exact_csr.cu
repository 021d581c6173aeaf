// scan_exact_csr: the exact IVF engine's list scan with an encoded min-fold,
// on Hopper's tensor cores.
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
// [x, hi(|x|^2), lo(|x|^2), 1, 0...], i.e. the squared distance |q - x|^2,
// rounded to bf16 with round-to-nearest-even. A position >= counts[c] (or a
// class with no point) holds 2^31 - 1, and so does every slot
// q >= slot_counts[c] (when given): those slots are empty and are neither
// staged nor multiplied. Lists are at most 65,536 points (16-bit positions).
//
// Summation rule. Each bf16 x bf16 product is exact in f32, and the tensor
// cores add them in f32 in an order of their own (not dimension order). So
// on integer-valued inputs, where every partial sum is exact, the fold is
// bit for bit the plain version's (scan_exact_csr_reference, which adds in
// dimension order); on real inputs a decoded distance may differ from it by
// the rounding of the f32 sums, at most 1 bf16 ulp on the inputs held.
//
// Design. The product is a bf16 GEMM with f32 accumulators, D[point, slot] =
// sum_j vecs[t, j, point] * q_sel[c, slot, j], on mma.sync m16n8k16 with the
// points as M, the slots as N (in groups of 8, as K1's onehot_mma.cuh) and
// the dimensions as K. mma.sync rather than wgmma: a block's work is one or
// a few tiles of 128 points by at most 32 occupied slots, too little to fill
// a 64-row wgmma pipeline, and bytes, not the tensor cores, bind (below).
// Block (list c, fold segment w, block of 32 slots) walks tiles ti = w,
// w + W, ... of list c (no atomics, no carry between blocks) with 4 warps of
// 32 points each. It stages only its occupied slots' query rows, in bf16, K
// contiguous per slot, which ldmatrix gives as the B fragments; the vector
// tile, [K][128] with points contiguous, streams through a 4-stage cp.async
// ring of 32 dimensions a stage (rows padded to 272 bytes so ldmatrix.trans,
// which gives the A fragments, hits distinct banks). Any d_aug works: the
// K loop walks the stages, and the dimensions past d_aug up to a multiple of
// 16 are zeros in shared memory. After each tile the epilogue clamps at 0,
// rounds to bf16, shifts, ORs the position, masks positions past the count
// and keeps the running minima in registers. At the end they go through
// shared memory so each thread writes 16 contiguous bytes. A block whose
// list has no tile in its segment, or no occupied slot in its slot block,
// stages nothing and writes its rows of sentinels with streaming 16-byte
// stores.
//
// What bounds it on the H100. At the GloVe shape round 0 (1,087 lists,
// q_sel (1087, 32, 112), W = 26, ~10k of 34,784 slots occupied) it reads
// ~290 MB of vector tiles and writes the (C, qc, W * 128) int32 fold in
// full, 463 MB; its products over the occupied slots are ~3e9 bf16
// operations, microseconds at the tensor-core peak even counted over whole
// groups of 8 slots. So bytes bind: 0.22 ms at 3.35 TB/s; the 128-slot
// retry writes 1.85 GB (0.64 ms with its tiles). Measured by chip_smoke.py
// (one H100 80GB HBM3, 700 W): 0.27 ms at round 0, 82% of its bound, and
// 0.70 ms at the retry, 91%, where the earlier design (one scalar f32 FMA
// per point, slot and dimension over every slot) took 0.81 ms and ~3.2 ms.
// The rest of round 0 is not measured apart: at W = max_tiles a fold
// segment holds at most one tile, so each block loads, multiplies and
// stores once, with no next tile to hide that latency behind (4 blocks an
// SM at 114 registers a thread).
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
constexpr int kThreads = 128;                 // 4 warps x 32 points
constexpr int kEncInvalid = INT_MAX;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kKc = 32;                       // dimensions per stage
constexpr int kStages = 4;
constexpr int kTileRow = kLane + 8;           // staged bf16 per dimension
constexpr int kStageElems = kKc * kTileRow;
constexpr int kRingBytes = kStages * kStageElems * 2;
constexpr int kOutRow = kLane + 4;            // int32 per staged output row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment of m16n8k16 from a [K][M] tile (points contiguous): the four
// 8 x 8 matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), transposed on load.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B fragment of m16n8k16 from [N][K] rows (K contiguous): k 0-7, 8-15.
__device__ __forceinline__ void ldsm_x2(uint32_t (&b)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row stride of the staged queries: d16 plus 8, an odd number of 16-byte
// units, so the 8 rows of an ldmatrix fall in distinct banks.
__host__ __device__ constexpr int query_stride(int d_aug) {
  return ((d_aug + 15) & ~15) + 8;
}

template <int G>
__host__ __device__ constexpr size_t smem_bytes(int d_aug) {
  return static_cast<size_t>(kRingBytes) +
         static_cast<size_t>(8 * G) * query_stride(d_aug) * 2;
}

// Grid: x = list * fold_tiles + fold segment, y = slot block of 8G slots.
// Block: 4 warps. Shared memory: the tile ring (reused by the epilogue),
// then the block's staged query rows.
template <int G>
__global__ void __launch_bounds__(kThreads)
scan_exact_csr_kernel(const uint16_t* __restrict__ q_sel,
                      const uint16_t* __restrict__ vecs,
                      const int32_t* __restrict__ tile_offsets,
                      const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ slot_counts,
                      int32_t* __restrict__ enc, int qc, int d_aug,
                      int fold_tiles, int max_tiles) {
  static_assert(8 * G * kOutRow * 4 <= kRingBytes, "epilogue staging");
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ring = smem;
  uint16_t* qs = smem + kRingBytes / 2;
  const int c = blockIdx.x / fold_tiles;
  const int w = blockIdx.x - c * fold_tiles;
  const int q0 = blockIdx.y * 8 * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int occupied = slot_counts ? min(max(slot_counts[c], 0), qc) : qc;
  const int n_act = max(0, min(occupied - q0, 8 * G));
  const int count = counts[c];
  const int ntiles = min((count + kLane - 1) / kLane, max_tiles);
  const int n_mine = w < ntiles ? (ntiles - 1 - w) / fold_tiles + 1 : 0;
  const size_t s_width = static_cast<size_t>(fold_tiles) * kLane;
  int32_t* out = enc + (static_cast<size_t>(c) * qc + q0) * s_width +
                 static_cast<size_t>(w) * kLane + 4 * lane;
  const int n_rows = min(8 * G, qc - q0);
  const int4 invalid =
      make_int4(kEncInvalid, kEncInvalid, kEncInvalid, kEncInvalid);

  if (n_act == 0 || n_mine == 0) {
    // no work: the sentinel rows, as the TPU kernel's dummy step gives
    for (int r = warp; r < n_rows; r += kThreads / 32)
      __stcs(reinterpret_cast<int4*>(out + r * s_width), invalid);
    return;
  }

  // Stage the occupied slots' query rows (whole groups of 8; the rest of
  // a group and the columns d_aug .. d16 are zeros).
  const int n_groups = (n_act + 7) / 8;
  const int d16 = (d_aug + 15) & ~15;
  const int qstride = query_stride(d_aug);
  const uint16_t* qsrc = q_sel + (static_cast<size_t>(c) * qc + q0) * d_aug;
  if ((d_aug & 7) == 0) {
    const int per_row = d16 / 8;
    for (int i = tid; i < 8 * n_groups * per_row; i += kThreads) {
      const int r = i / per_row;
      const int j = 8 * (i - r * per_row);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < n_act && j < d_aug)
        v = __ldg(reinterpret_cast<const uint4*>(
            qsrc + static_cast<size_t>(r) * d_aug + j));
      *reinterpret_cast<uint4*>(qs + r * qstride + j) = v;
    }
  } else {
    for (int i = tid; i < 8 * n_groups * d16; i += kThreads) {
      const int r = i / d16;
      const int j = i - r * d16;
      qs[r * qstride + j] = (r < n_act && j < d_aug)
                                ? qsrc[static_cast<size_t>(r) * d_aug + j]
                                : static_cast<uint16_t>(0);
    }
  }

  // The tile stream: step s is chunk s % n_chunks of this block's tile
  // s / n_chunks, kKc dimensions (the last chunk: what is left of d16).
  const int n_chunks = (d16 + kKc - 1) / kKc;
  const int n_steps = n_mine * n_chunks;
  const size_t toff = static_cast<size_t>(tile_offsets[c]);
  auto issue = [&](int s) {
    if (s < n_steps) {
      const int i = s / n_chunks;
      const int k0 = (s - i * n_chunks) * kKc;
      const int rows = min(kKc, d16 - k0);
      const size_t t = toff + w + static_cast<size_t>(i) * fold_tiles;
      const uint16_t* src = vecs + (t * d_aug + k0) * kLane;
      uint16_t* dst = ring + (s % kStages) * kStageElems;
      for (int e = tid; e < rows * 16; e += kThreads) {
        const int r = e >> 4;
        const int v = 8 * (e & 15);
        if (k0 + r < d_aug)
          cp_async16(dst + r * kTileRow + v, src + r * kLane + v);
        else
          *reinterpret_cast<uint4*>(dst + r * kTileRow + v) =
              make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[G][2][4];
  int32_t best[G][2][4];
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[n][i >> 2][i & 3] = 0.f;
      best[n][i >> 2][i & 3] = kEncInvalid;
    }

  // ldmatrix row addresses of this lane: A (k row, m column) and B (slot
  // row, k column), as offsets within a stage / the staged queries
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * kTileRow + 32 * warp +
                    8 * ((lane >> 3) & 1);
  const int b_off = (lane & 7) * qstride + 8 * ((lane >> 3) & 1);
  const int g = lane >> 2;
  const int t4 = lane & 3;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed; every warp is done with s - 1
    issue(s + kStages - 1);
    const int i = s / n_chunks;
    const int kc = s - i * n_chunks;
    const int k0 = kc * kKc;
    const int ksteps = min(kKc, d16 - k0) / 16;
    const uint16_t* st = ring + (s % kStages) * kStageElems;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[2][4];
      ldsm_x4_trans(a[0], st + a_off + ks * 16 * kTileRow);
      ldsm_x4_trans(a[1], st + a_off + ks * 16 * kTileRow + 16);
#pragma unroll
      for (int n = 0; n < G; ++n) {
        if (n >= n_groups) break;
        uint32_t b[2];
        ldsm_x2(b, qs + b_off + 8 * n * qstride + k0 + 16 * ks);
        mma_bf16(acc[n][0], a[0], b);
        mma_bf16(acc[n][1], a[1], b);
      }
    }
    if (kc == n_chunks - 1) {
      // epilogue of tile ti: acc[n][m][2h + p] is point 32 warp + 16 m +
      // 8 h + g, slot 8 n + 2 t4 + p
      const int pos0 = (w + i * fold_tiles) * kLane + 32 * warp + g;
#pragma unroll
      for (int n = 0; n < G; ++n) {
        if (n >= n_groups) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int m = e >> 2;
          const int pos = pos0 + 16 * m + 8 * ((e & 3) >> 1);
          float& d = acc[n][m][e & 3];
          if (pos < count) {
            // clamp at 0 (bf16 input rounding can push a ~0 distance
            // below); non-negative floats keep their order as integer bits
            const float v = d > 0.f ? d : 0.f;
            const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
            best[n][m][e & 3] =
                min(best[n][m][e & 3], static_cast<int32_t>(bits << 16) | pos);
          }
          d = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the minima as [slot][point]

  int32_t* so = reinterpret_cast<int32_t*>(ring);
#pragma unroll
  for (int n = 0; n < G; ++n) {
    if (n >= n_groups) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int m = e >> 2;
      const int slot = 8 * n + 2 * t4 + (e & 1);
      so[slot * kOutRow + 32 * warp + 16 * m + 8 * ((e & 3) >> 1) + g] =
          best[n][m][e & 3];
    }
  }
  __syncthreads();
  // every row of the block: 16 bytes a thread, a warp per 512-byte row
  for (int r = warp; r < n_rows; r += kThreads / 32)
    __stcs(reinterpret_cast<int4*>(out + r * s_width),
           r < n_act ? *reinterpret_cast<const int4*>(so + r * kOutRow +
                                                      4 * lane)
                     : invalid);
}

template <int G>
cudaError_t launch(const void* q_sel, const void* vecs,
                   const void* tile_offsets, const void* counts,
                   const void* slot_counts, void* enc, int n_lists, int qc,
                   int d_aug, int fold_tiles, int max_tiles,
                   cudaStream_t stream) {
  if constexpr (G > 1) {
    // fewer slots per block when the staged queries do not fit
    if (smem_bytes<G>(d_aug) > kMaxSmem)
      return launch<G / 2>(q_sel, vecs, tile_offsets, counts, slot_counts,
                           enc, n_lists, qc, d_aug, fold_tiles, max_tiles,
                           stream);
  }
  const size_t smem = smem_bytes<G>(d_aug);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // too wide
  auto kernel = scan_exact_csr_kernel<G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(n_lists) * fold_tiles,
                  (qc + 8 * G - 1) / (8 * G));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q_sel), static_cast<const uint16_t*>(vecs),
      static_cast<const int32_t*>(tile_offsets),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(slot_counts), static_cast<int32_t*>(enc),
      qc, d_aug, fold_tiles, max_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_sel: bf16 [n_lists, qc, d_aug]; vecs: bf16 [T, d_aug, 128];
// tile_offsets, counts: int32 [n_lists]; slot_counts: int32 [n_lists],
// list c's occupied slots (the first slot_counts[c]), or null for all qc;
// enc: int32 [n_lists, qc, fold_tiles * 128], written in full.
int scan_exact_csr_launch(const void* q_sel, const void* vecs,
                          const void* tile_offsets, const void* counts,
                          const void* slot_counts, void* enc, int n_lists,
                          int qc, int d_aug, int fold_tiles, int max_tiles,
                          void* stream) {
  if (d_aug < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<4>(
      q_sel, vecs, tile_offsets, counts, slot_counts, enc, n_lists, qc,
      d_aug, fold_tiles, max_tiles, static_cast<cudaStream_t>(stream)));
}

const char* scan_exact_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
