// onehot_mma.cuh: the one-hot tensor-core product that K1 (scan_fold_csr.cu)
// and K3 (estimate_scan_tiled.cu) share.
//
// A PQ estimate is a sum of table entries picked by 4-bit codes. For packed
// code byte sb, a query's 32 entries [lo 16 | hi 16] (permute_tables_csr's
// layout) are one k32 slice, so byte sb's share of the estimates of 16
// points and 8 query slots is one product of the points' one-hot rows (A,
// 16 x 32: a 1 at the lo nibble and at 16 + the hi nibble) with the slots'
// slices (B, 32 x 8). int8 tables take one mma.sync m16n8k32 s8 -> s32 per
// byte: int8 x {0, 1} products summed in s32 are exact, so the sums are
// bit for bit the lookups'. bf16 tables take two m16n8k16 bf16 -> f32 per
// byte, lo nibble then hi. Each has one nonzero product per point, so on a
// zero accumulator it gives the table entry exactly; the tensor cores' f32
// accumulation need not round to nearest, so the entry is added to the
// running sum by an f32 add, in the plain version's block order, and bf16
// sums are bit for bit the plain version's too. This is the TPU kernels'
// one-hot MXU product, on the tensor cores.
//
// A is built in registers from the code bytes, with no copy of it in
// shared or device memory; B is staged once per block in shared memory.
// The one-hot is on the A side (points are M) and the tables on the B side
// (slots are N, in groups of 8), the operand sides wgmma takes: K3's int8
// path issues wgmma m64n64k32 (scan_tile_gmma) with the same per-warp A
// fragments; K1 and K3's bf16 path use mma.sync (scan_tile).
//
// Warp tile: the warp's 32 points of a 128-point code tile by G groups of 8
// slots. Thread (g = lane / 4, t = lane % 4) loads the code word holding
// points 4g .. 4g + 3 and gives them to A as row g and g + 8 of m-tile 0
// (points 4g, 4g + 1) and of m-tile 1 (points 4g + 2, 4g + 3). So its
// accumulators acc[n][m][i] hold slot 8n + 2t + (i & 1) of point
// 4g + 2m + (i >> 1): per slot, four neighbouring points, which leave as
// one 16-byte store, and 8 threads fill a 128-byte line.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace onehot {

// The staged type of the tables whose sums are accumulated in Acc.
template <class Acc>
struct TableOf;
template <>
struct TableOf<int32_t> {
  using type = int8_t;
};
template <>
struct TableOf<float> {
  using type = uint16_t;  // raw bf16 bits
};

// 32-bit words of one staged slot: bs_pad * 32 entries plus 8 words of pad,
// so that a stride of 8 (mod 32) words puts the 64-bit B loads of a
// half-warp (4 slots x 4 threads) in distinct banks.
template <class S>
__host__ __device__ constexpr int row_words(int bs_pad) {
  return bs_pad * 8 * static_cast<int>(sizeof(S)) + 8;
}

// shl.b32 clamps a shift of 32 or more to 32, which gives 0; a "negative"
// shift is a large unsigned one, so it gives 0 too.
__device__ __forceinline__ uint32_t shl_clamped(uint32_t v, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(s));
  return r;
}

// Where the int8 staging puts the 4 values 4 vq .. 4 vq + 3 of nibble hi of
// byte sb of row r (a 32-bit word index). For the mma.sync B fragments:
// row stride rw, per byte 8 words, word 2 vq + hi.
struct MmaRows {
  int rw;
  __device__ int operator()(int r, int sb, int hi, int vq) const {
    return r * rw + sb * 8 + 2 * vq + hi;
  }
};

// For wgmma's B operand, K-major with no swizzle: per byte a block of
// sb_words words; in it, rows in groups of 8, each group two 8 x 16-byte
// core matrices (lo nibble, then hi) of 128 bytes, rows 16 bytes apart.
// So the descriptor's leading (K) byte offset is 128 and its stride (N)
// byte offset 256.
struct GmmaRows {
  int sb_words;
  __device__ int operator()(int r, int sb, int hi, int vq) const {
    return sb * sb_words + (r >> 3) * 64 + hi * 32 + (r & 7) * 4 + vq;
  }
};

// Stage n_rows rows of int8 tables, row r at src + r * 32 * bs_pad in
// permute_tables_csr's layout (value v of storage block s at column
// v * B_pad + s; s < bs_pad is the low nibble of packed byte s, s >= bs_pad
// the high nibble of byte s - bs_pad), at the words ``dest`` gives. Bytes
// sb >= n_bytes are not staged.
template <class Dest>
__device__ inline void stage_rows(uint32_t* tbl, const int8_t* src,
                                  int n_rows, int bs_pad, int n_bytes,
                                  Dest dest) {
  const int b_pad = 2 * bs_pad;
  const int quads = b_pad / 4;  // 4-block groups of one value's row
  const int per_row = 4 * quads;
  for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int j = i - r * per_row;
    const int vq = j / quads;
    const int s0 = 4 * (j - vq * quads);
    const int hi = s0 >= bs_pad;
    const int sb0 = s0 - hi * bs_pad;
    if (sb0 >= n_bytes) continue;
    // w_k: blocks s0 .. s0 + 3 of value 4 vq + k; transpose the 4 x 4 bytes
    const uint32_t* w = reinterpret_cast<const uint32_t*>(
        src + static_cast<size_t>(r) * 16 * b_pad + 4 * vq * b_pad + s0);
    const int vs = b_pad / 4;
    const uint32_t w0 = __ldg(w), w1 = __ldg(w + vs);
    const uint32_t w2 = __ldg(w + 2 * vs), w3 = __ldg(w + 3 * vs);
    const uint32_t x01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t y01 = __byte_perm(w2, w3, 0x5140);
    const uint32_t x23 = __byte_perm(w0, w1, 0x7362);
    const uint32_t y23 = __byte_perm(w2, w3, 0x7362);
    tbl[dest(r, sb0, hi, vq)] = __byte_perm(x01, y01, 0x5410);
    tbl[dest(r, sb0 + 1, hi, vq)] = __byte_perm(x01, y01, 0x7632);
    tbl[dest(r, sb0 + 2, hi, vq)] = __byte_perm(x23, y23, 0x5410);
    tbl[dest(r, sb0 + 3, hi, vq)] = __byte_perm(x23, y23, 0x7632);
  }
}

// int8 tables for the mma.sync B fragments (row stride rw words).
__device__ inline void stage_rows(uint32_t* tbl, const int8_t* src,
                                  int n_rows, int bs_pad, int n_bytes,
                                  int rw) {
  stage_rows(tbl, src, n_rows, bs_pad, n_bytes, MmaRows{rw});
}

// The same for bf16 tables: per byte sb, 16 words, word
// hi * 8 + 2 * (vp % 4) + vp / 4 holding values 2 vp, 2 vp + 1 of nibble hi.
__device__ inline void stage_rows(uint32_t* tbl, const uint16_t* src,
                                  int n_rows, int bs_pad, int n_bytes,
                                  int rw) {
  const int b_pad = 2 * bs_pad;
  const int pairs = b_pad / 2;  // 2-block groups of one value's row
  const int per_row = 8 * pairs;
  for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int j = i - r * per_row;
    const int vp = j / pairs;
    const int s0 = 2 * (j - vp * pairs);
    const int hi = s0 >= bs_pad;
    const int sb0 = s0 - hi * bs_pad;
    if (sb0 >= n_bytes) continue;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(
        src + static_cast<size_t>(r) * 16 * b_pad + 2 * vp * b_pad + s0);
    const uint32_t w0 = __ldg(w), w1 = __ldg(w + b_pad / 2);
    uint32_t* d = tbl + r * rw + sb0 * 16 + hi * 8 + 2 * (vp & 3) + (vp >> 2);
    d[0] = __byte_perm(w0, w1, 0x5410);   // block s0
    d[16] = __byte_perm(w0, w1, 0x7632);  // block s0 + 1
  }
}

// A fragment (m16n8k32, s8) of m-tile m for one code word: a 1 in byte
// 8 * (nibble - 4t) when that lies in the thread's 4 columns.
__device__ __forceinline__ void onehot_a(uint32_t cw, int m, uint32_t tsh,
                                         uint32_t (&a)[4]) {
  const uint32_t c = cw >> (16 * m);  // row g in byte 0, row g + 8 in byte 1
  a[0] = shl_clamped(1u, ((c << 3) & 0x78u) - tsh);  // row g, lo
  a[1] = shl_clamped(1u, ((c >> 5) & 0x78u) - tsh);  // row g + 8, lo
  a[2] = shl_clamped(1u, ((c >> 1) & 0x78u) - tsh);  // row g, hi
  a[3] = shl_clamped(1u, ((c >> 9) & 0x78u) - tsh);  // row g + 8, hi
}

// A fragment (m16n8k16, bf16) of m-tile m, nibble h: bf16 1.0 (0x3F80) in
// half (nibble - 2t) of columns 2t, 2t + 1 or (nibble - 8 - 2t) of 2t + 8,
// 2t + 9.
__device__ __forceinline__ void onehot_a(uint32_t cw, int m, int h,
                                         uint32_t tsh, uint32_t (&a)[4]) {
  const uint32_t c = cw >> (16 * m + 4 * h);
  const uint32_t x0 = (c << 4) & 0xF0u;  // 16 * nibble, row g
  const uint32_t x1 = (c >> 4) & 0xF0u;  // 16 * nibble, row g + 8
  a[0] = shl_clamped(0x3F80u, x0 - tsh);
  a[1] = shl_clamped(0x3F80u, x1 - tsh);
  a[2] = shl_clamped(0x3F80u, x0 - tsh - 128u);
  a[3] = shl_clamped(0x3F80u, x1 - tsh - 128u);
}

__device__ __forceinline__ void mma(int32_t (&d)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc += the one-hot product (one table entry per point and slot): the
// product on a zero accumulator, then one round-to-nearest f32 add.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  float d0, d1, d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "f"(0.0f));
  acc[0] = __fadd_rn(acc[0], d0);
  acc[1] = __fadd_rn(acc[1], d1);
  acc[2] = __fadd_rn(acc[2], d2);
  acc[3] = __fadd_rn(acc[3], d3);
}

// Code words of 8 bytes sb0 .. sb0 + 7 of the warp's tile column (codes:
// this thread's word of byte 0; byte rows are 128 bytes = 32 words apart).
__device__ __forceinline__ void load_codes(uint32_t (&cw)[8],
                                           const uint32_t* codes, int sb0,
                                           int n_bytes) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    cw[j] = sb0 + j < n_bytes ? __ldg(codes + (sb0 + j) * 32) : 0u;
}

// Add one code tile's estimates for the warp's 32 points and the first
// n_groups groups of 8 staged slots to acc (layout above). tbl: the staged
// rows; codes: this thread's word of byte 0 of the tile.
template <int G>
__device__ __forceinline__ void scan_tile(int32_t (&acc)[G][2][4],
                                          const uint32_t* tbl,
                                          const uint32_t* codes, int n_bytes,
                                          int n_groups, int rw) {
  const int lane = threadIdx.x & 31;
  const uint32_t tsh = 32u * (lane & 3);
  const uint32_t* brow = tbl + (lane >> 2) * rw + 2 * (lane & 3);
  uint32_t cw[8], next[8];
  load_codes(cw, codes, 0, n_bytes);
  for (int sb0 = 0; sb0 < n_bytes; sb0 += 8) {
    load_codes(next, codes, sb0 + 8, n_bytes);  // in flight meanwhile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sb = sb0 + j;
      if (sb >= n_bytes) break;
      uint32_t a0[4], a1[4];
      onehot_a(cw[j], 0, tsh, a0);
      onehot_a(cw[j], 1, tsh, a1);
#pragma unroll
      for (int n = 0; n < G; ++n) {
        if (n >= n_groups) break;
        const uint2 b =
            *reinterpret_cast<const uint2*>(brow + 8 * n * rw + sb * 8);
        mma(acc[n][0], a0, b);
        mma(acc[n][1], a1, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cw[j] = next[j];
  }
}

template <int G>
__device__ __forceinline__ void scan_tile(float (&acc)[G][2][4],
                                          const uint32_t* tbl,
                                          const uint32_t* codes, int n_bytes,
                                          int n_groups, int rw) {
  const int lane = threadIdx.x & 31;
  const uint32_t tsh = 32u * (lane & 3);
  const uint32_t* brow = tbl + (lane >> 2) * rw + 2 * (lane & 3);
  uint32_t cw[8], next[8];
  load_codes(cw, codes, 0, n_bytes);
  for (int sb0 = 0; sb0 < n_bytes; sb0 += 8) {
    load_codes(next, codes, sb0 + 8, n_bytes);  // in flight meanwhile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sb = sb0 + j;
      if (sb >= n_bytes) break;
      // block 2sb (lo nibble), then 2sb + 1 (hi): the plain version's order
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a0[4], a1[4];
        onehot_a(cw[j], 0, h, tsh, a0);
        onehot_a(cw[j], 1, h, tsh, a1);
#pragma unroll
        for (int n = 0; n < G; ++n) {
          if (n >= n_groups) break;
          const uint2 b = *reinterpret_cast<const uint2*>(
              brow + 8 * n * rw + sb * 16 + h * 8);
          mma(acc[n][0], a0, b);
          mma(acc[n][1], a1, b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cw[j] = next[j];
  }
}

// ---- wgmma (sm_90a): one warpgroup, A from registers, B in shared memory

// Shared-memory matrix descriptor of a no-swizzle K-major operand at p:
// start address, leading (K) byte offset 128, stride (N) byte offset 256,
// each encoded >> 4.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of r across a wgmma wait.
__device__ __forceinline__ void gmma_fence_operand(int32_t (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 s32, 32 per thread) = A (64 x 32 s8, registers) x B (the
// descriptor's 32 x 64 s8) + (scale_d ? d : 0).
__device__ __forceinline__ void gmma_s8(int32_t (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// One code tile's estimates for 128 points x 64 staged rows on wgmma: the
// warpgroup's two m64 halves are the m-tiles above (warp w's rows 16w ..
// 16w + 15 of half h are its points 4g + 2h, 4g + 2h + 1), so acc[h][4n + i]
// holds what acc[n][h][i] holds in scan_tile. One code byte per step: build
// its two A fragments, issue the two m64n64k32 products and wait for them
// before the next step rewrites A. (Building the A of 8 bytes first and
// issuing 16 products back to back gains nothing: ptxas serializes
// wgmma products whose A registers are written inside the pipeline
// stage, and the extra registers cost occupancy.)
__device__ __forceinline__ void scan_tile_gmma(int32_t (&acc)[2][32],
                                               uint64_t desc,
                                               const uint32_t* codes,
                                               int n_bytes, int sb_bytes) {
  const uint32_t tsh = 32u * (threadIdx.x & 3);
  uint32_t cw[8], next[8];
  load_codes(cw, codes, 0, n_bytes);
  for (int sb0 = 0; sb0 < n_bytes; sb0 += 8) {
    load_codes(next, codes, sb0 + 8, n_bytes);  // in flight meanwhile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sb = sb0 + j;
      if (sb >= n_bytes) break;
      uint32_t a[2][4];
      onehot_a(cw[j], 0, tsh, a[0]);
      onehot_a(cw[j], 1, tsh, a[1]);
      gmma_fence_operand(acc[0]);
      gmma_fence_operand(acc[1]);
      gmma_fence();
      const uint64_t b = desc + ((sb * sb_bytes) >> 4);
      gmma_s8(acc[0], a[0], b, sb > 0);
      gmma_s8(acc[1], a[1], b, sb > 0);
      gmma_commit();
      gmma_wait<0>();
      gmma_fence_operand(acc[0]);
      gmma_fence_operand(acc[1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cw[j] = next[j];
  }
}

// The four points of slot 8n + 2t + p in acc[n] (points 4g .. 4g + 3).
__device__ __forceinline__ int4 points_of(const int32_t (&a)[2][4], int p) {
  return make_int4(a[0][p], a[0][2 + p], a[1][p], a[1][2 + p]);
}
__device__ __forceinline__ float4 points_of(const float (&a)[2][4], int p) {
  return make_float4(a[0][p], a[0][2 + p], a[1][p], a[1][2 + p]);
}
// The same for the wgmma accumulators.
__device__ __forceinline__ int4 points_of(const int32_t (&a)[2][32], int n,
                                          int p) {
  return make_int4(a[0][4 * n + p], a[0][4 * n + 2 + p], a[1][4 * n + p],
                   a[1][4 * n + 2 + p]);
}

}  // namespace onehot
