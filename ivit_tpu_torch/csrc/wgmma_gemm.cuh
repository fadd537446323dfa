// The row-block GEMM of the attention chain's two GEMM launches
// (attn_chain.cuh ln_qkv_wgmma_kernel and proj_wgmma_kernel), on Hopper's
// warpgroup MMA with TMA-fed weights:
//
//   out[r0:r0+64, :] = A[64, K] @ W[N, K]^T, int8 x int8 -> int32,
//
// A a 64-row int8 tile that the block writes itself (its LN output, the
// hoisted ln_in or ctx), W the weight transposed once by the wrapper
// ([N, K] row-major, K contiguous: the K-major layout that 8-bit wgmma
// takes for both operands).  One block of 288 threads:
//   * warp 8, the producer: one lane streams W in [BN, 128]-byte slices by
//     TMA (a CUtensorMap with 128-byte swizzle) into a ring of kStages
//     buffers, each with a "full" and an "empty" mbarrier; it starts before
//     the block's prologue runs, so the first slices arrive under it;
//   * warps 0-7, two consumer warpgroups: they write A in the same swizzled
//     K-major layout (the prologue), then for each BN-column pass each
//     warpgroup runs wgmma.mma_async m64n(BN/2)k32 over its half of the
//     pass (BN: exact.cuh pass_width, 128, 96 or 64 columns), slice by
//     slice, and hands the int32 tile to the epilogue in wgmma's
//     accumulator layout (wg_row / wg_col).
// The whole weight streams through every block; it stays in L2 (at most
// 3 MB for C = 1024).
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace ivit {

constexpr int kGemmRows = 64;                        // token rows a block
constexpr int kGemmConsumers = 256;                  // two warpgroups
constexpr int kGemmThreads = kGemmConsumers + 32;    // + the producer warp
constexpr int kStages = 3;                           // weight slices in flight
constexpr int kSliceK = 128;                         // K bytes a slice: one swizzle row

// K rounded up to whole 128-byte swizzle rows.
__host__ __device__ constexpr int gemm_kp(int K) {
  return (K + kSliceK - 1) / kSliceK * kSliceK;
}

// Dynamic shared memory of a block: 1024 bytes of alignment slack, the
// weight ring, the A tile and the 2 * kStages mbarriers.
__host__ __device__ constexpr size_t wg_smem(int K, int BN) {
  return 1024 + (size_t)kStages * BN * kSliceK + (size_t)kGemmRows * gemm_kp(K) +
         2 * kStages * sizeof(uint64_t);
}

// Byte offset of A[r][c] in the swizzled K-major tile: 128-byte column
// blocks of 64 rows each, and in a block the 16-byte chunk c / 16 of row r
// at chunk (c / 16) ^ (r % 8), the pattern TMA's 128-byte swizzle writes.
__device__ __forceinline__ int a_off(int r, int c) {
  return (c >> 7) * (kGemmRows * kSliceK) + r * kSliceK +
         ((((c >> 4) & 7) ^ (r & 7)) << 4) + (c & 15);
}

// ln_row's output row r of the swizzled A tile.
struct SwizzledRow {
  int8_t* a;
  int r;
  __device__ __forceinline__ int8_t& operator[](int c) const {
    return a[a_off(r, c)];
  }
};

// The rows r0.. of an int8 [R, C] matrix into the swizzled A tile (16
// bytes a thread at a time; rows past R zero).  Consumer threads only.
__device__ __forceinline__ void copy_rows_swizzled(
    const int8_t* __restrict__ src, int R, int C, int r0, int8_t* A) {
  const int cw = C >> 4;
  for (int i = threadIdx.x; i < kGemmRows * cw; i += kGemmConsumers) {
    const int row = i / cw, w = i - row * cw;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + row < R)
      v = *reinterpret_cast<const int4*>(src + (size_t)(r0 + row) * C + 16 * w);
    *reinterpret_cast<int4*>(A + a_off(row, 16 * w)) = v;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (c0 = K offset, c1 = row) of a 2-D tensor map into dst,
// completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, stride 1024 bytes between 8-row groups, layout
// SWIZZLE_128B.  A k step of 32 bytes inside a swizzle row advances the
// start address by 32.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma.mma_async m64nNk32 s32 += s8 * s8, both operands from shared memory.
template <int N>
struct Wgmma;
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The accumulator layout of wgmma m64nN for consumer thread threadIdx.x
// (< 256): d[4j + e] is row wg_row(e), column wg_col(j, e) of its
// warpgroup's 64 x N tile.
__device__ __forceinline__ int wg_row(int e) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int wg_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// Two 16-bit halves of adjacent 8-column tiles (v0: tile j, v1: tile j + 1,
// this lane's two columns of each) into one 32-bit word of four adjacent
// columns: lanes 2u and 2u + 1 of a quad swap halves, the even lane keeps
// tile j, columns 2t .. 2t + 3, the odd one tile j + 1, columns 2t - 2 ..
// 2t + 1.  pair_col gives the first of the four, relative to tile j.
__device__ __forceinline__ uint32_t pair_word(uint32_t v0, uint32_t v1) {
  const bool odd = threadIdx.x & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 1);
  return odd ? (got | (v1 << 16)) : (v0 | (got << 16));
}
__device__ __forceinline__ int pair_col() {
  const int t = threadIdx.x & 3;
  return 8 * (t & 1) + 2 * (t & ~1);
}

// The block's GEMM: fill(A) writes the 64-row A tile (consumer threads,
// swizzled K-major, a_off); then for each of the block's passes n0 (0, BN,
// .. < N, or with SPLIT the blockIdx.y-th gridDim.y-th of them) the two
// warpgroups compute columns n0 + wg * BN/2 .. + BN/2 and call
// epi(acc, n0 + wg * BN/2).  wmap: W [N, K] int8 with a [BN, 128] box,
// 128-byte swizzle.  Launch with kGemmThreads threads and wg_smem(K, BN)
// bytes of dynamic shared memory.
template <int BN, bool SPLIT, class Fill, class Epi>
__device__ __forceinline__ void wgmma_rows(const CUtensorMap* wmap, int K,
                                           int N, Fill fill, Epi epi) {
  constexpr int WN = BN / 2, NACC = WN / 2;
  extern __shared__ uint8_t wg_raw[];
  int8_t* Bs = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~(uintptr_t)1023);
  int8_t* As = Bs + kStages * BN * kSliceK;
  uint64_t* full = reinterpret_cast<uint64_t*>(As + kGemmRows * gemm_kp(K));
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kGemmConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this block's passes: all, or (SPLIT) a gridDim.y-th of them
  const int npass = N / BN, per = SPLIT ? (npass + gridDim.y - 1) / gridDim.y : npass;
  const int p0 = SPLIT ? blockIdx.y * per : 0, p1 = min(npass, p0 + per);
  const int nkb = (K + kSliceK - 1) / kSliceK, total = max(0, p1 - p0) * nkb;
  if (threadIdx.x >= kGemmConsumers) {
    if (threadIdx.x == kGemmConsumers) {
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, BN * kSliceK);
        tma_load_2d(Bs + s * BN * kSliceK, wmap, full + s, (it % nkb) * kSliceK,
                    (p0 + it / nkb) * BN);
      }
    }
    return;
  }
  fill(As);
  // zero A past K in its last swizzle row (TMA zero-fills W there), so
  // every slice runs all four k steps
  const int pad = (gemm_kp(K) - K) >> 4;
  for (int i = threadIdx.x; i < kGemmRows * pad; i += kGemmConsumers)
    *reinterpret_cast<int4*>(As + a_off(i / pad, K + 16 * (i % pad))) =
        make_int4(0, 0, 0, 0);
  // the generic-proxy writes of A, visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kGemmConsumers) : "memory");
  const int wg = threadIdx.x >> 7;
  int acc[NACC];
  int it = 0;
  for (int n0 = p0 * BN; n0 < p1 * BN; n0 += BN) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(full + s, (it / kStages) & 1);
      const int8_t* a = As + kb * kGemmRows * kSliceK;
      const int8_t* b = Bs + s * BN * kSliceK + wg * WN * kSliceK;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSliceK / 32; ++ks)
        Wgmma<WN>::mma(acc, sw128_desc(a + ks * 32), sw128_desc(b + ks * 32));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(acc[i])::"memory");
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);
    }
    epi(acc, n0 + wg * WN);
  }
}

}  // namespace ivit
