// The row-block GEMM of the block kernels on Hopper's warpgroup MMA with
// TMA-fed weights: the attention chain's two GEMM launches (attn_chain.cuh
// ln_qkv_wgmma_kernel and proj_wgmma_kernel) and the MLP's fc1 and fc2
// (mlp_block.cu mlp_wgmma_kernel, both in one block):
//
//   out[r0:r0+64, :] = A[64, K] @ W[N, K]^T, int8 x int8 -> int32,
//
// A a 64-row int8 tile that the block writes itself (its LN output, the
// hoisted ln_in, ctx, or the MLP's hidden tile), W the weight transposed
// ([N, K] row-major, K contiguous: the K-major layout that 8-bit wgmma
// takes for both operands).  One block of 288 threads:
//   * warp 8, the producer: one lane streams W in [BN, 128]-byte slices by
//     TMA (a CUtensorMap with 128-byte swizzle) into a ring of kStages
//     buffers, each with a "full" and an "empty" mbarrier; it starts before
//     the block's prologue runs, so the first slices arrive under it, and
//     it may stream several weights in one sequence (ring_produce once per
//     weight: the MLP's W2 slices arrive during its GELU phase);
//   * warps 0-7, two consumer warpgroups: they write A in the same swizzled
//     K-major layout (the prologue), then for each BN-column pass each
//     warpgroup runs wgmma.mma_async m64n(BN/2)k32 over its half of the
//     pass (BN: exact.cuh pass_width, 128, 96 or 64 columns), slice by
//     slice (ring_consume, on the same ring counter as the producer), and
//     hands the int32 tile to the epilogue in wgmma's accumulator layout
//     (wg_row / wg_col).
// The whole weight streams through every block; it stays in L2 (at most
// 4 MB for C = 1024, hidden 4096).
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <mutex>

#include "exact.cuh"

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

// Where a GEMM's row r lies in the [R, C] matrices that it reads and
// writes row by row: the row itself (every kernel but Swin's token-order
// window chain, swin_attn_block.cu WindowRows, whose rows are windows'
// tokens and whose matrices are in token order).  A map is a functor
// int -> int; the kernels take it as their last argument.  at(g): the map
// as one thread's epilogue uses it, on its rows g and g + 8 alone
// (residual_epilogue), so a map that costs arithmetic runs it once.
struct IdentityRows {
  __device__ __forceinline__ int operator()(int r) const { return r; }
  __device__ __forceinline__ IdentityRows at(int) const { return *this; }
};

// The rows r0.. of an int8 [R, C] matrix, row r at rows(r), into the
// swizzled A tile (16 bytes a thread at a time; rows past R zero).
// Consumer threads only.
template <class Rows = IdentityRows>
__device__ __forceinline__ void copy_rows_swizzled(
    const int8_t* __restrict__ src, int R, int C, int r0, int8_t* A,
    Rows rows = {}) {
  const int cw = C >> 4;
  for (int i = threadIdx.x; i < kGemmRows * cw; i += kGemmConsumers) {
    const int row = i / cw, w = i - row * cw;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + row < R)
      v = *reinterpret_cast<const int4*>(src + (size_t)rows(r0 + row) * C + 16 * w);
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

// The weight ring in shared memory: kStages [BN, 128]-byte slice buffers
// (1024-byte aligned, as the 128-byte swizzle wants) and their "full" and
// "empty" mbarriers.  Producer and consumers walk the same sequence of
// slices with their own copies of one counter `it`.
struct WeightRing {
  int8_t* bufs;
  uint64_t* full;
  uint64_t* empty;
};

// The first 1024-byte boundary of dynamic shared memory (which carries 1024
// bytes of slack for it): the ring's buffers start there.
__device__ __forceinline__ int8_t* smem_aligned(uint8_t* raw) {
  return reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
}

// Thread 0 initialises the ring's barriers; the caller then syncs the block.
__device__ __forceinline__ void ring_init(const WeightRing& ring) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kGemmConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The producer lane: the slices of W's passes p0 .. p1 - 1 (BN rows each,
// K in 128-byte slices) into the ring, from slice number it on.
template <int BN>
__device__ __forceinline__ void ring_produce(const WeightRing& ring,
                                             const CUtensorMap* wmap, int K,
                                             int p0, int p1, int& it) {
  const int nkb = (K + kSliceK - 1) / kSliceK;
  for (int p = p0; p < p1; ++p)
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(ring.empty + s, ((it / kStages) & 1) ^ 1);
      mbar_expect_tx(ring.full + s, BN * kSliceK);
      tma_load_2d(ring.bufs + s * BN * kSliceK, wmap, ring.full + s,
                  kb * kSliceK, p * BN);
    }
}

// The consumers: one BN-column pass over the swizzled A tile (K deep) from
// the slices it .. of the ring; warpgroup wg's half in acc (wg_row /
// wg_col), each slice released to the producer as soon as it is used.
template <int BN>
__device__ __forceinline__ void ring_consume(const WeightRing& ring,
                                             const int8_t* A, int K, int& it,
                                             int (&acc)[BN / 4]) {
  constexpr int WN = BN / 2, NACC = WN / 2;
  const int wg = threadIdx.x >> 7, nkb = (K + kSliceK - 1) / kSliceK;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  for (int kb = 0; kb < nkb; ++kb, ++it) {
    const int s = it % kStages;
    mbar_wait(ring.full + s, (it / kStages) & 1);
    const int8_t* a = A + kb * kGemmRows * kSliceK;
    const int8_t* b = ring.bufs + s * BN * kSliceK + wg * WN * kSliceK;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSliceK / 32; ++ks)
      Wgmma<WN>::mma(acc, sw128_desc(a + ks * 32), sw128_desc(b + ks * 32));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(acc[i])::"memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(ring.empty + s);
  }
}

// Zero a swizzled tile past K in its last swizzle row (TMA zero-fills W
// there), so every slice runs all four k steps.  Consumer threads only.
__device__ __forceinline__ void pad_tile_k(int8_t* A, int K) {
  const int pad = (gemm_kp(K) - K) >> 4;
  for (int i = threadIdx.x; i < kGemmRows * pad; i += kGemmConsumers)
    *reinterpret_cast<int4*>(A + a_off(i / pad, K + 16 * (i % pad))) =
        make_int4(0, 0, 0, 0);
}

// The consumers' named barrier (the producer warp has left: no
// __syncthreads after the split).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kGemmConsumers) : "memory");
}

// The generic-proxy writes of a tile, visible to wgmma's async proxy once
// the consumers have synced.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
  extern __shared__ uint8_t wg_raw[];
  int8_t* Bs = smem_aligned(wg_raw);
  int8_t* As = Bs + kStages * BN * kSliceK;
  uint64_t* full = reinterpret_cast<uint64_t*>(As + kGemmRows * gemm_kp(K));
  const WeightRing ring{Bs, full, full + kStages};
  ring_init(ring);
  __syncthreads();
  // this block's passes: all, or (SPLIT) a gridDim.y-th of them
  const int npass = N / BN, per = SPLIT ? (npass + gridDim.y - 1) / gridDim.y : npass;
  const int p0 = SPLIT ? blockIdx.y * per : 0, p1 = min(npass, p0 + per);
  int it = 0;
  if (threadIdx.x >= kGemmConsumers) {
    if (threadIdx.x == kGemmConsumers) ring_produce<BN>(ring, wmap, K, p0, p1, it);
    return;
  }
  fill(As);
  pad_tile_k(As, K);
  fence_to_async();
  consumers_sync();
  int acc[BN / 4];
  for (int p = p0; p < p1; ++p) {
    ring_consume<BN>(ring, As, K, it, acc);
    epi(acc, p * BN + (threadIdx.x >> 7) * (BN / 2));
  }
}

// The LN prologue of a row GEMM: the LN (of the ln_kind form, exact.cuh
// ln_row_i32) of the 64 rows r0.. of x (XT: int8 or int16; row r at
// rows(r)) into the swizzled A tile.  A row takes L lanes (8 below C 256,
// else 16), so a warp runs 32 / L rows at once: the Newton chain and the
// group reductions are latency.  Rows past R rerun row R - 1 (every lane
// of a warp takes part in the group sums); the GEMM never stores them.
template <int L, typename XT, class Rows = IdentityRows>
__device__ __forceinline__ void ln_rows_swizzled(
    const XT* __restrict__ x, int R, int C, int r0, int ln_kind,
    const float* __restrict__ bias, const float* __restrict__ m_ln, float pw,
    int shift, int8_t* A, Rows rows = {}) {
  constexpr int kGroups = 32 / L, kWarps = kGemmConsumers / 32;
  const int lane = threadIdx.x & (L - 1);
  const int first = (threadIdx.x >> 5) * kGroups + ((threadIdx.x & 31) / L);
  for (int row = first; row < kGemmRows; row += kWarps * kGroups) {
    const XT* xrow = x + (size_t)rows(min(r0 + row, R - 1)) * C;
    const SwizzledRow out{A, row};
    if (ln_kind == kLnIvit)
      ln_row_i32<true, L>(xrow, C, bias, m_ln, 1.f, 0, out, lane);
    else
      ln_row_i32<false, L>(xrow, C, bias, m_ln, pw, shift, out, lane,
                           ln_kind == kLnIbertIntSqrt);
  }
}

template <typename XT, class Rows = IdentityRows>
__device__ __forceinline__ void ln_rows_any_width(
    const XT* __restrict__ x, int R, int C, int r0, int ln_kind,
    const float* __restrict__ bias, const float* __restrict__ m_ln, float pw,
    int shift, int8_t* A, Rows rows = {}) {
  if (C < 256)
    ln_rows_swizzled<8>(x, R, C, r0, ln_kind, bias, m_ln, pw, shift, A, rows);
  else
    ln_rows_swizzled<16>(x, R, C, r0, ln_kind, bias, m_ln, pw, shift, A, rows);
}

// The A tile of an LN + GEMM block: the LN of the rows r0.. of x (int8,
// or int16 with x16; row r at rows(r)) with the LN shift leaf ln_shift, or
// the hoisted LN output ln_in (null: run the LN; its rows mapped alike) as
// it is.
template <class Rows = IdentityRows>
__device__ __forceinline__ void fill_ln_tile(
    int8_t* A, const void* __restrict__ x, const int8_t* __restrict__ ln_in,
    int R, int C, int r0, bool x16, int ln_kind,
    const float* __restrict__ ln_bias, const float* __restrict__ m_ln,
    const float* __restrict__ ln_shift, Rows rows = {}) {
  if (ln_in != nullptr) {
    copy_rows_swizzled(ln_in, R, C, r0, A, rows);
    return;
  }
  const LnShift ln = ln_shift_of(ln_shift);
  if (x16)
    ln_rows_any_width(static_cast<const int16_t*>(x), R, C, r0, ln_kind,
                      ln_bias, m_ln, ln.pw, ln.bits, A, rows);
  else
    ln_rows_any_width(static_cast<const int8_t*>(x), R, C, r0, ln_kind,
                      ln_bias, m_ln, ln.pw, ln.bits, A, rows);
}

// Two adjacent activations x[i], x[i + 1] (i even) of an int8 or (x16)
// int16 stream, read-only for the kernel: one 2- or 4-byte load through the
// non-coherent path.
__device__ __forceinline__ float2 load_act_pair(const void* x, size_t i,
                                                bool x16) {
  if (x16) {
    const int w = __ldg(reinterpret_cast<const int*>(static_cast<const int16_t*>(x) + i));
    return make_float2((float)(int16_t)w, (float)(w >> 16));
  }
  const int w = __ldg(reinterpret_cast<const short*>(static_cast<const int8_t*>(x) + i));
  return make_float2((float)(int8_t)w, (float)(w >> 8));
}

// The epilogue of a GEMM that closes a half-block (attn's proj, the MLP's
// fc2): bias, requant to lim_p's bits, then the integer residual
// clip(round(y * m_res_x) + round(x * m_res_id)) to lim_o's, for the
// columns c0 .. c0 + BN/2 of this warpgroup's pass and the rows r0.. < R;
// x and out [R, C], int8 or (x16 / o16) int16, x read-only, row r of both
// at rows(r) (a map's at(r0 + wg_row(0))).  Each group of two 8-column tiles and one row half loads its
// x before it stores; 8-bit rows are stored a 4-byte word of two lanes at a
// time (pair_word), 16-bit ones two columns a lane.
template <int BN, class Rows = IdentityRows>
__device__ __forceinline__ void residual_epilogue(
    const int (&acc)[BN / 4], int c0, int r0, int R, int C,
    const void* __restrict__ x, const int32_t* __restrict__ bias,
    const float* __restrict__ mult, float m_res_x, float m_res_id,
    float lim_p, float lim_o, bool x16, bool o16, void* __restrict__ out,
    Rows rows = {}) {
#pragma unroll
  for (int j = 0; j < BN / 16; j += 2)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + wg_row(2 * h);
      float2 xv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (gr < R) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          xv[q] = load_act_pair(x, (size_t)rows(gr) * C + c0 + wg_col(j + q, 0), x16);
      }
      int o[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = c0 + wg_col(j + q, 0);
        const int2 b = __ldg(reinterpret_cast<const int2*>(bias + col));
        const float2 m = __ldg(reinterpret_cast<const float2*>(mult + col));
        const int* a = &acc[4 * (j + q) + 2 * h];
        const float y0 = requant(__int2float_rn(a[0] + b.x), m.x, lim_p);
        const float y1 = requant(__int2float_rn(a[1] + b.y), m.y, lim_p);
        o[q][0] = (int)clampf(rintf(y0 * m_res_x) + rintf(xv[q].x * m_res_id),
                              -lim_o, lim_o - 1.f);
        o[q][1] = (int)clampf(rintf(y1 * m_res_x) + rintf(xv[q].y * m_res_id),
                              -lim_o, lim_o - 1.f);
      }
      if (o16) {
        if (gr < R) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            *reinterpret_cast<uint32_t*>(static_cast<int16_t*>(out) +
                                         (size_t)rows(gr) * C + c0 + wg_col(j + q, 0)) =
                (uint32_t)(o[q][0] & 0xffff) | ((uint32_t)(o[q][1] & 0xffff) << 16);
        }
      } else {
        uint32_t v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          v[q] = (uint32_t)(o[q][0] & 0xff) | ((uint32_t)(o[q][1] & 0xff) << 8);
        const uint32_t word = pair_word(v[0], v[1]);
        if (gr < R)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) +
                                       (size_t)rows(gr) * C + c0 + 8 * j +
                                       pair_col()) = word;
      }
    }
}

// The TMA descriptor of a weight W [N, K] int8, row-major: [BN, 128]-byte
// boxes with the 128-byte swizzle, zero past K.  cuTensorMapEncodeTiled
// comes from the driver through the runtime's entry-point query (no -lcuda);
// descriptors are cached by pointer and shape (enough entries for a
// forward's weights), since the host sets the pace of small calls.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline cudaError_t weight_map(CUtensorMap* map, const int8_t* w, int N, int K,
                              int BN) {
  struct Entry {
    const int8_t* w;
    int N, K, BN;
    CUtensorMap map;
  };
  constexpr int kCache = 64;
  static Entry cache[kCache];
  static int used = 0, next = 0;
  static EncodeTiledFn encode = nullptr;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.w == w && e.N == N && e.K == K && e.BN == BN) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kSliceK, (cuuint32_t)BN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cache[next] = {w, N, K, BN, *map};
  next = (next + 1) % kCache;
  if (used < kCache) ++used;
  return cudaSuccess;
}

// The card's SM count, read once (1 if it cannot be read).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 1;
    return n;
  }();
  return sms;
}

// Blocks of the proj launch over R rows and N columns: ceil(R / 64) row
// blocks, times a split of the BN-column passes where the row blocks alone
// would leave SMs idle (Swin-T's last stage has 49 of them for 132 SMs).
// ln_qkv is not split: each split block would rerun the LN of its rows.
inline dim3 gemm_grid(int R, int N, int BN) {
  const int sms = sm_count();
  const int rows = (R + kGemmRows - 1) / kGemmRows, passes = N / BN;
  const int split = min(passes, max(1, (2 * sms + rows - 1) / rows));
  return dim3(rows, split);
}

}  // namespace ivit
