// Fused MLP half-block, ivit, ibert and ppoly GELUs, for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::mlp_block_p (body _mlp_kernel):
//   LN (I-LayerNorm or ibert LN; or the hoisted int8 ln_in) -> int8
//   requant -> fc1 + bias -> requant -> GELU (ShiftGELU, ibert GELU or the
//   ppoly GELU) -> requant -> fc2 + bias -> requant to mlp_bits -> integer
//   residual clip(round(y * m_res_x) + round(x * m_res_id)).
//
// The token stream in and out is int8 or int16, each read and written as it
// is: int8 -> int8 (ViT), int16 -> int16 (Swin: fc2 requant to 8 bits,
// residual and output at 16 bits), int16 -> int8 (the reference's INT16
// configuration: norm2_in 16 bits, att_block_out 8).
//
// Bound on this card: operations.  At DeiT-S (R = 256 * 197 rows, C 384,
// hidden 1536) one launch does 2 * R * C * hidden * 2 = 119 G int8 ops
// (~60 us at 1,979 TOPS) and moves ~40 MB (~12 us at 3.35 TB/s); Swin-T's
// four stages at batch 64 do 2 * R * C * 4C * 2 = 59-118 G ops a launch.
//
// Design (mlp_wgmma_kernel): one block of 288 threads per 64 token rows on
// the row GEMM of wgmma_gemm.cuh, everything between the input read and the
// output write kept in shared memory:
//   * the producer warp streams fc1's weight [Hd, C] and then fc2's [C, Hd]
//     through one TMA ring in one sequence, so fc2's first slices arrive
//     during the GELU phase;
//   * the two consumer warpgroups write the LN rows (ln_row_i32 over 8 or
//     16 lanes a row, exact int32) or the hoisted ln_in into the swizzled A
//     tile;
//   * fc1 runs on wgmma in passes of 128 columns (96 or 64 where the widths
//     are not multiples of 128: Swin-T's C = 96 and 192); its epilogue
//     applies bias and requant (and the ibert GELU and its requant per
//     element) and writes the int8 hidden tile [64, Hd] in the same
//     swizzled K-major layout, fc2's A operand;
//   * the ppoly GELU: its input is the int8 fc1 requant, so the GELU and
//     its requant of all 256 inputs are one table (ppoly.cuh
//     ppoly_table_kernel, launched first, fast-div or rdiv form), which
//     fc1's epilogue looks up an element: the same bits as the reference's
//     per-element Horner and divide, computed 256 times a call;
//   * the table forms (a spec's freeze-time gelu_lut, block.py :728-757):
//     the ibert GELU x * U[x + 128] and the ppoly GELU U[x + 128] take the
//     same 256-entry table of final outputs, built from U by one launch
//     (gelu_lut_table_kernel); ShiftGELU's table launch takes its exps from
//     the spec's T instead of the exp tower;
//   * ShiftGELU: fc1's epilogue also keeps each row's max (the lane, the
//     quad, then a shared atomicMax a row); after the last pass each row
//     copies its max's 256-byte table of final outputs from the call's
//     table (ivit.cuh shift_gelu_table_kernel, launched first: every
//     (row max, value) pair, 65,536 evaluations of the divide chain a call
//     instead of one an element), and the hidden tile is rewritten in
//     place by lookup.  In place
//     rather than looked up on the way into fc2's A registers: the tile
//     stays the shared-memory operand that the same ring_consume reads, and
//     the rewrite is one pass of 16-byte chunks;
//   * the tile is fenced to the async proxy, and fc2 runs on wgmma; its
//     epilogue is the attention chain's residual epilogue
//     (wgmma_gemm.cuh residual_epilogue).
// Where the 64-row tiles and the ring do not fit a block's shared memory
// (hidden 3072 at C 768: Swin-T stage 3, ViT-B; hidden 4096 at C 1024:
// ViT-L), ivit_mlp_block takes mlp_block_kernel instead: the first port's
// 32-row block on mma.sync with a cp.async weight stream and the f32 LN, whose 8
// warps split the output columns four ways so that every hidden row stays
// whole in shared memory; its ShiftGELU is the same table row code
// (shift_gelu_row).  The weights come transposed ([out, in], torch's
// Linear layout; the engine keeps such copies).  C need not be a multiple
// of the TPU's 128 lanes: the port runs Swin's C = 96 and 192 as they are,
// with no c_valid padding.  The LN shift and the GELU constants are
// derived in every thread from the spec's scalar leaves, with the plain
// version's rdiv, so a call costs the host no arithmetic launches.

#include "ivit.cuh"
#include "ppoly.cuh"
#include "wgmma_gemm.cuh"

namespace ivit {

// The GELU families of the kernels (the wrapper's codes): the ibert GELU
// per element in fc1's epilogue, ShiftGELU through the per-row tables, the
// ppoly GELU through its 256-entry table of final outputs (kGeluTable, the
// epilogue the table forms of the ibert and ppoly GELUs take too).
constexpr int kGeluIbert = 0, kGeluShift = 1, kGeluPpoly = 2;
constexpr int kGeluTable = kGeluPpoly;

// The table forms of the ibert and ppoly GELUs + requant (block.py
// _ibert_gelu_lut, _ppoly_gelu_lut, then _requant): their input is the int8
// fc1 requant, so all 256 outputs are one table, as the ppoly GELU's:
// table[x + 128] = requant(x * U[x + 128]) (times_x, ibert) or
// requant(U[x + 128]) (ppoly), U the spec's gelu_lut, one f32 multiply and
// the requant as the reference rounds them.
__global__ void __launch_bounds__(256)
gelu_lut_table_kernel(const float* __restrict__ lut, int times_x,
                      const float* __restrict__ m_gelu,
                      int8_t* __restrict__ table) {
  const int i = threadIdx.x;
  const float u = __ldg(lut + i);
  const float g = times_x ? __fmul_rn(__int2float_rn(i - 128), u) : u;
  table[i] = (int8_t)(int)requant(g, __ldg(m_gelu), 128.f);
}

// ibert GELU on one int8-valued input (block.py _ibert_gelu).
__device__ __forceinline__ float ibert_gelu(float h, float b_int, float c_int,
                                            float shift, int fast_poly) {
  float sgn = h > 0.f ? 1.f : (h < 0.f ? -1.f : 0.f);
  float t = fminf(fabsf(h), -b_int) + b_int;
  float z = fast_poly ? t * t + c_int : exact_fma(t, t, c_int);
  float y = floorf(sgn * z * 0.015625f);
  return h * (y + shift);
}

// The kernel's scalar operands: device pointers to the spec's 0-d f32
// leaves, read by every thread (no wrapper-side arithmetic).
struct MlpScalars {
  const float *ln_shift, *s_gelu, *m_gelu, *m_res_x, *m_res_id;
};

// ibert GELU constants at input scale s_gelu, as ibert.int_erf and
// ibert_gelu_int derive them: b_int, c_int and the sigmoid shift.
struct GeluConsts {
  float b, c, shift;
};
__device__ __forceinline__ GeluConsts gelu_consts_of(float s_gelu) {
  const float se = rdiv(s_gelu, kGeluK);
  const float se2 = __fmul_rn(se, se);
  return {floorf(rdiv(kGeluB, se)), floorf(rdiv(kGeluC, se2)),
          floorf(rdiv(1.f, __fmul_rn(__fmul_rn(se2, kGeluA), 64.f)))};
}

// Shared memory of one mlp_wgmma_kernel block: alignment slack, the weight
// ring, the LN tile and the hidden tile (both swizzled, K rounded up to
// 128), for ShiftGELU the rows' tables and maxima, the ring's barriers.
__host__ __device__ constexpr size_t mlp_wg_smem(int C, int Hd, int BN,
                                                 bool shift_gelu) {
  return 1024 + (size_t)kStages * BN * kSliceK +
         (size_t)kGemmRows * (gemm_kp(C) + gemm_kp(Hd)) +
         (shift_gelu ? (size_t)kGemmRows * (256 + sizeof(int)) : 0) +
         2 * kStages * sizeof(uint64_t);
}

// w1 / w2: the tensor maps of fc1's weight transposed [Hd, C] and fc2's
// [C, Hd]; x and out: [R, C], int8 or (x16 / o16) int16; ln_in: the hoisted LN
// output [R, C], or null to run the LN here.  GELU: kGeluShift, ShiftGELU
// through gelu_table (shift_gelu_table_kernel's); kGeluTable, the GELU +
// requant through gelu_table (ppoly_table_kernel's or
// gelu_lut_table_kernel's, 256 entries); kGeluIbert, the ibert GELU.
template <int BN, int GELU>
__global__ void __launch_bounds__(kGemmThreads, 2)
mlp_wgmma_kernel(const __grid_constant__ CUtensorMap w1,
                 const __grid_constant__ CUtensorMap w2,
                 const void* __restrict__ x, const int8_t* __restrict__ ln_in,
                 const float* __restrict__ ln_bias,
                 const float* __restrict__ m_ln, const int32_t* __restrict__ b1,
                 const float* __restrict__ m1, const int32_t* __restrict__ b2,
                 const float* __restrict__ m2, MlpScalars sp,
                 const int8_t* __restrict__ gelu_table,
                 void* __restrict__ out, int R, int C, int Hd, int mlp_bits,
                 int out_bits, int x16, int o16, int ln_kind, int fast_poly) {
  constexpr int WN = BN / 2;
  extern __shared__ uint8_t mlp_raw[];
  int8_t* bufs = smem_aligned(mlp_raw);
  int8_t* A = bufs + kStages * BN * kSliceK;
  int8_t* G = A + kGemmRows * gemm_kp(C);
  int8_t* T = G + kGemmRows * gemm_kp(Hd);  // ShiftGELU: [64][256] tables
  int* rmax = reinterpret_cast<int*>(T + kGemmRows * 256);
  constexpr bool SHIFT_GELU = GELU == kGeluShift;
  uint64_t* bars = reinterpret_cast<uint64_t*>(SHIFT_GELU ? (int8_t*)(rmax + kGemmRows) : T);
  const WeightRing ring{bufs, bars, bars + kStages};
  ring_init(ring);
  __syncthreads();
  const int r0 = blockIdx.x * kGemmRows;
  int it = 0;
  if (threadIdx.x >= kGemmConsumers) {
    if (threadIdx.x == kGemmConsumers) {
      ring_produce<BN>(ring, &w1, C, 0, Hd / BN, it);
      ring_produce<BN>(ring, &w2, Hd, 0, C / BN, it);
    }
    return;
  }
  fill_ln_tile(A, x, ln_in, R, C, r0, x16, ln_kind, ln_bias, m_ln, sp.ln_shift);
  pad_tile_k(A, C);
  pad_tile_k(G, Hd);
  if (SHIFT_GELU && threadIdx.x < kGemmRows) rmax[threadIdx.x] = -128;
  fence_to_async();
  consumers_sync();

  // fc1 + bias + requant (ibert: + GELU + requant) into the hidden tile,
  // two lanes' 16-bit pairs of two 8-column tiles a 4-byte word
  GeluConsts gc{};
  if (GELU == kGeluIbert) gc = gelu_consts_of(__ldg(sp.s_gelu));
  const float m_gelu = __ldg(sp.m_gelu);
  const int wg = threadIdx.x >> 7;
  int vmax[2] = {-128, -128};  // this lane's max of rows wg_row(0), wg_row(2)
  int acc[BN / 4];
  for (int n0 = 0; n0 < Hd; n0 += BN) {
    ring_consume<BN>(ring, A, C, it, acc);
    const int c0 = n0 + wg * WN;
#pragma unroll
    for (int j = 0; j < BN / 16; j += 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = c0 + wg_col(j + q, 0);
          const int2 b = __ldg(reinterpret_cast<const int2*>(b1 + col));
          const float2 m = __ldg(reinterpret_cast<const float2*>(m1 + col));
          const int* a = &acc[4 * (j + q) + 2 * h];
          float lo = requant(__int2float_rn(a[0] + b.x), m.x, 128.f);
          float hi = requant(__int2float_rn(a[1] + b.y), m.y, 128.f);
          if (SHIFT_GELU) {
            vmax[h] = max(vmax[h], max((int)lo, (int)hi));
          } else if (GELU == kGeluTable) {
            lo = (float)__ldg(gelu_table + (int)lo + 128);
            hi = (float)__ldg(gelu_table + (int)hi + 128);
          } else {
            lo = requant(ibert_gelu(lo, gc.b, gc.c, gc.shift, fast_poly),
                         m_gelu, 128.f);
            hi = requant(ibert_gelu(hi, gc.b, gc.c, gc.shift, fast_poly),
                         m_gelu, 128.f);
          }
          v[q] = (uint32_t)((int)lo & 0xff) | ((uint32_t)((int)hi & 0xff) << 8);
        }
        const uint32_t word = pair_word(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(
            G + a_off(wg_row(2 * h), c0 + 8 * j + pair_col())) = word;
      }
  }

  if (SHIFT_GELU) {
    // row maxima: over the quad that holds a row, then across warps
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = max(vmax[h], __shfl_xor_sync(0xffffffffu, vmax[h], 1));
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if ((threadIdx.x & 3) == 0) atomicMax(rmax + wg_row(2 * h), m);
    }
    consumers_sync();  // the hidden tile and its row maxima are complete
    // each row's 256-byte table, 16 bytes a thread a step
    for (int i = threadIdx.x; i < kGemmRows * 16; i += kGemmConsumers) {
      const int r = i >> 4;
      reinterpret_cast<int4*>(T + r * 256)[i & 15] = __ldg(
          reinterpret_cast<const int4*>(gelu_table + (rmax[r] + 128) * 256) + (i & 15));
    }
    consumers_sync();
    const int cw = Hd >> 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kGemmRows * cw; i += kGemmConsumers) {
      const int r = i / cw;
      int4* p = reinterpret_cast<int4*>(G + a_off(r, 16 * (i - r * cw)));
      *p = gelu_lookup16(T + r * 256, *p);
    }
  }
  fence_to_async();
  consumers_sync();

  // fc2 + bias + requant to mlp_bits + residual to out_bits (block.py
  // :766-775; on Swin 8 and 16)
  const float m_res_x = __ldg(sp.m_res_x), m_res_id = __ldg(sp.m_res_id);
  const float lim_mlp = bits_lim(mlp_bits), lim_out = bits_lim(out_bits);
  for (int n0 = 0; n0 < C; n0 += BN) {
    ring_consume<BN>(ring, G, Hd, it, acc);
    residual_epilogue<BN>(acc, n0 + wg * WN, r0, R, C, x, b2, m2, m_res_x,
                          m_res_id, lim_mlp, lim_out, x16, o16, out);
  }
}

// The block for shapes whose 64-row tiles do not fit mlp_wgmma_kernel's
// shared memory: TM token rows per block on mma.sync (exact.cuh
// gemm_tile), the LN one row a warp (ln_row), the hidden tile [TM, Hd]
// row-major.  w1t: fc1 weight transposed, [Hd, C]; w2t: fc2 weight
// transposed, [C, Hd].  x: [R, C] of XT, int8 or int16; out: [R, C], int8
// or (o16) int16.  ln_in: the hoisted LN output [R, C], or null to run the
// LN here.  GELU: as mlp_wgmma_kernel's.
template <int BN, int TM, int GELU, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_block_kernel(const XT* __restrict__ x, const int8_t* __restrict__ ln_in,
                 const float* __restrict__ ln_bias,
                 const float* __restrict__ m_ln, const int8_t* __restrict__ w1t,
                 const int32_t* __restrict__ b1, const float* __restrict__ m1,
                 const int8_t* __restrict__ w2t, const int32_t* __restrict__ b2,
                 const float* __restrict__ m2, MlpScalars sp,
                 const int8_t* __restrict__ gelu_table, void* __restrict__ out,
                 int R, int C, int Hd, int mlp_bits, int out_bits, int o16,
                 int ln_kind, int fast_poly) {
  constexpr int NT = GemmShape<BN, TM>::NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C), ldg = tile_ld(Hd);
  int8_t* As = smem;
  int8_t* Gs = As + TM * lda;
  int8_t* Bs = Gs + TM * ldg;
  const float m_gelu = __ldg(sp.m_gelu), m_res_x = __ldg(sp.m_res_x);
  const float m_res_id = __ldg(sp.m_res_id);
  const LnShift ln = ln_shift_of(sp.ln_shift);
  const int r0 = blockIdx.x * TM;
  GeluConsts gc{};
  if (GELU == kGeluIbert) {
    gc = gelu_consts_of(__ldg(sp.s_gelu));
    // pinned before the LN: their divides' slow-path calls then run while
    // little is live, not among fc1's accumulators
    asm volatile("" : "+f"(gc.b), "+f"(gc.c), "+f"(gc.shift));
  }

  ln_tile<TM>(x, ln_in, R, C, r0, ln_kind, ln_bias, m_ln, ln.pw, ln.inv_pw,
              As, lda);

  int acc[NT][4];
  for (int n0 = 0; n0 < Hd; n0 += BN) {
    gemm_tile<BN, TM>(As, lda, w1t, C, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row = tile_row<TM>(e), col = n0 + tile_col<BN, TM>(j, e);
        float h = requant(__int2float_rn(acc[j][e] + __ldg(b1 + col)),
                          __ldg(m1 + col), 128.f);
        if (GELU == kGeluIbert)
          h = requant(ibert_gelu(h, gc.b, gc.c, gc.shift, fast_poly), m_gelu,
                      128.f);
        else if (GELU == kGeluTable)
          h = (float)__ldg(gelu_table + (int)h + 128);
        Gs[row * ldg + col] = (int8_t)(int)h;
      }
  }
  if (GELU == kGeluShift) {
    __syncthreads();  // the whole hidden tile is written
    // the weight stage, free until fc2, holds each warp's row table
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int8_t* tab = Bs + warp * 256;
    for (int rr = 0; rr < TM / 8; ++rr) {
      int8_t* g = Gs + (warp * (TM / 8) + rr) * ldg;
      shift_gelu_row(g, g, Hd, tab, gelu_table, lane);
    }
  }

  // fc2 requants into its own mlp_bits container before the residual's
  // out_bits clip (block.py:766-775; on Swin 8 and 16)
  const float lim_mlp = bits_lim(mlp_bits), lim_out = bits_lim(out_bits);
  for (int n0 = 0; n0 < C; n0 += BN) {
    gemm_tile<BN, TM>(Gs, ldg, w2t, Hd, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int gr = r0 + tile_row<TM>(e), col = n0 + tile_col<BN, TM>(j, e);
        if (gr >= R) continue;
        float y2 = requant(__int2float_rn(acc[j][e] + __ldg(b2 + col)),
                           __ldg(m2 + col), lim_mlp);
        size_t idx = (size_t)gr * C + col;
        float o = rintf(y2 * m_res_x) + rintf((float)x[idx] * m_res_id);
        const int v = (int)clampf(o, -lim_out, lim_out - 1.f);
        if (o16)
          static_cast<int16_t*>(out)[idx] = (int16_t)v;
        else
          static_cast<int8_t*>(out)[idx] = (int8_t)v;
      }
  }
}

// Shared memory of one mlp_block_kernel block: the LN tile, the hidden
// tile, the weight stage (which holds the warps' ShiftGELU row tables
// between fc1 and fc2).
constexpr size_t mlp_smem(int TM, int BN, int C, int Hd) {
  return (size_t)TM * (tile_ld(C) + tile_ld(Hd)) + gemm_stage_bytes(BN);
}

constexpr int kFallbackRows = 32;  // mlp_block_kernel's rows a block

template <int BN, int GELU, typename XT>
int launch_mlp(const void* x, const int8_t* ln_in, const float* ln_bias,
               const float* m_ln, const int8_t* w1t, const int32_t* b1,
               const float* m1, const int8_t* w2t, const int32_t* b2,
               const float* m2, MlpScalars sp, const int8_t* gelu_table,
               void* out, int R, int C, int Hd, int mlp_bits, int out_bits,
               int o16, int ln_kind, int fast_poly, cudaStream_t stream) {
  constexpr int TM = kFallbackRows;
  const size_t smem = mlp_smem(TM, BN, C, Hd);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel<BN, TM, GELU, XT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + TM - 1) / TM);
  mlp_block_kernel<BN, TM, GELU, XT><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), ln_in, ln_bias, m_ln, w1t, b1, m1, w2t, b2,
      m2, sp, gelu_table, out, R, C, Hd, mlp_bits, out_bits, o16, ln_kind,
      fast_poly);
  return (int)cudaGetLastError();
}

template <int BN, int GELU>
int launch_mlp_wgmma(const void* x, const int8_t* ln_in, const float* ln_bias,
                     const float* m_ln, const int8_t* w1t, const int32_t* b1,
                     const float* m1, const int8_t* w2t, const int32_t* b2,
                     const float* m2, MlpScalars sp, const int8_t* gelu_table,
                     void* out, int R, int C, int Hd, int mlp_bits,
                     int out_bits, int x16, int o16, int ln_kind,
                     int fast_poly, cudaStream_t stream) {
  const size_t smem = mlp_wg_smem(C, Hd, BN, GELU == kGeluShift);
  CUtensorMap map1, map2;
  cudaError_t err;
  if ((err = weight_map(&map1, w1t, Hd, C, BN)) != cudaSuccess ||
      (err = weight_map(&map2, w2t, C, Hd, BN)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(mlp_wgmma_kernel<BN, GELU>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid((R + kGemmRows - 1) / kGemmRows);
  mlp_wgmma_kernel<BN, GELU><<<grid, kGemmThreads, smem, stream>>>(
      map1, map2, x, ln_in, ln_bias, m_ln, b1, m1, b2, m2, sp, gelu_table, out,
      R, C, Hd, mlp_bits, out_bits, x16, o16, ln_kind, fast_poly);
  return (int)cudaGetLastError();
}

// The launcher of one pass width, for the GELU family and the stream types
// picked at run time: mlp_wgmma_kernel where its tiles fit (rows64), else
// mlp_block_kernel.
template <int BN, int GELU>
int launch_mlp_rows(bool rows64, bool x16, bool o16, const void* x,
                    const int8_t* ln_in, const float* ln_bias,
                    const float* m_ln, const int8_t* w1t, const int32_t* b1,
                    const float* m1, const int8_t* w2t, const int32_t* b2,
                    const float* m2, MlpScalars sp, const int8_t* gelu_table,
                    void* out, int R, int C, int Hd, int mlp_bits,
                    int out_bits, int ln_kind, int fast_poly,
                    cudaStream_t stream) {
  if (rows64)
    return launch_mlp_wgmma<BN, GELU>(x, ln_in, ln_bias, m_ln, w1t, b1, m1,
                                      w2t, b2, m2, sp, gelu_table, out, R, C,
                                      Hd, mlp_bits, out_bits, x16, o16,
                                      ln_kind, fast_poly, stream);
  return (x16 ? launch_mlp<BN, GELU, int16_t> : launch_mlp<BN, GELU, int8_t>)(
      x, ln_in, ln_bias, m_ln, w1t, b1, m1, w2t, b2, m2, sp, gelu_table, out,
      R, C, Hd, mlp_bits, out_bits, o16, ln_kind, fast_poly, stream);
}

template <int BN>
int launch_mlp_any(bool rows64, int gelu, bool x16, bool o16, const void* x,
                   const int8_t* ln_in, const float* ln_bias,
                   const float* m_ln, const int8_t* w1t, const int32_t* b1,
                   const float* m1, const int8_t* w2t, const int32_t* b2,
                   const float* m2, MlpScalars sp, const int8_t* gelu_table,
                   void* out, int R, int C, int Hd, int mlp_bits,
                   int out_bits, int ln_kind, int fast_poly,
                   cudaStream_t stream) {
  auto launch = gelu == kGeluShift   ? launch_mlp_rows<BN, kGeluShift>
               : gelu == kGeluTable ? launch_mlp_rows<BN, kGeluTable>
                                    : launch_mlp_rows<BN, kGeluIbert>;
  return launch(rows64, x16, o16, x, ln_in, ln_bias, m_ln, w1t, b1, m1, w2t,
                b2, m2, sp, gelu_table, out, R, C, Hd, mlp_bits, out_bits,
                ln_kind, fast_poly, stream);
}

constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

}  // namespace ivit

// Pointers in the wrapper's argument order; ln_in may be null (LN in the
// kernel); ln_shift, s_gelu, m_gelu, m_res_x and m_res_id point at one f32
// each.  x16: x is int16 (else int8); out is int16 where out_bits > 8 (else
// int8).  ln_kind: the LayerNorm (0 ibert, 1 ivit, 2 ibert with I-BERT's
// integer sqrt); gelu the GELU (0 ibert, 1 ShiftGELU, 2 ppoly).
// gelu_table: scratch for the GELU's table, whose launch runs first:
// 65,536 bytes for ShiftGELU, 256 for the ppoly GELU, whose fitted table
// pp describes (host memory; null for the other GELUs), and for the ibert
// GELU's table form; unused by the ibert GELU's tower.  gelu_lut: the
// spec's freeze-time GELU table (256 f32 on the card), or null for the
// towers; with it pp is not read.  C % 32 == 0, C <= 1024, C and Hd share a
// pass width of 128, 96 or 64 columns (ivit::pass_width), the 32-row
// block's tiles fit, and a ppoly table within ppoly.cuh's limits; else
// cudaErrorInvalidValue.
extern "C" int ivit_mlp_block(const void* x, const int8_t* ln_in,
                              const float* ln_bias, const float* m_ln,
                              const float* ln_shift, const int8_t* w1t,
                              const int32_t* b1, const float* m1,
                              const float* s_gelu, const float* m_gelu,
                              const int8_t* w2t, const int32_t* b2,
                              const float* m2, const float* m_res_x,
                              const float* m_res_id, void* out, int R, int C,
                              int Hd, int mlp_bits, int out_bits, int x16,
                              int ln_kind, int gelu, int fast_exp,
                              int fast_poly, int8_t* gelu_table,
                              const ivit::PpolyArgs* pp, const float* gelu_lut,
                              cudaStream_t stream) {
  using namespace ivit;
  const MlpScalars sp{ln_shift, s_gelu, m_gelu, m_res_x, m_res_id};
  const int bn = pass_width(C, Hd);
  if (C % 32 || C > 32 * kMaxLnVals || bn == 0 ||
      mlp_smem(kFallbackRows, bn, C, Hd) > kMaxSmem || gelu < 0 || gelu > 2 ||
      mlp_bits < 2 || mlp_bits > 16 || out_bits < 2 || out_bits > 16 ||
      ln_kind < 0 || ln_kind > 2 ||
      (gelu == kGeluPpoly && gelu_lut == nullptr && !ppoly_args_ok(pp, true)) ||
      ((gelu != kGeluIbert || gelu_lut != nullptr) && gelu_table == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaError_t err = cudaSuccess;
  if (gelu == kGeluShift) {
    err = launch_shift_gelu_table(s_gelu, m_gelu, 8, (int)kShiftGeluN, 8,
                                  fast_exp, gelu_table, stream, gelu_lut);
  } else if (gelu_lut != nullptr) {
    gelu_lut_table_kernel<<<1, 256, 0, stream>>>(gelu_lut, gelu == kGeluIbert,
                                                 m_gelu, gelu_table);
    err = cudaGetLastError();
    gelu = kGeluTable;
  } else if (gelu == kGeluPpoly) {
    err = launch_ppoly_table(*pp, true, m_gelu, gelu_table, stream);
  }
  if (err != cudaSuccess) return (int)err;
  // the 64-row wgmma block where its tiles fit (DeiT-S, Swin-T stages 0-2),
  // the 32-row block otherwise (hidden 3072 at C 768, 4096 at C 1024)
  const bool rows64 = mlp_wg_smem(C, Hd, bn, gelu == kGeluShift) <= kMaxSmem;
  auto launch = bn == 128 ? launch_mlp_any<128>
              : bn == 96  ? launch_mlp_any<96>
                          : launch_mlp_any<64>;
  return launch(rows64, gelu, x16, out_bits > 8, x, ln_in, ln_bias, m_ln, w1t,
                b1, m1, w2t, b2, m2, sp, gelu_table, out, R, C, Hd, mlp_bits,
                out_bits, ln_kind, fast_poly, stream);
}
