// Fused MLP half-block, ivit and ibert families, for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::mlp_block_p (body _mlp_kernel):
//   LN (I-LayerNorm or ibert LN; or the hoisted int8 ln_in) -> int8
//   requant -> fc1 + bias -> requant -> GELU (ShiftGELU or ibert GELU) ->
//   requant -> fc2 + bias -> requant to mlp_bits -> integer residual
//   clip(round(y * m_res_x) + round(x * m_res_id)).
//
// The token stream is int8 (ViT) or int16 (Swin: int16 in, fc2 requant to
// 8 bits, residual and output at 16 bits), read and written as it is.
//
// Bound on this card: operations.  At DeiT-S (R = 256 * 197 rows, C 384,
// hidden 1536) one launch does 2 * R * C * hidden * 2 = 119 G int8 ops
// (~60 us at 1,979 TOPS) and moves ~40 MB (~12 us at 3.35 TB/s); Swin-T's
// four stages at batch 64 do 2 * R * C * 4C * 2 = 59-118 G ops a launch.
//
// Design: one block of 256 threads per 64 token rows, everything between
// the input read and the output write kept in shared memory:
//   * 8 warps run the row LayerNorms into an int8 [64, C] tile;
//   * fc1 sweeps the hidden dim in passes of 128 columns (96 or 64 where
//     the widths are not multiples of 128: Swin-T's C = 96 and 192) with
//     mma.sync m16n8k32 s8 tensor-core products; the epilogue applies bias
//     and requant and writes the int8 [64, hidden] hidden tile (96 KB at
//     DeiT-S, dynamic shared memory), with the ibert GELU and its requant
//     applied per element on the way;
//   * ShiftGELU needs its row's max over all hidden columns first, so for
//     it the tile is stored as requanted, and then each warp runs whole
//     rows of it in place (ivit.cuh shift_gelu_row: max, exp, sigmoid,
//     x * sigmoid, requant by m_gelu), the standalone kernel's row code;
//   * fc2 sweeps C the same way and its epilogue writes the residual output.
// Where the [64, hidden] tile does not fit beside the LN tile and the
// weight ring (Swin-T stage 3: hidden 3072, 197 KB), a block takes 32 rows
// and its 8 warps split the output columns four ways instead of two, so
// every hidden row stays whole in shared memory for ShiftGELU.
// The wrapper hands the weights over transposed ([out, in], torch's Linear
// layout), so each 64-deep weight slice (32-deep in the 96-column passes)
// streams into shared memory with 16-byte cp.async copies, double-buffered
// against the tensor-core work.  C need not be a multiple of the TPU's 128 lanes: the
// port runs Swin's C = 96 and 192 as they are, with no c_valid padding.
// The LN shift and the GELU constants are derived in every thread from the
// spec's scalar leaves, with the plain version's rdiv, so a call costs the
// host no arithmetic launches of its own.
// wgmma and a deeper pipeline are the next steps for speed.

#include "ivit.cuh"

namespace ivit {

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

// w1t: fc1 weight transposed, [Hd, C]; w2t: fc2 weight transposed, [C, Hd].
// x and out: [R, C] of XT, int8 (ViT) or int16 (Swin).
// ln_in: the hoisted LN output [R, C], or null to run the LN here.
// TM token rows per block; SHIFT_GELU: ShiftGELU (ivit), else the ibert GELU.
template <int BN, int TM, bool SHIFT_GELU, typename XT>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const XT* __restrict__ x, const int8_t* __restrict__ ln_in,
                 const float* __restrict__ ln_bias,
                 const float* __restrict__ m_ln, const int8_t* __restrict__ w1t,
                 const int32_t* __restrict__ b1, const float* __restrict__ m1,
                 const int8_t* __restrict__ w2t, const int32_t* __restrict__ b2,
                 const float* __restrict__ m2, MlpScalars sp,
                 XT* __restrict__ out, int R, int C, int Hd, int mlp_bits,
                 int out_bits, int ln_ivit, int fast_exp, int fast_poly) {
  constexpr int NT = GemmShape<BN, TM>::NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C), ldg = tile_ld(Hd);
  int8_t* As = smem;
  int8_t* Gs = As + TM * lda;
  int8_t* Bs = Gs + TM * ldg;
  const float m_gelu = __ldg(sp.m_gelu), m_res_x = __ldg(sp.m_res_x);
  const float m_res_id = __ldg(sp.m_res_id);
  const LnShift ln = ln_shift_of(sp.ln_shift);
  const float s_gelu = __ldg(sp.s_gelu);
  const int r0 = blockIdx.x * TM;

  ln_tile<TM>(x, ln_in, R, C, r0, ln_ivit, ln_bias, m_ln, ln.pw, ln.inv_pw,
              As, lda);

  GeluConsts gc{};
  if (!SHIFT_GELU) gc = gelu_consts_of(s_gelu);
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
        if (!SHIFT_GELU)
          h = requant(ibert_gelu(h, gc.b, gc.c, gc.shift, fast_poly), m_gelu,
                      128.f);
        Gs[row * ldg + col] = (int8_t)(int)h;
      }
  }
  if (SHIFT_GELU) {
    __syncthreads();  // the whole hidden tile is written
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float x0 = shift_gelu_x0(s_gelu);
    for (int rr = 0; rr < TM / 8; ++rr) {
      int8_t* g = Gs + (warp * (TM / 8) + rr) * ldg;
      shift_gelu_row(g, g, Hd, x0, kShiftGeluN, shift_out_scale(8), m_gelu,
                     128.f, fast_exp, lane);
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
        out[idx] = (XT)(int)clampf(o, -lim_out, lim_out - 1.f);
      }
  }
}

// Shared memory of one block: the LN tile, the hidden tile, the weight ring.
constexpr size_t mlp_smem(int TM, int BN, int C, int Hd) {
  return (size_t)TM * (tile_ld(C) + tile_ld(Hd)) + gemm_stage_bytes(BN);
}

template <int BN, int TM, bool SHIFT_GELU, typename XT>
int launch_mlp(const void* x, const int8_t* ln_in, const float* ln_bias,
               const float* m_ln, const int8_t* w1t, const int32_t* b1,
               const float* m1, const int8_t* w2t, const int32_t* b2,
               const float* m2, MlpScalars sp, void* out, int R, int C,
               int Hd, int mlp_bits, int out_bits, int ln_ivit, int fast_exp,
               int fast_poly, cudaStream_t stream) {
  const size_t smem = mlp_smem(TM, BN, C, Hd);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel<BN, TM, SHIFT_GELU, XT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + TM - 1) / TM);
  mlp_block_kernel<BN, TM, SHIFT_GELU, XT><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), ln_in, ln_bias, m_ln, w1t, b1, m1, w2t, b2,
      m2, sp, static_cast<XT*>(out), R, C, Hd, mlp_bits, out_bits, ln_ivit,
      fast_exp, fast_poly);
  return (int)cudaGetLastError();
}

// The launcher of one pass width and row tile, for the GELU family and the
// stream type picked at run time.
template <int BN, int TM>
int launch_mlp_any(bool gelu_ivit, bool x16, const void* x,
                   const int8_t* ln_in, const float* ln_bias,
                   const float* m_ln, const int8_t* w1t, const int32_t* b1,
                   const float* m1, const int8_t* w2t, const int32_t* b2,
                   const float* m2, MlpScalars sp, void* out, int R, int C,
                   int Hd, int mlp_bits, int out_bits, int ln_ivit,
                   int fast_exp, int fast_poly, cudaStream_t stream) {
  auto launch = gelu_ivit ? (x16 ? launch_mlp<BN, TM, true, int16_t>
                                 : launch_mlp<BN, TM, true, int8_t>)
                          : (x16 ? launch_mlp<BN, TM, false, int16_t>
                                 : launch_mlp<BN, TM, false, int8_t>);
  return launch(x, ln_in, ln_bias, m_ln, w1t, b1, m1, w2t, b2, m2, sp, out, R,
                C, Hd, mlp_bits, out_bits, ln_ivit, fast_exp, fast_poly,
                stream);
}

constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

}  // namespace ivit

// Pointers in the wrapper's argument order; ln_in may be null (LN in the
// kernel); ln_shift, s_gelu, m_gelu, m_res_x and m_res_id point at one f32
// each.  x16: x and out are int16 (else int8).  ln_ivit / gelu_ivit pick
// the ivit LN / GELU over the ibert ones.  C % 32 == 0,
// C <= 1024, and C and Hd share a pass width of 128, 96 or 64 columns
// (ivit::pass_width); else cudaErrorInvalidValue.
extern "C" int ivit_mlp_block(const void* x, const int8_t* ln_in,
                              const float* ln_bias, const float* m_ln,
                              const float* ln_shift, const int8_t* w1t,
                              const int32_t* b1, const float* m1,
                              const float* s_gelu, const float* m_gelu,
                              const int8_t* w2t, const int32_t* b2,
                              const float* m2, const float* m_res_x,
                              const float* m_res_id, void* out, int R, int C,
                              int Hd, int mlp_bits, int out_bits, int x16,
                              int ln_ivit, int gelu_ivit, int fast_exp,
                              int fast_poly, cudaStream_t stream) {
  using namespace ivit;
  const MlpScalars sp{ln_shift, s_gelu, m_gelu, m_res_x, m_res_id};
  const int bn = pass_width(C, Hd);
  if (C % 32 || C > 32 * kMaxLnVals || bn == 0)
    return (int)cudaErrorInvalidValue;
  // 64 token rows per block where the hidden tile leaves the room (DeiT-S,
  // Swin-T stages 0-2), 32 otherwise (Swin-T stage 3: hidden 3072)
  const bool rows64 = mlp_smem(64, bn, C, Hd) <= kMaxSmem;
  if (!rows64 && mlp_smem(32, bn, C, Hd) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto launch = bn == 128 ? (rows64 ? launch_mlp_any<128, 64>
                                    : launch_mlp_any<128, 32>)
              : bn == 96  ? (rows64 ? launch_mlp_any<96, 64>
                                    : launch_mlp_any<96, 32>)
                          : (rows64 ? launch_mlp_any<64, 64>
                                    : launch_mlp_any<64, 32>);
  return launch(gelu_ivit, x16, x, ln_in, ln_bias, m_ln, w1t, b1, m1, w2t, b2,
                m2, sp, out, R, C, Hd, mlp_bits, out_bits, ln_ivit, fast_exp,
                fast_poly, stream);
}
