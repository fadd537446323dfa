// Fused MLP half-block, ibert family, for sm_90a.
//
// Replaces ivit_tpu/ops/pallas/block.py::mlp_block_p (body _mlp_kernel):
//   ibert LN -> int8 requant -> fc1 + bias -> requant -> ibert GELU ->
//   requant -> fc2 + bias -> requant to mlp_bits -> integer residual
//   clip(round(y * m_res_x) + round(x * m_res_id)).
//
// Bound on this card: operations.  At DeiT-S (R = 256 * 197 rows, C 384,
// hidden 1536) one launch does 2 * R * C * hidden * 2 = 119 G int8 ops
// (~60 us at 1,979 TOPS) and moves ~40 MB (~12 us at 3.35 TB/s).
//
// Design: one block of 256 threads per 64 token rows, everything between
// the input read and the output write kept in shared memory:
//   * 8 warps run the row LayerNorms into an int8 [64, C] tile;
//   * fc1 sweeps the hidden dim in 128-column passes (64 where a width is
//     not a multiple of 128) with mma.sync
//     m16n8k32 s8 tensor-core products; the epilogue applies bias, requant,
//     GELU and requant per element and writes the int8 [64, hidden] hidden
//     tile (96 KB at DeiT-S, dynamic shared memory);
//   * fc2 sweeps C the same way and its epilogue writes the residual output.
// The wrapper hands the weights over transposed ([out, in], torch's Linear
// layout), so each 64-deep weight slice streams into shared memory with
// 16-byte cp.async copies, double-buffered against the tensor-core work.
// The LN shift and the GELU constants are derived in every thread from the
// spec's scalar leaves, with the plain version's rdiv, so a call costs the
// host no arithmetic launches of its own.
// wgmma and a deeper pipeline are the next steps for speed.

#include "exact.cuh"

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
template <int BN>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const int8_t* __restrict__ x, const float* __restrict__ ln_bias,
                 const float* __restrict__ m_ln, const int8_t* __restrict__ w1t,
                 const int32_t* __restrict__ b1, const float* __restrict__ m1,
                 const int8_t* __restrict__ w2t, const int32_t* __restrict__ b2,
                 const float* __restrict__ m2, MlpScalars sp,
                 int8_t* __restrict__ out, int R, int C, int Hd, int mlp_bits,
                 int out_bits, int fast_poly) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = tile_ld(C), ldg = tile_ld(Hd);
  int8_t* As = smem;
  int8_t* Gs = As + kTileM * lda;
  int8_t* Bs = Gs + kTileM * ldg;
  const float m_gelu = __ldg(sp.m_gelu), m_res_x = __ldg(sp.m_res_x);
  const float m_res_id = __ldg(sp.m_res_id);
  const LnShift ln = ln_shift_of(sp.ln_shift);
  const GeluConsts gc = gelu_consts_of(__ldg(sp.s_gelu));
  const int r0 = blockIdx.x * kTileM;

  ln_tile_ibert(x, R, C, r0, ln_bias, m_ln, ln.pw, ln.inv_pw, As, lda);

  int acc[BN / 16][4];
  for (int n0 = 0; n0 < Hd; n0 += BN) {
    gemm_tile<BN>(As, lda, w1t, C, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row = tile_row(e), col = n0 + tile_col<BN>(j, e);
        float h = requant(__int2float_rn(acc[j][e] + __ldg(b1 + col)),
                          __ldg(m1 + col), 128.f);
        float g = ibert_gelu(h, gc.b, gc.c, gc.shift, fast_poly);
        Gs[row * ldg + col] = (int8_t)(int)requant(g, m_gelu, 128.f);
      }
  }

  const float lim_mlp = bits_lim(mlp_bits), lim_out = bits_lim(out_bits);
  for (int n0 = 0; n0 < C; n0 += BN) {
    gemm_tile<BN>(Gs, ldg, w2t, Hd, n0, Bs, acc);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int gr = r0 + tile_row(e), col = n0 + tile_col<BN>(j, e);
        if (gr >= R) continue;
        float y2 = requant(__int2float_rn(acc[j][e] + __ldg(b2 + col)),
                           __ldg(m2 + col), lim_mlp);
        size_t idx = (size_t)gr * C + col;
        float o = rintf(y2 * m_res_x) + rintf((float)x[idx] * m_res_id);
        out[idx] = (int8_t)(int)clampf(o, -lim_out, lim_out - 1.f);
      }
  }
}

template <int BN>
int launch_mlp(const int8_t* x, const float* ln_bias, const float* m_ln,
               const int8_t* w1t, const int32_t* b1, const float* m1,
               const int8_t* w2t, const int32_t* b2, const float* m2,
               MlpScalars sp, int8_t* out, int R, int C, int Hd, int mlp_bits,
               int out_bits, int fast_poly, cudaStream_t stream) {
  size_t smem = (size_t)kTileM * (tile_ld(C) + tile_ld(Hd)) + gemm_stage_bytes(BN);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_block_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + kTileM - 1) / kTileM);
  mlp_block_kernel<BN><<<grid, kThreads, smem, stream>>>(
      x, ln_bias, m_ln, w1t, b1, m1, w2t, b2, m2, sp, out, R, C, Hd, mlp_bits,
      out_bits, fast_poly);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// Pointers in the wrapper's argument order; ln_shift, s_gelu, m_gelu,
// m_res_x and m_res_id point at one f32 each.
extern "C" int ivit_mlp_block(const int8_t* x, const float* ln_bias,
                              const float* m_ln, const float* ln_shift,
                              const int8_t* w1t, const int32_t* b1,
                              const float* m1, const float* s_gelu,
                              const float* m_gelu, const int8_t* w2t,
                              const int32_t* b2, const float* m2,
                              const float* m_res_x, const float* m_res_id,
                              int8_t* out, int R, int C, int Hd, int mlp_bits,
                              int out_bits, int fast_poly, cudaStream_t stream) {
  const ivit::MlpScalars sp{ln_shift, s_gelu, m_gelu, m_res_x, m_res_id};
  // 128-column passes where both widths allow (DeiT-S), 64 otherwise
  auto launch = (C % 128 == 0 && Hd % 128 == 0) ? ivit::launch_mlp<128>
                                                : ivit::launch_mlp<64>;
  return launch(x, ln_bias, m_ln, w1t, b1, m1, w2t, b2, m2, sp, out, R, C, Hd,
                mlp_bits, out_bits, fast_poly, stream);
}
