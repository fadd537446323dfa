// The ppoly family's piecewise polynomial on the card, shared by the three
// block kernels (mlp_block.cu, and the attention cores of attn_chain.cuh):
//   * ppoly_eval, the in-kernel eval_piecewise_poly of
//     ivit_tpu/ops/pallas/block.py _ppoly_eval: the segment by a select
//     chain over the internal bounds (segment s covers bounds[s-1] <= x <
//     bounds[s]), so every element takes exactly coeffs[seg_idx], then
//     Horner highest power first, each step an f32 multiply then an f32
//     add (__fmul_rn / __fadd_rn, never an FMA);
//   * ppoly_table_kernel, one launch of 256 threads before the kernel that
//     looks its table up.  Both ppoly nonlinearities see only 256 inputs:
//     the GELU input is the int8 fc1 requant, so the GELU table holds
//     requant(GELU(x)) of every int8 x (block.py _mlp_kernel :732-753, the
//     fast-div form or the rdiv form); a softmax row of int8 scores has
//     offsets x - max + 127 in [-128, 127], so the exp table holds
//     floor(max(poly(127 - d), 0) * 2**-(31 - exp_bits)) of every d = max -
//     x in [0, 255] (block.py _ppoly_softmax).  The table entries are the
//     reference's arithmetic on the same values, so a lookup gives its bits;
//     the polynomial runs 256 times a call instead of once an element.
//   * ppoly_exp, one softmax element: the table where its offset lies in
//     the table, else ppoly_eval on the element (Swin's shift mask drives
//     scores far below the int8 range, where the polynomial extrapolates,
//     floored at 0 and unbounded above).
// The fitted bounds and coefficients stay where the spec holds them on the
// card (bounds int32 [seg - 1], coefficients f32 [seg, deg + 1]).
#pragma once

#include "exact.cuh"

namespace ivit {

constexpr int kPpolyMaxSeg = 64;      // segments a table may have
constexpr int kPpolyMaxDeg = 8;       // its degree
constexpr int kPpolyMaxPatches = 8;   // fast-div patches (freeze.py:179)

// A fitted table's device leaves and the constants of its epilogue, as the
// wrappers hand them over (ops/kernels/block.py _PpolyArgs).  GELU: s_out,
// and with fastdiv s_out_c and npatch patches (patch_h, patch_d); softmax:
// exp_bits.  bounds is null for one segment.
struct PpolyArgs {
  const int32_t* bounds;
  const float *coeffs, *s_out, *s_out_c, *patch_h, *patch_d;
  int seg, deg, scale_bits, fastdiv, npatch, exp_bits;
};

__host__ inline bool ppoly_args_ok(const PpolyArgs* pp, bool gelu) {
  return pp != nullptr && pp->coeffs != nullptr && pp->seg >= 1 &&
         pp->seg <= kPpolyMaxSeg && pp->deg >= 0 && pp->deg <= kPpolyMaxDeg &&
         (pp->seg == 1 || pp->bounds != nullptr) &&
         (gelu ? pp->s_out != nullptr &&
                     (!pp->fastdiv ||
                      (pp->s_out_c != nullptr && pp->npatch >= 0 &&
                       pp->npatch <= kPpolyMaxPatches &&
                       (pp->npatch == 0 ||
                        (pp->patch_h != nullptr && pp->patch_d != nullptr))))
               : pp->exp_bits >= 1 && pp->exp_bits <= 30);
}

// The piecewise polynomial at the f32-held integer x.  The select chain
// runs four bounds an iteration, so that their loads are in flight together
// (a masked Swin score takes this path per element).
__device__ __forceinline__ float ppoly_eval(float x, const PpolyArgs& pp) {
  int s_idx = 0;
#pragma unroll 4
  for (int s = 1; s < pp.seg; ++s)
    s_idx = x >= __int2float_rn(__ldg(pp.bounds + s - 1)) ? s : s_idx;
  const float* c = pp.coeffs + s_idx * (pp.deg + 1);
  float r = __ldg(c);
  for (int k = 1; k <= pp.deg; ++k) r = __fadd_rn(__fmul_rn(r, x), __ldg(c + k));
  return r;
}

// One softmax exp at offset x_off = x - max + 127: clipped at 0, floored
// onto the exp_bits grid.
__device__ __forceinline__ float ppoly_exp_of(float x_off, const PpolyArgs& pp) {
  return floorf(fmaxf(ppoly_eval(x_off, pp), 0.f) * pow2((float)(pp.exp_bits - 31)));
}

// The exp of one score x of a row whose max is xmax: exp_tab[xmax - x]
// where that lies in the table, else the polynomial on the element.
__device__ __forceinline__ float ppoly_exp(float x, float xmax,
                                           const float* __restrict__ exp_tab,
                                           const PpolyArgs& pp) {
  const float d = xmax - x;
  return d <= 255.f ? __ldg(exp_tab + (int)d)
                    : ppoly_exp_of(__fadd_rn(-d, 127.f), pp);
}

// GELU (gelu != 0): int8 table[x + 128] = requant(g(x), m_gelu), g the
// fast-div form floor(poly(x) * s_out_c) plus the patches, or
// floor(rdiv(poly(x) * 2**-scale_bits, s_out)).  Softmax: f32
// table[d] = ppoly_exp_of(127 - d).
__global__ void __launch_bounds__(256)
ppoly_table_kernel(PpolyArgs pp, int gelu, const float* __restrict__ m_gelu,
                   void* __restrict__ table) {
  const int i = threadIdx.x;
  if (!gelu) {
    static_cast<float*>(table)[i] = ppoly_exp_of(__int2float_rn(127 - i), pp);
    return;
  }
  const float h = __int2float_rn(i - 128), y = ppoly_eval(h, pp);
  float g;
  if (pp.fastdiv) {
    g = floorf(__fmul_rn(y, __ldg(pp.s_out_c)));
    for (int j = 0; j < pp.npatch; ++j)
      g = __fadd_rn(g, h == __ldg(pp.patch_h + j) ? __ldg(pp.patch_d + j) : 0.f);
  } else {
    g = floorf(rdiv(__fmul_rn(y, pow2((float)-pp.scale_bits)), __ldg(pp.s_out)));
  }
  static_cast<int8_t*>(table)[i] = (int8_t)(int)requant(g, __ldg(m_gelu), 128.f);
}

// The table launch before a kernel that looks it up, on the same stream.
inline cudaError_t launch_ppoly_table(const PpolyArgs& pp, bool gelu,
                                      const float* m_gelu, void* table,
                                      cudaStream_t stream) {
  ppoly_table_kernel<<<1, 256, 0, stream>>>(pp, gelu ? 1 : 0, m_gelu, table);
  return cudaGetLastError();
}

// The exact row sum of exps e >= 0, each an f32 integer below 2**38, as
// two int32 limbs a lane (hi = floor(e / 2**16) < 2**22, lo = e - 2**16 hi
// < 2**16; 256 of them sum inside int32): the caller reduces both over the
// row and recombines them in 64 bits, rounded to f32 once.  Where JAX's f32
// row sum is exact (every row below 2**24: the fitted specs' exps stay
// under 2**13), it equals that sum in any order.
__device__ __forceinline__ void exp_limb_add(int& hi, int& lo, float e) {
  const float h = floorf(e * 0x1p-16f);
  hi += (int)h;
  lo += (int)__fsub_rn(e, h * 65536.f);
}
__device__ __forceinline__ float exp_limb_total(int hi, int lo) {
  return __ll2float_rn(((long long)hi << 16) + (long long)lo);
}

}  // namespace ivit
