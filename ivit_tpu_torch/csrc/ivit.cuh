// The ivit nonlinearities as device functions, shared by the standalone
// kernels (nonlinear.cu) and the block kernels (mlp_block.cu, attn_block.cu)
// so that the two forms cannot drift apart:
//   * int_exp_shift (ivit_tpu/ops/pallas/nonlinear.py _int_exp_shift),
//     which the standalone Shiftmax kernel tabulates (nonlinear.cu);
//   * shiftmax_quad, the Shiftmax of a row spread over a quad of an mma
//     accumulator tile (the attention cores; block.py _shiftmax);
//   * shift_gelu_table_kernel, the table of ShiftGELU + requant outputs of
//     every (row max, value) pair, and shift_gelu_row, one warp's ShiftGELU
//     + requant of an int8 row in global or shared memory through that
//     table (nonlinear.py _shift_gelu_kernel, block.py _shift_gelu with
//     the requant after it).
// Every f32 rounding happens once, where the reference rounds: s_gelu *
// 1.702 is one multiply, exp + exp_max one add, exp * factor one multiply
// followed by an exact power-of-two scale.  Built with --fmad=false.
#pragma once

#include "exact.cuh"

namespace ivit {

constexpr float kInt32Max = 2147483648.f;  // INT32_MAX rounded to f32
constexpr float kSigmoidK = (float)1.702;  // sigmoid(1.702 x) ~ GELU
constexpr float kShiftmaxN = 15.f;         // the exps' shift budgets n
constexpr float kShiftGeluN = 23.f;

// The scale 2**-(32 - bits) that turns exp * factor (~2**31) into a
// ``bits``-bit probability or sigmoid: 2**-(31 - bits + 1) in the reference.
__device__ __forceinline__ float shift_out_scale(int bits) {
  return pow2((float)(bits - 32));
}

// x0 = floor(-1 / s), the exp's range-reduction step at input scale s.
__device__ __forceinline__ float exp_shift_x0(float s) {
  return floorf(rdiv(-1.f, s));
}

// x0 of ShiftGELU's exp at input scale s_gelu: its scale is s_gelu * 1.702.
__device__ __forceinline__ float shift_gelu_x0(float s_gelu) {
  return exp_shift_x0(__fmul_rn(s_gelu, kSigmoidK));
}

// Shift-based integer exp of the f32-held integer x (nonlinear.py
// _int_exp_shift, after ivit_modules.py:89-103):
// x * log2(e) ~ x + x/2 - x/16, then 2**(n - q) * (r/2 - x0) with q, r the
// quotient and remainder by x0.  fast_q: the divide-free exact quotient.
__device__ __forceinline__ float int_exp_shift(float x, float x0, float n,
                                               int fast_q) {
  x = (x + floorf(x * 0.5f)) - floorf(x * 0.0625f);
  x = fmaxf(x, n * x0);
  const float q = fast_q ? floor_div_int(x, x0) : floorf(rdiv(x, x0));
  const float r = x - x0 * q;
  return fmaxf(floorf((r * 0.5f - x0) * pow2(n - q)), 0.f);
}

// The largest f32 below 2**31: Shiftmax's exp * factor clamped to it floors
// to at most 2**(bits - 1) - 1, the top of the probabilities' container,
// where the reference's f32 -> int conversion saturates (a one-column row
// whose exp is a power of two reaches 2**(bits - 1)).
constexpr float kShiftProductMax = 2147483520.f;

// The column of this lane's i-th value of a row in an mma accumulator tile
// (m16n8, or wgmma's m64nN): 8-column tile i / 2, columns 2t and 2t + 1 of
// it, t = lane % 4.
__device__ __forceinline__ int quad_col(int i, int t) {
  return 8 * (i >> 1) + 2 * t + (i & 1);
}

// floor(n / d) for 0 <= n < 2**32 / d and d >= 2 by a multiply-high with
// magic = div_magic(d) = floor((2**32 - 1) / d) + 1: the product overshoots
// n / d by less than n / 2**32 < 1 / d, short of the next multiple.  The
// exps below divide n <= 30 d with 2 <= d < 2**13.
__device__ __forceinline__ unsigned div_magic(int d) {
  return 0xffffffffu / (unsigned)d + 1u;
}
__device__ __forceinline__ int div_small(int n, unsigned magic) {
  return (int)__umulhi((unsigned)n, magic);
}

// int_exp_shift at n = 15 in int32 for x0 in (-2**13, -1) and an integer
// x <= 0 (clamped at -2**30): every f32 step of int_exp_shift is exact
// there, so this gives its bits in integer instructions alone.  x + x/2 -
// x/16 with floors is x + (x >> 1) - (x >> 4); q = floor(x / x0) <= 15
// (either quotient form is exact at these sizes), rem = -x - q |x0|, r =
// -rem; (r / 2 - x0) 2**(15 - q) = (2 |x0| - rem) 2**(14 - q), floored.
__device__ __forceinline__ int int_exp_shift15(int x, int x0, unsigned magic) {
  x = x + (x >> 1) - (x >> 4);
  x = max(x, 15 * x0);
  const int q = div_small(-x, magic);
  const int m = -2 * x0 + x - x0 * q;  // 2 |x0| - rem
  return q < 15 ? m << (14 - q) : m >> 1;
}

// int_exp_shift at n = 15 out of line, for the f32 path of shiftmax_quad
// (x0 past the int32 path's range) in a tile whose keys several warps
// split, whose exchange state leaves the fewest registers: its registers
// then do not weigh on the int32 path that the engines' scales take.
__device__ __noinline__ float int_exp_shift15_f32(float x, float x0, int fast_q) {
  return int_exp_shift(x, x0, kShiftmaxN, fast_q);
}

// Shiftmax of one row on the accumulator layout: the row held by the four
// lanes of a quad (and, where K warps split the keys, by a quad of each),
// this lane's values v[i] at columns col0 + quad_col(i, t), those of i <
// nv_live computed, the columns >= n_valid padding (kept out of the max,
// probability 0).  In place: v[i] becomes floor(min(exp * factor, 2**31 -
// 128) * out_scale), out_scale = 2**-(32 - bits), factor = floor(2**31 /
// the row's exp sum).  red reduces over the row's lanes: red.max(float),
// red.sum(int).  The row sum is the two-limb exact int32 sum clamped to
// INT32_MAX: a row of N exps sums to up to N * (-x0) * 2**15, past f32's
// exact integers (2**24) for ViT's 197 tokens at any scale below ~0.3.
// The max and the limb sums do not depend on the order of the columns, so
// every value gets the bits of the reference's row Shiftmax (block.py
// _shiftmax), saturated as the standalone kernel stores them
// (kShiftProductMax).  For -2**13 < x0 < -1 the exp runs in int32
// (int_exp_shift15; the limbs of an int e >= 0 are e >> 8 and e & 255),
// else in f32 as int_exp_shift.
template <int NV, class Red>
__device__ __forceinline__ void shiftmax_quad(float (&v)[NV], int nv_live,
                                              int t, int col0, int n_valid,
                                              float x0, float out_scale,
                                              int fast_q, Red& red) {
  float vmax = -8388608.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < nv_live && col0 + quad_col(i, t) < n_valid) vmax = fmaxf(vmax, v[i]);
  vmax = red.max(vmax);
  int sh = 0, sl = 0;
  if (x0 > -8192.f && x0 < -1.f) {
    const int x0i = (int)x0;
    const unsigned magic = div_magic(-x0i);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      int e = 0;
      if (i < nv_live && col0 + quad_col(i, t) < n_valid) {
        e = int_exp_shift15(__float2int_rn(fmaxf(v[i] - vmax, -1073741824.f)),
                            x0i, magic);
        sh += e >> 8;
        sl += e & 255;
      }
      v[i] = __int2float_rn(e);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float e = 0.f;
      if (i < nv_live && col0 + quad_col(i, t) < n_valid) {
        e = Red::kParts > 1 ? int_exp_shift15_f32(v[i] - vmax, x0, fast_q)
                            : int_exp_shift(v[i] - vmax, x0, kShiftmaxN, fast_q);
        limb_add(sh, sl, e);
      }
      v[i] = e;
    }
  }
  sh = red.sum(sh);
  sl = red.sum(sl);
  const float total = __fadd_rn(__fmul_rn(__int2float_rn(sh), 256.f),
                                __int2float_rn(sl));
  const float factor = floorf(rdiv(kInt32Max, fminf(total, kInt32Max)));
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = floorf(fminf(__fmul_rn(v[i], factor), kShiftProductMax) * out_scale);
}

// ShiftGELU + requant as a table.  The output of an element depends only
// on the element x (int8) and its row's max xmax (block.py _shift_gelu_lut
// makes the same observation): its exp is int_exp_shift(x - xmax), a
// function of d = xmax - x in [0, 255] alone, and exp_max =
// int_exp_shift(-xmax) is constant along the row.  An int8 xmax takes 256
// values, so one small launch (shift_gelu_table_kernel) computes the
// outputs requant(x * sigmoid) of every (xmax, x <= xmax) pair, 65,536
// entries, with the reference's operations on the same values; each row
// then copies its xmax's 256 bytes into shared memory and each element is
// one lookup.  The divide chain runs once a table entry a call instead of
// once an element.
// The table is [xmax + 128][x + 128], 65,536 bytes.  One block of 256
// threads a row max xmax = blockIdx.x - 128: the exps
// int_exp_shift(-d), d = 0 .. 255, then the entries x = -128 .. xmax of
// table[xmax + 128], x * floor(exp * factor * sig_scale) with factor =
// floor(2**31 / (exp + exp_max)), requantized by m_out to [-lim, lim - 1].
// Entries past xmax are never looked up and stay unwritten.  exp_lut: a
// spec's freeze-time exp table (luts.shift_gelu_exp_lut, 256 f32, T[d] =
// int_exp_shift(-d)), whose entries replace the exps (block.py
// _shift_gelu_lut: the same per-row sigmoid from the table), or null.
__global__ void __launch_bounds__(256)
shift_gelu_table_kernel(const float* __restrict__ s_gelu,
                        const float* __restrict__ m_out, int output_bit,
                        int n, int out_bits, int fast_q,
                        int8_t* __restrict__ table,
                        const float* __restrict__ exp_lut) {
  __shared__ float exps[256];
  const float x0 = shift_gelu_x0(__ldg(s_gelu)), nf = (float)n;
  const int d = threadIdx.x, xmax = (int)blockIdx.x - 128;
  exps[d] = exp_lut != nullptr ? __ldg(exp_lut + d)
                               : int_exp_shift(__int2float_rn(-d), x0, nf, fast_q);
  __syncthreads();
  const int x = d - 128;
  if (x > xmax) return;
  const float exp_max = int_exp_shift(__int2float_rn(-xmax), x0, nf, fast_q);
  const float e = exps[xmax - x];
  const float sum = fminf(__fadd_rn(e, exp_max), kInt32Max);
  const float factor = floorf(rdiv(kInt32Max, sum));
  const float y = __int2float_rn(x) *
                  floorf(__fmul_rn(e, factor) * shift_out_scale(output_bit));
  table[blockIdx.x * 256 + d] =
      (int8_t)(int)requant(y, __ldg(m_out), bits_lim(out_bits));
}

// The table launch before a kernel that looks it up, on the same stream.
inline cudaError_t launch_shift_gelu_table(const float* s_gelu,
                                           const float* m_out, int output_bit,
                                           int n, int out_bits, int fast_q,
                                           int8_t* table, cudaStream_t stream,
                                           const float* exp_lut = nullptr) {
  shift_gelu_table_kernel<<<256, 256, 0, stream>>>(s_gelu, m_out, output_bit, n,
                                                   out_bits, fast_q, table,
                                                   exp_lut);
  return cudaGetLastError();
}

// The four int8 values of a word through a row's table.
__device__ __forceinline__ uint32_t gelu_lookup4(const int8_t* tab,
                                                 uint32_t w) {
  uint32_t o = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    o |= (uint32_t)(uint8_t)tab[((w >> (8 * d)) & 255) ^ 128] << (8 * d);
  return o;
}

__device__ __forceinline__ int4 gelu_lookup16(const int8_t* tab, int4 v) {
  return make_int4((int)gelu_lookup4(tab, (uint32_t)v.x),
                   (int)gelu_lookup4(tab, (uint32_t)v.y),
                   (int)gelu_lookup4(tab, (uint32_t)v.z),
                   (int)gelu_lookup4(tab, (uint32_t)v.w));
}

// The max of the four signed bytes of a word and of m.
__device__ __forceinline__ int max_s8x4(int m, uint32_t w) {
#pragma unroll
  for (int d = 0; d < 4; ++d) m = max(m, (int)(int8_t)(w >> (8 * d)));
  return m;
}

__device__ __forceinline__ int warp_max_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp: the 256-byte table of row max xmax into tab (shared memory this
// warp owns), 8 bytes a lane.
__device__ __forceinline__ void copy_gelu_row_table(int8_t* tab,
                                                    const int8_t* table,
                                                    int xmax, int lane) {
  reinterpret_cast<int2*>(tab)[lane] =
      __ldg(reinterpret_cast<const int2*>(table + (xmax + 128) * 256) + lane);
  __syncwarp();
}

// One warp: ShiftGELU + requant of one int8 row of H through the launch's
// table (shift_gelu_table_kernel) and tab, 256 bytes of shared memory this
// warp owns.  The row is read twice: for its max, then for the lookups
// (out may be in: each lane rewrites only what it read); rows of whole
// 4-byte words a word per lane.
__device__ __forceinline__ void shift_gelu_row(const int8_t* in, int8_t* out,
                                               int H, int8_t* tab,
                                               const int8_t* table, int lane) {
  const bool words =
      (H & 3) == 0 && ((reinterpret_cast<uintptr_t>(in) |
                        reinterpret_cast<uintptr_t>(out)) & 3) == 0;
  const uint32_t* in4 = reinterpret_cast<const uint32_t*>(in);
  int xmax = -128;
  if (words) {
    for (int w = lane; w < (H >> 2); w += 32) xmax = max_s8x4(xmax, in4[w]);
  } else {
    for (int c = lane; c < H; c += 32) xmax = max(xmax, (int)in[c]);
  }
  copy_gelu_row_table(tab, table, warp_max_int(xmax), lane);
  if (words) {
    uint32_t* out4 = reinterpret_cast<uint32_t*>(out);
    for (int w = lane; w < (H >> 2); w += 32) out4[w] = gelu_lookup4(tab, in4[w]);
  } else {
    for (int c = lane; c < H; c += 32) out[c] = tab[(uint8_t)in[c] ^ 128];
  }
  __syncwarp();  // the table may be replaced for the warp's next row
}

}  // namespace ivit
