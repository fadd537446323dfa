// The launches that the two attention kernels share (attn_block.cu for ViT,
// swin_attn_block.cu for Swin's windows): each is a chain of three kernels
// on one stream, counted as one,
//   1. ln_qkv_wgmma_kernel: LN + qkv GEMM + requant over flat token rows,
//      on wgmma with TMA-fed weights (wgmma_gemm.cuh);
//   2. a softmax attention core per (head, image) or (window, head) on
//      mma.sync tensor cores, whose 16-query-row tile is attn_tile below;
//   3. proj_wgmma_kernel: proj GEMM + requant + integer residual, on the
//      same wgmma row GEMM.
// The token stream is int8 (ViT) or int16 (Swin), read and written as it
// is; the LN shift and the exp constants are derived in every thread from
// the spec's scalar leaves.
#pragma once

#include "ivit.cuh"
#include "ppoly.cuh"
#include "wgmma_gemm.cuh"

namespace ivit {

// The softmax families of the cores (the wrappers' codes), and the cores
// of the ivit and ibert table forms (a spec's freeze-time sm_lut).
constexpr int kSmIbert = 0, kSmShift = 1, kSmPpoly = 2;
constexpr int kSmShiftLut = 3, kSmIbertLut = 4;

__host__ __device__ constexpr bool is_lut_core(int sm) {
  return sm == kSmShiftLut || sm == kSmIbertLut;
}

// ibert integer exp of x = score - row max (block.py _ibert_int_exp).
__device__ __forceinline__ float ibert_exp(float x, float x0, float b_int,
                                           float c_int, int fast_q,
                                           int fast_poly) {
  x = fmaxf(x, 30.f * x0);
  float q = fast_q ? floor_div_int(x, x0) : floorf(rdiv(x, x0));
  float r = x - x0 * q;
  float z = fast_poly ? r * (r + b_int) + c_int : exact_fma(r, r + b_int, c_int);
  return fmaxf(floorf(z * pow2(30.f - q)), 0.f);
}

// The chain's scalar operands: device pointers to the spec's 0-d f32
// leaves, read by every thread (no wrapper-side arithmetic).  m_attn2 is
// Swin's second score requant (null for ViT).
struct AttnScalars {
  const float *ln_shift, *m_attn, *m_attn2, *s_attn, *s_exp_act, *m_av,
      *m_res_x, *m_res_id;
};

// The exp table a core looks up, a parameter of the cores only:
//   exp_tab: the ppoly softmax's 256 f32, the call's (ppoly_table_kernel
//     writes it before the core runs) or a spec's sm_lut, or the ivit or
//     ibert sm_lut of a table-form core, which copies it into shared
//     memory (tab);
//   pp: the fitted ppoly table, for the scores past exp_tab;
//   sum_i32: the ivit table form's row sum as one int32 reduction (the
//     freeze's sm_sum_i32 gate), else in two limbs clamped to INT32_MAX;
//   sat: a shifted Swin block's exp of a masked score (a spec's sm_sat on
//     the card), taken wherever the shift mask is negative, or null.
struct SoftmaxTable {
  const float* exp_tab;
  PpolyArgs pp;
  int sum_i32;
  const float* sat;
  const float* tab;
};

// Stage a table-form core's exp table in shared memory (256 f32, tid of
// nthr threads); the caller synchronizes before the lookups.
__device__ __forceinline__ void stage_lut(SoftmaxTable& st, float* smem_tab,
                                          int tid, int nthr) {
  for (int i = tid; i < 256; i += nthr) smem_tab[i] = __ldg(st.exp_tab + i);
  st.tab = smem_tab;
}

// ibert exp constants at score scale s_attn, as ibert.int_exp and
// int_polynomial derive them: x0 = floor(-ln2 / s), b_int and c_int.
struct ExpConsts {
  float x0, b, c;
};
__device__ __forceinline__ ExpConsts exp_consts_of(float s) {
  return {floorf(rdiv(kExpX0, s)), floorf(rdiv(kExpB, s)),
          floorf(rdiv(kExpC, __fmul_rn(s, s)))};
}

// The softmax constants of one block: Shiftmax's x0, or the ibert exp's
// constants and the reciprocal of its 16-bit requant scale.
struct SoftmaxConsts {
  float x0, m_exp_act;
  ExpConsts ec;
};
template <int SM>
__device__ __forceinline__ SoftmaxConsts softmax_consts_of(AttnScalars sp) {
  const float s_attn = __ldg(sp.s_attn);
  SoftmaxConsts k{};
  if (SM == kSmShift) {
    k.x0 = exp_shift_x0(s_attn);
  } else if (SM == kSmIbert) {
    k.m_exp_act = rdiv(1.f, __ldg(sp.s_exp_act));
    k.ec = exp_consts_of(s_attn);
  }
  return k;
}

// ibert_exp in int32 for x0 in (-2**13, -1), where the polynomial's terms
// stay below 2**23 (ibert_exp_int_ok): every f32 step of ibert_exp is then
// an exact integer, so this gives its bits.  q = floor(x / x0) <= 30 by
// div_small, r = x - x0 q, z = r (r + b) + c, and 2**(30 - q) z as an
// exact f32 product.
__device__ __forceinline__ bool ibert_exp_int_ok(const ExpConsts& ec) {
  return ec.x0 > -8192.f && ec.x0 < -1.f &&
         fabsf(ec.x0) * (fabsf(ec.x0) + fabsf(ec.b)) + fabsf(ec.c) < 8388608.f;
}
__device__ __forceinline__ float ibert_exp_i32(int x, int x0, unsigned magic,
                                               int b, int c) {
  x = max(x, 30 * x0);
  const int q = div_small(-x, magic), r = x - x0 * q, z = r * (r + b) + c;
  return fmaxf(__int2float_rn(z) * __int_as_float((157 - q) << 23), 0.f);
}

// The scale 2**-(32 - bits + 1) that turns the ibert and ppoly softmaxes'
// exp * factor (<= 2**32) into a ``bits``-bit probability.
__host__ __device__ constexpr float prob_scale(int bits) {
  return 1.f / (float)(1u << (33 - bits));
}

// The largest f32 below 2**32: exp * factor clamped to it floors to at most
// 2**(bits - 1) - 1, so a one-hot row, whose exp * factor rounds to 2**32,
// saturates at its container's top as the reference's f32 -> int
// conversion does, where the probability 2**(bits - 1) would wrap.
constexpr float kProbProductMax = 4294967040.f;

// The ibert softmax (int exp, 16-bit exp requant, 2**32 reciprocal) of one
// row on the accumulator layout, as shiftmax_quad runs Shiftmax: values
// v[i] at columns col0 + quad_col(i, t), those of i < nv_live computed,
// columns >= n_valid padding with probability 0; max and int32 sum by red;
// out_scale = prob_scale(bits), the product saturating at kProbProductMax.
// The exp runs in int32 where
// ibert_exp_int_ok, else in f32.
template <int NV, class Red>
__device__ __forceinline__ void ibert_softmax_quad(float (&v)[NV], int nv_live,
                                                   int t, int col0, int n_valid,
                                                   const SoftmaxConsts& k,
                                                   int fast_q, int fast_poly,
                                                   float out_scale, Red& red) {
  float smax = -8388608.f;  // -2**23, the reference's pad-column fill
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < nv_live && col0 + quad_col(i, t) < n_valid) smax = fmaxf(smax, v[i]);
  smax = red.max(smax);
  int esum = 0;
  auto exp16 = [&](float e, int i) {
    const float e16 = clampf(rintf(e * k.m_exp_act), -32768.f, 32767.f);
    esum += (int)e16;
    v[i] = e16;
  };
  if (ibert_exp_int_ok(k.ec)) {
    const int x0 = (int)k.ec.x0, b = (int)k.ec.b, c = (int)k.ec.c;
    const unsigned magic = div_magic(-x0);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv_live && col0 + quad_col(i, t) < n_valid)
        exp16(ibert_exp_i32(__float2int_rn(fmaxf(v[i] - smax, -1073741824.f)),
                            x0, magic, b, c), i);
      else
        v[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i < nv_live && col0 + quad_col(i, t) < n_valid)
        exp16(ibert_exp(v[i] - smax, k.ec.x0, k.ec.b, k.ec.c, fast_q, fast_poly), i);
      else
        v[i] = 0.f;
    }
  }
  esum = red.sum(esum);
  const float factor = floorf(rdiv(4294967296.f, __int2float_rn(esum)));
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = floorf(fminf(v[i] * factor, kProbProductMax) * out_scale);
}

// The ppoly softmax (block.py _ppoly_softmax) of one row on the
// accumulator layout, as ibert_softmax_quad runs the ibert one: the row max
// over the real columns, each exp from the call's table or, past it, the
// polynomial (ppoly_exp), the exact row sum in two int32 limbs by red
// (exp_limb_add), clamped to >= 1, factor = floor(2**32 / sum), the
// probability floor(exp * factor * out_scale), out_scale = prob_scale(bits),
// the product saturating at kProbProductMax; columns >= n_valid padding with
// probability 0.
template <int NV, class Red>
__device__ __forceinline__ void ppoly_softmax_quad(float (&v)[NV], int nv_live,
                                                   int t, int col0, int n_valid,
                                                   const SoftmaxTable& ps,
                                                   float out_scale, Red& red) {
  float smax = -8388608.f;  // -2**23, the reference's pad-column fill
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < nv_live && col0 + quad_col(i, t) < n_valid) smax = fmaxf(smax, v[i]);
  smax = red.max(smax);
  int hi = 0, lo = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float e = 0.f;
    if (i < nv_live && col0 + quad_col(i, t) < n_valid) {
      e = ppoly_exp(v[i], smax, ps.exp_tab, ps.pp);
      exp_limb_add(hi, lo, e);
    }
    v[i] = e;
  }
  hi = red.sum(hi);
  lo = red.sum(lo);
  const float factor =
      floorf(rdiv(4294967296.f, fmaxf(exp_limb_total(hi, lo), 1.f)));
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = floorf(fminf(__fmul_rn(v[i], factor), kProbProductMax) * out_scale);
}

// The table softmax (block.py _softmax_lut) of one row on the accumulator
// layout, as shiftmax_quad runs Shiftmax: the row max over the real
// columns, each exp tab[clamp(max - x, 0, 255)] from the shared copy of
// the spec's table, or sat where bit i of satb is set (a masked Swin
// score); columns >= n_valid padding with exp 0.  IVIT: the row sum as one
// int32 reduction (sum_i32) or two int32 limbs recombined and clamped to
// INT32_MAX, factor = floor(2**31 / sum), the product saturating at
// kShiftProductMax; else (ibert) an int32 sum, factor = floor(2**32 / sum),
// saturating at kProbProductMax; the probability floor(exp * factor *
// out_scale).  The exps are the table's integers, so every sum is exact
// (the freeze's gate keeps the int32 one below 2**31) in any order.
template <bool IVIT, int NV, class Red>
__device__ __forceinline__ void lut_softmax_quad(float (&v)[NV], int nv_live,
                                                 int t, int col0, int n_valid,
                                                 const SoftmaxTable& st,
                                                 uint32_t satb, float out_scale,
                                                 Red& red) {
  float vmax = -8388608.f;  // -2**23, the reference's pad-column fill
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i < nv_live && col0 + quad_col(i, t) < n_valid) vmax = fmaxf(vmax, v[i]);
  vmax = red.max(vmax);
  const float sat = st.sat != nullptr ? __ldg(st.sat) : 0.f;
  const bool limbs = IVIT && !st.sum_i32;
  int s32 = 0, sl = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float e = 0.f;
    if (i < nv_live && col0 + quad_col(i, t) < n_valid) {
      e = (satb >> i) & 1u ? sat : st.tab[(int)clampf(vmax - v[i], 0.f, 255.f)];
      const int ei = (int)e;
      s32 += limbs ? ei >> 8 : ei;
      sl += ei & 255;
    }
    v[i] = e;
  }
  float total;
  if (limbs) {
    const int sh = red.sum(s32);
    sl = red.sum(sl);
    total = fminf(__fadd_rn(__fmul_rn(__int2float_rn(sh), 256.f), __int2float_rn(sl)),
                  kInt32Max);
  } else {
    total = __int2float_rn(red.sum(s32));
  }
  const float factor = floorf(rdiv(IVIT ? kInt32Max : 4294967296.f, total));
  const float top = IVIT ? kShiftProductMax : kProbProductMax;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = floorf(fminf(__fmul_rn(v[i], factor), top) * out_scale);
}

// Row reductions of an attention tile whose keys one warp holds: over the
// 4 lanes of the row's quad (row: the row in the tile, unused here).
struct QuadReduce {
  static constexpr int kParts = 1;
  int part, row;
  __device__ __forceinline__ float max(float v) { return quad_max(v); }
  __device__ __forceinline__ int sum(int v) { return quad_sum(v); }
};

// The shared memory through which the K warps that split a tile's keys
// exchange their row maxima and sums (two alternating slots of [K warps][16
// rows] words) and their int32 P v partial sums (warps 1 .. K - 1, each
// [channel tiles][4][32 lanes]).
__host__ __device__ constexpr size_t split_xchg_bytes(int K, int dh) {
  return (size_t)2 * K * 16 * 4 +
         (size_t)(K - 1) * (((dh + 31) & ~31) / 8) * 4 * 32 * 4;
}

// ... or over the quads of the row in all K warps of a split (part 0 ..
// K - 1): each quad's value goes through shared memory to the others, and
// every warp combines the K values in the same order-free way (max; exact
// int32 sum).  One named barrier (bar, 32 K threads) an exchange; the
// slots alternate, so a slot is rewritten only after every warp passed the
// barrier of the exchange in between, after its reads.
template <int K>
struct SplitReduce {
  static constexpr int kParts = K;
  int* xch;  // the split's exchange memory (split_xchg_bytes)
  int part, bar, row, slot;
  __device__ __forceinline__ const int* publish(int v) {
    int* b = xch + slot * K * 16;
    if ((threadIdx.x & 3) == 0) b[part * 16 + row] = v;
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(32 * K) : "memory");
    slot ^= 1;
    return b + row;  // part p's value at [16 p]
  }
  __device__ __forceinline__ float max(float v) {
    const int* b = publish(__float_as_int(quad_max(v)));
    float m = __int_as_float(b[0]);
#pragma unroll
    for (int p = 1; p < K; ++p) m = fmaxf(m, __int_as_float(b[16 * p]));
    return m;
  }
  __device__ __forceinline__ int sum(int v) {
    const int* b = publish(quad_sum(v));
    int total = 0;
#pragma unroll
    for (int p = 0; p < K; ++p) total += b[16 * p];
    return total;
  }
};

// One head's keys and values in shared memory, for n tokens of Dh
// channels, both rounded up to 32 (kp, dp) and zero-filled:
//   Ks [kp][kv_ld(Dh)]: key rows, the B operand of q k^T;
//   Vt [dp][kv_ld(n)]:  v transposed, the B operand of p v, with the keys
//       of every 32-key chunk permuted to chunk_slot order, so that the
//       probabilities pack straight from the score accumulators into P's
//       A fragments.
// A row stride of 16 mod 32 bytes puts the 8 rows x 4 words of a fragment
// load in 32 distinct banks.
__host__ __device__ constexpr int kv_ld(int n) { return ((n + 31) & ~31) + 16; }
__host__ __device__ constexpr size_t kv_bytes(int n, int dh) {
  return (size_t)((n + 31) & ~31) * kv_ld(dh) + (size_t)((dh + 31) & ~31) * kv_ld(n);
}

// The slot of key k (0..31) of a chunk in P's m16n8k32 A fragment: a
// lane's score accumulators hold keys 8 (i >> 1) + 2t + (i & 1) of each
// 16-key half, which its A registers name slots 4t + i.
__device__ __forceinline__ int chunk_slot(int k) {
  const int r = k & 15;
  return (k & 16) + 4 * ((r >> 1) & 3) + ((r >> 3) << 1) + (r & 1);
}

// Stage one (image, head)'s or (window, head)'s k and v (tid of nthr
// threads).  base: the first token's q columns of this head in the int8
// qkv rows [n, 3C].
__device__ __forceinline__ void stage_kv(const int8_t* __restrict__ base,
                                         int n, int C, int Dh, int8_t* Ks,
                                         int8_t* Vt, int tid, int nthr) {
  const int N3 = 3 * C, kp = (n + 31) & ~31, dw = ((Dh + 31) & ~31) >> 2;
  const int ldk = kv_ld(Dh), ldv = kv_ld(n);
  for (int i = tid; i < kp * dw; i += nthr) {
    const int j = i / dw, w = i - j * dw;
    int kv = 0, vv = 0;
    if (j < n && 4 * w < Dh) {
      const int8_t* src = base + (size_t)j * N3 + 4 * w;
      kv = *reinterpret_cast<const int*>(src + C);
      vv = *reinterpret_cast<const int*>(src + 2 * C);
    }
    *reinterpret_cast<int*>(Ks + j * ldk + 4 * w) = kv;
    const int slot = (j & ~31) + chunk_slot(j & 31);
#pragma unroll
    for (int d = 0; d < 4; ++d) Vt[(4 * w + d) * ldv + slot] = (int8_t)(vv >> (8 * d));
  }
}

// One word of a q row for an A fragment: 4 channels from col, 0 past the
// n rows or the Dh channels.
__device__ __forceinline__ int q_word(const int8_t* __restrict__ qbase,
                                      int row, int n, int N3, int col, int Dh) {
  return row < n && col < Dh
             ? *reinterpret_cast<const int*>(qbase + (size_t)row * N3 + col)
             : 0;
}

__device__ __forceinline__ int pack4(float a, float b, float c, float d) {
  return (int)(((uint32_t)(int)a & 0xff) | (((uint32_t)(int)b & 0xff) << 8) |
               (((uint32_t)(int)c & 0xff) << 16) | ((uint32_t)(int)d << 24));
}

// The high bytes p >> 8 of four 16-bit probabilities p (f32-held), packed
// as pack4 packs their low bytes.
__device__ __forceinline__ int pack4_hi(const float* p) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (((uint32_t)(int)p[i] >> 8) & 0xff) << (8 * i);
  return (int)w;
}

// One warp, or the K warps of a split (part 0 .. K - 1, each with a K-th of
// the keys): the 16 query rows i0 .. i0 + 15 of one head against all
// its n keys, on mma.sync m16n8k32 s8 (rows past n are zero and never
// written):
//   S = q k^T in int32 accumulators, MAXC chunks of 32 keys a warp (4
//   tiles of 8 keys each; the warp's chunks part * MAXC .. that hold keys
//   computed);
//   score(row, key, dot) -> the f32 score of a real row and key < n_valid;
//   masked(row, key) -> whether a table-form core takes st.sat there (a
//   negative Swin shift mask; never read by the other cores);
//   the softmax on the accumulator layout (shiftmax_quad,
//   ibert_softmax_quad, ppoly_softmax_quad or lut_softmax_quad, by SM),
//   each row in the 4 lanes of a quad;
//   the SB-bit probabilities packed from those registers into P's A
//   fragments (keys in chunk_slot order, as Vt holds them), P v over up to
//   MAXD chunks of 32 channels (the other parts' int32 partials added into
//   part 0's through shared memory), requant by m_av, 4-byte stores of ctx
//   rows by part 0.
// SB: the probabilities' bits, 8 (one s8 product a chunk) or 16: a
// probability p in [0, 2**15 - 1] is split p = 256 hi + lo, hi = p >> 8 in
// [0, 127] and lo = p & 255, and P v = 256 (hi v) + lo v, hi on mma s8 x s8
// and lo on mma u8 x s8: two products a chunk, exact in int32, the hi and lo
// fragments packed a chunk at a time inside the P v loop.  The softmaxes
// saturate their probabilities at 2**(SB - 1) - 1, as the reference's
// conversion into the probabilities' container does.
// qbase / cbase: row 0, channel 0 of this head in qkv [n, N3] / ctx [n, ldc].
// red: the row reductions, QuadReduce, or SplitReduce<K>, whose part says
// which K-th of the keys this warp holds (MAXC chunks from part * MAXC).
template <int SM, int MAXC, int MAXD, int SB = 8, class Red, class Score,
          class Masked>
__device__ __forceinline__ void attn_tile(
    const int8_t* __restrict__ qbase, int N3, int i0, int n, int Dh,
    int n_valid, const int8_t* Ks, const int8_t* Vt, Score score,
    Masked masked, const SoftmaxConsts& k, const SoftmaxTable& ps, int fast_q,
    int fast_poly, float m_av, int8_t* __restrict__ cbase, int ldc, Red& red) {
  const int part = red.part;
  constexpr int NT = 4 * MAXC, DT = 4 * MAXD;  // 8-key and 8-channel tiles
  static_assert(2 * NT <= 32, "a row's values of a lane fit satb's bits");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = part * MAXC;                            // first chunk
  const int nc = min(MAXC, max(0, ((n + 31) >> 5) - c0));  // chunks with keys
  const int nd = (Dh + 31) >> 5, key0 = 32 * c0;
  const int ldk = kv_ld(Dh), ldv = kv_ld(n);
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < MAXD; ++kk) {
    if (kk < nd) {
      const int c = 32 * kk + 4 * t;
      const int a0 = q_word(qbase, i0 + g, n, N3, c, Dh);
      const int a1 = q_word(qbase, i0 + g + 8, n, N3, c, Dh);
      const int a2 = q_word(qbase, i0 + g, n, N3, c + 16, Dh);
      const int a3 = q_word(qbase, i0 + g + 8, n, N3, c + 16, Dh);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < 4 * nc) {
          const int8_t* kr = Ks + (key0 + 8 * j + g) * ldk + c;
          mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const int*>(kr),
                 *reinterpret_cast<const int*>(kr + 16));
        }
      }
    }
  }
  // f32 scores of rows g (s[0]) and g + 8 (s[1]); index 2j + (e & 1) is
  // column key0 + quad_col(2j + (e & 1), t); a padding row's scores are 0
  float s[2][2 * NT];
  uint32_t satb[2] = {0u, 0u};  // table forms: the values that take st.sat
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + g + 8 * (e >> 1), key = key0 + 8 * j + 2 * t + (e & 1);
      float v = -8388608.f;
      if (j < 4 * nc && key < n_valid) {
        v = row < n ? score(row, key, acc[j][e]) : 0.f;
        if (is_lut_core(SM) && row < n && masked(row, key))
          satb[e >> 1] |= 1u << (2 * j + (e & 1));
      }
      s[e >> 1][2 * j + (e & 1)] = v;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    red.row = g + 8 * h;
    if constexpr (SM == kSmShift)
      shiftmax_quad(s[h], 8 * nc, t, key0, n_valid, k.x0, shift_out_scale(SB),
                    fast_q, red);
    else if constexpr (SM == kSmPpoly)
      ppoly_softmax_quad(s[h], 8 * nc, t, key0, n_valid, ps, prob_scale(SB),
                         red);
    else if constexpr (SM == kSmShiftLut)
      lut_softmax_quad<true>(s[h], 8 * nc, t, key0, n_valid, ps, satb[h],
                             shift_out_scale(SB), red);
    else if constexpr (SM == kSmIbertLut)
      lut_softmax_quad<false>(s[h], 8 * nc, t, key0, n_valid, ps, satb[h],
                              prob_scale(SB), red);
    else
      ibert_softmax_quad(s[h], 8 * nc, t, key0, n_valid, k, fast_q, fast_poly,
                         prob_scale(SB), red);
  }
  int o[DT][4];
  if constexpr (SB == 8) {
    // P's A fragments, chunk c: registers 0-1 rows g / g + 8 of tiles 4c
    // and 4c + 1, registers 2-3 those of tiles 4c + 2 and 4c + 3
    int pa[MAXC][4];
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* v = &s[r & 1][8 * c + 4 * (r >> 1)];
        pa[c][r] = pack4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          if (d < 4 * nd) {
            const int8_t* vr = Vt + (8 * d + g) * ldv + key0 + 32 * c + 4 * t;
            mma_s8(o[d], pa[c][0], pa[c][1], pa[c][2], pa[c][3],
                   *reinterpret_cast<const int*>(vr),
                   *reinterpret_cast<const int*>(vr + 16));
          }
        }
      }
    }
  } else {
    static_assert(SB == 16, "probabilities of 8 or 16 bits");
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
        // this chunk's hi and lo fragments, laid out as pa above
        int ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* v = &s[r & 1][8 * c + 4 * (r >> 1)];
          ph[r] = pack4_hi(v);
          pl[r] = pack4(v[0], v[1], v[2], v[3]);
        }
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          if (d < 4 * nd) {
            const int8_t* vr = Vt + (8 * d + g) * ldv + key0 + 32 * c + 4 * t;
            const int b0 = *reinterpret_cast<const int*>(vr);
            const int b1 = *reinterpret_cast<const int*>(vr + 16);
            int hv[4] = {0, 0, 0, 0};
            mma_s8(hv, ph[0], ph[1], ph[2], ph[3], b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) o[d][e] += hv[e] * 256;
            mma_u8s8(o[d], pl[0], pl[1], pl[2], pl[3], b0, b1);
          }
        }
      }
    }
  }
  if constexpr (Red::kParts > 1) {  // parts 1.. add their sums into part 0's
    int* pv = red.xch + 2 * Red::kParts * 16;
    const int stride = 4 * nd * 4 * 32;  // one part's partial sums
    if (part > 0) {
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d < 4 * nd) pv[(part - 1) * stride + (4 * d + e) * 32 + lane] = o[d][e];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(red.bar), "n"(32 * Red::kParts)
                 : "memory");
    if (part > 0) return;
#pragma unroll
    for (int p = 1; p < Red::kParts; ++p)
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d < 4 * nd) o[d][e] += pv[(p - 1) * stride + (4 * d + e) * 32 + lane];
  }
  // ctx: requant, then two lanes' 16-bit pairs of two tiles into one word
#pragma unroll
  for (int d = 0; d < DT; d += 2) {
    if (d < 4 * nd) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int lo = (int)requant(__int2float_rn(o[d + q][2 * h]), m_av, 128.f);
          const int hi = (int)requant(__int2float_rn(o[d + q][2 * h + 1]), m_av, 128.f);
          v[q] = (uint32_t)(lo & 0xff) | ((uint32_t)(hi & 0xff) << 8);
        }
        const uint32_t word = pair_word(v[0], v[1]);
        const int row = i0 + g + 8 * h, col = 8 * d + pair_col();
        if (row < n && col < Dh)
          *reinterpret_cast<uint32_t*>(cbase + (size_t)row * ldc + col) = word;
      }
    }
  }
}

// 1. LN + qkv GEMM + requant.  x: [R, C] int8 or (x16) int16; wqkv: the
// tensor map of the qkv weight transposed, [3C, C]; ln_in: the hoisted LN
// output [R, C], or null to run the LN here.
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 2)
ln_qkv_wgmma_kernel(const __grid_constant__ CUtensorMap wqkv,
                    const void* __restrict__ x, const int8_t* __restrict__ ln_in,
                    const float* __restrict__ ln_bias,
                    const float* __restrict__ m_ln,
                    const int32_t* __restrict__ bqkv,
                    const float* __restrict__ mqkv, AttnScalars sp,
                    int8_t* __restrict__ qkv, int R, int C, int x16,
                    int ln_kind) {
  const int r0 = blockIdx.x * kGemmRows, N3 = 3 * C;
  auto fill = [&](int8_t* A) {
    fill_ln_tile(A, x, ln_in, R, C, r0, x16, ln_kind, ln_bias, m_ln,
                 sp.ln_shift);
  };
  auto epi = [&](int (&acc)[BN / 4], int c0) {
#pragma unroll
    for (int j = 0; j < BN / 16; j += 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = c0 + wg_col(j + q, 0);
          const int2 b = __ldg(reinterpret_cast<const int2*>(bqkv + col));
          const float2 m = __ldg(reinterpret_cast<const float2*>(mqkv + col));
          const int* a = &acc[4 * (j + q) + 2 * h];
          const int lo = (int)requant(__int2float_rn(a[0] + b.x), m.x, 128.f);
          const int hi = (int)requant(__int2float_rn(a[1] + b.y), m.y, 128.f);
          v[q] = (uint32_t)(lo & 0xff) | ((uint32_t)(hi & 0xff) << 8);
        }
        const uint32_t word = pair_word(v[0], v[1]);
        const int gr = r0 + wg_row(2 * h);
        if (gr < R)
          *reinterpret_cast<uint32_t*>(qkv + (size_t)gr * N3 + c0 + 8 * j +
                                       pair_col()) = word;
      }
  };
  wgmma_rows<BN, false>(&wqkv, C, N3, fill, epi);
}

// 3. proj GEMM + requant to proj_bits + residual to out_bits.  wp: the
// tensor map of the proj weight transposed, [C, C]; x and out: [R, C],
// int8 or (x16 / o16) int16.
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 2)
proj_wgmma_kernel(const __grid_constant__ CUtensorMap wp,
                  const void* __restrict__ x, const int8_t* __restrict__ ctx,
                  const int32_t* __restrict__ bp, const float* __restrict__ mp,
                  AttnScalars sp, void* __restrict__ out, int R, int C,
                  int proj_bits, int out_bits, int x16, int o16) {
  const int r0 = blockIdx.x * kGemmRows;
  auto fill = [&](int8_t* A) { copy_rows_swizzled(ctx, R, C, r0, A); };
  const float m_res_x = __ldg(sp.m_res_x), m_res_id = __ldg(sp.m_res_id);
  const float lim_p = bits_lim(proj_bits), lim_o = bits_lim(out_bits);
  auto epi = [&](int (&acc)[BN / 4], int c0) {
    residual_epilogue<BN>(acc, c0, r0, R, C, x, bp, mp, m_res_x, m_res_id,
                          lim_p, lim_o, x16, o16, out);
  };
  wgmma_rows<BN, true>(&wp, C, C, fill, epi);
}

// Launch the two GEMM launches' kernels around a core launch: set their
// shared memory limit and build both weight maps.
template <int BN>
cudaError_t prepare_gemms(const int8_t* wqkv_t, const int8_t* wp_t, int C,
                          CUtensorMap* mq, CUtensorMap* mp) {
  const int bytes = (int)wg_smem(C, BN);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ln_qkv_wgmma_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(proj_wgmma_kernel<BN>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes)) != cudaSuccess ||
      (err = weight_map(mq, wqkv_t, 3 * C, C, BN)) != cudaSuccess)
    return err;
  return weight_map(mp, wp_t, C, C, BN);
}

}  // namespace ivit
