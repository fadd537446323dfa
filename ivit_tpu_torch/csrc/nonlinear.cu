// The two standalone ivit nonlinearity kernels, for sm_90a.
//
// ivit_shiftmax replaces ivit_tpu/ops/pallas/nonlinear.py::shiftmax_p
// (body _shiftmax_kernel): row Shiftmax over the last axis of int8 scores
// [rows, N], columns >= n_valid masked (probability 0), into int8 probs
// (output_bit <= 8) or int16 (up to 16).
//
// ivit_shift_gelu_requant replaces shift_gelu_requant_p (body
// _shift_gelu_kernel): row ShiftGELU over the last axis of int8 [rows, H]
// (the max runs over the whole row) and the requant clip(round(y * m_out))
// to the next activation scale, int8 out.  Two launches counted as one:
// ivit.cuh's table of every (row max, value) pair's output, then the rows.
//
// Bound on this card: bytes.  Each reads its int8 input once and writes its
// output once: at DeiT-S, Shiftmax on [256, 6, 197, 197] moves 2 x 59.6 MB
// (35.6 us at 3.35 TB/s), ShiftGELU on [50,432, 1536] 2 x 77.5 MB (46.2 us).
// The exp chains (a divide-free or correctly rounded quotient, a bit-built
// power of two, a Dekker-corrected reciprocal) run on the f32 units, some
// tens of operations each: Shiftmax's an element, ShiftGELU's 65,536 a
// call (its table); they are not counted in that bound.
//
// Design: one warp per row, 8 rows per block of 256 threads.  A Shiftmax
// row of up to 256 columns is held in registers, a column per lane per
// step; a wider one (up to 1024) keeps its exps in shared memory.  A
// ShiftGELU row of whole 16-byte chunks (H % 16 == 0, up to 4096) is read
// once into registers, 16 bytes a lane a step (DeiT-S's 1536: 3 a lane);
// its max goes over the warp, the lanes copy that max's 256-byte table of
// final outputs into shared memory, 8 bytes a lane, and each byte is
// looked up and written back 16 bytes at a time.
// Other rows take shift_gelu_row, which reads the row twice, a word or a
// byte a lane.  The table and the row code are ivit.cuh's, which the MLP
// block kernel runs too.  The scale operands are device pointers to one
// f32 each (the spec's 0-d leaves); every thread derives x0 and s_gelu *
// 1.702 from them, so the host does no arithmetic for a call.

#include "ivit.cuh"

namespace ivit {

constexpr int kRowsPerBlock = kThreads / 32;

// WIDE: rows of 257 to 1024 columns, whose exps wait in shared memory (the
// warp's 1024 floats) between the row sum and the output instead of in 32
// registers a lane, which spilled across the divides; else rows of at most
// 256 columns, 8 a lane in registers (shiftmax_row).  The same operations
// either way: the max and the two-limb int32 sums do not depend on order.
template <bool WIDE, typename OutT>
__global__ void __launch_bounds__(kThreads)
shiftmax_kernel(const int8_t* __restrict__ x, const float* __restrict__ s_attn,
                OutT* __restrict__ out, int rows, int N, int n_valid,
                int output_bit, int fast_q) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int8_t* xr = x + (size_t)row * N;
  OutT* orow = out + (size_t)row * N;
  const float x0 = exp_shift_x0(__ldg(s_attn));
  const float out_scale = shift_out_scale(output_bit);
  // where output_bit fills its container, a probability of
  // 2**(output_bit - 1) (a one-column row whose exp is a power of two)
  // saturates at the container's top, as the reference's f32 -> int
  // conversion does; narrower probabilities always fit
  const float pmax = output_bit == 8 || output_bit == 16 ? kShiftProductMax : kInt32Max;
  if constexpr (WIDE) {
    __shared__ float exps[kRowsPerBlock][1024];
    float* e_row = exps[threadIdx.x >> 5];
    float vmax = -8388608.f;  // -2**23, the reference's pad-column fill
    for (int j = lane; j < n_valid; j += 32) vmax = fmaxf(vmax, (float)xr[j]);
    vmax = warp_max(vmax);
    int sh = 0, sl = 0;
    for (int j = lane; j < N; j += 32) {
      float e = 0.f;
      if (j < n_valid) {
        e = int_exp_shift((float)xr[j] - vmax, x0, kShiftmaxN, fast_q);
        limb_add(sh, sl, e);
      }
      e_row[j] = e;
    }
    const float factor =
        floorf(rdiv(kInt32Max, fminf(limb_total(sh, sl), kInt32Max)));
    for (int j = lane; j < N; j += 32)
      orow[j] = (OutT)(int)floorf(fminf(__fmul_rn(e_row[j], factor), pmax) * out_scale);
  } else {
    float v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int j = lane + 32 * t;
      v[t] = j < N ? (float)xr[j] : 0.f;
    }
    shiftmax_row(v, n_valid, x0, out_scale, pmax, fast_q, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int j = lane + 32 * t;
      if (j < N) orow[j] = (OutT)(int)v[t];
    }
  }
}

// V > 0: rows of whole 16-byte chunks, at most V a lane, held in registers;
// V == 0: any row, through shift_gelu_row.  table: shift_gelu_table_kernel's.
template <int V>
__global__ void __launch_bounds__(kThreads)
shift_gelu_requant_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ table,
                          int8_t* __restrict__ out, int rows, int H) {
  __shared__ __align__(16) int8_t tabs[kRowsPerBlock][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warps leave together
  int8_t* tab = tabs[warp];
  if (V == 0) {
    shift_gelu_row(x + (size_t)row * H, out + (size_t)row * H, H, tab, table,
                   lane);
    return;
  }
  const int4* in = reinterpret_cast<const int4*>(x + (size_t)row * H);
  const int nw = H >> 4;
  int4 v[V > 0 ? V : 1];
  int xmax = -128;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int w = lane + 32 * t;
    if (w < nw) {
      v[t] = in[w];
      xmax = max_s8x4(max_s8x4(xmax, (uint32_t)v[t].x), (uint32_t)v[t].y);
      xmax = max_s8x4(max_s8x4(xmax, (uint32_t)v[t].z), (uint32_t)v[t].w);
    }
  }
  copy_gelu_row_table(tab, table, warp_max_int(xmax), lane);
  int4* o4 = reinterpret_cast<int4*>(out + (size_t)row * H);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int w = lane + 32 * t;
    if (w < nw) o4[w] = gelu_lookup16(tab, v[t]);
  }
}

template <int V>
int launch_shift_gelu(const int8_t* x, const int8_t* table, int8_t* out,
                      int rows, int H, cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  shift_gelu_requant_kernel<V><<<grid, kThreads, 0, stream>>>(x, table, out,
                                                              rows, H);
  return (int)cudaGetLastError();
}

template <bool WIDE, typename OutT>
int launch_shiftmax(const int8_t* x, const float* s_attn, void* out, int rows,
                    int N, int n_valid, int output_bit, int fast_q,
                    cudaStream_t stream) {
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  shiftmax_kernel<WIDE, OutT><<<grid, kThreads, 0, stream>>>(
      x, s_attn, static_cast<OutT*>(out), rows, N, n_valid, output_bit, fast_q);
  return (int)cudaGetLastError();
}

}  // namespace ivit

// scores int8 [rows, N], N <= 1024; out int8 [rows, N] for output_bit <= 8,
// else int16; s_attn points at one f32.
extern "C" int ivit_shiftmax(const int8_t* x, const float* s_attn, void* out,
                             int rows, int N, int n_valid, int output_bit,
                             int fast_q, cudaStream_t stream) {
  if (rows == 0) return 0;
  using namespace ivit;
  // registers for 8 columns a lane where the row allows (N <= 256: ViT's
  // 197 tokens), shared memory otherwise
  auto launch = output_bit <= 8
                    ? (N <= 256 ? launch_shiftmax<false, int8_t>
                                : launch_shiftmax<true, int8_t>)
                    : (N <= 256 ? launch_shiftmax<false, int16_t>
                                : launch_shiftmax<true, int16_t>);
  return launch(x, s_attn, out, rows, N, n_valid, output_bit, fast_q, stream);
}

// x, out int8 [rows, H]; s_gelu and m_out point at one f32 each; output_bit
// is the sigmoid's, n the exp's shift budget, out_bits the requant's (<= 8);
// table: 65,536 bytes of scratch (the table launch runs first).
extern "C" int ivit_shift_gelu_requant(const int8_t* x, const float* s_gelu,
                                       const float* m_out, int8_t* out,
                                       int rows, int H, int output_bit, int n,
                                       int out_bits, int fast_q, int8_t* table,
                                       cudaStream_t stream) {
  if (rows == 0) return 0;
  using namespace ivit;
  const cudaError_t err = launch_shift_gelu_table(s_gelu, m_out, output_bit, n,
                                                  out_bits, fast_q, table, stream);
  if (err != cudaSuccess) return (int)err;
  // 16-byte chunks a lane in registers where the row is made of them (the
  // wrapper's operands are 16-byte aligned), else the word / byte path
  const bool chunks = H % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int per_lane = chunks ? (H / 16 + 31) / 32 : 0;
  auto launch = per_lane == 0 || per_lane > 8 ? launch_shift_gelu<0>
              : per_lane == 1                 ? launch_shift_gelu<1>
              : per_lane == 2                 ? launch_shift_gelu<2>
              : per_lane == 3                 ? launch_shift_gelu<3>
              : per_lane == 4                 ? launch_shift_gelu<4>
                                              : launch_shift_gelu<8>;
  return launch(x, table, out, rows, H, stream);
}
