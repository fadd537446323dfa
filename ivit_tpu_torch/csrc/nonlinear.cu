// The standalone kernels, for sm_90a: the two ivit nonlinearities, and the
// integer LayerNorm + int8 requant of the LNs outside the block kernels.
//
// ivit_shiftmax replaces ivit_tpu/ops/pallas/nonlinear.py::shiftmax_p
// (body _shiftmax_kernel): row Shiftmax over the last axis of int8 scores
// [rows, N], N <= 1024, columns >= n_valid masked (probability 0), into
// int8 probs (output_bit <= 8) or int16 (up to 16).
//
// ivit_shift_gelu_requant replaces shift_gelu_requant_p (body
// _shift_gelu_kernel): row ShiftGELU over the last axis of int8 [rows, H]
// (the max runs over the whole row) and the requant clip(round(y * m_out))
// to the next activation scale, int8 out.  Two launches counted as one:
// ivit.cuh's table of every (row max, value) pair's output, then the rows.
//
// Bound on this card: bytes.  Each reads its int8 input once and writes its
// output once: at DeiT-S, Shiftmax on [256, 6, 197, 197] moves 2 x 59.6 MB
// (35.6 us at 3.35 TB/s; 16-bit probabilities 59.6 + 119.2 MB, 53.4 us),
// ShiftGELU on [50,432, 1536] 2 x 77.5 MB (46.2 us).  Both take the exp
// chains (a divide-free or correctly rounded quotient, a bit-built power
// of two, a Dekker-corrected reciprocal) off the elements into a table, so
// that an element costs a few integer and f32 instructions and
// shared-memory accesses; what remains is issuing those instructions,
// which the tiles below overlap with the copies.
//
// Shiftmax, the table.  The scores are int8 and the row max is one of them,
// so an element's exp is int_exp_shift(-d) with d = max - x in [0, 255]:
// one of 256 values that depend only on the call's s_attn and fast_q.
// Each block computes them in its prologue with int_exp_shift itself (one
// entry a thread), so the table holds the bits the per-element chain gives,
// at any x0 and with either quotient form.  It is stored once per lane
// (entry d of lane l at word 32 d + l, 32 KB), so a warp's 32 lookups hit
// 32 banks whatever the d.  An element then costs a byte read from shared
// memory and the max; one lookup, p = min(e, 2**31) as an integer, whose
// p >> 8 and p & 255 are limb_add's two limbs (summed as sum(p >> 8) and
// sum(p) mod 2**32, the low limbs' sum being their difference), two adds;
// for the output a multiply, a min, a floor and a byte or halfword store:
// floor(min(e * factor, pmax) * 2**-k) as floor(min(e * (factor 2**-k),
// pmax 2**-k)), a power-of-two scale being exact on both sides.  Where
// factor >= 0, v = min(...) lies in [0, 2**15] and its floor is v + 2**23
// rounded down, whose low bits are the probability.  Where a row's exps
// sum past 2**31 the high limbs' int32 sum wraps (as in the reference),
// the factor turns negative and so do the probabilities: such a row (a
// warp-uniform branch) takes the f32 -> int32 conversion rounding down,
// floorf and the conversion in one (a conversion on every element cost 5%
// on an H100 at DeiT-S's scores).  A row costs the warp max and two warp
// sums (redux) and one rdiv for factor, the RW rows of a warp on RW lanes
// side by side.  The max and the int32 limb sums do not depend on order,
// so every output has the per-element chain's bits.
//
// Shiftmax, the tiles.  A persistent grid (three blocks of 256 threads an
// SM where the shared memory allows) walks tiles of R consecutive rows:
// R = 32 for rows of up to 224 columns (each warp 4 rows at once, 7
// columns a lane in registers: ViT's 197), R = 16 for wider rows (each
// warp 2 rows, 32 columns a lane).  R is a multiple of 16, so a tile
// is R N bytes, a whole number of 16-byte chunks at a 16-byte aligned
// address wherever the tensor's base is.  One thread brings tiles into a
// ring of S buffers by 1-D TMA bulk copies (cp.async.bulk against an
// mbarrier, S tiles ahead of the rows being computed) and sends each
// output tile from one of two shared buffers to global memory by a bulk
// copy.  A ragged last tile, or a tensor whose base is not 16-byte aligned,
// is copied in and out by the block's threads a byte at a time and
// computed by the same code.

// ShiftGELU: one warp per row, 8 rows per block of 256 threads.  A row of
// whole 16-byte chunks (H % 16 == 0, up to 4096) is read once into
// registers, 16 bytes a lane a step (DeiT-S's 1536: 3 a lane); its max goes
// over the warp, the lanes copy that max's 256-byte table of final outputs
// into shared memory, 8 bytes a lane, and each byte is looked up and
// written back 16 bytes at a time.  Other rows take shift_gelu_row, which
// reads the row twice, a word or a byte a lane.  The table and the row code
// are ivit.cuh's, which the MLP block kernel runs too.  The scale operands
// are device pointers to one f32 each (the spec's 0-d leaves); every thread
// derives x0 and s_gelu * 1.702 from them, so the host does no arithmetic
// for a call.

// ivit_ln_requant replaces no Pallas kernel: JAX leaves the LNs outside
// its block kernels (Swin's patch norm, each PatchMerging norm, the final
// norm; ViT's final norm of the cls rows) to XLA, which fuses their chains.
// The port ran each as about 250 torch launches (ten Newton steps of
// correctly rounded divides, two-limb sums, the requant) and copied two
// host scalars to the card for the ibert LN, after which torch waits for
// the stream.  It maps int8 or int16 rows [R, C] (any row stride of
// 16-byte aligned rows; C a multiple of 16 up to 2,048, the widest norm the
// engines run: Swin-B's last merge, Swin-T's 1,536) to int8 [R, C]:
// exact.cuh's ln_row_i32, the LN the block kernels run at their
// input (I-LayerNorm, or the ibert LN with the spec's shift, floor(sqrt)
// or I-BERT's integer sqrt), its bias, a NaN row pinned to 0 and the int8
// requant; every scalar is an argument or read from the spec's 0-d leaf.
//
// Bound on this card: bytes.  Each row is read once and its output written
// once: a Swin-T batch of 64 moves about 147 MB through its five LNs
// (patch norm [200,704, 96] int8, merges [50,176, 384], [12,544, 768],
// [3,136, 1,536] and the final norm [3,136, 768] int16), 44 us at 3.35 TB/s.
// A persistent grid walks tiles of 256 / L rows, L lanes a row (4 up to C
// 128, 8 up to 384, 16 up to 768, else 32: the narrower the row, the more
// rows a warp takes at once, so that its Newton chain is shared by fewer
// lanes).  The block copies a tile into shared memory, 16 bytes a thread,
// each group runs ln_row_i32 on its row there (so
// the row leaves device memory once, however often the LN reads it) into
// an output tile, which the block writes back 16 bytes a thread.  A row
// 16 bytes longer in shared memory than in device memory keeps the groups
// of a warp, on consecutive rows, on distinct banks.

#include "ivit.cuh"
#include "wgmma_gemm.cuh"

namespace ivit {

constexpr int kRowsPerBlock = kThreads / 32;

// The Shiftmax exp table: 256 entries (d = 0 .. 255) of 32 words each, one
// per lane.
constexpr int kSmEntries = 256;
constexpr int kSmTableBytes = kSmEntries * 32 * 4;
// the table and its staging, rounded up to the tiles' 16-byte alignment
constexpr int kSmHeadBytes = (kSmTableBytes + kSmEntries * 4 + 15) & ~15;
constexpr int kSmBlocksPerSm = 3;

// Rows of at most 32 V columns, RW rows a warp at once: tiles of 8 RW rows.
template <int V>
struct SmTile {
  static constexpr int RW = V <= 8 ? 4 : 2;
  static constexpr int R = kRowsPerBlock * RW;
};

// Shared memory of a shiftmax block: the table, its staging (one entry a
// thread), S input tiles, two output tiles, S mbarriers.
inline size_t shiftmax_smem(int R, int N, int out_size, int stages) {
  return kSmHeadBytes + (size_t)R * N * (stages + 2 * out_size) + 8 * stages;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N bulk stores of this thread still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The exp of the table entry at a 32-bit shared address.
__device__ __forceinline__ float lds_exp(uint32_t a) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// base - 128 x in one multiply-add: the shared address of a table entry.
__device__ __forceinline__ uint32_t entry_addr(int x, uint32_t base) {
  uint32_t a;
  asm("mad.lo.u32 %0, %1, 0xffffff80, %2;" : "=r"(a) : "r"(x), "r"(base));
  return a;
}

// One warp: Shiftmax of rows row0 + 8 i (i < RW; rows >= live are
// computed on row live - 1 and not stored) of a tile in shared memory, row
// r at in + r N, into out + r N.  etab: the shared address of this lane's
// word of entry 0; out_scale and pmax_s as in the header.  A lane holds
// columns lane + 32 t, t < V; those past n_valid take no part (predicated
// off) and the padding columns n_valid .. N - 1 are written 0 after the row.
template <int V, int RW, typename OutT>
__device__ __forceinline__ void shiftmax_tile_rows(
    const int8_t* in, OutT* out, int row0, int live, int N, int n_valid,
    uint32_t etab, float out_scale, float pmax_s, int lane) {
  const int nv = (n_valid - lane + 31) >> 5;  // this lane's columns < n_valid
  // x: the element's value, then its exp
  int x[RW][V];
  int vmax[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int8_t* xr = in + min(row0 + kRowsPerBlock * i, live - 1) * N + lane;
    vmax[i] = -128;
#pragma unroll
    for (int t = 0; t < V; ++t)
      if (t < nv) {
        x[i][t] = xr[32 * t];
        vmax[i] = max(vmax[i], x[i][t]);
      }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) vmax[i] = __reduce_max_sync(0xffffffffu, vmax[i]);
  // limb_add's limbs of min(e, 2**31) as an integer p: p >> 8 and p & 255,
  // summed as hi = sum(p >> 8) and all = sum(p), mod 2**32; the low limbs'
  // sum, under 2**32, is all - 256 hi
  uint32_t hi[RW], all[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const uint32_t base = etab + ((uint32_t)vmax[i] << 7);
    hi[i] = all[i] = 0;
#pragma unroll
    for (int t = 0; t < V; ++t)
      if (t < nv) {
        const float e = lds_exp(entry_addr(x[i][t], base));  // entry max - x
        const uint32_t p = (uint32_t)fminf(e, kInt32Max);
        hi[i] += p >> 8;
        all[i] += p;
        x[i][t] = __float_as_int(e);
      }
  }
  // each row's factor floor(2**31 / sum): lane l divides for row l % RW,
  // so the RW quotients run side by side
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const uint32_t h = __reduce_add_sync(0xffffffffu, hi[i]);
    const uint32_t l = __reduce_add_sync(0xffffffffu, all[i]) - (h << 8);
    const float ti = __fadd_rn(__fmul_rn(__int2float_rn((int)h), 256.f),
                               __int2float_rn((int)l));
    if ((lane & (RW - 1)) == i) total = ti;
  }
  const float f = __fmul_rn(floorf(rdiv(kInt32Max, fminf(total, kInt32Max))),
                            out_scale);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = row0 + kRowsPerBlock * i;
    const float factor_s = __shfl_sync(0xffffffffu, f, i);
    if (row >= live) continue;  // warp-uniform
    OutT* orow = out + row * N + lane;
    if (factor_s >= 0.f) {  // 0 <= v <= 2**15: v + 2**23 rounded down
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (t < nv) {
          const float v = fminf(__fmul_rn(__int_as_float(x[i][t]), factor_s), pmax_s);
          orow[32 * t] = (OutT)(__float_as_int(__fadd_rd(v, 8388608.f)) - 0x4B000000);
        }
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (t < nv) {
          const float v = fminf(__fmul_rn(__int_as_float(x[i][t]), factor_s), pmax_s);
          orow[32 * t] = (OutT)__float2int_rd(v);
        }
    }
    if (n_valid < N)  // warp-uniform
      for (int j = n_valid; j + lane < N; j += 32) orow[j] = 0;
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of R = SmTile<V>::R
// rows.  bulk: x and out are 16-byte aligned, so whole tiles move by bulk
// copies (the ragged last one by the threads).
template <int V, typename OutT>
__global__ void __launch_bounds__(kThreads, V <= 8 ? kSmBlocksPerSm : 1)
shiftmax_kernel(const int8_t* __restrict__ x, const float* __restrict__ s_attn,
                OutT* __restrict__ out, int rows, int N, int n_valid,
                int output_bit, int fast_q, int stages, int bulk) {
  constexpr int RW = SmTile<V>::RW, R = SmTile<V>::R;
  extern __shared__ __align__(128) uint8_t smem[];
  float* etab = reinterpret_cast<float*>(smem);
  float* stage = reinterpret_cast<float*>(smem + kSmTableBytes);
  const int tile_in = R * N, tile_out = R * N * (int)sizeof(OutT);
  int8_t* ins = reinterpret_cast<int8_t*>(smem + kSmHeadBytes);
  OutT* outs = reinterpret_cast<OutT*>(ins + (size_t)stages * tile_in);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(outs) + 2 * (size_t)tile_out);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (rows + R - 1) / R;
  // whole tiles of an aligned tensor move by bulk copies
  auto by_bulk = [&](int t) { return bulk && (t + 1) * R <= rows; };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < stages; ++k) {
      const int t = blockIdx.x + k * gridDim.x;
      if (t < ntiles && by_bulk(t)) {
        mbar_expect_tx(full + k, tile_in);
        bulk_load(ins + k * tile_in, x + (size_t)t * R * N, tile_in, full + k);
      }
    }
  }
  // the table: entry d = 0 .. 255 by thread d
  const float out_scale = shift_out_scale(output_bit);
  stage[tid] = int_exp_shift(__int2float_rn(-tid), exp_shift_x0(__ldg(s_attn)),
                             kShiftmaxN, fast_q);
  __syncthreads();
  for (int w = tid; w < kSmEntries * 32; w += kThreads) etab[w] = stage[w >> 5];
  // where output_bit fills its container, a probability of 2**(bits - 1)
  // (a one-column row whose exp is a power of two) saturates at the
  // container's top, as the reference's f32 -> int conversion does;
  // narrower probabilities always fit
  const float pmax_s = __fmul_rn(
      output_bit == 8 || output_bit == 16 ? kShiftProductMax : kInt32Max, out_scale);
  __syncthreads();
  for (int k = 0, t = blockIdx.x; t < ntiles; ++k, t += gridDim.x) {
    const int s = k % stages, r0 = t * R, live = min(R, rows - r0);
    int8_t* in = ins + s * tile_in;
    OutT* o = outs + (k & 1) * (tile_out / (int)sizeof(OutT));
    if (by_bulk(t)) {
      mbar_wait(full + s, (k / stages) & 1);
    } else {
      const int8_t* src = x + (size_t)r0 * N;
      for (int i = tid; i < live * N; i += kThreads) in[i] = src[i];
    }
    // the output buffer's store of two tiles ago has left shared memory
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();
    shiftmax_tile_rows<V, RW, OutT>(in, o, warp, live, N, n_valid,
                                    smem_u32(smem) + 4 * lane, out_scale, pmax_s,
                                    lane);
    fence_to_async();
    __syncthreads();
    if (by_bulk(t)) {
      if (tid == 0) bulk_store(out + (size_t)r0 * N, o, tile_out);
    } else {
      OutT* dst = out + (size_t)r0 * N;
      for (int i = tid; i < live * N; i += kThreads) dst[i] = o[i];
    }
    // every thread has read this input buffer: refill it, stages tiles on
    const int tn = t + stages * gridDim.x;
    if (tid == 0 && tn < ntiles && by_bulk(tn)) {
      mbar_expect_tx(full + s, tile_in);
      bulk_load(in, x + (size_t)tn * R * N, tile_in, full + s);
    }
  }
  if (tid == 0) bulk_wait_read<0>();
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

// What every launch of shiftmax_kernel<V, OutT> shares: the SM's shared
// memory, and a block's whole opt-in share granted to the kernel, once.
struct SmDevice {
  cudaError_t err;
  int per_sm;
};

template <typename Kernel>
SmDevice sm_device(Kernel kernel) {
  int dev = 0, per_sm = 0, per_block = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               per_block);
  return {err, per_sm};
}

// A launch's ring depth, shared memory and grid at row width n.
struct SmPlan {
  int n, stages, grid;
  size_t smem;
};

template <int V, typename OutT>
int launch_shiftmax(const int8_t* x, const float* s_attn, void* out, int rows,
                    int N, int n_valid, int output_bit, int fast_q,
                    cudaStream_t stream) {
  constexpr int R = SmTile<V>::R;
  auto kernel = shiftmax_kernel<V, OutT>;
  static const SmDevice device = sm_device(kernel);
  if (device.err != cudaSuccess) return (int)device.err;
  // the deepest ring (4 down to 2 tiles) that leaves kSmBlocksPerSm blocks
  // an SM, each of which also takes 1 KB of the SM's shared memory for the
  // system, and the grid of the blocks that fit; kept while the width stays
  static thread_local SmPlan plan{0, 0, 0, 0};
  if (plan.n != N) {
    int stages = 4;
    while (stages > 2 && kSmBlocksPerSm * (shiftmax_smem(R, N, sizeof(OutT), stages) +
                                           1024) > (size_t)device.per_sm)
      --stages;
    const size_t smem = shiftmax_smem(R, N, sizeof(OutT), stages);
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    plan = {N, stages, max(1, blocks) * sm_count(), smem};
  }
  const int grid = min((rows + R - 1) / R, plan.grid);
  const int bulk = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  kernel<<<grid, kThreads, plan.smem, stream>>>(x, s_attn, static_cast<OutT*>(out),
                                                rows, N, n_valid, output_bit, fast_q,
                                                plan.stages, bulk);
  return (int)cudaGetLastError();
}

// The fewest columns a lane that hold the row: 7 in registers (rows of up
// to 224 columns: ViT's 197), else 32.
template <typename OutT>
int launch_by_width(const int8_t* x, const float* s_attn, void* out, int rows,
                    int N, int n_valid, int output_bit, int fast_q,
                    cudaStream_t stream) {
  auto launch = N <= 224 ? launch_shiftmax<7, OutT> : launch_shiftmax<32, OutT>;
  return launch(x, s_attn, out, rows, N, n_valid, output_bit, fast_q, stream);
}

// The widest row ln_requant takes: Swin-B's last merge norm (4 x 512).  Each
// int32 limb sum of ln_row_i32 (C * 2**16 at most, 2**27 here) is exact
// there.  At C 2,048 an int16 tile of 8 rows takes 49,408 bytes of shared
// memory, past the 48 KB default: sm_device raises the kernel's limit.
constexpr int kMaxLnWidth = 2048;

// Shared memory of an ln_requant tile: TR rows of x and TR output rows,
// each 16 bytes longer than the row.
inline size_t ln_tile_smem(int TR, int C, int x_size) {
  return (size_t)TR * (C * x_size + 16 + C + 16);
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of TR = 256 / L
// rows; thread t's group (L lanes) computes row t / L of each.  Rows are
// whole 16-byte chunks at 16-byte aligned addresses.
template <int L, bool IVIT, typename XT>
__global__ void __launch_bounds__(kThreads)
ln_requant_kernel(const XT* __restrict__ x, long long stride, int R, int C,
                  const float* __restrict__ bias, const float* __restrict__ m_ln,
                  const float* __restrict__ ln_shift, int isqrt,
                  int8_t* __restrict__ out) {
  constexpr int TR = kThreads / L;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ld_in = C * (int)sizeof(XT) + 16, ld_out = C + 16;
  const int cw_in = C * (int)sizeof(XT) / 16, cw_out = C / 16;
  uint8_t* xs = smem;
  int8_t* os = reinterpret_cast<int8_t*>(smem + (size_t)TR * ld_in);
  const int tid = threadIdx.x, row = tid / L;
  float pw = 1.f;
  int shift = 0;
  if (!IVIT) {
    const LnShift ln = ln_shift_of(ln_shift);
    pw = ln.pw;
    shift = ln.bits;
  }
  const int ntiles = (R + TR - 1) / TR;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * TR, live = min(TR, R - r0);
    for (int i = tid; i < live * cw_in; i += kThreads) {
      const int r = i / cw_in, w = i - r * cw_in;
      const int4* src = reinterpret_cast<const int4*>(x + (r0 + r) * stride);
      *reinterpret_cast<int4*>(xs + r * ld_in + 16 * w) = __ldg(src + w);
    }
    __syncthreads();
    // rows past the tile's last rerun it (every lane of a warp takes part
    // in the group sums) into output rows that are not stored
    ln_row_i32<IVIT, L>(reinterpret_cast<const XT*>(xs + min(row, live - 1) * ld_in),
                        C, bias, m_ln, pw, shift, os + row * ld_out, tid & (L - 1),
                        isqrt != 0);
    __syncthreads();
    int8_t* dst = out + (size_t)r0 * C;
    for (int i = tid; i < live * cw_out; i += kThreads) {
      const int r = i / cw_out, w = i - r * cw_out;
      *reinterpret_cast<int4*>(dst + (size_t)r * C + 16 * w) =
          *reinterpret_cast<const int4*>(os + r * ld_out + 16 * w);
    }
    // the next tile's copy writes xs only: every group has read it
  }
}

// A launch's grid at width C: the blocks that fit an SM, on every SM.
struct LnPlan {
  int C, grid;
};

template <int L, bool IVIT, typename XT>
int launch_ln_requant(const void* x, long long stride, int R, int C,
                      const float* bias, const float* m_ln, const float* ln_shift,
                      int isqrt, int8_t* out, cudaStream_t stream) {
  auto kernel = ln_requant_kernel<L, IVIT, XT>;
  static const SmDevice device = sm_device(kernel);
  if (device.err != cudaSuccess) return (int)device.err;
  constexpr int TR = kThreads / L;
  const size_t smem = ln_tile_smem(TR, C, sizeof(XT));
  static thread_local LnPlan plan{0, 0};
  if (plan.C != C) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    plan = {C, max(1, blocks) * sm_count()};
  }
  const int grid = min((R + TR - 1) / TR, plan.grid);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(x), stride, R, C,
                                           bias, m_ln, ln_shift, isqrt, out);
  return (int)cudaGetLastError();
}

template <bool IVIT, typename XT>
int ln_requant_by_width(const void* x, long long stride, int R, int C,
                        const float* bias, const float* m_ln, const float* ln_shift,
                        int isqrt, int8_t* out, cudaStream_t stream) {
  auto launch = C <= 128   ? launch_ln_requant<4, IVIT, XT>
                : C <= 384 ? launch_ln_requant<8, IVIT, XT>
                : C <= 768 ? launch_ln_requant<16, IVIT, XT>
                           : launch_ln_requant<32, IVIT, XT>;
  return launch(x, stride, R, C, bias, m_ln, ln_shift, isqrt, out, stream);
}

}  // namespace ivit

// scores int8 [rows, N], N <= 1024; out int8 [rows, N] for output_bit <= 8,
// else int16; s_attn points at one f32.
extern "C" int ivit_shiftmax(const int8_t* x, const float* s_attn, void* out,
                             int rows, int N, int n_valid, int output_bit,
                             int fast_q, cudaStream_t stream) {
  if (rows == 0) return 0;
  using namespace ivit;
  return output_bit <= 8
             ? launch_by_width<int8_t>(x, s_attn, out, rows, N, n_valid, output_bit,
                                       fast_q, stream)
             : launch_by_width<int16_t>(x, s_attn, out, rows, N, n_valid,
                                        output_bit, fast_q, stream);
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

// x int8 (x16 0) or int16 [R, C] with row stride `stride` elements (its
// columns contiguous; x and each row 16-byte aligned, C a multiple of 16 up
// to kMaxLnWidth); bias and m_ln f32 [C]; ln_shift points at one f32 (read
// by the ibert LN only); out int8 [R, C], contiguous and 16-byte aligned.
// ln_kind: 0 the ibert LN (floor(sqrt)), 1 I-LayerNorm, 2 the ibert LN with
// I-BERT's integer sqrt.
extern "C" int ivit_ln_requant(const void* x, long long stride, const float* bias,
                               const float* m_ln, const float* ln_shift,
                               int8_t* out, int R, int C, int x16, int ln_kind,
                               cudaStream_t stream) {
  if (R == 0) return 0;
  using namespace ivit;
  const size_t x_size = x16 ? 2 : 1;
  if (C < 16 || C > kMaxLnWidth || C % 16 || ln_kind < 0 || ln_kind > 2 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
        (uintptr_t)(stride * x_size)) & 15))
    return (int)cudaErrorInvalidValue;
  const int isqrt = ln_kind == kLnIbertIntSqrt;
  if (ln_kind == kLnIvit)
    return x16 ? ln_requant_by_width<true, int16_t>(x, stride, R, C, bias, m_ln,
                                                    ln_shift, 0, out, stream)
               : ln_requant_by_width<true, int8_t>(x, stride, R, C, bias, m_ln,
                                                   ln_shift, 0, out, stream);
  return x16 ? ln_requant_by_width<false, int16_t>(x, stride, R, C, bias, m_ln,
                                                   ln_shift, isqrt, out, stream)
             : ln_requant_by_width<false, int8_t>(x, stride, R, C, bias, m_ln,
                                                  ln_shift, isqrt, out, stream);
}
