// One gated residual layer of the WaveNet stack, one launch per layer.
//
// Replaces the TPU kernel mbexwn_vocoder_tpu/ops/pallas_wavenet.py
// (fused_wavenet_group, body _group_kernel, driven by fused_wavenet_stack).
// Per layer, for x (B, T, C) and the shared conditioning slab cond (B, T, 2C):
//   y    = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b_dil + cond[t]    (C -> 2C)
//   g    = tanh(y[:, :C]) * sigmoid(y[:, C:])                  (rounded to the operand type)
//   rs   = g W_rs + b_rs                                        (C -> 2C)
//   x'   = x + rs[:, :C]        (rounded to the operand type; rows outside [0, T) are zero)
//   skip += rs[:, C:]           (fp32, in place)
// A skip-only last layer (skip_only = 1) has W_rs (C, C) and b_rs (C,), all
// skip columns: it reads no res weights, does no res half of the second
// product and writes no x'.
// Weights are "N-major": w_dil (2C, 3, C) and w_rs (2C, C), each output
// column's inputs contiguous, which is the layout the tensor-core B operand
// wants.
//
// What bounds it on the H100: operations.  A layer does 16*C^2 FLOP per row
// against ~8C bytes of x, cond and output traffic per row, far above the
// card's ~295 FLOP/byte ridge.  The TPU design keeps a 4-layer group's
// weights resident in ~100 MB of VMEM; one layer's weights alone (1.6 MB in
// bf16 at C=320) are 7x a block's 227 KB of shared memory, so that does not
// carry over.  This design:
//   - one launch per layer; the 12 layers' weights (~20 MB in bf16) stream
//     from the 50 MB L2;
//   - one CTA per (batch, 64-row time tile); rows outside [0, T) load as
//     zero, which is the SAME padding, so no halo is recomputed;
//   - y is computed in column chunks that pair column j with column C+j, so
//     each chunk's tanh and sigmoid halves are gated together in registers
//     and no 2C-wide fp32 accumulator is needed;
//   - the gated tile (64 x C) stays in shared memory as the A operand of the
//     second product;
//   - x' goes to a second buffer (neighbouring CTAs read this layer's x at
//     t +- d, so an in-place update would race); skip is owned row-wise by
//     one CTA and accumulates in place;
//   - bf16 operands (the shipped mode) run on the tensor cores with
//     mma.sync m16n8k16 (fp32 accumulate), fed by ldmatrix from a ring of
//     three 64-deep cp.async stages with one block barrier per stage (the
//     fastest of the tile shapes, depths and ring sizes compared on the
//     card); fp32 operands (the reference mode, no TF32) run as fp32 FMAs;
//   - C = 340 is not a multiple of the 16-deep MMA step: ragged channel
//     chunks are zero-filled on load (the TPU kernel pads lanes to 128).
// wgmma, TMA and multi-layer fusion are the work of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // time rows per CTA
constexpr int kPairs = 32;  // column pairs (j, C+j) per chunk -> 64 output columns
constexpr int kDepth = 32;  // reduction depth per shared-memory stage (fp32 path)

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---------------------------------------------------------------- fp32 FMA

constexpr int kLdA = kRows + 4;     // x stage, transposed [k][row]
constexpr int kLdB = 2 * kPairs + 1;  // weight stage [k][col], odd to spread banks

// Stage kDepth reduction rows of an N-major (2C x K) weight matrix into Bs:
// columns c0..c0+kPairs of the first half next to the same of the second.
// With skip_only the matrix is (C x K), all second half; the first half is
// staged as zeros.
__device__ __forceinline__ void stage_weights_f32(float* Bs, const float* __restrict__ w, int K, int k0, int k_end,
                                                  int c0, int C, int skip_only) {
  for (int i = threadIdx.x; i < kDepth * 2 * kPairs; i += kThreads) {
    const int cc = i / kDepth, kk = i % kDepth;
    const int j = c0 + (cc % kPairs);
    const int n = (cc < kPairs || skip_only) ? j : C + j;
    const int k = k0 + kk;
    const bool ok = k < k_end && j < C && !(skip_only && cc < kPairs);
    Bs[kk * kLdB + cc] = ok ? w[static_cast<long long>(n) * K + k] : 0.0f;
  }
}

// kSkipOnly is a template parameter, not a runtime flag: as a runtime flag
// the bf16 kernel spilled 88 bytes to local memory and K1 ran 3 % slower.
template <bool kSkipOnly>
__global__ void __launch_bounds__(kThreads) wavenet_layer_f32(
    const float* __restrict__ x_in, const float* __restrict__ cond, const float* __restrict__ w_dil,
    const float* __restrict__ b_dil, const float* __restrict__ w_rs, const float* __restrict__ b_rs,
    float* __restrict__ x_out, float* __restrict__ skip, int T_len, int C, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [kDepth][kLdA]
  float* Bs = As + kDepth * kLdA;              // [kDepth][kLdB]
  float* Gs = Bs + kDepth * kLdB;              // [C][kLdA] gated tile, transposed (16-byte aligned)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows rg*4 .. rg*4+3
  const int cg = tid % 16;  // pairs cg*2, cg*2+1
  const int C2 = 2 * C;
  const long long x_base = static_cast<long long>(b) * T_len * C;
  const long long c_base = static_cast<long long>(b) * T_len * C2;

  for (int c0 = 0; c0 < C; c0 += kPairs) {
    float acc[4][4] = {};
    for (int tap = 0; tap < 3; ++tap) {
      const int shift = (tap - 1) * d;
      for (int ci0 = 0; ci0 < C; ci0 += kDepth) {
        for (int i = tid; i < kRows * kDepth; i += kThreads) {
          const int r = i / kDepth, kk = i % kDepth;
          const int t = t0 + r + shift, ci = ci0 + kk;
          As[kk * kLdA + r] = (t >= 0 && t < T_len && ci < C) ? x_in[x_base + static_cast<long long>(t) * C + ci] : 0.0f;
        }
        stage_weights_f32(Bs, w_dil, 3 * C, tap * C + ci0, tap * C + C, c0, C, 0);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kDepth; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * kLdA + rg * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float* brow = Bs + kk * kLdB;
          const float bv[4] = {brow[cg * 2], brow[cg * 2 + 1], brow[kPairs + cg * 2], brow[kPairs + cg * 2 + 1]};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, t = t0 + r;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = c0 + cg * 2 + q;
        if (j >= C) continue;
        float ya = acc[i][q] + b_dil[j];
        float ys = acc[i][2 + q] + b_dil[C + j];
        if (t < T_len) {
          ya += cond[c_base + static_cast<long long>(t) * C2 + j];
          ys += cond[c_base + static_cast<long long>(t) * C2 + C + j];
        }
        Gs[j * kLdA + r] = tanhf(ya) * sigmoidf(ys);
      }
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += kPairs) {
    float acc[4][4] = {};
    for (int ci0 = 0; ci0 < C; ci0 += kDepth) {
      stage_weights_f32(Bs, w_rs, C, ci0, C, c0, C, kSkipOnly);
      __syncthreads();
      const int depth = min(kDepth, C - ci0);
      for (int kk = 0; kk < depth; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(Gs + (ci0 + kk) * kLdA + rg * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float* brow = Bs + kk * kLdB;
        const float bv[4] = {brow[cg * 2], brow[cg * 2 + 1], brow[kPairs + cg * 2], brow[kPairs + cg * 2 + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg * 4 + i;
      if (t >= T_len) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = c0 + cg * 2 + q;
        if (j >= C) continue;
        const long long o = x_base + static_cast<long long>(t) * C + j;
        if (!kSkipOnly) x_out[o] = x_in[o] + (acc[i][q] + b_rs[j]);
        skip[o] += acc[i][2 + q] + b_rs[kSkipOnly ? j : C + j];
      }
    }
  }
}

// ------------------------------------------------------- bf16 tensor cores
//
// Tile shape: kWarpsM x 4 warps; warp (wm, wn) owns rows wm*32 .. +32 (two
// m16 tiles) and, in each column chunk, pairs wn*8 .. +8 (one n8 tile in the
// tanh half, the same columns in the sigmoid half).  A CTA covers
// 32*kWarpsM rows; kStage is the reduction depth of one cp.async stage and
// kRing the number of stages in flight.
constexpr int kWarpsM = 2;
constexpr int kStage = 64;
constexpr int kRing = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8-byte async copy global -> shared; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int WM, int DEPTH, int NS>
struct Bf16Tile {
  static constexpr int kRowsT = 32 * WM;
  static constexpr int kThreadsT = 128 * WM;
  static constexpr int kLd = DEPTH + 8;  // bf16 row stride of a stage: 4 (mod 8) words, conflict-free ldmatrix
};

// Issue the cp.async copies of one K stage: 64 weight rows (the chunk's
// paired output columns) x DEPTH, and (if x) the tile's x rows x DEPTH.
// With skip_only the weights are (C x K), all second half, and the first
// half's rows are not copied (their product is skipped).
template <int WM, int DEPTH, int NS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* As, __nv_bfloat16* Bs, const __nv_bfloat16* __restrict__ x,
                                           long long x_base, int t0, int shift, int T_len,
                                           const __nv_bfloat16* __restrict__ w, int K, int k0, int ci0, int c0, int C,
                                           int skip_only) {
  using Tile = Bf16Tile<WM, DEPTH, NS>;
  constexpr int kVec = DEPTH / 4;
  for (int i = threadIdx.x + (skip_only ? kPairs * kVec : 0); i < 2 * kPairs * kVec; i += Tile::kThreadsT) {
    const int row = i / kVec, v = i % kVec;
    const int ci = ci0 + v * 4;
    const int j = c0 + (row % kPairs);
    const int n = (row < kPairs || skip_only) ? j : C + j;
    const bool ok = ci < C && j < C;
    cp_async8(Bs + row * Tile::kLd + v * 4, ok ? w + static_cast<long long>(n) * K + k0 + v * 4 : w, ok ? 8 : 0);
  }
  if (x == nullptr) return;
  for (int i = threadIdx.x; i < Tile::kRowsT * kVec; i += Tile::kThreadsT) {
    const int row = i / kVec, v = i % kVec;
    const int ci = ci0 + v * 4;
    const int t = t0 + row + shift;
    const bool ok = ci < C && t >= 0 && t < T_len;
    cp_async8(As + row * Tile::kLd + v * 4, ok ? x + x_base + static_cast<long long>(t) * C + ci : x, ok ? 8 : 0);
  }
}

template <int WM, int DEPTH, int NS, bool kSkipOnly>
__global__ void __launch_bounds__(128 * WM) wavenet_layer_bf16(
    const __nv_bfloat16* __restrict__ x_in, const __nv_bfloat16* __restrict__ cond,
    const __nv_bfloat16* __restrict__ w_dil, const __nv_bfloat16* __restrict__ b_dil,
    const __nv_bfloat16* __restrict__ w_rs, const __nv_bfloat16* __restrict__ b_rs, __nv_bfloat16* __restrict__ x_out,
    float* __restrict__ skip, int T_len, int C, int d, int ld_g) {
  using Tile = Bf16Tile<WM, DEPTH, NS>;
  constexpr int kRowsT = Tile::kRowsT, kLd = Tile::kLd;
  constexpr int kASize = kRowsT * kLd, kBSize = 2 * kPairs * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [NS][kRowsT][kLd]
  __nv_bfloat16* Bs = As + NS * kASize;                          // [NS][64][kLd]
  __nv_bfloat16* Gs = Bs + NS * kBSize;                          // [kRowsT][ld_g] gated tile, zero beyond C

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRowsT;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int C2 = 2 * C;
  const long long x_base = static_cast<long long>(b) * T_len * C;
  const long long c_base = static_cast<long long>(b) * T_len * C2;
  const int n_ci = (C + DEPTH - 1) / DEPTH;

  for (int i = threadIdx.x; i < kRowsT * ld_g / 2; i += Tile::kThreadsT) reinterpret_cast<uint32_t*>(Gs)[i] = 0u;

  // per-lane ldmatrix offsets: A rows lane%16 at k (lane/16)*8; B rows
  // (lane/16)*32 + wn*8 + lane%8 (tanh half, then sigmoid half) at k ((lane/8)%2)*8
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = (lane / 16) * kPairs + wn * 8 + lane % 8, b_k = ((lane / 8) % 2) * 8;
  const int f_row = lane / 4, f_col = (lane % 4) * 2;  // accumulator fragment position

  // One K stage of the dilated conv: tap-major steps over 32/64-deep
  // channel slices; x rows shifted by (tap-1)*d, weight rows tap*C + ci.
  auto load_conv = [&](int step, int slot, int c0) {
    const int tap = step / n_ci, ci0 = (step % n_ci) * DEPTH;
    stage_bf16<WM, DEPTH, NS>(As + slot * kASize, Bs + slot * kBSize, x_in, x_base, t0, (tap - 1) * d, T_len, w_dil,
                              3 * C, tap * C + ci0, ci0, c0, C, 0);
  };
  auto load_res = [&](int step, int slot, int c0) {
    stage_bf16<WM, DEPTH, NS>(nullptr, Bs + slot * kBSize, nullptr, 0, 0, 0, 0, w_rs, C, step * DEPTH, step * DEPTH,
                              c0, C, kSkipOnly);
  };
  // The ring: stage s lands in slot s % NS; NS-1 stages are in flight while
  // one is multiplied, and one barrier per stage both publishes the landed
  // stage and frees the slot the next copy overwrites.  `lo` = false skips
  // the first half's product (a skip-only layer has no res columns).
  auto mma_step = [&](float acc[2][2][4], const __nv_bfloat16* Ab, int lda, int a_col, const __nv_bfloat16* Bb,
                      bool lo) {
#pragma unroll
    for (int kk = 0; kk < DEPTH; kk += 16) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, Bb + b_row * kLd + kk + b_k);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t afr[4];
        ldmatrix_x4(afr, Ab + (wm * 32 + mt * 16 + a_row) * lda + a_col + kk + a_k);
        if (lo) mma_bf16(acc[mt][0], afr, bfr[0], bfr[1]);
        mma_bf16(acc[mt][1], afr, bfr[2], bfr[3]);
      }
    }
  };

  // ---- y = dilated conv + bias + cond, gated chunk by chunk into Gs
  for (int c0 = 0; c0 < C; c0 += kPairs) {
    float acc[2][2][4] = {};
    const int n_steps = 3 * n_ci;
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) {
      if (p < n_steps) load_conv(p, p, c0);
      cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (s + NS - 1 < n_steps) load_conv(s + NS - 1, (s + NS - 1) % NS, c0);
      cp_async_commit();
      mma_step(acc, As + (s % NS) * kASize, kLd, 0, Bs + (s % NS) * kBSize, true);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int j = c0 + wn * 8 + f_col;
    if (j < C) {  // C is a multiple of 4, so j+1 < C too
      const float2 ba = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_dil + j));
      const float2 bs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_dil + C + j));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + f_row + h * 8, t = t0 + r;
          float2 ca = make_float2(0.f, 0.f), cs = make_float2(0.f, 0.f);
          if (t < T_len) {
            const __nv_bfloat16* crow = cond + c_base + static_cast<long long>(t) * C2;
            ca = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow + j));
            cs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(crow + C + j));
          }
          const float g0 = tanhf(acc[mt][0][2 * h] + ba.x + ca.x) * sigmoidf(acc[mt][1][2 * h] + bs.x + cs.x);
          const float g1 = tanhf(acc[mt][0][2 * h + 1] + ba.y + ca.y) * sigmoidf(acc[mt][1][2 * h + 1] + bs.y + cs.y);
          *reinterpret_cast<__nv_bfloat162*>(Gs + r * ld_g + j) = __floats2bfloat162_rn(g0, g1);
        }
    }
  }
  __syncthreads();

  // ---- rs = g W_rs + b_rs: residual into x_out, skip accumulated in place
  for (int c0 = 0; c0 < C; c0 += kPairs) {
    float acc[2][2][4] = {};
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) {
      if (p < n_ci) load_res(p, p, c0);
      cp_async_commit();
    }
    for (int s = 0; s < n_ci; ++s) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (s + NS - 1 < n_ci) load_res(s + NS - 1, (s + NS - 1) % NS, c0);
      cp_async_commit();
      mma_step(acc, Gs, ld_g, s * DEPTH, Bs + (s % NS) * kBSize, !kSkipOnly);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int j = c0 + wn * 8 + f_col;
    if (j < C) {
      const float2 br = kSkipOnly ? make_float2(0.f, 0.f)
                                  : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_rs + j));
      const float2 bk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_rs + (kSkipOnly ? j : C + j)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + wm * 32 + mt * 16 + f_row + h * 8;
          if (t >= T_len) continue;
          const long long o = x_base + static_cast<long long>(t) * C + j;
          if (!kSkipOnly) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x_in + o));
            *reinterpret_cast<__nv_bfloat162*>(x_out + o) = __floats2bfloat162_rn(
                xv.x + (acc[mt][0][2 * h] + br.x), xv.y + (acc[mt][0][2 * h + 1] + br.y));
          }
          float2 sk = *reinterpret_cast<float2*>(skip + o);
          sk.x += acc[mt][1][2 * h] + bk.x;
          sk.y += acc[mt][1][2 * h + 1] + bk.y;
          *reinterpret_cast<float2*>(skip + o) = sk;
        }
    }
  }
}

// Leading dimension of the bf16 gated tile: at least C rounded up to the
// stage depth, with a row stride of 4 (mod 8) 32-bit words so the 8 rows of
// an ldmatrix phase fall in distinct banks.
int gated_ld(int C, int depth) {
  int ld = (C + depth - 1) / depth * depth;
  while ((ld / 2) % 8 != 4) ld += 2;
  return ld;
}

}  // namespace

// dtype: 0 = fp32 operands (FMA), 1 = bf16 operands (tensor cores); fp32
// accumulation in both.  C must be a multiple of 4 for bf16.  skip_only: W_rs
// is (C, C) and x_out is not written.
extern "C" int mbexwn_wavenet_layer(int dtype, const void* x_in, const void* cond, const void* w_dil,
                                    const void* b_dil, const void* w_rs, const void* b_rs, void* x_out, void* skip,
                                    int B, int T_len, int C, int d, int skip_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T_len + kRows - 1) / kRows, B);
  cudaError_t e;
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (kDepth * kLdA + kDepth * kLdB + static_cast<size_t>(C) * kLdA);
    auto kernel = skip_only ? wavenet_layer_f32<true> : wavenet_layer_f32<false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x_in), static_cast<const float*>(cond), static_cast<const float*>(w_dil),
        static_cast<const float*>(b_dil), static_cast<const float*>(w_rs), static_cast<const float*>(b_rs),
        static_cast<float*>(x_out), static_cast<float*>(skip), T_len, C, d);
  } else if (dtype == 1) {
    if (C % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    using Tile = Bf16Tile<kWarpsM, kStage, kRing>;
    const int ld_g = gated_ld(C, kStage);
    const size_t smem = sizeof(__nv_bfloat16) * (kRing * (Tile::kRowsT + 2 * kPairs) * static_cast<size_t>(Tile::kLd) +
                                                 static_cast<size_t>(Tile::kRowsT) * ld_g);
    auto kernel = skip_only ? wavenet_layer_bf16<kWarpsM, kStage, kRing, true>
                            : wavenet_layer_bf16<kWarpsM, kStage, kRing, false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    using bf = __nv_bfloat16;
    const dim3 grid_bf((T_len + Tile::kRowsT - 1) / Tile::kRowsT, B);
    kernel<<<grid_bf, Tile::kThreadsT, smem, s>>>(
        static_cast<const bf*>(x_in), static_cast<const bf*>(cond), static_cast<const bf*>(w_dil),
        static_cast<const bf*>(b_dil), static_cast<const bf*>(w_rs), static_cast<const bf*>(b_rs),
        static_cast<bf*>(x_out), static_cast<float*>(skip), T_len, C, d, ld_g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
