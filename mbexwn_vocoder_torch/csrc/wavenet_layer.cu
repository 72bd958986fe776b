// One gated residual layer of the WaveNet stack, one launch per layer, and a
// host entry that enqueues a whole stack.
//
// Replaces the TPU kernel mbexwn_vocoder_tpu/ops/pallas_wavenet.py
// (fused_wavenet_group, body _group_kernel, driven by fused_wavenet_stack).
// Per layer, for x (B, T, C) and the conditioning slab cond (B, T, 2C), shared by
// all layers or the layer's own (cond_i of a per-layer (B, T, L, 2C) cond):
//   y    = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b_dil + cond[t]    (C -> 2C; SAME)
//   y    = x[t-2d] W0 + x[t-d] W1 + x[t] W2 + b_dil + cond[t]   (C -> 2C; causal)
//   g    = tanh(y[:, :C]) * sigmoid(y[:, C:])                  (rounded to the operand type)
//   rs   = g W_rs + b_rs                                        (C -> 2C)
//   x'   = x + rs[:, :C]        (rounded to the operand type; rows outside [0, T) are zero)
//   skip += rs[:, C:]           (fp32, in place)
// A skip-only last layer (skip_only = 1) has W_rs (C, C) and b_rs (C,), all
// skip columns: it reads no res weights, does no res half of the second
// product and writes no x'.  SAME and causal differ only in the row of x
// each tap reads, (tap + tap0) * d with tap0 = -1 or -2: a runtime argument
// (a row coordinate of a TMA box, or of the fp32 kernel's loads), not a
// template instance.  Shared and per-layer conditioning differ only in where
// a layer's slab starts and the distance between its rows (2 Ch, or L x 2 Ch
// from column i x 2 Ch): the fp32 kernel's cond_ld and the bf16 kernel's cond
// tensor map, encoded per layer.
//
// A shared cond may come at the frame rate, with its linear upsampling factor
// U > 1 (cond_upsampling): cond is then (B, T/U + 1, 2C), the cond conv's
// output with its last frame repeated, as ops/interp.py's upsampler reads it,
// and row t takes lerp(cond[t/U], cond[t/U + 1], t % U) with the upsampler's
// weights, which the kernel computes as PyTorch does on the card (lerp_weights).
// Each product and the sum are rounded to the operand type, with no FMA
// contraction (fp32: __fmul_rn, __fadd_rn; bf16: mul.rn / add.rn.bf16x2,
// which round as PyTorch's fp32 opmath does, see lerp_bf16x2), as PyTorch's
// elementwise kernels round them, so a row's value is the full-rate slab's
// bit for bit and the kernel's output is the output it gives on the slab
// (U = 1).  The full-rate slab is
// never written: at batch 8 of a 1024-frame bucket it was 0.26 GB (2 kHz)
// and 0.52 GB (4 kHz) at C = 320, made in three elementwise passes and read
// by every layer.  The bf16 kernel's producer thread loads the 3 + 126/U
// frame rows that cover a tile (8 at U = 25) where it loaded the tile's 128
// cond rows, into the stage's x slot, and goes on issuing loads; the
// producer warpgroup's other three warps expand them into the stage's cond
// slot and mark the stage filled, so the consumers read the very tile they
// read at U = 1.  At batch 8 of a 1024-frame bucket on the H100 a stack
// call then takes 3-5 % less time than on the full-rate slab, and the
// slab's three passes are gone.  (Expanded by the loading thread's whole
// warpgroup it took 2-4 % less: the loading thread waited for each box.
// Interpolated by the consumers as they start their accumulators, the
// added consumer code slowed the U = 1 path by 7-18 %.  Unpacked to fp32
// for the arithmetic, the expansion made the call 1-8 % slower than on
// the slab at C = 320.)  The fp32 kernel interpolates where it reads cond.
//
// Operand layout.  The reduction dimension is padded with zeros to Cp, a
// multiple of 64 (320 stays 320, 340 becomes 384): x and x' are (B, T, Cp),
// w_dil is (2C, 3, Cp) and w_rs (2C or C, Cp), "N-major" (each output
// column's inputs contiguous, the K-major B operand the tensor cores want).
// Every row then starts 128-byte aligned, so TMA descriptors are legal for
// both models and a 64-deep reduction slice is exactly one 128-byte swizzle
// row.  The kernels write only columns < C of x', so the pad stays zero from
// layer to layer.  The biases and the fp32 skip sum (B, T, C) are not
// padded.  cond is (B, T, 2 Ch) with its tanh half at column 0 and its
// sigmoid half at column Ch: Ch = C for fp32; for bf16 Ch is C rounded up to
// a multiple of 8, because a TMA box has to start on a 16-byte boundary (a
// box at column 340 of a bf16 row faults).
//
// What bounds it on the H100: operations (16*C^2 FLOP per row and layer
// against ~8C bytes of x, cond and output traffic, far above the card's ~295
// FLOP/byte ridge).  What the design has to fight is traffic: one layer's
// weights (1.6 MB in bf16 at C=320) are 7x a block's 227 KB of shared
// memory, so every CTA streams them all from L2, and a layer's activations
// (cond, x, x', the fp32 skip sum: ~100 MB at 25,600 rows) exceed the 50 MB
// L2, so they stream from device memory.  The bf16 kernel (the shipped
// mode):
//   - one CTA per (batch, 128-row time tile), 384 threads: two consumer
//     warpgroups of 64 rows each and one producer warpgroup of which one
//     thread issues TMA loads; setmaxnreg moves registers from the producer
//     (40) to the consumers (232);
//   - the output columns are walked in chunks of P pairs (column j with
//     column C+j), P = 112 at C = 320 (3 chunks), 88 at C = 340 (4
//     chunks) and 88 at C = 256 (3 chunks, WaveGlow's width), so a chunk's
//     tanh and sigmoid halves meet in one thread's accumulators (2 x P/2
//     fp32 registers) and the gate is computed in registers.  P = 160 (2 chunks, 160 accumulator registers) spilled and
//     ran several times slower on the H100.  Per CTA and layer at C = 320 that stages 3 x 3 x 128 x
//     320 x 2 B = 0.74 MB of x and the 1.64 MB of weights for 210 MFLOP: ~88
//     FLOP per byte staged (the mma.sync kernel this replaces, 64-row tiles
//     and 32-pair chunks, staged 1.23 + 1.64 MB for 105 MFLOP: ~37);
//   - a ring of stages, each a 128 x 64 x tile and two P x 64 weight boxes
//     (tanh rows c0.., sigmoid rows C+c0..) in the 128-byte-swizzled layout,
//     filled by TMA with completion on an mbarrier per stage and released by
//     the consumers on a second one.  A stage's products stay in flight
//     while the next stage is waited for (wgmma.wait_group 1);
//   - x is a 3-D tensor map (Cp, T, B): the tap tiles are loaded at rows
//     t0-d, t0, t0+d (causal: t0-2d, t0-d, t0) and TMA zero-fills rows
//     outside [0, T), which is the SAME (causal) padding, without bleeding
//     into the next utterance of the batch;
//   - wgmma.mma_async m64nPk16 (bf16 x bf16 -> fp32), A and B from shared
//     memory; the gated tile (128 x Cp bf16) is written from the accumulator
//     fragments in the same swizzled layout and is the A operand of the
//     second product;
//   - what is added to a product is what its accumulators start from: cond
//     + b_dil for the first, x + b_res | b_skip for the second.  The
//     producer fetches a chunk's cond tiles (and x tile) as plain P-column
//     TMA boxes into ring stages while the chunk before is still being
//     multiplied, so their device-memory latency is off the critical path
//     and they cost no registers.  (Loaded by the consumers themselves they
//     were a large part of the kernel's time on the H100.)
//   - the gate uses tanh.approx.f32 (sigmoid as 0.5 tanh(0.5 v) + 0.5): its
//     error (~2^-11) is below the bf16 rounding of the gated value; against
//     the plain version the bf16 rel-RMS error stays at ~2e-3 (PERF.md has
//     the readings), and precise tanhf/expf were slower;
//   - x' goes to a second buffer (neighbouring CTAs read this layer's x at
//     t +- d, so an in-place update would race).  x' and the layer's skip
//     terms leave through shared memory: a warpgroup stages its 64 rows in
//     the x slot of a ring stage, which the second product does not use, and
//     one thread sends each piece with a TMA store, or for skip with a TMA
//     reduce-add: each row of skip belongs to one CTA, and the reduction
//     adds in fp32 at L2 without the round trip of a read.
// Shared memory (one CTA per SM): gated tile Cp/64 x 16 KB (80 KB at 320,
// 96 KB at 384) + ring n x (16 KB x slot + 2P x 128 B of weights) + barriers
// + 1 KB of alignment slack, under the 227 KB limit: 3 stages of 44 KB at
// C = 320, 3 stages of 38 KB at C = 340 (P is chosen so that three fit: with
// two the producer starves).  The cond and x tiles the accumulators start
// from take the place of a stage's weights; the output pieces use x slots.
// Wave shape at batch 1 and 512 frames: 100 tiles (block 0) and 200 tiles
// (block 1) over 132 SMs, one CTA per SM, so either way the card is ~76 %
// occupied; 64-row tiles with two CTAs per SM give the same 76 % and stream
// the weights twice.  CTAs are not persistent because a layer is one launch
// and its tiles are equal.
// fp32 operands (the reference mode, no TF32) run as fp32 FMAs in the kernel
// kept from the first port.  Cluster multicast of the weights and
// multi-layer fusion are left for a later change.
#include <cuda.h>  // CUtensorMap and the encode function's types; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // time rows per CTA (fp32 path)
constexpr int kPairs = 32;  // column pairs (j, C+j) per chunk -> 64 output columns (fp32 path)
constexpr int kDepth = 32;  // reduction depth per shared-memory stage (fp32 path)

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// ops/interp.py's upsampler weights for offset j of a frame interval,
// w1 = arange(U) / U and w0 = 1 - w1 in the operand type, as PyTorch computes
// them on the card: it divides a tensor by a scalar by multiplying with the
// scalar's fp32 reciprocal, and rounds each result to the operand type.
template <bool kBf16>
__device__ __forceinline__ void lerp_weights(int j, int U, float& w0, float& w1) {
  w1 = __fmul_rn(static_cast<float>(j), __frcp_rn(static_cast<float>(U)));
  if (kBf16) w1 = __bfloat162float(__float2bfloat16_rn(w1));
  w0 = __fsub_rn(1.0f, w1);
  if (kBf16) w0 = __bfloat162float(__float2bfloat16_rn(w0));
}

// The linear upsampler's value between two frames with weights (w0, w1),
// rounded as PyTorch rounds it in fp32: each product, then the sum.
__device__ __forceinline__ float lerp_f32(float lo, float hi, float w0, float w1) {
  return __fadd_rn(__fmul_rn(lo, w0), __fmul_rn(hi, w1));
}

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
// the first bf16 kernel spilled 88 bytes to local memory and ran 3 % slower.
template <bool kSkipOnly>
__global__ void __launch_bounds__(kThreads) wavenet_layer_f32(
    const float* __restrict__ x_in, const float* __restrict__ cond, const float* __restrict__ w_dil,
    const float* __restrict__ b_dil, const float* __restrict__ w_rs, const float* __restrict__ b_rs,
    float* __restrict__ x_out, float* __restrict__ skip, int T_len, int C, int Cp, int cond_ld, int d, int tap0,
    int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [kDepth][kLdA]
  float* Bs = As + kDepth * kLdA;              // [kDepth][kLdB]
  float* Gs = Bs + kDepth * kLdB;              // [C][kLdA] gated tile, transposed (16-byte aligned)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows rg*4 .. rg*4+3
  const int cg = tid % 16;  // pairs cg*2, cg*2+1
  const long long row_base = static_cast<long long>(b) * T_len;

  for (int c0 = 0; c0 < C; c0 += kPairs) {
    float acc[4][4] = {};
    for (int tap = 0; tap < 3; ++tap) {
      const int shift = (tap + tap0) * d;
      for (int ci0 = 0; ci0 < C; ci0 += kDepth) {
        for (int i = tid; i < kRows * kDepth; i += kThreads) {
          const int r = i / kDepth, kk = i % kDepth;
          const int t = t0 + r + shift, ci = ci0 + kk;
          As[kk * kLdA + r] = (t >= 0 && t < T_len && ci < C) ? x_in[(row_base + t) * Cp + ci] : 0.0f;
        }
        stage_weights_f32(Bs, w_dil, 3 * Cp, tap * Cp + ci0, tap * Cp + C, c0, C, 0);
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
        if (t < T_len && U == 1) {
          ya += cond[(row_base + t) * cond_ld + j];
          ys += cond[(row_base + t) * cond_ld + C + j];
        } else if (t < T_len) {  // frame-rate cond: T_len / U + 1 rows an utterance
          const float* lo = cond + (static_cast<long long>(b) * (T_len / U + 1) + t / U) * cond_ld;
          float w0, w1;
          lerp_weights<false>(t % U, U, w0, w1);
          ya += lerp_f32(lo[j], lo[cond_ld + j], w0, w1);
          ys += lerp_f32(lo[C + j], lo[cond_ld + C + j], w0, w1);
        }
        Gs[j * kLdA + r] = tanhf(ya) * sigmoidf(ys);
      }
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += kPairs) {
    float acc[4][4] = {};
    for (int ci0 = 0; ci0 < C; ci0 += kDepth) {
      stage_weights_f32(Bs, w_rs, Cp, ci0, C, c0, C, kSkipOnly);
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
        const long long ox = (row_base + t) * Cp + j;
        if (!kSkipOnly) x_out[ox] = x_in[ox] + (acc[i][q] + b_rs[j]);
        skip[(row_base + t) * C + j] += acc[i][2 + q] + b_rs[kSkipOnly ? j : C + j];
      }
    }
  }
}

// ------------------------------------------- bf16: TMA-fed wgmma, 128-row tiles

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 128;                           // rows per CTA: two consumer warpgroups x 64
constexpr int kStageK = 64;                              // reduction depth of a stage: one 128-byte swizzle row
constexpr int kRowBytes = kStageK * 2;                   // 128
constexpr int kXTileBytes = kTileRows * kRowBytes;       // 16 KB: an x stage, and one 64-column block of the gated tile
constexpr int kMaxRing = 4;                              // most stages the ring holds
constexpr int kSmemLimit = 232448;                       // dynamic shared memory a block may ask for (227 KB)
constexpr int kMaxDevices = 64;                          // cards a process may launch on (per-device state)
constexpr int kBf16Threads = 384;                        // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kConsumerWarps = 8;


template <int P>
__host__ __device__ constexpr int stage_bytes() { return kXTileBytes + 2 * P * kRowBytes; }

// 1 KB of slack to align the tiles to the swizzle period, then gated tile, ring, barriers (two a
// stage and the frame-rate cond's two)
template <int P>
size_t bf16_smem_bytes(int Cp, int n_ring) {
  return 1024 + static_cast<size_t>(Cp / kStageK) * kXTileBytes + n_ring * (stage_bytes<P>() + 2 * sizeof(uint64_t)) +
         2 * sizeof(uint64_t);
}

// Rows of a cond box: a tile's 128, or at U > 1 the frames that rows t0..t0+127 interpolate
// between, t/U - t0/U and one more, at most 3 + 126/U (8 at U = 25; 66 at U = 2, which still
// fits a stage's 16 KB x slot at P = 112).
__host__ __device__ constexpr int cond_box_rows(int U) { return U == 1 ? kTileRows : 3 + (kTileRows - 2) / U; }

// as many stages as fit beside the gated tile; fewer than 2 is refused
template <int P>
int ring_stages(int Cp) {
  int n = kMaxRing;
  while (n > 0 && bf16_smem_bytes<P>(Cp, n) > kSmemLimit) --n;
  return n;
}

// Column pairs per chunk, of the two instantiated widths: the one that leaves
// room for the most stages, then the fewest chunks, then the least padding
// (C = 320: 3 x 112, both widths with 3 stages; C = 340: 4 x 88 with 3
// stages, since 112 leaves room for only 2 beside the 96 KB gated tile;
// C = 256: 3 x 88 with 4 stages beside the 64 KB gated tile, 7 % faster on
// the H100 than 3 x 112 with 3).  A 2 x 128 instance (3 stages) ran 7 %
// slower than 3 x 88 at C = 256 and its output differed from run to run:
// not kept.
int pairs_per_chunk(int C, int Cp) {
  const int widths[2] = {88, 112};
  const int rings[2] = {ring_stages<88>(Cp), ring_stages<112>(Cp)};
  int best = 0;
  long best_score = -1;
  for (int i = 0; i < 2; ++i) {
    const int n_chunks = (C + widths[i] - 1) / widths[i];
    const long score = 1000000L * (kMaxRing - rings[i]) + 1000L * n_chunks + (n_chunks * widths[i] - C);
    if (best_score < 0 || score < best_score) { best = widths[i]; best_score = score; }
  }
  return best;
}

struct LayerArgs {
  const bf16* b_dil;
  const bf16* b_rs;
  // Ch: columns between the two halves of cond; tap0: the first tap's row offset in dilations, -1
  // (SAME) or -2 (causal); U: cond's upsampling factor (1: cond is at the row rate)
  int T_len, C, Cp, Ch, d, tap0, n_ring, U;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// Spin until the barrier's phase differs from `parity`.  A wait that outlasts
// any real one by orders of magnitude (a lost transaction, a miscounted
// phase) traps, so a fault ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Matrix descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: start address / 16, leading offset 1 (unused with a swizzle),
// 1024 bytes between 8-row groups, layout type 1 (B128).  A 16-deep
// reduction step inside the row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// keeps the compiler from moving accumulator reads or writes across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float gate_approx(float ya, float ys) {
  return tanh_approx(ya) * fmaf(0.5f, tanh_approx(0.5f * ys), 0.5f);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two bf16 columns of the linear upsampler's value between two frames, rounded
// as PyTorch's bf16 elementwise kernels round it: each product to bf16 (the
// fp32 product of two bf16 values is exact, so one rounding, as here), then
// the sum, which PyTorch rounds to fp32 and then to bf16.  That double
// rounding is the single rounding of the bf16 add: two bf16 values whose
// exponents differ by up to 15 sum exactly in fp32, and beyond that the
// smaller is far below half a bf16 ulp of the larger either way.  The .rn
// forms are never contracted into an fma.  w0, w1: a weight in both halves.
__device__ __forceinline__ uint32_t lerp_bf16x2(uint32_t lo, uint32_t hi, uint32_t w0, uint32_t w1) {
  uint32_t s, u, y;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(s) : "r"(lo), "r"(w0));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(u) : "r"(hi), "r"(w1));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(y) : "r"(s), "r"(u));
  return y;
}
__device__ __forceinline__ uint32_t bf16x2_of(float w) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w, w);
  uint32_t v;
  memcpy(&v, &h, sizeof(v));
  return v;
}
// Row r of a chunk's plain 128 x P cond tile from the frame rows of its box
// (P bf16 a row): lerp(frames[f], frames[f + 1]) with the row's weights.
template <int P>
__device__ __forceinline__ void expand_cond_row(const unsigned char* frames, unsigned char* tile, int r, int f,
                                                uint32_t w0, uint32_t w1) {
  const uint4* lo = reinterpret_cast<const uint4*>(frames + f * (2 * P));
  const uint4* hi = reinterpret_cast<const uint4*>(frames + (f + 1) * (2 * P));
  uint4* out = reinterpret_cast<uint4*>(tile + r * (2 * P));
#pragma unroll 2
  for (int v = 0; v < P / 8; ++v) {
    const uint4 p = lo[v], q = hi[v];
    out[v] = make_uint4(lerp_bf16x2(p.x, q.x, w0, w1), lerp_bf16x2(p.y, q.y, w0, w1), lerp_bf16x2(p.z, q.z, w0, w1),
                        lerp_bf16x2(p.w, q.w, w0, w1));
  }
}

// shared -> global tile store, and the same as an element-wise add into global memory
// (fp32 by the map's type); both complete through the issuing thread's bulk groups
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until the thread's bulk groups have read their shared-memory sources (the buffer may be rewritten)
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// until they have completed altogether
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
template <int P, bool kSkipOnly>
__global__ void __launch_bounds__(kBf16Threads, 1) wavenet_layer_bf16(const __grid_constant__ CUtensorMap map_x,
                                                                      const __grid_constant__ CUtensorMap map_xr,
                                                                      const __grid_constant__ CUtensorMap map_cond,
                                                                      const __grid_constant__ CUtensorMap map_wd,
                                                                      const __grid_constant__ CUtensorMap map_wr,
                                                                      const __grid_constant__ CUtensorMap map_xo,
                                                                      const __grid_constant__ CUtensorMap map_skip,
                                                                      const LayerArgs a) {
  // map_x: x_in in swizzled 64-column boxes (the A operand's stages); map_xr: x_in and map_cond:
  // cond in plain 128 x P boxes (what the accumulators start from); map_wd, map_wr: the weights;
  // map_xo: x_out in 64 x P boxes and map_skip: skip in 64 x P/2 boxes (what a warpgroup stores)
  constexpr int kStageBytes = stage_bytes<P>();
  constexpr int kHalfBytes = P * kRowBytes;  // one weight box: P output columns x 64 inputs
  constexpr int kInitBytes = kTileRows * P * 2;  // a plain 128 x P tile of cond or x: as large as a stage's weight part
  static_assert(kInitBytes == 2 * kHalfBytes, "an accumulator-start tile takes the place of a stage's weight boxes");
  constexpr int kPieceRowBytes = 2 * P;  // an output piece: 64 rows x P bf16 of x' or 64 rows x P/2 fp32 of skip
  static_assert(64 * kPieceRowBytes <= kXTileBytes && kPieceRowBytes % 16 == 0, "an output piece must fit a stage's x slot");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* gated = smem_raw + pad;  // [Cp/64][128 rows][128 B], swizzled like a TMA tile
  const int n_kb = a.Cp / kStageK;
  unsigned char* ring = gated + n_kb * kXTileBytes;
  const uint32_t gated_s = raw + pad;
  const uint32_t ring_s = gated_s + n_kb * kXTileBytes;
  const int n_ring = a.n_ring;
  const uint32_t full_s = ring_s + n_ring * kStageBytes;  // n_ring "stage filled" barriers, then n_ring "stage free"
  const uint32_t empty_s = full_s + n_ring * 8;
  // U > 1: frame-rate cond box j (j = 2 x chunk + half) has landed, on barrier j % 2
  const uint32_t frames_s = empty_s + n_ring * 8;

  const int C = a.C;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileRows;
  const int n_chunks = (C + P - 1) / P;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_ring; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, kConsumerWarps);
    }
    mbar_init(frames_s, 1);
    mbar_init(frames_s + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // Thread 256 issues the loads.  At U > 1 warps 1-3 make each cond tile
    // from its frame rows (thread e: tile rows e and e + 96), so the loading
    // thread never waits for them.
    const int pr = threadIdx.x - 256;
    if (pr >= 32 && a.U > 1) {
      const int U = a.U, e = pr - 32;
      int f[2];  // a row's first frame within the box, and its weights
      uint32_t w0[2], w1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + e + 96 * h;
        f[h] = t / U - t0 / U;
        float v0, v1;
        lerp_weights<true>(t % U, U, v0, v1);
        w0[h] = bf16x2_of(v0);
        w1[h] = bf16x2_of(v1);
      }
      int stage = 0, j = 0;
      for (int c0 = 0; c0 < n_chunks * P; c0 += P) {
        for (int half = 0; half < 2; ++half, ++j) {
          mbar_wait(frames_s + 8 * (j & 1), (j >> 1) & 1);
          unsigned char* st = ring + stage * kStageBytes;
          expand_cond_row<P>(st, st + kXTileBytes, e, f[0], w0[0], w1[0]);
          if (e < 32) expand_cond_row<P>(st, st + kXTileBytes, e + 96, f[1], w0[1], w1[1]);
          // TMA writes the stage next: order these writes before it, then hand the tile over
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 4, 96;\n" ::: "memory");
          if (e == 0) mbar_arrive(full_s + 8 * stage);
          if (++stage == n_ring) stage = 0;
        }
        stage = (stage + 3 * n_kb) % n_ring;
      }
    } else if (pr == 0) {
      int stage = 0, j = 0;
      uint32_t phase = 0;
      for (int c0 = 0; c0 < n_chunks * P; c0 += P) {
        for (int half = 0; half < 2; ++half, ++j) {  // cond of the chunk's tanh columns, then of its sigmoid columns
          mbar_wait(empty_s + 8 * stage, phase ^ 1);
          const uint32_t dst = ring_s + stage * kStageBytes;
          if (a.U == 1) {
            mbar_expect_tx(full_s + 8 * stage, kInitBytes);
            tma_load_3d(dst + kXTileBytes, &map_cond, full_s + 8 * stage, half * a.Ch + c0, t0, b);
          } else {  // the frame rows into the stage's x slot, which a cond stage does not use
            mbar_expect_tx(frames_s + 8 * (j & 1), cond_box_rows(a.U) * P * 2);
            tma_load_3d(dst, &map_cond, frames_s + 8 * (j & 1), half * a.Ch + c0, t0 / a.U, b);
          }
          if (++stage == n_ring) { stage = 0; phase ^= 1; }
        }
        for (int tap = 0; tap < 3; ++tap) {
          for (int kb = 0; kb < n_kb; ++kb) {
            mbar_wait(empty_s + 8 * stage, phase ^ 1);
            const uint32_t full = full_s + 8 * stage;
            const uint32_t dst = ring_s + stage * kStageBytes;
            mbar_expect_tx(full, kStageBytes);
            tma_load_3d(dst, &map_x, full, kb * kStageK, t0 + (tap + a.tap0) * a.d, b);
            tma_load_2d(dst + kXTileBytes, &map_wd, full, tap * a.Cp + kb * kStageK, c0);
            tma_load_2d(dst + kXTileBytes + kHalfBytes, &map_wd, full, tap * a.Cp + kb * kStageK, C + c0);
            if (++stage == n_ring) { stage = 0; phase ^= 1; }
          }
        }
      }
      for (int c0 = 0; c0 < n_chunks * P; c0 += P) {
        if (!kSkipOnly) {  // the chunk's columns of x, for the residual
          mbar_wait(empty_s + 8 * stage, phase ^ 1);
          mbar_expect_tx(full_s + 8 * stage, kInitBytes);
          tma_load_3d(ring_s + stage * kStageBytes + kXTileBytes, &map_xr, full_s + 8 * stage, c0, t0, b);
          if (++stage == n_ring) { stage = 0; phase ^= 1; }
        }
        for (int kb = 0; kb < n_kb; ++kb) {
          mbar_wait(empty_s + 8 * stage, phase ^ 1);
          const uint32_t full = full_s + 8 * stage;
          const uint32_t dst = ring_s + stage * kStageBytes + kXTileBytes;
          mbar_expect_tx(full, kSkipOnly ? kHalfBytes : 2 * kHalfBytes);
          if (!kSkipOnly) tma_load_2d(dst, &map_wr, full, kb * kStageK, c0);
          tma_load_2d(dst + kHalfBytes, &map_wr, full, kb * kStageK, (kSkipOnly ? 0 : C) + c0);
          if (++stage == n_ring) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32;
    const int wtid = threadIdx.x % 128;
    const int r_lo = wg * 64 + (wtid / 32) * 16 + lane / 4;  // tile rows r_lo and r_lo + 8
    const int f_col = (lane % 4) * 2;                        // columns f_col, f_col + 1 of each 8-wide block
    const int k_last = (C - (n_kb - 1) * kStageK + 15) / 16;  // 16-deep steps of the last 64-column block that reach below C

    // the gated tile's columns >= C of the last block are read by the second
    // product (against zero weights): they must not hold NaN bit patterns
    if (C % kStageK != 0) {
      uint4* blk = reinterpret_cast<uint4*>(gated + (n_kb - 1) * kXTileBytes + wg * 64 * kRowBytes);
      for (int i = wtid; i < 64 * kRowBytes / 16; i += 128) blk[i] = make_uint4(0u, 0u, 0u, 0u);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    float acc_a[P / 2], acc_b[P / 2];  // tanh | sigmoid halves, then res | skip halves
    int stage = 0, prev_stage = 0;
    uint32_t phase = 0;

    // ---- y = dilated conv + bias + cond, gated chunk by chunk into the gated tile
    for (int c0 = 0; c0 < n_chunks * P; c0 += P) {
      // the accumulators start from cond + bias: the producer has fetched the
      // chunk's cond tiles into two stages while the chunk before was still
      // being multiplied, so their latency is off the critical path
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mbar_wait(full_s + 8 * stage, phase);
        const unsigned char* tile = ring + stage * kStageBytes + kXTileBytes;
#pragma unroll
        for (int i = 0; i < P / 8; ++i) {
          const int j = c0 + 8 * i + f_col;
          const float2 bias = j < C ? ld_bf16x2(a.b_dil + half * C + j) : make_float2(0.f, 0.f);  // C is even: j + 1 < C too
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 cv = ld_bf16x2(reinterpret_cast<const bf16*>(tile + (r_lo + 8 * h) * (P * 2)) + 8 * i + f_col);
            float* acc = half == 0 ? acc_a : acc_b;
            acc[4 * i + 2 * h] = cv.x + bias.x;
            acc[4 * i + 2 * h + 1] = cv.y + bias.y;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_s + 8 * stage);
        if (++stage == n_ring) { stage = 0; phase ^= 1; }
      }
      fence_acc(acc_a);
      fence_acc(acc_b);
      for (int step = 0; step < 3 * n_kb; ++step) {
        const int nk = (step % n_kb == n_kb - 1) ? k_last : 4;
        mbar_wait(full_s + 8 * stage, phase);
        const uint32_t st = ring_s + stage * kStageBytes;
        const uint64_t da = smem_desc(st + wg * 64 * kRowBytes);
        const uint64_t db0 = smem_desc(st + kXTileBytes);
        const uint64_t db1 = smem_desc(st + kXTileBytes + kHalfBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < nk) {
            Wgmma<P>::mma(acc_a, da + 2 * k, db0 + 2 * k, 1);
            Wgmma<P>::mma(acc_b, da + 2 * k, db1 + 2 * k, 1);
          }
        }
        wgmma_commit();
        // this stage's products stay in flight; the one before has been read
        if (step > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_s + 8 * prev_stage);
        }
        prev_stage = stage;
        if (++stage == n_ring) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty_s + 8 * prev_stage);
      fence_acc(acc_a);
      fence_acc(acc_b);
#pragma unroll
      for (int i = 0; i < P / 8; ++i) {
        const int j = c0 + 8 * i + f_col;
        if (j < C) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_lo + 8 * h;
            const float g0 = gate_approx(acc_a[4 * i + 2 * h], acc_b[4 * i + 2 * h]);
            const float g1 = gate_approx(acc_a[4 * i + 2 * h + 1], acc_b[4 * i + 2 * h + 1]);
            // swizzled position of (row r, column j): 16-byte group XOR row % 8
            unsigned char* dst = gated + (j >> 6) * kXTileBytes + r * kRowBytes +
                                 ((((j & 63) >> 3) ^ (r & 7)) << 4) + (j & 7) * 2;
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(g0, g1);
          }
        }
      }
    }
    // A warpgroup reads back only its own 64 rows of the gated tile, but the
    // second product's store phase reuses the stages' x slots: both
    // warpgroups must be done with the first product's x tiles.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 3, 256;\n" ::: "memory");

    // ---- rs = g W_rs + b_rs: residual into x_out, skip accumulated in place
    for (int c0 = 0; c0 < n_chunks * P; c0 += P) {
      // the accumulators start from x + b_res | b_skip; x comes through a stage like cond
      if (!kSkipOnly) mbar_wait(full_s + 8 * stage, phase);
#pragma unroll
      for (int i = 0; i < P / 8; ++i) {
        const int j = c0 + 8 * i + f_col;
        float2 br = make_float2(0.f, 0.f), bk = br;
        if (j < C) {
          if (!kSkipOnly) br = ld_bf16x2(a.b_rs + j);
          bk = ld_bf16x2(a.b_rs + (kSkipOnly ? j : C + j));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 xv = make_float2(0.f, 0.f);
          if (!kSkipOnly)
            xv = ld_bf16x2(reinterpret_cast<const bf16*>(ring + stage * kStageBytes + kXTileBytes + (r_lo + 8 * h) * (P * 2)) + 8 * i + f_col);
          acc_a[4 * i + 2 * h] = xv.x + br.x;
          acc_a[4 * i + 2 * h + 1] = xv.y + br.y;
          acc_b[4 * i + 2 * h] = bk.x;
          acc_b[4 * i + 2 * h + 1] = bk.y;
        }
      }
      if (!kSkipOnly) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_s + 8 * stage);
        if (++stage == n_ring) { stage = 0; phase ^= 1; }
      }
      fence_acc(acc_a);
      fence_acc(acc_b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int nk = (kb == n_kb - 1) ? k_last : 4;
        mbar_wait(full_s + 8 * stage, phase);
        const uint32_t st = ring_s + stage * kStageBytes;
        const uint64_t da = smem_desc(gated_s + kb * kXTileBytes + wg * 64 * kRowBytes);
        const uint64_t db0 = smem_desc(st + kXTileBytes);
        const uint64_t db1 = smem_desc(st + kXTileBytes + kHalfBytes);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < nk) {
            if (!kSkipOnly) Wgmma<P>::mma(acc_a, da + 2 * k, db0 + 2 * k, 1);
            Wgmma<P>::mma(acc_b, da + 2 * k, db1 + 2 * k, 1);
          }
        }
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty_s + 8 * prev_stage);
        }
        prev_stage = stage;
        if (++stage == n_ring) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty_s + 8 * prev_stage);
      fence_acc(acc_a);
      fence_acc(acc_b);
      // x' and this layer's skip terms leave through shared memory: during the
      // second product nothing else uses the x slot (the first 16 KB) of a
      // stage, so warpgroup wg stages its 64 rows there, one piece of 64 rows
      // x 2P bytes at a time (x', then the two column halves of skip), and
      // one thread sends each piece with a TMA store, or for skip a TMA
      // reduce-add: each row of skip belongs to one CTA, and the reduction
      // adds at L2 without the round trip of a read.  The copies drain while
      // the warps go on to the next chunk's products.  (Stores from the
      // warps themselves, 4 or 16 bytes a lane, held the warps for a third of
      // the kernel's time on the H100: the SM's store path, not device
      // memory, was the limit.)  Rows >= T and columns >= C are outside the
      // maps' extents and are not written (but see the zeros below).
      {
        unsigned char* piece = ring + wg * kStageBytes;
        const uint32_t piece_s = ring_s + wg * kStageBytes;
        const int r_wg = r_lo - wg * 64;  // row within the warpgroup's 64
#pragma unroll
        for (int p = kSkipOnly ? 1 : 0; p < 3; ++p) {
          if (wtid == 0) bulk_wait_read();  // the piece before has been read out of the buffer
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
          for (int i = 0; i < P / 8; ++i) {
            const int col = 8 * i + f_col;  // column within the chunk
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned char* row = piece + (r_wg + 8 * h) * kPieceRowBytes;
              if (p == 0) {
                // zeros beyond C: the store is cut at the map's extent in 16-byte units, so at
                // C % 8 != 0 up to 4 columns of the pad are written, and the pad must stay zero
                *reinterpret_cast<__nv_bfloat162*>(row + col * 2) =
                    c0 + col < C ? __floats2bfloat162_rn(acc_a[4 * i + 2 * h], acc_a[4 * i + 2 * h + 1])
                                 : __floats2bfloat162_rn(0.f, 0.f);
              } else if (col >= (p - 1) * (P / 2) && col < p * (P / 2)) {
                *reinterpret_cast<float2*>(row + (col - (p - 1) * (P / 2)) * 4) =
                    make_float2(acc_b[4 * i + 2 * h], acc_b[4 * i + 2 * h + 1]);
              }
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
          if (wtid == 0) {
            if (p == 0) tma_store_3d(&map_xo, piece_s, c0, t0 + wg * 64, b);
            else tma_reduce_add_3d(&map_skip, piece_s, c0 + (p - 1) * (P / 2), t0 + wg * 64, b);
            bulk_commit();
          }
        }
      }
    }
    if (wtid == 0) bulk_wait_all();
  }
}

// ------------------------------------------------------------------- host

// Error codes of the C entry points: 0 or a launch count on success, else
// -(cudaError) or, for a failed tensor-map encode, -(10000 + CUresult).
int cuda_fail(cudaError_t e) { return -static_cast<int>(e); }

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: its address is fetched through the
// runtime, so the library links against nothing but cudart.
EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A bf16 (or fp32) tensor map; dims and box innermost first, strides in bytes
// for dims 1...  Swizzled boxes are 64 bf16 (128 bytes) wide.  Out-of-bounds
// elements of a box are read as zeros and are not written.
int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box, bool swizzled = true, bool fp32 = false) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cuda_fail(cudaErrorSymbolNotFound);
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(10000 + static_cast<int>(r));
}

// maps[0]: w_dil as (2C rows, 3*Cp); maps[1]: w_rs as (rs_rows, Cp); boxes of P rows x 64
int encode_weight_maps(CUtensorMap* maps, const void* w_dil, const void* w_rs, int C, int Cp, int rs_rows) {
  const cuuint32_t box[2] = {kStageK, static_cast<cuuint32_t>(pairs_per_chunk(C, Cp))};
  const cuuint64_t dims_d[2] = {static_cast<cuuint64_t>(3 * Cp), static_cast<cuuint64_t>(2 * C)};
  const cuuint64_t stride_d[1] = {static_cast<cuuint64_t>(3 * Cp) * 2};
  if (int e = encode_map(&maps[0], w_dil, 2, dims_d, stride_d, box)) return e;
  const cuuint64_t dims_r[2] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(rs_rows)};
  const cuuint64_t stride_r[1] = {static_cast<cuuint64_t>(Cp) * 2};
  return encode_map(&maps[1], w_rs, 2, dims_r, stride_r, box);
}

// A (B, T, row_elems) activation as (cols, T, B), cols <= row_elems, with
// boxes of box_cols columns x box_rows rows of one utterance.
int encode_rows_map(CUtensorMap* map, const void* x, int B, int T_len, int cols, int row_elems, int box_cols,
                    int box_rows, bool swizzled, bool fp32 = false) {
  const cuuint64_t elem = fp32 ? 4 : 2;
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(T_len), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row_elems * elem, static_cast<cuuint64_t>(T_len) * row_elems * elem};
  return encode_map(map, x, 3, dims, strides, box, swizzled, fp32);
}

// The maps of one ping-pong buffer: as x_in, swizzled 128 x 64 boxes for the
// A operand (a) and plain 128 x P boxes for the residual (r); as x_out, plain
// 64 x P boxes over columns < C only (o), so that the pad is never written.
struct BufMaps {
  CUtensorMap a, r, o;
};
int encode_buf_maps(BufMaps* m, const void* x, int B, int T_len, int C, int Cp) {
  const int P = pairs_per_chunk(C, Cp);
  if (int e = encode_rows_map(&m->a, x, B, T_len, Cp, Cp, kStageK, kTileRows, true)) return e;
  if (int e = encode_rows_map(&m->r, x, B, T_len, Cp, Cp, P, kTileRows, false)) return e;
  return encode_rows_map(&m->o, x, B, T_len, C, Cp, P, 64, false);
}

// The maps a stack's layers share: cond in plain P-column boxes of
// cond_box_rows(U) rows (a layer's slab: 2 Ch columns of rows cond_ld apart,
// T_len / U + 1 rows an utterance at U > 1; per-layer cond re-encodes it for
// each layer), and the fp32 skip sum in 64 x P/2 boxes for the reduce-add.
struct SharedMaps {
  CUtensorMap cond, skip;
};
int encode_cond_map(CUtensorMap* map, const void* cond, int B, int T_len, int C, int Cp, int Ch, int cond_ld, int U) {
  return encode_rows_map(map, cond, B, U == 1 ? T_len : T_len / U + 1, 2 * Ch, cond_ld, pairs_per_chunk(C, Cp),
                         cond_box_rows(U), false);
}
int encode_shared_maps(SharedMaps* m, const void* cond, const void* skip, int B, int T_len, int C, int Cp, int Ch,
                       int cond_ld, int U) {
  if (int e = encode_cond_map(&m->cond, cond, B, T_len, C, Cp, Ch, cond_ld, U)) return e;
  return encode_rows_map(&m->skip, skip, B, T_len, C, C, pairs_per_chunk(C, Cp) / 2, 64, false, true);
}

template <int P, bool kSkipOnly>
int launch_bf16(const BufMaps& in, const BufMaps& out, const SharedMaps& sh, const CUtensorMap* wmaps, LayerArgs args, int B,
                cudaStream_t s) {
  auto kernel = wavenet_layer_bf16<P, kSkipOnly>;
  args.n_ring = ring_stages<P>(args.Cp);
  if (args.n_ring < 2) return cuda_fail(cudaErrorInvalidValue);  // the gated tile leaves no room: C is too wide
  const size_t smem = bf16_smem_bytes<P>(args.Cp, args.n_ring);
  // The attribute belongs to the current device (the caller enters the
  // tensors' device), so it is kept per instantiation and per device, and
  // raised when a wider tile comes along.
  static size_t smem_set[kMaxDevices] = {};
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return cuda_fail(e);
  if (dev < 0 || dev >= kMaxDevices) return cuda_fail(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return cuda_fail(e);
    smem_set[dev] = smem;
  }
  const dim3 grid((args.T_len + kTileRows - 1) / kTileRows, B);
  kernel<<<grid, kBf16Threads, smem, s>>>(in.a, in.r, sh.cond, wmaps[0], wmaps[1], out.o, sh.skip, args);
  return cuda_fail(cudaGetLastError());
}

struct Layer {
  const void *w_dil, *b_dil, *w_rs, *b_rs;
  const CUtensorMap* wmaps;  // bf16 only
  int d, skip_only, tap0;    // tap0: the first tap's offset in dilations, -1 (SAME) or -2 (causal)
};

// dtype: 0 = fp32 operands (FMA), 1 = bf16 operands (tensor cores); fp32
// accumulation in both.  The maps (bf16 only) describe x_in, x_out, cond and skip;
// cond (fp32 only) is the layer's slab, its rows cond_ld elements apart.  U > 1:
// cond is at the frame rate.
int launch_layer(int dtype, const Layer& l, const void* x_in, const void* cond, void* x_out, void* skip,
                 const BufMaps* in, const BufMaps* out, const SharedMaps* sh, int B, int T_len, int C, int Cp, int Ch,
                 int cond_ld, int U, cudaStream_t s) {
  if (dtype == 0) {
    const dim3 grid((T_len + kRows - 1) / kRows, B);
    const size_t smem = sizeof(float) * (kDepth * kLdA + kDepth * kLdB + static_cast<size_t>(C) * kLdA);
    auto kernel = l.skip_only ? wavenet_layer_f32<true> : wavenet_layer_f32<false>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return cuda_fail(e);
    kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x_in), static_cast<const float*>(cond), static_cast<const float*>(l.w_dil),
        static_cast<const float*>(l.b_dil), static_cast<const float*>(l.w_rs), static_cast<const float*>(l.b_rs),
        static_cast<float*>(x_out), static_cast<float*>(skip), T_len, C, Cp, cond_ld, l.d, l.tap0, U);
    return cuda_fail(cudaGetLastError());
  }
  const LayerArgs args = {static_cast<const bf16*>(l.b_dil), static_cast<const bf16*>(l.b_rs), T_len, C, Cp, Ch,
                          l.d, l.tap0, 0, U};
  if (pairs_per_chunk(C, Cp) == 88)
    return l.skip_only ? launch_bf16<88, true>(*in, *out, *sh, l.wmaps, args, B, s)
                       : launch_bf16<88, false>(*in, *out, *sh, l.wmaps, args, B, s);
  return l.skip_only ? launch_bf16<112, true>(*in, *out, *sh, l.wmaps, args, B, s)
                     : launch_bf16<112, false>(*in, *out, *sh, l.wmaps, args, B, s);
}

// Ch is the distance in columns between the tanh and the sigmoid half of a
// cond row: C for fp32; for bf16 a multiple of 8 >= C, since a TMA box must
// start on a 16-byte boundary.  bf16 needs C % 4 == 0: the rows of cond and
// of the fp32 skip sum must be multiples of 16 bytes for their tensor maps.
bool bad_shape(int dtype, int B, int T_len, int C, int Cp, int Ch) {
  return (dtype != 0 && dtype != 1) || B <= 0 || T_len <= 0 || C <= 0 || Cp < C || Cp % kStageK != 0 ||
         (dtype == 0 && Ch != C) || (dtype == 1 && (C % 4 != 0 || Ch < C || Ch % 8 != 0));
}

}  // namespace

// The two tensor maps of one bf16 layer's weights, written to `out` (host
// memory, 2 x 128 bytes).  They hold device addresses: encode once per
// cached weight set.
extern "C" int mbexwn_wavenet_weight_maps(void* out, const void* w_dil, const void* w_rs, int C, int Cp, int rs_rows) {
  if (bad_shape(1, 1, 1, C, Cp, Cp)) return cuda_fail(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  if (int e = encode_weight_maps(maps, w_dil, w_rs, C, Cp, rs_rows)) return e;
  memcpy(out, maps, sizeof(maps));
  return 0;
}

// One layer: x_in, x_out (B, T, Cp), cond (B, T, 2 Ch) with its halves at
// columns 0 and Ch, skip (B, T, C) fp32, weights as in the note above.
// skip_only: W_rs is (C, Cp) and x_out is not written.  causal: taps at
// t-2d, t-d, t.  Returns the launches enqueued (1) or a negative error.
extern "C" int mbexwn_wavenet_layer(int dtype, const void* x_in, const void* cond, const void* w_dil,
                                    const void* b_dil, const void* w_rs, const void* b_rs, void* x_out, void* skip,
                                    int B, int T_len, int C, int Cp, int Ch, int d, int skip_only, int causal,
                                    void* stream) {
  if (bad_shape(dtype, B, T_len, C, Cp, Ch) || (causal != 0 && causal != 1))
    return cuda_fail(cudaErrorInvalidValue);
  CUtensorMap wmaps[2];
  BufMaps in, out;
  SharedMaps sh;
  if (dtype == 1) {
    if (int e = encode_weight_maps(wmaps, w_dil, w_rs, C, Cp, skip_only ? C : 2 * C)) return e;
    if (int e = encode_buf_maps(&in, x_in, B, T_len, C, Cp)) return e;
    if (int e = encode_buf_maps(&out, x_out, B, T_len, C, Cp)) return e;
    if (int e = encode_shared_maps(&sh, cond, skip, B, T_len, C, Cp, Ch, 2 * Ch, 1)) return e;
  }
  const Layer l = {w_dil, b_dil, w_rs, b_rs, wmaps, d, skip_only, causal ? -2 : -1};
  const int e = launch_layer(dtype, l, x_in, cond, x_out, skip, &in, &out, &sh, B, T_len, C, Cp, Ch, 2 * Ch, 1,
                             static_cast<cudaStream_t>(stream));
  return e ? e : 1;
}

// A whole stack in one host call: layer i reads x_bufs[i % 2] and writes
// x_bufs[(i + 1) % 2]; the caller has put x into x_bufs[0] and zeros into
// skip and into the pad columns of both buffers.  cond is (B, T, 2 Ch) shared
// by every layer (per_layer_cond = 0) or (B, T, n_layers, 2 Ch), layer i's
// slab at column i x 2 Ch of each row (per_layer_cond = 1); a shared cond may
// be at the frame rate, (B, T / U + 1, 2 Ch) with U = cond_upsampling > 1 (see
// the note at the top).  The per-layer arrays hold
// n_layers device pointers (weight_maps: n_layers x 2 tensor maps in host
// memory from mbexwn_wavenet_weight_maps, bf16 only).  causal: every
// layer's taps at t-2d, t-d, t.  Enqueues on `stream`, allocates and
// synchronises nothing.  Returns the launches enqueued or a negative error.
extern "C" int mbexwn_wavenet_stack(int dtype, int n_layers, void* x_buf0, void* x_buf1, const void* cond,
                                    const void* const* w_dil, const void* const* b_dil, const void* const* w_rs,
                                    const void* const* b_rs, const int* dils, const int* skip_only,
                                    const void* weight_maps, void* skip, int B, int T_len, int C, int Cp, int Ch,
                                    int per_layer_cond, int causal, int cond_upsampling, void* stream) {
  const int U = cond_upsampling;
  if (bad_shape(dtype, B, T_len, C, Cp, Ch) || n_layers < 0 || (causal != 0 && causal != 1) ||
      (per_layer_cond != 0 && per_layer_cond != 1) || U < 1 ||
      (U > 1 && (per_layer_cond || T_len % U != 0)))
    return cuda_fail(cudaErrorInvalidValue);
  const int cond_ld = (per_layer_cond ? n_layers : 1) * 2 * Ch;  // elements between two rows of cond
  void* bufs[2] = {x_buf0, x_buf1};
  BufMaps maps[2];  // of the two ping-pong buffers
  SharedMaps sh;
  CUtensorMap wmaps[2];
  if (dtype == 1) {
    for (int i = 0; i < 2; ++i)
      if (int e = encode_buf_maps(&maps[i], bufs[i], B, T_len, C, Cp)) return e;
    if (int e = encode_shared_maps(&sh, cond, skip, B, T_len, C, Cp, Ch, cond_ld, U)) return e;
  }
  const size_t elem = dtype == 1 ? sizeof(bf16) : sizeof(float);
  for (int i = 0; i < n_layers; ++i) {
    const void* cond_i = static_cast<const unsigned char*>(cond) + (per_layer_cond ? i * 2 * Ch * elem : 0);
    if (dtype == 1) {
      memcpy(wmaps, static_cast<const unsigned char*>(weight_maps) + i * sizeof(wmaps), sizeof(wmaps));
      if (per_layer_cond && i > 0)
        if (int e = encode_cond_map(&sh.cond, cond_i, B, T_len, C, Cp, Ch, cond_ld, 1)) return e;
    }
    const Layer l = {w_dil[i], b_dil[i], w_rs[i], b_rs[i], wmaps, dils[i], skip_only[i], causal ? -2 : -1};
    if (int e = launch_layer(dtype, l, bufs[i % 2], cond_i, bufs[(i + 1) % 2], skip, &maps[i % 2], &maps[(i + 1) % 2], &sh,
                             B, T_len, C, Cp, Ch, cond_ld, U, static_cast<cudaStream_t>(stream)))
      return e;
  }
  return n_layers;
}
