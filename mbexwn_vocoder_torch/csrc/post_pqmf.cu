// K3: MBExWN's post net and PQMF synthesis in one launch.
//
// Replaces no TPU kernel: the JAX package runs this stage in plain XLA
// (models/mbexwn.py generate_excitation: wn_post_net, the multiband gains,
// ops/pqmf_ops.py pqmf_synthesis), and so did the port's plain version
// (ops/post_pqmf.py post_pqmf_plain).  It was added because on the H100 the
// plain version's synthesis is one zero-stuffed fp32 conv with one output
// channel, for which cuDNN picks its generic fallback: ~3.9 ms of a batch-8,
// 1024-frame group, ~120x the stage's bound, five of every six
// multiply-adds on stuffed zeros.
//
// Per request and sub-band row t of x (B, T, Cin) and each used band s:
//   y[t, s] = (g[s] * (W[s] . x[t]) + bias[s]) * mb_gain[t, s] * S
// (g, bias and mb_gain optional; each product and sum after the dot product
// rounded on its own, as the plain version's separate ops round), and output
// sample n = S q + r (0 <= r < S) of the synthesis, the correlation of the
// zero-stuffed y, padded by P = taps / 2 on each side, with the (used,
// taps + 1) filter h:
//   out[n] = sum over s and d of h[s][S d + P - r] * y[q + d, s]
// over the d with 0 <= S d + P - r <= taps; rows q + d outside [0, T) are
// the padding's zeros.  That is ~(taps + 1) / S taps a band (16 at S = 6,
// taps = 94, d in [-7, 8]) where the zero-stuffed conv multiplies all of
// them.  Every operation is an fp32 FMA or product: only the order of the
// sums differs from the plain version's.
//
// What bounds it on the H100: bytes.  x is read once (4 Cin bytes a row)
// and the audio written once (4 S bytes a row): 114.7 MB at batch 8 of a
// 1024-frame bucket (Cin = 64, S = 6), 34 us at 3.35 TB/s, against ~0.39 G
// FMAs, 12 us at 67 TFLOP/s.  So the design makes one pass over x and
// keeps every intermediate on chip.  x comes channel-major, (B, Cin, T)
// in memory, as the WaveNet's end conv leaves it on the main path, or
// row-major, (B, T, Cin); a copy into either layout would move its bytes
// twice more.  One CTA of 128 threads per (request, tile of R output rows):
//   phase 0: cp.async copies the tile's x rows, a halo of kPhaseTaps - 1 rows
//     and up to 3 more that align the tile to 16 bytes (R + kPhaseTaps + 4 <= 256
//     rows), into shared memory, channel-major: 16-byte copies along each
//     channel's rows (channel-major x with T % 4 == 0), else 4-byte ones.
//     Meanwhile the weights, transposed to (Cin, 8), and the polyphase
//     filter hp[r][s][d] = h[s][S (dmin + d) + P - r] (zero outside the
//     filter) go to shared memory;
//   phase 1: each thread forms the sub-band values of two rows (the
//     weights broadcast from shared memory, the rows read without bank
//     conflicts), zero outside [0, T); they replace x in shared memory,
//     band-major;
//   phase 2: each thread owns one phase r and Q consecutive output rows,
//     holds hp[r][s][.] in registers a band at a time and slides over the
//     rows: Q x kPhaseTaps FMAs a band from Q + kPhaseTaps - 1 shared loads.
//     The outputs are staged in shared memory and written coalesced.
// kPhaseTaps = 16 taps a phase covers every configuration's bank (6 bands,
// 94 taps: 16); a filter with fewer reads zeros for the rest, one with more
// is refused.  At Cin = 64 a CTA holds 69 KB of shared
// memory, three to an SM; batch 8 x 51,200 rows make 1,800 CTAs, ~4.5
// waves; a live chunk's ~2,500 rows make 11.  The kernel launches on the caller's
// stream, allocates nothing and does not synchronise, so a captured CUDA
// graph replays it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;                    // phase 1
constexpr int kMaxRows = kThreads * kRowsPerThread;  // x rows a CTA holds: R + kPhaseTaps + 4 at most
constexpr int kQ = 12;                               // output rows a thread accumulates (phase 2), a multiple of 4
constexpr int kBands = 8;                            // used sub-bands at most; the weights are padded to it
constexpr int kPhaseTaps = 16;                       // polyphase taps a phase at most
constexpr int kXBudget = 64 * 252 * 4;               // bytes for the x tile: 248 rows (+ 4 of pad) at Cin = 64
constexpr int kMaxSmem = 232448 - 1024;              // a block's shared memory on the H100, less a margin

struct Params {
  const float* x;     // (B, Cin, T) in memory if channel_major, else (B, T, Cin)
  const float* w;     // (S, cin); rows < used are read
  const float* bias;  // (S,) or null
  const float* gain;  // (S,) or null
  const float* mb;    // element (b, t, s) at b * mb_bs + t * mb_ts + s, or null
  const float* h;     // (used, taps + 1)
  float* out;         // (B, T * S)
  long long mb_bs, mb_ts;
  int T, cin, S, used, taps, dmin;
  int channel_major;
  int vec4;      // 16-byte copies: channel-major, T % 4 == 0, x 16-byte aligned
  int rows_out;  // R, a multiple of kQ
  int rows_in;   // R + kPhaseTaps + 4, the tile's rows from a 16-byte aligned first row
  int xstride;   // floats between two channels of the x tile: rows_in + 4
  int region;    // floats of the x tile's region (later the sub-band values and the staged outputs)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kThreads) post_pqmf_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int T = p.T, cin = p.cin, rows = p.rows_in, xs_ld = p.xstride;
  const int t0 = blockIdx.x * p.rows_out;  // the tile's first output row
  const int a0 = (t0 + p.dmin) & ~3;       // the input row of tile row 0 (floor to a multiple of 4)
  const int off = t0 + p.dmin - a0;        // tile row of output row t0's first tap
  const int hstride = p.used * kPhaseTaps + 4;
  float* xs = smem;                    // (cin, xstride): row m of channel c at c * xstride + m
  float* wt = smem + p.region;         // (cin, kBands)
  float* hs = wt + cin * kBands;       // (S, hstride)

  // ---- phase 0: the x tile (asynchronous), the weights and the polyphase filter
  const float* xb = p.x + static_cast<long long>(b) * T * cin;
  if (p.vec4) {
    const int quads = rows / 4;
    for (int u = tid; u < cin * quads; u += kThreads) {
      const int c = u / quads, j = u - c * quads;
      const int t = a0 + 4 * j;
      if (t >= 0 && t < T) cp_async16(xs + c * xs_ld + 4 * j, xb + static_cast<long long>(c) * T + t);
    }
  } else if (p.channel_major) {
    for (int u = tid; u < cin * rows; u += kThreads) {
      const int c = u / rows, m = u - c * rows;
      const int t = a0 + m;
      if (t >= 0 && t < T) cp_async4(xs + c * xs_ld + m, xb + static_cast<long long>(c) * T + t);
    }
  } else {
    for (int u = tid; u < rows * cin; u += kThreads) {
      const int m = u / cin, c = u - m * cin;
      const int t = a0 + m;
      if (t >= 0 && t < T) cp_async4(xs + c * xs_ld + m, xb + static_cast<long long>(t) * cin + c);
    }
  }
  for (int i = tid; i < cin * kBands; i += kThreads) {
    const int c = i / kBands, s = i - c * kBands;
    wt[i] = s < p.used ? p.w[s * cin + c] : 0.f;
  }
  const int half = p.taps / 2;
  for (int i = tid; i < p.S * p.used * kPhaseTaps; i += kThreads) {
    const int r = i / (p.used * kPhaseTaps), rest = i - r * p.used * kPhaseTaps;
    const int s = rest / kPhaseTaps, d = rest - s * kPhaseTaps;
    const int k = p.S * (p.dmin + d) + half - r;
    hs[r * hstride + s * kPhaseTaps + d] = (k >= 0 && k <= p.taps) ? p.h[s * (p.taps + 1) + k] : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- phase 1: the sub-band values of tile rows tid and tid + 128
  float acc[kRowsPerThread][kBands];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int s = 0; s < kBands; ++s) acc[i][s] = 0.f;
  int mr[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) mr[i] = min(tid + i * kThreads, rows - 1);
#pragma unroll 4
  for (int c = 0; c < cin; ++c) {
    const float4 wa = *reinterpret_cast<const float4*>(wt + c * kBands);
    const float4 wb = *reinterpret_cast<const float4*>(wt + c * kBands + 4);
    const float w8[kBands] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float xv = xs[c * xs_ld + mr[i]];
#pragma unroll
      for (int s = 0; s < kBands; ++s) acc[i][s] = fmaf(xv, w8[s], acc[i][s]);
    }
  }
  const float scale = static_cast<float>(p.S);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = tid + i * kThreads;
    const int t = a0 + m;
    const bool valid = m < rows && t >= 0 && t < T;
#pragma unroll
    for (int s = 0; s < kBands; ++s) {
      if (s < p.used) {
        float v = acc[i][s];
        if (p.gain) v = __fmul_rn(p.gain[s], v);
        if (p.bias) v = __fadd_rn(v, p.bias[s]);
        if (p.mb && valid) v = __fmul_rn(v, p.mb[b * p.mb_bs + t * p.mb_ts + s]);
        acc[i][s] = valid ? __fmul_rn(v, scale) : 0.f;
      }
    }
  }
  __syncthreads();  // every x row is read: the sub-band values take its place
  float* ys = smem;  // (used, rows)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = tid + i * kThreads;
    if (m < rows) {
#pragma unroll
      for (int s = 0; s < kBands; ++s)
        if (s < p.used) ys[s * rows + m] = acc[i][s];
    }
  }
  __syncthreads();

  // ---- phase 2: the polyphase synthesis, Q output rows of one phase a thread
  float* outs = smem + p.used * rows;  // (R, S), the tile's output samples in order
  const int items = (p.rows_out / kQ) * p.S;
  for (int item = tid; item < items; item += kThreads) {
    const int r = item % p.S, q0 = (item / p.S) * kQ;
    float sum[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) sum[j] = 0.f;
    for (int s = 0; s < p.used; ++s) {
      float hr[kPhaseTaps];
      const float* hp = hs + r * hstride + s * kPhaseTaps;
#pragma unroll
      for (int d = 0; d < kPhaseTaps; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(hp + d);
        hr[d] = v.x;
        hr[d + 1] = v.y;
        hr[d + 2] = v.z;
        hr[d + 3] = v.w;
      }
      const float* yr = ys + s * rows + q0 + off;
#pragma unroll
      for (int m = 0; m < kQ + kPhaseTaps - 1; ++m) {
        const float v = yr[m];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          if (m - j >= 0 && m - j < kPhaseTaps) sum[j] = fmaf(hr[m - j], v, sum[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) outs[(q0 + j) * p.S + r] = sum[j];
  }
  __syncthreads();
  const int n_out = min(p.rows_out, T - t0) * p.S;
  float* ob = p.out + (static_cast<long long>(b) * T + t0) * p.S;
  for (int i = tid; i < n_out; i += kThreads) ob[i] = outs[i];
}

int launch(Params p, int B, void* stream) {
  const int chan_bytes = 4 * p.cin;  // a tile row's bytes, over all channels
  const int rows_max = kXBudget / chan_bytes - 4 < kMaxRows ? kXBudget / chan_bytes - 4 : kMaxRows;
  p.rows_out = (rows_max - kPhaseTaps - 4) / kQ * kQ;
  if (p.rows_out < kQ) p.rows_out = kQ;  // a wide x: the smallest tile, if it fits at all
  p.rows_in = p.rows_out + kPhaseTaps + 4;
  p.xstride = p.rows_in + 4;
  const int x_floats = p.cin * p.xstride;
  const int y_floats = p.used * p.rows_in + p.rows_out * p.S;
  p.region = ((x_floats > y_floats ? x_floats : y_floats) + 3) / 4 * 4;
  const long long smem = 4LL * (p.region + p.cin * kBands + p.S * (p.used * kPhaseTaps + 4));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(post_pqmf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.T + p.rows_out - 1) / p.rows_out, B);
  post_pqmf_kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Enqueue K3 on `stream`: out (B, T * S) from x (B, T, cin) (channel_major:
// stored as (B, cin, T)), the post net's (S, cin) weights, its bias and
// equalized-LR gain (S,) or null, the multiband gain (element (b, t, s) at
// b * mb_bs + t * mb_ts + s) or null, and the (used, taps + 1) synthesis
// filter.  Every pointer is fp32 device memory of the current device.
// Returns 0 or a cudaError.
extern "C" int mbexwn_post_pqmf(const void* x, int channel_major, const void* w, const void* bias, const void* gain,
                                const void* mb, long long mb_bs, long long mb_ts, const void* h, void* out, int B,
                                int T, int cin, int S, int used, int taps, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || cin <= 0 || S <= 0 || used <= 0 || used > S || used > kBands || taps < 0 ||
      taps % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = taps / 2;
  const int dmin = -(half / S);
  const int n_taps = (half + S - 1) / S - dmin + 1;  // polyphase taps a phase: d in [dmin, (half + S - 1) / S]
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.gain = static_cast<const float*>(gain);
  p.mb = static_cast<const float*>(mb);
  p.h = static_cast<const float*>(h);
  p.out = static_cast<float*>(out);
  p.mb_bs = mb_bs;
  p.mb_ts = mb_ts;
  p.T = T;
  p.cin = cin;
  p.S = S;
  p.used = used;
  p.taps = taps;
  p.dmin = dmin;
  p.channel_major = channel_major != 0;
  p.vec4 = p.channel_major && T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (n_taps > kPhaseTaps) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, B, stream);
}
