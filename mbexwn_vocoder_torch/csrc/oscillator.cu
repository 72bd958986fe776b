// The whole wavetable oscillator stage in one launch: F0 -> chunked, mod-1
// wrapped phase -> table lookup -> F0-grid cross-fade -> audio.
//
// Replaces the TPU kernel mbexwn_vocoder_tpu/ops/pallas_oscillator.py
// (oscillator_fused, body _osc_kernel: lookup + cross-fade) together with the
// phase accumulation that the JAX package runs before it in plain XLA
// (ops/oscillator.py, stable_cumsum_and_wrap).  Per row of F0 (Hz, at the
// oscillator's sample rate sr), in the rounding steps of the port's plain
// version (ops/oscillator.py, oscillate_plain):
//   v      = f0 * fp32(1/sr)                          (phase increment)
//   chunks of 1000 samples: s = fp32(inclusive fp64 prefix of v in the chunk)
//   r[c]   = remainder(s[last of chunk c], 1)
//   off[c] = remainder(fp32(sum over k < c of r[k], in fp64), 1)
//   phase  = remainder(s + off[c], 1), then remainder(phase + phase_offset, 1)
//   p   = phase * (n_wavetable - 1),  j = floor(p),  f = p - j
//   gp  = log(clip(F0 / nominal_f0, min_tr, max_tr)) / log(grid_factor)
//   out = sum over the two grid columns g = floor(gp), floor(gp) + 1 of
//         max(0, 1 - |gp - g|) * ((1 - f) * table[j][g] + f * table[j + 1][g])
// The last two lines are the tent-weighted sum over every table row and grid
// column that the TPU kernel evaluates as a matmul, restricted to its
// non-zero terms.
//
// Exactness of the scan.  For 1 Hz <= F0 <= 12 kHz and sr = 12 kHz every increment is
// an fp32 number whose lowest bit is >= 2^-37, and every partial sum of a
// chunk (and of the <= 2^16 chunk remainders of a row, each < 1) stays below
// 2^16, so all of them fit in fp64's 53 bits: the fp64 sums are exact in any
// order.  A parallel scan rounded once to fp32 therefore gives the plain
// version's phase bit for bit, and every later step rounds as the plain
// version's tensor ops do (no FMA contraction).
//
// What bounds it on the H100: launch latency.  It reads 4 bytes of F0 and
// writes 4 bytes of audio per sample plus the table once: at 512 mel frames
// (76,800 samples) and a 513 x 13 table, 0.64 MB, 0.19 us at 3.35 TB/s,
// below the device time of one launch.  So the design takes work off the
// path rather than bytes: one cooperative launch does the phase, its
// cross-chunk carry and the lookup; each 256-thread CTA owns one
// (row, 1000-sample chunk) at a time, 4 samples a thread.
//   Phase A: scan the chunk in fp64 (thread, warp shuffles, then across the
//     8 warps through shared memory), publish r[c] to a scratch of B x
//     n_chunks floats.
//   One grid-wide barrier (cg::this_grid().sync()).
//   Phase B: sum the row's earlier r[k] in fp64, wrap, add to the chunk's
//     prefix (kept in registers when a CTA owns one chunk, else scanned
//     again from L2), look up and write audio (and the phase if asked).
// The table goes to shared memory with one bulk asynchronous copy per CTA
// (cp.async.bulk on an mbarrier) issued at CTA start, so it lands while
// phase A runs; the <= 3 floats past its last 16-byte boundary are copied
// by plain loads.  The grid is as many CTAs as fit on the card at once
// (occupancy query), at most one per chunk, and loops over chunks beyond
// that, so any batch and length run in the one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1000;  // the plain version's chunk_size
constexpr int kPer = 4;       // samples a thread
static_assert(kThreads * kPer >= kChunk, "a CTA covers a chunk in one pass");
constexpr int kMaxSmem = 232448;  // what a block may use on the H100
constexpr int kStaticSmem = 1024;  // kept free for the kernel's static shared memory

struct Params {
  const float* f0;            // (n_rows, n_time)
  const float* tables;        // (n_wavetable, n_grid), 16-byte aligned
  const float* phase_offset;  // (n_rows,) or null
  float* out;                 // (n_rows, n_time)
  float* phase_out;           // (n_rows, n_time) or null
  float* chunk_rem;           // (n_rows, n_chunks) scratch, every entry written in phase A
  long long n_time;
  int n_rows, n_chunks, n_wavetable, n_grid, bulk_bytes;
  float inv_sr, inv_nominal, min_tr, max_tr, log_grid_norm;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin until the barrier's phase differs from `parity`; a wait that outlasts
// any real one by orders of magnitude traps instead of hanging the card.
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

// torch.remainder(a, 1.0) in fp32: fmod (exact), then a negative result
// moved up by one
__device__ __forceinline__ float wrap1(float a) {
  float m = fmodf(a, 1.0f);
  if (m < 0.0f) m = __fadd_rn(m, 1.0f);
  return m;
}

// Block-wide sum of one fp64 value a thread (exact for the values summed
// here, so the order does not matter).
__device__ __forceinline__ double block_sum(double x, double* red) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();  // red is reused by the next call
  return total;
}

// Inclusive fp64 prefix sums of the chunk at the thread's 4 samples, and the
// chunk's total.  f0 of samples past the chunk or the row is 0.
__device__ __forceinline__ double chunk_scan(const float (&v)[kPer], double (&s)[kPer], double* red) {
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    run += static_cast<double>(v[k]);
    s[k] = run;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  double before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.0;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const double t = red[w];
    if (w < warp) before += t;
    total += t;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) s[k] += before;
  return total;
}

__device__ __forceinline__ void load_chunk(const Params& p, int row, int c, float (&f)[kPer], float (&v)[kPer]) {
  const long long t0 = static_cast<long long>(c) * kChunk;
  const float* src = p.f0 + static_cast<long long>(row) * p.n_time + t0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x * kPer + k;
    f[k] = (i < kChunk && t0 + i < p.n_time) ? src[i] : 0.0f;
    v[k] = __fmul_rn(f[k], p.inv_sr);
  }
}

// lookup in the table (rows: phase, columns: F0 grid) and cross-fade, each
// step rounded on its own in the order of the plain version's tensor ops
__device__ __forceinline__ float lookup(const Params& p, const float* tab, float phase, float freq) {
  const float pw = __fmul_rn(phase, static_cast<float>(p.n_wavetable - 1));
  int j = static_cast<int>(floorf(pw));
  j = min(max(j, 0), p.n_wavetable - 2);
  const float f = __fsub_rn(pw, static_cast<float>(j));
  const float omf = __fsub_rn(1.0f, f);
  // PyTorch divides by a scalar as a multiply by its fp32 reciprocal
  const float ratio = fminf(fmaxf(__fmul_rn(freq, p.inv_nominal), p.min_tr), p.max_tr);
  const float gp = __fmul_rn(logf(ratio), p.log_grid_norm);
  const int g0 = static_cast<int>(floorf(gp));
  const float* row0 = tab + j * p.n_grid;
  const float* row1 = row0 + p.n_grid;
  float acc = 0.0f;
#pragma unroll
  for (int g = g0; g <= g0 + 1; ++g) {
    if (g < 0 || g >= p.n_grid) continue;
    const float w = __fsub_rn(1.0f, fabsf(__fsub_rn(gp, static_cast<float>(g))));
    const float val = __fadd_rn(__fmul_rn(row0[g], omf), __fmul_rn(row1[g], f));
    acc = __fadd_rn(acc, __fmul_rn(val, fmaxf(w, 0.0f)));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) oscillate_kernel(const Params p) {
  extern __shared__ __align__(128) float tab[];
  __shared__ __align__(8) uint64_t tab_bar;
  __shared__ double red[kWarps];

  // the table: one bulk copy of its 16-byte-aligned head, on an mbarrier,
  // waited for only before the lookup; the tail by plain loads
  const uint32_t bar = smem_u32(&tab_bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (p.bulk_bytes > 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(p.bulk_bytes)
                   : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                       smem_u32(tab)),
                   "l"(p.tables), "r"(p.bulk_bytes), "r"(bar)
                   : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
    }
  }
  const int n_tab = p.n_wavetable * p.n_grid;
  for (int i = p.bulk_bytes / 4 + threadIdx.x; i < n_tab; i += kThreads) tab[i] = p.tables[i];

  const int n_units = p.n_rows * p.n_chunks;
  // a CTA that owns one chunk keeps its F0 and prefix in registers across the barrier
  const bool single = n_units == static_cast<int>(gridDim.x);
  float f[kPer], v[kPer];
  double s[kPer];

  // phase A: each chunk's total, wrapped, to the scratch
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    load_chunk(p, u / p.n_chunks, u % p.n_chunks, f, v);
    const double total = chunk_scan(v, s, red);
    if (threadIdx.x == 0) p.chunk_rem[u] = wrap1(__double2float_rn(total));
  }

  cg::this_grid().sync();
  mbar_wait(bar, 0);

  // phase B: the carry of the earlier chunks, then phase, lookup, cross-fade
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int row = u / p.n_chunks, c = u % p.n_chunks;
    double prior = 0.0;
    for (int k = threadIdx.x; k < c; k += kThreads)
      prior += static_cast<double>(__ldcg(p.chunk_rem + static_cast<long long>(row) * p.n_chunks + k));
    if (!single) {
      load_chunk(p, row, c, f, v);
      chunk_scan(v, s, red);
    }
    const float off = wrap1(__double2float_rn(block_sum(prior, red)));
    const float row_off = p.phase_offset ? p.phase_offset[row] : 0.0f;
    const long long t0 = static_cast<long long>(c) * kChunk;
    const long long base = static_cast<long long>(row) * p.n_time + t0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x * kPer + k;
      if (i >= kChunk || t0 + i >= p.n_time) continue;
      float phase = wrap1(__fadd_rn(__double2float_rn(s[k]), off));
      if (p.phase_offset) phase = wrap1(__fadd_rn(phase, row_off));
      if (p.phase_out) p.phase_out[base + i] = phase;
      p.out[base + i] = lookup(p, tab, phase, f[k]);
    }
  }
}

// The practical floor of a launch, for timing beside the kernel: an empty
// kernel, or (grid_sync) a cooperative one that only crosses one grid-wide
// barrier.
__global__ void empty_kernel() {}
__global__ void __launch_bounds__(kThreads) grid_sync_kernel() { cg::this_grid().sync(); }

int max_resident_blocks(int smem) {
  // per device: the dynamic shared memory the count was taken for, and the
  // count.  The current device is the tensors' (the caller enters it).
  static int cached_smem[64], cached_blocks[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < 64 && cached_smem[dev] == smem + 1) return cached_blocks[dev];
  int n_sm = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, oscillate_kernel, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < 64) {
    cached_blocks[dev] = per_sm * n_sm;
    cached_smem[dev] = smem + 1;
  }
  return per_sm * n_sm;
}

}  // namespace

extern "C" int mbexwn_oscillate(const void* f0, const void* tables, const void* phase_offset, void* out,
                                void* phase_out, void* chunk_rem, int n_rows, long long n_time, int chunk,
                                int n_wavetable, int n_grid, float inv_sr, float nominal_f0, float min_tr,
                                float max_tr, float log_grid_norm, void* stream) {
  const long long n_chunks = (n_time + kChunk - 1) / kChunk;
  const long long table_bytes = 4LL * n_wavetable * n_grid;
  const int smem = static_cast<int>((table_bytes + 15) / 16 * 16);
  if (chunk != kChunk || n_rows <= 0 || n_time <= 0 || n_wavetable < 2 || n_grid < 1 ||
      table_bytes > kMaxSmem - kStaticSmem || n_rows * n_chunks > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(tables) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(oscillate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int resident = max_resident_blocks(smem);
  if (resident <= 0) return resident < 0 ? -resident : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long n_units = n_rows * n_chunks;
  const int grid = static_cast<int>(n_units < resident ? n_units : resident);

  Params p;
  p.f0 = static_cast<const float*>(f0);
  p.tables = static_cast<const float*>(tables);
  p.phase_offset = static_cast<const float*>(phase_offset);
  p.out = static_cast<float*>(out);
  p.phase_out = static_cast<float*>(phase_out);
  p.chunk_rem = static_cast<float*>(chunk_rem);
  p.n_time = n_time;
  p.n_rows = n_rows;
  p.n_chunks = static_cast<int>(n_chunks);
  p.n_wavetable = n_wavetable;
  p.n_grid = n_grid;
  p.bulk_bytes = static_cast<int>(table_bytes / 16 * 16);
  p.inv_sr = inv_sr;
  p.inv_nominal = 1.0f / nominal_f0;
  p.min_tr = min_tr;
  p.max_tr = max_tr;
  p.log_grid_norm = log_grid_norm;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(oscillate_kernel), dim3(grid),
                                                    dim3(kThreads), args, static_cast<size_t>(smem),
                                                    static_cast<cudaStream_t>(stream));
  // a refused launch also sets the runtime's last error: clear it, so that
  // the next PyTorch launch check does not report it again
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" int mbexwn_floor_launch(int grid_sync, int blocks, void* stream) {
  cudaError_t e;
  if (grid_sync) {
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_sync_kernel), dim3(blocks), dim3(kThreads),
                                    nullptr, 0, static_cast<cudaStream_t>(stream));
  } else {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

