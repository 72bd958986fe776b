// Wavetable oscillator: table lookup + F0-grid cross-fade, one sample per
// thread.
//
// Replaces the TPU kernel mbexwn_vocoder_tpu/ops/pallas_oscillator.py
// (oscillator_fused, body _osc_kernel).  Per sample, from the phase in
// [0, 1) and the F0 in Hz:
//   p   = phase * (n_wavetable - 1),  j = floor(p),  f = p - j
//   gp  = log(clip(F0 / nominal_f0, min_tr, max_tr)) / log(grid_factor)
//   out = sum over the two grid columns g = floor(gp), floor(gp) + 1 of
//         max(0, 1 - |gp - g|) * ((1 - f) * table[j][g] + f * table[j + 1][g])
// which is the tent-weighted sum over every table row and grid column that
// the TPU kernel evaluates as a matmul, restricted to its non-zero terms.
//
// What bounds it on the H100: memory and launch.  It reads 8 bytes and
// writes 4 bytes per sample (77k samples per 512-frame utterance, ~0.9 MB),
// about 0.3 us of HBM time, so one launch costs more than the work.  The
// design keeps the whole (513 x 13) fp32 table (26.7 KB) in shared memory,
// loaded once per block, does the 2-tap reads there, and touches device
// memory only for the phase, the F0 and the output, each once, coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) oscillator_kernel(
    const float* __restrict__ phase, const float* __restrict__ freq, const float* __restrict__ tables,
    float* __restrict__ out, long long n, int n_wavetable, int n_grid, float nominal_f0, float min_tr,
    float max_tr, float log_grid_norm) {
  extern __shared__ float tab[];
  const int n_tab = n_wavetable * n_grid;
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const float n_period = static_cast<float>(n_wavetable - 1);
  const float inv_nominal = 1.0f / nominal_f0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    // every step rounds on its own (no FMA contraction), in the order of
    // the plain version's tensor ops, so the two agree to the last bits
    const float pw = __fmul_rn(phase[i], n_period);
    int j = static_cast<int>(floorf(pw));
    j = min(max(j, 0), n_wavetable - 2);
    const float f = __fsub_rn(pw, static_cast<float>(j));
    const float omf = __fsub_rn(1.0f, f);

    // PyTorch divides by a scalar as a multiply by its fp32 reciprocal
    const float ratio = fminf(fmaxf(__fmul_rn(freq[i], inv_nominal), min_tr), max_tr);
    const float gp = __fmul_rn(logf(ratio), log_grid_norm);
    const int g0 = static_cast<int>(floorf(gp));

    const float* row0 = tab + j * n_grid;
    const float* row1 = row0 + n_grid;
    float acc = 0.0f;
#pragma unroll
    for (int g = g0; g <= g0 + 1; ++g) {
      if (g < 0 || g >= n_grid) continue;
      const float w = __fsub_rn(1.0f, fabsf(__fsub_rn(gp, static_cast<float>(g))));
      const float v = __fadd_rn(__fmul_rn(row0[g], omf), __fmul_rn(row1[g], f));
      acc = __fadd_rn(acc, __fmul_rn(v, fmaxf(w, 0.0f)));
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" int mbexwn_oscillator(const void* phase, const void* freq, const void* tables, void* out,
                                 long long n, int n_wavetable, int n_grid, float nominal_f0, float min_tr,
                                 float max_tr, float log_grid_norm, void* stream) {
  const size_t smem = static_cast<size_t>(n_wavetable) * n_grid * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(oscillator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 8) blocks = 132LL * 8;  // grid-stride beyond 8 blocks per SM
  oscillator_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phase), static_cast<const float*>(freq), static_cast<const float*>(tables),
      static_cast<float*>(out), n, n_wavetable, n_grid, nominal_f0, min_tr, max_tr, log_grid_norm);
  return static_cast<int>(cudaGetLastError());
}
