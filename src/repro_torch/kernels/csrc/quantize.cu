// Stochastic fixed-point quantization and dequantization (paper §II-B).
//
// Replaces the Pallas TPU kernels stochastic_quantize_codes and
// dequantize_codes in src/repro/kernels/quantize.py.
//
// Bound: bytes.  Quantize reads x and u (f32) and writes the int32 code,
// 12 bytes per element for a handful of float operations; dequantize moves
// 8 bytes per element.  At the main path's 4,216,420 elements that is
// 50.6 MB and 33.7 MB, about 15 us and 10 us at 3.35 TB/s.
//
// Design: one element per thread in a grid-stride loop, so neighbouring
// threads touch neighbouring addresses and every load is coalesced; the
// whole tensor is one flat vector, so no padding to the TPU's (512, 128)
// tiles is needed.  The codes must equal the JAX kernel bit for bit, so
// every rounding step is explicit: __fdiv_rn / __fmul_rn / __fadd_rn, rintf
// (half to even, like jnp.round), and the library is built with
// -fmad=false so no multiply-add is contracted.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void quantize_codes_kernel(const float* __restrict__ x,
                                      const float* __restrict__ u,
                                      int* __restrict__ codes, long long n,
                                      float clip, float gain, int stochastic) {
  const float lo = -gain, hi = gain - 1.0f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float xs = fminf(fmaxf(__fdiv_rn(x[i], clip), -1.0f), 1.0f);
    float xq = __fmul_rn(xs, gain);
    float r = stochastic ? floorf(__fadd_rn(xq, u[i])) : rintf(xq);
    codes[i] = (int)fminf(fmaxf(r, lo), hi);
  }
}

__global__ void dequantize_codes_kernel(const int* __restrict__ codes,
                                        float* __restrict__ out, long long n,
                                        float inv_gain) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = __fmul_rn((float)codes[i], inv_gain);
  }
}

}  // namespace

extern "C" {

// u may be null when stochastic == 0.  Returns cudaGetLastError().
int repro_quantize_codes(const void* x, const void* u, void* codes,
                         long long n, float clip, int bits, int stochastic,
                         void* stream) {
  if (n > 0) {
    float gain = (float)(1 << (bits - 1));
    quantize_codes_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)x, (const float*)u, (int*)codes, n, clip, gain,
        stochastic);
  }
  return (int)cudaGetLastError();
}

int repro_dequantize_codes(const void* codes, void* out, long long n,
                           float inv_gain, void* stream) {
  if (n > 0) {
    dequantize_codes_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const int*)codes, (float*)out, n, inv_gain);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
