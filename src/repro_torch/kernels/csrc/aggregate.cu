// Error-aware masked weighted aggregation (paper eq. 6):
//   out[d] = sum_k w_k * u[k, d] / max(sum_k w_k, eps),  w_k = alpha_k * lambda_k
//
// Replaces the Pallas TPU kernel masked_aggregate in
// src/repro/kernels/aggregate.py.
//
// Bound: bytes.  Each update is read once and each output written once,
// 4*K*D + 4*D bytes for 2*K*D float operations; at the main path's K=10,
// D=421,642 that is 18.6 MB, about 5.5 us at 3.35 TB/s.
//
// Design: one thread per column d, looping k = 0..K-1 over the row-major
// (K, D) matrix, so for every k neighbouring threads read neighbouring
// addresses.  The K weights are staged once per block in shared memory and
// summed by every thread in the same fixed order, so the denominator is the
// same in every block and no second pass or atomic is needed.  Updates may
// be float32 or int32 (a template parameter), as in the TPU kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

template <typename T>
__global__ void masked_aggregate_kernel(const T* __restrict__ updates,
                                        const float* __restrict__ weights,
                                        float* __restrict__ out, int K,
                                        long long D, float eps) {
  extern __shared__ float w[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) w[k] = weights[k];
  __syncthreads();
  float den = 0.0f;
  for (int k = 0; k < K; ++k) den = __fadd_rn(den, w[k]);
  den = fmaxf(den, eps);
  for (long long d = blockIdx.x * (long long)blockDim.x + threadIdx.x; d < D;
       d += (long long)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(w[k], (float)updates[k * D + d]));
    out[d] = __fdiv_rn(acc, den);
  }
}

template <typename T>
int launch(const void* updates, const void* weights, void* out, int K,
           long long D, float eps, void* stream) {
  if (D > 0) {
    long long b = (D + kThreads - 1) / kThreads;
    int blocks = (int)(b < kMaxBlocks ? b : kMaxBlocks);
    masked_aggregate_kernel<T><<<blocks, kThreads, K * sizeof(float),
                                 (cudaStream_t)stream>>>(
        (const T*)updates, (const float*)weights, (float*)out, K, D, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError().
int repro_masked_aggregate_f32(const void* updates, const void* weights,
                               void* out, int K, long long D, float eps,
                               void* stream) {
  return launch<float>(updates, weights, out, K, D, eps, stream);
}

int repro_masked_aggregate_i32(const void* updates, const void* weights,
                               void* out, int K, long long D, float eps,
                               void* stream) {
  return launch<int>(updates, weights, out, K, D, eps, stream);
}

}  // extern "C"
