// int8 x int8 -> int32 quantized matrix product with a per-tensor
// dequantize: out = float32(x_q @ w_q) * (sx * sw).
//
// Replaces the Pallas TPU kernel qmatmul in src/repro/kernels/qmatmul.py
// (128 x 128 x 128 blocks on the MXU, the int32 sum kept in the output
// block across the sequential K steps).
//
// Bound: at the shapes it is called with, (960, 3136, 128) and
// (256, 512, 256), bytes: (M*K + K*N + 4*M*N) at 3.35 TB/s is 1.2 and
// 0.5 us, and 2*M*N*K int8 operations at 1,979 TOP/s are 0.39 and 0.07 us,
// so both are bound by the launch.
//
// Design: simple and exact.  A block owns a 32 x 32 tile of the output;
// blocks run in parallel, so the sequential K grid axis of the TPU kernel
// becomes a loop inside the block.  Each step stages a 32 x 32 tile of x
// and of w in shared memory, four consecutive k packed in one 32-bit word
// for both (w transposed on the way in), with the ragged edges zero-filled;
// each of the 256 threads then accumulates a 2 x 2 block of outputs with
// __dp4a, four int8 products into an int32 sum per instruction.  The sum
// is exact (|sum| <= K * 2^14), converted once with __int2float_rn and
// scaled with __fmul_rn, as the reference's acc.astype(f32) * (sx * sw).
// Tensor cores (mma.sync / wgmma on int8) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;               // output tile edge and k step
constexpr int kWords = kTile / 4;       // packed words along k per step
constexpr int kThreads = 256;

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
               ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24));
}

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all row-major.
__global__ void qmatmul_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ w,
                               float* __restrict__ out, int M, int N, int K,
                               float scale) {
  __shared__ int xs[kTile][kWords + 1];   // [m][k/4]
  __shared__ int ws[kTile][kWords + 1];   // [n][k/4]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = tid % 16, ty = tid / 16;
  // the word this thread stages: x row lm, word lkx; w column ln, word lkw
  const int lm = tid / kWords, lkx = tid % kWords;
  const int ln = tid % kTile, lkw = tid / kTile;
  int acc[2][2] = {{0, 0}, {0, 0}};
  for (int k0 = 0; k0 < K; k0 += kTile) {
    {
      const int m = m0 + lm, k = k0 + 4 * lkx;
      int8_t v[4] = {0, 0, 0, 0};
      if (m < M) {
        const int8_t* row = x + (long long)m * K;
        for (int t = 0; t < 4; ++t) v[t] = (k + t < K) ? row[k + t] : 0;
      }
      xs[lm][lkx] = pack4(v[0], v[1], v[2], v[3]);
    }
    {
      const int n = n0 + ln, k = k0 + 4 * lkw;
      int8_t v[4] = {0, 0, 0, 0};
      if (n < N) {
        for (int t = 0; t < 4; ++t)
          v[t] = (k + t < K) ? w[(long long)(k + t) * N + n] : 0;
      }
      ws[ln][lkw] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      const int a0 = xs[ty][kw], a1 = xs[ty + 16][kw];
      const int b0 = ws[tx][kw], b1 = ws[tx + 16][kw];
      acc[0][0] = __dp4a(a0, b0, acc[0][0]);
      acc[0][1] = __dp4a(a0, b1, acc[0][1]);
      acc[1][0] = __dp4a(a1, b0, acc[1][0]);
      acc[1][1] = __dp4a(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N)
        out[(long long)m * N + n] = __fmul_rn(__int2float_rn(acc[i][j]), scale);
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError().  scale = float32(sx) * float32(sw).
int repro_qmatmul(const void* x, const void* w, void* out, int M, int N,
                  int K, float scale, void* stream) {
  if (M > 0 && N > 0) {
    dim3 grid((unsigned)((N + kTile - 1) / kTile),
              (unsigned)((M + kTile - 1) / kTile));
    qmatmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (float*)out, M, N, K, scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
