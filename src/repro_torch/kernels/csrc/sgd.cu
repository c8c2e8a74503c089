// The float32 SGD step, in place: w[i] = fma(-eta, g[i], w[i]), rounded once.
//
// Replaces no Pallas kernel.  It replaces XLA's fused update of the
// reference's local step, w - eta * g.astype(w.dtype)
// (src/repro/core/fl.py:185 and :620, src/repro/launch/steps.py:31):
// XLA:CPU contracts that multiply and subtract into one fused multiply-add,
// so the reference rounds once where a PyTorch mul and sub round twice
// (ROADMAP C5).  -fmad=false stops only the compiler's contraction: the
// explicit __fmaf_rn is one fused multiply-add.  neg_eta is the float32
// learning rate negated on the host (exact), so the result is the correctly
// rounded w - eta*g, as the plain version (kernels/ref.py fma32, an exact
// float32 FMA) computes it: the two are equal bit for bit.
//
// Bound: bytes.  Each weight is read and written once and each gradient
// read once, 12 bytes an element for 2 float operations; at the QNN's local
// step, (10, 421,642) float32, 50.6 MB, about 15.1 us at 3.35 TB/s.
//
// Design: `rows` rows of n elements, row r of w at w + r*w_stride and of g
// at g + r*g_stride (a leaf of the flat (K, D) parameters is such a strided
// view; a contiguous tensor is one row).  Where both pointers sit on a
// 16-byte boundary and n and both strides are multiples of 4, every row
// starts on one: a thread owns kVecs float4 vectors of a tile, kThreads
// apart (neighbouring threads on neighbouring vectors), and issues all its
// loads before its first FMA.  Otherwise the same loop runs on single
// elements.  One wave of resident blocks walks the tiles, a tile within one
// row; one row needs no division, and one row of fewer than 2^31 vectors
// (the QNN's step) takes int indices.

#include <cuda_runtime.h>

#include "quantizer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;
constexpr long long kTile = (long long)kThreads * kVecs;

__device__ __forceinline__ float step(float w, float g, float neg_eta) {
  return __fmaf_rn(neg_eta, g, w);
}

__device__ __forceinline__ float4 step(float4 w, float4 g, float neg_eta) {
  return make_float4(step(w.x, g.x, neg_eta), step(w.y, g.y, neg_eta),
                     step(w.z, g.z, neg_eta), step(w.w, g.w, neg_eta));
}

// T is float4 on the 16-byte path, else float; n and the strides count Ts.
// I, the index type, is int where every index fits (one row of fewer than
// 2^31 Ts, the QNN's step), else long long.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
sgd_step_kernel(T* __restrict__ w, const T* __restrict__ g, I rows, I n,
                I w_stride, I g_stride, float neg_eta) {
  const I per_row = (n + (I)kTile - 1) / (I)kTile;
  const I tiles = rows * per_row;
  for (I t = blockIdx.x; t < tiles; t += gridDim.x) {
    // one row (a contiguous tensor, the QNN's step) needs no division
    const I r = rows == 1 ? 0 : t / per_row;
    const I base = (t - r * per_row) * (I)kTile + (I)threadIdx.x;
    T* wr = w + r * w_stride;
    const T* gr = g + r * g_stride;
    T a[kVecs], b[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const I i = base + (I)j * kThreads;
      if (i < n) {
        a[j] = wr[i];
        b[j] = gr[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const I i = base + (I)j * kThreads;
      if (i < n) wr[i] = step(a[j], b[j], neg_eta);
    }
  }
}

bool vector_path(const void* w, const void* g, long long n, long long ws,
                 long long gs) {
  return (reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(g) % 16 == 0 && n % 4 == 0 &&
          ws % 4 == 0 && gs % 4 == 0);
}

template <typename T, typename I>
int wave_blocks(long long tiles) {
  static int cache[kMaxDevices];
  return one_wave((const void*)sgd_step_kernel<T, I>, kThreads, cache, tiles);
}

long long tiles_of(long long rows, long long n) {
  return rows * ((n + kTile - 1) / kTile);
}

// Launches sgd_step_kernel<T, I> (n and the strides in Ts) and returns
// its blocks; with launch false only the blocks.
template <typename T, typename I>
int run(bool launch, void* w, const void* g, long long rows, long long n,
        long long ws, long long gs, float neg_eta, cudaStream_t st) {
  const int blocks = wave_blocks<T, I>(tiles_of(rows, n));
  if (launch)
    sgd_step_kernel<T, I><<<blocks, kThreads, 0, st>>>(
        (T*)w, (const T*)g, (I)rows, (I)n, (I)ws, (I)gs, neg_eta);
  return blocks;
}

// The path for these arguments: 16-byte vectors or single elements, int
// or 64-bit indices; returns the blocks.
int dispatch(bool launch, void* w, const void* g, long long rows,
             long long n, long long ws, long long gs, float neg_eta,
             cudaStream_t st) {
  const bool vec = vector_path(w, g, n, ws, gs);
  const int k = vec ? 4 : 1;
  const bool small = rows == 1 && n / k + kTile < (1LL << 31);
  if (vec && small)
    return run<float4, int>(launch, w, g, rows, n / 4, ws / 4, gs / 4,
                            neg_eta, st);
  if (vec)
    return run<float4, long long>(launch, w, g, rows, n / 4, ws / 4, gs / 4,
                                  neg_eta, st);
  if (small)
    return run<float, int>(launch, w, g, rows, n, ws, gs, neg_eta, st);
  return run<float, long long>(launch, w, g, rows, n, ws, gs, neg_eta, st);
}

}  // namespace

extern "C" {

// w (rows x n, row stride w_stride elements) -= eta * g (row stride
// g_stride), each element one fused multiply-add with neg_eta = -eta.
// w and g must not overlap.  Returns cudaGetLastError().
int repro_sgd_step_f32(void* w, const void* g, long long rows, long long n,
                       long long w_stride, long long g_stride, float neg_eta,
                       void* stream) {
  if (rows > 0 && n > 0)
    dispatch(true, w, g, rows, n, w_stride, g_stride, neg_eta,
             (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The launch repro_sgd_step_f32 makes for these arguments: plan_out =
// {16-byte path (1) or single elements (0), tiles, blocks}.  Returns 0.
int repro_sgd_plan(const void* w, const void* g, long long rows, long long n,
                   long long w_stride, long long g_stride,
                   long long* plan_out) {
  const bool vec = vector_path(w, g, n, w_stride, g_stride);
  plan_out[0] = vec;
  plan_out[1] = tiles_of(rows, vec ? n / 4 : n);
  plan_out[2] = dispatch(false, (void*)w, g, rows, n, w_stride, g_stride,
                         0.0f, nullptr);
  return 0;
}

}  // extern "C"
