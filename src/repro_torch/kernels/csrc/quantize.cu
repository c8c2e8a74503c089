// Stochastic fixed-point quantization and dequantization (paper §II-B).
//
// Replaces the Pallas TPU kernels stochastic_quantize_codes and
// dequantize_codes in src/repro/kernels/quantize.py.
//
// Bound: bytes.  Quantize reads x and u (f32) and writes the int32 code,
// 12 bytes per element for a handful of float operations; dequantize moves
// 8 bytes per element.  At the main path's 4,216,420 elements that is
// 50.6 MB and 33.7 MB, about 15 us and 10 us at 3.35 TB/s.  Every round
// runs them as a pair (the STE's fake quantization, the uplink): the
// 16.9 MB of codes that quantize writes are read by the next launch, so
// with the codes kept in the 50 MB L2 the pair moves 12 bytes an element
// from HBM instead of 20.
//
// Design:
// * 16-byte accesses, software-pipelined.  A thread takes one float4 (or
//   int4) vector of each operand a step, a grid apart so that every load
//   instruction of a warp covers 512 contiguous bytes, and issues the
//   next step's loads before this step's arithmetic and store: two
//   vectors of each operand in flight, 32 bytes of quantize's inputs
//   instead of 8.  In exploratory variants on the H100, two to eight
//   vectors a step loaded together were no faster, and the vector
//   quantize ran faster after an L2 flush held to 40 registers (six
//   blocks an SM, kMinBlocks) than at its unbounded 48.  With the
//   reference's multiply in place of a division it needs 36, so seven
//   blocks fit; capped at six it ran no faster.
// * The vector path needs every pointer of the call at one offset past a
//   16-byte boundary.  A scalar head runs up to the boundary and a scalar
//   tail after the last whole vector, in the same launch (the first
//   threads of the grid take them).  Where the offsets differ the sibling
//   scalar kernel takes the whole call, one element a thread per step.
//   The wrapper allocates the output at its input's offset, so a view
//   that starts 4, 8 or 12 bytes past a boundary still takes the vector
//   path when x and u agree.  repro_quantizer_plan reports the choice.
// * One wave.  The grid is the card's SM count times the blocks of this
//   kernel that fit on one SM (both read once per device and cached),
//   capped by the work; blocks stride over the vectors.
// * L2 policy for the hand-off: quantize reads x and u streaming
//   (ld.global.cs, evict first: each is read once) and stores the codes
//   with an L2::evict_last cache policy, so the next launch finds them in
//   L2; dequantize reads the codes with an evict_first policy (their last
//   use) and stores its output normally (the model reads it next).
//   Built with -DREPRO_PLAIN_CACHE_POLICY the kernels use plain loads and
//   stores instead (tools/l2_probe.py times both).
//
// The codes must equal the reference's bit for bit: the step is the
// reference's multiply, in quantizer.cuh with the cache policies.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantizer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;      // resident blocks an SM: <= 40 registers
enum Slot { kQuantVecStoch, kQuantVecNear, kQuantScalarStoch,
            kQuantScalarNear, kDequantVec, kDequantScalar, kSlots };

template <bool kStochastic>
__device__ __forceinline__ int4 quantize4(float4 x, float4 u,
                                          const QuantStep& q) {
  return make_int4(quantize_one<kStochastic>(x.x, u.x, q),
                   quantize_one<kStochastic>(x.y, u.y, q),
                   quantize_one<kStochastic>(x.z, u.z, q),
                   quantize_one<kStochastic>(x.w, u.w, q));
}

__device__ __forceinline__ float dequantize_one(int c, float inv_gain) {
  return __fmul_rn((float)c, inv_gain);
}

// ---- kernels --------------------------------------------------------------

// Elements [head, head + 4*nvec) as 16-byte vectors, one a thread per
// step, the next step's loads issued before this step's arithmetic; [0,
// head) and the tail [head + 4*nvec, n) one element each on the grid's
// first threads.  u is read only when kStochastic (null otherwise).
template <bool kStochastic>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quantize_vec_kernel(const float* __restrict__ x, const float* __restrict__ u,
                    int* __restrict__ codes, long long n, long long head,
                    long long nvec, QuantStep q) {
  const uint64_t keep = keep_policy();
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const float4* uv =
      kStochastic ? reinterpret_cast<const float4*>(u + head) : nullptr;
  int4* cv = reinterpret_cast<int4*>(codes + head);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xa = zero, ua = zero;
  if (t < nvec) {
    xa = ld_stream(xv + t);
    if (kStochastic) ua = ld_stream(uv + t);
  }
  for (long long i = t; i < nvec; i += stride) {
    float4 xb = zero, ub = zero;
    if (i + stride < nvec) {
      xb = ld_stream(xv + i + stride);
      if (kStochastic) ub = ld_stream(uv + i + stride);
    }
    st_keep(cv + i, quantize4<kStochastic>(xa, ua, q), keep);
    xa = xb;
    ua = ub;
  }
  const long long edge = n - 4 * nvec;          // head + tail elements
  if (t < edge) {
    const long long i = t < head ? t : t + 4 * nvec;
    const float ui = kStochastic ? ld_stream(u + i) : 0.f;
    st_keep(codes + i,
            quantize_one<kStochastic>(ld_stream(x + i), ui, q), keep);
  }
}

template <bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quantize_scalar_kernel(const float* __restrict__ x,
                       const float* __restrict__ u, int* __restrict__ codes,
                       long long n, QuantStep q) {
  const uint64_t keep = keep_policy();
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float ui = kStochastic ? ld_stream(u + i) : 0.f;
    st_keep(codes + i,
            quantize_one<kStochastic>(ld_stream(x + i), ui, q), keep);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequantize_vec_kernel(const int* __restrict__ codes, float* __restrict__ out,
                      long long n, long long head, long long nvec,
                      float inv_gain) {
  const uint64_t last = last_use_policy();
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const int4* cv = reinterpret_cast<const int4*>(codes + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  int4 ca = make_int4(0, 0, 0, 0);
  if (t < nvec) ca = ld_last_use(cv + t, last);
  for (long long i = t; i < nvec; i += stride) {
    int4 cb = make_int4(0, 0, 0, 0);
    if (i + stride < nvec) cb = ld_last_use(cv + i + stride, last);
    ov[i] = make_float4(dequantize_one(ca.x, inv_gain),
                        dequantize_one(ca.y, inv_gain),
                        dequantize_one(ca.z, inv_gain),
                        dequantize_one(ca.w, inv_gain));
    ca = cb;
  }
  const long long edge = n - 4 * nvec;
  if (t < edge) {
    const long long i = t < head ? t : t + 4 * nvec;
    out[i] = dequantize_one(ld_last_use(codes + i, last), inv_gain);
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_scalar_kernel(const int* __restrict__ codes,
                         float* __restrict__ out, long long n,
                         float inv_gain) {
  const uint64_t last = last_use_policy();
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    out[i] = dequantize_one(ld_last_use(codes + i, last), inv_gain);
}

// ---- launch geometry ------------------------------------------------------

struct Plan {
  bool vector;      // every pointer at one offset past a 16-byte boundary
  long long head;   // elements before the first boundary
  long long nvec;   // whole 16-byte vectors after the head
};

// a, b, c: the call's pointers; b may be null (unused noise).
Plan plan(const void* a, const void* b, const void* c, long long n) {
  const uintptr_t off = (uintptr_t)a & 15;
  const bool vector = (off & 3) == 0 && ((uintptr_t)c & 15) == off &&
                      (b == nullptr || ((uintptr_t)b & 15) == off);
  if (!vector) return {false, 0, 0};
  long long head = (long long)((16 - off) & 15) / 4;
  if (head > n) head = n;
  return {true, head, (n - head) / 4};
}

// Blocks for `items` thread-steps of work, at most one wave of this
// kernel (its resident blocks read once per device and slot).
int grid(const void* kernel, Slot slot, long long items) {
  static int cache[kSlots][kMaxDevices];
  return one_wave(kernel, kThreads, cache[slot],
                  (items + kThreads - 1) / kThreads);
}

template <bool kStochastic>
void launch_quantize(const float* x, const float* u, int* codes, long long n,
                     QuantStep q, cudaStream_t st) {
  const Plan p = plan(x, kStochastic ? u : nullptr, codes, n);
  if (p.vector) {
    const void* k = (const void*)quantize_vec_kernel<kStochastic>;
    const long long edge = n - 4 * p.nvec;
    const int g = grid(k, kStochastic ? kQuantVecStoch : kQuantVecNear,
                       p.nvec > edge ? p.nvec : edge);
    quantize_vec_kernel<kStochastic><<<g, kThreads, 0, st>>>(
        x, u, codes, n, p.head, p.nvec, q);
  } else {
    const void* k = (const void*)quantize_scalar_kernel<kStochastic>;
    const int g = grid(k, kStochastic ? kQuantScalarStoch : kQuantScalarNear,
                       n);
    quantize_scalar_kernel<kStochastic><<<g, kThreads, 0, st>>>(
        x, u, codes, n, q);
  }
}

}  // namespace

extern "C" {

// The path the quantizer's kernels take for pointers a, b (may be null)
// and c of n elements: returns 1 for the 16-byte path, 0 for the scalar
// one, and writes out = {head elements, 16-byte vectors, tail elements}
// (on the scalar path {0, 0, n}).
int repro_quantizer_plan(const void* a, const void* b, const void* c,
                         long long n, long long* out) {
  const Plan p = plan(a, b, c, n);
  out[0] = p.head;
  out[1] = p.nvec;
  out[2] = n - p.head - 4 * p.nvec;
  return p.vector ? 1 : 0;
}

// bound = float32(clip) and scale = float32(2^(bits-1) / clip), each
// rounded once by the caller from the double clip; u may be null when
// stochastic == 0.  Returns cudaGetLastError().
int repro_quantize_codes(const void* x, const void* u, void* codes,
                         long long n, float bound, float scale, int bits,
                         int stochastic, void* stream) {
  if (n > 0) {
    const QuantStep q{bound, scale, (float)(1 << (bits - 1))};
    cudaStream_t st = (cudaStream_t)stream;
    if (stochastic)
      launch_quantize<true>((const float*)x, (const float*)u, (int*)codes, n,
                            q, st);
    else
      launch_quantize<false>((const float*)x, nullptr, (int*)codes, n, q, st);
  }
  return (int)cudaGetLastError();
}

int repro_dequantize_codes(const void* codes, void* out, long long n,
                           float inv_gain, void* stream) {
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const Plan p = plan(codes, nullptr, out, n);
    if (p.vector) {
      const long long edge = n - 4 * p.nvec;
      const int g = grid((const void*)dequantize_vec_kernel, kDequantVec,
                         p.nvec > edge ? p.nvec : edge);
      dequantize_vec_kernel<<<g, kThreads, 0, st>>>(
          (const int*)codes, (float*)out, n, p.head, p.nvec, inv_gain);
    } else {
      const int g = grid((const void*)dequantize_scalar_kernel,
                         kDequantScalar, n);
      dequantize_scalar_kernel<<<g, kThreads, 0, st>>>(
          (const int*)codes, (float*)out, n, inv_gain);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
