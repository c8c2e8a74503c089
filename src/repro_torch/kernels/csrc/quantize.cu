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
//   blocks an SM, kMinBlocks) than at its unbounded 48.
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
// The codes must equal the JAX kernel bit for bit, so every rounding step
// is explicit: __fdiv_rn / __fmul_rn / __fadd_rn, rintf (half to even,
// like jnp.round), and the library is built with -fmad=false so no
// multiply-add is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;      // resident blocks an SM: <= 40 registers
constexpr int kMaxDevices = 64;
enum Slot { kQuantVecStoch, kQuantVecNear, kQuantScalarStoch,
            kQuantScalarNear, kDequantVec, kDequantScalar, kSlots };

// ---- cache policy ---------------------------------------------------------

#ifdef REPRO_PLAIN_CACHE_POLICY
__device__ __forceinline__ uint64_t keep_policy() { return 0; }
__device__ __forceinline__ uint64_t last_use_policy() { return 0; }
__device__ __forceinline__ float4 ld_stream(const float4* p) { return *p; }
__device__ __forceinline__ float ld_stream(const float* p) { return *p; }
__device__ __forceinline__ void st_keep(int4* p, int4 v, uint64_t) { *p = v; }
__device__ __forceinline__ void st_keep(int* p, int v, uint64_t) { *p = v; }
__device__ __forceinline__ int4 ld_last_use(const int4* p, uint64_t) {
  return *p;
}
__device__ __forceinline__ int ld_last_use(const int* p, uint64_t) {
  return *p;
}
#else
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t last_use_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ void st_keep(int4* p, int4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.s32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
               : "memory");
}
__device__ __forceinline__ void st_keep(int* p, int v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.s32 [%0], %1, %2;"
               :: "l"(p), "r"(v), "l"(pol) : "memory");
}
__device__ __forceinline__ int4 ld_last_use(const int4* p, uint64_t pol) {
  int4 v;
  asm volatile("ld.global.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int ld_last_use(const int* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.L2::cache_hint.s32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
#endif

// ---- arithmetic -----------------------------------------------------------

template <bool kStochastic>
__device__ __forceinline__ int quantize_one(float x, float u, float clip,
                                            float gain) {
  float xs = fminf(fmaxf(__fdiv_rn(x, clip), -1.0f), 1.0f);
  float xq = __fmul_rn(xs, gain);
  float r = kStochastic ? floorf(__fadd_rn(xq, u)) : rintf(xq);
  return (int)fminf(fmaxf(r, -gain), gain - 1.0f);
}

template <bool kStochastic>
__device__ __forceinline__ int4 quantize4(float4 x, float4 u, float clip,
                                          float gain) {
  return make_int4(quantize_one<kStochastic>(x.x, u.x, clip, gain),
                   quantize_one<kStochastic>(x.y, u.y, clip, gain),
                   quantize_one<kStochastic>(x.z, u.z, clip, gain),
                   quantize_one<kStochastic>(x.w, u.w, clip, gain));
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
                    long long nvec, float clip, float gain) {
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
    st_keep(cv + i, quantize4<kStochastic>(xa, ua, clip, gain), keep);
    xa = xb;
    ua = ub;
  }
  const long long edge = n - 4 * nvec;          // head + tail elements
  if (t < edge) {
    const long long i = t < head ? t : t + 4 * nvec;
    const float ui = kStochastic ? ld_stream(u + i) : 0.f;
    st_keep(codes + i,
            quantize_one<kStochastic>(ld_stream(x + i), ui, clip, gain), keep);
  }
}

template <bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quantize_scalar_kernel(const float* __restrict__ x,
                       const float* __restrict__ u, int* __restrict__ codes,
                       long long n, float clip, float gain) {
  const uint64_t keep = keep_policy();
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const float ui = kStochastic ? ld_stream(u + i) : 0.f;
    st_keep(codes + i,
            quantize_one<kStochastic>(ld_stream(x + i), ui, clip, gain), keep);
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

// Blocks of kThreads resident on the whole card at once for this kernel:
// SM count times blocks per SM, read once per device and kernel.
int wave(const void* kernel, Slot slot) {
  static int cache[kMaxDevices][kSlots];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 1;
  int& blocks = cache[dev][slot];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 1;
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return blocks;
}

// Blocks for `items` thread-steps of work, at most one wave.
int grid(const void* kernel, Slot slot, long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  const int w = wave(kernel, slot);
  return (int)(b < 1 ? 1 : b < w ? b : w);
}

template <bool kStochastic>
void launch_quantize(const float* x, const float* u, int* codes, long long n,
                     float clip, float gain, cudaStream_t st) {
  const Plan p = plan(x, kStochastic ? u : nullptr, codes, n);
  if (p.vector) {
    const void* k = (const void*)quantize_vec_kernel<kStochastic>;
    const long long edge = n - 4 * p.nvec;
    const int g = grid(k, kStochastic ? kQuantVecStoch : kQuantVecNear,
                       p.nvec > edge ? p.nvec : edge);
    quantize_vec_kernel<kStochastic><<<g, kThreads, 0, st>>>(
        x, u, codes, n, p.head, p.nvec, clip, gain);
  } else {
    const void* k = (const void*)quantize_scalar_kernel<kStochastic>;
    const int g = grid(k, kStochastic ? kQuantScalarStoch : kQuantScalarNear,
                       n);
    quantize_scalar_kernel<kStochastic><<<g, kThreads, 0, st>>>(
        x, u, codes, n, clip, gain);
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

// u may be null when stochastic == 0.  Returns cudaGetLastError().
int repro_quantize_codes(const void* x, const void* u, void* codes,
                         long long n, float clip, int bits, int stochastic,
                         void* stream) {
  if (n > 0) {
    const float gain = (float)(1 << (bits - 1));
    cudaStream_t st = (cudaStream_t)stream;
    if (stochastic)
      launch_quantize<true>((const float*)x, (const float*)u, (int*)codes, n,
                            clip, gain, st);
    else
      launch_quantize<false>((const float*)x, nullptr, (int*)codes, n, clip,
                             gain, st);
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
