// The quantizer's step, its L2 cache policies, its one-wave launch
// geometry and the programmatic dependent launch, shared by quantize.cu
// (stochastic_quantize_codes, dequantize_codes) and pack.cu
// (quantize_pack, quantize_pack_chunk, pack_sums, unpack_dequantize), so
// the kernels that quantize round alike and share their L2 policies;
// aggregate.cu (masked_aggregate) shares the geometry and the dependent
// launch, sgd.cu (the float32 SGD step) the geometry.
//
// The step is the reference's multiply (src/repro/kernels/ref.py
// stochastic_quantize_ref, src/repro/core/quantization.py quantize_codes):
//   code = clamp(floor(fl32(fl32(clip(x, -bound, bound) * scale) + u)),
//                -gain, gain - 1)
// with bound = float32(clip) and scale = float32(gain / clip), each
// rounded once on the host from the Python double clip; rintf (half to
// even, like jnp.round) replaces the floor for nearest rounding.  Every
// rounding step is explicit (__fmul_rn, __fadd_rn) and the libraries are
// built with -fmad=false, so no multiply-add is contracted.
//
// Cache policy: inputs read once are loaded streaming (ld.global.cs,
// evict first); outputs the next launch reads are stored with an
// L2::evict_last policy; a last read of such an output uses evict_first.
// Built with -DREPRO_PLAIN_CACHE_POLICY every access is a plain load or
// store instead (tools/l2_probe.py times both builds).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The scale step's constants, computed by the wrapper (kernels/ops.py).
struct QuantStep {
  float bound;   // float32(clip)
  float scale;   // float32(2^(bits-1) / clip)
  float gain;    // 2^(bits-1): the codes saturate to [-gain, gain - 1]
};

template <bool kStochastic>
__device__ __forceinline__ int quantize_one(float x, float u,
                                            const QuantStep& q) {
  const float xs = fminf(fmaxf(x, -q.bound), q.bound);
  const float xq = __fmul_rn(xs, q.scale);
  const float r = kStochastic ? floorf(__fadd_rn(xq, u)) : rintf(xq);
  return (int)fminf(fmaxf(r, -q.gain), q.gain - 1.0f);
}

// Blocks of ``threads`` resident on the whole card at once for ``kernel``:
// SM count times blocks per SM, read once per device into ``cache`` (one
// array of kMaxDevices per kernel), 1 if either cannot be read.
constexpr int kMaxDevices = 64;

inline int resident_blocks(const void* kernel, int threads, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 1;
  int& blocks = cache[dev];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0) !=
            cudaSuccess)
      return 1;
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return blocks;
}

// Blocks for ``items`` units of work of one block each, at most one wave.
inline int one_wave(const void* kernel, int threads, int* cache,
                    long long items) {
  const int w = resident_blocks(kernel, threads, cache);
  return (int)(items < 1 ? 1 : items < w ? items : w);
}

// Programmatic dependent launch (Hopper): a kernel launched as a
// dependent (launch_dependent) may start while the kernel before it on the
// stream still runs.  Before its first load or store it waits here until
// that kernel has finished and its writes are visible, so the stream's
// order holds for memory (the caching allocator's reuse included).  A
// no-op in a launch without the attribute.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets the next kernel on the stream, if launched as a dependent, start
// its launch now rather than when this one ends.
__device__ __forceinline__ void allow_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launches `blocks` blocks of `threads` of kernel(args...) on `st` as a
// programmatic dependent of the kernel before it; the kernel calls
// wait_for_prior_grid before it touches memory.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int blocks,
                             int threads, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ((Params)args)...);
}

}  // namespace
