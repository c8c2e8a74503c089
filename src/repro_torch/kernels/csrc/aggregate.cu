// Error-aware masked weighted aggregation (paper eq. 6):
//   out[d] = sum_k w_k * u[k, d] / max(sum_k w_k, eps),  w_k = alpha_k * lambda_k
// or, given a denominator (one float32 on the device, read after the kernel
// before this one has finished), sum_k w_k * u[k, d] / den: the fleet's
// unbiased inverse-probability aggregate, whose divisor is the expected
// surviving mass and not the weights' sum (population/errors.py
// reweighted_aggregate).  A null denominator keeps eq. 6.
//
// Replaces the Pallas TPU kernel masked_aggregate in
// src/repro/kernels/aggregate.py.
//
// Order of operations: the reference's.  XLA:CPU contracts the Pallas
// kernel's multiply (and the jitted error_aware_aggregate's) into its
// reduce over k, so the numerator is the chain acc = fma(w_k, u_k, acc)
// for k = 0..K-1 from 0; the denominator sums the w_k in k order from 0;
// then fmaxf(den, eps) and one division.  -fmad=false stops only the
// compiler's contraction: an explicit __fmaf_rn is still one fused
// multiply-add.  The plain version (kernels/ref.py masked_aggregate_ref,
// an exact float32 FMA) runs the same chain, so the two are equal bit for
// bit.  Updates may be float32 or int32 (converted to nearest float32).
//
// Bound: bytes.  Each update is read once and each output written once,
// 4*K*D + 4*D + 4*K bytes for 2*K*D float operations; at the main path's
// K=10, D=421,642 that is 18.55 MB, about 5.5 us at 3.35 TB/s.
//
// Design:
// * Specialised on K (with_spec: K = 1..16), so the weights live in
//   registers and the row loops unroll; each thread loads the K weights
//   and sums the denominator once.  A generic kernel with a runtime K
//   takes K > 16, 16 rows a step.
// * A thread owns kVecs(K) vectors of V columns, kThreads apart
//   (neighbouring threads on neighbouring vectors, so every load of a
//   warp is contiguous), and issues all its loads, every row of every
//   vector, before its first FMA: at least kMinLoads (16) loads a thread.
// * The vector width is chosen per launch from the pointers and D.  Row k
//   starts k*D elements past the first, so the rows share one offset past
//   a 16-byte boundary only where D % 4 == 0 (or K == 1) and one past an
//   8-byte boundary where D is even: 16-byte loads in the first case,
//   8-byte ones in the second (the main path's D = 421,642 = 2 mod 4),
//   4-byte ones otherwise; the output must share the offset too (the
//   wrapper allocates it at the updates' offset past a 16-byte boundary).
//   Columns before the first boundary (head) and after the last whole
//   vector (tail) take one column a thread on the grid's first threads.
//   repro_masked_aggregate_plan reports the choice.
// * L2 and launch, as measured on the H100 (PERF.md): the updates are
//   loaded plainly and the output stored plainly (an evict_first hint on
//   the loads was 3 us slower back to back, an evict_last store gained
//   nothing).  The kernel is launched as a programmatic dependent of the
//   kernel before it (quantizer.cuh launch_dependent), which it waits for
//   before its first load, and lets its own dependents start once its
//   stores are issued.
// * One wave: blocks walk tiles of kThreads*kVecs(K) vectors over at most
//   one wave of resident blocks (SM count times blocks an SM, read once
//   per device).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quantizer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;            // the largest K specialisation
constexpr int kMinLoads = 16;       // loads a thread issues before its FMAs

// Vectors a thread owns: at least kMinLoads loads (K * kVecs); one in the
// generic kernel (KS = 0), which loads kMaxK rows a step.
__host__ __device__ constexpr int kVecs(int KS) {
  return KS == 0 || KS >= kMinLoads ? 1 : (kMinLoads + KS - 1) / KS;
}

// Rows a thread loads before their FMAs: all K of a specialisation.
__host__ __device__ constexpr int kRows(int KS) { return KS == 0 ? kMaxK : KS; }

// The raw 32-bit lanes of one load of V columns.
template <int V> struct Lanes;
template <> struct Lanes<4> { using type = int4; };
template <> struct Lanes<2> { using type = int2; };
template <> struct Lanes<1> { using type = int; };

__device__ __forceinline__ int lane(int4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane(int2 v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ int lane(int v, int) { return v; }

// Plain loads, each one asm statement as quantizer.cuh's hinted loads are,
// so that the compiler keeps every load a thread owns ahead of its FMAs.
__device__ __forceinline__ int4 ld_plain(const int4* p) {
  int4 v;
  asm volatile("ld.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ int2 ld_plain(const int2* p) {
  int2 v;
  asm volatile("ld.global.v2.s32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ int ld_plain(const int* p) {
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

template <typename T>
__device__ __forceinline__ float to_f32(int bits) {
  if constexpr (std::is_same<T, float>::value) return __int_as_float(bits);
  else return __int2float_rn(bits);
}

__device__ __forceinline__ int4 pack_lanes(const float (&o)[4]) {
  return make_int4(__float_as_int(o[0]), __float_as_int(o[1]),
                   __float_as_int(o[2]), __float_as_int(o[3]));
}
__device__ __forceinline__ int2 pack_lanes(const float (&o)[2]) {
  return make_int2(__float_as_int(o[0]), __float_as_int(o[1]));
}
__device__ __forceinline__ int pack_lanes(const float (&o)[1]) {
  return __float_as_int(o[0]);
}

template <int V>
__device__ __forceinline__ void store_out(float* p, const float (&o)[V]) {
  *reinterpret_cast<typename Lanes<V>::type*>(p) = pack_lanes(o);
}

// u: (K, D) as raw 32-bit lanes of T; out: (D,).  Columns [head, head +
// V*nvec) in vectors of V, [0, head) and the tail one a thread.  KS is K
// (1..kMaxK) or 0 for the generic kernel, which reads K.
template <typename T, int KS, int V>
__global__ void __launch_bounds__(kThreads)
masked_aggregate_kernel(const int* __restrict__ u,
                        const float* __restrict__ weights,
                        const float* __restrict__ den_in,
                        float* __restrict__ out, int K, long long D,
                        long long head, long long nvec, float eps) {
  using L = typename Lanes<V>::type;
  constexpr int NV = kVecs(KS), R = kRows(KS);
  const int nk = KS > 0 ? KS : K;
  wait_for_prior_grid();
  float w[R];
  float den = 0.f;
  if constexpr (KS > 0) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      w[k] = __ldg(weights + k);
      den = __fadd_rn(den, w[k]);
    }
  } else {
    for (int k = 0; k < K; ++k) den = __fadd_rn(den, __ldg(weights + k));
  }
  den = den_in != nullptr ? *den_in : fmaxf(den, eps);

  const L* rows = reinterpret_cast<const L*>(u + head);  // row k at k*D/V
  const long long stride = D / V;                // whole when V > 1
  const long long tile = (long long)kThreads * NV;
  const long long tiles = (nvec + tile - 1) / tile;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long first = t * tile + threadIdx.x;
    float acc[NV][V];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < nk; k0 += R) {
      L r[NV][R];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const long long i = first + (long long)j * kThreads;
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
          const int k = k0 + kk;
          r[j][kk] = i < nvec && (KS > 0 || k < nk)
                         ? ld_plain(rows + k * stride + i)
                         : L{};
        }
      }
      if constexpr (KS == 0) {
#pragma unroll
        for (int kk = 0; kk < R; ++kk)
          w[kk] = k0 + kk < nk ? __ldg(weights + k0 + kk) : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < R; ++kk) {
        if (KS == 0 && k0 + kk >= nk) break;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[j][e] = __fmaf_rn(w[kk], to_f32<T>(lane(r[j][kk], e)),
                                  acc[j][e]);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const long long i = first + (long long)j * kThreads;
      if (i < nvec) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = __fdiv_rn(acc[j][e], den);
        store_out<V>(out + head + i * V, o);
      }
    }
  }
  allow_dependent_grid();

  // the head and tail columns, one a thread
  const long long g = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (g < D - V * nvec) {
    const long long c = g < head ? g : g + V * nvec;
    float a = 0.f;
    if constexpr (KS > 0) {
#pragma unroll
      for (int k = 0; k < KS; ++k)
        a = __fmaf_rn(w[k], to_f32<T>(ld_plain(u + k * D + c)), a);
    } else {
      for (int k = 0; k < K; ++k)
        a = __fmaf_rn(__ldg(weights + k),
                      to_f32<T>(ld_plain(u + k * D + c)), a);
    }
    out[c] = __fdiv_rn(a, den);
  }
}

// The launch's vector width V (columns a load) and its column split.
struct Plan {
  int V;
  long long head;   // columns before the first boundary of 4*V bytes
  long long nvec;   // whole vectors of V columns after the head
};

// The widest V whose boundary every row start and out share: rows start
// k*D elements apart, so every row shares row 0's offset past a boundary
// of 4*V bytes where D % V == 0 (or there is one row).
Plan plan(const void* u, const void* out, int K, long long D) {
  const uintptr_t a = (uintptr_t)u, o = (uintptr_t)out;
  for (int V = 4; V > 1; V /= 2) {
    const uintptr_t m = 4u * V - 1;
    if ((K == 1 || D % V == 0) && (a & m) == (o & m) && (a & 3) == 0) {
      long long head = (long long)(((m + 1) - (a & m)) & m) / 4;
      if (head > D) head = D;
      return {V, head, (D - head) / V};
    }
  }
  return {1, 0, D};
}

// Calls f(integral_constant<KS>, integral_constant<V>) for the
// specialisation of K (0: the generic kernel) and the vector width V.
template <typename F>
void with_spec(int K, int V, F&& f) {
  auto with_v = [&](auto ks) {
    if (V == 4) f(ks, std::integral_constant<int, 4>{});
    else if (V == 2) f(ks, std::integral_constant<int, 2>{});
    else f(ks, std::integral_constant<int, 1>{});
  };
  switch (K) {
#define REPRO_K_CASE(C) \
  case C:               \
    with_v(std::integral_constant<int, C>{}); \
    return;
    REPRO_K_CASE(1) REPRO_K_CASE(2) REPRO_K_CASE(3) REPRO_K_CASE(4)
    REPRO_K_CASE(5) REPRO_K_CASE(6) REPRO_K_CASE(7) REPRO_K_CASE(8)
    REPRO_K_CASE(9) REPRO_K_CASE(10) REPRO_K_CASE(11) REPRO_K_CASE(12)
    REPRO_K_CASE(13) REPRO_K_CASE(14) REPRO_K_CASE(15) REPRO_K_CASE(16)
#undef REPRO_K_CASE
    default:
      with_v(std::integral_constant<int, 0>{});
  }
}

// One wave of masked_aggregate_kernel<T, KS, V>, capped by its tiles (its
// resident blocks read once per device).
template <typename T, int KS, int V>
int wave_blocks(long long tiles) {
  static int cache[kMaxDevices];
  return one_wave((const void*)masked_aggregate_kernel<T, KS, V>, kThreads,
                  cache, tiles);
}

long long tiles_of(long long nvec, int KS) {
  const long long tile = (long long)kThreads * kVecs(KS);
  return (nvec + tile - 1) / tile;
}

template <typename T>
int launch(const void* updates, const void* weights, const void* den,
           void* out, int K, long long D, float eps, void* stream) {
  cudaError_t err = cudaSuccess;
  if (D > 0) {
    const Plan p = plan(updates, out, K, D);
    with_spec(K, p.V, [&](auto ks, auto v) {
      constexpr int KS = decltype(ks)::value, V = decltype(v)::value;
      const int blocks = wave_blocks<T, KS, V>(tiles_of(p.nvec, KS));
      err = launch_dependent(masked_aggregate_kernel<T, KS, V>, blocks,
                             kThreads, (cudaStream_t)stream,
                             (const int*)updates, (const float*)weights,
                             (const float*)den, (float*)out, K, D, p.head,
                             p.nvec, eps);
    });
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError().  out must not overlap updates.  den: null
// for eq. 6's max(sum_k w_k, eps), else one float32 on the device that
// divides the numerator as it is.
int repro_masked_aggregate_f32(const void* updates, const void* weights,
                               const void* den, void* out, int K, long long D,
                               float eps, void* stream) {
  return launch<float>(updates, weights, den, out, K, D, eps, stream);
}

int repro_masked_aggregate_i32(const void* updates, const void* weights,
                               const void* den, void* out, int K, long long D,
                               float eps, void* stream) {
  return launch<int>(updates, weights, den, out, K, D, eps, stream);
}

// The launch masked_aggregate makes for these pointers, K and D (is_int:
// int32 updates): out = {K specialisation (0: generic), bytes a load,
// loads a thread issues before its first FMA, head columns, vectors,
// tail columns, tiles, blocks}.  Returns 0.
int repro_masked_aggregate_plan(const void* updates, const void* out, int K,
                                long long D, int is_int, long long* plan_out) {
  const Plan p = plan(updates, out, K, D);
  with_spec(K, p.V, [&](auto ks, auto v) {
    constexpr int KS = decltype(ks)::value, V = decltype(v)::value;
    const long long tiles = tiles_of(p.nvec, KS);
    plan_out[0] = KS;
    plan_out[1] = 4 * V;
    plan_out[2] = kRows(KS) * kVecs(KS);
    plan_out[3] = p.head;
    plan_out[4] = p.nvec;
    plan_out[5] = D - p.head - V * p.nvec;
    plan_out[6] = tiles;
    plan_out[7] = is_int ? wave_blocks<int, KS, V>(tiles)
                         : wave_blocks<float, KS, V>(tiles);
  });
  return 0;
}

}  // extern "C"
