// The packed wire format: fused quantize-and-pack, unpack-and-dequantize,
// quantize-pack-chunk, the ring hop's repack and the partial-sum pack
// (paper §II-D2 payload).
//
// Replaces the Pallas TPU kernels quantize_pack, unpack_dequantize,
// quantize_pack_chunk, repack and pack_sums in src/repro/kernels/pack.py.
//
// Layout: a row (one cohort) of n codes packs planar into W = ceil(n/cpw)
// 32-bit words, cpw = 32 / lane: code i = j*W + w sits in bits
// [j*lane, (j+1)*lane) of word w, biased unsigned.  Padding lanes are raw 0.
//
// Bound: bytes.  Each kernel is one pass with a handful of integer
// operations per code.  At the cohort round's main shape (10 rows of
// 421,642 codes, 8 bits) quantize_pack (lane 12) moves 42.2 MB,
// quantize_pack_chunk (lane 8) 54.8 MB and a repack hop 38.0 MB, about 13,
// 16 and 11 us at 3.35 TB/s; unpack_dequantize moves 2.5 MB and is bound
// by its launch.  pack_sums at the two-axis ring's level change (10 rows
// of 421,642 partial sums to lane 9) moves 22.5 MB, about 6.7 us; at an
// rsag hop (10 rows of 42,165) it moves about 2.3 MB and is launch-bound.
//
// Design: one thread per output word per row, the row in blockIdx.y.  The
// thread reads its cpw planes at j*W + w, so neighbouring threads touch
// neighbouring addresses in every plane and every load is coalesced; the
// word is built in a register and stored once (pack_word, shared by
// quantize_pack and pack_sums: the lanes are added modulo 2^32, as the
// reference sums its shifted planes).  The quantizer is the step
// of csrc/quantize.cu (__fdiv_rn / __fmul_rn / __fadd_rn, rintf, built
// with -fmad=false), so the codes equal the quantize kernel's bit for bit.
// Biases are uint32 and every bias and un-bias is a modular uint32 add, so
// the lane-symmetric bias 2^31 at lane 32 is exact.  A lane of 32 bits
// gets its mask without the undefined shift 1u << 32.
//
// The ring's repack reads the words of the row ``hop`` steps back along
// one axis of the cohort grid and adds them into row r of acc in place:
// the cohort-stacked form of one ppermute hop, with no copy of acc and no
// rotated copy of the words.  Rows stack row-major over the grid; an axis
// of K entries with ``inner`` rows per step maps row r to
//   (r / (K*inner))*K*inner + (((r / inner) mod K - hop) mod K)*inner
//   + r mod inner,
// which is (r - hop) mod R for the one-axis ring (K = R, inner = 1).
// A hop loads each acc value, adds and stores it back, and a thread that
// did that plane by plane kept one 4-byte load in flight (the store
// through acc keeps the next plane's load behind it): about 8 KB per SM,
// where 3.35 TB/s needs some 15-20 KB (Little's law).  So repack is
// specialised on cpw and a thread issues all its loads before its stores:
// its word, then its cpw planes.  A thread owns one word: 2, 4 and 8 words
// a thread were measured no faster at cpw 4.  Plane j starts at j*W ints
// and W is odd at the main shape, so the loads stay 4 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int quantize_one(float x, float u, float clip,
                                            float gain, int stochastic) {
  float xs = fminf(fmaxf(__fdiv_rn(x, clip), -1.0f), 1.0f);
  float xq = __fmul_rn(xs, gain);
  float r = stochastic ? floorf(__fadd_rn(xq, u)) : rintf(xq);
  return (int)fminf(fmaxf(r, -gain), gain - 1.0f);
}

__host__ __device__ __forceinline__ uint32_t lane_mask(int lane) {
  return lane >= 32 ? 0xffffffffu : ((1u << lane) - 1u);
}

// One word w of a planar row of n codes: sum over the cpw planes of
// (code(j*W + w) + bias) << j*lane, modulo 2^32; padding lanes stay 0.
template <typename CodeAt>
__device__ __forceinline__ uint32_t pack_word(CodeAt code_at, long long w,
                                              long long W, long long n,
                                              int lane, int cpw,
                                              uint32_t bias) {
  uint32_t word = 0;
  for (int j = 0; j < cpw; ++j) {
    const long long i = j * W + w;
    if (i < n) word += ((uint32_t)code_at(i) + bias) << (j * lane);
  }
  return word;
}

// x, u: (R, n); words: (R, W).  Bias +G.
__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     uint32_t* __restrict__ words, long long n,
                                     long long W, int lane, int cpw,
                                     float clip, float gain, int stochastic) {
  const long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const float* xr = x + row * n;
  const float* ur = u + row * n;
  words[row * W + w] = pack_word(
      [&](long long i) {
        return quantize_one(xr[i], stochastic ? ur[i] : 0.0f, clip, gain,
                            stochastic);
      },
      w, W, n, lane, cpw, (uint32_t)gain);
}

// codes: (R, n) int32 partial sums; words: (R, W).  The bias is added
// modulo 2^32, so lane 32 with the bias 2^31 is exact.
__global__ void pack_sums_kernel(const int* __restrict__ codes,
                                 uint32_t* __restrict__ words, long long n,
                                 long long W, int lane, int cpw,
                                 uint32_t bias) {
  const long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const int* cr = codes + row * n;
  words[row * W + w] = pack_word([&](long long i) { return cr[i]; }, w, W, n,
                                 lane, cpw, bias);
}

// words: (R, W); out: (R, size) f32.
__global__ void unpack_dequantize_kernel(const uint32_t* __restrict__ words,
                                         float* __restrict__ out,
                                         long long size, long long W, int lane,
                                         int cpw, uint32_t bias,
                                         float inv_gain) {
  const long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const uint32_t word = words[row * W + w];
  const uint32_t mask = lane_mask(lane);
  float* o = out + row * size;
  for (int j = 0; j < cpw; ++j) {
    const long long i = j * W + w;
    if (i < size) {
      int v = (int)(((word >> (j * lane)) & mask) - bias);
      o[i] = __fmul_rn((float)v, inv_gain);
    }
  }
}

// x, u: (R, n); words: (R, k, Wc); codes: (R, k, C), C = ceil(n/k).
// blockIdx.y = row * k + chunk.  The chunk tail (n..k*C) is the real zero
// code, biased on the wire; word padding past C stays raw 0.
__global__ void quantize_pack_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    uint32_t* __restrict__ words, int* __restrict__ codes, long long n,
    int k, long long C, long long Wc, int lane, int cpw, uint32_t bias,
    float clip, float gain, int stochastic) {
  const long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (w >= Wc) return;
  const long long rc = blockIdx.y;          // row * k + chunk
  const long long row = rc / k, chunk = rc % k;
  const float* xr = x + row * n;
  const float* ur = u + row * n;
  int* cr = codes + rc * C;
  uint32_t word = 0;
  for (int j = 0; j < cpw; ++j) {
    const long long e = j * Wc + w;         // position in the chunk
    if (e < C) {
      const long long i = chunk * C + e;    // position in the row
      int code = i < n ? quantize_one(xr[i], stochastic ? ur[i] : 0.0f, clip,
                                      gain, stochastic)
                       : 0;
      cr[e] = code;
      word |= ((uint32_t)code + bias) << (j * lane);
    }
  }
  words[rc * Wc + w] = word;
}

// words: (R, W); acc: (R, size) int32, updated in place from the words of
// the row ``hop`` steps back along an axis of ``axis`` entries, ``inner``
// rows per step; 0 <= hop < axis.  A thread owns one word; it loads the
// word (read-only path) and its CPW planes, then adds and stores, and the
// plane loop unrolls on CPW.
template <int CPW>
__global__ void __launch_bounds__(kThreads)
    repack_kernel(const uint32_t* __restrict__ words, int* __restrict__ acc,
                  long long size, long long W, int hop, int axis, int inner,
                  int lane, uint32_t bias) {
  const long long w = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (w >= W) return;
  const int row = blockIdx.y;
  const int span = axis * inner;
  const int src = (row / span) * span +
                  (((row / inner) % axis - hop + axis) % axis) * inner +
                  row % inner;
  const uint32_t word = __ldg(words + (long long)src * W + w);
  int* a = acc + (long long)row * size;
  uint32_t val[CPW];
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const long long i = j * W + w;
    val[j] = i < size ? (uint32_t)a[i] : 0u;
  }
  const uint32_t mask = lane_mask(lane);
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    const long long i = j * W + w;
    // modular: acc + lane - bias in uint32, no signed overflow
    if (i < size) a[i] = (int)(val[j] + ((word >> (j * lane)) & mask) - bias);
  }
}

dim3 grid_for(long long words, long long rows) {
  return dim3((unsigned)((words + kThreads - 1) / kThreads), (unsigned)rows);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError(); u may be null when stochastic == 0.

int repro_quantize_pack(const void* x, const void* u, void* words, int rows,
                        long long n, long long W, int lane, float clip,
                        int bits, int stochastic, void* stream) {
  if (rows > 0 && W > 0) {
    quantize_pack_kernel<<<grid_for(W, rows), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)x, (const float*)u, (uint32_t*)words, n, W, lane,
        32 / lane, clip, (float)(1 << (bits - 1)), stochastic);
  }
  return (int)cudaGetLastError();
}

int repro_unpack_dequantize(const void* words, void* out, int rows,
                            long long size, long long W, int lane,
                            unsigned int bias, float inv_gain, void* stream) {
  if (rows > 0 && W > 0) {
    unpack_dequantize_kernel<<<grid_for(W, rows), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)words, (float*)out, size, W, lane, 32 / lane,
        (uint32_t)bias, inv_gain);
  }
  return (int)cudaGetLastError();
}

int repro_quantize_pack_chunk(const void* x, const void* u, void* words,
                              void* codes, int rows, long long n, int k,
                              long long C, long long Wc, int lane,
                              unsigned int bias, float clip, int bits,
                              int stochastic, void* stream) {
  if (rows > 0 && Wc > 0) {
    quantize_pack_chunk_kernel<<<grid_for(Wc, (long long)rows * k), kThreads,
                                 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)u, (uint32_t*)words, (int*)codes, n, k,
        C, Wc, lane, 32 / lane, (uint32_t)bias, clip,
        (float)(1 << (bits - 1)), stochastic);
  }
  return (int)cudaGetLastError();
}

int repro_repack(const void* words, void* acc, int rows, long long size,
                 long long W, int hop, int axis, int inner, int lane,
                 unsigned int bias, void* stream) {
  if (rows > 0 && W > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t b = (uint32_t)bias;
    // the ten codes-per-word counts of lanes 1..32
    switch (lane >= 1 && lane <= 32 ? 32 / lane : 0) {
#define REPRO_REPACK_CASE(C)                                               \
  case C:                                                                  \
    repack_kernel<C><<<grid_for(W, rows), kThreads, 0, st>>>(              \
        (const uint32_t*)words, (int*)acc, size, W, hop, axis, inner, lane, \
        b);                                                                \
    break;
      REPRO_REPACK_CASE(32) REPRO_REPACK_CASE(16) REPRO_REPACK_CASE(10)
      REPRO_REPACK_CASE(8) REPRO_REPACK_CASE(6) REPRO_REPACK_CASE(5)
      REPRO_REPACK_CASE(4) REPRO_REPACK_CASE(3) REPRO_REPACK_CASE(2)
      REPRO_REPACK_CASE(1)
#undef REPRO_REPACK_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int repro_pack_sums(const void* codes, void* words, int rows, long long n,
                    long long W, int lane, unsigned int bias, void* stream) {
  if (rows > 0 && W > 0) {
    pack_sums_kernel<<<grid_for(W, rows), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const int*)codes, (uint32_t*)words, n, W, lane, 32 / lane,
        (uint32_t)bias);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
