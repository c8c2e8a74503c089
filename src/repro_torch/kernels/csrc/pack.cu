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
// 16 and 11 us at 3.35 TB/s.  pack_sums at the two-axis ring's level
// change (10 rows of 421,642 partial sums to lane 9) moves 22.5 MB, about
// 6.7 us.  pack_sums at an rsag hop (10 rows of 42,165 sums, lane 12) and
// unpack_dequantize at rsag's last store and the packed psum move about
// 2.5 MB each, 0.76 us: there the launch and one round trip to memory
// bound them.  An empty kernel (null_kernel) of 256 threads a block costs,
// back to back on an H100 SXM at 700 W, about 1.9-2.1 us plus 0.6 ns a
// block (2.4-2.6 us at 830 blocks, 5.2-5.4 us at 5,500); these kernels
// sat about 0.7-1.0 us above it at their grids, a single 2.5 MB launch
// after a flush of L2 about 2 us above it.
//
// Design of pack_sums and unpack_dequantize: specialised on cpw (with_cpw),
// so the shifts, masks and plane loops are compile-time and unroll.  A
// thread owns words kThreads apart (neighbouring threads on neighbouring
// words, so every plane's loads and stores are coalesced): pack_sums
// kSumWords(cpw), all cpw*kSumWords loads (at least 16; 18 at cpw 3)
// issued before the first shift; unpack_dequantize kUnpackWords(cpw), all
// loaded before its cpw*kUnpackWords stores (at least 8), plane by plane.
// Loads are 4 bytes: plane j starts at j*W and W is odd at these shapes.
// Biases are uint32 and every bias and un-bias is a modular uint32 add
// (the lanes are added modulo 2^32, as the reference sums its shifted
// planes), so the lane-symmetric bias 2^31 at lane 32 is exact; a lane of
// 32 bits gets its mask without the undefined shift 1u << 32.  Blocks
// walk tiles of kThreads words a thread over at most one wave of resident
// blocks, so the grid follows the work and the launch pays the floor's
// 0.6 ns a block for few blocks: 528 (63 registers, four an SM) for the
// level change's 920 tiles, 110, 206 and 210 at the 2.5 MB shapes.  Both
// are launched as programmatic dependents of the kernel before them
// (launch_dependent; repack, pack_sums and unpack_dequantize let their
// dependents start at once), which overlaps a launch with the end of the
// kernel before: on the H100, rsag's hop (pack_sums, repack) and tail
// (pack_sums, unpack_dequantize) ran 0.9 and 1.6-1.7 us faster back to
// back.  unpack_dequantize's f32 is read next (the apply step, rsag's
// gather), so it is stored evict_last (st_keep), never streaming; plain
// stores timed within 0.3 us of it either way (tools/l2_probe.py).
//
// quantize_pack and quantize_pack_chunk read 8 bytes an element and do
// the quantizer's step (quantizer.cuh, the reference's multiply, so the
// codes equal the quantize kernel's bit for bit).  A thread that built
// one word plane by plane kept about one pair of 4-byte loads in flight,
// where 3.35 TB/s needs some 15-20 KB an SM (Little's law).  So both are
// specialised on cpw, and a thread owns kWords(cpw) words kThreads apart
// (neighbouring threads, neighbouring words: every load coalesced) and
// issues all its loads, every plane of x and u for every word, before any
// arithmetic: at least 16 loads in flight a thread (8 or 32 were no
// faster on the H100 at the main shapes).  The loads are
// 4 bytes: plane j starts at j*W floats and the words' row stride is W,
// both odd at the main shapes, so a 16-byte path would need a scalar head
// for every plane of every row.  x and u are read streaming (each once,
// quantizer.cuh).  quantize_pack_chunk's codes become the ring's acc,
// which the next repack reads and writes in place, so they are stored
// with the quantizer pair's L2::evict_last policy (st_keep), as the pair
// hands its codes over.  -DREPRO_PLAIN_CACHE_POLICY builds plain loads and
// stores (tools/l2_probe.py times both builds).
// Blocks walk tiles of kThreads*kWords(cpw) words of one row (chunk) over
// one wave of resident blocks (SM count times blocks an SM, read once per
// device; a grid covering the tiles was faster for quantize_pack but
// slower back to back for the chunk);
// repro_quantize_pack_plan reports the geometry.
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

#include <type_traits>

#include "quantizer.cuh"

namespace {

constexpr int kThreads = 256;

// Words a thread of quantize_pack(_chunk) owns: enough that its loads of
// x and u number at least 16 (2 * cpw * kWords; half that without noise).
__host__ __device__ constexpr int kWords(int cpw) {
  return cpw >= 8 ? 1 : (8 + cpw - 1) / cpw;
}

// Words a thread of pack_sums owns: at least 16 loads of partial sums
// (cpw * kSumWords); 18 at cpw 3.
__host__ __device__ constexpr int kSumWords(int cpw) {
  return cpw >= 16 ? 1 : (16 + cpw - 1) / cpw;
}

// Words a thread of unpack_dequantize owns: at least 8 stores
// (cpw * kUnpackWords).
__host__ __device__ constexpr int kUnpackWords(int cpw) {
  return cpw >= 8 ? 1 : (8 + cpw - 1) / cpw;
}

__host__ __device__ __forceinline__ uint32_t lane_mask(int lane) {
  return lane >= 32 ? 0xffffffffu : ((1u << lane) - 1u);
}

// The tiles of a kernel that walks `segments` runs of W words (a row, or
// a row's chunk), each cut into tiles of `tile` words: kThreads times the
// words a thread owns.
struct Tiles {
  long long per_segment;
  long long total;
};

__host__ __device__ inline Tiles tiles_of(long long segments, long long W,
                                          int tile) {
  const long long per = (W + tile - 1) / tile;
  return {per, per * segments};
}

// x, u: (R, n); words: (R, W).  Bias +G.  Each tile: its thread's words
// w = base + k*kThreads (k < kWords), every plane of x and u of each
// loaded before the first code is computed.  u is read only when
// kStochastic (null otherwise).
template <int CPW, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
    quantize_pack_kernel(const float* __restrict__ x,
                         const float* __restrict__ u,
                         uint32_t* __restrict__ words, long long n,
                         long long W, int lane, QuantStep q, Tiles tiles) {
  constexpr int kW = kWords(CPW);
  const uint32_t bias = (uint32_t)q.gain;
  for (long long t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    const long long row = t / tiles.per_segment;
    const long long base = (t - row * tiles.per_segment) * (kThreads * kW) +
                           threadIdx.x;
    const float* xr = x + row * n;
    const float* ur = kStochastic ? u + row * n : nullptr;
    float xv[kW][CPW], uv[kW][CPW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const long long w = base + k * kThreads;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const long long i = j * W + w;
        const bool in = w < W && i < n;
        xv[k][j] = in ? ld_stream(xr + i) : 0.f;
        uv[k][j] = kStochastic && in ? ld_stream(ur + i) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const long long w = base + k * kThreads;
      if (w >= W) break;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        if (j * W + w < n)
          word += ((uint32_t)quantize_one<kStochastic>(xv[k][j], uv[k][j], q) +
                   bias) << (j * lane);
      }
      words[row * W + w] = word;
    }
  }
}

// codes: (R, n) int32 partial sums; words: (R, W).  The bias is added
// modulo 2^32, so lane 32 with the bias 2^31 is exact.  Each tile: its
// thread's words w = base + k*kThreads (k < kSumWords), every plane of each
// loaded before the first shift.
template <int CPW>
__global__ void __launch_bounds__(kThreads)
    pack_sums_kernel(const int* __restrict__ codes,
                     uint32_t* __restrict__ words, long long n, long long W,
                     int lane, uint32_t bias, Tiles tiles) {
  constexpr int kW = kSumWords(CPW);
  wait_for_prior_grid();
  allow_dependent_grid();
  for (long long t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    const long long row = t / tiles.per_segment;
    const long long base = (t - row * tiles.per_segment) * (kThreads * kW) +
                           threadIdx.x;
    const int* cr = codes + row * n;
    uint32_t v[kW][CPW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const long long w = base + k * kThreads;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const long long i = j * W + w;
        v[k][j] = w < W && i < n ? (uint32_t)cr[i] : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const long long w = base + k * kThreads;
      if (w >= W) break;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < CPW; ++j)
        if (j * W + w < n) word += (v[k][j] + bias) << (j * lane);
      words[row * W + w] = word;
    }
  }
}

// words: (R, W); out: (R, size) f32, read next (the apply step, rsag's
// gather), so stored evict_last (st_keep).  Each tile: its thread's words
// w = base + k*kThreads (k < kUnpackWords), all loaded before the first
// store; then plane by plane, each plane's run of stores coalesced.
template <int CPW>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_kernel(const uint32_t* __restrict__ words,
                             float* __restrict__ out, long long size,
                             long long W, int lane, uint32_t bias,
                             float inv_gain, Tiles tiles) {
  constexpr int kW = kUnpackWords(CPW);
  const uint32_t mask = lane_mask(lane);
  const uint64_t keep = keep_policy();
  wait_for_prior_grid();
  allow_dependent_grid();
  for (long long t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    const long long row = t / tiles.per_segment;
    const long long base = (t - row * tiles.per_segment) * (kThreads * kW) +
                           threadIdx.x;
    const uint32_t* wr = words + row * W;
    int* o = (int*)(out + row * size);
    uint32_t v[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const long long w = base + k * kThreads;
      v[k] = w < W ? __ldg(wr + w) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const long long w = base + k * kThreads;
      if (w >= W) break;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const long long i = j * W + w;
        if (i < size) {
          const int c = (int)(((v[k] >> (j * lane)) & mask) - bias);
          st_keep(o + i, __float_as_int(__fmul_rn((float)c, inv_gain)), keep);
        }
      }
    }
  }
}

// x, u: (R, n); words: (R, k, Wc); codes: (R, k, C), C = ceil(n/k).
// Segment rc = row * k + chunk.  The chunk tail (n..k*C) is the real zero
// code, biased on the wire; word padding past C stays raw 0.  The tiles
// and the loads are quantize_pack's.
template <int CPW, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
    quantize_pack_chunk_kernel(const float* __restrict__ x,
                               const float* __restrict__ u,
                               uint32_t* __restrict__ words,
                               int* __restrict__ codes, long long n, int k,
                               long long C, long long Wc, int lane,
                               uint32_t bias, QuantStep q, Tiles tiles) {
  constexpr int kW = kWords(CPW);
  const uint64_t keep = keep_policy();
  for (long long t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    const long long rc = t / tiles.per_segment;      // row * k + chunk
    const long long base = (t - rc * tiles.per_segment) * (kThreads * kW) +
                           threadIdx.x;
    const long long row = rc / k, start = (rc % k) * C;
    // the chunk's positions e < C that hold values: i = start + e < n
    const long long filled = n - start < C ? n - start : C;
    const float* xr = x + row * n + start;
    const float* ur = kStochastic ? u + row * n + start : nullptr;
    int* cr = codes + rc * C;
    float xv[kW][CPW], uv[kW][CPW];
#pragma unroll
    for (int kk = 0; kk < kW; ++kk) {
      const long long w = base + kk * kThreads;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const long long e = j * Wc + w;             // position in the chunk
        const bool in = w < Wc && e < filled;
        xv[kk][j] = in ? ld_stream(xr + e) : 0.f;
        uv[kk][j] = kStochastic && in ? ld_stream(ur + e) : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kW; ++kk) {
      const long long w = base + kk * kThreads;
      if (w >= Wc) break;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        const long long e = j * Wc + w;
        if (e < C) {
          const int code =
              e < filled ? quantize_one<kStochastic>(xv[kk][j], uv[kk][j], q)
                         : 0;
          st_keep(cr + e, code, keep);
          word |= ((uint32_t)code + bias) << (j * lane);
        }
      }
      words[rc * Wc + w] = word;
    }
  }
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
  allow_dependent_grid();
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

// An empty kernel: the launch floor chip_smoke.py times beside the wire
// kernels at their grids.  No round calls it.
__global__ void null_kernel() {}

dim3 grid_for(long long words, long long rows) {
  return dim3((unsigned)((words + kThreads - 1) / kThreads), (unsigned)rows);
}

// Calls f(std::integral_constant<int, cpw>) for the codes per word of
// `lane`, one of the ten counts of lanes 1..32; false for another lane.
template <typename F>
bool with_cpw(int lane, F&& f) {
  switch (lane >= 1 && lane <= 32 ? 32 / lane : 0) {
#define REPRO_CPW_CASE(C)                 \
  case C:                                 \
    f(std::integral_constant<int, C>{}); \
    return true;
    REPRO_CPW_CASE(32) REPRO_CPW_CASE(16) REPRO_CPW_CASE(10)
    REPRO_CPW_CASE(8) REPRO_CPW_CASE(6) REPRO_CPW_CASE(5)
    REPRO_CPW_CASE(4) REPRO_CPW_CASE(3) REPRO_CPW_CASE(2)
    REPRO_CPW_CASE(1)
#undef REPRO_CPW_CASE
    default:
      return false;
  }
}

// One wave of quantize_pack(_chunk)_kernel<CPW, kStochastic>, capped by
// its tiles (its resident blocks read once per device).
template <int CPW, bool kStochastic, bool kChunk>
int wave_blocks(long long tiles) {
  static int cache[kMaxDevices];
  const void* kernel =
      kChunk ? (const void*)quantize_pack_chunk_kernel<CPW, kStochastic>
             : (const void*)quantize_pack_kernel<CPW, kStochastic>;
  return one_wave(kernel, kThreads, cache, tiles);
}

template <int CPW>
int wave_blocks(bool chunk, bool stochastic, long long tiles) {
  if (chunk)
    return stochastic ? wave_blocks<CPW, true, true>(tiles)
                      : wave_blocks<CPW, false, true>(tiles);
  return stochastic ? wave_blocks<CPW, true, false>(tiles)
                    : wave_blocks<CPW, false, false>(tiles);
}

template <int CPW>
int pack_sums_blocks(long long tiles) {
  static int cache[kMaxDevices];
  return one_wave((const void*)pack_sums_kernel<CPW>, kThreads, cache, tiles);
}

template <int CPW>
int unpack_blocks(long long tiles) {
  static int cache[kMaxDevices];
  return one_wave((const void*)unpack_dequantize_kernel<CPW>, kThreads, cache,
                  tiles);
}

template <int CPW, bool kStochastic>
void launch_quantize_pack(const float* x, const float* u, uint32_t* words,
                          int rows, long long n, long long W, int lane,
                          QuantStep q, cudaStream_t st) {
  const Tiles t = tiles_of(rows, W, kThreads * kWords(CPW));
  quantize_pack_kernel<CPW, kStochastic>
      <<<wave_blocks<CPW, kStochastic, false>(t.total), kThreads, 0, st>>>(
          x, u, words, n, W, lane, q, t);
}

template <int CPW, bool kStochastic>
void launch_quantize_pack_chunk(const float* x, const float* u,
                                uint32_t* words, int* codes, int rows,
                                long long n, int k, long long C, long long Wc,
                                int lane, uint32_t bias, QuantStep q,
                                cudaStream_t st) {
  const Tiles t = tiles_of((long long)rows * k, Wc, kThreads * kWords(CPW));
  quantize_pack_chunk_kernel<CPW, kStochastic>
      <<<wave_blocks<CPW, kStochastic, true>(t.total), kThreads, 0, st>>>(
          x, u, words, codes, n, k, C, Wc, lane, bias, q, t);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError(), or cudaErrorInvalidValue for a lane
// outside 1..32.  The quantizing ones take bound = float32(clip) and
// scale = float32(2^(bits-1) / clip), each rounded once by the caller
// from the double clip; u may be null when stochastic == 0.

int repro_quantize_pack(const void* x, const void* u, void* words, int rows,
                        long long n, long long W, int lane, float bound,
                        float scale, int bits, int stochastic, void* stream) {
  if (rows > 0 && W > 0) {
    const QuantStep q{bound, scale, (float)(1 << (bits - 1))};
    const float* xf = (const float*)x;
    const float* uf = (const float*)u;
    cudaStream_t st = (cudaStream_t)stream;
    if (!with_cpw(lane, [&](auto c) {
          constexpr int CPW = decltype(c)::value;
          if (stochastic)
            launch_quantize_pack<CPW, true>(xf, uf, (uint32_t*)words, rows, n,
                                            W, lane, q, st);
          else
            launch_quantize_pack<CPW, false>(xf, nullptr, (uint32_t*)words,
                                             rows, n, W, lane, q, st);
        }))
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The launch that `kernel` makes for `segments` runs of W words (rows, or
// rows times chunks) at `lane`: 0 quantize_pack, 1 quantize_pack_chunk,
// 2 pack_sums, 3 unpack_dequantize.  out = {codes per word of the
// specialisation, words a thread, bytes a load, tiles, blocks}.  Returns
// 0, or cudaErrorInvalidValue for another kernel or a lane outside 1..32.
int repro_pack_plan(int kernel, int stochastic, long long segments,
                    long long W, int lane, long long* out) {
  if (kernel < 0 || kernel > 3) return (int)cudaErrorInvalidValue;
  const bool ok = with_cpw(lane, [&](auto c) {
    constexpr int CPW = decltype(c)::value;
    const int words = kernel == 2   ? kSumWords(CPW)
                      : kernel == 3 ? kUnpackWords(CPW)
                                    : kWords(CPW);
    const Tiles t = tiles_of(segments, W, kThreads * words);
    out[0] = CPW;
    out[1] = words;
    out[2] = 4;
    out[3] = t.total;
    out[4] = t.total < 1      ? 0
             : kernel == 2 ? pack_sums_blocks<CPW>(t.total)
             : kernel == 3 ? unpack_blocks<CPW>(t.total)
                           : wave_blocks<CPW>(kernel == 1, stochastic, t.total);
  });
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

int repro_unpack_dequantize(const void* words, void* out, int rows,
                            long long size, long long W, int lane,
                            unsigned int bias, float inv_gain, void* stream) {
  cudaError_t err = cudaSuccess;
  if (rows > 0 && W > 0 && !with_cpw(lane, [&](auto c) {
        constexpr int CPW = decltype(c)::value;
        const Tiles t = tiles_of(rows, W, kThreads * kUnpackWords(CPW));
        err = launch_dependent(unpack_dequantize_kernel<CPW>,
                               unpack_blocks<CPW>(t.total), kThreads,
                               (cudaStream_t)stream, (const uint32_t*)words,
                               (float*)out, size, W, lane, (uint32_t)bias,
                               inv_gain, t);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int repro_quantize_pack_chunk(const void* x, const void* u, void* words,
                              void* codes, int rows, long long n, int k,
                              long long C, long long Wc, int lane,
                              unsigned int bias, float bound, float scale,
                              int bits, int stochastic, void* stream) {
  if (rows > 0 && Wc > 0) {
    const QuantStep q{bound, scale, (float)(1 << (bits - 1))};
    const float* xf = (const float*)x;
    const float* uf = (const float*)u;
    cudaStream_t st = (cudaStream_t)stream;
    if (!with_cpw(lane, [&](auto c) {
          constexpr int CPW = decltype(c)::value;
          if (stochastic)
            launch_quantize_pack_chunk<CPW, true>(
                xf, uf, (uint32_t*)words, (int*)codes, rows, n, k, C, Wc, lane,
                (uint32_t)bias, q, st);
          else
            launch_quantize_pack_chunk<CPW, false>(
                xf, nullptr, (uint32_t*)words, (int*)codes, rows, n, k, C, Wc,
                lane, (uint32_t)bias, q, st);
        }))
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int repro_repack(const void* words, void* acc, int rows, long long size,
                 long long W, int hop, int axis, int inner, int lane,
                 unsigned int bias, void* stream) {
  if (rows > 0 && W > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t b = (uint32_t)bias;
    if (!with_cpw(lane, [&](auto c) {
          constexpr int CPW = decltype(c)::value;
          repack_kernel<CPW><<<grid_for(W, rows), kThreads, 0, st>>>(
              (const uint32_t*)words, (int*)acc, size, W, hop, axis, inner,
              lane, b);
        }))
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int repro_pack_sums(const void* codes, void* words, int rows, long long n,
                    long long W, int lane, unsigned int bias, void* stream) {
  cudaError_t err = cudaSuccess;
  if (rows > 0 && W > 0 && !with_cpw(lane, [&](auto c) {
        constexpr int CPW = decltype(c)::value;
        const Tiles t = tiles_of(rows, W, kThreads * kSumWords(CPW));
        err = launch_dependent(pack_sums_kernel<CPW>,
                               pack_sums_blocks<CPW>(t.total), kThreads,
                               (cudaStream_t)stream, (const int*)codes,
                               (uint32_t*)words, n, W, lane, (uint32_t)bias, t);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// `blocks` blocks of kThreads threads of null_kernel on `stream`.
int repro_null_kernel(int blocks, void* stream) {
  null_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
