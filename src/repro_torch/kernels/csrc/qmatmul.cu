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
// so both are bound by latency and the launch rather than by a rate.
//
// Design.
// * Product: the int8 tensor cores, mma.sync m16n8k32 s8.s8.s32.  A block
//   owns a 64 x 64 output tile; its four warps own 32 x 32 each, two m16
//   by four n8 mma tiles.  A's fragments come from shared memory with
//   ldmatrix.  B wants four consecutive k of one n in a register, but w
//   is row-major (n contiguous), so each thread loads four 32-bit words
//   (four k rows of four n) and transposes them with __byte_perm into the
//   B registers of four mma tiles: tile j's column g is n = 4g + j, which
//   leaves each thread eight consecutive n of the output.
// * Staging: k-tiles of 128 bytes of x (64 x 128) and w (128 x 64) go into
//   a ring of three shared-memory stages (48 KB, dynamic) with cp.async
//   and commit/wait groups, so two k-tiles are in flight while the tensor
//   cores work on one.  Both tiles are XOR-swizzled in 16-byte chunks so
//   that ldmatrix and the B-word loads hit 32 distinct banks.
// * Grid: M and N give few tiles at these shapes (30 at (960, 3136, 128)),
//   so K is split over a thread-block cluster of `split` blocks (at most
//   8, about one block per SM).  Each block sums its
//   share of the k-tiles, writes its int32 partial tile over its stages,
//   and after a cluster barrier each block adds a 1/split share of the
//   rows over the cluster's blocks through distributed shared memory and
//   stores them; a last, relaxed barrier keeps every block's tile alive
//   until it has been read.  int32 sums are exact in any order, there is
//   no workspace and one launch per call.  The two barriers are most of
//   what a launch-bound shape pays beyond its loads.
// * Ragged and unaligned operands stay inside the kernel.  The rows and
//   k-tiles past M, N and K are zero-filled (cp.async with a source size
//   of 0).  An operand whose row stride or base pointer is not a multiple
//   of 16 bytes is staged byte by byte.  plan() below picks the staging
//   of each operand and the split from the shapes, the pointers and the
//   card's SM count; it is the one place that holds the launch geometry.
// * Exactness: the int32 sum (|sum| <= K * 2^14) is converted once with
//   __int2float_rn and scaled with __fmul_rn, as the reference's
//   acc.astype(f32) * (sx * sw).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 128;   // block tile; kBK in bytes
constexpr int kStages = 3;
constexpr int kThreads = 128;                  // four warps, 2 x 2 of 32 x 32
constexpr int kMI = kBM / 32;                  // m16 tiles per warp
constexpr int kXBytes = kBM * kBK;
constexpr int kStageBytes = kXBytes + kBK * kBN;
constexpr int kRedPitch = kBN + 4;             // ints per row of the partial tile
constexpr int kSmemBytes = kStages * kStageBytes;   // 48 KB
static_assert(kSmemBytes <= 48 * 1024, "more needs cudaFuncSetAttribute");
constexpr int kMaxSplit = 8;                   // portable cluster size
static_assert(kBM * kRedPitch * 4 <= kSmemBytes, "the partial tile fits the stages");

// x tile: 64 rows of 128 bytes; 16-byte chunk c of row r at slot c ^ (r & 7).
__device__ __forceinline__ int xs_off(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 4);
}

// w tile: 128 rows (k) of 64 bytes (n), two rows to a 128-byte line; chunk
// c of row r at slot ((r & 1) * 4 + c) ^ (2 * ((r >> 2) & 3)).  The B loads
// read rows r, r + 4, r + 8, r + 12 at two chunks each: eight slots.
__device__ __forceinline__ int ws_off(int r, int c) {
  return (r >> 1) * 128 + (((((r & 1) << 2) | c) ^ (((r >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One element of VEC bytes (16 or 1) from global to shared memory, zero
// when !valid.
template <int VEC>
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src,
                                      bool valid) {
  if constexpr (VEC == 1) {
    *dst = valid ? __ldg(src) : (int8_t)0;
  } else {
    static_assert(VEC == 16, "16-byte or byte staging");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rows m0.., bytes k0..k0+127 of the row-major (M, K) x.
template <int VEC>
__device__ __forceinline__ void load_x(int8_t* xs, const int8_t* x, int m0,
                                       int k0, int M, int K, int tid) {
  constexpr int kPer = kBK / VEC;
#pragma unroll(VEC == 1 ? 8 : 16)   // the byte path unrolled fully spills
  for (int p = 0; p < kBM * kPer / kThreads; ++p) {
    const int e = tid + p * kThreads;
    const int r = e / kPer, b = (e % kPer) * VEC;
    const int m = m0 + r, k = k0 + b;
    const bool valid = m < M && k < K;
    stage<VEC>(xs + xs_off(r, b >> 4) + (b & 15),
               valid ? x + (long long)m * K + k : x, valid);
  }
}

// w rows k0..k0+127, bytes n0..n0+63 of the row-major (K, N) w.
template <int VEC>
__device__ __forceinline__ void load_w(int8_t* ws, const int8_t* w, int n0,
                                       int k0, int N, int K, int tid) {
  constexpr int kPer = kBN / VEC;
#pragma unroll(VEC == 1 ? 8 : 16)
  for (int p = 0; p < kBK * kPer / kThreads; ++p) {
    const int e = tid + p * kThreads;
    const int r = e / kPer, b = (e % kPer) * VEC;
    const int k = k0 + r, n = n0 + b;
    const bool valid = k < K && n < N;
    stage<VEC>(ws + ws_off(r, b >> 4) + (b & 15),
               valid ? w + (long long)k * N + n : w, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 4 x 4 byte transpose: byte j of v[i] becomes byte i of v[j].
__device__ __forceinline__ void transpose4(uint32_t (&v)[4]) {
  const uint32_t p0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t p1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t p2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t p3 = __byte_perm(v[2], v[3], 0x7362);
  v[0] = __byte_perm(p0, p2, 0x5410);
  v[1] = __byte_perm(p0, p2, 0x7632);
  v[2] = __byte_perm(p1, p3, 0x5410);
  v[3] = __byte_perm(p1, p3, 0x7632);
}

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all row-major.  Block
// b computes part b % split of the k-tiles of output tile b / split.
template <int XV, int WV>
__global__ void __launch_bounds__(kThreads)
    qmatmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   float* __restrict__ out, int M, int N, int K, int tiles_n,
                   int split, float scale) {
  extern __shared__ __align__(128) int8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();
  const int tile = blockIdx.x / split;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int kt_all = (K + kBK - 1) / kBK;
  const int kt0 = (int)((long long)kt_all * s / split);
  const int nkt = (int)((long long)kt_all * (s + 1) / split) - kt0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * (kBM / 2), wn = (warp & 1) * 32;
  const int g = lane >> 2, tig = lane & 3;

  auto load = [&](int i) {        // k-tile kt0 + i into stage i % kStages
    int8_t* st = smem + (i % kStages) * kStageBytes;
    const int k0 = (kt0 + i) * kBK;
    load_x<XV>(st, x, m0, k0, M, K, tid);
    load_w<WV>(st + kXBytes, w, n0, k0, N, K, tid);
  };

  int acc[kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[mi][j][t] = 0;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nkt) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // tile i landed; stage (i - 1) is free
    if (i + kStages - 1 < nkt) load(i + kStages - 1);
    cp_async_commit();
    const int8_t* st = smem + (i % kStages) * kStageBytes;
    const uint32_t xs = smem_u32(st);
    const int8_t* ws = st + kXBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[kMI][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        ldmatrix_x4(a[mi], xs + xs_off(wm + mi * 16 + (lane & 15),
                                       kk * 2 + (lane >> 4)));
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // k = kk*32 + q*16 + tig*4 + 0..3
#pragma unroll
        for (int r = 0; r < 4; ++r)
          b[q][r] = *reinterpret_cast<const uint32_t*>(
              ws + ws_off(kk * 32 + q * 16 + tig * 4 + r, (wn >> 4) + (g >> 2)) +
              ((g & 3) << 2));
        transpose4(b[q]);          // b[q][j]: n = wn + 4g + j
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[mi][j], a[mi], b[0][j], b[1][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the partial tile goes over the stages

  // The partial tile, [kBM][kRedPitch] int32.  Thread (g, tig) holds rows
  // g and g + 8 of each m16 tile at n = wn + 8*tig + t: tile j's c0/c2 at
  // t = j, its c1/c3 at t = 4 + j.
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int* p = red + (wm + mi * 16 + g + 8 * h) * kRedPitch + wn + 8 * tig;
      *reinterpret_cast<int4*>(p) = make_int4(acc[mi][0][2 * h], acc[mi][1][2 * h],
                                              acc[mi][2][2 * h], acc[mi][3][2 * h]);
      *reinterpret_cast<int4*>(p + 4) =
          make_int4(acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                    acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]);
    }
  cluster.sync();

  // Block s sums rows s, s + split, ... over the cluster and stores them.
  constexpr int kQuads = kBN / 4;
  const int rows = (kBM - s + split - 1) / split;
  for (int e = tid; e < rows * kQuads; e += kThreads) {
    const int r = s + (e / kQuads) * split, c = (e % kQuads) * 4;
    int4 q[kMaxSplit];             // every remote load issued before the adds
#pragma unroll
    for (int t = 0; t < kMaxSplit; ++t)
      if (t < split)
        q[t] = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(red + r * kRedPitch + c, (unsigned)t));
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < kMaxSplit; ++t)
      if (t < split) {
        v[0] += (uint32_t)q[t].x;
        v[1] += (uint32_t)q[t].y;
        v[2] += (uint32_t)q[t].z;
        v[3] += (uint32_t)q[t].w;
      }
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    float* o = out + (long long)m * N + n;
    float f[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) f[t] = __fmul_rn(__int2float_rn((int)v[t]), scale);
    if (n + 3 < N && ((uintptr_t)o & 15) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (n + t < N) o[t] = f[t];
    }
  }
  // No block leaves while its tile is read; its own reads are done, so the
  // arrive needs no release.
  cluster_arrive_relaxed();
  cluster_wait();
}

template <int XV, int WV>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int tiles, int tiles_n, int split, float scale,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmatmul_kernel<XV, WV>, (const int8_t*)x,
                            (const int8_t*)w, (float*)out, M, N, K, tiles_n,
                            split, scale);
}

// The launch for one product: output tiles, the K split over a cluster
// (about one block per SM, at most kMaxSplit and at most one per k-tile)
// and each operand's staging (16 where its row stride, K bytes for x and
// N for w, and its base pointer allow it, else 1).
struct Plan {
  long long tiles_n, tiles;
  int split, x_vec, w_vec;
};

int staging(long long row_bytes, const void* p) {
  return row_bytes % 16 == 0 && (uintptr_t)p % 16 == 0 ? 16 : 1;
}

Plan plan(const void* x, const void* w, int M, int N, int K, int sms) {
  Plan p;
  p.tiles_n = (N + kBN - 1) / kBN;
  p.tiles = (M + kBM - 1) / kBM * p.tiles_n;
  long long split = sms / (p.tiles > 0 ? p.tiles : 1);
  split = split < kMaxSplit ? split : kMaxSplit;
  const long long k_tiles = (K + kBK - 1) / kBK;
  split = split < k_tiles ? split : k_tiles;
  p.split = split > 1 ? (int)split : 1;
  p.x_vec = staging(K, x);
  p.w_vec = staging(N, w);
  return p;
}

}  // namespace

extern "C" {

// plan_out[0..3] = output tiles, split, x staging, w staging (bytes) of the
// launch repro_qmatmul makes for these arguments.
int repro_qmatmul_plan(const void* x, const void* w, int M, int N, int K,
                       int sms, int* plan_out) {
  const Plan p = plan(x, w, M, N, K, sms);
  plan_out[0] = (int)(p.tiles < 0x7fffffffLL ? p.tiles : 0x7fffffffLL);
  plan_out[1] = p.split;
  plan_out[2] = p.x_vec;
  plan_out[3] = p.w_vec;
  return 0;
}

// sms: the card's SM count, which the K split aims to fill.  Returns
// cudaErrorInvalidValue for a grid over 2^31 - 1 blocks, else the
// launch's error.  scale = float32(sx) * float32(sw).
int repro_qmatmul(const void* x, const void* w, void* out, int M, int N,
                  int K, int sms, float scale, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const Plan p = plan(x, w, M, N, K, sms);
  if (p.tiles * p.split > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tiles = (int)p.tiles, tiles_n = (int)p.tiles_n;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (p.x_vec == 16 && p.w_vec == 16)
    err = launch<16, 16>(x, w, out, M, N, K, tiles, tiles_n, p.split, scale, st);
  else if (p.x_vec == 16)
    err = launch<16, 1>(x, w, out, M, N, K, tiles, tiles_n, p.split, scale, st);
  else if (p.w_vec == 16)
    err = launch<1, 16>(x, w, out, M, N, K, tiles, tiles_n, p.split, scale, st);
  else
    err = launch<1, 1>(x, w, out, M, N, K, tiles, tiles_n, p.split, scale, st);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
