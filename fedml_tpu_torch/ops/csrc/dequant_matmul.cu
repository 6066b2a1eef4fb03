// Fused int8 weight-only dequant-matmul for Hopper (sm_90a).
//
//   out[M, F] = bf16( (x_bf16[M, H] @ float(W_int8[H, F])) * scale_f32[F] )
//
// Replaces the TPU kernel fedml_tpu/ops/quant.py::_dequant_matmul_kernel
// (launched by pallas_dequant_matmul). Same arithmetic: every int8 code is
// exact in bf16 and every bf16 x bf16 product is exact in f32, the sum over
// H is kept in f32, and the per-column scale is applied in f32 after the
// sum, before the one rounding to bf16. Only the order of the f32 sum
// differs.
//
// What bounds it: memory. Serving calls it with M <= 128 rows: at the
// decode's 8 rows that is ~16 flops per weight byte, far below the ~295
// flops/byte at which an H100 stops waiting for memory; at 128 rows ~256,
// near the line. So the weight is streamed from device memory exactly once
// a launch, as int8, and no converted copy of it is written anywhere.
//
// Design:
//  * Tensor cores at every row count, computing out^T = W^T x^T: the
//    weight is the A operand with F on the product's rows, and the rows of
//    x are its n columns, so at 8 decode rows no work is spent on padding.
//    The int8 codes become bf16 in registers (the 2^23 mantissa trick to
//    an exact f32, then a packing conversion); the order of F within a tile
//    is free, so a thread's columns of a weight row are bytes of one
//    16-byte chunk. Up to 32 rows, mma.sync m16n8k16 with x's fragments
//    loaded from shared memory (dequant_matmul_kernel); from 33 rows, wgmma
//    m64 n64/n128 k16 with the converted weight as its register A operand
//    and x read by the tensor cores from 128-byte-swizzled shared memory
//    (dequant_matmul_wgmma_kernel).
//  * A block of 4 warps owns 128 columns and all rows of x (padded to 8,
//    16, 32, 64 or 128): each weight byte is read once a launch, whatever
//    the row count. Its warps split the columns, the rows (n-tiles) and the
//    depth as the row count's instance says (FEDML_DEQUANT_INSTANCES); in
//    the wgmma kernel each weight byte is converted by one warp.
//  * The weight (128 or 64 H-rows x 128 columns a stage, 16-byte chunks
//    swizzled against bank conflicts) and the matching slice of x stream
//    through a 4-stage cp.async ring, so three stages of copies are in
//    flight while the tensor cores work on the fourth.
//  * Split-K across the blocks of a thread-block cluster (c of 1, 2, 4, 8,
//    chosen by the caller, ops/quant.py::dequant_splits): block rank r sums
//    H-rows [r, r + 1) * H / c. Each block parks its f32 partial sums in its
//    shared memory; after a cluster barrier rank r adds columns [r, r + 1) *
//    128 / c of every block in rank order through distributed shared memory,
//    scales them and writes them once in bf16: no atomics, no f32 buffer in
//    device memory, and two launches give the same bits.
//
// What still limits it: the cluster cap of 8 leaves k/v_proj (F = 1024) at
// 64 blocks on 132 SMs, and each of a decode step's 225 launches pays its
// own fill and tail. From 33 rows every 128-column block reads all of x
// again from L2 (at 128 rows twice the weight's bytes), and one warpgroup
// a block converts, issues and waits in turn; wider column blocks, x
// shared across a cluster and a producer warp are the next steps.
//
// Plain C interface, loaded with ctypes (fedml_tpu_torch/ops/_build.py);
// the launch never synchronises and allocates nothing; the caller checks
// the returned cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;                    // output columns per block
constexpr int kSplitRows = 128;               // H-rows: the unit of the split
constexpr int kStages = 4;
constexpr int kRedLd = kCols + 4;             // f32 per parked row of partial sums

// One instance's shape: KC H-rows a stage, MP rows of x (8 NTW WN), each
// warp TPW of the 8 column tiles (WF = 8 / TPW warps along the columns),
// NTW n-tiles, WN warps along the rows and WK = 4 / (WF WN) along the depth.
template <int KC, int TPW, int NTW, int WN>
struct Shape {
  static constexpr int WF = 8 / TPW, WK = kWarps / (WF * WN), MP = 8 * NTW * WN;
  static constexpr int XLD = KC + 8;  // bf16 per staged row of x (padded)
  static constexpr int W_BYTES = KC * kCols, STAGE = W_BYTES + MP * XLD * 2;
  static constexpr int RED = WK * MP * kRedLd * 4;
  static constexpr int SMEM = STAGE * kStages > RED ? STAGE * kStages : RED;
  static_assert(WF * WN * WK == kWarps && KC % 16 == 0, "warps must tile the block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte I of the biased codes u (each code xor 0x80) as an exact float:
// splice the byte under the exponent of 2^23 and subtract 2^23 + 128.
template <int I, int N>
__device__ __forceinline__ float code(const uint32_t (&u)[N]) {
  return __uint_as_float(__byte_perm(u[I / 4], 0x4B000000u, 0x7440 + I % 4)) - 8388736.0f;
}

// bf16 pair (lo: byte I of row a, hi: byte I of row b), exact
template <int I, int N>
__device__ __forceinline__ uint32_t pair(const uint32_t (&a)[N], const uint32_t (&b)[N]) {
  __nv_bfloat162 v = __floats2bfloat162_rn(code<I>(a), code<I>(b));
  return *reinterpret_cast<uint32_t*>(&v);
}

// A thread's bytes of one weight row of a stage: its 16-byte chunk g holds
// columns 16 g .. 16 g + 15, stored at chunk g ^ (r % 8) so that the 8
// threads of a quarter warp, which read 4 rows (2 tq each), hit 8 different
// bank groups. The warp's TPW tiles from t0 take bytes [t0, t0 + TPW) (lo)
// and [t0 + 8, t0 + 8 + TPW) (hi), biased (xor 0x80 a byte).
template <int TPW>
__device__ __forceinline__ void load_row(uint32_t (&lo)[TPW / 4], uint32_t (&hi)[TPW / 4],
                                         const unsigned char* ws, int r, int g, int t0) {
  const unsigned char* p = ws + r * kCols + ((g ^ (r & 7)) << 4);
  if constexpr (TPW == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    lo[0] = v.x; lo[1] = v.y; hi[0] = v.z; hi[1] = v.w;
  } else {
    lo[0] = *reinterpret_cast<const uint32_t*>(p + t0);
    hi[0] = *reinterpret_cast<const uint32_t*>(p + 8 + t0);
  }
#pragma unroll
  for (int i = 0; i < TPW / 4; ++i) {
    lo[i] ^= 0x80808080u;
    hi[i] ^= 0x80808080u;
  }
}

// One depth step of tile T (of the warp's TPW): the A fragment's row g is
// column t0 + T + 16 g, row g + 8 column t0 + T + 16 g + 8; its k pairs
// come from rows r0, r0 + 1 (a0, a1) and r0 + 8, r0 + 9 (a2, a3).
template <int T, int TPW, int NTW>
__device__ __forceinline__ void mma_tile(float (&acc)[TPW][NTW][4],
                                         const uint32_t (&lo)[4][TPW / 4],
                                         const uint32_t (&hi)[4][TPW / 4],
                                         const uint32_t (&bx)[NTW][2]) {
  const uint32_t a0 = pair<T>(lo[0], lo[1]), a1 = pair<T>(hi[0], hi[1]);
  const uint32_t a2 = pair<T>(lo[2], lo[3]), a3 = pair<T>(hi[2], hi[3]);
#pragma unroll
  for (int j = 0; j < NTW; ++j) mma_bf16(acc[T][j], a0, a1, a2, a3, bx[j][0], bx[j][1]);
}

template <int TPW, int NTW, int... T>
__device__ __forceinline__ void mma_tiles(float (&acc)[TPW][NTW][4],
                                          const uint32_t (&lo)[4][TPW / 4],
                                          const uint32_t (&hi)[4][TPW / 4],
                                          const uint32_t (&bx)[NTW][2]) {
  (mma_tile<T>(acc, lo, hi, bx), ...);
}

// The cluster's sum, after each block has parked its partial sums in
// red[k][n][column] (f32, k < WK depth partials): rank r adds columns
// [r, r + 1) * kCols / c of every row over the cluster's blocks (in rank
// order) and their depth partials, scales them and writes them once in
// bf16. The barriers keep every block resident until its sums are read.
template <int WK, int MP>
__device__ __forceinline__ void reduce_cluster(const float* red, const float* __restrict__ scale,
                                               bf16* __restrict__ out, int rows, int f,
                                               int col0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = cluster.num_blocks(), rank = cluster.block_rank();
  cluster.sync();
  const int vec = kCols / c / 4, f0 = rank * (kCols / c);
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int n = i / vec, fl = f0 + (i % vec) * 4;
    // every remote read is issued before the first sum, then the sums are
    // taken in rank order
    float4 part[8][WK];
#pragma unroll
    for (int src = 0; src < 8; ++src)
      if (src < c) {
        const float* rs = cluster.map_shared_rank(red, src);
#pragma unroll
        for (int k = 0; k < WK; ++k)
          part[src][k] = *reinterpret_cast<const float4*>(rs + (k * MP + n) * kRedLd + fl);
      }
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int src = 0; src < 8; ++src)
      if (src < c) {
#pragma unroll
        for (int k = 0; k < WK; ++k) {
          s.x += part[src][k].x; s.y += part[src][k].y;
          s.z += part[src][k].z; s.w += part[src][k].w;
        }
      }
    const float4 sc = *reinterpret_cast<const float4*>(scale + col0 + fl);
    __nv_bfloat162 lo = __floats2bfloat162_rn(s.x * sc.x, s.y * sc.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(s.z * sc.z, s.w * sc.w);
    *reinterpret_cast<uint2*>(out + (size_t)n * f + col0 + fl) =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
  cluster.sync();
}

// One block of 4 warps per (128 columns, H-slice); the blocks of a cluster
// share the columns and split H (module comment). The instance's Shape
// says how its warps tile the columns, rows and depth.
template <int KC, int TPW, int NTW, int WN>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, bf16* __restrict__ out,
                      int rows, int h, int f) {
  using S = Shape<KC, TPW, NTW, WN>;
  constexpr int WK = S::WK, MP = S::MP, XLD = S::XLD;
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = cluster.num_blocks(), rank = cluster.block_rank();
  const int col0 = blockIdx.x / c * kCols;
  const int hs = h / c, h0 = rank * hs, n_chunks = hs / KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wk = warp % WK, wn = warp / WK % WN, t0 = warp / (WK * WN) * TPW;

  const int8_t* wb = w + (size_t)h0 * f + col0;
  const bf16* xb = x + h0;
  auto load_stage = [&](int ch) {  // every thread
    unsigned char* st = smem + (ch % kStages) * S::STAGE;
    for (int i = threadIdx.x; i < KC * 8; i += kThreads) {
      const int r = i >> 3, cc = i & 7;
      cp_async16(st + r * kCols + ((cc ^ (r & 7)) << 4),
                 wb + (size_t)(ch * KC + r) * f + cc * 16, true);
    }
    bf16* xs = reinterpret_cast<bf16*>(st + S::W_BYTES);
    for (int i = threadIdx.x; i < MP * (KC / 8); i += kThreads) {
      const int n = i / (KC / 8), cc = i % (KC / 8);
      const bool in = n < rows;
      cp_async16(xs + n * XLD + cc * 8, xb + (size_t)(in ? n : 0) * h + ch * KC + cc * 8, in);
    }
  };

  float acc[TPW][NTW][4];
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int j = 0; j < NTW; ++j) acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_stage(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();  // chunk ch has landed
    __syncthreads();               // and no warp still reads the stage refilled below
    if (ch + kStages - 1 < n_chunks) load_stage(ch + kStages - 1);
    cp_async_commit();
    const unsigned char* ws = smem + (ch % kStages) * S::STAGE;
    const bf16* xs = reinterpret_cast<const bf16*>(ws + S::W_BYTES);
#pragma unroll
    for (int kk = wk; kk < KC / 16; kk += WK) {
      const int r0 = kk * 16 + 2 * tq;
      uint32_t lo[4][TPW / 4], hi[4][TPW / 4], bx[NTW][2];
      load_row<TPW>(lo[0], hi[0], ws, r0, g, t0);
      load_row<TPW>(lo[1], hi[1], ws, r0 + 1, g, t0);
      load_row<TPW>(lo[2], hi[2], ws, r0 + 8, g, t0);
      load_row<TPW>(lo[3], hi[3], ws, r0 + 9, g, t0);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const bf16* xr = xs + ((wn * NTW + j) * 8 + g) * XLD + kk * 16 + 2 * tq;
        bx[j][0] = *reinterpret_cast<const uint32_t*>(xr);
        bx[j][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
      if constexpr (TPW == 8)
        mma_tiles<TPW, NTW, 0, 1, 2, 3, 4, 5, 6, 7>(acc, lo, hi, bx);
      else
        mma_tiles<TPW, NTW, 0, 1, 2, 3>(acc, lo, hi, bx);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages, reused below

  // Park the partial sums: red[wk][n][column], f32. Tile T's accumulator
  // holds columns 16 g + t0 + T (c0, c1) and 16 g + 8 + t0 + T (c2, c3) of
  // rows 2 tq, 2 tq + 1 of its n-tile.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int n = (wn * NTW + j) * 8 + 2 * tq;
      float* r = red + (wk * MP + n) * kRedLd + 16 * g + t0 + t;
      r[0] = acc[t][j][0];
      r[kRedLd] = acc[t][j][1];
      r[8] = acc[t][j][2];
      r[kRedLd + 8] = acc[t][j][3];
    }
  reduce_cluster<WK, MP>(red, scale, out, rows, f, col0);
}

// ---------------------------------------------------------------------------
// 33-128 rows: the weight tiles as wgmma's register A operand
// ---------------------------------------------------------------------------
// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async writes are seen by wgmma (the async proxy) after this fence and
// a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma reads its register A operand until the wait that retires it, but
// the compiler counts the registers free once the instruction is issued:
// this "use" after that wait keeps them from being reused in between.
template <int N>
__device__ __forceinline__ void hold_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// keep the compiler from moving accesses to registers a wgmma is writing
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (each warp's 16
// rows in the mma.sync A layout), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], as above
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// byte `sel` (0..3, at run time) of a biased word as an exact float
__device__ __forceinline__ float code_at(uint32_t u, int sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | sel)) - 8388736.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kWgChunk = 64;  // H-rows a stage: x's [MP][64] bf16 is one swizzled block
constexpr int kAlign = 1024;  // the 128-byte swizzle repeats every 1024 bytes

template <int MP>
struct WgShape {
  static constexpr int W_BYTES = kWgChunk * kCols, STAGE = W_BYTES + MP * kWgChunk * 2;
  static constexpr int RED = MP * kRedLd * 4;
  static constexpr int SMEM = (STAGE * kStages > RED ? STAGE * kStages : RED) + kAlign;
  static_assert(STAGE % kAlign == 0, "each stage's x tile starts on the swizzle's period");
};

// One warpgroup per (128 columns, H-slice), all MP rows of x. Warp w
// converts column tiles w and w + 4 (in the order of the mma.sync kernel:
// tile t's row g is column 16 g + t, row g + 8 column 16 g + 8 + t), which
// are rows 16 w .. 16 w + 15 of the two 64-row halves of W^T: each weight
// byte is converted once. x sits in the stage as wgmma's K-major B operand
// (128-byte swizzle), so the tensor cores read it from shared memory and
// no thread loads it. A stage's 4 depth steps each issue the two halves'
// wgmma (m64 n = MP k16) as soon as their A operands are converted, so the
// next step's conversion overlaps them; the stage ends with their wait,
// before its buffer is refilled.
template <int MP>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_wgmma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                            const float* __restrict__ scale, bf16* __restrict__ out,
                            int rows, int h, int f) {
  using S = WgShape<MP>;
  constexpr int NT = MP / 8, KD = kWgChunk / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((kAlign - (base & (kAlign - 1))) & (kAlign - 1));

  cg::cluster_group cluster = cg::this_cluster();
  const int c = cluster.num_blocks(), rank = cluster.block_rank();
  const int col0 = blockIdx.x / c * kCols;
  const int hs = h / c, h0 = rank * hs, n_chunks = hs / kWgChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const int8_t* wb = w + (size_t)h0 * f + col0;
  const bf16* xb = x + h0;
  auto load_stage = [&](int ch) {  // every thread
    unsigned char* st = smem + (ch % kStages) * S::STAGE;
    for (int i = threadIdx.x; i < kWgChunk * 8; i += kThreads) {
      const int r = i >> 3, cc = i & 7;
      cp_async16(st + r * kCols + ((cc ^ (r & 7)) << 4),
                 wb + (size_t)(ch * kWgChunk + r) * f + cc * 16, true);
    }
    unsigned char* xs = st + S::W_BYTES;  // [MP][64] bf16, 16-byte chunk c of row n at c ^ n % 8
    for (int i = threadIdx.x; i < MP * 8; i += kThreads) {
      const int n = i >> 3, cc = i & 7;
      const bool in = n < rows;
      cp_async16(xs + n * 128 + ((cc ^ (n & 7)) << 4),
                 xb + (size_t)(in ? n : 0) * h + ch * kWgChunk + cc * 8, in);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[hh][j][0] = acc[hh][j][1] = acc[hh][j][2] = acc[hh][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_stage(s);
    cp_async_commit();
  }
  uint32_t a[KD][2][4];
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();  // chunk ch has landed
    fence_async_smem();
    __syncthreads();  // for every thread; no wgmma reads the stage refilled below
    if (ch + kStages - 1 < n_chunks) load_stage(ch + kStages - 1);
    cp_async_commit();
    const unsigned char* ws = smem + (ch % kStages) * S::STAGE;
    const unsigned char* xs = ws + S::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int r0 = kk * 16 + 2 * tq;
      uint32_t u[4][4];  // rows r0, r0 + 1, r0 + 8, r0 + 9: the thread's 16-byte chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + (i & 1) + (i >> 1) * 8;
        const uint4 v = *reinterpret_cast<const uint4*>(ws + r * kCols + ((g ^ (r & 7)) << 4));
        u[i][0] = v.x ^ 0x80808080u; u[i][1] = v.y ^ 0x80808080u;
        u[i][2] = v.z ^ 0x80808080u; u[i][3] = v.w ^ 0x80808080u;
      }
      // tile warp + 4 hh: bytes warp + 4 hh (word hh) and + 8 (word hh + 2)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        a[kk][hh][0] = pack_bf16(code_at(u[0][hh], warp), code_at(u[1][hh], warp));
        a[kk][hh][1] = pack_bf16(code_at(u[0][hh + 2], warp), code_at(u[1][hh + 2], warp));
        a[kk][hh][2] = pack_bf16(code_at(u[2][hh], warp), code_at(u[3][hh], warp));
        a[kk][hh][3] = pack_bf16(code_at(u[2][hh + 2], warp), code_at(u[3][hh + 2], warp));
      }
      const uint64_t db = smem_desc(xs + kk * 32, 16, 1024);
      wgmma_fence();
      wgmma_rs(acc[0], a[kk][0], db);
      wgmma_rs(acc[1], a[kk][1], db);
      wgmma_commit();
    }
    wgmma_wait_all();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) hold_frags(a[kk]);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages, reused below

  // Park the partial sums: red[n][column], f32. Half hh's accumulator rows
  // 16 warp + g (c0, c1) and + 8 (c2, c3) are tile warp + 4 hh's columns
  // 16 g + warp + 4 hh and 16 g + 8 + warp + 4 hh; its columns n = 8 j +
  // 2 tq (+ 1) are rows of x.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* r = red + (8 * j + 2 * tq) * kRedLd + 16 * g + warp + 4 * hh;
      r[0] = acc[hh][j][0];
      r[kRedLd] = acc[hh][j][1];
      r[8] = acc[hh][j][2];
      r[kRedLd + 8] = acc[hh][j][3];
    }
  reduce_cluster<1, MP>(red, scale, out, rows, f, col0);
}

using Kernel = void (*)(const bf16*, const int8_t*, const float*, bf16*, int, int, int);

// f / 128 * splits blocks of 128 threads in clusters of `splits`, after the
// kernel's opt-in to `bytes` of dynamic shared memory (`attr`, once)
cudaError_t launch_in_clusters(Kernel kernel, cudaError_t attr, int bytes, const void* x,
                               const void* w, const void* scale, void* out, int rows, int h,
                               int f, int splits, cudaStream_t stream) {
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(f / kCols * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out), rows, h, f);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int KC, int TPW, int NTW, int WN>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int rows,
                   int h, int f, int splits, cudaStream_t stream) {
  const Kernel kernel = dequant_matmul_kernel<KC, TPW, NTW, WN>;
  constexpr int bytes = Shape<KC, TPW, NTW, WN>::SMEM;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return launch_in_clusters(kernel, attr, bytes, x, w, scale, out, rows, h, f, splits, stream);
}

template <int MP>
cudaError_t launch_wgmma(const void* x, const void* w, const void* scale, void* out, int rows,
                         int h, int f, int splits, cudaStream_t stream) {
  const Kernel kernel = dequant_matmul_wgmma_kernel<MP>;
  constexpr int bytes = WgShape<MP>::SMEM;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return launch_in_clusters(kernel, attr, bytes, x, w, scale, out, rows, h, f, splits, stream);
}

// The mma.sync instance for up to 32 rows: (rows, KC, TPW, NTW, WN). Up to
// 16 rows every warp covers all 8 column tiles and the 4 warps split the
// depth; at 17-32 two warps split the columns and two the depth. From 33
// rows the wgmma kernel takes over (x padded to 64 or 128 rows).
#define FEDML_DEQUANT_INSTANCES(X) \
  X(8, 128, 8, 1, 1) X(16, 128, 8, 2, 1) X(32, 128, 4, 4, 1)

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x: bf16 [rows, h]; w: int8 [h, f]; scale: f32 [f]; out: bf16 [rows, f].
// All contiguous; x, w and scale 16-byte aligned, out 8-byte aligned.
// Requires 1 <= rows <= 128, f a multiple of 128 (the TPU kernel's
// dispatch conditions) and h a multiple of 128 * splits, with splits (the
// cluster's blocks, each summing h / splits H-rows) one of 1, 2, 4, 8.
// Returns a cudaError_t as int: 0 when the launch was accepted.
int fedml_dequant_matmul_bf16(const void* x, const void* w, const void* scale, void* out,
                              int rows, int h, int f, int splits, void* stream) {
  if (rows < 1 || rows > 128 || f < kCols || f % kCols != 0 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) || h < kSplitRows * splits ||
      h % (kSplitRows * splits) != 0 || !aligned16(x) || !aligned16(w) || !aligned16(scale) ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FEDML_LAUNCH(R, KC, TPW, NTW, WN)                                            \
  if (rows <= R)                                                                     \
    return static_cast<int>(launch<KC, TPW, NTW, WN>(x, w, scale, out, rows, h, f, splits, s));
  FEDML_DEQUANT_INSTANCES(FEDML_LAUNCH)
#undef FEDML_LAUNCH
  const cudaError_t err = rows <= 64 ? launch_wgmma<64>(x, w, scale, out, rows, h, f, splits, s)
                                     : launch_wgmma<128>(x, w, scale, out, rows, h, f, splits, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of the launch for `rows` rows; -1 outside 1..128.
int fedml_dequant_smem_bytes(int rows) {
  if (rows < 1) return -1;
#define FEDML_SMEM(R, KC, TPW, NTW, WN) \
  if (rows <= R) return Shape<KC, TPW, NTW, WN>::SMEM;
  FEDML_DEQUANT_INSTANCES(FEDML_SMEM)
#undef FEDML_SMEM
  if (rows <= 64) return WgShape<64>::SMEM;
  if (rows <= 128) return WgShape<128>::SMEM;
  return -1;
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
