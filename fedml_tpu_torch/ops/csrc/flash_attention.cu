// Flash attention, forward and backward, for Hopper (sm_90a).
//
//   out[b,h,t,:] = softmax_s(q[b,h,t,:] . k[b,h/g,s,:] * scale, masked) @ v[b,h/g,:,:]
//   lse[b,h,t]   = log sum_s exp(...)                       (g = H / Hkv, GQA)
//
// Three kernels replace the three Pallas kernels of
// fedml_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (launched by _fwd)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (launched by _bwd)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (launched by _bwd)
// They compute the same functions: scores in f32, masked scores set to
// -0.7 * FLT_MAX, a top-left causal mask (row >= col), columns past S
// masked, rows past T never written; lse = m + log(max(l, 1e-30)) in f32;
// backward p = exp(s * scale - lse), ds = p * (dp - delta) * scale,
// dq = ds k, dv = p^T dO, dk = ds^T q, with delta = rowsum(dO * out)
// computed by the caller (the TPU code also computes it outside Pallas).
//
// Roundings the TPU kernels (all-f32 dots) do not make: p is rounded to
// bf16 before p @ v (forward) and p^T @ dO (dv), and ds before ds @ k (dq)
// and ds^T @ q (dk), because the tensor cores take bf16 operands. Every
// product is accumulated in f32. The tolerance of the comparison with the
// plain versions (chip_smoke.py phase d) is sized by these roundings.
//
// What bounds them on this card: at the training shape (T = S = 2048,
// D = 128) each (b, h) pair does ~1e9 multiply-adds on 2 MB of q/k/v, far
// above the ~295 flops/byte at which an H100 stops waiting for memory, so
// the kernels are bound by tensor-core throughput. The designs therefore
// keep the [T, S] scores out of device memory (they live in registers, and
// p and ds go from the accumulators of one product straight into the A
// operand of the next, never through shared memory).
//
//  * all three run one warpgroup a block on Hopper's wgmma. The streamed
//    tiles (K and V for the forward and dq; q and dO for dk/dv) come in by
//    TMA into 128-byte-swizzled shared memory, two stages deep, each stage
//    with its mbarrier, so the next tile's copy is in flight while the
//    tensor cores work; the TMA zero-fills rows past T or S (their scores
//    are masked all the same). The first product of each pair reads both
//    operands through wgmma descriptors, the second takes p or ds from
//    registers and its B operand transposed through the descriptor (dq's
//    first pair takes q and dO from registers). dq's q, dO and dk/dv's K,
//    V, lse, delta come by cp.async (a source size of 0 zero-fills).
//  * forward: one block per (64-row q tile, b, h), the last q tiles (the
//    most KV tiles under the causal mask) dispatched first; q comes by TMA
//    and is read from shared memory; the online softmax (running max and
//    sum, in the log2 domain) and the 64 x D accumulator stay in
//    registers; each tile issues the next tile's q k^T before its own p v,
//    so the softmax of tile kt + 1 runs while the tensor cores do p v of
//    tile kt (FlashAttention-3's overlap inside one warpgroup).
//  * dq: one block per (64-row q tile, b, h), the last q tiles (the most KV
//    tiles under the causal mask) dispatched first; q and dO are loaded
//    into registers once, as the A operands of q k^T and dO v^T, and a
//    tile's ds k product runs on while the next tile's products start.
//  * dk/dv: one block per (64-key tile, b, query head), the first key
//    tiles (the most q rows under the causal mask) first. A thread-block
//    cluster of c blocks (the largest of 8, 4, 2, 1 that divides the GQA
//    group) holds the query heads of one kv head, each block looping over
//    group / c of them; at the end the cluster sums dk and dv through
//    distributed shared memory in rank order and each block writes 64 / c
//    keys once, in bf16: no [B, H, S, D] f32 buffer, no group sum outside
//    (the TPU design's), no atomics, and two launches give the same bits.
//
// What still limits them: one warpgroup a block (two blocks an SM), so a
// block's copy issue, barriers and elementwise work sit between its
// products; FlashAttention-3 adds a producer warp (setmaxnreg) and two
// consumer warpgroups that take turns, and the forward could take 128-key
// tiles. Those, and deeper pipelines, are later work.
//
// Plain C interface, loaded with ctypes (fedml_tpu_torch/ops/_build.py).
// Inputs: bf16, contiguous [B, H, T, D] (q, out, dO, dq) and [B, Hkv, S, D]
// (k, v, dk, dv), f32 [B, H, T] (lse, delta), D in {64, 128}, 16-byte
// aligned. Launches go on the given stream, never synchronise and allocate
// nothing; each entry point returns cudaGetLastError() as an int.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int kThreads = 128;  // 4 warps
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Dims {
  int b, h, hkv, t, s, causal;
  float scale;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Asynchronous copies (cp.async): the bytes land in shared memory while the
// thread goes on; a source size of 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Per-row values (lse, delta) of rows [row0, row0 + ROWS); 0 past n_rows.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0,
                                                int n_rows) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool in = row0 + i < n_rows;
    cp_async4(dst + i, src + (in ? row0 + i : 0), in);
  }
}

// Store a warp's 16 x D f32 accumulator as bf16 rows row_a, row_a + 8 of a
// row-major [n_rows, D] matrix (rows past n_rows are skipped).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[NT][4],
                                           int row_a, int n_rows, float s0, float s1) {
  const int tq = threadIdx.x & 3;
  constexpr int D = NT * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_a + half * 8;
    if (row >= n_rows) continue;
    const float sc = half ? s1 : s0;
    bf16* out = dst + (size_t)row * D + tq * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) =
          pack_bf16(acc[j][2 * half] * sc, acc[j][2 * half + 1] * sc);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Hopper pieces of the kernels: 128-byte-swizzled tiles filled by TMA or
// cp.async, read by wgmma through shared-memory descriptors
// ---------------------------------------------------------------------------
// A [ROWS, D] bf16 tile is D / 64 column blocks of [ROWS][64] (128 bytes a
// row, 1024-byte aligned), each 16-byte chunk c of row r stored at chunk
// c ^ (r % 8): the layout of a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B and
// of wgmma's 128-byte swizzle mode. Rows past n_rows are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_sw(bf16* dst, const bf16* src, int row0,
                                             int n_rows) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + (c / 8) * ROWS * 64 + r * 64 + ((c % 8) ^ (r % 8)) * 8,
               src + (size_t)(in ? row0 + r : 0) * D + c * 8, in);
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major operand (a swizzled [ROWS, D] tile whose D is the product's depth):
// its depth slice [16 kk, 16 kk + 16). Eight-row groups are 1024 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return smem_desc(tile + (kk / 4) * ROWS * 64 + (kk % 4) * 16, 16, 1024);
}

// MN-major operand (a swizzled [ROWS, D] tile whose ROWS are the product's
// depth and D its width, read transposed): depth rows [16 kk, 16 kk + 16).
// Column blocks of 64 are ROWS * 128 bytes apart, eight-row groups 1024.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return smem_desc(tile + kk * 16 * 64, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses to registers a wgmma is writing
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
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

// cp.async writes are seen by wgmma (the async proxy) after this fence and
// a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
}

// The bf16 A operand of step kk (16 columns) of a product whose left factor
// is an accumulator of 8-wide column tiles (rounded to bf16 here): tiles
// 2 kk and 2 kk + 1.
template <int NT>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&p)[NT][4], int kk) {
  a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// The bf16 A operand of step kk (16 columns) of the 16 rows from row0 of a
// swizzled [ROWS, D] tile, read from shared memory: the layout of a_frag.
template <int ROWS>
__device__ __forceinline__ void a_frag_sw(uint32_t (&a)[4], const bf16* tile, int row0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + g + (i & 1) * 8, c = kk * 16 + (i >> 1) * 8 + tq * 2;
    a[i] = *reinterpret_cast<const uint32_t*>(
        tile + (c / 64) * ROWS * 64 + r * 64 + (((c % 64) / 8) ^ (r % 8)) * 8 + c % 8);
  }
}

// 1024-byte-aligned start of the dynamic shared memory (the swizzle
// pattern repeats every 1024 bytes); launches ask for kAlign bytes more
constexpr int kAlign = 1024;
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// TMA: one thread asks for a whole tile; the copy engine writes it into
// shared memory in the 128-byte swizzle (zero-filling rows past the
// tensor's end) and reports its bytes to an mbarrier, which the consumers
// wait on. One barrier per pipeline stage, one phase per use of the stage.
// The issuing thread is chosen by a predicate inside the asm, not by a
// branch: with a branch between a KV tile's first wgmmas and its last,
// ptxas (CUDA 12.8) reused the registers of dq's loop-invariant wgmma A
// operands for ds, which gave wrong dq at head_dim 64.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of a phase, which also expects `bytes` of copies (only
// where pred holds)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred P;\nsetp.ne.b32 P, %2, 0;\n"
      "@P mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Rows [row0, row0 + ROWS) of head `head` of a [heads, rows, D] bf16 tensor
// (its map: dims {D, rows, heads}, box {64, ROWS, 1}, 128-byte swizzle)
// into a swizzled [ROWS, D] tile, one copy per 64-column block (only where
// pred holds).
template <int ROWS, int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row0, int head, bool pred) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    asm volatile(
        "{\n.reg .pred P;\nsetp.ne.b32 P, %6, 0;\n"
        "@P cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(smem_u32(dst + cb * ROWS * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(cb * 64), "r"(row0),
        "r"(head), "r"(static_cast<int>(pred))
        : "memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, both operands K-major in
// shared memory (descriptors), bf16 in, f32 out: one warpgroup. With
// accumulate 0 the old d is ignored, so d needs no zeroing (zeroing would
// write accumulator registers while earlier wgmma groups are in flight,
// which makes ptxas serialise them).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A from registers (the mma.sync
// A fragment of each warp's 16 rows), B in shared memory: MN-major (read
// transposed) when TB is 1, K-major when 0
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], as wgmma_rs above
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// ---------------------------------------------------------------------------
// forward: replaces _fwd_kernel
// ---------------------------------------------------------------------------
constexpr int kFwdM = 64, kFwdN = 64;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// q, two stages of K, V (all swizzled [64, D]), then three mbarriers (the
// two stages', q's)
template <int D>
__host__ __device__ constexpr int fwd_tiles() { return (kFwdM + 2 * 2 * kFwdN) * D * 2; }

template <int D>
constexpr int fwd_smem() { return fwd_tiles<D>() + 3 * 8 + kAlign; }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KV tile (keys from k0) of the online softmax, in the log2 domain:
// the scores scaled by scale * log2(e) and masked by a select (columns past
// S, and col > row under the causal mask, at kMaskValue); m becomes the new
// running max of this thread's two rows, alpha = 2^(old m - new m) rescales
// the old sums (0 on the first tile), s becomes p = 2^(x - m) and rs its
// row sums over this thread's columns (the quad's other threads hold the
// rest, as in the accumulator layout).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], int k0, int row_a,
                                             const Dims& p, float scale2, float (&m)[2],
                                             float (&alpha)[2], float (&rs)[2]) {
  const int tq = threadIdx.x & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_a + (e >> 1) * 8, col = k0 + j * 8 + tq * 2 + (e & 1);
      const bool masked = col >= p.s || (p.causal && col > row);
      const float x = masked ? kMaskValue : s[j][e] * scale2;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = exp2_approx(m[i] - mx[i]);
    m[i] = mx[i];
    rs[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(s[j][e] - m[e >> 1]);
      rs[e >> 1] += s[j][e];
    }
}

// One block (one warpgroup) per (64-row q tile, b, h), the last q tiles (the
// most KV tiles under the causal mask) first. q comes in once by TMA and
// stays in shared memory; K and V stream through two stages filled by TMA,
// the copy of tile kt + 2 issued as soon as tile kt's stage is read. Each
// iteration issues s = q k^T of the next tile (both operands through
// descriptors) and then o += p v of this one (p from registers, in bf16; v
// transposed through its descriptor), and computes the next tile's softmax
// while the tensor cores run p v. No branch sits between a tile's first
// wgmma and its last (the mask is a select, the copy is predicated).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                 float* __restrict__ lse, Dims p) {
  constexpr int NS = kFwdN / 8, NO = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = qs + kFwdM * D;  // [stage][K, V][kFwdN][D], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + fwd_tiles<D>());

  const int h = blockIdx.x % p.h, b = blockIdx.x / p.h % p.b, hk = h / (p.h / p.hkv);
  const int q_tiles = (p.t + kFwdM - 1) / kFwdM;
  const int q0 = (q_tiles - 1 - blockIdx.x / (p.h * p.b)) * kFwdM;
  const int bh = b * p.h + h, bhk = b * p.hkv + hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
  const float scale2 = p.scale * kLog2e;

  int n_tiles = (p.s + kFwdN - 1) / kFwdN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kFwdM - 1) / kFwdN + 1);
  auto stage = [&](int kt) { return kvs + (kt & 1) * 2 * kFwdN * D; };  // K; V follows
  auto issue = [&](int kt, bool pred) {  // pred holds for one thread
    mbar_expect(&full[kt & 1], 2 * kFwdN * D * 2, pred);
    tma_tile<kFwdN, D>(stage(kt), &k_map, &full[kt & 1], kt * kFwdN, bhk, pred);
    tma_tile<kFwdN, D>(stage(kt) + kFwdN * D, &v_map, &full[kt & 1], kt * kFwdN, bhk, pred);
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    mbar_init(&full[2]);
    mbar_init_fence();
    mbar_expect(&full[2], kFwdM * D * 2, true);
    tma_tile<kFwdM, D>(qs, &q_map, &full[2], q0, bh, true);
    issue(0, true);
    issue(1, n_tiles > 1);
  }
  __syncthreads();  // the barriers are initialised

  float s[NS][4], o[NO][4];
  float m[2] = {neg_inf(), neg_inf()}, l[2], alpha[2], rs[2];
  zero(o);
  mbar_wait(&full[2], 0);  // q
  mbar_wait(&full[0], 0);  // tile 0
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    wgmma_ss_n64(s, desc_k<kFwdM>(qs, kk), desc_k<kFwdN>(stage(0), kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, 0, row_a, p, scale2, m, alpha, l);
  uint32_t a[NS / 2][4];  // p of the tile whose p v is in flight
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) a_frag(a[kk], s, kk);

  for (int kt = 0; kt + 1 < n_tiles; ++kt) {
    mbar_wait(&full[(kt + 1) & 1], ((kt + 1) >> 1) & 1);  // the next tile has landed
    const bf16* vs = stage(kt) + kFwdN * D;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(s, desc_k<kFwdM>(qs, kk), desc_k<kFwdN>(stage(kt + 1), kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) wgmma_rs<1>(o, a[kk], desc_mn<kFwdN>(vs, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // s of the next tile has landed; p v may still run
    fence_regs(s);
    softmax_tile(s, (kt + 1) * kFwdN, row_a, p, scale2, m, alpha, rs);
    wgmma_wait<0>();  // p v has landed: o and a are free
    hold_frags(a);
    fence_regs(o);
    __syncthreads();  // no warp reads tile kt's stage any more
    issue(kt + 2, threadIdx.x == 0 && kt + 2 < n_tiles);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) a_frag(a[kk], s, kk);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk)
    wgmma_rs<1>(o, a[kk], desc_mn<kFwdN>(stage(n_tiles - 1) + kFwdN * D, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  hold_frags(a);
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    inv[i] = 1.0f / li;
    const int row = row_a + i * 8;
    if (tq == 0 && row < p.t) lse[(size_t)bh * p.t + row] = m[i] * kLn2 + logf(li);
  }
  store_rows<NO>(out + (size_t)bh * p.t * D, o, row_a, p.t, inv[0], inv[1]);
}

// ---------------------------------------------------------------------------
// dq: replaces _bwd_dq_kernel
// ---------------------------------------------------------------------------
constexpr int kDqM = 64, kDqN = 64;

// q, dO, two stages of K, V (all swizzled [64, D]), then two mbarriers
template <int D>
__host__ __device__ constexpr int dq_tiles() { return (2 * kDqM + 2 * 2 * kDqN) * D * 2; }

template <int D>
constexpr int dq_smem() { return dq_tiles<D>() + 2 * 8 + kAlign; }

// One block (one warpgroup) per (64-row q tile, b, h), the last q tiles (the
// most KV tiles under the causal mask) first. K and V stream through two
// stages filled by TMA: the next tile's copy is in flight while the tensor
// cores work on this one. s = q k^T and dp = dO v^T are wgmma with q and dO
// in registers (loaded once) and k, v in shared memory; dq += ds k takes ds
// from registers and k transposed through its descriptor.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const bf16* __restrict__ q,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, Dims p) {
  constexpr int NS = kDqN / 8, NO = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kDqM * D;
  bf16* kvs = dos + kDqM * D;  // [stage][K, V][kDqN][D], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + dq_tiles<D>());

  const int h = blockIdx.x % p.h, b = blockIdx.x / p.h % p.b, hk = h / (p.h / p.hkv);
  const int q_tiles = (p.t + kDqM - 1) / kDqM;
  const int q0 = (q_tiles - 1 - blockIdx.x / (p.h * p.b)) * kDqM;
  const size_t bh = (size_t)b * p.h + h;
  const int bhk = b * p.hkv + hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

  int n_tiles = (p.s + kDqN - 1) / kDqN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kDqM - 1) / kDqN + 1);
  auto issue = [&](int kt, bool pred) {  // pred holds for one thread
    bf16* ks = kvs + (kt & 1) * 2 * kDqN * D;
    mbar_expect(&full[kt & 1], 2 * kDqN * D * 2, pred);
    tma_tile<kDqN, D>(ks, &k_map, &full[kt & 1], kt * kDqN, bhk, pred);
    tma_tile<kDqN, D>(ks + kDqN * D, &v_map, &full[kt & 1], kt * kDqN, bhk, pred);
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    mbar_init_fence();
    issue(0, true);
  }
  load_tile_sw<kDqM, D>(qs, q + bh * p.t * D, q0, p.t);
  load_tile_sw<kDqM, D>(dos, dout + bh * p.t * D, q0, p.t);
  cp_async_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    lse_r[i] = row < p.t ? lse[bh * p.t + row] : 0.0f;
    delta_r[i] = row < p.t ? delta[bh * p.t + row] : 0.0f;
  }

  // q and dO stay in registers as the A operands of s and dp: the tensor
  // cores then read only K and V from shared memory
  cp_async_wait<0>();
  __syncthreads();  // q, dO have landed; the barriers are initialised
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    a_frag_sw<kDqM>(qa[kk], qs, warp * 16, kk);
    a_frag_sw<kDqM>(da[kk], dos, warp * 16, kk);
  }

  // Tile kt's dq product is still running when tile kt + 1 starts its own
  // s and dp: the wait that lands s(kt + 1) also lands dq(kt), and only
  // then is its K/V stage refilled with tile kt + 2; a, dq's A operand,
  // stays untouched until then. No branch sits between the tile's first
  // wgmmas and its last (the mask is a select, the copy is predicated):
  // see tma_tile.
  float acc[NO][4];
  zero(acc);
  uint32_t a[NS / 2][4];
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqN;
    mbar_wait(&full[kt & 1], (kt >> 1) & 1);  // this tile has landed
    const bf16* ks = kvs + (kt & 1) * 2 * kDqN * D;
    const bf16* vs = ks + kDqN * D;

    float s[NS][4], dp[NS][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_rs<0>(s, qa[kk], desc_k<kDqN>(ks, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) wgmma_rs<0>(dp, da[kk], desc_k<kDqN>(vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // dq of the last tile and s have landed; dp may run
    hold_frags(a);
    fence_regs(acc);
    fence_regs(s);
    __syncthreads();  // no warp reads the other stage any more
    issue(kt + 1, threadIdx.x == 0 && kt + 1 < n_tiles);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row_a + i * 8, col = k0 + j * 8 + tq * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (col >= p.s || (p.causal && col > row)) x = kMaskValue;
        s[j][e] = __expf(x - lse_r[i]);  // p
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - delta_r[e >> 1]) * p.scale;  // ds
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) a_frag(a[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) wgmma_rs<1>(acc, a[kk], desc_mn<kDqN>(ks, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  hold_frags(a);
  fence_regs(acc);
  store_rows<NO>(dq + bh * p.t * D, acc, row_a, p.t, 1.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// dk/dv: replaces _bwd_dkv_kernel (and the group sum after it)
// ---------------------------------------------------------------------------
constexpr int kDkvN = 64, kDkvM = 64;
constexpr int kRedPad = 8;  // f32 of padding per row of the cluster's partial sums

// one stage: q, dO [kDkvM][D] bf16 (swizzled), lse, delta [kDkvM] f32,
// rounded up to the swizzle's 1024 bytes
template <int D>
__host__ __device__ constexpr int dkv_stage() { return (2 * kDkvM * D * 2 + 2 * kDkvM * 4 + 1023) / 1024 * 1024; }

// K, V and two stages; then (reused) the block's f32 dk and dv for the
// cluster sum
template <int D>
__host__ __device__ constexpr int dkv_body() {
  return cmax(2 * kDkvN * D * 2 + 2 * dkv_stage<D>(), 2 * kDkvN * (D + kRedPad) * 4);
}

// the body, then the stages' two mbarriers
template <int D>
constexpr int dkv_smem() { return dkv_body<D>() + 2 * 8 + kAlign; }

// The cluster size of a group: the largest of 8, 4, 2, 1 that divides it.
int dkv_cluster(int group) {
  for (int c = 8; c > 1; c /= 2)
    if (group % c == 0) return c;
  return 1;
}

// One block (one warpgroup) per (64-key tile, b, query head): the c blocks
// of a cluster share a key tile and a kv head, and block rank r takes the
// group's query heads r, r + c, ... (group / c of them). The blocks of the
// first key tiles, which see the most q rows under the causal mask, come
// first. The q tiles (with their dO, lse and delta) stream through two
// stages: the next one's copies (TMA for q and dO, cp.async for lse and
// delta) are in flight while the tensor cores work on this one. s^T = k q^T
// and dp^T = v dO^T are wgmma with both operands in shared memory; dv +=
// p^T dO and dk += ds^T q take p^T and ds^T from registers and dO, q
// transposed through their descriptors.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Dims p) {
  constexpr int NS = kDkvM / 8, NO = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kDkvN * D;
  unsigned char* stages = reinterpret_cast<unsigned char*>(vs + kDkvN * D);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + dkv_body<D>());

  cg::cluster_group cluster = cg::this_cluster();
  const int c = cluster.num_blocks(), rank = cluster.block_rank();
  const int group = p.h / p.hkv;
  int idx = blockIdx.x / c;  // the cluster's index
  const int hk = idx % p.hkv;
  idx /= p.hkv;
  const int b = idx % p.b;
  const int k0 = idx / p.b * kDkvN;
  const size_t bhk = (size_t)b * p.hkv + hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, key_a + 8

  const int q_tiles = (p.t + kDkvM - 1) / kDkvM;
  // causal: q tiles wholly above the diagonal see none of these keys
  const int first = p.causal ? min(k0 / kDkvM, q_tiles) : 0;
  const int per_head = q_tiles - first, n_iter = per_head * (group / c);
  // iteration it: query head rank + c * (it / per_head), q tile first + it % per_head
  auto head_of = [&](int it) { return b * p.h + hk * group + rank + c * (it / per_head); };
  auto issue_rows = [&](int it) {  // every thread
    const size_t bh = head_of(it);
    const int q0 = (first + it % per_head) * kDkvM;
    float* rows = reinterpret_cast<float*>(stages + (it & 1) * dkv_stage<D>() + 2 * kDkvM * D * 2);
    load_rows_async<kDkvM>(rows, lse + bh * p.t, q0, p.t);
    load_rows_async<kDkvM>(rows + kDkvM, delta + bh * p.t, q0, p.t);
  };
  auto issue_tiles = [&](int it, bool pred) {  // pred holds for one thread
    bf16* qs = reinterpret_cast<bf16*>(stages + (it & 1) * dkv_stage<D>());
    const int q0 = (first + it % per_head) * kDkvM, bh = head_of(it);
    mbar_expect(&full[it & 1], 2 * kDkvM * D * 2, pred);
    tma_tile<kDkvM, D>(qs, &q_map, &full[it & 1], q0, bh, pred);
    tma_tile<kDkvM, D>(qs + kDkvM * D, &do_map, &full[it & 1], q0, bh, pred);
  };
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    mbar_init_fence();
    if (n_iter > 0) issue_tiles(0, true);
  }
  load_tile_sw<kDkvN, D>(ks, k + bhk * p.s * D, k0, p.s);
  load_tile_sw<kDkvN, D>(vs, v + bhk * p.s * D, k0, p.s);
  if (n_iter > 0) issue_rows(0);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised

  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);
  // Iteration it's dk product is still running when iteration it + 1
  // starts its own s^T and dp^T: wgmma groups complete in order, so the
  // wait that lands s^T(it + 1) also lands dv(it), dk(it), and only then is
  // their stage refilled with q tile it + 2. ap and ads, the A operands of
  // dv and dk, stay untouched until then.
  uint32_t ap[NS / 2][4], ads[NS / 2][4];
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();  // this stage's lse, delta (and K, V) have landed
    mbar_wait(&full[it & 1], (it >> 1) & 1);  // and its q, dO
    fence_async_smem();
    __syncthreads();
    const int q0 = (first + it % per_head) * kDkvM;
    const unsigned char* st = stages + (it & 1) * dkv_stage<D>();
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* dos = qs + kDkvM * D;
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * kDkvM * D * 2);
    const float* delta_s = lse_s + kDkvM;

    // transposed scores: rows are the block's 64 keys, columns the q rows.
    // wgmma groups in flight order: s^T, dp^T, then dv (as soon as p^T is
    // known, while dp^T may still run), then dk; the exponentials and ds^T
    // are computed while the tensor cores work on the group before.
    float sp[NS][4], dpt[NS][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(sp, desc_k<kDkvN>(ks, kk), desc_k<kDkvM>(qs, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_ss_n64(dpt, desc_k<kDkvN>(vs, kk), desc_k<kDkvM>(dos, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // dv, dk of the last iteration and s^T have landed
    hold_frags(ap);
    hold_frags(ads);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(sp);
    __syncthreads();  // no warp reads the other stage any more
    if (it + 1 < n_iter) {
      issue_rows(it + 1);
      issue_tiles(it + 1, threadIdx.x == 0);
    }
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] *= p.scale;
    // only the tiles that cross the diagonal need the causal mask
    if (p.causal && q0 < k0 + kDkvN - 1) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + j * 8 + tq * 2 + (e & 1) < key_a + (e >> 1) * 8) sp[j][e] = kMaskValue;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = __expf(sp[j][e] - lse_s[j * 8 + tq * 2 + (e & 1)]);
    // phantom q rows past T carry no probability mass
    if (q0 + kDkvM > p.t) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (q0 + j * 8 + tq * 2 + (e & 1) >= p.t) sp[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) a_frag(ap[kk], sp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      wgmma_rs<1>(dv_acc, ap[kk], desc_mn<kDkvM>(dos, kk), 1);  // dv += p^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dp^T has landed (dv may still run)
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + tq * 2 + (e & 1);
        dpt[j][e] = sp[j][e] * (dpt[j][e] - delta_s[r]) * p.scale;  // ds^T
      }
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) a_frag(ads[kk], dpt, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      wgmma_rs<1>(dk_acc, ads[kk], desc_mn<kDkvM>(qs, kk), 1);  // dk += ds^T q
    wgmma_commit();
  }
  wgmma_wait<0>();
  hold_frags(ap);
  hold_frags(ads);
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  cp_async_wait<0>();  // nothing lands in the buffers reused below
  // The group sum: each block parks its f32 dk, dv in its own shared
  // memory; after the cluster barrier rank r adds the c blocks' rows
  // [r, r + 1) * 64 / c in rank order (deterministic) through distributed
  // shared memory and writes them once in bf16. The second barrier keeps
  // every block resident until its partial sums have been read.
  constexpr int LR = D + kRedPad;
  float* red = reinterpret_cast<float*>(smem);  // [2][kDkvN][LR]
  __syncthreads();  // every warp is done with the tiles
  const int kl = warp * 16 + g;  // this thread's keys in the tile: kl, kl + 8
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = (kl + half * 8) * LR + j * 8 + tq * 2;
      *reinterpret_cast<float2*>(red + off) =
          make_float2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
      *reinterpret_cast<float2*>(red + kDkvN * LR + off) =
          make_float2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  cluster.sync();
  const int rows = kDkvN / c, r0 = rank * rows;
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < 2 * rows * kVec; i += kThreads) {
    const int which = i / (rows * kVec), rem = i - which * rows * kVec;
    const int row = r0 + rem / kVec, col = (rem % kVec) * 4;
    const int off = which * kDkvN * LR + row * LR + col;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int src = 0; src < c; ++src) {
      const float4 o = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, src) + off);
      s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
    }
    if (k0 + row < p.s) {
      bf16* out = (which ? dv : dk) + (bhk * p.s + k0 + row) * D + col;
      *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    }
  }
  cluster.sync();
}

// Opt in to more than 48 KB of dynamic shared memory, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool valid(const Dims& p, int d) {
  return p.b > 0 && p.h > 0 && p.hkv > 0 && p.h % p.hkv == 0 && p.t > 0 && p.s > 0 &&
         (d == 64 || d == 128) && p.h <= 65535 && p.b <= 65535;
}

Dims make_dims(int b, int h, int hkv, int t, int s, int causal, float scale) {
  Dims p;
  p.b = b; p.h = h; p.hkv = hkv; p.t = t; p.s = s; p.causal = causal != 0;
  p.scale = scale;
  return p;
}

// cuTensorMapEncodeTiled, from the driver at run time (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The TMA map of a contiguous [heads, rows, d] bf16 tensor: 64 x 64 boxes,
// 128-byte swizzle, rows past the end read as zeros.
cudaError_t tile_map(CUtensorMap* map, const void* base, int d, int rows, int heads) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       const Dims& p, cudaStream_t st) {
  static cudaError_t attr = allow_smem(flash_fwd_kernel<D>, fwd_smem<D>());
  if (attr != cudaSuccess) return attr;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = tile_map(&q_map, q, D, p.t, p.b * p.h);
  if (err == cudaSuccess) err = tile_map(&k_map, k, D, p.s, p.b * p.hkv);
  if (err == cudaSuccess) err = tile_map(&v_map, v, D, p.s, p.b * p.hkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + kFwdM - 1) / kFwdM * p.b * p.h);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), st>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const Dims& p,
                      cudaStream_t st) {
  static cudaError_t attr = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (attr != cudaSuccess) return attr;
  CUtensorMap k_map, v_map;
  cudaError_t err = tile_map(&k_map, k, D, p.s, p.b * p.hkv);
  if (err == cudaSuccess) err = tile_map(&v_map, v, D, p.s, p.b * p.hkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t + kDqM - 1) / kDqM * p.b * p.h);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), st>>>(
      k_map, v_map, static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const Dims& p, cudaStream_t st) {
  static cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>());
  if (attr != cudaSuccess) return attr;
  CUtensorMap q_map, do_map;
  cudaError_t err = tile_map(&q_map, q, D, p.t, p.b * p.h);
  if (err == cudaSuccess) err = tile_map(&do_map, dout, D, p.t, p.b * p.h);
  if (err != cudaSuccess) return err;
  const int c = dkv_cluster(p.h / p.hkv);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = c;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.s + kDkvN - 1) / kDkvN * p.b * p.hkv * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dkv_smem<D>();
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<D>, q_map, do_map,
                           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                           static_cast<const float*>(lse), static_cast<const float*>(delta),
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: bf16 [b, h, t, d]; k, v: bf16 [b, hkv, s, d]; lse: f32 [b, h, t].
int fedml_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                         void* lse, int b, int h, int hkv, int t, int s, int d,
                         int causal, float scale, void* stream) {
  const Dims p = make_dims(b, h, hkv, t, s, causal, scale);
  if (!valid(p, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 128 ? launch_fwd<128>(q, k, v, out, lse, p, st)
                                   : launch_fwd<64>(q, k, v, out, lse, p, st));
}

// dout, dq: bf16 [b, h, t, d]; lse, delta: f32 [b, h, t].
int fedml_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            void* dq, int b, int h, int hkv, int t, int s, int d,
                            int causal, float scale, void* stream) {
  const Dims p = make_dims(b, h, hkv, t, s, causal, scale);
  if (!valid(p, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d == 128 ? launch_dq<128>(q, k, v, dout, lse, delta, dq, p, st)
               : launch_dq<64>(q, k, v, dout, lse, delta, dq, p, st));
}

// dk, dv: bf16 [b, hkv, s, d], summed over each kv head's group of q heads.
int fedml_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int b, int h, int hkv, int t, int s,
                             int d, int causal, float scale, void* stream) {
  const Dims p = make_dims(b, h, hkv, t, s, causal, scale);
  if (!valid(p, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      d == 128 ? launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, p, st)
               : launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, p, st));
}

// Dynamic shared memory of a launch at head_dim d: kernel 0 forward, 1 dq,
// 2 dk/dv; -1 for anything else.
int fedml_flash_smem_bytes(int kernel, int d) {
  if (d != 64 && d != 128) return -1;
  switch (kernel) {
    case 0: return d == 128 ? fwd_smem<128>() : fwd_smem<64>();
    case 1: return d == 128 ? dq_smem<128>() : dq_smem<64>();
    case 2: return d == 128 ? dkv_smem<128>() : dkv_smem<64>();
    default: return -1;
  }
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
