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
// the kernels are bound by tensor-core throughput. The design therefore
// keeps the [T, S] scores out of device memory (they live in registers,
// one 16-row slice per warp, as in FlashAttention-2) and feeds the tensor
// cores with mma.sync m16n8k16 bf16 -> f32. The score fragments are reused
// directly as the A operand of the next product, so p and ds never touch
// shared memory either.
//
// Layout: one 128-thread block (4 warps). Tiles are staged in shared
// memory with rows padded by 8 bf16, which makes both the row-contiguous
// 32-bit fragment loads and the 16-bit loads down a column (the transposed
// operand of p @ v, ds @ k, p^T @ dO, ds^T @ q) free of bank conflicts.
//  * forward: one block per (q tile of 64 rows, h, b); a loop over the KV
//    tiles up to the diagonal stands in for the TPU's sequential kv grid
//    axis; running max, sum and the 16 x D accumulator stay in registers.
//  * dq: one block per (q tile of 64, h, b), looping over the KV tiles and
//    recomputing p from lse.
//  * dk/dv: one block per (kv tile of 64, kv head, b), looping over the
//    group's query heads and, for each, the q tiles (32 rows) from the
//    diagonal on. dk and dv of the whole group sum in registers and are
//    written once, in k's dtype: no [B, H, S, D] f32 buffer and no group
//    sum outside (the TPU design's).
//
// Known weaknesses, left for later work: no asynchronous copies (each
// tile's global loads and its products are serialised by __syncthreads),
// mma.sync rather than wgmma with TMA, and under a causal mask the dk/dv
// blocks of early KV tiles carry H/Hkv times more q tiles than the last.
//
// Plain C interface, loaded with ctypes (fedml_tpu_torch/ops/_build.py).
// Inputs: bf16, contiguous [B, H, T, D] (q, out, dO, dq) and [B, Hkv, S, D]
// (k, v, dk, dv), f32 [B, H, T] (lse, delta), D in {64, 128}, 16-byte
// aligned. Launches go on the given stream, never synchronise and allocate
// nothing; each entry point returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
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

// two adjacent bf16 of a row (the lower column in the low half)
__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] in the low half, p[stride] (one row down) in the high half
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return lo | (hi << 16);
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

// Stage rows [row0, row0 + ROWS) of a row-major [n_rows, D] bf16 matrix in
// shared memory (row stride D + kPad), 16 bytes per thread per step; rows
// past n_rows are zero-filled, so phantom rows add nothing and stay finite.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n_rows) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = v;
  }
}

// Per-row values (lse, delta) of rows [row0, row0 + ROWS); 0 past n_rows.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads)
    dst[i] = row0 + i < n_rows ? src[row0 + i] : 0.0f;
}

// One warp: acc[j] += A[16 x K] * B[8j .. 8j+7, 0 .. K)^T for j < NT, where
// A and B are row-major in shared memory with k contiguous (q k^T, dO v^T,
// k q^T, v dO^T). Fragment layout of mma.m16n8k16: lane = 4 g + tq; A holds
// rows g, g+8 and columns 2tq(+1), 2tq+8(+1); B column n = g, rows 2tq(+1),
// 2tq+8(+1); the accumulator rows g (c0, c1) and g+8 (c2, c3), columns
// 2tq, 2tq+1 of each 8-wide tile.
template <int NT, int K>
__device__ __forceinline__ void warp_gemm_nt(float (&acc)[NT][4], const bf16* a_tile,
                                             const bf16* b_tile, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* a = a_tile + g * ld + k0 + tq * 2;
    const uint32_t a0 = ld_u32(a), a1 = ld_u32(a + 8 * ld);
    const uint32_t a2 = ld_u32(a + 8), a3 = ld_u32(a + 8 * ld + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* b = b_tile + (j * 8 + g) * ld + k0 + tq * 2;
      mma_bf16(acc[j], a0, a1, a2, a3, ld_u32(b), ld_u32(b + 8));
    }
  }
}

// One warp: acc[j] += P[16 x 8KT] * V[8KT x 8NT], with P given as the f32
// accumulator fragments of an earlier warp_gemm_nt (rounded to bf16 here:
// the accumulator layout of two adjacent 8-wide tiles is exactly the A
// layout of one 16-deep step) and V row-major in shared memory, k running
// down its rows (p v, ds k, p^T dO, ds^T q).
template <int KT, int NT>
__device__ __forceinline__ void warp_gemm_pv(float (&acc)[NT][4], const float (&p)[KT][4],
                                             const bf16* v_tile, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int c = 0; c < KT / 2; ++c) {
    const uint32_t a0 = pack_bf16(p[2 * c][0], p[2 * c][1]);
    const uint32_t a1 = pack_bf16(p[2 * c][2], p[2 * c][3]);
    const uint32_t a2 = pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3]);
    const bf16* v = v_tile + (c * 16 + tq * 2) * ld + g;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_bf16(acc[j], a0, a1, a2, a3, ld_col_pair(v + j * 8, ld),
               ld_col_pair(v + j * 8 + 8 * ld, ld));
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
// forward: replaces _fwd_kernel
// ---------------------------------------------------------------------------
constexpr int kFwdM = 64, kFwdN = 64;

template <int D>
constexpr int fwd_smem() { return (kFwdM + 2 * kFwdN) * (D + kPad) * 2; }

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, Dims p) {
  constexpr int LD = D + kPad, NS = kFwdN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kFwdM * LD;
  bf16* vs = ks + kFwdN * LD;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.h / p.hkv);
  const int q0 = blockIdx.x * kFwdM;
  const size_t bh = (size_t)b * p.h + h;
  const bf16* kb = k + ((size_t)b * p.hkv + hk) * p.s * D;
  const bf16* vb = v + ((size_t)b * p.hkv + hk) * p.s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

  load_tile<kFwdM, D>(qs, q + bh * p.t * D, q0, p.t);

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f};

  int n_tiles = (p.s + kFwdN - 1) / kFwdN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kFwdM - 1) / kFwdN + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFwdN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kFwdN, D>(ks, kb, k0, p.s);
    load_tile<kFwdN, D>(vs, vb, k0, p.s);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    warp_gemm_nt<NS, D>(s, qs + warp * 16 * LD, ks, LD);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + (e >> 1) * 8, col = k0 + j * 8 + tq * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (col >= p.s || (p.causal && col > row)) x = kMaskValue;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = __expf(m[i] - mx[i]);  // 0 on the first tile (m = -inf)
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }
    warp_gemm_pv<NS, NO>(o, s, vs, LD);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    inv[i] = 1.0f / li;
    const int row = row_a + i * 8;
    if (tq == 0 && row < p.t) lse[bh * p.t + row] = m[i] + logf(li);
  }
  store_rows<NO>(out + bh * p.t * D, o, row_a, p.t, inv[0], inv[1]);
}

// ---------------------------------------------------------------------------
// dq: replaces _bwd_dq_kernel
// ---------------------------------------------------------------------------
constexpr int kDqM = 64, kDqN = 64;

template <int D>
constexpr int dq_smem() { return (2 * kDqM + 2 * kDqN) * (D + kPad) * 2; }

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, Dims p) {
  constexpr int LD = D + kPad, NS = kDqN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kDqM * LD;
  bf16* ks = dos + kDqM * LD;
  bf16* vs = ks + kDqN * LD;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.h / p.hkv);
  const int q0 = blockIdx.x * kDqM;
  const size_t bh = (size_t)b * p.h + h;
  const bf16* kb = k + ((size_t)b * p.hkv + hk) * p.s * D;
  const bf16* vb = v + ((size_t)b * p.hkv + hk) * p.s * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row_a = q0 + warp * 16 + g;

  load_tile<kDqM, D>(qs, q + bh * p.t * D, q0, p.t);
  load_tile<kDqM, D>(dos, dout + bh * p.t * D, q0, p.t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    lse_r[i] = row < p.t ? lse[bh * p.t + row] : 0.0f;
    delta_r[i] = row < p.t ? delta[bh * p.t + row] : 0.0f;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  int n_tiles = (p.s + kDqN - 1) / kDqN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kDqM - 1) / kDqN + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqN;
    __syncthreads();
    load_tile<kDqN, D>(ks, kb, k0, p.s);
    load_tile<kDqN, D>(vs, vb, k0, p.s);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    warp_gemm_nt<NS, D>(s, qs + warp * 16 * LD, ks, LD);
    warp_gemm_nt<NS, D>(dp, dos + warp * 16 * LD, vs, LD);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row_a + i * 8, col = k0 + j * 8 + tq * 2 + (e & 1);
        float x = s[j][e] * p.scale;
        if (col >= p.s || (p.causal && col > row)) x = kMaskValue;
        const float pv = __expf(x - lse_r[i]);
        s[j][e] = pv * (dp[j][e] - delta_r[i]) * p.scale;  // ds
      }
    warp_gemm_pv<NS, NO>(acc, s, ks, LD);
  }
  store_rows<NO>(dq + bh * p.t * D, acc, row_a, p.t, 1.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// dk/dv: replaces _bwd_dkv_kernel (and the group sum after it)
// ---------------------------------------------------------------------------
constexpr int kDkvN = 64, kDkvM = 32;

template <int D>
constexpr int dkv_smem() {
  return (2 * kDkvN + 2 * kDkvM) * (D + kPad) * 2 + 2 * kDkvM * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Dims p) {
  constexpr int LD = D + kPad, NS = kDkvM / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kDkvN * LD;
  bf16* qs = vs + kDkvN * LD;
  bf16* dos = qs + kDkvM * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kDkvM * LD);
  float* delta_s = lse_s + kDkvM;

  const int hk = blockIdx.y, b = blockIdx.z, group = p.h / p.hkv;
  const int k0 = blockIdx.x * kDkvN;
  const size_t bhk = (size_t)b * p.hkv + hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, key_a + 8

  load_tile<kDkvN, D>(ks, k + bhk * p.s * D, k0, p.s);
  load_tile<kDkvN, D>(vs, v + bhk * p.s * D, k0, p.s);

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  const int q_tiles = (p.t + kDkvM - 1) / kDkvM;
  // causal: q tiles wholly above the diagonal see none of these keys
  const int first = p.causal ? k0 / kDkvM : 0;
  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * p.h + (size_t)hk * group + hh;
    for (int qt = first; qt < q_tiles; ++qt) {
      const int q0 = qt * kDkvM;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<kDkvM, D>(qs, q + bh * p.t * D, q0, p.t);
      load_tile<kDkvM, D>(dos, dout + bh * p.t * D, q0, p.t);
      load_rows<kDkvM>(lse_s, lse + bh * p.t, q0, p.t);
      load_rows<kDkvM>(delta_s, delta + bh * p.t, q0, p.t);
      __syncthreads();

      // transposed scores: rows are this warp's 16 keys, columns the q rows
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
      warp_gemm_nt<NS, D>(st, ks + warp * 16 * LD, qs, LD);
      warp_gemm_nt<NS, D>(dpt, vs + warp * 16 * LD, dos, LD);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_a + (e >> 1) * 8;
          const int r = j * 8 + tq * 2 + (e & 1), row = q0 + r;
          float x = st[j][e] * p.scale;
          if (p.causal && row < key) x = kMaskValue;
          // phantom q rows past T carry no probability mass
          const float pv = row < p.t ? __expf(x - lse_s[r]) : 0.0f;
          st[j][e] = pv;
          dpt[j][e] = pv * (dpt[j][e] - delta_s[r]) * p.scale;  // ds^T
        }
      warp_gemm_pv<NS, NO>(dv_acc, st, dos, LD);   // dv += p^T dO
      warp_gemm_pv<NS, NO>(dk_acc, dpt, qs, LD);   // dk += ds^T q
    }
  }
  store_rows<NO>(dk + bhk * p.s * D, dk_acc, key_a, p.s, 1.0f, 1.0f);
  store_rows<NO>(dv + bhk * p.s * D, dv_acc, key_a, p.s, 1.0f, 1.0f);
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

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       const Dims& p, cudaStream_t st) {
  static cudaError_t attr = allow_smem(flash_fwd_kernel<D>, fwd_smem<D>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.t + kFwdM - 1) / kFwdM, p.h, p.b);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const Dims& p,
                      cudaStream_t st) {
  static cudaError_t attr = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.t + kDqM - 1) / kDqM, p.h, p.b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
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
  const dim3 grid((p.s + kDkvN - 1) / kDkvN, p.hkv, p.b);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return cudaGetLastError();
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

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
