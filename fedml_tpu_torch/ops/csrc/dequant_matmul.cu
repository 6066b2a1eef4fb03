// Fused int8 weight-only dequant-matmul for Hopper (sm_90a).
//
//   out[M, F] = bf16( (x_bf16[M, H] @ float(W_int8[H, F])) * scale_f32[F] )
//
// Replaces the TPU kernel fedml_tpu/ops/quant.py::_dequant_matmul_kernel
// (launched by pallas_dequant_matmul). Same arithmetic: every bf16 x int8
// product is exact in f32 (8 + 7 significant bits), the sum over H is kept
// in f32, and the per-column scale is applied in f32 before the one
// rounding to bf16. Only the order of the f32 sum differs.
//
// What bounds it: memory. The decode path calls it with M <= 8 rows, i.e.
// about 2*M flops per weight byte, far below the ~295 flops/byte at which
// an H100 stops being bandwidth-bound in bf16. The design therefore does
// one thing: stream W from device memory exactly once, as int8, and never
// write a converted copy of it anywhere.
//
// Design (simple first; no wgmma, no TMA):
//  * A block of 256 threads (8 warps) owns 128 output columns and a tile of
//    BM <= 8 rows. Each lane owns 4 adjacent columns and reads them as one
//    4-byte load per weight row, so a warp reads 128 contiguous bytes of a
//    row: fully coalesced.
//  * The TPU grid's sequential H-reduction axis becomes a loop inside the
//    block: x is staged into shared memory 128 H-rows at a time (converted
//    to f32, transposed to [h][m] so one broadcast read serves all BM rows),
//    and the 8 warps split those 128 H-rows between them.
//  * int8 -> f32 uses the 2^23 mantissa trick (one byte-permute and one
//    add) instead of the quarter-rate I2F conversion.
//  * The 8 warps' partial sums meet in shared memory; the epilogue applies
//    scale[f] in f32 and rounds with __float2bfloat16_rn.
//
// Known weakness: parallelism is F/128 x ceil(M/BM) blocks. For the
// Llama-3-8B k_proj/v_proj (F = 1024) at M <= 8 that is 8 blocks on 132
// SMs, and q_proj/o_proj/down_proj (F = 4096) give 32: those launches read
// memory far below the card's rate. Splitting H across blocks (split-K)
// and tensor-core tiles for the M = 128 prefill buckets are later work.
//
// Plain C interface, loaded with ctypes (fedml_tpu_torch/ops/_build.py);
// the launch never synchronises and allocates nothing; the caller checks
// the returned cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kBlockCols = 32 * kColsPerLane;  // 128 output columns per block
constexpr int kChunk = 128;                    // H-rows of x staged per pass
constexpr int kRowsPerWarp = kChunk / kWarps;  // 16 H-rows per warp per pass
constexpr int kUnroll = 8;                     // weight loads in flight per lane

static_assert(kRowsPerWarp % kUnroll == 0, "unroll must divide the warp's rows");

// Four int8 codes packed little-endian in one word -> four exact floats.
// Bias each byte to unsigned (xor 0x80), splice it under the exponent of
// 2^23 (0x4B000000), and subtract 2^23 + 128.
__device__ __forceinline__ void int8x4_to_float(uint32_t packed, float (&out)[4]) {
  const uint32_t u = packed ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out,
                      int rows, int h, int f) {
  __shared__ __align__(16) float xs[kChunk][BM];
  __shared__ __align__(16) float red[kWarps][BM][kBlockCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kBlockCols;
  const int row0 = blockIdx.y * BM;

  float acc[BM][kColsPerLane];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[m][j] = 0.0f;

  const int8_t* wlane = w + col0 + lane * kColsPerLane;

  for (int h0 = 0; h0 < h; h0 += kChunk) {
    __syncthreads();  // every warp is done with the previous chunk of xs
    for (int i = threadIdx.x; i < kChunk * BM; i += kThreads) {
      const int m = i / kChunk;
      const int k = i - m * kChunk;
      const int r = row0 + m;
      xs[k][m] = r < rows ? __bfloat162float(x[(size_t)r * h + h0 + k]) : 0.0f;
    }
    __syncthreads();

    const int kw = warp * kRowsPerWarp;
    const int8_t* wp = wlane + (size_t)(h0 + kw) * f;
#pragma unroll
    for (int k0 = 0; k0 < kRowsPerWarp; k0 += kUnroll) {
      uint32_t wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wv[u] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)(k0 + u) * f));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float wf[kColsPerLane];
        int8x4_to_float(wv[u], wf);
        const float* xrow = xs[kw + k0 + u];
        float xv[BM];
        if constexpr (BM % 4 == 0) {
#pragma unroll
          for (int m = 0; m < BM; m += 4) {
            const float4 t = *reinterpret_cast<const float4*>(xrow + m);
            xv[m] = t.x; xv[m + 1] = t.y; xv[m + 2] = t.z; xv[m + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < BM; ++m) xv[m] = xrow[m];
        }
#pragma unroll
        for (int m = 0; m < BM; ++m)
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j)
            acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
      }
    }
  }

  // the 8 warps each hold a partial sum over their share of H
#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * kColsPerLane]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * kBlockCols; i += kThreads) {
    const int m = i / kBlockCols;
    const int c = i - m * kBlockCols;
    const int r = row0 + m;
    if (r >= rows) continue;
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][m][c];
    const int fc = col0 + c;
    out[(size_t)r * f + fc] = __float2bfloat16_rn(s * scale[fc]);
  }
}

template <int BM>
void launch(const void* x, const void* w, const void* scale, void* out,
            int rows, int h, int f, cudaStream_t stream) {
  const dim3 grid(f / kBlockCols, (rows + BM - 1) / BM);
  dequant_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      rows, h, f);
}

}  // namespace

extern "C" {

// x: bf16 [rows, h]; w: int8 [h, f]; scale: f32 [f]; out: bf16 [rows, f].
// All contiguous, w 4-byte aligned. Requires 1 <= rows <= 128 and h, f
// multiples of 128 (the TPU kernel's dispatch conditions). Returns a
// cudaError_t as int: 0 when the launch was accepted.
int fedml_dequant_matmul_bf16(const void* x, const void* w, const void* scale,
                              void* out, int rows, int h, int f, void* stream) {
  if (rows < 1 || rows > 128 || h < kChunk || h % kChunk != 0 || f < kBlockCols ||
      f % kBlockCols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 1) {
    launch<1>(x, w, scale, out, rows, h, f, s);
  } else if (rows == 2) {
    launch<2>(x, w, scale, out, rows, h, f, s);
  } else if (rows <= 4) {
    launch<4>(x, w, scale, out, rows, h, f, s);
  } else {
    launch<8>(x, w, scale, out, rows, h, f, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
