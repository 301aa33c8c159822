// Block-circulant projection with a fused feature epilogue, for Hopper
// (sm_90a), plain C interface, loaded with ctypes
// (repro_torch/kernels/circulant.py):
//
//   y[b, i] = sum_j x[b, j] g[i / n, (j - i mod n) mod n],   out = f(y)
//
// f: identity | relu | heaviside (y >= 0) | exp (exp(y - sq[b])) | cos_sin
// ([cos y | sin y], out (B, 2m)). x (B, n) and g (nb, n) f32 or bf16, out
// in x's dtype, m <= nb * n; f32 accumulation, one cast on write.
//
// Replaces src/repro/kernels/circulant.py::_circ_kernel (the TPU kernel
// behind circulant_project_pallas), which regenerates each (TM, n) tile of
// A from the doubled generator [g, g] in VMEM and feeds it to the MXU. A
// never exists in memory here either: each thread reads its row of A from
// the O(n) generator through the index rule (a window of g that wraps once
// per row; the whole generator is 16 KB at nb = 4, n = 1024 and stays in
// L1), so device memory sees x once per column tile, g, and the output.
//
// What bounds it on this card: the function needs the FFT product's
// operations (structured.flops_fast) and moves x and the output once, so
// its bound is the bytes (0.050 ms at B = 8192, n = 1024, m = 4096, f32).
// This simple kernel instead does the dense B*m*n multiply-adds on the CUDA
// cores (34.4 G at that shape, ~1.2 ms at the f32 FMA peak): it is bound by
// FMA issue rate, far from the bound. The design keeps the FMAs fed:
//  * a block owns TB = 32 rows of x and TM = 256 output columns (one per
//    thread, TB accumulators in registers), and walks j in chunks of KC =
//    64: the chunk of x is staged in shared memory as f32, transposed to
//    xs[j][r] (row stride TB + 4, so float4 reads stay aligned), and every
//    thread reads the same xs[j][0..TB) as broadcast float4s: one generator
//    read feeds TB FMAs.
//  * the epilogue and the single write happen in registers; consecutive
//    threads write consecutive columns. Ragged B, m and n are masked,
//    nothing is padded in memory.
// Later work (the gap to the bound): the FFT algorithm, or A tiles in
// shared memory feeding wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Epilogue { IDENTITY = 0, RELU = 1, HEAVISIDE = 2, EXP = 3, COS_SIN = 4 };

constexpr int TM = 256;             // output columns a block = threads
constexpr int TB = 32;              // rows of x a block
constexpr int KC = 64;              // columns of x a chunk
constexpr int XS = TB + 4;          // row stride of the staged chunk

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(TM)
circulant_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ sq, T* __restrict__ out, int B,
                 int n, int m, int epilogue) {
  __shared__ __align__(16) float xs[KC * XS];
  const int b0 = blockIdx.x * TB;
  const int i = blockIdx.y * TM + threadIdx.x;
  const bool valid = i < m;
  const int off = valid ? i % n : 0;
  const T* grow = g + (size_t)(valid ? i / n : 0) * n;   // row i's generator
  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < n; j0 += KC) {
    const int kc = min(KC, n - j0);
    for (int e = threadIdx.x; e < TB * KC; e += TM) {
      const int r = e / KC, c = e - r * KC;
      const int b = b0 + r;
      xs[c * XS + r] = (b < B && c < kc)
                           ? load(x + (size_t)b * n + j0 + c) : 0.f;
    }
    __syncthreads();
    if (valid) {
      // A[i, j] = g[i / n, (j - off) mod n]: the index wraps at most once
      int idx = j0 - off;
      if (idx < 0) idx += n;
#pragma unroll 4
      for (int c = 0; c < kc; ++c) {
        const float a = load(grow + idx);
        if (++idx == n) idx = 0;
        const float4* xv = reinterpret_cast<const float4*>(xs + c * XS);
#pragma unroll
        for (int q = 0; q < TB / 4; ++q) {
          const float4 t = xv[q];
          acc[4 * q] = fmaf(a, t.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(a, t.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a, t.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a, t.w, acc[4 * q + 3]);
        }
      }
    }
    __syncthreads();
  }
  if (!valid) return;

  const int width = epilogue == COS_SIN ? 2 * m : m;
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const int b = b0 + r;
    if (b >= B) break;
    const float y = acc[r];
    T* o = out + (size_t)b * width;
    if (epilogue == COS_SIN) {
      store(o + i, cosf(y));
      store(o + m + i, sinf(y));
      continue;
    }
    float f;
    switch (epilogue) {
      case RELU: f = fmaxf(y, 0.f); break;
      case HEAVISIDE: f = y >= 0.f ? 1.f : 0.f; break;
      case EXP: f = expf(y - sq[b]); break;
      default: f = y; break;
    }
    store(o + i, f);
  }
}

template <typename T>
int launch(const void* x, const void* g, const float* sq, void* out, int B,
           int n, int nb, int m, int epilogue, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || (long long)nb * n < m ||
      epilogue < IDENTITY || epilogue > COS_SIN ||
      (epilogue == EXP && sq == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TB - 1) / TB, (m + TM - 1) / TM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  circulant_kernel<T><<<grid, TM, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), sq,
      static_cast<T*>(out), B, n, m, epilogue);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, n), g (nb, n), out (B, m) or (B, 2m) for cos_sin, all contiguous on
// the device in one dtype; sq (B,) float32, or null unless epilogue is exp.
// Returns a cudaError_t (0 = launched).
int circulant_project_f32(const void* x, const void* g, const void* sq,
                          void* out, int B, int n, int nb, int m,
                          int epilogue, void* stream) {
  return launch<float>(x, g, static_cast<const float*>(sq), out, B, n, nb,
                       m, epilogue, stream);
}

int circulant_project_bf16(const void* x, const void* g, const void* sq,
                           void* out, int B, int n, int nb, int m,
                           int epilogue, void* stream) {
  return launch<__nv_bfloat16>(x, g, static_cast<const float*>(sq), out, B,
                               n, nb, m, epilogue, stream);
}

}  // extern "C"
