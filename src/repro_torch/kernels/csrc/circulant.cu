// Block-circulant projection with a fused feature epilogue, for Hopper
// (sm_90a), plain C interface, loaded with ctypes
// (repro_torch/kernels/circulant.py):
//
//   y[b, i] = sum_j x[b, j] g[i / n, (j - i mod n) mod n],   out = f(y)
//
// f: identity | relu | heaviside (y >= 0) | exp (exp(y - sq[b])) | cos_sin
// ([cos y | sin y], out (B, 2m)), numbered as window_mma.cuh's Epilogue.
// x (B, n) and g (nb, n) f32 or bf16, out in x's dtype, m <= nb * n; f32
// accumulation, one cast on write.
//
// Replaces src/repro/kernels/circulant.py::_circ_kernel (the TPU kernel
// behind circulant_project_pallas), which regenerates each (TM, n) tile of
// A from the doubled generator [g, g] in VMEM and feeds it to the MXU.
// This kernel does the same on the tensor cores: A never exists in memory.
//
// What bounds it on this card: the function needs only the FFT product's
// operations, so its bound is the bytes (x read once, the output written
// once: 0.050 ms at B = 8192, n = 1024, m = 4096, f32). The kernel does the
// dense B*m*n multiply-adds instead (a product with a regenerated A, as the
// TPU kernel does), so it is bound by the tensor cores' rate and by the
// instructions around them. It is window_mma.cuh's mainloop with 128 x 128
// output tiles: x staged chunk by chunk by cp.async, the B operand read
// from a Toeplitz window of the generator (tiles in one generator block)
// or a tile built by the per-row rule (tiles crossing a block, n < BN),
// 3xTF32 in f32, one bf16 product in bf16 (x and g are bf16 values). The
// spinner kernels (spinner.cu) run the same mainloop.

#include "window_mma.cuh"

namespace {

constexpr int MT = 4;               // 128 rows of x a block

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
circulant_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ sq, T* __restrict__ out, int B,
                 int n, int m, int epilogue, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GlobalSrc<T> src{g, n, m};
  build_window<MMA_OF<T, T>>(window_at<T, MT, false>(smem), src, CIRCULANT,
                             n, m);
  project_tile<T, T, MT, false>(src, x, nullptr,
                                sq == nullptr ? nullptr
                                              : sq + blockIdx.y * 32 * MT,
                                out, B, n, m, CIRCULANT, epilogue, 1.f, 1.f,
                                vec != 0, smem);
}

template <typename T>
int launch(const void* x, const void* g, const float* sq, void* out, int B,
           int n, int nb, int m, int epilogue, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || (long long)nb * n < m ||
      epilogue < IDENTITY || epilogue > COS_SIN || epilogue == SIGN ||
      (epilogue == EXP && sq == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + BN - 1) / BN, (B + 32 * MT - 1) / (32 * MT));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = mainloop_bytes<T>(32 * MT, false, n,
                                         crosses_block(n, m));
  static size_t raised = 48 * 1024;     // per dtype (per process)
  if (bytes > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        circulant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    raised = bytes;
  }
  const bool vec = n % (16 / (int)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  circulant_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), sq,
      static_cast<T*>(out), B, n, m, epilogue, vec ? 1 : 0);
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
