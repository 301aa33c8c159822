// Walsh-Hadamard transform  out = H_n x (* 1/sqrt(n))  along each row, for
// Hopper (sm_90a), plain C interface, loaded with ctypes
// (repro_torch/kernels/fwht.py).
//
// Replaces src/repro/kernels/fwht.py::_fwht_kernel (the TPU kernel behind
// fwht_pallas). x (B, n) f32 or bf16, n = 2^k <= 16384 -> (B, n) in x's
// dtype, Sylvester order (H_n = H_a (x) H_b, what transforms.fwht computes);
// f32 arithmetic, one scale and one cast on the way out.
//
// The TPU kernel multiplies by the two small Kronecker factors on the MXU,
// because strided shuffles are slow on its vector unit. Here the work is
// the log2(n)-stage butterfly (n log2 n adds a row, about 0.0014 ms of the
// f32 peak at B = 8192, n = 1024) against 8 bytes a row element of device
// memory (0.020 ms at 3.35 TB/s): the card is bound by bytes, so the design
// reads x once and writes out once, and keeps every stage on chip:
//  * a block owns whole rows: max(1, 2048 / n) consecutive rows (several
//    rows for small n, so a block always has work for its 256 threads).
//    They are one contiguous span of x, loaded coalesced (16-byte vectors
//    where aligned) into shared memory as f32.
//  * the stages run in groups of up to three: each thread takes 8 elements
//    at stride h into registers, applies the strides h, 2h, 4h there, and
//    writes them back, so a row passes through shared memory ceil(k / 3)
//    times instead of k. The last group writes straight to device memory,
//    scaled and cast: its threads own consecutive columns, so the writes
//    coalesce.
//  * shared memory is padded by one float every 8 (index i -> i + i/8), so
//    the stride-1 and stride-8 groups, whose threads read 8 apart and 64
//    apart, hit distinct banks.
// Shared memory: 9/8 of max(n, 2048) floats, 72 KB at n = 16384, above the
// 48 KB default: the launch raises the kernel's limit first. A larger n is
// refused here; kernels/ops.py sends it to the plain version by a written
// rule.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LOG2N = 14;        // n <= 16384: kron_factors a, b <= 128
constexpr int BLOCK_ELEMS = 2048;    // a block stages at least this many

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// s[pad(i)] = x[i] for the block's `count` elements; 16-byte loads when
// the span is aligned.
__device__ __forceinline__ void stage(const float* x, float* s, int count) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && (count & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int v = threadIdx.x; v < (count >> 2); v += blockDim.x) {
      const float4 t = __ldg(x4 + v);
      const int i = v << 2;
      s[pad(i)] = t.x;
      s[pad(i + 1)] = t.y;
      s[pad(i + 2)] = t.z;
      s[pad(i + 3)] = t.w;
    }
    return;
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[pad(i)] = load(x + i);
}

__device__ __forceinline__ void stage(const __nv_bfloat16* x, float* s,
                                      int count) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && (count & 7) == 0) {
    const uint4* x8 = reinterpret_cast<const uint4*>(x);
    for (int v = threadIdx.x; v < (count >> 3); v += blockDim.x) {
      const uint4 t = __ldg(x8 + v);
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
      const int i = v << 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {     // a bf16 is the top half of an f32
        s[pad(i + 2 * q)] = __uint_as_float(w[q] << 16);
        s[pad(i + 2 * q + 1)] = __uint_as_float(w[q] & 0xffff0000u);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[pad(i)] = load(x + i);
}

// R butterfly stages of strides h, 2h, ..., 2^(R-1) h over every row of the
// block, 2^R elements a thread in registers. LAST: write the result scaled
// and cast to `out` (the block's first row) instead of back to s.
template <int R, bool LAST, typename T>
__device__ __forceinline__ void stages(float* s, T* out, int rows, int n,
                                       int log2n, int h, float scale) {
  constexpr int E = 1 << R;
  const int log2g = log2n - R;                 // groups a row: n / E
  const int total = rows << log2g;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int row = t >> log2g, p = t & ((1 << log2g) - 1);
    const int low = p & (h - 1), high = p / h;
    const int base = row * n + high * h * E + low;
    float v[E];
#pragma unroll
    for (int q = 0; q < E; ++q) v[q] = s[pad(base + q * h)];
#pragma unroll
    for (int st = 1; st < E; st <<= 1) {
#pragma unroll
      for (int q = 0; q < E; ++q) {
        if (q & st) continue;
        const float a = v[q], b = v[q + st];
        v[q] = a + b;
        v[q + st] = a - b;
      }
    }
#pragma unroll
    for (int q = 0; q < E; ++q) {
      if (LAST)
        store(out + base + q * h, v[q] * scale);
      else
        s[pad(base + q * h)] = v[q];
    }
  }
}

template <bool LAST, typename T>
__device__ __forceinline__ void group(int r, float* s, T* out, int rows,
                                      int n, int log2n, int h, float scale) {
  switch (r) {
    case 1: stages<1, LAST>(s, out, rows, n, log2n, h, scale); break;
    case 2: stages<2, LAST>(s, out, rows, n, log2n, h, scale); break;
    default: stages<3, LAST>(s, out, rows, n, log2n, h, scale); break;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwht_kernel(const T* __restrict__ x, T* __restrict__ out, long long B, int n,
            int log2n, int rows_per_block, float scale) {
  extern __shared__ float s[];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, B - row0);
  const T* xb = x + row0 * n;
  T* ob = out + row0 * n;
  if (log2n == 0) {                        // n = 1: H_1 = [1]
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      store(ob + i, load(xb + i) * scale);
    return;
  }
  stage(xb, s, rows * n);
  __syncthreads();
  int h = 1, left = log2n;
  while (left > 3) {
    group<false>(3, s, ob, rows, n, log2n, h, scale);
    __syncthreads();
    h <<= 3;
    left -= 3;
  }
  group<true>(left, s, ob, rows, n, log2n, h, scale);
}

int rows_per_block(int n) { return n >= BLOCK_ELEMS ? 1 : BLOCK_ELEMS / n; }

size_t smem_bytes(int n) {
  const int count = rows_per_block(n) * n;
  return sizeof(float) * (size_t)(count + ((count - 1) >> 3));
}

template <typename T>
int launch(const void* x, void* out, long long B, int n, float scale,
           void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (n <= 0 || (1 << log2n) != n || log2n > MAX_LOG2N || B <= 0)
    return (int)cudaErrorInvalidValue;
  static bool raised = false;              // one attribute call per type
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(1 << MAX_LOG2N));
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const int rpb = rows_per_block(n);
  const long long blocks = (B + rpb - 1) / rpb;
  fwht_kernel<T><<<(unsigned)blocks, THREADS, smem_bytes(n),
                   (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), B, n, log2n, rpb,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (B, n) contiguous on the device; n a power of two <= 16384.
// Returns a cudaError_t (0 = launched).
int fwht_f32(const void* x, void* out, long long B, int n, float scale,
             void* stream) {
  return launch<float>(x, out, B, n, scale, stream);
}

int fwht_bf16(const void* x, void* out, long long B, int n, float scale,
              void* stream) {
  return launch<__nv_bfloat16>(x, out, B, n, scale, stream);
}

}  // extern "C"
