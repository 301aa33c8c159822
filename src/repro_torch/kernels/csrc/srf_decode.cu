// Fused SRF decode step for Hopper (sm_90a), plain C interface, loaded with
// ctypes (repro_torch/kernels/srf_decode.py).
//
// Replaces: src/repro/kernels/srf_decode.py::_srf_decode_kernel (behind
// srf_decode_pallas). Per (batch, head) state:
//     S' = S + phi_k^T v ;  z' = z + phi_k ;
//     out = (phi_q . S') / (phi_q . z' + eps)
// with S and z updated in place, as the TPU kernel aliases them.
//
// What bounds it on this card: bytes. S is (m, dv) f32 per (b, h) and is
// read once and written once; everything else is O(m + dv). At the serving
// shape (B = 8, H = 32, m = 256, dv = 128) that is 2 * 33.5 MB of state
// against ~34 MFLOP, far below the card's ops-per-byte balance point, so
// the design is about keeping enough bytes in flight:
//  * one block of 256 threads per (b, h): 32 column threads x 8 row groups.
//    A column thread owns VEC = 4 adjacent columns (one 16-byte load and
//    store per row when dv % 4 == 0), a row group every 8th row, so a warp
//    reads one 512-byte stretch of a row of S and the 8 warps of a block
//    stream 8 rows at once (the first version, one thread per column
//    walking all m rows, kept too few bytes in flight: PERF.md);
//  * the numerator phi_q . S' accumulates in registers while S' is
//    written — the state makes exactly one round trip; the 8 row-group
//    partials are summed through shared memory;
//  * phi_q and phi_k are per-row scalars every thread of a warp reads at
//    the same address (a broadcast through the read-only cache);
//  * the denominator is a block reduction over m that also writes z'.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;            // column threads per block (one warp wide)
constexpr int ROWS = 8;             // row groups per block
constexpr int THREADS = COLS * ROWS;

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}
__device__ __forceinline__ float fma4(float a, float x, float y) {
  return fmaf(a, x, y);
}
__device__ __forceinline__ float4 zero4(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float zero4(float) { return 0.f; }
__device__ __forceinline__ void store_div(float* o, float4 a, float d) {
  o[0] = a.x / d; o[1] = a.y / d; o[2] = a.z / d; o[3] = a.w / d;
}
__device__ __forceinline__ void store_div(float* o, float a, float d) {
  o[0] = a / d;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
srf_decode_kernel(float* __restrict__ S, float* __restrict__ z,
                  const float* __restrict__ pq, const float* __restrict__ pk,
                  const float* __restrict__ v, float* __restrict__ out, int m,
                  int dv, float eps) {
  using V = typename Vec<VEC>::T;
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float den;
  __shared__ V partial[ROWS][COLS];
  const size_t bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int cx = tid % COLS, ry = tid / COLS;
  float* Sb = S + bh * m * dv;
  float* zb = z + bh * m;
  const float* pqb = pq + bh * m;
  const float* pkb = pk + bh * m;
  const float* vb = v + bh * dv;

  float part = 0.f;
  for (int i = tid; i < m; i += THREADS) {
    const float z2 = zb[i] + __ldg(pkb + i);
    zb[i] = z2;
    part = fmaf(__ldg(pqb + i), z2, part);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
    den = s + eps;
  }

  const int dvv = dv / VEC;                 // row length in V units
  V* Sv = reinterpret_cast<V*>(Sb);
  const V* vv = reinterpret_cast<const V*>(vb);
  for (int c0 = 0; c0 < dvv; c0 += COLS) {
    const int c = c0 + cx;
    V num = zero4(V());
    if (c < dvv) {
      const V vc = vv[c];
#pragma unroll 4
      for (int i = ry; i < m; i += ROWS) {
        V* p = Sv + (size_t)i * dvv + c;
        const V s = fma4(__ldg(pkb + i), vc, *p);
        *p = s;
        num = fma4(__ldg(pqb + i), s, num);
      }
    }
    partial[ry][cx] = num;
    __syncthreads();                        // also publishes den
    if (ry == 0 && c < dvv) {
      V acc = partial[0][cx];
      for (int r = 1; r < ROWS; ++r) acc = fma4(1.f, partial[r][cx], acc);
      store_div(out + bh * dv + (size_t)c * VEC, acc, den);
    }
    __syncthreads();                        // partial is reused
  }
}

}  // namespace

// S (BH, m, dv), z/pq/pk (BH, m), v/out (BH, dv): contiguous f32 device
// tensors; S and z are updated in place. Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int srf_decode_f32(float* S, float* z, const float* pq,
                              const float* pk, const float* v, float* out,
                              int BH, int m, int dv, float eps,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec4 = dv % 4 == 0 && (uintptr_t)S % 16 == 0 &&
                    (uintptr_t)v % 16 == 0;
  if (vec4)
    srf_decode_kernel<4><<<BH, THREADS, 0, st>>>(S, z, pq, pk, v, out, m, dv,
                                                 eps);
  else
    srf_decode_kernel<1><<<BH, THREADS, 0, st>>>(S, z, pq, pk, v, out, m, dv,
                                                 eps);
  return (int)cudaGetLastError();
}
