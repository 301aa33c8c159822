// Paged KV gathers for Hopper (sm_90a), plain C interface, loaded with
// ctypes (repro_torch/kernels/paged_gather.py).
//
// Replaces: src/repro/kernels/paged_gather.py::_gather_kernel (behind
// paged_gather_pallas) and ::_gather_dequant_kernel (behind
// paged_gather_dequant_pallas). For pool (N, P, D) and tables (R, M):
//
//     out[r, j*P:(j+1)*P, :] = pool[clamp(table[r, j], 0, N-1)]
//
// and the int8 variant, out = float(pool[idx]) * scales[idx] (one f32
// scale per page row), cast to bf16 (round to nearest even) or kept f32.
//
// What bounds it on this card: bytes. Both are copies with no reuse; at
// the full-width decode shape (R = 8, M = 16, P = 16, D = 8 * 128) the
// bf16 gather reads 4.19 MB and writes 4.19 MB (2.5 us at 3.35 TB/s). The
// TPU kernel DMAs one page per grid step after a scalar-prefetched table
// lookup; here the grid's x axis walks the (r, j) page slots, so the table
// id is read once per block (into shared memory) and no block depends on
// another. Design for keeping bytes in flight:
//  * a page is P*D contiguous elements on both sides, so the gather is a
//    batched copy of contiguous chunks: each block copies one CHUNK of one
//    page with 16-byte (uint4) accesses, UNROLL loads issued before the
//    stores, so a 128-thread block keeps 8 KB in flight; the grid's y axis
//    splits a page into chunks so the decode shape runs 512 blocks;
//  * the copy kernel is dtype-agnostic: it moves bytes, in the widest unit
//    (16, 8, 4, 2 or 1 bytes) that divides the page's byte size and both
//    base addresses. A page whose bytes are not a multiple of 16 takes a
//    narrower unit, down to single bytes; it never leaves the kernel;
//  * the dequant kernel reads 16 int8 of one page row at a time (when D is
//    a multiple of 16), multiplies each by the row's scale in f32 and
//    writes 16 outputs (two or four 16-byte stores); other row widths take
//    one element per step. float(q) * s is one IEEE multiply, so the result
//    is bit-identical to the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;
constexpr long long CHUNK = (long long)THREADS * UNROLL;   // units per block

__device__ __forceinline__ long long page_id(const void* tables, int idx64,
                                             long long rm, long long n) {
  long long id = idx64 ? ((const long long*)tables)[rm]
                       : (long long)((const int*)tables)[rm];
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

// One block: units [y * CHUNK, (y + 1) * CHUNK) of page slot x = r * M + j.
template <typename U>
__global__ void __launch_bounds__(THREADS)
paged_gather_kernel(const U* __restrict__ pool,
                    const void* __restrict__ tables, int idx64,
                    U* __restrict__ out, long long n_pages,
                    long long page_units) {
  __shared__ long long src_page;
  const long long rm = blockIdx.x;
  if (threadIdx.x == 0) src_page = page_id(tables, idx64, rm, n_pages);
  __syncthreads();
  const U* src = pool + src_page * page_units;
  U* dst = out + rm * page_units;
  const long long base = (long long)blockIdx.y * CHUNK + threadIdx.x;
  U buf[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i < page_units) buf[u] = __ldg(src + i);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i < page_units) dst[i] = buf[u];
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* o, const float* f) {
  __align__(16) __nv_bfloat16 h[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) h[e] = __float2bfloat16_rn(f[e]);
  const uint4* hv = reinterpret_cast<const uint4*>(h);
  uint4* ov = reinterpret_cast<uint4*>(o);
  ov[0] = hv[0];
  ov[1] = hv[1];
}

__device__ __forceinline__ void store16(float* o, const float* f) {
  float4* ov = reinterpret_cast<float4*>(o);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    ov[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* o, float f) {
  *o = __float2bfloat16_rn(f);
}
__device__ __forceinline__ void store1(float* o, float f) { *o = f; }

// VEC: a unit is 16 int8 of one page row (needs D % 16 == 0 and a 16-byte
// aligned pool); else a unit is one element.
template <typename O, bool VEC>
__global__ void __launch_bounds__(THREADS)
paged_gather_dequant_kernel(const int8_t* __restrict__ pool,
                            const float* __restrict__ scales,
                            const void* __restrict__ tables, int idx64,
                            O* __restrict__ out, long long n_pages, int P,
                            int D) {
  constexpr int W = VEC ? 16 : 1;
  __shared__ long long src_page;
  const long long rm = blockIdx.x;
  if (threadIdx.x == 0) src_page = page_id(tables, idx64, rm, n_pages);
  __syncthreads();
  const long long page_elems = (long long)P * D;
  const long long page_units = page_elems / W;
  const int8_t* src = pool + src_page * page_elems;
  const float* srow = scales + src_page * P;
  O* dst = out + rm * page_elems;
  const long long base = (long long)blockIdx.y * CHUNK + threadIdx.x;
  if constexpr (VEC) {
    uint4 buf[UNROLL];
    const uint4* sv = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < page_units) buf[u] = __ldg(sv + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < page_units) {
        const long long e0 = i * 16;
        const float s = __ldg(srow + e0 / D);
        const int8_t* q = reinterpret_cast<const int8_t*>(&buf[u]);
        float f[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) f[e] = (float)q[e] * s;
        store16(dst + e0, f);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < page_units)
        store1(dst + i, (float)__ldg(src + i) * __ldg(srow + i / D));
    }
  }
}

template <typename U>
int launch_gather(const void* pool, const void* tables, int idx64, void* out,
                  long long rm, long long n_pages, long long page_bytes,
                  cudaStream_t st) {
  const long long units = page_bytes / (long long)sizeof(U);
  const dim3 grid((unsigned)rm, (unsigned)((units + CHUNK - 1) / CHUNK));
  paged_gather_kernel<U><<<grid, THREADS, 0, st>>>(
      (const U*)pool, tables, idx64, (U*)out, n_pages, units);
  return (int)cudaGetLastError();
}

template <typename O>
int launch_dequant(const int8_t* pool, const float* scales,
                   const void* tables, int idx64, O* out, long long rm,
                   long long n_pages, int P, int D, cudaStream_t st) {
  const bool vec = D % 16 == 0 && (uintptr_t)pool % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long units = (long long)P * D / (vec ? 16 : 1);
  const dim3 grid((unsigned)rm, (unsigned)((units + CHUNK - 1) / CHUNK));
  if (vec)
    paged_gather_dequant_kernel<O, true><<<grid, THREADS, 0, st>>>(
        pool, scales, tables, idx64, out, n_pages, P, D);
  else
    paged_gather_dequant_kernel<O, false><<<grid, THREADS, 0, st>>>(
        pool, scales, tables, idx64, out, n_pages, P, D);
  return (int)cudaGetLastError();
}

}  // namespace

// pool: N pages of page_bytes contiguous bytes each; tables: RM = R * M page
// ids, int32 (idx64 = 0) or int64 (idx64 = 1); out: RM pages. All device
// pointers; pool and out are not aliased. Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int paged_gather(const void* pool, const void* tables, int idx64,
                            void* out, long long RM, long long N,
                            long long page_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (RM <= 0 || page_bytes <= 0) return 0;
  const uintptr_t a = (uintptr_t)pool | (uintptr_t)out | (uintptr_t)page_bytes;
  if (a % 16 == 0)
    return launch_gather<uint4>(pool, tables, idx64, out, RM, N, page_bytes,
                                st);
  if (a % 8 == 0)
    return launch_gather<uint2>(pool, tables, idx64, out, RM, N, page_bytes,
                                st);
  if (a % 4 == 0)
    return launch_gather<unsigned int>(pool, tables, idx64, out, RM, N,
                                       page_bytes, st);
  if (a % 2 == 0)
    return launch_gather<unsigned short>(pool, tables, idx64, out, RM, N,
                                         page_bytes, st);
  return launch_gather<unsigned char>(pool, tables, idx64, out, RM, N,
                                      page_bytes, st);
}

// pool (N, P, D) int8, scales (N, P) f32, tables as above, out (RM, P, D)
// in bf16 (out_bf16 = 1) or f32 (out_bf16 = 0).
extern "C" int paged_gather_dequant(const int8_t* pool, const float* scales,
                                    const void* tables, int idx64, void* out,
                                    int out_bf16, long long RM, long long N,
                                    int P, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (RM <= 0 || (long long)P * D <= 0) return 0;
  if (out_bf16)
    return launch_dequant<__nv_bfloat16>(pool, scales, tables, idx64,
                                         (__nv_bfloat16*)out, RM, N, P, D, st);
  return launch_dequant<float>(pool, scales, tables, idx64, (float*)out, RM,
                               N, P, D, st);
}
