// Fused structured spinner  out = f(y_scale * A . D1 H D0 . x) * out_scale
// for Hopper (sm_90a), plain C interface, loaded with ctypes
// (repro_torch/kernels/spinner.py).
//
// Replaces: src/repro/kernels/spinner.py::_spinner_kernel (the TPU kernel
// behind spinner_project_pallas). Same function: x (G, B, n) -> (G, B, m),
// or (G, B, 2m) = [cos | sin] per row for cos_sin; f32 math, one cast on
// write; A never exists in memory — its entries are regenerated from the
// O(n) generator with the index rules of _regen_tile/_gen_table.
//
// What bounds it on this card: at the serving shapes (n = 128, m = 256,
// G = 8 heads, B = 8..512 rows per head) the call moves a few hundred KB
// and does B*m*n multiply-adds per group, so it is bound by launch latency
// and by the FMA issue rate of the CUDA cores (no tensor cores here), not
// by HBM. The design keeps every intermediate on chip:
//  * one block owns (batch tile of TB rows, row tile of TM = 256 rows of A,
//    group). The TPU kernel carries the HD result in VMEM scratch from one
//    row-tile grid step to the next; blocks here run in no order, so each
//    block RECOMPUTES the HD sandwich for its batch tile. At n = 128 that is
//    TB*n*log2(n) adds against TB*TM*n FMAs of projection (~3%), and it
//    buys ceil(m/TM) times more blocks than looping over row tiles inside
//    one block would when m > TM. At the serving m = 256 a row tile is the
//    whole of A, and the grid is filled by shrinking TB instead (pick_tb):
//    the decode shapes have only G = 8 groups of 8..32 rows.
//  * x rows are staged in shared memory as f32, transposed to v[j][r], so
//    the projection reads TB consecutive floats per column j (a broadcast:
//    every thread of the block reads the same address).
//  * HD is an in-place natural-order butterfly in shared memory; natural
//    order equals the Sylvester H_a (x) H_b the TPU kernel multiplies by.
//  * each thread owns one row i of A, regenerates A[i, j] for j = 0..n-1
//    from the generator (read-only cache), and keeps TB accumulators in
//    registers: one generator load feeds TB FMAs.
//  * the epilogue and the single write happen in registers; consecutive
//    threads write consecutive columns. Ragged B and m are masked, nothing
//    is padded in memory.
// Later work: stage A tiles in shared memory and use wgmma for large B.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Kind { CIRCULANT = 0, SKEW_CIRCULANT = 1, TOEPLITZ = 2, HANKEL = 3,
            UNSTRUCTURED = 4 };
enum Epilogue { IDENTITY = 0, RELU = 1, HEAVISIDE = 2, SIGN = 3, EXP = 4,
                COS_SIN = 5 };

constexpr int TM = 256;             // rows of A per block = threads per block
constexpr int SMEM_FLOATS = 12288;  // 48 KB of staged x: TB * n <= this

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A[i, j] regenerated from the group's generator gg (index rules of
// _regen_tile over the _gen_table layouts, read straight from g):
//   circulant       [g, g][blk, j - (i mod n) + n],   blk = i / n
//   skew_circulant  [-g, g][blk, j - (i mod n) + n]
//   toeplitz        glin[j - i + m - 1], glin = [flip(g[n:]), g[:n]]
//   hankel          g[i + j]
//   unstructured    g[i, j] (dense rows)
template <int KIND, typename T>
__device__ __forceinline__ float coef(const T* gg, int i, int j, int n,
                                      int m) {
  if (KIND == CIRCULANT || KIND == SKEW_CIRCULANT) {
    const int blk = i / n;
    const int idx = j - (i - blk * n) + n;          // in [1, 2n)
    const T* gb = gg + (size_t)blk * n;
    if (idx >= n) return load(gb + (idx - n));
    return KIND == CIRCULANT ? load(gb + idx) : -load(gb + idx);
  } else if (KIND == TOEPLITZ) {
    const int k = j - i + m - 1;                    // in [0, n + m - 1)
    return k < m - 1 ? load(gg + (n + (m - 2 - k))) : load(gg + (k - (m - 1)));
  } else if (KIND == HANKEL) {
    return load(gg + (i + j));
  } else {
    return load(gg + (size_t)i * n + j);
  }
}

template <int KIND, int TB, typename T>
__device__ __forceinline__ void project(const T* gg, const float* v, int i,
                                        int n, int m, float* acc) {
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float a = coef<KIND>(gg, i, j, n, m);
    const float* vj = v + j * TB;
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = fmaf(a, vj[r], acc[r]);
  }
}

template <typename T, int TB>
__global__ void __launch_bounds__(TM)
spinner_kernel(const T* __restrict__ x, const T* __restrict__ d0,
               const T* __restrict__ d1, const T* __restrict__ g,
               T* __restrict__ out, int B, int n, int m, long long gstride,
               int kind, int epilogue, int use_hd, float inv_sqrt_n,
               float y_scale, float out_scale) {
  extern __shared__ float v[];      // TB * n, transposed: v[j * TB + r]
  __shared__ float sq[TB];          // 0.5 ||x_r||^2 for the exp epilogue

  const int r0 = blockIdx.x * TB;
  const int i0 = blockIdx.y * TM;
  const int gi = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(TB, B - r0);

  const T* xg = x + ((size_t)gi * B + r0) * n;
  for (int idx = tid; idx < TB * n; idx += TM) {
    const int r = idx / n, j = idx - r * n;
    v[j * TB + r] = r < rows ? load(xg + (size_t)r * n + j) : 0.f;
  }
  __syncthreads();

  if (epilogue == EXP) {            // from the RAW x: ||v|| = ||x|| (HD isometry)
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < TB; r += TM / 32) {
      float s = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float t = v[j * TB + r];
        s = fmaf(t, t, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sq[r] = 0.5f * s;
    }
    __syncthreads();                // HD below rewrites v in place
  }

  if (use_hd) {
    const T* d0g = d0 + (size_t)gi * n;
    const T* d1g = d1 + (size_t)gi * n;
    for (int idx = tid; idx < TB * n; idx += TM) v[idx] *= load(d0g + idx / TB);
    __syncthreads();
    for (int h = 1; h < n; h <<= 1) {         // natural-order butterfly
      for (int t = tid; t < (n >> 1) * TB; t += TM) {
        const int r = t % TB, p = t / TB;
        const int a = (p / h) * 2 * h + (p % h), b = a + h;
        const float xa = v[a * TB + r], xb = v[b * TB + r];
        v[a * TB + r] = xa + xb;
        v[b * TB + r] = xa - xb;
      }
      __syncthreads();
    }
    for (int idx = tid; idx < TB * n; idx += TM)
      v[idx] = v[idx] * inv_sqrt_n * load(d1g + idx / TB);
  }
  __syncthreads();

  const int i = i0 + tid;
  if (i >= m) return;
  const T* gg = g + (size_t)gi * gstride;
  float acc[TB];
  switch (kind) {
    case CIRCULANT: project<CIRCULANT, TB>(gg, v, i, n, m, acc); break;
    case SKEW_CIRCULANT: project<SKEW_CIRCULANT, TB>(gg, v, i, n, m, acc); break;
    case TOEPLITZ: project<TOEPLITZ, TB>(gg, v, i, n, m, acc); break;
    case HANKEL: project<HANKEL, TB>(gg, v, i, n, m, acc); break;
    default: project<UNSTRUCTURED, TB>(gg, v, i, n, m, acc); break;
  }

  const int width = epilogue == COS_SIN ? 2 * m : m;
  T* og = out + ((size_t)gi * B + r0) * width;
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    if (r >= rows) break;
    const float y = acc[r] * y_scale;
    T* o = og + (size_t)r * width;
    if (epilogue == COS_SIN) {
      store(o + i, cosf(y) * out_scale);
      store(o + m + i, sinf(y) * out_scale);
      continue;
    }
    float f;
    switch (epilogue) {
      case RELU: f = fmaxf(y, 0.f); break;
      case HEAVISIDE: f = y >= 0.f ? 1.f : 0.f; break;
      case SIGN: f = y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f); break;
      case EXP: f = expf(y - sq[r]); break;
      default: f = y; break;
    }
    store(o + i, f * out_scale);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// Batch tile: the largest TB (<= 16, staged x within SMEM_FLOATS) that
// still gives at least one block per SM; decode calls (B = 8..32 rows a
// group) come out at TB = 1..2, prefill calls at TB = 8..16. Fewer rows
// per block means fewer FMAs per generator load, but at decode sizes the
// card is latency-bound and idle SMs cost more.
int pick_tb(int G, int B, int n, int m) {
  const long long tiles = (long long)G * ((m + TM - 1) / TM);
  int tb = 16;
  while (tb > 1 && (tb * n > SMEM_FLOATS || tb / 2 >= B ||
                    tiles * ((B + tb - 1) / tb) < sm_count()))
    tb >>= 1;
  return tb;
}

template <typename T>
int launch(const T* x, const T* d0, const T* d1, const T* g, T* out, int G,
           int B, int n, int m, long long gstride, int kind, int epilogue,
           int use_hd, float inv_sqrt_n, float y_scale, float out_scale,
           cudaStream_t stream) {
  const int tb = pick_tb(G, B, n, m);
  const dim3 grid((B + tb - 1) / tb, (m + TM - 1) / TM, G);
  const size_t smem = (size_t)tb * n * sizeof(float);
#define SPINNER_LAUNCH(TBV)                                                  \
  spinner_kernel<T, TBV><<<grid, TM, smem, stream>>>(                        \
      x, d0, d1, g, out, B, n, m, gstride, kind, epilogue, use_hd,           \
      inv_sqrt_n, y_scale, out_scale)
  switch (tb) {
    case 16: SPINNER_LAUNCH(16); break;
    case 8: SPINNER_LAUNCH(8); break;
    case 4: SPINNER_LAUNCH(4); break;
    case 2: SPINNER_LAUNCH(2); break;
    default: SPINNER_LAUNCH(1); break;
  }
#undef SPINNER_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// x (G, B, n), d0/d1 (G, n) or null when use_hd == 0, g the group-major
// generator with gstride elements per group, out (G, B, m) or (G, B, 2m).
// All pointers are device pointers of contiguous tensors. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int spinner_project_f32(const float* x, const float* d0,
                                   const float* d1, const float* g,
                                   float* out, int G, int B, int n, int m,
                                   long long gstride, int kind, int epilogue,
                                   int use_hd, float inv_sqrt_n,
                                   float y_scale, float out_scale,
                                   void* stream) {
  return launch<float>(x, d0, d1, g, out, G, B, n, m, gstride, kind,
                       epilogue, use_hd, inv_sqrt_n, y_scale, out_scale,
                       (cudaStream_t)stream);
}

extern "C" int spinner_project_bf16(const __nv_bfloat16* x,
                                    const __nv_bfloat16* d0,
                                    const __nv_bfloat16* d1,
                                    const __nv_bfloat16* g,
                                    __nv_bfloat16* out, int G, int B, int n,
                                    int m, long long gstride, int kind,
                                    int epilogue, int use_hd,
                                    float inv_sqrt_n, float y_scale,
                                    float out_scale, void* stream) {
  return launch<__nv_bfloat16>(x, d0, d1, g, out, G, B, n, m, gstride, kind,
                               epilogue, use_hd, inv_sqrt_n, y_scale,
                               out_scale, (cudaStream_t)stream);
}
