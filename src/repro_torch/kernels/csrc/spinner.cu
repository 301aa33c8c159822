// Fused structured spinner  out = f(y_scale * A . D1 H D0 . x) * out_scale
// for Hopper (sm_90a), plain C interface, loaded with ctypes
// (repro_torch/kernels/spinner.py). Two kernels share every step but the
// source of A's entries and of the HD diagonals:
//
// spinner_kernel replaces src/repro/kernels/spinner.py::_spinner_kernel
// (the TPU kernel behind spinner_project_pallas). x (G, B, n) -> (G, B, m),
// or (G, B, 2m) = [cos | sin] per row for cos_sin; f32 math, one cast on
// write; A never exists in memory: its entries are read from the O(n)
// generator g with the index rules of _regen_tile/_gen_table.
//
// seeded_spinner_kernel replaces src/repro/kernels/spinner.py::
// _seeded_spinner_kernel (behind spinner_project_seeded_pallas). The same
// function with g, d0 and d1 regenerated on chip from one uint32 seed per
// group (threefry2x32 + Box-Muller at flat param positions, the rules of
// kernels/seedgen.py): device memory holds x, the output and 8 bytes of
// seed per group, nothing else. The TPU kernel evaluates the cipher for
// every entry of every (tm, n) tile; here a block draws each value its row
// tile reads ONCE, into shared memory, one draw per thread (a circulant
// row reuses the same n values, so a per-entry draw would cost ~TM times
// more than the block's multiply-adds):
//   circulant / skew   the n values of every block i / n its rows touch
//   toeplitz           the window of glin indices j - i + m - 1 its rows
//                      touch (at most TM + n - 1)
//   hankel             the window of positions i + j (at most TM + n - 1)
//   d0, d1             n signs each (before the window, in the same space)
//   unstructured       no window: every entry is read once per block, so
//                      each thread draws its own row's entries as it walks
//                      j and feeds each draw to TB multiply-adds.
// The window is then read by the same coef/project code as g is. Box-Muller
// uses the accurate logf, sqrtf and cosf (no intrinsics, no fast math) in
// the reference's order of operations, so the drawn values equal
// seedgen.normal_at evaluated by PyTorch on the card, and the seeded kernel
// equals spinner_kernel run on seedgen.grouped_params.
//
// What bounds them on this card: at the serving shapes (n = 128, m = 256,
// G = 8 heads, or 64 (head, request) groups for seeded SRF, B = 1..64 rows
// per group) a call moves tens to hundreds of KB and does B*m*n
// multiply-adds per group, so it is bound by launch latency and by the FMA
// issue rate of the CUDA cores (no tensor cores here), not by HBM. The
// seeded kernel adds one threefry + Box-Muller per window entry (~TM + n per
// block), about one draw a thread. The design keeps every intermediate on
// chip:
//  * one block owns (batch tile of TB rows, row tile of TM = 256 rows of A,
//    group). The TPU kernel carries the HD result in VMEM scratch from one
//    row-tile grid step to the next; blocks here run in no order, so each
//    block RECOMPUTES the HD sandwich for its batch tile. At n = 128 that is
//    TB*n*log2(n) adds against TB*TM*n FMAs of projection (~3%), and it
//    buys ceil(m/TM) times more blocks than looping over row tiles inside
//    one block would when m > TM. At the serving m = 256 a row tile is the
//    whole of A, and the grid is filled by shrinking TB instead (pick_tb):
//    the decode shapes have few groups of few rows.
//  * x rows are staged in shared memory as f32, transposed to v[j][r], so
//    the projection reads TB consecutive floats per column j (a broadcast:
//    every thread of the block reads the same address).
//  * HD is an in-place natural-order butterfly in shared memory; natural
//    order equals the Sylvester H_a (x) H_b the TPU kernel multiplies by.
//  * each thread owns one row i of A, reads A[i, j] for j = 0..n-1 (from g
//    through the read-only cache, or from the seeded window), and keeps TB
//    accumulators in registers: one generator read feeds TB FMAs.
//  * the epilogue and the single write happen in registers; consecutive
//    threads write consecutive columns. Ragged B and m are masked, nothing
//    is padded in memory.
// Shared memory: staged x is at most 48 KB (pick_tb); the seeded window
// grows with n (up to 2n floats for circulant at n = MAX_N = 8192), so a
// launch above 48 KB of dynamic shared memory first raises the kernel's
// limit with cudaFuncSetAttribute.
// Later work: stage A tiles in shared memory and use wgmma for large B.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Kind { CIRCULANT = 0, SKEW_CIRCULANT = 1, TOEPLITZ = 2, HANKEL = 3,
            UNSTRUCTURED = 4 };
enum Epilogue { IDENTITY = 0, RELU = 1, HEAVISIDE = 2, SIGN = 3, EXP = 4,
                COS_SIN = 5 };
// kernels/seedgen.py's domains (the second threefry key word)
enum Domain { DOM_G = 0, DOM_D0 = 1, DOM_D1 = 2 };

constexpr int TM = 256;             // rows of A per block = threads per block
constexpr int SMEM_FLOATS = 12288;  // 48 KB of staged x: TB * n <= this
// dynamic shared memory a launch may take without opting in, less room
// for the kernels' static arrays
constexpr size_t DEFAULT_SMEM = 47 * 1024;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// counter-based generation (kernels/seedgen.py, elementwise)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// 20-round threefry-2x32: key (k0, k1), counter (x0, x1) in, streams out.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][q]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float u01(uint32_t bits) {   // [0, 1)
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// seedgen.normal_at: Box-Muller over the position's two streams, in the
// reference's order: u1 = 1 - u01(b0), sqrt(-2 log u1) * cos(2 pi u2).
__device__ __forceinline__ float normal_at(uint32_t seed, uint32_t domain,
                                           uint32_t pos) {
  uint32_t b0 = pos, b1 = 0u;
  threefry2x32(seed, domain, b0, b1);
  const float u1 = 1.0f - u01(b0);
  const float u2 = u01(b1);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// seedgen.sign_at: +1 where the first stream's top bit is set, else -1.
__device__ __forceinline__ float sign_at(uint32_t seed, uint32_t domain,
                                         uint32_t pos) {
  uint32_t b0 = pos, b1 = 0u;
  threefry2x32(seed, domain, b0, b1);
  return (b0 >> 31) ? 1.f : -1.f;
}

// ---------------------------------------------------------------------------
// sources of A's entries. coef asks for index p: the flat position in g
// for circulant / skew / hankel / unstructured, and glin's index k for
// toeplitz (glin = [flip(g[n:]), g[:n]], so k < m - 1 reads g[n + m-2-k]).
// ---------------------------------------------------------------------------

template <typename T>
struct GlobalGen {                  // the generator g in device memory
  const T* g;
  int n, m;
  __device__ __forceinline__ float operator()(long long p) const {
    return load(g + p);
  }
  __device__ __forceinline__ float toeplitz(int k) const {
    return k < m - 1 ? load(g + (n + (m - 2 - k))) : load(g + (k - (m - 1)));
  }
};

struct WindowGen {                  // seeded: the block's window in smem
  const float* w;
  long long base;
  __device__ __forceinline__ float operator()(long long p) const {
    return w[p - base];
  }
  __device__ __forceinline__ float toeplitz(int k) const {
    return w[k - base];
  }
};

struct RegenGen {                   // seeded unstructured: drawn where used
  uint32_t seed;
  __device__ __forceinline__ float operator()(long long p) const {
    return normal_at(seed, DOM_G, (uint32_t)p);
  }
  __device__ __forceinline__ float toeplitz(int) const { return 0.f; }
};

template <typename T>
struct GlobalDiag {
  const T* d;
  __device__ __forceinline__ float operator()(int j) const {
    return load(d + j);
  }
};

struct SharedDiag {
  const float* d;
  __device__ __forceinline__ float operator()(int j) const { return d[j]; }
};

// A[i, j] by the index rules of _regen_tile over the _gen_table layouts:
//   circulant       [g, g][blk, j - (i mod n) + n],   blk = i / n
//   skew_circulant  [-g, g][blk, j - (i mod n) + n]
//   toeplitz        glin[j - i + m - 1]
//   hankel          g[i + j]
//   unstructured    g[i, j] (dense rows)
template <int KIND, typename Src>
__device__ __forceinline__ float coef(const Src& src, int i, int j, int n,
                                      int m) {
  if (KIND == CIRCULANT || KIND == SKEW_CIRCULANT) {
    const int blk = i / n;
    const int idx = j - (i - blk * n) + n;          // in [1, 2n)
    const long long gb = (long long)blk * n;
    if (idx >= n) return src(gb + (idx - n));
    return KIND == CIRCULANT ? src(gb + idx) : -src(gb + idx);
  } else if (KIND == TOEPLITZ) {
    return src.toeplitz(j - i + m - 1);             // in [0, n + m - 1)
  } else if (KIND == HANKEL) {
    return src((long long)(i + j));
  } else {
    return src((long long)i * n + j);
  }
}

template <int KIND, int TB, typename Src>
__device__ __forceinline__ void project(const Src& src, const float* v, int i,
                                        int n, int m, float* acc) {
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float a = coef<KIND>(src, i, j, n, m);
    const float* vj = v + j * TB;
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = fmaf(a, vj[r], acc[r]);
  }
}

template <int TB, typename Src>
__device__ __forceinline__ void project_kind(int kind, const Src& src,
                                             const float* v, int i, int n,
                                             int m, float* acc) {
  switch (kind) {
    case CIRCULANT: project<CIRCULANT, TB>(src, v, i, n, m, acc); break;
    case SKEW_CIRCULANT:
      project<SKEW_CIRCULANT, TB>(src, v, i, n, m, acc);
      break;
    case TOEPLITZ: project<TOEPLITZ, TB>(src, v, i, n, m, acc); break;
    case HANKEL: project<HANKEL, TB>(src, v, i, n, m, acc); break;
    default: project<UNSTRUCTURED, TB>(src, v, i, n, m, acc); break;
  }
}

// ---------------------------------------------------------------------------
// steps shared by both kernels (every thread of the block calls them)
// ---------------------------------------------------------------------------

// x rows [r0, r0 + rows) of the group -> v[j * TB + r] as f32, zero-padded.
template <typename T, int TB>
__device__ __forceinline__ void stage_x(const T* xg, float* v, int rows,
                                        int n) {
  for (int idx = threadIdx.x; idx < TB * n; idx += TM) {
    const int r = idx / n, j = idx - r * n;
    v[j * TB + r] = r < rows ? load(xg + (size_t)r * n + j) : 0.f;
  }
}

// sq[r] = 0.5 ||x_r||^2 from the RAW x (||v|| = ||x||: HD is an isometry).
template <int TB>
__device__ __forceinline__ void half_sq(const float* v, float* sq, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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
}

// v <- D1 H D0 v / sqrt(n) in place: a natural-order butterfly.
template <int TB, typename D0, typename D1>
__device__ __forceinline__ void hd(float* v, int n, float inv_sqrt_n,
                                   const D0& d0, const D1& d1) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < TB * n; idx += TM) v[idx] *= d0(idx / TB);
  __syncthreads();
  for (int h = 1; h < n; h <<= 1) {
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
    v[idx] = v[idx] * inv_sqrt_n * d1(idx / TB);
}

// Epilogue and the single write of column i for the block's rows.
template <typename T, int TB>
__device__ __forceinline__ void write_out(const float* acc, const float* sq,
                                          T* og, int rows, int i, int m,
                                          int epilogue, float y_scale,
                                          float out_scale) {
  const int width = epilogue == COS_SIN ? 2 * m : m;
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

// ---------------------------------------------------------------------------
// the two kernels
// ---------------------------------------------------------------------------

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
  const int rows = min(TB, B - r0);

  stage_x<T, TB>(x + ((size_t)gi * B + r0) * n, v, rows, n);
  __syncthreads();
  if (epilogue == EXP) {
    half_sq<TB>(v, sq, n);
    __syncthreads();                // HD below rewrites v in place
  }
  if (use_hd)
    hd<TB>(v, n, inv_sqrt_n, GlobalDiag<T>{d0 + (size_t)gi * n},
           GlobalDiag<T>{d1 + (size_t)gi * n});
  __syncthreads();

  const int i = i0 + threadIdx.x;
  if (i >= m) return;
  float acc[TB];
  project_kind<TB>(kind, GlobalGen<T>{g + (size_t)gi * gstride, n, m}, v, i,
                   n, m, acc);
  write_out<T, TB>(acc, sq,
                   out + ((size_t)gi * B + r0) * (epilogue == COS_SIN ? 2 * m
                                                                      : m),
                   rows, i, m, epilogue, y_scale, out_scale);
}

template <typename T, int TB>
__global__ void __launch_bounds__(TM)
seeded_spinner_kernel(const T* __restrict__ x,
                      const long long* __restrict__ seeds,
                      T* __restrict__ out, int B, int n, int m, int kind,
                      int epilogue, int use_hd, float inv_sqrt_n,
                      float y_scale, float out_scale) {
  extern __shared__ float smem[];
  float* v = smem;                  // TB * n, transposed: v[j * TB + r]
  float* w = smem + TB * n;         // d0 | d1, then the generator window
  __shared__ float sq[TB];

  const int r0 = blockIdx.x * TB;
  const int i0 = blockIdx.y * TM;
  const int gi = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(TB, B - r0);
  const uint32_t seed = (uint32_t)seeds[gi];

  stage_x<T, TB>(x + ((size_t)gi * B + r0) * n, v, rows, n);
  if (use_hd) {
    for (int j = tid; j < n; j += TM) {
      w[j] = sign_at(seed, DOM_D0, j);
      w[n + j] = sign_at(seed, DOM_D1, j);
    }
  }
  __syncthreads();
  if (epilogue == EXP) {
    half_sq<TB>(v, sq, n);
    __syncthreads();
  }
  if (use_hd) hd<TB>(v, n, inv_sqrt_n, SharedDiag{w}, SharedDiag{w + n});
  __syncthreads();                  // d0 / d1 read: w is free for the window

  // the window of generator values rows [i0, i_hi] read, one draw a thread
  const int i_hi = min(i0 + TM, m) - 1;
  long long base = 0;
  if (kind == CIRCULANT || kind == SKEW_CIRCULANT) {
    const int b0 = i0 / n, b1 = i_hi / n;
    base = (long long)b0 * n;
    const int len = (b1 - b0 + 1) * n;
    for (int t = tid; t < len; t += TM)
      w[t] = normal_at(seed, DOM_G, (uint32_t)(base + t));
  } else if (kind == TOEPLITZ) {
    base = m - 1 - i_hi;            // glin index k = j - i + m - 1
    const int len = i_hi - i0 + n;
    for (int t = tid; t < len; t += TM) {
      const int k = (int)base + t;
      const int pos = k >= m - 1 ? k - (m - 1) : n + (m - 2 - k);
      w[t] = normal_at(seed, DOM_G, (uint32_t)pos);
    }
  } else if (kind == HANKEL) {
    base = i0;                      // position i + j
    const int len = i_hi - i0 + n;
    for (int t = tid; t < len; t += TM)
      w[t] = normal_at(seed, DOM_G, (uint32_t)(base + t));
  }
  __syncthreads();

  const int i = i0 + tid;
  if (i >= m) return;
  float acc[TB];
  if (kind == UNSTRUCTURED)
    project<UNSTRUCTURED, TB>(RegenGen{seed}, v, i, n, m, acc);
  else
    project_kind<TB>(kind, WindowGen{w, base}, v, i, n, m, acc);
  write_out<T, TB>(acc, sq,
                   out + ((size_t)gi * B + r0) * (epilogue == COS_SIN ? 2 * m
                                                                      : m),
                   rows, i, m, epilogue, y_scale, out_scale);
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
// still gives at least one block per SM; decode calls (a few rows a
// group) come out at TB = 1..2, prefill calls at TB = 8..16. Fewer rows
// per block means fewer FMAs per generator read, but at decode sizes the
// card is latency-bound and idle SMs cost more.
int pick_tb(int G, int B, int n, int m) {
  const long long tiles = (long long)G * ((m + TM - 1) / TM);
  int tb = 16;
  while (tb > 1 && (tb * n > SMEM_FLOATS || tb / 2 >= B ||
                    tiles * ((B + tb - 1) / tb) < sm_count()))
    tb >>= 1;
  return tb;
}

// Floats of the seeded kernel's window area: the largest window a row
// tile reads (see the kernel), and room for d0 | d1.
long long seeded_window(int kind, int n, int m, int use_hd) {
  long long win = 0;
  if (kind == CIRCULANT || kind == SKEW_CIRCULANT) {
    const long long nb = (m + n - 1) / n;
    const long long spans = (TM - 1) / n + 2;      // blocks TM rows touch
    win = (spans < nb ? spans : nb) * n;
  } else if (kind == TOEPLITZ || kind == HANKEL) {
    win = (long long)(m < TM ? m : TM) + n - 1;
  }
  const long long diag = use_hd ? 2LL * n : 0;
  return win > diag ? win : diag;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch(const T* x, const T* d0, const T* d1, const T* g, T* out, int G,
           int B, int n, int m, long long gstride, int kind, int epilogue,
           int use_hd, float inv_sqrt_n, float y_scale, float out_scale,
           cudaStream_t stream) {
  const int tb = pick_tb(G, B, n, m);
  const dim3 grid((B + tb - 1) / tb, (m + TM - 1) / TM, G);
  const size_t smem = (size_t)tb * n * sizeof(float);
  cudaError_t err = cudaSuccess;
#define SPINNER_LAUNCH(TBV)                                                  \
  err = allow_smem(spinner_kernel<T, TBV>, smem);                            \
  if (err == cudaSuccess)                                                    \
    spinner_kernel<T, TBV><<<grid, TM, smem, stream>>>(                      \
        x, d0, d1, g, out, B, n, m, gstride, kind, epilogue, use_hd,         \
        inv_sqrt_n, y_scale, out_scale)
  switch (tb) {
    case 16: SPINNER_LAUNCH(16); break;
    case 8: SPINNER_LAUNCH(8); break;
    case 4: SPINNER_LAUNCH(4); break;
    case 2: SPINNER_LAUNCH(2); break;
    default: SPINNER_LAUNCH(1); break;
  }
#undef SPINNER_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_seeded(const T* x, const long long* seeds, T* out, int G, int B,
                  int n, int m, int kind, int epilogue, int use_hd,
                  float inv_sqrt_n, float y_scale, float out_scale,
                  cudaStream_t stream) {
  const int tb = pick_tb(G, B, n, m);
  const dim3 grid((B + tb - 1) / tb, (m + TM - 1) / TM, G);
  const size_t smem =
      ((size_t)tb * n + (size_t)seeded_window(kind, n, m, use_hd)) *
      sizeof(float);
  cudaError_t err = cudaSuccess;
#define SEEDED_LAUNCH(TBV)                                                   \
  err = allow_smem(seeded_spinner_kernel<T, TBV>, smem);                     \
  if (err == cudaSuccess)                                                    \
    seeded_spinner_kernel<T, TBV><<<grid, TM, smem, stream>>>(               \
        x, seeds, out, B, n, m, kind, epilogue, use_hd, inv_sqrt_n, y_scale, \
        out_scale)
  switch (tb) {
    case 16: SEEDED_LAUNCH(16); break;
    case 8: SEEDED_LAUNCH(8); break;
    case 4: SEEDED_LAUNCH(4); break;
    case 2: SEEDED_LAUNCH(2); break;
    default: SEEDED_LAUNCH(1); break;
  }
#undef SEEDED_LAUNCH
  if (err != cudaSuccess) return (int)err;
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

// Seeded: x (G, B, n), seeds (G,) int64 holding the uint32 seeds, out
// (G, B, m) or (G, B, 2m). Device pointers of contiguous tensors; returns
// the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int spinner_project_seeded_f32(const float* x,
                                          const long long* seeds, float* out,
                                          int G, int B, int n, int m,
                                          int kind, int epilogue, int use_hd,
                                          float inv_sqrt_n, float y_scale,
                                          float out_scale, void* stream) {
  return launch_seeded<float>(x, seeds, out, G, B, n, m, kind, epilogue,
                              use_hd, inv_sqrt_n, y_scale, out_scale,
                              (cudaStream_t)stream);
}

extern "C" int spinner_project_seeded_bf16(const __nv_bfloat16* x,
                                           const long long* seeds,
                                           __nv_bfloat16* out, int G, int B,
                                           int n, int m, int kind,
                                           int epilogue, int use_hd,
                                           float inv_sqrt_n, float y_scale,
                                           float out_scale, void* stream) {
  return launch_seeded<__nv_bfloat16>(x, seeds, out, G, B, n, m, kind,
                                      epilogue, use_hd, inv_sqrt_n, y_scale,
                                      out_scale, (cudaStream_t)stream);
}
