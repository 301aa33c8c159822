// Fused structured spinner  out = f(y_scale * A . D1 H D0 . x) * out_scale
// for Hopper (sm_90a), plain C interface, loaded with ctypes
// (repro_torch/kernels/spinner.py). Two kernels share every step but the
// source of A's entries and of the HD diagonals:
//
// spinner_kernel replaces src/repro/kernels/spinner.py::_spinner_kernel
// (the TPU kernel behind spinner_project_pallas). x (G, B, n) -> (G, B, m),
// or (G, B, 2m) = [cos | sin] per row for cos_sin; f32 accumulation, one
// cast on write; A never exists in memory: its entries are read from the
// O(n) generator g (circulant, skew-circulant, Toeplitz, Hankel) or the
// dense g (unstructured) by the index rules of _regen_tile / _gen_table.
//
// seeded_spinner_kernel replaces src/repro/kernels/spinner.py::
// _seeded_spinner_kernel (behind spinner_project_seeded_pallas): the same
// function with g, d0 and d1 regenerated on chip from one uint32 seed per
// group (threefry2x32 + Box-Muller at flat param positions, the rules of
// kernels/seedgen.py). Device memory holds x, the output and 8 bytes of
// seed per group (and z below at n > 128).
//
// What bounds them on this card: the function needs an FFT product (O(n log
// n) a row), so its bound is the bytes at every shape. The kernels do the
// dense B*m*n multiply-adds of a product with a regenerated A instead, as
// the TPU kernel does, on the tensor cores: each launch is
// window_mma.cuh's mainloop (mma.sync; f32 as 3xTF32, bf16 with f32
// accumulators) behind a prologue that produces its A operand
// z = D1 H D0 x / sqrt(n) ONCE per row:
//  * n <= 128 (the serving head width): the block computes z for its BM
//    rows itself, one warp a row, the butterfly in registers and shuffles
//    (natural order, which equals the Sylvester H_a (x) H_b the TPU kernel
//    multiplies by), and keeps the rows resident in shared memory as the A
//    operand for all n / 32 chunks. 0.5 ||x||^2 (exp) is summed from the raw
//    row on the way.
//  * n > 128 (the library's n = 1024): a pre-pass kernel writes z and
//    0.5 ||x||^2 once per row into scratch the wrapper allocates (32 MiB at
//    B = 8192, n = 1024, f32: it stays in the 50 MB L2), staging rows in
//    shared memory and running three butterfly stages at a time in
//    registers (fwht.cu's design); the projection then streams z chunk by
//    chunk by cp.async, as circulant.cu streams x. Without HD it streams x.
//  z stays f32 in both dtypes: f32 runs 3xTF32, bf16 runs m16n8k16 on
//  z = hi + lo (two bf16 values) and the generator's bf16 values (the
//  seeded kernel's f32 draws: hi + lo as well). Rounding z once to bf16
//  instead cost up to 2.05e-2 of the largest cos_sin output at n = 64 on
//  the card, past the bf16 tolerance of 2e-2.
//  The pre-pass also writes x itself in f32 where bf16 x has no HD.
// The B operand comes from a window of the generator that the block writes
// into shared memory once (every generator value a block's columns read
// over all chunks: BN + n values, split into (hi, lo) pairs), or, for
// circulant / skew tiles that cross a generator block and for dense A,
// from a tile built by the per-row rule each chunk. The seeded block draws
// each value its columns read ONCE into shared memory first (the generator
// values of the blocks its BN columns touch, or the BN + n - 1 Toeplitz /
// Hankel values, and d0 and d1: n signs each, while its first rows load)
// and builds the window or tile from there; seeded dense A draws its tile each chunk (BK * BN draws a
// chunk, repeated for every row tile: unstructured is off the serving
// path). Box-Muller uses the accurate logf, sqrtf and cosf (no intrinsics,
// no fast math) in the reference's order of operations, so the drawn values
// equal seedgen.normal_at evaluated by PyTorch on the card; since the
// values, their split, and the order of products and sums are the same,
// the f32 seeded kernel equals spinner_kernel run on seedgen.grouped_params
// bit for bit.
// Tiles: BM = 32 or 128 rows a block (pick_mt: 128 where that still gives
// two blocks an SM, else 32: the decode shapes have 1-32 rows a group) by
// BN = 128 columns, one group a block (blockIdx.z).

#include "window_mma.cuh"

namespace {

// kernels/seedgen.py's domains (the second threefry key word)
enum Domain { DOM_G = 0, DOM_D0 = 1, DOM_D1 = 2 };

constexpr int MAX_N = 8192;
constexpr int PRE_ELEMS = 2048;     // a pre-pass block stages at least this

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

// The generator values a column tile [i0, i0 + BN) reads: gen[u] holds flat
// position base + u (circulant / skew: the whole blocks i0 / n .. i_hi / n;
// Hankel: i0 .. i_hi + n - 1), or, for Toeplitz, glin index base + u (the
// BN + n - 1 diagonals j - i + m - 1). Dense A has none (len 0).
__host__ __device__ inline void gen_range(int kind, int n, int m, int i0,
                                          long long& base, int& len) {
  const int i_hi = (i0 + BN < m ? i0 + BN : m) - 1;
  base = 0;
  len = 0;
  if (kind == CIRCULANT || kind == SKEW_CIRCULANT) {
    base = (long long)(i0 / n) * n;
    len = (i_hi / n - i0 / n + 1) * n;
  } else if (kind == TOEPLITZ) {
    base = m - 1 - i_hi;
    len = i_hi - i0 + n;
  } else if (kind == HANKEL) {
    base = i0;
    len = i_hi - i0 + n;
  }
}

// The most gen values a tile of the launch draws (the host's bound of
// gen_range's len).
int gen_len(int kind, int n, int m) {
  if (kind == CIRCULANT || kind == SKEW_CIRCULANT) {
    if (!crosses_block(n, m)) return n;
    const int blocks = (m + n - 1) / n, spans = (BN - 1) / n + 2;
    return (blocks < spans ? blocks : spans) * n;
  }
  if (kind == TOEPLITZ || kind == HANKEL) return (m < BN ? m : BN) + n - 1;
  return 0;
}

// The seeded block's source: its drawn values, or (dense A, gen == null)
// a draw at the position.
struct SeededSrc {
  static constexpr bool BF16_EXACT = false;    // f32 draws: bf16 hi + lo
  const float* gen;
  long long base;
  uint32_t seed;
  __device__ __forceinline__ float operator()(long long p) const {
    return gen != nullptr ? gen[p - base]
                          : normal_at(seed, DOM_G, (uint32_t)p);
  }
  __device__ __forceinline__ float toeplitz(int k) const {
    return gen[k - base];
  }
};

template <typename T>
struct GlobalDiag {
  const T* d;
  __device__ __forceinline__ float operator()(int j) const {
    return to_float(d[j]);
  }
};

struct SharedDiag {
  const float* d;
  __device__ __forceinline__ float operator()(int j) const { return d[j]; }
};

// ---------------------------------------------------------------------------
// the block's shared memory: [resident rows | their 0.5||x||^2] [seeded:
// d0 | d1 (resident with HD) | drawn generator values] [mainloop]
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t a16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

struct Plan {
  size_t sq, diag, gen, main;
};

__host__ __device__ inline Plan plan(int bm, bool resident, bool seeded,
                                     int n, int use_hd, int gen_words) {
  Plan p;
  size_t o = resident ? a16((size_t)bm * Tr<float>::ZS * sizeof(float)) : 0;
  p.sq = o;
  o += resident ? a16((size_t)bm * sizeof(float)) : 0;
  p.diag = o;
  o += (seeded && resident && use_hd) ? a16(2 * (size_t)n * sizeof(float))
                                      : 0;
  p.gen = o;
  o += seeded ? a16((size_t)gen_words * sizeof(float)) : 0;
  p.main = o;
  return p;
}

// One launch's arguments (both kernels and the pre-pass).
template <typename T>
struct Args {
  const T* x;               // (G, B, n)
  const T* d0;              // (G, n), materialized with HD, else null
  const T* d1;
  const T* g;               // materialized: gstride elements a group
  long long gstride;
  const long long* seeds;   // seeded: (G,) uint32 seeds in int64 words
  float* z;                 // (G, B, n) pre-pass output at n > RES_N: z with
                            // HD, else x in f32 (bf16 x)
  float* sq;                // (G, B) pre-pass output at n > RES_N with exp
  T* out;                   // (G, B, m) or (G, B, 2m)
  int B, n, m, kind, epilogue, use_hd, vec, gen_words;
  float inv_sqrt_n, y_scale, out_scale;
};

// ---------------------------------------------------------------------------
// n <= RES_N: the block's rows, resident (E consecutive values a lane)
// ---------------------------------------------------------------------------

// zs[r][j] = (D1 H D0 x_r / sqrt(n))[j] (or x_r without HD) in f32 for the
// block's `rows` rows, zero for n <= j < chunks * BK; sqs[r] =
// 0.5 ||x_r||^2. A warp takes rows warp, warp + 8, ..., loading 4 rows
// before it works on them, so their loads' latencies overlap; `between`
// (block-wide work, every thread calls it once) runs while the first
// loads are in flight.
template <typename T, int E, typename Diag, typename F>
__device__ __forceinline__ void resident_rows(const T* __restrict__ xr0,
                                              float* zs, float* sqs,
                                              const Diag& d0, const Diag& d1,
                                              int rows, int n, bool hd,
                                              bool want_sq, float inv_sqrt_n,
                                              const F& between) {
  constexpr int ZS = Tr<float>::ZS, R = 4, W = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = chunks_of(n) * BK;
  float v[R][E];
  auto load = [&](int r0) {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = r0 + q * W, j = lane * E + e;
        v[q][e] = r < rows && j < n ? to_float(xr0[(size_t)r * n + j]) : 0.f;
      }
  };
  load(warp);
  between();
  for (int r0 = warp; r0 < rows; r0 += R * W) {
    if (r0 != warp) load(r0);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q * W;
      if (r >= rows) break;
      if (want_sq) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(v[q][e], v[q][e], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) sqs[r] = 0.5f * s;
      }
      if (hd) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (lane * E + e < n) v[q][e] *= d0(lane * E + e);
        // strides below E inside the lane, then across lanes
        if constexpr (E >= 2) {
#pragma unroll
          for (int p = 0; p < E; p += 2) {
            const float a = v[q][p], b = v[q][p + 1];
            v[q][p] = a + b;
            v[q][p + 1] = a - b;
          }
        }
        if constexpr (E >= 4) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float a = v[q][p], b = v[q][p + 2];
            v[q][p] = a + b;
            v[q][p + 2] = a - b;
          }
        }
        for (int s = 1; s * E < n; s <<= 1) {
          const bool upper = (lane & s) != 0;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float p = __shfl_xor_sync(0xffffffffu, v[q][e], s);
            v[q][e] = upper ? p - v[q][e] : v[q][e] + p;
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (lane * E + e < n) v[q][e] = v[q][e] * inv_sqrt_n * d1(lane * E + e);
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (lane * E + e < n) zs[r * ZS + lane * E + e] = v[q][e];
      for (int j = n + lane; j < cols; j += 32) zs[r * ZS + j] = 0.f;
    }
  }
}

// E = n / 32 values a lane with HD (the butterfly's lane layout), else 4.
template <typename T, typename Diag, typename F>
__device__ __forceinline__ void resident_prologue(
    const T* xr0, float* zs, float* sqs, const Diag& d0, const Diag& d1,
    int rows, int n, bool hd, bool want_sq, float inv_sqrt_n,
    const F& between) {
  if (!hd || n > 64)
    resident_rows<T, 4>(xr0, zs, sqs, d0, d1, rows, n, hd, want_sq,
                        inv_sqrt_n, between);
  else if (n > 32)
    resident_rows<T, 2>(xr0, zs, sqs, d0, d1, rows, n, hd, want_sq,
                        inv_sqrt_n, between);
  else
    resident_rows<T, 1>(xr0, zs, sqs, d0, d1, rows, n, hd, want_sq,
                        inv_sqrt_n, between);
}

// ---------------------------------------------------------------------------
// n > RES_N: the pre-pass (z and 0.5 ||x||^2 once per row)
// ---------------------------------------------------------------------------

__host__ __device__ inline int pre_rows(int n) {
  const int r = n >= PRE_ELEMS ? 1 : PRE_ELEMS / n;
  return r > 8 ? 8 : r;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// R butterfly stages of strides h, 2h, ..., 2^(R-1) h over every staged
// row, 2^R values a thread in registers (fwht.cu). LAST: write
// v / sqrt(n) * d1 cast to `out` (the rows' first element) instead of
// back to s.
template <int R, bool LAST, typename T>
__device__ __forceinline__ void stages(float* s, T* out, const float* d1s,
                                       int rows, int n, int log2n, int h,
                                       float inv_sqrt_n) {
  constexpr int E = 1 << R;
  const int log2g = log2n - R;                 // groups a row: n / E
  const int total = rows << log2g;
  for (int t = threadIdx.x; t < total; t += THREADS) {
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
      const int i = base + q * h;
      if (LAST)
        store(out + i, v[q] * inv_sqrt_n * d1s[i & (n - 1)]);
      else
        s[pad(i)] = v[q];
    }
  }
}

template <bool LAST, typename T>
__device__ __forceinline__ void group(int r, float* s, T* out,
                                      const float* d1s, int rows, int n,
                                      int log2n, int h, float inv_sqrt_n) {
  switch (r) {
    case 1: stages<1, LAST>(s, out, d1s, rows, n, log2n, h, inv_sqrt_n); break;
    case 2: stages<2, LAST>(s, out, d1s, rows, n, log2n, h, inv_sqrt_n); break;
    default: stages<3, LAST>(s, out, d1s, rows, n, log2n, h, inv_sqrt_n); break;
  }
}

// Block (blockIdx.x, group blockIdx.y) loops over row groups of pre_rows(n)
// rows: z = D1 H D0 x / sqrt(n) in f32 (use_hd), or z = x in f32 (no HD, z
// set: bf16 x), and sq = 0.5 ||x||^2 (sq set). Shared: d0 | d1 (use_hd;
// seeded: drawn once a block), the staged rows (padded by one float every
// 8), 8 partial sums.
template <typename T, bool SEEDED>
__global__ void __launch_bounds__(THREADS)
prepass_kernel(Args<T> a, int log2n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, gi = blockIdx.y, rpb = pre_rows(n);
  const bool hd = a.use_hd != 0, want_sq = a.sq != nullptr;
  float* d0s = reinterpret_cast<float*>(smem);
  float* d1s = d0s + (hd ? n : 0);
  float* s = d1s + (hd ? n : 0);
  float* part = s + pad(rpb * n - 1) + 1;
  if (hd) {
    if constexpr (SEEDED) {
      const uint32_t seed = (uint32_t)a.seeds[gi];
      for (int t = threadIdx.x; t < 2 * n; t += THREADS) {
        if (t < n)
          d0s[t] = sign_at(seed, DOM_D0, t);
        else
          d1s[t - n] = sign_at(seed, DOM_D1, t - n);
      }
    } else {
      for (int t = threadIdx.x; t < n; t += THREADS) {
        d0s[t] = to_float(a.d0[(size_t)gi * n + t]);
        d1s[t] = to_float(a.d1[(size_t)gi * n + t]);
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpr = (THREADS / 32) / rpb;           // warps a row's sum
  for (long long rg = blockIdx.x; rg * rpb < a.B; rg += gridDim.x) {
    const long long row0 = rg * rpb;
    const int rows = (int)min((long long)rpb, (long long)a.B - row0);
    const size_t off = ((size_t)gi * a.B + row0) * n;
    for (int i = threadIdx.x; i < rows * n; i += THREADS) {
      const float v = to_float(a.x[off + i]);
      s[pad(i)] = hd ? v * d0s[i & (n - 1)] : v;
      if (!hd && a.z != nullptr) a.z[off + i] = v;
    }
    __syncthreads();
    if (want_sq) {                 // (x d0)^2 = x^2: the raw row's norm
      const int r = warp / wpr, q = warp % wpr, seg = (n + wpr - 1) / wpr;
      if (r < rows) {
        const int hi = min(n, (q + 1) * seg);
        float acc = 0.f;
        for (int j = q * seg + lane; j < hi; j += 32) {
          const float t = s[pad(r * n + j)];
          acc = fmaf(t, t, acc);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) part[warp] = acc;
      }
      __syncthreads();
      if ((int)threadIdx.x < rows) {
        float t = 0.f;
        for (int w = 0; w < wpr; ++w) t += part[threadIdx.x * wpr + w];
        a.sq[(size_t)gi * a.B + row0 + threadIdx.x] = 0.5f * t;
      }
    }
    if (hd) {
      int h = 1, left = log2n;
      while (left > 3) {
        group<false>(3, s, a.z + off, d1s, rows, n, log2n, h, a.inv_sqrt_n);
        __syncthreads();
        h <<= 3;
        left -= 3;
      }
      group<true>(left, s, a.z + off, d1s, rows, n, log2n, h, a.inv_sqrt_n);
    }
    __syncthreads();                // s and part are reused
  }
}

size_t prepass_bytes(int n, bool hd) {
  const int count = pre_rows(n) * n;
  return sizeof(float) *
         ((hd ? 2 * (size_t)n : 0) + count + ((count - 1) >> 3) + 8);
}

// ---------------------------------------------------------------------------
// the two kernels
// ---------------------------------------------------------------------------

// Everything after the sources are named: `prep` (block-wide: the seeded
// kernel's draws) and the window, while the first rows load; the resident
// rows (n <= RES_N) or the pre-pass's z (or f32 x); then the mainloop on
// the f32 A operand (TF32X3 for f32 out, BF16X2 for bf16 out).
template <typename T, int MT, bool RESIDENT, typename Src, typename Diag,
          typename F>
__device__ __forceinline__ void spin_block(const Args<T>& a, const Src& src,
                                           const Diag& d0, const Diag& d1,
                                           const Plan& p, unsigned char* smem,
                                           const F& prep) {
  constexpr int BM = 32 * MT;
  const int b0 = blockIdx.y * BM;
  const size_t row0 = (size_t)blockIdx.z * a.B;    // the group's first row
  T* og = a.out + row0 * (a.epilogue == COS_SIN ? 2 * a.m : a.m);
  auto between = [&]() {
    prep();
    build_window<MMA_OF<float, T>>(
        window_at<float, MT, RESIDENT>(smem + p.main), src, a.kind, a.n,
        a.m);
  };
  if constexpr (RESIDENT) {
    float* zs = reinterpret_cast<float*>(smem);
    float* sqs = reinterpret_cast<float*>(smem + p.sq);
    resident_prologue(a.x + (row0 + b0) * a.n, zs, sqs, d0, d1,
                      min(BM, a.B - b0), a.n, a.use_hd != 0,
                      a.epilogue == EXP, a.inv_sqrt_n, between);
    project_tile<float, T, MT, true>(src, nullptr, zs, sqs, og, a.B, a.n,
                                     a.m, a.kind, a.epilogue, a.y_scale,
                                     a.out_scale, false, smem + p.main);
  } else {
    const float* rows = a.z != nullptr
                            ? a.z
                            : reinterpret_cast<const float*>(a.x);  // f32 x
    between();
    project_tile<float, T, MT, false>(
        src, rows + row0 * a.n, nullptr,
        a.sq == nullptr ? nullptr : a.sq + row0 + b0, og, a.B, a.n, a.m,
        a.kind, a.epilogue, a.y_scale, a.out_scale, a.vec != 0,
        smem + p.main);
  }
}

template <typename T, int MT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
spinner_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int gi = blockIdx.z;
  const bool hd = a.use_hd != 0;
  spin_block<T, MT, RESIDENT>(
      a, GlobalSrc<T>{a.g + gi * a.gstride, a.n, a.m},
      GlobalDiag<T>{hd ? a.d0 + (size_t)gi * a.n : nullptr},
      GlobalDiag<T>{hd ? a.d1 + (size_t)gi * a.n : nullptr},
      plan(32 * MT, RESIDENT, false, a.n, a.use_hd, 0), smem, [] {});
}

template <typename T, int MT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
seeded_spinner_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n;
  const Plan p = plan(32 * MT, RESIDENT, true, n, a.use_hd, a.gen_words);
  const uint32_t seed = (uint32_t)a.seeds[blockIdx.z];
  float* d0s = reinterpret_cast<float*>(smem + p.diag);
  float* d1s = d0s + n;
  float* gen = reinterpret_cast<float*>(smem + p.gen);
  long long base;
  int len;
  gen_range(a.kind, n, a.m, blockIdx.x * BN, base, len);
  // every value the block reads, drawn once: the generator values one a
  // thread from thread 0, the 2n signs of d0 | d1 two a thread from thread
  // len on (a sign costs about half a normal)
  const int dn = (RESIDENT && a.use_hd) ? n : 0;
  auto draw = [&]() {
    for (int t = threadIdx.x; t < len; t += THREADS) {
      const long long u = base + t;
      const long long pos = a.kind != TOEPLITZ ? u
                            : u >= a.m - 1     ? u - (a.m - 1)
                                               : n + (a.m - 2 - u);
      gen[t] = normal_at(seed, DOM_G, (uint32_t)pos);
    }
    for (int q = (threadIdx.x + THREADS - len % THREADS) % THREADS; q < dn;
         q += THREADS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 2 * q + h;                  // in [0, 2n)
        if (t < dn)
          d0s[t] = sign_at(seed, DOM_D0, t);
        else
          d1s[t - dn] = sign_at(seed, DOM_D1, t - dn);
      }
    }
    __syncthreads();
  };
  spin_block<T, MT, RESIDENT>(
      a, SeededSrc{a.kind == UNSTRUCTURED ? nullptr : gen, base, seed},
      SharedDiag{d0s}, SharedDiag{d1s}, p, smem, draw);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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

// 128 rows a block where that still gives two blocks an SM, else 32 (more
// blocks, and less of each tile past B at a few rows a group).
int pick_mt(int G, int B, int m) {
  const long long tiles = (long long)G * ((m + BN - 1) / BN);
  return tiles * ((B + 127) / 128) >= 2LL * sm_count() ? 4 : 1;
}

template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, size_t& raised) {
  if (bytes <= raised) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) raised = bytes;
  return e;
}

template <typename T, int MT, bool RESIDENT, bool SEEDED>
cudaError_t project(const Args<T>& a, int G, bool tile,
                    cudaStream_t stream) {
  constexpr int BM = 32 * MT;
  const dim3 grid((a.m + BN - 1) / BN, (a.B + BM - 1) / BM, G);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const Plan p = plan(BM, RESIDENT, SEEDED, a.n, a.use_hd, a.gen_words);
  const size_t bytes = p.main + mainloop_bytes<float>(BM, RESIDENT, a.n, tile);
  static size_t raised = 48 * 1024;     // per kernel (per process)
  cudaError_t e;
  if constexpr (SEEDED) {
    e = raise_smem(seeded_spinner_kernel<T, MT, RESIDENT>, bytes, raised);
    if (e == cudaSuccess)
      seeded_spinner_kernel<T, MT, RESIDENT>
          <<<grid, THREADS, bytes, stream>>>(a);
  } else {
    e = raise_smem(spinner_kernel<T, MT, RESIDENT>, bytes, raised);
    if (e == cudaSuccess)
      spinner_kernel<T, MT, RESIDENT><<<grid, THREADS, bytes, stream>>>(a);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, bool SEEDED>
cudaError_t prepass(const Args<T>& a, int G, cudaStream_t stream) {
  int log2n = 0;
  while ((1 << log2n) < a.n) ++log2n;
  const long long groups = (a.B + pre_rows(a.n) - 1) / pre_rows(a.n);
  const long long most = 4LL * sm_count();
  const dim3 grid((unsigned)(groups < most ? groups : most), G);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t bytes = prepass_bytes(a.n, a.use_hd != 0);
  static size_t raised = 48 * 1024;
  const cudaError_t e =
      raise_smem(prepass_kernel<T, SEEDED>, bytes, raised);
  if (e != cudaSuccess) return e;
  prepass_kernel<T, SEEDED><<<grid, THREADS, bytes, stream>>>(a, log2n);
  return cudaGetLastError();
}

template <typename T, bool SEEDED>
int launch(Args<T> a, int G, cudaStream_t stream) {
  const int n = a.n, m = a.m;
  if (G <= 0 || a.B <= 0 || n <= 0 || n > MAX_N || m <= 0 ||
      (long long)n + m - 1 > (1LL << 22) || a.kind < CIRCULANT ||
      a.kind > UNSTRUCTURED || a.epilogue < IDENTITY ||
      a.epilogue > COS_SIN || (a.use_hd && (n & (n - 1)) != 0) ||
      (SEEDED ? a.seeds == nullptr
              : (a.g == nullptr ||
                 (a.use_hd && (a.d0 == nullptr || a.d1 == nullptr)))))
    return (int)cudaErrorInvalidValue;
  const bool resident = n <= RES_N;
  const bool pre_z = !resident && (a.use_hd || sizeof(T) == 2);
  const bool pre_sq = !resident && a.epilogue == EXP;
  if ((pre_z && a.z == nullptr) || (pre_sq && a.sq == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!pre_z) a.z = nullptr;
  if (!pre_sq) a.sq = nullptr;
  a.gen_words = SEEDED ? gen_len(a.kind, n, m) : 0;
  const void* rows = pre_z ? (const void*)a.z : (const void*)a.x;
  a.vec = !resident && n % 4 == 0 &&
          reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const bool tile =
      a.kind == UNSTRUCTURED ||
      ((a.kind == CIRCULANT || a.kind == SKEW_CIRCULANT) &&
       crosses_block(n, m));
  cudaError_t e = cudaSuccess;
  if (pre_z || pre_sq) e = prepass<T, SEEDED>(a, G, stream);
  if (e != cudaSuccess) return (int)e;
  const bool big = pick_mt(G, a.B, m) == 4;
  if (resident)
    e = big ? project<T, 4, true, SEEDED>(a, G, tile, stream)
            : project<T, 1, true, SEEDED>(a, G, tile, stream);
  else
    e = big ? project<T, 4, false, SEEDED>(a, G, tile, stream)
            : project<T, 1, false, SEEDED>(a, G, tile, stream);
  return (int)e;
}

template <typename T>
Args<T> args(const void* x, void* z, void* sq, void* out, int B, int n,
             int m, int kind, int epilogue, int use_hd, float inv_sqrt_n,
             float y_scale, float out_scale) {
  Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.z = static_cast<float*>(z);
  a.sq = static_cast<float*>(sq);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.n = n;
  a.m = m;
  a.kind = kind;
  a.epilogue = epilogue;
  a.use_hd = use_hd;
  a.inv_sqrt_n = inv_sqrt_n;
  a.y_scale = y_scale;
  a.out_scale = out_scale;
  return a;
}

template <typename T>
int materialized(const void* x, const void* d0, const void* d1,
                 const void* g, void* z, void* sq, void* out, int G, int B,
                 int n, int m, long long gstride, int kind, int epilogue,
                 int use_hd, float inv_sqrt_n, float y_scale,
                 float out_scale, void* stream) {
  Args<T> a = args<T>(x, z, sq, out, B, n, m, kind, epilogue, use_hd,
                      inv_sqrt_n, y_scale, out_scale);
  a.d0 = static_cast<const T*>(d0);
  a.d1 = static_cast<const T*>(d1);
  a.g = static_cast<const T*>(g);
  a.gstride = gstride;
  return launch<T, false>(a, G, (cudaStream_t)stream);
}

template <typename T>
int seeded(const void* x, const void* seeds, void* z, void* sq, void* out,
           int G, int B, int n, int m, int kind, int epilogue, int use_hd,
           float inv_sqrt_n, float y_scale, float out_scale, void* stream) {
  Args<T> a = args<T>(x, z, sq, out, B, n, m, kind, epilogue, use_hd,
                      inv_sqrt_n, y_scale, out_scale);
  a.seeds = static_cast<const long long*>(seeds);
  return launch<T, true>(a, G, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// x (G, B, n), d0/d1 (G, n) or null when use_hd == 0, g the group-major
// generator with gstride elements per group, out (G, B, m) or (G, B, 2m);
// z (G, B, n) and sq (G, B), float32: scratch the launch fills at n > 128
// (z with HD or for bf16 x, sq with exp), else null. All pointers are device
// pointers of contiguous tensors. Returns the cudaError_t of the launches
// (0 = cudaSuccess).
int spinner_project_f32(const void* x, const void* d0, const void* d1,
                        const void* g, void* z, void* sq, void* out, int G,
                        int B, int n, int m, long long gstride, int kind,
                        int epilogue, int use_hd, float inv_sqrt_n,
                        float y_scale, float out_scale, void* stream) {
  return materialized<float>(x, d0, d1, g, z, sq, out, G, B, n, m, gstride,
                             kind, epilogue, use_hd, inv_sqrt_n, y_scale,
                             out_scale, stream);
}

int spinner_project_bf16(const void* x, const void* d0, const void* d1,
                         const void* g, void* z, void* sq, void* out, int G,
                         int B, int n, int m, long long gstride, int kind,
                         int epilogue, int use_hd, float inv_sqrt_n,
                         float y_scale, float out_scale, void* stream) {
  return materialized<__nv_bfloat16>(x, d0, d1, g, z, sq, out, G, B, n, m,
                                     gstride, kind, epilogue, use_hd,
                                     inv_sqrt_n, y_scale, out_scale, stream);
}

// Seeded: x (G, B, n), seeds (G,) int64 holding the uint32 seeds, z / sq as
// above, out (G, B, m) or (G, B, 2m). Device pointers of contiguous
// tensors; returns the cudaError_t of the launches (0 = cudaSuccess).
int spinner_project_seeded_f32(const void* x, const void* seeds, void* z,
                               void* sq, void* out, int G, int B, int n,
                               int m, int kind, int epilogue, int use_hd,
                               float inv_sqrt_n, float y_scale,
                               float out_scale, void* stream) {
  return seeded<float>(x, seeds, z, sq, out, G, B, n, m, kind, epilogue,
                       use_hd, inv_sqrt_n, y_scale, out_scale, stream);
}

int spinner_project_seeded_bf16(const void* x, const void* seeds, void* z,
                                void* sq, void* out, int G, int B, int n,
                                int m, int kind, int epilogue, int use_hd,
                                float inv_sqrt_n, float y_scale,
                                float out_scale, void* stream) {
  return seeded<__nv_bfloat16>(x, seeds, z, sq, out, G, B, n, m, kind,
                               epilogue, use_hd, inv_sqrt_n, y_scale,
                               out_scale, stream);
}

}  // extern "C"
