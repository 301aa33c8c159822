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
// A from the doubled generator [g, g] in VMEM and feeds it to the MXU.
// This kernel does the same on the tensor cores: A never exists in memory.
//
// What bounds it on this card: the function needs only the FFT product's
// operations, so its bound is the bytes (x read once, the output written
// once: 0.050 ms at B = 8192, n = 1024, m = 4096, f32). The kernel does the
// dense B*m*n multiply-adds instead (a product with a regenerated A, as the
// TPU kernel does), so it is bound by the tensor cores' rate and by the
// instructions around them:
//  * a block owns an output tile of BM = 128 rows of x by BN = 128 columns
//    of y (8 warps, each 64 x 32 of it; two blocks an SM) and walks j in
//    chunks of BK = 32. The chunks of x are staged in shared memory by
//    cp.async (16-byte copies, zero-filled past B and n), STAGES - 1
//    chunks in flight ahead of the one multiplied (3 stages in f32, 4 in
//    bf16), one barrier a chunk; A fragments are read by ldmatrix.
//  * B operand, the (BK, BN) tile of A^T, is never read from memory. Where
//    the tile's BN output rows lie in one generator block, A_tile[c][k] =
//    w[k - c + BN - 1] with w the BN + BK - 1 consecutive values of the
//    doubled generator that the chunk needs (a Toeplitz window): each chunk
//    reads BN + BK - 1 generator values (one a thread, loaded a chunk
//    ahead), and each lane builds its mma fragments from w in shared
//    memory (lanes of a fragment read w at k - c: 11 distinct words, no
//    bank conflict). Tiles that cross a generator block, or where n < BN,
//    build the whole tile in shared memory by the per-row rule A[i, j] =
//    g[i / n, (j - i mod n) mod n] (zero past m and n). The chunk product
//    is a template on the two layouts, so its shared loads take constant
//    offsets.
//  * warp-level mma.sync: m16n8k16 bf16 (bf16 operands, f32 accumulators),
//    and for f32 3xTF32 (m16n8k8): each operand v is split into two tf32
//    values big + small, and the warp sums small*big + big*small + big*big
//    (the window is split once, at staging, by cvt.rna; x as it is loaded,
//    by masks: big = v with its low 13 bits cleared, small the exact
//    remainder likewise; cvt.rna costs ~5 instructions here, the masks 3).
//    Single-pass TF32 keeps ~11 bits and misses f32 tolerances at
//    n = 1024; the split keeps ~21. The tensor cores round their f32
//    accumulation toward zero, which over n / 8 steps drifts past f32
//    tolerances (measured: 3.4e-5 at n = 160), so each k8 step's three
//    products are summed from a zero accumulator and added to the running
//    sum by an ordinary (round-to-nearest) add.
//  * the epilogue runs on the accumulator fragments in registers, and
//    writes each output once. Ragged B, m and n are masked.
// x rows that are not 16-byte aligned (n % 4 in f32, n % 8 in bf16, or an
// offset base) are staged by plain loads instead of cp.async.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Epilogue { IDENTITY = 0, RELU = 1, HEAVISIDE = 2, EXP = 3, COS_SIN = 4 };

constexpr int BM = 128;             // rows of x a block
constexpr int BN = 128;             // output columns a block
constexpr int BK = 32;              // columns of x a chunk
constexpr int THREADS = 256;        // 8 warps: 2 along BM x 4 along BN
constexpr int WM = 64, WN = 32;     // a warp's tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int WIN = BN + BK;        // window words (BN + BK - 1 used)
constexpr int TS = BN + 8;          // row stride (words) of a built tile

template <typename T> struct Tr;
template <> struct Tr<float> {
  static constexpr int KS = 8;                 // mma depth
  static constexpr int XS = BK + 4;            // staged x row stride
  static constexpr int STAGES = 3;             // chunks in flight
  static constexpr int WWORDS = 2 * WIN;       // a window: big, small
  static constexpr int PLANE = 2 * BK * TS;    // words of a built tile
  static constexpr int SMALL = BK * TS;        // offset of the small plane
};
template <> struct Tr<__nv_bfloat16> {
  static constexpr int KS = 16;
  static constexpr int XS = BK + 8;
  static constexpr int STAGES = 4;
  static constexpr int WWORDS = WIN;           // packed (u, u+1) pairs
  static constexpr int PLANE = (BK / 2) * TS;  // packed (k, k+1) pairs
  static constexpr int SMALL = 0;              // (no small plane)
};

// Shared memory: STAGES chunks of x, STAGES windows, one built tile.
template <typename T>
constexpr size_t smem_bytes() {
  return Tr<T>::STAGES * ((size_t)BM * Tr<T>::XS * sizeof(T) +
                          Tr<T>::WWORDS * sizeof(uint32_t)) +
         Tr<T>::PLANE * sizeof(uint32_t);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit values (or 8x4 of 32-bit) from shared
// memory: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b, float) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a * b (tf32, a zero accumulator in)
__device__ __forceinline__ void mma0(float* d, const uint32_t* a,
                                     const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b, __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A[i, j] = g[i / n, (j - i mod n) mod n], 0 past m or n (raw bits).
__device__ __forceinline__ float a_at(const float* g, int n, int m, int i,
                                      int j) {
  return (i < m && j < n) ? __ldg(g + (size_t)(i / n) * n +
                                  (j - i % n + n) % n)
                          : 0.f;
}
__device__ __forceinline__ uint32_t a_at(const __nv_bfloat16* g, int n,
                                         int m, int i, int j) {
  const unsigned short* gb = reinterpret_cast<const unsigned short*>(g);
  return (i < m && j < n) ? gb[(size_t)(i / n) * n + (j - i % n + n) % n]
                          : 0u;
}

// Stage x[b0:b0+BM, j0:j0+BK] into xs (row stride XS), zero past B and n.
template <typename T>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ x,
                                        int B, int n, int b0, int j0,
                                        bool vec) {
  constexpr int XS = Tr<T>::XS;
  if (vec) {
    constexpr int EPV = 16 / sizeof(T);        // elements a 16-byte copy
    constexpr int PER_ROW = BK / EPV;
    for (int e = threadIdx.x; e < BM * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW, c = (e % PER_ROW) * EPV;
      const int b = b0 + r, j = j0 + c;
      const bool ok = b < B && j < n;          // n % EPV == 0: all or none
      cp_async16(xs + r * XS + c, ok ? x + (size_t)b * n + j : x,
                 ok ? 16 : 0);
    }
  } else {
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int b = b0 + r, j = j0 + c;
      if constexpr (sizeof(T) == 4) {
        xs[r * XS + c] = (b < B && j < n) ? x[(size_t)b * n + j] : 0.f;
      } else {
        reinterpret_cast<unsigned short*>(xs)[r * XS + c] =
            (b < B && j < n) ? xb[(size_t)b * n + j] : 0;
      }
    }
  }
}

// The window of a Toeplitz tile, one word a thread (u = threadIdx.x <
// BN + BK - 1): w[u] of chunk kc is A[i0 + c, kc * BK + k] at
// u = k - c + BN - 1, generator index (u - i0 mod n - (BN - 1) + kc * BK)
// mod n. Each thread loads its word a chunk ahead (chunk kc + 2's while
// chunk kc is multiplied), so the load's latency hides behind a chunk of
// products. f32 keeps the value, bf16 the packed pair (w[u], w[u + 1]).
template <typename T> struct Word { using type = float; };
template <> struct Word<__nv_bfloat16> { using type = uint32_t; };

template <typename T>
__device__ __forceinline__ typename Word<T>::type window_load(
    const T* __restrict__ row, int n, int& idx) {
  typename Word<T>::type v;
  if constexpr (sizeof(T) == 4) {
    v = __ldg(row + idx);
  } else {
    const unsigned short* rb = reinterpret_cast<const unsigned short*>(row);
    v = (uint32_t)rb[idx] | ((uint32_t)rb[idx + 1 == n ? 0 : idx + 1] << 16);
  }
  idx += BK;                          // n >= BN > BK in a window tile
  if (idx >= n) idx -= n;
  return v;
}

// Store a window word: f32 as a big and a small tf32 plane (at + WIN).
__device__ __forceinline__ void window_store(uint32_t* bs, float v) {
  const uint32_t big = tf32(v);
  bs[threadIdx.x] = big;
  bs[WIN + threadIdx.x] = tf32(v - __uint_as_float(big));
}
__device__ __forceinline__ void window_store(uint32_t* bs, uint32_t v) {
  bs[threadIdx.x] = v;
}

// Build the whole (BK, BN) B tile of chunk j0 for output columns i0.. at
// [k][c] by the per-row rule (tiles that are no window). f32: a big and a
// small tf32 plane; bf16: packed (k, k+1) pairs at [k / 2][c].
template <typename T>
__device__ __forceinline__ void stage_tile(uint32_t* bs,
                                           const T* __restrict__ g, int n,
                                           int m, int i0, int j0) {
  if constexpr (sizeof(T) == 4) {
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int k = e / BN, c = e % BN;
      const float v = a_at(g, n, m, i0 + c, j0 + k);
      const uint32_t big = tf32(v);
      bs[k * TS + c] = big;
      bs[Tr<float>::SMALL + k * TS + c] = tf32(v - __uint_as_float(big));
    }
  } else {
    for (int e = threadIdx.x; e < (BK / 2) * BN; e += THREADS) {
      const int kp = e / BN, c = e % BN;
      const int i = i0 + c, j = j0 + 2 * kp;
      bs[kp * TS + c] = a_at(g, n, m, i, j) | (a_at(g, n, m, i, j + 1) << 16);
    }
  }
}

// v = big + small as two tf32 values (low 13 bits clear): big is v
// truncated, small the exact remainder truncated, so v is kept to ~2^-21.
__device__ __forceinline__ void split(uint32_t v, uint32_t& big,
                                      uint32_t& small) {
  big = v & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(v) - __uint_as_float(big)) &
          0xffffe000u;
}

// One chunk's products, acc += x_chunk . B. B word of (k, c) at k * SK +
// c * SC + OFF: a window k - c + BN - 1, a built tile k * TS + c (f32) or
// k / 2 * TS + c (bf16, k even); f32's small plane at + SMALL. The
// strides are constants, so every shared load takes an immediate offset.
template <typename T, bool WINDOW>
__device__ __forceinline__ void multiply_chunk(float (&acc)[MT][NT][4],
                                               const T* xc,
                                               const uint32_t* bc, int wm,
                                               int wn, int lane) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int XS = Tr<T>::XS, KS = Tr<T>::KS;
  constexpr int SK = WINDOW ? 1 : (F32 ? TS : TS / 2);
  constexpr int SC = WINDOW ? -1 : 1;
  constexpr int OFF = WINDOW ? BN - 1 : 0;
  constexpr int SMALL = WINDOW ? WIN : Tr<T>::SMALL;
  constexpr int KH = F32 ? 4 : 8;               // second B register's k
  // this lane's B fragment (k, c) = (tq or 2 tq, wn + gq), and its
  // ldmatrix row: matrices are rows +0 / +8 by columns +0 / +KS/2
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t* bl = bc + (F32 ? tq : 2 * tq) * SK + (wn + gq) * SC + OFF;
  const T* xl = xc + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                (lane >> 4) * (KS / 2);
#pragma unroll
  for (int ks = 0; ks < BK; ks += KS) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int w = ks * SK + nt * 8 * SC;
      bb[nt][0] = bl[w];
      bb[nt][1] = bl[w + KH * SK];
      if constexpr (F32) {
        bs[nt][0] = bl[SMALL + w];
        bs[nt][1] = bl[SMALL + w + KH * SK];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm4(a, xl + mt * 16 * XS + ks);
      if constexpr (F32) {
        uint32_t big[4], sml[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split(a[q], big[q], sml[q]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float t[4];
          mma0(t, sml, bb[nt]);
          mma(t, big, bs[nt], T());
          mma(t, big, bb[nt], T());
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += t[q];
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a, bb[nt], T());
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
circulant_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ sq, T* __restrict__ out, int B,
                 int n, int m, int epilogue, int vec) {
  constexpr int XS = Tr<T>::XS, S = Tr<T>::STAGES, WW = Tr<T>::WWORDS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem + S * BM * XS * sizeof(T));
  uint32_t* tile = wsm + S * WW;

  const int i0 = blockIdx.x * BN, b0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  const int gq = lane >> 2, tq = lane & 3;     // fragment row / column
  const bool window = i0 % n + BN <= n;

  float acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;

  const int chunks = (n + BK - 1) / BK;
  const T* grow = g + (size_t)(i0 / n) * n;   // a window's generator row
  const bool owner = window && threadIdx.x < BN + BK - 1;
  int widx = ((int)threadIdx.x - i0 % n - (BN - 1)) % n;
  if (widx < 0) widx += n;
  typename Word<T>::type wv{};
  // S - 1 chunks in flight ahead of the one multiplied; one barrier a
  // chunk (the stage written at chunk kc was read at chunk kc - 1, which
  // every warp has left once it passes chunk kc's barrier)
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < chunks) {
      stage_x(xs + st * BM * XS, x, B, n, b0, st * BK, vec);
      if (owner) window_store(wsm + st * WW, window_load(grow, n, widx));
    }
    cp_async_commit();
  }
  if (owner) wv = window_load(grow, n, widx);   // chunk S - 1's word
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (!window) {
      stage_tile(tile, g, n, m, i0, kc * BK);
      __syncthreads();
    }
    const int nx = kc + S - 1, st = nx % S;
    if (nx < chunks) {
      stage_x(xs + st * BM * XS, x, B, n, b0, nx * BK, vec);
      if (owner) {
        window_store(wsm + st * WW, wv);
        wv = window_load(grow, n, widx);        // chunk nx + 1's word
      }
    }
    cp_async_commit();
    const T* xc = xs + (kc % S) * BM * XS;
    if (window)
      multiply_chunk<T, true>(acc, xc, wsm + (kc % S) * WW, wm, wn, lane);
    else
      multiply_chunk<T, false>(acc, xc, tile, wm, wn, lane);
  }

  const int width = epilogue == COS_SIN ? 2 * m : m;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wm + mt * 16 + gq + 8 * h;
      if (b >= B) continue;
      T* o = out + (size_t)b * width;
      const float s = epilogue == EXP ? sq[b] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = i0 + wn + nt * 8 + 2 * tq + q;
          if (i >= m) continue;
          const float y = acc[mt][nt][2 * h + q];
          switch (epilogue) {
            case RELU: store(o + i, fmaxf(y, 0.f)); break;
            case HEAVISIDE: store(o + i, y >= 0.f ? 1.f : 0.f); break;
            case EXP: store(o + i, expf(y - s)); break;
            case COS_SIN:
              store(o + i, cosf(y));
              store(o + m + i, sinf(y));
              break;
            default: store(o + i, y); break;
          }
        }
    }
}

template <typename T>
int launch(const void* x, const void* g, const float* sq, void* out, int B,
           int n, int nb, int m, int epilogue, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || (long long)nb * n < m ||
      epilogue < IDENTITY || epilogue > COS_SIN ||
      (epilogue == EXP && sq == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + BN - 1) / BN, (B + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = smem_bytes<T>();
  static bool opted = false;            // once per dtype (per process)
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        circulant_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted = true;
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
