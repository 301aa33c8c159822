// The tensor-core mainloop shared by circulant.cu and spinner.cu: one
// (BM, BN) output tile of  y = a . A^T  with A (m, n) regenerated from its
// O(n) generator chunk by chunk, never held in device memory, and the
// pointwise epilogue on the accumulators. Header only; each source that
// includes it gets its own copy inside an anonymous namespace.
//
// A block owns BM = 32 * MT rows of `a` by BN = 128 output columns (8
// warps: 2 along BM x 4 along BN, each 16 MT x 32 of it) and walks j in
// chunks of BK = 32:
//  * the A operand (rows of `a`) is either staged chunk by chunk from device
//    memory by cp.async (16-byte copies, zero-filled past B and n; STAGES - 1
//    chunks in flight, one barrier a chunk; plain loads for unaligned rows),
//    or RESIDENT: the caller has put the block's rows, all n columns, in
//    shared memory (row stride Tr<TA>::ZS) before the loop. Fragments are
//    read by ldmatrix.
//  * the B operand, the (BK, BN) tile of A^T of chunk kc, is read from one of
//    three layouts in shared memory; the chunk product takes the word of
//    (k, c) at k * SK + c * SC + OFF, all constants:
//      - Toeplitz window (SK = 1, SC = -1, OFF = BN - 1): A[i0 + c, j] =
//        w[j - c + BN - 1]. Circulant and skew-circulant tiles whose BN
//        rows lie in one generator block, and every Toeplitz tile.
//      - Hankel window (SK = 1, SC = +1, OFF = 0): A[i0 + c, j] = w[j + c].
//      - built tile (SK = TS, SC = 1): the whole tile written each chunk by
//        the per-row rule, for circulant / skew tiles that cross a generator
//        block (or n < BN) and for dense (unstructured) A.
//    A window holds the values w[u], u < chunks * BK + BN, that the block's
//    columns read over ALL chunks (chunk kc reads it from u = kc * BK on),
//    written once before the loop: every generator value is read (or, in the
//    seeded kernel, drawn) once a block.
//  * warp-level mma.sync, in one of three modes (MMA_OF<TA, TO>):
//    - TF32X3 (f32 in, f32 out): 3xTF32 (m16n8k8). Each operand v is split
//      into two tf32 values big + small, and the warp sums small*big +
//      big*small + big*big. Single-pass TF32 keeps ~11 bits and misses f32
//      tolerances at n = 1024; the split keeps ~21. The tensor cores round
//      their f32 accumulation toward zero, which over n / 8 steps drifts
//      past f32 tolerances (3.4e-5 at n = 160), so each k8 step's three
//      products are summed from a zero accumulator and added to the running
//      sum by an ordinary (round-to-nearest) add.
//    - BF16 (bf16 in and out, operands exact in bf16: circulant): one
//      m16n8k16 product, f32 accumulators.
//    - BF16X2 (an f32 A operand, bf16 out: the spinner's z = D1 H D0 x,
//      which bf16 cannot hold): m16n8k16 on z = hi + lo, two bf16 values,
//      and on the B operand's hi (and lo, where the generator values are
//      not bf16: the seeded kernel's draws), f32 accumulators. The A
//      fragments come from the f32 layout of TF32X3 (columns t, t + 4 of a
//      k8 step), so k is permuted: the k16 product pairs logical (2t, 2t+1,
//      2t+8, 2t+9) with stored (t, t+4, t+8, t+12), in A and B alike.
//    B is split once, when the window or tile is written (tf32 by cvt.rna,
//    bf16 by round to nearest), into a hi and a lo plane, each word already
//    what the mma's B register holds (TF32X3: the value; BF16X2: the bf16
//    pair of k and k + 4), so every fragment is two 4-byte loads straight
//    into its register pair (an 8-byte (hi, lo) load would need a move
//    for each half); the A operand is split as it is loaded, by masks
//    (hi: v with its low bits cleared, lo: the exact remainder likewise).
//  * the epilogue  f(y_scale * y) * out_scale  runs on the accumulator
//    fragments and writes each output once; ragged B, m and n are masked.
// The values, the split, and the order of products and sums depend only on
// the generator values and the A operand, never on where the values came
// from: so the seeded spinner, which draws its window from a seed, equals
// the materialized spinner on the same values bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Kind { CIRCULANT = 0, SKEW_CIRCULANT = 1, TOEPLITZ = 2, HANKEL = 3,
            UNSTRUCTURED = 4 };
enum Epilogue { IDENTITY = 0, RELU = 1, HEAVISIDE = 2, SIGN = 3, EXP = 4,
                COS_SIN = 5 };
enum Layout { TOEPLITZ_WINDOW = 0, HANKEL_WINDOW = 1, BUILT_TILE = 2 };
enum Mma { TF32X3 = 0, BF16 = 1, BF16X2 = 2 };

constexpr int BN = 128;             // output columns a block
constexpr int BK = 32;              // columns of the A operand a chunk
constexpr int THREADS = 256;        // 8 warps: 2 along BM x 4 along BN
constexpr int WN = 32, NT = WN / 8;  // a warp's columns, its n8 tiles
constexpr int RES_N = 128;          // n up to which the rows stay resident

// TA: the A operand's type in shared memory (the B operand's follows it).
template <typename T> struct Tr;
template <> struct Tr<float> {
  static constexpr int XS = BK + 4;      // staged row stride (elements)
  static constexpr int ZS = RES_N + 4;   // resident row stride (elements)
  static constexpr int STAGES = 3;       // chunks in flight
  static constexpr int UNIT = 2;         // B planes: hi, lo
  static constexpr int TS = BN + 8;      // built tile row stride (words)
  static constexpr int TILE_WORDS = 2 * BK * TS;
};
template <> struct Tr<__nv_bfloat16> {
  static constexpr int XS = BK + 8;
  static constexpr int ZS = RES_N + 8;
  static constexpr int STAGES = 4;
  static constexpr int UNIT = 1;         // one plane of (k, k + 1) pairs
  static constexpr int TS = BN + 8;      // built tile row stride (pairs)
  static constexpr int TILE_WORDS = (BK / 2) * TS;
};

__host__ __device__ constexpr int chunks_of(int n) { return (n + BK - 1) / BK; }
// values of a block's window
__host__ __device__ constexpr int window_len(int n) {
  return chunks_of(n) * BK + BN;
}

// The product's mode from the A operand's type in shared memory (TA) and
// the output's (TO).
template <typename TA, typename TO>
constexpr int MMA_OF = sizeof(TA) == 2 ? BF16 : (sizeof(TO) == 4 ? TF32X3
                                                                 : BF16X2);

// Shared memory the mainloop takes after the caller's own (RESIDENT rows,
// seeded draws): staged chunks, the window, and the built tile if any
// block of the launch builds one.
template <typename T>
size_t mainloop_bytes(int bm, bool resident, int n, bool tile) {
  size_t b = resident ? 0 : (size_t)Tr<T>::STAGES * bm * Tr<T>::XS * sizeof(T);
  b += (size_t)Tr<T>::UNIT * window_len(n) * sizeof(uint32_t);
  if (tile) b += (size_t)Tr<T>::TILE_WORDS * sizeof(uint32_t);
  return b;
}

// Whether some column tile of a circulant / skew-circulant A crosses a
// generator block: n < BN, or a tile starts within BN of a block's end.
__host__ __device__ inline bool crosses_block(int n, int m) {
  return n < BN || (n % BN != 0 && m > (n / BN) * BN);
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The generator g of one group in device memory: value at flat position p
// of its canonical array ((nb, n) circulant / skew, (n + m - 1) Toeplitz /
// Hankel, (m, n) dense); toeplitz(k) reads glin[k], glin = [flip(g[n:]),
// g[:n]] (k < m - 1 reads g[n + m - 2 - k]).
template <typename T>
struct GlobalSrc {
  static constexpr bool BF16_EXACT = sizeof(T) == 2;   // no lo part in bf16
  const T* g;
  int n, m;
  __device__ __forceinline__ float operator()(long long p) const {
    return to_float(g[p]);
  }
  __device__ __forceinline__ float toeplitz(int k) const {
    return (*this)(k >= m - 1 ? k - (m - 1) : n + (m - 2 - k));
  }
};

// w[u] of a block's window (columns i0 .. i_hi = min(i0 + BN, m) - 1), the
// value of A[i0 + c, j] at u = j - c + BN - 1 (Hankel: u = j + c). Values
// no valid (i, j) reads are 0 (Toeplitz, Hankel) or wrap (circulant, skew:
// indices mod n); they meet only zero A-operand columns or masked outputs.
template <typename Src>
__device__ __forceinline__ float window_value(const Src& src, int kind, int u,
                                              int n, int m, int i0,
                                              int i_hi) {
  if (kind == HANKEL) {
    const int p = i0 + u;
    return p <= i_hi + n - 1 ? src((long long)p) : 0.f;
  }
  if (kind == TOEPLITZ) {
    const int k = u - (BN - 1) - i0 + m - 1;
    return (k >= m - 1 - i_hi && k <= n + m - 2 - i0) ? src.toeplitz(k)
                                                       : 0.f;
  }
  const long long gb = (long long)(i0 / n) * n;
  const int t = u - (BN - 1) - i0 % n;        // > -n in a window tile
  if (kind == CIRCULANT) return src(gb + (t % n + n) % n);
  const int d = (t + n) % (2 * n);             // index into [-g, g]
  return d >= n ? src(gb + (d - n)) : -src(gb + d);
}

// A[i, j] by the per-row rule (a built tile), 0 past m and n.
template <typename Src>
__device__ __forceinline__ float tile_value(const Src& src, int kind, int i,
                                            int j, int n, int m) {
  if (i >= m || j >= n) return 0.f;
  if (kind == UNSTRUCTURED) return src((long long)i * n + j);
  if (kind == HANKEL) return src((long long)(i + j));
  if (kind == TOEPLITZ) return src.toeplitz(j - i + m - 1);
  const long long gb = (long long)(i / n) * n;
  const int d = j - i % n;
  const float v = src(gb + (d < 0 ? d + n : d));
  return (kind == SKEW_CIRCULANT && d < 0) ? -v : v;
}

// The B words of values v (at k) and v4 (at k + 4): the hi and lo plane's
// word, tf32 halves of v (TF32X3) or the bf16 halves of both, packed
// (BF16X2).
template <int MMA>
__device__ __forceinline__ void split_b(float v, float v4, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (MMA == TF32X3) {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  } else {
    const uint32_t h = bf16_bits(v), h4 = bf16_bits(v4);
    hi = h | (h4 << 16);
    lo = bf16_bits(v - __uint_as_float(h << 16)) |
         (bf16_bits(v4 - __uint_as_float(h4 << 16)) << 16);
  }
}

// Which layout the block of columns i0 reads.
__device__ __forceinline__ int layout_of(int kind, int n, int i0) {
  return kind == HANKEL ? HANKEL_WINDOW
         : kind == TOEPLITZ ? TOEPLITZ_WINDOW
         : kind == UNSTRUCTURED ? BUILT_TILE
         : (i0 % n + BN <= n ? TOEPLITZ_WINDOW : BUILT_TILE);
}

// The window of the block's columns (blockIdx.x), written once if it reads
// one: hi plane at w, lo plane at w + window_len(n) (TF32X3, BF16X2), or
// packed (w[u], w[u + 1]) bf16 pairs (BF16). Every thread calls it.
template <int MMA, typename Src>
__device__ __forceinline__ void build_window(uint32_t* w, const Src& src,
                                             int kind, int n, int m) {
  const int i0 = blockIdx.x * BN;
  if (layout_of(kind, n, i0) == BUILT_TILE) return;
  const int len = window_len(n), i_hi = min(i0 + BN, m) - 1;
  for (int u = threadIdx.x; u < len; u += THREADS) {
    const float v = window_value(src, kind, u, n, m, i0, i_hi);
    if constexpr (MMA == BF16) {
      const float v1 = window_value(src, kind, u + 1, n, m, i0, i_hi);
      w[u] = bf16_bits(v) | (bf16_bits(v1) << 16);
    } else {
      const float v4 = MMA == BF16X2
                           ? window_value(src, kind, u + 4, n, m, i0, i_hi)
                           : 0.f;
      split_b<MMA>(v, v4, w[u], w[len + u]);
    }
  }
}

// The (BK, BN) tile of chunk j0 by the per-row rule, at [k][c]: hi and lo
// planes (TF32X3, BF16X2: the pair of k and k + 4), or packed (k, k + 1)
// bf16 pairs at [k / 2][c] (BF16).
template <int MMA, typename Src>
__device__ __forceinline__ void build_tile(uint32_t* t, const Src& src,
                                           int kind, int n, int m, int i0,
                                           int j0) {
  if constexpr (MMA != BF16) {
    constexpr int TS = Tr<float>::TS;
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int k = e / BN, c = e % BN;
      const float v = tile_value(src, kind, i0 + c, j0 + k, n, m);
      const float v4 =
          MMA == BF16X2 ? tile_value(src, kind, i0 + c, j0 + k + 4, n, m)
                        : 0.f;
      split_b<MMA>(v, v4, t[k * TS + c], t[BK * TS + k * TS + c]);
    }
  } else {
    constexpr int TS = Tr<__nv_bfloat16>::TS;
    for (int e = threadIdx.x; e < (BK / 2) * BN; e += THREADS) {
      const int kp = e / BN, c = e % BN;
      const int i = i0 + c, j = j0 + 2 * kp;
      t[kp * TS + c] = bf16_bits(tile_value(src, kind, i, j, n, m)) |
                       (bf16_bits(tile_value(src, kind, i, j + 1, n, m)) << 16);
    }
  }
}

// Stage a[b0:b0+BM, j0:j0+BK] into xs (row stride XS), zero past B and n.
template <typename T, int BM>
__device__ __forceinline__ void stage_x(T* xs, const T* __restrict__ x, int B,
                                        int n, int b0, int j0, bool vec) {
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

// v = big + small as two tf32 values (low 13 bits clear): big is v
// truncated, small the exact remainder truncated, so v is kept to ~2^-21.
__device__ __forceinline__ void split(uint32_t v, uint32_t& big,
                                      uint32_t& small) {
  big = v & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(v) - __uint_as_float(big)) &
          0xffffe000u;
}

// The same into two bf16 values (low 16 bits clear): v kept to ~2^-16.
__device__ __forceinline__ void split16(uint32_t v, uint32_t& hi,
                                        uint32_t& lo) {
  hi = v & 0xffff0000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi)) &
       0xffff0000u;
}

// Two bf16 halves (the top halves of a and b) as one bf16x2 register, a's
// in the low half (the lower k).
__device__ __forceinline__ uint32_t pack(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// One chunk's products, acc += a_chunk . B. B's word of (k, c) at
// k * SK + c * SC + OFF of the hi plane bc and of the lo plane bc + lo
// (TF32X3: the value's halves; BF16X2: the packed pair of k and k + 4), or
// of the one plane of packed (k, k + 1) pairs at even k (BF16). XS: the A
// operand's row stride. BLO: BF16X2 also multiplies by B's lo plane. Every
// shared load takes a constant offset.
template <int MMA, bool BLO, int MT, int XS, int SK, int SC, int OFF,
          typename TA>
__device__ __forceinline__ void multiply_chunk(float (&acc)[MT][NT][4],
                                               const TA* xc,
                                               const uint32_t* bc, int lo,
                                               int wm, int wn, int lane) {
  // this lane's B fragment (k, c) = (tq or 2 tq, wn + gq), and its
  // ldmatrix row: matrices are rows +0 / +8 by columns +0 / +4 f32 (+8
  // bf16) values
  const int gq = lane >> 2, tq = lane & 3;
  const TA* xl = xc + (wm + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                 (lane >> 4) * (MMA == BF16 ? 8 : 4);
  const uint32_t* bh =
      bc + (MMA == BF16 ? 2 * tq : tq) * SK + (wn + gq) * SC + OFF;
  const uint32_t* bl = bh + lo;
  if constexpr (MMA == BF16) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bb[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int w = ks * SK + nt * 8 * SC;
        bb[nt][0] = bh[w];
        bb[nt][1] = bh[w + 8 * SK];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm4(a, xl + mt * 16 * XS + ks);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a, bb[nt], TA());
      }
    }
  } else if constexpr (MMA == TF32X3) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int w = ks * SK + nt * 8 * SC;
        bb[nt][0] = bh[w];
        bb[nt][1] = bh[w + 4 * SK];
        bs[nt][0] = bl[w];
        bs[nt][1] = bl[w + 4 * SK];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4], big[4], sml[4];
        ldsm4(a, xl + mt * 16 * XS + ks);
#pragma unroll
        for (int q = 0; q < 4; ++q) split(a[q], big[q], sml[q]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float t[4];
          mma0(t, sml, bb[nt]);
          mma(t, big, bs[nt], 0.f);
          mma(t, big, bb[nt], 0.f);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += t[q];
        }
      }
    }
  } else {                    // BF16X2: k16 steps over stored k order
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int w = ks * SK + nt * 8 * SC;
        bb[nt][0] = bh[w];
        bb[nt][1] = bh[w + 8 * SK];
        if constexpr (BLO) {
          bs[nt][0] = bl[w];
          bs[nt][1] = bl[w + 8 * SK];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // r0: (g, t), (g+8, t), (g, t+4), (g+8, t+4); r1: the same + 8
        uint32_t r0[4], r1[4], h0[4], l0[4], h1[4], l1[4];
        ldsm4(r0, xl + mt * 16 * XS + ks);
        ldsm4(r1, xl + mt * 16 * XS + ks + 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split16(r0[q], h0[q], l0[q]);
          split16(r1[q], h1[q], l1[q]);
        }
        const uint32_t ah[4] = {pack(h0[0], h0[2]), pack(h0[1], h0[3]),
                                pack(h1[0], h1[2]), pack(h1[1], h1[3])};
        const uint32_t al[4] = {pack(l0[0], l0[2]), pack(l0[1], l0[3]),
                                pack(l1[0], l1[2]), pack(l1[1], l1[3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma(acc[mt][nt], al, bb[nt], __nv_bfloat16());
          if constexpr (BLO) mma(acc[mt][nt], ah, bs[nt], __nv_bfloat16());
          mma(acc[mt][nt], ah, bb[nt], __nv_bfloat16());
        }
      }
    }
  }
}

// The epilogue of one value: f(y_scale * acc) * out_scale; cos_sin writes
// [cos | sin] (o + i and o + m + i).
template <typename T>
__device__ __forceinline__ void write_value(T* o, int i, int m, float acc,
                                            float s, int epilogue,
                                            float y_scale, float out_scale) {
  const float y = acc * y_scale;
  if (epilogue == COS_SIN) {
    store(o + i, cosf(y) * out_scale);
    store(o + m + i, sinf(y) * out_scale);
    return;
  }
  float f;
  switch (epilogue) {
    case RELU: f = fmaxf(y, 0.f); break;
    case HEAVISIDE: f = y >= 0.f ? 1.f : 0.f; break;
    case SIGN: f = y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f); break;
    case EXP: f = expf(y - s); break;
    default: f = y; break;
  }
  store(o + i, f * out_scale);
}

// The mainloop's window in its shared memory (mainloop_bytes<TA>).
template <typename TA, int MT, bool RESIDENT>
__device__ __forceinline__ uint32_t* window_at(unsigned char* smem) {
  return reinterpret_cast<uint32_t*>(
      smem + (RESIDENT ? 0
                       : (size_t)Tr<TA>::STAGES * 32 * MT * Tr<TA>::XS *
                             sizeof(TA)));
}

// The whole tile of block (blockIdx.x: columns, blockIdx.y: rows) of one
// group: out rows [b0, b0 + BM) of og = f(a . A^T), A from src. a is xg
// (B, n) row-major in TA, staged by chunks, or (RESIDENT) zs, all n
// columns of the block's rows in shared memory, zero from n to
// chunks_of(n) * BK. sqr: the exp subtrahends of the block's rows
// (sqr[b - b0]). smem: the mainloop's shared memory (mainloop_bytes<TA>),
// whose window the caller has written by build_window<MMA_OF<TA, TO>>
// (window_at). Every thread of the block calls it; the caller's shared
// writes need no barrier before it. Warps whose rows all lie past B skip
// the products.
template <typename TA, typename TO, int MT, bool RESIDENT, typename Src>
__device__ __forceinline__ void project_tile(
    const Src& src, const TA* __restrict__ xg, const TA* zs,
    const float* sqr, TO* __restrict__ og, int B, int n, int m, int kind,
    int epilogue, float y_scale, float out_scale, bool vec,
    unsigned char* smem) {
  constexpr int MMA = MMA_OF<TA, TO>;
  constexpr bool BLO = !Src::BF16_EXACT;
  constexpr int BM = 32 * MT, WM = 16 * MT;
  constexpr int XS = Tr<TA>::XS, S = Tr<TA>::STAGES, U = Tr<TA>::UNIT;
  constexpr int AXS = RESIDENT ? Tr<TA>::ZS : XS;
  constexpr int TSK = MMA == BF16 ? Tr<TA>::TS / 2 : Tr<TA>::TS;
  TA* xs = reinterpret_cast<TA*>(smem);
  uint32_t* win = window_at<TA, MT, RESIDENT>(smem);
  uint32_t* tile = win + U * window_len(n);

  const int i0 = blockIdx.x * BN, b0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  const bool busy = b0 + wm < B;
  const int chunks = chunks_of(n);
  const int layout = layout_of(kind, n, i0);
  if constexpr (!RESIDENT) {
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < chunks)
        stage_x<TA, BM>(xs + st * BM * XS, xg, B, n, b0, st * BK, vec);
      cp_async_commit();
    }
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;

  for (int kc = 0; kc < chunks; ++kc) {
    // one barrier a chunk: the window and the caller's writes (first
    // chunk), chunk kc's stage, and every warp done with chunk kc - 1 (its
    // stage and tile are written below)
    if constexpr (!RESIDENT) cp_async_wait<S - 2>();
    __syncthreads();
    if (layout == BUILT_TILE) {
      build_tile<MMA>(tile, src, kind, n, m, i0, kc * BK);
      __syncthreads();
    }
    const TA* xc;
    if constexpr (RESIDENT) {
      xc = zs + kc * BK;
    } else {
      const int nx = kc + S - 1;
      if (nx < chunks)
        stage_x<TA, BM>(xs + (nx % S) * BM * XS, xg, B, n, b0, nx * BK, vec);
      cp_async_commit();
      xc = xs + (kc % S) * BM * XS;
    }
    if (!busy) continue;
    const uint32_t* wc = win + kc * BK;
    if (layout == TOEPLITZ_WINDOW)
      multiply_chunk<MMA, BLO, MT, AXS, 1, -1, BN - 1>(
          acc, xc, wc, window_len(n), wm, wn, lane);
    else if (layout == HANKEL_WINDOW)
      multiply_chunk<MMA, BLO, MT, AXS, 1, 1, 0>(acc, xc, wc, window_len(n),
                                                 wm, wn, lane);
    else
      multiply_chunk<MMA, BLO, MT, AXS, TSK, 1, 0>(
          acc, xc, tile, BK * Tr<TA>::TS, wm, wn, lane);
  }

  const int gq = lane >> 2, tq = lane & 3;
  const int width = epilogue == COS_SIN ? 2 * m : m;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = b0 + wm + mt * 16 + gq + 8 * h;
      if (b >= B) continue;
      TO* o = og + (size_t)b * width;
      const float s = epilogue == EXP ? sqr[b - b0] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = i0 + wn + nt * 8 + 2 * tq + q;
          if (i < m)
            write_value(o, i, m, acc[mt][nt][2 * h + q], s, epilogue,
                        y_scale, out_scale);
        }
    }
}

}  // namespace
