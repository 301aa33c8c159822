// Paged KV gathers for Hopper (sm_90a), plain C interface, loaded with
// ctypes (repro_torch/kernels/paged_gather.py).
//
// Replaces: src/repro/kernels/paged_gather.py::_gather_kernel (behind
// paged_gather_pallas) and ::_gather_dequant_kernel (:33, behind
// paged_gather_dequant_pallas). For pool (N, P, D) and tables (R, M):
//
//     out[r, j*P:(j+1)*P, :] = pool[clamp(table[r, j], 0, N-1)]
//
// and the int8 variant, out = float(pool[idx]) * scales[idx] (one f32
// scale per page row), cast to bf16 (round to nearest even) or kept f32.
//
// What bounds both on this card: bytes. They are copies with no reuse; at
// the full-width decode shape (R = 8, M = 16, P = 16, D = 8 * 128) the
// bf16 gather reads 4.19 MB and writes 4.19 MB (2.5 us at 3.35 TB/s; a
// layer's K and V together 5.0 us), the int8 one reads 2.10 MB of pages
// and 8 KB of scales and writes 4.19 MB of bf16 (1.88 us; K and V 3.76
// us).
//
// The copy kernel (paged_gather_kernel). Its first version gave each
// 128-thread block one chunk of one page (4 x 128 units of the widest
// width, 8 KB when rows allow 16 bytes): 0.0047-0.0050 ms against the
// 0.0025 ms of its bytes at D = 1024, 7% of its bound at D = 64, the
// launch, the id -> page chain and the tail setting its time; and the
// attention paid that twice a layer (K, then V). The design here keeps
// its blocks and pays the fixed costs once a layer:
//  * one launch covers one pool, or two pools that share the table and
//    differ in row width, page size and base (a layer's K and V; MLA's
//    latents c and kpe): the grid is (page slots, chunks of a page of
//    pool 0 + chunks of a page of pool 1), blockIdx.y picks the pool by a
//    select, and each pool's blocks write its own output. Blocks run in
//    the first version's order, chunk-major (chunk 0 of every slot, then
//    chunk 1, ...): a page id that recurs in a table (the null page,
//    shared prefix pages) is read again while its chunk is in L2;
//  * every thread reads its slot's page id itself (one broadcast load a
//    warp), so no block waits on a __syncthreads before its first page
//    load;
//  * the unit is the widest of 16, 8, 4, 2 and 1 bytes that divides both
//    pools' pages and all four bases (paged_gather.gather_plan), so one
//    ragged or misaligned pool runs in the same kernel at a narrower
//    unit. A call never falls back to anything outside the kernel.
// Measured against it on an H100 and dropped (launch/time_kernels.py,
// launch/sweep_gather.py; PERF.md): persistent blocks walking a strided
// list of items with the next item's page id read ahead (at every
// decode shape one item a block, so the loop never acted; one pool
// 0.0053 against 0.0050 ms), and a TMA ring (1-D bulk copies into
// shared-memory stages with full and empty mbarriers, drained by
// consumer warps with streaming stores or by the bulk store): slower at
// every decode shape, where one or two 8 KB items a block leave the
// ring's extra hop as latency, and at the prefill shape (K and V 0.0856
// against 0.0797 ms).
// It is dtype-agnostic (it moves bytes), so its output is bit-equal to
// pool[tables] in every dtype.
//
// The dequant kernel (paged_gather_dequant_kernel). Its first version (one
// block per 512 units of one page, 16 int8 a thread) reached 35-37% of its
// bound at decode and 58% at prefill. Its compiled code (ptxas -v,
// cuobjdump -sass: launch/kernel_sass.py) showed no stack frame and no
// local memory, but (a) a 64-bit division per 16 elements (row = e / D: a
// call to the division routine, or its 32-bit fast path of ~20
// instructions) in front of (b) a dependent load of the row's scale, so a
// thread made its four scale loads one after another, each after the
// previous unit's stores; (c) stores of 2 x 16 bytes a thread, 32 bytes
// apart, so one store instruction of a warp spanned 1 KB; and (d) blocks
// that live for one chunk of one page and keep nothing in flight across
// pages. The design here, for each:
//  * persistent blocks (the launch plan in paged_gather.py gives three a
//    multiprocessor) walk a strided list of work items; an item is one
//    chunk of one page slot of one pool, and one launch may cover two
//    pools that share the table (a layer's K and V: the K items, then the
//    V items, into one output buffer, so item w writes out + w * chunk);
//  * (d) on the TMA path, warp 0 is the producer: its 32 lanes read the
//    clamped page ids of the block's next 32 items at once (the first 32
//    while warp 1 sets up the ring), and lane 0 fills a ring of stages in
//    shared memory with the TMA's 1-D bulk copy (cp.async.bulk ...
//    mbarrier::complete_tx::bytes): the chunk's int8 bytes and, in a
//    second copy, the 16-byte span of scales around its rows. Each stage
//    has a full and an empty mbarrier: the consumers wait on full, the
//    producer on empty; no __syncthreads per page. The next chunks' bytes
//    are in flight while the current one is converted, and no register
//    holds them;
//  * (b) the scales arrive with the chunk, in shared memory;
//  * (a) the row of a piece is tracked in 32-bit registers by an
//    increment fixed per thread (its first row and column, and the rows
//    and columns a stride of the thread count adds, computed once); no
//    division in the loop;
//  * (c) the consumer threads (warps 1-8) read 8 int8 (bf16 out; one
//    8-byte ld.shared) or 4 int8 (f32 out) per piece, neighbouring threads
//    on neighbouring pieces, convert with one f32 multiply each and write
//    one 16-byte store: a warp writes 512 contiguous bytes, as streaming
//    stores (st.global.cs, evict first), which on the card beat plain
//    stores at the prefill shape and tied at decode;
//  * what the TMA does not take (a base address or a row width that is
//    not a multiple of 16 bytes, scales whose rows are not a multiple of
//    4) runs in the same kernel: the vector path (pieces of 8 or 4 int8
//    read from device memory, 16-byte stores) when rows and bases allow
//    it, else the scalar path (one element a step), both with the same
//    32-bit row tracking and no producer warp. A call never falls back to
//    anything outside the kernel.
// The kernel's parameter struct is read in place (__grid_constant__) and
// its pools are picked by a select: a runtime index into an array member
// made every thread copy the 104-byte struct to local memory (ptxas: a
// 104-byte stack frame, 13 STL.64 a thread), which made the decode
// launch slower than the first version's (7.1 against 5.3 us).
// float(q) * s is one IEEE multiply (no FMA, reciprocal or reassociation)
// rounded once to the output type, so the result is bit-identical to the
// plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Path { TMA = 0, VECTOR = 1, SCALAR = 2 };
constexpr int MAX_STAGES = 8;

__device__ __forceinline__ long long page_id(const void* tables, int idx64,
                                             long long rm, long long n) {
  long long id = idx64 ? ((const long long*)tables)[rm]
                       : (long long)((const int*)tables)[rm];
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// 1-D bulk copy global -> shared (the TMA), completing on ``bar``. dst,
// src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// copy gather
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;
constexpr int UNROLL = 4;
constexpr int CHUNK = THREADS * UNROLL;           // units a block
constexpr int MAX_CHUNKS = 65535;                 // gridDim.y at most

// The kernel's one parameter, read in place (__grid_constant__); the
// pools are picked by a select, never by a runtime array index.
struct GatherArgs {
  const void* pool0;
  const void* pool1;
  void* out0;
  void* out1;
  const void* tables;
  int idx64;
  int n_pages0, n_pages1;
  int units0, units1;     // units a page of each pool
  int cpp0;               // chunks a page of pool 0: blockIdx.y below it
};

// One block: chunk y of page slot x = r * M + j, of pool 0 for y < cpp0,
// else chunk y - cpp0 of pool 1; UNROLL loads a thread issued before
// their stores.
template <typename U>
__global__ void __launch_bounds__(THREADS)
paged_gather_kernel(const __grid_constant__ GatherArgs a) {
  const int slot = blockIdx.x;
  const bool second = (int)blockIdx.y >= a.cpp0;
  const int y = second ? (int)blockIdx.y - a.cpp0 : (int)blockIdx.y;
  const int units = second ? a.units1 : a.units0;
  const long long page =
      page_id(a.tables, a.idx64, slot, second ? a.n_pages1 : a.n_pages0);
  const U* src =
      static_cast<const U*>(second ? a.pool1 : a.pool0) + page * units;
  U* dst = static_cast<U*>(second ? a.out1 : a.out0) + (long long)slot * units;
  const int base = y * CHUNK + (int)threadIdx.x;
  U buf[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = base + u * THREADS;
    if (i < units) buf[u] = __ldg(src + i);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = base + u * THREADS;
    if (i < units) dst[i] = buf[u];
  }
}

// The shared body of both entry points: checks the unit it is given
// (paged_gather.gather_plan) against the pages and bases, and launches
// once for every pool (pool 1 unused when n_pools == 1).
int gather(GatherArgs& a, int n_pools, long long rm, long long page0,
           long long page1, int unit, cudaStream_t st) {
  const uintptr_t bases = (uintptr_t)a.pool0 | (uintptr_t)a.out0 |
                          (uintptr_t)a.pool1 | (uintptr_t)a.out1;
  if (!(unit == 1 || unit == 2 || unit == 4 || unit == 8 || unit == 16) ||
      page0 % unit != 0 || page1 % unit != 0 || bases % unit != 0)
    return (int)cudaErrorInvalidValue;
  a.units0 = (int)(page0 / unit);
  a.units1 = (int)(page1 / unit);
  a.cpp0 = (a.units0 + CHUNK - 1) / CHUNK;
  const int chunks =
      a.cpp0 + (n_pools == 2 ? (a.units1 + CHUNK - 1) / CHUNK : 0);
  if (chunks > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rm, (unsigned)chunks);
  switch (unit) {
    case 16: paged_gather_kernel<uint4><<<grid, THREADS, 0, st>>>(a); break;
    case 8: paged_gather_kernel<uint2><<<grid, THREADS, 0, st>>>(a); break;
    case 4:
      paged_gather_kernel<unsigned int><<<grid, THREADS, 0, st>>>(a);
      break;
    case 2:
      paged_gather_kernel<unsigned short><<<grid, THREADS, 0, st>>>(a);
      break;
    default: paged_gather_kernel<unsigned char><<<grid, THREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dequant gather
// ---------------------------------------------------------------------------

// The kernel's one parameter, read in place (__grid_constant__): pools
// are picked by a select, never by a runtime array index, which would copy
// the struct to local memory in every thread.
struct DequantArgs {
  const int8_t* pool0;
  const int8_t* pool1;
  const float* scales0;
  const float* scales1;
  const void* tables;
  void* out;            // n_pools * RM * P * D outputs, pool-major
  int idx64, n_pools, rm, n_pages, P, D;
  int chunk_rows;       // c: rows of a chunk (c | P; 1 when rows are cut)
  int chunk_cols;       // w: columns of a chunk (w | D)
  int chunks;           // chunks a page: P * D / (c * w)
  int items;            // n_pools * rm * chunks
  int stages, stage_bytes, slot_bytes;
};

// Where work item w reads: its pool, its page slot (r * M + j), the first
// element of its chunk within the page, and the chunk's first row.
struct Item {
  int pool, slot, start, row0;
};

__device__ __forceinline__ Item item_of(const DequantArgs& a, int w) {
  const int per_pool = a.rm * a.chunks;
  Item it;
  it.pool = w >= per_pool;
  const int rem = w - it.pool * per_pool;
  it.slot = rem / a.chunks;
  const int j = rem - it.slot * a.chunks;
  it.start = j * a.chunk_rows * a.chunk_cols;
  it.row0 = it.start / a.D;
  return it;
}

__device__ __forceinline__ float s8(uint32_t word, int byte) {
  return (float)(int8_t)(word >> (8 * byte));
}

// Convert one piece of 8 int8 (bf16 out; ``q`` holds them low byte first)
// or 4 (f32 out) with one f32 multiply each, and store it with one
// 16-byte streaming store (st.global.cs) at o.
__device__ __forceinline__ void put8(__nv_bfloat16* o, uint2 q, float s) {
  __nv_bfloat162 h[4];
  h[0] = __floats2bfloat162_rn(s8(q.x, 0) * s, s8(q.x, 1) * s);
  h[1] = __floats2bfloat162_rn(s8(q.x, 2) * s, s8(q.x, 3) * s);
  h[2] = __floats2bfloat162_rn(s8(q.y, 0) * s, s8(q.y, 1) * s);
  h[3] = __floats2bfloat162_rn(s8(q.y, 2) * s, s8(q.y, 3) * s);
  uint4 v;
  v.x = *reinterpret_cast<uint32_t*>(&h[0]);
  v.y = *reinterpret_cast<uint32_t*>(&h[1]);
  v.z = *reinterpret_cast<uint32_t*>(&h[2]);
  v.w = *reinterpret_cast<uint32_t*>(&h[3]);
  __stcs(reinterpret_cast<uint4*>(o), v);
}

__device__ __forceinline__ void put4(float* o, uint32_t q, float s) {
  uint4 v;
  v.x = __float_as_uint(s8(q, 0) * s);
  v.y = __float_as_uint(s8(q, 1) * s);
  v.z = __float_as_uint(s8(q, 2) * s);
  v.w = __float_as_uint(s8(q, 3) * s);
  __stcs(reinterpret_cast<uint4*>(o), v);
}

__device__ __forceinline__ void put1(__nv_bfloat16* o, int8_t q, float s) {
  *o = __float2bfloat16_rn((float)q * s);
}
__device__ __forceinline__ void put1(float* o, int8_t q, float s) {
  *o = (float)q * s;
}

// Elements a piece of the vector paths: 8 int8 -> 8 bf16 (16 bytes), or
// 4 int8 -> 4 f32 (16 bytes).
template <typename O> struct Vec;
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<float> { static constexpr int N = 4; };

// The row of a thread's piece within its chunk, tracked without division:
// pieces k = t, t + NT, t + 2 NT, ... of a chunk with ppr pieces a row.
struct RowWalk {
  int row0, col0, drow, dcol, ppr;
  __device__ __forceinline__ RowWalk(int t, int nt, int ppr_) : ppr(ppr_) {
    row0 = t / ppr;
    col0 = t - row0 * ppr;
    drow = nt / ppr;
    dcol = nt - drow * ppr;
  }
  __device__ __forceinline__ void step(int& row, int& col) const {
    row += drow;
    col += dcol;
    if (col >= ppr) {
      col -= ppr;
      ++row;
    }
  }
};

// One chunk from a ring stage: pieces of V int8 at data, the chunk's
// scales at sc[row], outputs at dst.
template <typename O>
__device__ __forceinline__ void convert_stage(const int8_t* data,
                                              const float* sc, O* dst,
                                              int pieces, int t, int nt,
                                              const RowWalk& walk) {
  constexpr int V = Vec<O>::N;
  int row = walk.row0, col = walk.col0;
  for (int k = t; k < pieces; k += nt) {
    const float s = sc[row];
    if constexpr (V == 8)
      put8(dst + (long long)k * 8,
           *reinterpret_cast<const uint2*>(data + 8 * k), s);
    else
      put4(dst + (long long)k * 4,
           *reinterpret_cast<const uint32_t*>(data + 4 * k), s);
    walk.step(row, col);
  }
}

template <int PATH, typename O>
__global__ void paged_gather_dequant_kernel(const __grid_constant__
                                            DequantArgs a) {
  constexpr int V = PATH == SCALAR ? 1 : Vec<O>::N;
  const int chunk = a.chunk_rows * a.chunk_cols;
  const int pieces = chunk / V;
  O* out = static_cast<O*>(a.out);
  const long long page_elems = (long long)a.P * a.D;

  if constexpr (PATH == TMA) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int S = a.stages;
    unsigned char* slots = smem + S * a.stage_bytes;
    uint64_t* full = reinterpret_cast<uint64_t*>(slots + S * a.slot_bytes);
    uint64_t* empty = full + S;
    int* meta = reinterpret_cast<int*>(empty + S);   // scale offset a stage
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int consumers = blockDim.x / 32 - 1;
    // Warp 0 reads its first 32 page ids while warp 1 sets up the ring.
    int next = 0;                             // page id of item k, lane k%32
    if (warp == 0) {
      const long long wl = blockIdx.x + (long long)lane * gridDim.x;
      if (wl < a.items)
        next = (int)page_id(a.tables, a.idx64, item_of(a, (int)wl).slot,
                            a.n_pages);
    }
    if (threadIdx.x == 32) {
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], consumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {                                  // producer
      int s = 0;
      uint32_t parity = 0;
      for (int k = 0;; ++k) {
        const long long w = blockIdx.x + (long long)k * gridDim.x;
        if (w >= a.items) break;
        if ((k & 31) == 0 && k > 0) {
          const long long wl = w + (long long)lane * gridDim.x;
          if (wl < a.items)
            next = (int)page_id(a.tables, a.idx64,
                                item_of(a, (int)wl).slot, a.n_pages);
        }
        const int page = __shfl_sync(0xffffffffu, next, k & 31);
        if (k >= S) mbar_wait(&empty[s], parity ^ 1);
        if (lane == 0) {
          const Item it = item_of(a, (int)w);
          const int p = it.pool;
          const long long sidx = (long long)page * a.P + it.row0;
          const int sofs = (int)(sidx & 3);
          const int sbytes = ((sofs + a.chunk_rows) * 4 + 15) & ~15;
          meta[s] = sofs;
          mbar_expect_tx(&full[s], chunk + sbytes);
          bulk_load(smem + s * a.stage_bytes,
                    (p ? a.pool1 : a.pool0) + page * page_elems + it.start,
                    chunk,
                    &full[s]);
          bulk_load(slots + s * a.slot_bytes,
                    (p ? a.scales1 : a.scales0) + (sidx - sofs), sbytes,
                    &full[s]);
        }
        __syncwarp();
        if (++s == S) {
          s = 0;
          parity ^= 1;
        }
      }
    } else {                                          // consumers
      const int t = threadIdx.x - 32, nt = blockDim.x - 32;
      const RowWalk walk(t, nt, a.chunk_cols / V);
      int s = 0;
      uint32_t parity = 0;
      for (long long w = blockIdx.x; w < a.items; w += gridDim.x) {
        mbar_wait(&full[s], parity);
        const float* sc =
            reinterpret_cast<const float*>(slots + s * a.slot_bytes) +
            meta[s];
        convert_stage<O>(reinterpret_cast<const int8_t*>(smem +
                                                         s * a.stage_bytes),
                         sc, out + w * chunk, pieces, t, nt, walk);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == S) {
          s = 0;
          parity ^= 1;
        }
      }
    }
  } else {                                            // vector, scalar
    const int t = threadIdx.x, nt = blockDim.x;
    const RowWalk walk(t, nt, a.chunk_cols / V);
    for (long long w = blockIdx.x; w < a.items; w += gridDim.x) {
      const Item it = item_of(a, (int)w);
      const long long page = page_id(a.tables, a.idx64, it.slot, a.n_pages);
      const int8_t* src =
          (it.pool ? a.pool1 : a.pool0) + page * page_elems + it.start;
      const float* sc =
          (it.pool ? a.scales1 : a.scales0) + page * a.P + it.row0;
      O* dst = out + w * chunk;
      int row = walk.row0, col = walk.col0;
      for (int k = t; k < pieces; k += nt) {
        const float s = __ldg(sc + row);
        if constexpr (V == 8) {
          put8(dst + (long long)k * 8,
               __ldg(reinterpret_cast<const uint2*>(src) + k), s);
        } else if constexpr (V == 4) {
          put4(dst + (long long)k * 4,
               __ldg(reinterpret_cast<const unsigned int*>(src) + k), s);
        } else {
          put1(dst + k, __ldg(src + k), s);
        }
        walk.step(row, col);
      }
    }
  }
}

// Shared memory of a TMA plan: the stages, their scale slots, two
// mbarriers and one int a stage.
int tma_smem(const DequantArgs& a) {
  return a.stages * (a.stage_bytes + a.slot_bytes) + a.stages * (16 + 4);
}

template <int PATH, typename O>
int launch_dequant_as(const DequantArgs& a, int grid, int threads, int smem,
                      cudaStream_t st) {
  auto* kernel = paged_gather_dequant_kernel<PATH, O>;
  if (PATH == TMA) {
    static int allowed = 48 * 1024;       // the default dynamic limit
    if (smem > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      allowed = smem;
    }
  }
  kernel<<<grid, threads, PATH == TMA ? smem : 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename O>
int launch_dequant(const DequantArgs& a, int path, int grid, int threads,
                   int smem, cudaStream_t st) {
  if (path == TMA)
    return launch_dequant_as<TMA, O>(a, grid, threads, smem, st);
  if (path == VECTOR)
    return launch_dequant_as<VECTOR, O>(a, grid, threads, smem, st);
  return launch_dequant_as<SCALAR, O>(a, grid, threads, smem, st);
}

// The shared body of both entry points: checks the plan it is given
// (paged_gather.dequant_plan) against what the kernel relies on, then
// launches once for every pool.
int dequant(DequantArgs& a, int out_bf16, int path, int grid, int threads,
            int smem, cudaStream_t st) {
  if (a.items <= 0) return 0;
  const int V = path == SCALAR ? 1 : (out_bf16 ? 8 : 4);
  const bool shape_ok =
      a.chunk_rows > 0 && a.chunk_cols > 0 && a.P % a.chunk_rows == 0 &&
      a.D % a.chunk_cols == 0 && (a.chunk_rows == 1 || a.chunk_cols == a.D) &&
      a.chunk_cols % V == 0 && grid > 0 && threads % 32 == 0 &&
      (long long)a.n_pools * a.rm * a.chunks == a.items &&
      (long long)a.chunks * a.chunk_rows * a.chunk_cols ==
          (long long)a.P * a.D;
  if (!shape_ok || path < TMA || path > SCALAR)
    return (int)cudaErrorInvalidValue;
  if (path == TMA &&
      (a.stages < 1 || a.stages > MAX_STAGES || threads < 64 ||
       a.stage_bytes < a.chunk_rows * a.chunk_cols ||
       a.stage_bytes % 16 != 0 || a.chunk_cols % 16 != 0 ||
       a.slot_bytes < ((a.chunk_rows + 3) * 4 + 15) / 16 * 16 ||
       a.slot_bytes % 16 != 0 || smem < tma_smem(a)))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return launch_dequant<__nv_bfloat16>(a, path, grid, threads, smem, st);
  return launch_dequant<float>(a, path, grid, threads, smem, st);
}

DequantArgs dequant_args(const void* tables, int idx64, void* out,
                         long long RM, long long N, int P, int D, int n_pools,
                         int chunk_rows, int chunk_cols, int stages,
                         int stage_bytes, int slot_bytes) {
  DequantArgs a = {};
  a.tables = tables;
  a.out = out;
  a.idx64 = idx64;
  a.n_pools = n_pools;
  a.rm = (int)RM;
  a.n_pages = (int)N;
  a.P = P;
  a.D = D;
  a.chunk_rows = chunk_rows;
  a.chunk_cols = chunk_cols;
  a.chunks = chunk_rows > 0 && chunk_cols > 0
                 ? (int)((long long)P * D / ((long long)chunk_rows *
                                             chunk_cols))
                 : 0;
  a.items = (int)(n_pools * RM * a.chunks);
  a.stages = stages;
  a.stage_bytes = stage_bytes;
  a.slot_bytes = slot_bytes;
  return a;
}

}  // namespace

// The copy gather. unit: the bytes a thread moves at once (16, 8, 4, 2 or
// 1), from paged_gather.gather_plan; it must divide every page and base.
// tables: RM = R * M page ids, int32 (idx64 = 0) or int64 (idx64 = 1).
// All device pointers; pools and outputs are not aliased. Returns the
// cudaError_t of the launch (0 = cudaSuccess).

// pool: N pages of page_bytes contiguous bytes each; out: RM pages.
extern "C" int paged_gather(const void* pool, const void* tables, int idx64,
                            void* out, long long RM, long long N,
                            long long page_bytes, int unit, void* stream) {
  if (RM <= 0 || page_bytes <= 0) return 0;
  if (page_bytes >= (1LL << 30) || N >= (1LL << 31) || RM >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  GatherArgs a = {};
  a.pool0 = a.pool1 = pool;
  a.out0 = a.out1 = out;
  a.tables = tables;
  a.idx64 = idx64;
  a.n_pages0 = a.n_pages1 = (int)N;
  return gather(a, 1, RM, page_bytes, page_bytes, unit,
                (cudaStream_t)stream);
}

// Two pools through one table in one launch (a layer's K and V, or MLA's
// c and kpe): pool_a of N_a pages of page_a bytes into out_a, pool_b of
// N_b pages of page_b bytes into out_b, RM pages each.
extern "C" int paged_gather_kv(const void* pool_a, const void* pool_b,
                               const void* tables, int idx64, void* out_a,
                               void* out_b, long long RM, long long N_a,
                               long long N_b, long long page_a,
                               long long page_b, int unit, void* stream) {
  if (RM <= 0) return 0;
  if (page_a <= 0 || page_b <= 0 || page_a >= (1LL << 30) ||
      page_b >= (1LL << 30) || N_a >= (1LL << 31) || N_b >= (1LL << 31) ||
      RM >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  GatherArgs a = {};
  a.pool0 = pool_a;
  a.pool1 = pool_b;
  a.out0 = out_a;
  a.out1 = out_b;
  a.tables = tables;
  a.idx64 = idx64;
  a.n_pages0 = (int)N_a;
  a.n_pages1 = (int)N_b;
  return gather(a, 2, RM, page_a, page_b, unit, (cudaStream_t)stream);
}

// pool (N, P, D) int8, scales (N, P, 1) f32, tables as above, out (RM, P, D)
// in bf16 (out_bf16 = 1) or f32 (out_bf16 = 0). The launch plan (path 0 =
// TMA, 1 = vector, 2 = scalar; chunk_rows x chunk_cols elements a work
// item; the TMA ring's stages, stage_bytes and slot_bytes; grid, threads
// and dynamic shared memory) comes from paged_gather.dequant_plan.
extern "C" int paged_gather_dequant(const int8_t* pool, const float* scales,
                                    const void* tables, int idx64, void* out,
                                    int out_bf16, long long RM, long long N,
                                    int P, int D, int path, int chunk_rows,
                                    int chunk_cols, int stages,
                                    int stage_bytes, int slot_bytes, int grid,
                                    int threads, int smem, void* stream) {
  if (RM <= 0 || (long long)P * D <= 0) return 0;
  DequantArgs a = dequant_args(tables, idx64, out, RM, N, P, D, 1,
                               chunk_rows, chunk_cols, stages, stage_bytes,
                               slot_bytes);
  a.pool0 = a.pool1 = pool;
  a.scales0 = a.scales1 = scales;
  return dequant(a, out_bf16, path, grid, threads, smem,
                 (cudaStream_t)stream);
}

// A layer's K and V in one launch: two pools of one shape (N, P, D) int8
// with their scales, one table; out holds 2 * RM pages, K's then V's.
extern "C" int paged_gather_dequant_kv(
    const int8_t* k_pool, const float* k_scales, const int8_t* v_pool,
    const float* v_scales, const void* tables, int idx64, void* out,
    int out_bf16, long long RM, long long N, int P, int D, int path,
    int chunk_rows, int chunk_cols, int stages, int stage_bytes,
    int slot_bytes, int grid, int threads, int smem, void* stream) {
  if (RM <= 0 || (long long)P * D <= 0) return 0;
  DequantArgs a = dequant_args(tables, idx64, out, RM, N, P, D, 2,
                               chunk_rows, chunk_cols, stages, stage_bytes,
                               slot_bytes);
  a.pool0 = k_pool;
  a.scales0 = k_scales;
  a.pool1 = v_pool;
  a.scales1 = v_scales;
  return dequant(a, out_bf16, path, grid, threads, smem,
                 (cudaStream_t)stream);
}
