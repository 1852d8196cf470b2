// IVF shortlist rescore for Hopper (sm_90a), inverted probe table.
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/ivf_pallas.py
// `_rescore_kernel` (launched by `ivf_rescore`, dispatched through
// `rescore_shortlist`):
//
//   out[b, j, m] = dot(q[b, :], slabs[probe[b, j], m, :]) + bias[probe[b, j], m]
//
// probe [B, P] int32, q [B, d] f32, slabs [C, M, d] f32 or bf16,
// bias [C, M] f32 (0 live, -inf pad/removed) -> out [B, P, M] f32, with
// f32 accumulation.  Any B, P, C, M and d (d up to ~1,300: the queries of
// one pass are staged whole in shared memory).
//
// Bound: memory.  The B*P (query, probe) pairs of a serve batch name far
// fewer distinct clusters (64 queries x 69 probes -> ~380 clusters over a
// 1M x 384 index), so the least traffic is each probed slab read ONCE:
// 0.154 GB, 0.046 ms at 3.35 TB/s.  The products are 0.87 GFLOP, 0.013 ms
// at the 67 TFLOP/s f32 rate.
//
// Design: two kernels behind one C entry point, no host sync.
//
// 1. `invert_probe_kernel` (one block): a counting sort of the B*P probe
//    ids over the C clusters (counters in shared memory when they fit)
//    gives the distinct probed clusters in ascending id order, their
//    offsets, the (b, j) pairs grouped by cluster, and the distinct count,
//    all in device memory.
// 2. `rescore_kernel`: persistent blocks (as many as fit on the card) take
//    work items (probed cluster, tile of 128 slab rows) round-robin until
//    the distinct count is used up.  Each slab tile leaves device memory
//    once, in 128-byte-wide column chunks (16 KB), through a 3-stage
//    shared-memory ring that runs on across work items: TMA
//    (`cp.async.bulk.tensor`, 128-byte swizzle, completion on an
//    `mbarrier`) when the slab rows are 16-byte aligned, else `cp.async`
//    (f32) or plain loads (bf16) into the same swizzled layout.  Thread 0
//    refills a slot as soon as every warp is done with it.  The queries
//    that probe the cluster (32 per pass, more passes past that) are
//    gathered into shared memory, and the products take one of two paths:
//    - f32 slabs: FFMA on the CUDA cores.  Each warp owns 4 queries and
//      each lane 4 slab rows: a slab vector read from shared memory feeds
//      4 FMAs, a query vector (a broadcast) feeds 4 rows.
//    - bf16 slabs: `wgmma` m64n32k16 on the tensor cores, each warpgroup
//      64 slab rows (A, straight from the swizzled stage) against the 32
//      query slots (B).  Each query is split into bf16 hi + lo, so it
//      keeps ~16 significant bits (the slab is exact); both products
//      accumulate in f32.
//    The epilogue adds the bias and writes rows of out[b, j, :].
//
// What limits the f32 path on the H100 is the FFMA loop's shared-memory
// traffic and the per-item query gather rather than device-memory
// bandwidth: a 64-row tile with 2 rows per lane (more loads per FMA) was
// slower, and the slabs alone stream close to the card's rate.  3xTF32 on
// the tensor cores (each f32 split into two tf32 halves; `mma.sync`, and
// `wgmma` with the slab fragment split in registers) was tried and was
// slower than FFMA.
//
// Each output element is one chain of FMAs (or of wgmma steps) over d in
// a fixed order, so the (run-dependent) order of the pairs within a
// cluster does not change any bit of the output: two launches give
// bitwise-equal results.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 128;         // slab rows per work item (4 per lane)
constexpr int kRowBytes = 128;   // bytes of a slab row per ring stage: the swizzle span
constexpr int kStageBytes = kTM * kRowBytes;
constexpr int kStages = 3;
constexpr int kBarSlots = (kStages + 1) / 2 * 2;  // mbarriers, padded to 16 bytes
constexpr int kQW = 4;             // queries per warp
constexpr int kR = kTM / 32;      // slab rows per lane
constexpr int kQP = kWarps * kQW;  // queries per pass
static_assert(kTM == 64 * (kThreads / 128), "wgmma: one 64-row slab sub-tile per warpgroup");
static_assert(kQP == 32, "wgmma m64n32k16: one query slot per column of B");
constexpr int kInvThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kInvSmemMax = 96 * 1024;  // shared counters up to C = 24,576

struct Scratch {
  int* cl_ids;  // [n_max] distinct probed clusters
  int* cl_off;  // [n_max + 1] pair offsets per distinct cluster
  int* pairs;   // [B * P] flat (b * P + j), grouped by cluster
  int* meta;    // [0] distinct count
  int* counts;  // [C] counters when they do not fit in shared memory
};

__host__ __device__ inline long long scratch_ints(long long BP, long long C, Scratch* s, int* base) {
  const long long n_max = BP < C ? BP : C;
  const bool global_counts = C * 4 > kInvSmemMax;
  if (s != nullptr) {
    s->cl_ids = base;
    s->cl_off = base + n_max;
    s->pairs = s->cl_off + n_max + 1;
    s->meta = s->pairs + BP;
    s->counts = global_counts ? s->meta + 1 : nullptr;
  }
  return n_max + (n_max + 1) + BP + 1 + (global_counts ? C : 0);
}

__device__ __forceinline__ int clamp_id(int c, int C) { return c < 0 ? 0 : (c >= C ? C - 1 : c); }

// exclusive scan of (pairs, distinct) over the 1024 threads of a block
__device__ int2 block_exclusive_scan(int2 v) {
  __shared__ int2 warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yx = __shfl_up_sync(0xffffffffu, x.x, o);
    const int yy = __shfl_up_sync(0xffffffffu, x.y, o);
    if (lane >= o) {
      x.x += yx;
      x.y += yy;
    }
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int2 t = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int yx = __shfl_up_sync(0xffffffffu, t.x, o);
      const int yy = __shfl_up_sync(0xffffffffu, t.y, o);
      if (lane >= o) {
        t.x += yx;
        t.y += yy;
      }
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int2 pre = warp ? warp_tot[warp - 1] : make_int2(0, 0);
  return make_int2(pre.x + x.x - v.x, pre.y + x.y - v.y);
}

__global__ void __launch_bounds__(kInvThreads)
invert_probe_kernel(const int32_t* __restrict__ probe, int BP, int C, Scratch s) {
  extern __shared__ int inv_smem[];
  int* cnt = s.counts != nullptr ? s.counts : inv_smem;
  const int tid = threadIdx.x;
  for (int i = tid; i < C; i += kInvThreads) cnt[i] = 0;
  __syncthreads();
  // the first kCached ids of each thread stay in registers for the scatter
  constexpr int kCached = 8;
  int ids[kCached];
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int i = tid + j * kInvThreads;
    ids[j] = i < BP ? clamp_id(probe[i], C) : -1;
  }
#pragma unroll
  for (int j = 0; j < kCached; ++j)
    if (ids[j] >= 0) atomicAdd(&cnt[ids[j]], 1);
  for (int i = tid + kCached * kInvThreads; i < BP; i += kInvThreads) atomicAdd(&cnt[clamp_id(probe[i], C)], 1);
  __syncthreads();
  const int per = (C + kInvThreads - 1) / kInvThreads;
  const int lo = min(C, tid * per), hi = min(C, lo + per);
  int2 local = make_int2(0, 0);
  for (int c = lo; c < hi; ++c) {
    const int v = cnt[c];
    local.x += v;
    local.y += v > 0;
  }
  const int2 start = block_exclusive_scan(local);
  int po = start.x, di = start.y;
  for (int c = lo; c < hi; ++c) {
    const int v = cnt[c];
    if (v) {
      s.cl_ids[di] = c;
      s.cl_off[di] = po;
      cnt[c] = po;  // from here on: the cluster's fill cursor
      ++di;
      po += v;
    }
  }
  if (tid == kInvThreads - 1) {
    s.cl_off[di] = po;  // po == BP
    s.meta[0] = di;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCached; ++j)
    if (ids[j] >= 0) s.pairs[atomicAdd(&cnt[ids[j]], 1)] = tid + j * kInvThreads;
  for (int i = tid + kCached * kInvThreads; i < BP; i += kInvThreads)
    s.pairs[atomicAdd(&cnt[clamp_id(probe[i], C)], 1)] = i;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// byte offset of (row r, byte b of the row's 128-byte chunk) in a stage
// laid out as TMA's 128-byte swizzle writes it: the 16-byte unit index is
// XORed with r % 8, so 8 lanes reading one unit of 8 rows hit 8 banks
__device__ __forceinline__ int swz(int r, int b) {
  return r * kRowBytes + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

__device__ __forceinline__ void fma4(float& acc, const float4 a, const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// one ring stage (kTM rows x 128 bytes) against the warp's kQW queries:
// lane rows r[i], `qrow` = the chunk's first element of the warp's first
// query, query rows `qstride` apart
__device__ __forceinline__ void stage_fma(const unsigned char* st, const float* qrow, int qstride, const int (&r)[kR],
                                          float (&acc)[kR][kQW]) {
#pragma unroll
  for (int u = 0; u < kRowBytes / 16; ++u) {
    float4 a[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) a[i] = *reinterpret_cast<const float4*>(st + swz(r[i], u * 16));
#pragma unroll
    for (int qq = 0; qq < kQW; ++qq) {
      const float4 b = *reinterpret_cast<const float4*>(qrow + qq * qstride + u * 4);
#pragma unroll
      for (int i = 0; i < kR; ++i) fma4(acc[i][qq], a[i], b);
    }
  }
}

// bf16 slabs go through the tensor cores: wgmma m64n32k16, the slab
// tile as A (64 rows a warpgroup, K-major, 128-byte swizzle as TMA wrote
// it) and the pass's 32 query slots as B, each query split into two bf16
// halves q = hi + lo (about 16 significant bits, the slab exact), both
// products accumulated in f32.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  // start address, leading offset 16 B (unused when swizzled), stride 1024 B
  // between 8-row groups, 128-byte swizzle
  return ((a & 0x3FFFF) >> 4) | (uint64_t{1} << 16) | (uint64_t{64} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one ring stage: this warpgroup's 64 slab rows x 64 bf16 against the 32
// query slots' hi and lo blocks of the same 64 columns
__device__ __forceinline__ void stage_wgmma(const unsigned char* st, const unsigned char* qhi,
                                            const unsigned char* qlo, float (&d)[16]) {
  const uint64_t a = sw128_desc(st), bh = sw128_desc(qhi), bl = sw128_desc(qlo);
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kRowBytes / 32; ++kk) {  // K = 16 bf16 = 32 bytes a step
    wgmma_m64n32k16(d, a + 2 * kk, bh + 2 * kk);
    wgmma_m64n32k16(d, a + 2 * kk, bl + 2 * kk);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ inline int query_floats(int d, int kc) { return ((d + kc - 1) / kc) * kc; }

__host__ __device__ inline int rescore_smem_bytes(int dq) {
  // 1024 bytes of slack align the ring to the swizzle's 1024-byte period
  return 1024 + kStages * kStageBytes + kQP * dq * 4 + kQP * 4 + kBarSlots * 8 + 16;
}

template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
rescore_kernel(__grid_constant__ const CUtensorMap tmap, const T* __restrict__ slabs,
               const float* __restrict__ q, const float* __restrict__ bias, Scratch s,
               float* __restrict__ out, int P, int M, int d, int n_tiles) {
  constexpr int kKC = kRowBytes / static_cast<int>(sizeof(T));  // slab elements per chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n_chunks = (d + kKC - 1) / kKC;
  const int dq = n_chunks * kKC;
  float* qs = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  int* pair_s = reinterpret_cast<int*>(qs + kQP * dq);
  uint64_t* bars = reinterpret_cast<uint64_t*>(pair_s + kQP);
  int4* plan_s = reinterpret_cast<int4*>(bars + kBarSlots);  // generic path: (stage, c, m0, k)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's slab rows in the tile: lane + 32 i for the FFMA loop;
  // for wgmma (bf16) the accumulator rows of its warp in its warpgroup
  constexpr bool kWg = sizeof(T) == 2;
  constexpr int kBR = kWg ? 2 : kR;
  int r[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) r[i] = kWg ? (warp / 4) * 64 + (warp % 4) * 16 + lane / 4 + 8 * i : lane + 32 * i;
  const int n_work = s.meta[0] * n_tiles;

  // Work items go round-robin over the blocks: block b takes b, b + grid,
  // ...  Every thread can name its block's next item, so the loads that
  // describe it are started a whole item ahead of their use.
  auto load_desc = [&](int w, int& c, int& b, int& e) {
    if (w < n_work) {
      const int ci = w / n_tiles;
      c = s.cl_ids[ci];
      b = s.cl_off[ci];
      e = s.cl_off[ci + 1];
    }
  };

  // producer state, thread 0 only: the next ring item to load is item
  // p_item of work p_w (p_total items), into ring slot p_g
  int p_w = blockIdx.x, p_item = 0, p_total = 0, p_c = 0, p_m0 = 0;
  int pf_c = 0, pf_b = 0, pf_e = 0;  // work p_w + grid, loads in flight
  uint32_t p_g = 0;
  auto start_work = [&](int c, int b, int e) {
    p_c = c;
    p_m0 = (p_w % n_tiles) * kTM;
    p_total = p_w < n_work ? ((e - b + kQP - 1) / kQP) * n_chunks : 0;
    p_item = 0;
  };
  // thread 0: start the next ring load, if any work is left.  The slot
  // it fills was released by the __syncthreads() before the call.
  auto produce = [&]() {
    if (p_total == 0) return;
    const int k = p_item % n_chunks;
    const int stage = p_g % kStages;
    if constexpr (kTma) {
      mbar_expect_tx(&bars[stage], kStageBytes);
      tma_load_3d(ring + stage * kStageBytes, &tmap, &bars[stage], k * kKC, p_m0, p_c);
    } else {
      *plan_s = make_int4(stage, p_c, p_m0, k);
    }
    ++p_g;
    if (++p_item == p_total) {
      p_w += gridDim.x;
      start_work(pf_c, pf_b, pf_e);
      load_desc(p_w + gridDim.x, pf_c, pf_b, pf_e);
    }
  };
  // generic path: every thread loads the slot thread 0 planned
  auto load_generic = [&]() {
    const int4 is = *plan_s;
    if (is.x >= 0) {
      unsigned char* st = ring + is.x * kStageBytes;
      const T* slab = slabs + static_cast<long long>(is.y) * M * d;
      for (int e = tid; e < kTM * kKC; e += kThreads) {
        const int rr = e / kKC, ec = e - rr * kKC, col = is.w * kKC + ec;
        const bool valid = is.z + rr < M && col < d;
        const T* src = slab + static_cast<long long>(is.z + rr) * d + col;
        void* dst = st + swz(rr, ec * static_cast<int>(sizeof(T)));
        if constexpr (sizeof(T) == 4) {
          cp_async4(dst, valid ? src : slabs, valid);
        } else {
          *reinterpret_cast<T*>(dst) = valid ? *src : __float2bfloat16(0.f);
        }
      }
      if constexpr (sizeof(T) == 2) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // wgmma reads them
    }
    cp_async_commit();
  };
  auto step_producer = [&]() {
    if constexpr (kTma) {
      if (tid == 0) produce();
    } else {
      if (tid == 0) {
        *plan_s = make_int4(-1, 0, 0, 0);
        produce();
      }
      __syncthreads();
      load_generic();
      __syncthreads();  // plan_s is rewritten by the next step
    }
  };

  if (tid == 0) {
    if (kTma) {
      for (int i = 0; i < kStages; ++i) mbar_init(&bars[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    int c0 = 0, b0 = 0, e0 = 0;
    load_desc(p_w, c0, b0, e0);
    start_work(c0, b0, e0);
    load_desc(p_w + gridDim.x, pf_c, pf_b, pf_e);
  }
  __syncthreads();
  for (int i = 0; i < kStages; ++i) step_producer();

  // consumer prefetch, every thread: the next work's cluster and pair
  // range, then its first pair ids and this lane's bias values
  int n_c = 0, n_b = 0, n_e = 0, n_pair = 0;
  float n_bias[kR];
  auto load_detail = [&](int w) {
    if (w < n_work) {
      const int m0 = (w % n_tiles) * kTM;
      n_pair = tid < min(kQP, n_e - n_b) ? s.pairs[n_b + tid] : 0;
#pragma unroll
      for (int i = 0; i < kBR; ++i) n_bias[i] = m0 + r[i] < M ? bias[static_cast<long long>(n_c) * M + m0 + r[i]] : 0.f;
    }
  };
  load_desc(blockIdx.x, n_c, n_b, n_e);
  load_detail(blockIdx.x);

  const bool qvec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  uint32_t ring_i = 0;  // ring items consumed: slot ring_i % kStages, parity (ring_i / kStages) & 1
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int beg = n_b, nq_all = n_e - n_b, m0 = (w % n_tiles) * kTM, pair0 = n_pair;
    float bv[kR];
#pragma unroll
    for (int i = 0; i < kBR; ++i) bv[i] = n_bias[i];
    const int w_next = w + gridDim.x;
    load_desc(w_next, n_c, n_b, n_e);
    bool detail_due = true;
    const int n_pass = (nq_all + kQP - 1) / kQP;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int nq = min(kQP, nq_all - pass * kQP);
      __syncthreads();  // the previous pass is done with pair_s and qs
      if (tid < kQP) pair_s[tid] = pass == 0 ? pair0 : (tid < nq ? s.pairs[beg + pass * kQP + tid] : 0);
      __syncthreads();
      // the pass's queries, zero past d and in the pad slots of a warp
      const int nq_pad = (nq + kQW - 1) / kQW * kQW;
      if constexpr (kWg) {
        // 32 slots of hi and lo bf16, one 32 x 128-byte block per chunk,
        // swizzled as the slab tile is
        unsigned char* qb = reinterpret_cast<unsigned char*>(qs);
        const int units = dq / 8;  // 16-byte units of a row
        for (int i = tid; i < kQP * units; i += kThreads) {
          const int slot = i / units, u = i - slot * units;
          const float* src = q + static_cast<long long>(slot < nq ? pair_s[slot] / P : 0) * d;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = slot < nq && 8 * u + j < d ? src[8 * u + j] : 0.f;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hi[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[j]);
            const float2 hf = __bfloat1622float2(h);
            lo[j] = pack_bf16(v[2 * j] - hf.x, v[2 * j + 1] - hf.y);
          }
          const int off = (u / 8) * kQP * kRowBytes + slot * kRowBytes + (((u % 8) ^ (slot & 7)) << 4);
          *reinterpret_cast<uint4*>(qb + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(qb + n_chunks * kQP * kRowBytes + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // wgmma reads them
      } else if (qvec) {
        const int d4 = d / 4, dq4 = dq / 4;
        for (int i = tid; i < nq_pad * dq4; i += kThreads) {
          const int slot = i / dq4, e4 = i - slot * dq4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (slot < nq && e4 < d4)
            v = __ldg(reinterpret_cast<const float4*>(q + static_cast<long long>(pair_s[slot] / P) * d) + e4);
          reinterpret_cast<float4*>(qs)[i] = v;
        }
      } else {
        for (int i = tid; i < nq_pad * dq; i += kThreads) {
          const int slot = i / dq, e = i - slot * dq;
          qs[i] = slot < nq && e < d ? q[static_cast<long long>(pair_s[slot] / P) * d + e] : 0.f;
        }
      }
      __syncthreads();

      float acc[kR][kQW];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) acc[i][qq] = 0.f;
      float dacc[16];  // the wgmma accumulator (bf16 slabs)
#pragma unroll
      for (int i = 0; i < 16; ++i) dacc[i] = 0.f;
      const bool active = kWg || warp * kQW < nq;
      for (int k = 0; k < n_chunks; ++k, ++ring_i) {
        const int stage = ring_i % kStages;
        if constexpr (kTma) {
          mbar_wait(&bars[stage], (ring_i / kStages) & 1);
        } else {
          cp_async_wait<kStages - 1>();
          __syncthreads();
        }
        if constexpr (kWg) {
          const unsigned char* qb = reinterpret_cast<const unsigned char*>(qs) + k * kQP * kRowBytes;
          stage_wgmma(ring + stage * kStageBytes + (warp / 4) * 64 * kRowBytes, qb,
                      qb + n_chunks * kQP * kRowBytes, dacc);
        } else if (active) {
          stage_fma(ring + stage * kStageBytes, qs + warp * kQW * dq + k * kKC, dq, r, acc);
        }
        if (detail_due) {  // the next work's first loads have landed by now
          load_detail(w_next);
          detail_due = false;
        }
        __syncthreads();  // every warp is done with this slot: refill it
        step_producer();
      }
      if constexpr (kWg) {
        // accumulator i: row r[(i / 2) % 2], query slot 8 (i / 4) + 2 (lane % 4) + i % 2
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int slot = (i / 4) * 8 + (lane % 4) * 2 + (i % 2), h = (i / 2) % 2;
          if (slot < nq && m0 + r[h] < M) out[static_cast<long long>(pair_s[slot]) * M + m0 + r[h]] = dacc[i] + bv[h];
        }
      } else if (active) {
#pragma unroll
        for (int qq = 0; qq < kQW; ++qq) {
          const int slot = warp * kQW + qq;
          if (slot < nq) {
            float* o = out + static_cast<long long>(pair_s[slot]) * M + m0;
#pragma unroll
            for (int i = 0; i < kR; ++i)
              if (m0 + r[i] < M) o[r[i]] = acc[i][qq] + bv[i];
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, looked up at run time: no
// link against libcuda, whatever the toolkit version
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

template <typename T>
cudaError_t launch(const int32_t* probe, const float* q, const T* slabs, const float* bias, float* out,
                   int* scratch, int B, int P, int C, int M, int d, int sms, cudaStream_t stream) {
  constexpr int kKC = kRowBytes / static_cast<int>(sizeof(T));
  const long long BP = static_cast<long long>(B) * P;
  Scratch s;
  scratch_ints(BP, C, &s, scratch);
  const int inv_smem = s.counts != nullptr ? 0 : C * 4;
  if (inv_smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(invert_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, inv_smem);
    if (e != cudaSuccess) return e;
  }
  invert_probe_kernel<<<1, kInvThreads, inv_smem, stream>>>(probe, static_cast<int>(BP), C, s);

  const int dq = query_floats(d, kKC);
  const int smem = rescore_smem_bytes(dq);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // d too wide for one query pass
  const bool tma = (static_cast<long long>(d) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(slabs) % 16 == 0;
  CUtensorMap map = {};
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(M),
                                static_cast<cuuint64_t>(C)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * sizeof(T),
                                   static_cast<cuuint64_t>(M) * d * sizeof(T)};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(kKC), static_cast<cuuint32_t>(kTM), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        &map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
        const_cast<T*>(slabs), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  auto kernel = tma ? rescore_kernel<T, true> : rescore_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (M + kTM - 1) / kTM;
  const long long n_max = BP < C ? BP : C;
  const long long want = n_max * n_tiles;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  kernel<<<grid, kThreads, smem, stream>>>(map, slabs, q, bias, s, out, P, M, d, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// int32 scratch the caller allocates for one call
extern "C" long long pw_ivf_rescore_scratch_ints(int B, int P, int C) {
  return scratch_ints(static_cast<long long>(B) * P, C, nullptr, nullptr);
}

// slab_dtype: 0 = f32, 1 = bf16.  Launches the probe inversion and the
// rescore on `stream`; returns the cudaError_t of the launches.
extern "C" int pw_ivf_rescore(const void* probe, const void* q, const void* slabs, const void* bias, void* out,
                              void* scratch, int B, int P, int C, int M, int d, int slab_dtype, int sms,
                              void* stream) {
  if (B <= 0 || P <= 0 || M <= 0 || C <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const int32_t*>(probe);
  auto* qq = static_cast<const float*>(q);
  auto* bb = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  auto* sc = static_cast<int*>(scratch);
  const cudaError_t err =
      slab_dtype == 1
          ? launch(p, qq, static_cast<const __nv_bfloat16*>(slabs), bb, o, sc, B, P, C, M, d, sms, st)
          : launch(p, qq, static_cast<const float*>(slabs), bb, o, sc, B, P, C, M, d, sms, st);
  return static_cast<int>(err);
}

extern "C" const char* pw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
