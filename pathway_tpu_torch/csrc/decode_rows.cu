// Row-invariant LayerNorm (plain, and fused with the residual add before
// it) and tied readout of the generator decode path, for Hopper (sm_90a).
// Port-side kernels: they replace no Pallas kernel.  In the JAX package
// all three are XLA ops of the generator (pathway_tpu/models/transformer.py
// `nn.LayerNorm` and the residual adds of the KV / slot twins, and the
// readout einsum of pathway_tpu/models/generator.py).
//
// Why they exist: the decode path's invariants (a request decoded in the
// 16-slot pool emits exactly the tokens of the same request decoded alone,
// spec-on == spec-off, warm == cold) need each row's result to be the same
// bits whatever the number of rows beside it.  On the H100, torch's f32
// matmul picks another algorithm from 16 rows up (the readout of one row
// changed in 29,724 of 32,768 logits between M = 1 and M = 16), and its
// row-mean reduction another order (one row's mean moved an ulp); the
// bf16 Dense products and the attention did not move.  Here every output
// element is one fixed chain of operations that depends on its own row
// only, so the invariance holds by construction.
//
// layer_norm_rows: y = (x - mean) * (rsqrt(var + eps) * w) + b per row of
// width d, statistics in f32 with the fast variance E[x^2] - E[x]^2
// clipped at 0 (Flax's LayerNorm).  One warp per row: each lane sums its
// strided elements i = lane, lane + 32, ... in order, then a fixed xor
// butterfly; mean, variance and __frsqrt_rn as in `ln_stats`.  Bound:
// bytes (one read of x, one write of y), far below the launch floor at a
// decode step's 16 rows.
//
// add_layer_norm_rows: s = x + delta, rounded to x's type as torch's add
// rounds (f32 sum, round to nearest even), and y = layer_norm_rows(s), in
// one launch.  The warp keeps its row of s in registers (8 values a lane
// at d = 256; wider rows re-read the lane's own stores), and the statistics
// are the same chain (`ln_stats`, `ln_out`), so y is bit for bit
// layer_norm_rows(x + delta).  It replaces the separate add and its launch
// at every LayerNorm of a decode forward (2 per layer + 1).  Bound: bytes
// (x and delta read once, s and y written once).
//
// tied_readout: logits[m, v] = sum_k float(h[m, k]) * E[v, k] in f32 (the
// weight-tied readout over the f32 embedding table E [V, d]).  Fixed
// chain: acc = 0, then acc = fmaf(h[m, k], E[v, k], acc) for k = 0, 1,
// ..., d - 1 in order (pad columns past d, where d % 4 != 0, add
// fmaf(0, 0, acc) = acc).  Nothing of it depends on M, on the row's place
// in its block or on the tile sizes, and no tensor core or TF32 rounds an
// operand.
//   Bound: at a decode step (M = 16, d = 256, V = 32,768) the bytes of the
//   32 MB table (plus 2 MB of logits), 0.0106 ms at 3.35 TB/s; at a verify
//   (M = 256) the operations, 4.29 GFLOP, 0.064 ms at the 67 TFLOP/s f32
//   rate.
//   Design: each tile of the table leaves device memory ONCE per call,
//   whatever M is, copied into shared memory with `cp.async` (16 bytes a
//   thread where rows are 16-byte aligned) through a ring of stages, so
//   the next copies run under this tile's FMAs.  Persistent blocks, one
//   per SM, walk tiles b, b + grid, ... .  Two kernels, one chain:
//   - M <= 32 (a decode step, the 32-slot int8 pool's step): all rows of
//     h are staged once as f32; vocab tiles of 256 rows stream through a
//     4-stage ring in chunks of 32 columns, the accumulators running on
//     across the chunks of a tile (one group of rows: no chunk is needed
//     twice).
//   - M > 32 (verify, prefill): vocab tiles of 64 rows (32 when d is
//     wide) stay resident, whole rows, in a ring of up to 3 stages while
//     the block loops over groups of BM rows of h (staged as f32, in
//     chunks of columns when d is wide): more rows cost FMAs and L2 reads
//     of h, not table re-reads.
//   Lanes are 4 along rows x 8 along vocab: a lane owns RM rows (tm + 4a)
//   and 4 vocab rows (tv + 8j).  Per 4 k, RM float4 loads of h (one address
//   per quarter-warp: the cheap kind of shared-memory load) and 4 float4
//   loads of E (8 rows per quarter-warp: the dear kind) feed 16 RM FMAs;
//   RM = 8 (4 at M <= 16) balances the loads against the FMA issue.  Staged
//   row strides are an odd number of 16-byte units, so the 8 rows a
//   quarter-warp reads at one column fall in 8 different bank groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;     // dynamic shared memory a block may use on sm_90
constexpr int kLnCache = 8;          // row values a lane keeps in registers (d <= 256)
constexpr int kRV = 4;               // vocab rows a lane owns in the readout kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The statistics chain shared by both LayerNorm kernels: lane-strided
// sums s, ss (accumulated by the caller in i order), the xor butterfly,
// the fast variance clipped at 0, and the correctly rounded rsqrt.
__device__ __forceinline__ void ln_stats(float s, float ss, int d, float eps, float* mean, float* r) {
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float m = s / static_cast<float>(d);
  const float var = fmaxf(ss / static_cast<float>(d) - m * m, 0.f);
  *mean = m;
  *r = __frsqrt_rn(var + eps);
}

__device__ __forceinline__ float ln_out(float v, float mean, float r, float w, float b) {
  return (v - mean) * (r * w) + b;
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) layer_norm_rows_kernel(const Tin* __restrict__ x,
                                                                   const float* __restrict__ w,
                                                                   const float* __restrict__ b,
                                                                   Tout* __restrict__ y, int rows, int d,
                                                                   float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const Tin* xr = x + static_cast<size_t>(row) * d;
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    s += v;
    ss += v * v;
  }
  float mean, r;
  ln_stats(s, ss, d, eps, &mean, &r);
  Tout* yr = y + static_cast<size_t>(row) * d;
  for (int i = lane; i < d; i += 32) yr[i] = from_f<Tout>(ln_out(to_f(xr[i]), mean, r, w[i], b[i]));
}

template <typename T, typename Tout>
__global__ void __launch_bounds__(kThreads) add_layer_norm_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ delta, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ sum, Tout* __restrict__ y, int rows, int d, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const size_t off = static_cast<size_t>(row) * d;
  float cache[kLnCache];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < kLnCache; ++c) {
    const int i = lane + 32 * c;
    cache[c] = 0.f;
    if (i < d) {
      const T t = from_f<T>(to_f(x[off + i]) + to_f(delta[off + i]));
      sum[off + i] = t;
      const float v = to_f(t);
      cache[c] = v;
      s += v;
      ss += v * v;
    }
  }
  for (int i = lane + 32 * kLnCache; i < d; i += 32) {
    const T t = from_f<T>(to_f(x[off + i]) + to_f(delta[off + i]));
    sum[off + i] = t;
    const float v = to_f(t);
    s += v;
    ss += v * v;
  }
  float mean, r;
  ln_stats(s, ss, d, eps, &mean, &r);
#pragma unroll
  for (int c = 0; c < kLnCache; ++c) {
    const int i = lane + 32 * c;
    if (i < d) y[off + i] = from_f<Tout>(ln_out(cache[c], mean, r, w[i], b[i]));
  }
  for (int i = lane + 32 * kLnCache; i < d; i += 32)  // the lane's own stores of s
    y[off + i] = from_f<Tout>(ln_out(to_f(sum[off + i]), mean, r, w[i], b[i]));
}

// -- tied readout -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// 4 bytes, zero-filled when !valid (src is then not read)
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

struct HRows {
  int M, d;
  int hstr;   // row stride of the staged rows, in floats
  bool hvec;  // 16-byte loads (d % 8 == 0, h 16-byte aligned)
};

struct ReadoutShape {
  int M, V, d;
  int d4;      // d rounded up to 4: columns of a staged row
  int es;      // row stride of a staged table tile, in floats
  int tv;      // vocab rows per tile (32 WV)
  int stages;  // tiles in flight (1 to 3)
  int kc;      // staged columns of h per chunk (multiple of 8, <= d4)
  int hstr;    // row stride of the staged rows of h, in floats
  bool vec;    // 16-byte copies of E (d % 4 == 0, E 16-byte aligned)
  bool hvec;   // 16-byte loads of h (d % 8 == 0, h 16-byte aligned)
  __device__ HRows rows() const { return HRows{M, d, hstr, hvec}; }
};

// A row stride of an odd number of 16-byte units: 8 consecutive rows read
// at one column fall in 8 different bank groups.
__host__ __device__ __forceinline__ int odd_units(int floats) { return floats + ((floats / 4) % 2 == 0 ? 4 : 0); }

// Copy vocab tile `tile` into ring stage `es_stage`: rows past V and
// columns past d are zero-filled.  Every thread issues its share.
__device__ __forceinline__ void load_tile(float* es_stage, const float* __restrict__ E, int tile,
                                          const ReadoutShape& sh) {
  const int v0 = tile * sh.tv;
  if (sh.vec) {
    const int units = sh.d4 / 4;  // 16-byte units of a row
    auto copy = [&](int r, int u) {
      float* dst = es_stage + r * sh.es + 4 * u;
      if (v0 + r < sh.V)
        cp_async16(dst, E + static_cast<size_t>(v0 + r) * sh.d + 4 * u);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    };
    if (kThreads % units == 0) {  // a thread keeps one unit column: no division a copy
      const int u = threadIdx.x % units;
      for (int r = threadIdx.x / units; r < sh.tv; r += kThreads / units) copy(r, u);
    } else {
      for (int i = threadIdx.x; i < sh.tv * units; i += kThreads) copy(i / units, i % units);
    }
  } else {
    for (int i = threadIdx.x; i < sh.tv * sh.d4; i += kThreads) {
      const int r = i / sh.d4, k = i - r * sh.d4;
      const bool ok = v0 + r < sh.V && k < sh.d;
      cp_async4(es_stage + r * sh.es + k, ok ? E + static_cast<size_t>(v0 + r) * sh.d + k : E, ok);
    }
  }
}

// 16 bytes of h as f32 into shared memory: 4 f32 or 8 bf16 values.
__device__ __forceinline__ void put_f32(float* dst, uint4 raw, float) { *reinterpret_cast<uint4*>(dst) = raw; }
__device__ __forceinline__ void put_f32(float* dst, uint4 raw, __nv_bfloat16) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  d4[1] = make_float4(__uint_as_float(raw.z << 16), __uint_as_float(raw.z & 0xffff0000u),
                      __uint_as_float(raw.w << 16), __uint_as_float(raw.w & 0xffff0000u));
}

// Stage rows [m0, m0 + BM) x columns [k0, k0 + kn) of h as f32 (zeros past
// M and past d), row stride hstr.  Each thread issues its loads in batches
// of kBatch before it stores any, so a batch costs one round trip.
template <typename Th, int BM>
__device__ __forceinline__ void stage_h(float* hs, const Th* __restrict__ h, int m0, int k0, int kn,
                                        const HRows& sh) {
  constexpr int kBatch = 8;
  if (sh.hvec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(Th));
    const int units = kn / kPer, total = BM * units;
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      uint4 raw[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = base + q * kThreads;
        const int r = i / units, u = i - r * units;
        raw[q] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && m0 + r < sh.M)
          raw[q] = __ldg(reinterpret_cast<const uint4*>(h + static_cast<size_t>(m0 + r) * sh.d + k0 + u * kPer));
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = base + q * kThreads;
        const int r = i / units, u = i - r * units;
        if (i < total) put_f32(hs + r * sh.hstr + u * kPer, raw[q], Th());
      }
    }
    return;
  }
  const int total = BM * kn;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * kThreads;
      const int r = i / kn, k = i - r * kn;
      v[q] = i < total && m0 + r < sh.M && k0 + k < sh.d ? to_f(h[static_cast<size_t>(m0 + r) * sh.d + k0 + k]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = base + q * kThreads;
      const int r = i / kn, k = i - r * kn;
      if (i < total) hs[r * sh.hstr + k] = v[q];
    }
  }
}

// Warps: WV along the vocab tile (TV = 32 WV rows), kWarps / WV along the
// rows of h.  Lanes: 4 along rows x 8 along vocab.  A lane owns RM rows
// (tm + 4 a) x 4 vocab rows (tv + 8 j) of its warp's 4 RM x 32 tile.
template <typename Th, int RM, int WV>
__global__ void __launch_bounds__(kThreads, 1) tied_readout_kernel(const Th* __restrict__ h,
                                                                   const float* __restrict__ E,
                                                                   float* __restrict__ out, ReadoutShape sh) {
  constexpr int RV = kRV;
  constexpr int WM = kWarps / WV;   // warps along rows
  constexpr int BM = WM * 4 * RM;   // rows of h per group
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                            // [stages][tv][es]
  float* hs = smem + sh.stages * sh.tv * sh.es;  // [BM][hstr]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WV, wv = warp % WV, tm = lane >> 3, tv = lane & 7;
  const int n_tiles = (sh.V + sh.tv - 1) / sh.tv;
  const int n_my = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_groups = (sh.M + BM - 1) / BM;
  // h staged once for the whole call when one group and one chunk hold it
  const bool h_once = n_groups == 1 && sh.kc == sh.d4;

  for (int s = 0; s < sh.stages; ++s) {
    if (s < n_my) load_tile(ring + s * sh.tv * sh.es, E, blockIdx.x + s * gridDim.x, sh);
    cp_async_commit();
  }
  if (h_once) stage_h<Th, BM>(hs, h, 0, 0, sh.d4, sh.rows());

  for (int i = 0; i < n_my; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const float* tile_s = ring + (i % sh.stages) * sh.tv * sh.es;
    if (sh.stages == 3)
      cp_async_wait<2>();
    else if (sh.stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // the tile (and a once-staged h) landed for every thread
    for (int g = 0; g < n_groups; ++g) {
      const int mw = g * BM + wm * 4 * RM;  // the warp's first row
      float acc[RM][RV];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int j = 0; j < RV; ++j) acc[a][j] = 0.f;
      for (int k0 = 0; k0 < sh.d4; k0 += sh.kc) {
        const int kn = min(sh.kc, sh.d4 - k0);
        if (!h_once) {
          __syncthreads();  // every warp is done with the previous chunk of h
          stage_h<Th, BM>(hs, h, g * BM, k0, kn, sh.rows());
          __syncthreads();
        }
        if (mw < sh.M) {  // warp-uniform: a warp past the last row only stages
          const float* hw = hs + (wm * 4 * RM + tm) * sh.hstr;
          const float* ew = tile_s + (wv * 32 + tv) * sh.es + k0;
#pragma unroll 2
          for (int k = 0; k < kn; k += 4) {
            float4 hv[RM], ev[RV];
#pragma unroll
            for (int a = 0; a < RM; ++a) hv[a] = *reinterpret_cast<const float4*>(hw + 4 * a * sh.hstr + k);
#pragma unroll
            for (int j = 0; j < RV; ++j) ev[j] = *reinterpret_cast<const float4*>(ew + 8 * j * sh.es + k);
#pragma unroll
            for (int a = 0; a < RM; ++a)
#pragma unroll
              for (int j = 0; j < RV; ++j) {
                acc[a][j] = fmaf(hv[a].x, ev[j].x, acc[a][j]);
                acc[a][j] = fmaf(hv[a].y, ev[j].y, acc[a][j]);
                acc[a][j] = fmaf(hv[a].z, ev[j].z, acc[a][j]);
                acc[a][j] = fmaf(hv[a].w, ev[j].w, acc[a][j]);
              }
          }
        }
      }
      if (mw < sh.M) {
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          const int m = mw + tm + 4 * a;
          if (m < sh.M) {
#pragma unroll
            for (int j = 0; j < RV; ++j) {
              const int v = tile * sh.tv + wv * 32 + tv + 8 * j;
              if (v < sh.V) out[static_cast<size_t>(m) * sh.V + v] = acc[a][j];
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (i + sh.stages < n_my)
      load_tile(ring + (i % sh.stages) * sh.tv * sh.es, E, tile + sh.stages * gridDim.x, sh);
    cp_async_commit();
  }
}

// The streaming variant for a few rows (M <= 4 RM): one group of rows, so
// a wider vocab tile (TV = 256: 8 warps x 32) is streamed in k chunks of
// kSC columns through a ring of stages, and the accumulators run on
// across the chunks of a tile.  Each chunk still leaves device memory
// once, and each logit is the same chain as in the resident kernel.
constexpr int kSTV = kWarps * 32;  // vocab rows per streamed tile
constexpr int kSC = 32;            // columns per chunk
constexpr int kSCS = kSC + 4;      // chunk row stride: 9 16-byte units (odd)
constexpr int kSStages = 4;

struct StreamShape {
  int M, V, d, d4;
  int hstr;  // row stride of the staged rows of h
  int n_chunks;
  bool vec;
  bool hvec;
};

__device__ __forceinline__ void load_chunk(float* stage, const float* __restrict__ E, int tile, int c,
                                           const StreamShape& sh) {
  const int v0 = tile * kSTV, k0 = c * kSC;
  const int kn = min(kSC, sh.d4 - k0);
  if (sh.vec && kn == kSC) {  // a full chunk: 8 units a row, one unit column a thread
    constexpr int kUnits = kSC / 4;
    const int u = threadIdx.x % kUnits;
#pragma unroll
    for (int r = threadIdx.x / kUnits; r < kSTV; r += kThreads / kUnits) {
      float* dst = stage + r * kSCS + 4 * u;
      if (v0 + r < sh.V)
        cp_async16(dst, E + static_cast<size_t>(v0 + r) * sh.d + k0 + 4 * u);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else if (sh.vec) {
    const int units = kn / 4;
    for (int i = threadIdx.x; i < kSTV * units; i += kThreads) {
      const int r = i / units, u = i - r * units;
      float* dst = stage + r * kSCS + 4 * u;
      if (v0 + r < sh.V)
        cp_async16(dst, E + static_cast<size_t>(v0 + r) * sh.d + k0 + 4 * u);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kSTV * kn; i += kThreads) {
      const int r = i / kn, k = i - r * kn;
      const bool ok = v0 + r < sh.V && k0 + k < sh.d;
      cp_async4(stage + r * kSCS + k, ok ? E + static_cast<size_t>(v0 + r) * sh.d + k0 + k : E, ok);
    }
  }
}

template <typename Th, int RM>
__global__ void __launch_bounds__(kThreads, 1) tied_readout_stream_kernel(const Th* __restrict__ h,
                                                                          const float* __restrict__ E,
                                                                          float* __restrict__ out,
                                                                          StreamShape sh) {
  constexpr int RV = kRV;
  constexpr int BM = 4 * RM;  // every warp covers all the rows
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                            // [kSStages][kSTV][kSCS]
  float* hs = smem + kSStages * kSTV * kSCS;     // [BM][hstr]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = lane >> 3, tv = lane & 7;
  const int n_tiles = (sh.V + kSTV - 1) / kSTV;
  const int n_my = blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_seq = n_my * sh.n_chunks;  // (tile, chunk) items of this block, in order

  for (int s = 0; s < kSStages; ++s) {
    if (s < n_seq)
      load_chunk(ring + s * kSTV * kSCS, E, blockIdx.x + (s / sh.n_chunks) * gridDim.x, s % sh.n_chunks, sh);
    cp_async_commit();
  }
  stage_h<Th, BM>(hs, h, 0, 0, sh.d4, HRows{sh.M, sh.d, sh.hstr, sh.hvec});
  const float* hw = hs + tm * sh.hstr;
  float acc[RM][RV];
  for (int q = 0; q < n_seq; ++q) {
    const int c = q % sh.n_chunks;
    const int tile = blockIdx.x + (q / sh.n_chunks) * gridDim.x;
    const float* stage = ring + (q % kSStages) * kSTV * kSCS;
    cp_async_wait<kSStages - 1>();
    __syncthreads();  // the chunk (and h) landed for every thread
    if (c == 0) {
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int j = 0; j < RV; ++j) acc[a][j] = 0.f;
    }
    const int k0 = c * kSC, kn = min(kSC, sh.d4 - k0);
    const float* ew = stage + (warp * 32 + tv) * kSCS;
#pragma unroll 2
    for (int k = 0; k < kn; k += 4) {
      float4 hv[RM], ev[RV];
#pragma unroll
      for (int a = 0; a < RM; ++a) hv[a] = *reinterpret_cast<const float4*>(hw + 4 * a * sh.hstr + k0 + k);
#pragma unroll
      for (int j = 0; j < RV; ++j) ev[j] = *reinterpret_cast<const float4*>(ew + 8 * j * kSCS + k);
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int j = 0; j < RV; ++j) {
          acc[a][j] = fmaf(hv[a].x, ev[j].x, acc[a][j]);
          acc[a][j] = fmaf(hv[a].y, ev[j].y, acc[a][j]);
          acc[a][j] = fmaf(hv[a].z, ev[j].z, acc[a][j]);
          acc[a][j] = fmaf(hv[a].w, ev[j].w, acc[a][j]);
        }
    }
    if (c == sh.n_chunks - 1) {
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const int m = tm + 4 * a;
        if (m < sh.M) {
#pragma unroll
          for (int j = 0; j < RV; ++j) {
            const int v = tile * kSTV + warp * 32 + tv + 8 * j;
            if (v < sh.V) out[static_cast<size_t>(m) * sh.V + v] = acc[a][j];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    const int nq = q + kSStages;
    if (nq < n_seq)
      load_chunk(ring + (q % kSStages) * kSTV * kSCS, E, blockIdx.x + (nq / sh.n_chunks) * gridDim.x,
                 nq % sh.n_chunks, sh);
    cp_async_commit();
  }
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return v > 0 ? v : 132;
  }();
  return n;
}

template <typename Tin, typename Tout>
cudaError_t launch_ln(const void* x, const float* w, const float* b, void* y, int rows, int d, float eps,
                      cudaStream_t st) {
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  layer_norm_rows_kernel<Tin, Tout><<<blocks, kThreads, 0, st>>>(static_cast<const Tin*>(x), w, b,
                                                                  static_cast<Tout*>(y), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename Tout>
cudaError_t launch_add_ln(const void* x, const void* delta, const float* w, const float* b, void* sum, void* y,
                          int rows, int d, float eps, cudaStream_t st) {
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  add_layer_norm_rows_kernel<T, Tout><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), w, b, static_cast<T*>(sum), static_cast<Tout*>(y),
      rows, d, eps);
  return cudaGetLastError();
}

// Tile sizes for width d: the first of these that fits, with BM(TV) rows
// of h staged whole (first pass), else in chunks of a multiple of 8
// columns (second pass): a deeper ring first, then a wider tile.
bool readout_shape(int M, int V, int d, bool vec, bool hvec, int RM, ReadoutShape* sh, int* smem) {
  sh->M = M;
  sh->V = V;
  sh->d = d;
  sh->d4 = (d + 3) / 4 * 4;
  sh->es = odd_units(sh->d4);
  sh->vec = vec;
  sh->hvec = hvec;
  const int options[6][2] = {{64, 3}, {64, 2}, {128, 1}, {64, 1}, {32, 2}, {32, 1}};
  for (int whole = 1; whole >= 0; --whole) {
    for (const auto& o : options) {
      const int BM = (kWarps / (o[0] / 32)) * 4 * RM;
      const int ring = o[1] * o[0] * sh->es * 4;
      const int room = kMaxSmem - ring;
      int kc = sh->d4;
      if (BM * odd_units(kc) * 4 > room) {
        kc = room / (BM * 4) / 8 * 8;
        while (kc >= 8 && BM * odd_units(kc) * 4 > room) kc -= 8;
      }
      if (kc >= (whole ? sh->d4 : 8)) {
        sh->tv = o[0];
        sh->stages = o[1];
        sh->kc = kc;
        sh->hstr = odd_units(kc);
        *smem = ring + BM * sh->hstr * 4;
        return true;
      }
    }
  }
  return false;
}

template <typename Th, int RM, int WV>
cudaError_t launch_readout_cfg(const Th* h, const float* E, float* out, const ReadoutShape& sh, int smem,
                               cudaStream_t st) {
  auto kernel = tied_readout_kernel<Th, RM, WV>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = (sh.V + sh.tv - 1) / sh.tv;
  const int grid = std::min(n_tiles, sm_count());
  kernel<<<grid, kThreads, smem, st>>>(h, E, out, sh);
  return cudaGetLastError();
}

template <typename Th, int RM>
cudaError_t launch_stream_cfg(const Th* h, const float* E, float* out, const StreamShape& sh, int smem,
                              cudaStream_t st) {
  auto kernel = tied_readout_stream_kernel<Th, RM>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = (sh.V + kSTV - 1) / kSTV;
  const int grid = std::min(n_tiles, sm_count());
  kernel<<<grid, kThreads, smem, st>>>(h, E, out, sh);
  return cudaGetLastError();
}

template <typename Th>
cudaError_t launch_readout(const void* h, const float* E, float* out, int M, int V, int d, cudaStream_t st) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(E) % 16 == 0;
  const bool hvec = d % 8 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const Th* hh = static_cast<const Th*>(h);
  const int d4 = (d + 3) / 4 * 4;
  if (M <= 32) {  // few rows: stream the table in k chunks of wide tiles
    const int RM = M <= 16 ? 4 : 8;
    StreamShape sh{M, V, d, d4, odd_units(d4), (d4 + kSC - 1) / kSC, vec, hvec};
    const int smem = (kSStages * kSTV * kSCS + 4 * RM * sh.hstr) * 4;
    if (smem <= kMaxSmem)
      return RM == 4 ? launch_stream_cfg<Th, 4>(hh, E, out, sh, smem, st)
                     : launch_stream_cfg<Th, 8>(hh, E, out, sh, smem, st);
  }
  ReadoutShape sh;
  int smem = 0;
  if (!readout_shape(M, V, d, vec, hvec, 8, &sh, &smem)) return cudaErrorInvalidValue;
  if (sh.tv == 128) return launch_readout_cfg<Th, 8, 4>(hh, E, out, sh, smem, st);
  return sh.tv == 64 ? launch_readout_cfg<Th, 8, 2>(hh, E, out, sh, smem, st)
                     : launch_readout_cfg<Th, 8, 1>(hh, E, out, sh, smem, st);
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16.  Each entry point launches on `stream`
// and returns the cudaError_t of the launch.
extern "C" int pw_layer_norm_rows(const void* x, const void* w, const void* b, void* y, int rows, int d,
                                  float eps, int in_dtype, int out_dtype, void* stream) {
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* ww = static_cast<const float*>(w);
  auto* bb = static_cast<const float*>(b);
  cudaError_t err;
  if (in_dtype == 0 && out_dtype == 0) err = launch_ln<float, float>(x, ww, bb, y, rows, d, eps, st);
  else if (in_dtype == 0) err = launch_ln<float, __nv_bfloat16>(x, ww, bb, y, rows, d, eps, st);
  else if (out_dtype == 0) err = launch_ln<__nv_bfloat16, float>(x, ww, bb, y, rows, d, eps, st);
  else err = launch_ln<__nv_bfloat16, __nv_bfloat16>(x, ww, bb, y, rows, d, eps, st);
  return static_cast<int>(err);
}

// x, delta and sum share `dtype`; y is `out_dtype`.
extern "C" int pw_add_layer_norm_rows(const void* x, const void* delta, const void* w, const void* b, void* sum,
                                      void* y, int rows, int d, float eps, int dtype, int out_dtype,
                                      void* stream) {
  if (rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* ww = static_cast<const float*>(w);
  auto* bb = static_cast<const float*>(b);
  cudaError_t err;
  if (dtype == 0 && out_dtype == 0) err = launch_add_ln<float, float>(x, delta, ww, bb, sum, y, rows, d, eps, st);
  else if (dtype == 0) err = launch_add_ln<float, __nv_bfloat16>(x, delta, ww, bb, sum, y, rows, d, eps, st);
  else if (out_dtype == 0) err = launch_add_ln<__nv_bfloat16, float>(x, delta, ww, bb, sum, y, rows, d, eps, st);
  else err = launch_add_ln<__nv_bfloat16, __nv_bfloat16>(x, delta, ww, bb, sum, y, rows, d, eps, st);
  return static_cast<int>(err);
}

extern "C" int pw_tied_readout(const void* h, const void* E, void* out, int M, int V, int d, int h_dtype,
                               void* stream) {
  if (M <= 0 || V <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* ee = static_cast<const float*>(E);
  auto* oo = static_cast<float*>(out);
  const cudaError_t err = h_dtype == 1 ? launch_readout<__nv_bfloat16>(h, ee, oo, M, V, d, st)
                                       : launch_readout<float>(h, ee, oo, M, V, d, st);
  return static_cast<int>(err);
}

extern "C" const char* pw_decode_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
