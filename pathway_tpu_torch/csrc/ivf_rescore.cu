// IVF shortlist rescore for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pathway_tpu/ops/ivf_pallas.py
// `_rescore_kernel` (launched by `ivf_rescore`, dispatched through
// `rescore_shortlist`):
//
//   out[b, j, m] = dot(q[b, :], slabs[probe[b, j], m, :]) + bias[probe[b, j], m]
//
// probe [B, P] int32, q [B, d] f32, slabs [C, M, d] f32 or bf16,
// bias [C, M] f32 (0 live, -inf pad/removed) -> out [B, P, M] f32, with
// f32 accumulation.  None of the TPU tiling constraints carry over: B, M,
// d and C may be any size, and the output is written as [B, P, M]
// directly (no [P, B/8, 8, M] transpose).
//
// Bound: memory.  Each (b, j) reads one M x d slab and does 2 flops per
// slab element, far below the ~20 flops/byte the card needs before its
// f32 rate would bind (at 1M x 384, M = 256, P = 69, B = 64 that is
// <= 1.74 GB of slab reads against 0.87 GFLOP).
//
// Design (first, simple version): one block per (b, j).  The block loads
// its own probe id, stages q[b] in shared memory, and gives each warp
// groups of ROWS slab rows.  Lanes read 16-byte vectors along d (4 f32 or
// 8 bf16), accumulate in f32, reduce across the warp with shuffles, and
// lane 0 adds the bias and writes.  Slabs probed by several queries of a
// batch are read once per query, from L2 when they are still there.
//
// The later redesign inverts the probe table: one CTA per probed
// cluster, its slab streamed once by TMA into shared memory, and a
// `wgmma` product against the queries that probe it, so each slab is read
// from device memory once per batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // slab rows in flight per warp

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  __nv_bfloat162 h0, h1;
  *reinterpret_cast<uint32_t*>(&h0) = lo;
  *reinterpret_cast<uint32_t*>(&h1) = hi;
  const float2 f0 = __bfloat1622float2(h0);
  const float2 f1 = __bfloat1622float2(h1);
  return make_float4(f0.x, f0.y, f1.x, f1.y);
}

// dot of one 16-byte vector of slab elements (starting at element e, a
// multiple of the vector width) with the matching q values in shared
// memory, read as float4 so the lanes of a warp hit distinct banks
__device__ __forceinline__ float dot16(const float* row, int e, const float* qs) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(row + e));
  return dot4(s, *reinterpret_cast<const float4*>(qs + e));
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* row, int e, const float* qs) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + e));
  const float4* qv = reinterpret_cast<const float4*>(qs + e);
  return dot4(bf16x4(u.x, u.y), qv[0]) + dot4(bf16x4(u.z, u.w), qv[1]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
ivf_rescore_kernel(const int32_t* __restrict__ probe, const float* __restrict__ q,
                   const T* __restrict__ slabs, const float* __restrict__ bias,
                   float* __restrict__ out, int P, int C, int M, int d) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  constexpr int kElems = 16 / sizeof(T);

  const long long bj = blockIdx.x;  // b * P + j
  const int b = static_cast<int>(bj / P);
  int c = probe[bj];
  // out-of-range ids clamp, as the reference's gather does
  c = c < 0 ? 0 : (c >= C ? C - 1 : c);

  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = q[static_cast<long long>(b) * d + i];
  __syncthreads();

  const T* slab = slabs + static_cast<long long>(c) * M * d;
  const float* brow = bias + static_cast<long long>(c) * M;
  float* orow = out + bj * M;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;

  for (int r0 = warp * kRows; r0 < M; r0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    if (kVec) {
      for (int e = lane * kElems; e < d; e += 32 * kElems) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < M) acc[r] += dot16(slab + static_cast<long long>(r0 + r) * d, e, qs);
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        const float qv = qs[e];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r0 + r < M) acc[r] += to_f32(slab[static_cast<long long>(r0 + r) * d + e]) * qv;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < M) orow[r0 + r] = acc[r] + brow[r0 + r];
    }
  }
}

template <typename T>
cudaError_t launch(const void* probe, const void* q, const void* slabs, const void* bias,
                   void* out, int B, int P, int C, int M, int d, cudaStream_t stream) {
  constexpr int kElems = 16 / sizeof(T);
  const bool vec = (d % kElems == 0) && (reinterpret_cast<uintptr_t>(slabs) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(B) * P));
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto* p = static_cast<const int32_t*>(probe);
  auto* qq = static_cast<const float*>(q);
  auto* s = static_cast<const T*>(slabs);
  auto* bb = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (vec)
    ivf_rescore_kernel<T, true><<<grid, kThreads, smem, stream>>>(p, qq, s, bb, o, P, C, M, d);
  else
    ivf_rescore_kernel<T, false><<<grid, kThreads, smem, stream>>>(p, qq, s, bb, o, P, C, M, d);
  return cudaGetLastError();
}

}  // namespace

// slab_dtype: 0 = f32, 1 = bf16.  Returns the cudaError_t of the launch.
extern "C" int pw_ivf_rescore(const void* probe, const void* q, const void* slabs,
                              const void* bias, void* out, int B, int P, int C, int M, int d,
                              int slab_dtype, void* stream) {
  if (B <= 0 || P <= 0 || M <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      slab_dtype == 1
          ? launch<__nv_bfloat16>(probe, q, slabs, bias, out, B, P, C, M, d, st)
          : launch<float>(probe, q, slabs, bias, out, B, P, C, M, d, st);
  return static_cast<int>(err);
}

extern "C" const char* pw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
