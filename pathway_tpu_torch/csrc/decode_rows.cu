// Row-invariant LayerNorm and tied readout of the generator decode path,
// for Hopper (sm_90a).  Port-side kernels: they replace no Pallas kernel.
// In the JAX package both are XLA ops of the generator
// (pathway_tpu/models/transformer.py `nn.LayerNorm` in the KV / slot
// twins, and the readout einsum of pathway_tpu/models/generator.py).
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
// strided elements in order, then a fixed xor butterfly.  Bound: bytes
// (one read of x, one write of y).
//
// tied_readout: logits[m, v] = sum_k float(h[m, k]) * E[v, k] in f32 (the
// weight-tied readout over the f32 embedding table).  A block stages 8 rows
// of h in shared memory and its 8 warps walk 32 vocab rows; a lane
// accumulates k = lane, lane + 32, ... in order and a fixed xor butterfly
// finishes each sum.  Bound: bytes of the table (V x d x 4 = 32 MB for
// the default generator), read once per 8 rows of h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;   // rows of h staged per readout block
constexpr int kVocabPerBlock = 32; // vocab rows per readout block (4 per warp)

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

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(256) layer_norm_rows_kernel(const Tin* __restrict__ x, const float* __restrict__ w,
                                                              const float* __restrict__ b, Tout* __restrict__ y,
                                                              int rows, int d, float eps) {
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
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / static_cast<float>(d);
  const float var = fmaxf(ss / static_cast<float>(d) - mean * mean, 0.f);
  const float r = __frsqrt_rn(var + eps);
  Tout* yr = y + static_cast<size_t>(row) * d;
  for (int i = lane; i < d; i += 32) yr[i] = from_f<Tout>((to_f(xr[i]) - mean) * (r * w[i]) + b[i]);
}

template <typename Th>
__global__ void __launch_bounds__(256) tied_readout_kernel(const Th* __restrict__ h, const float* __restrict__ E,
                                                           float* __restrict__ out, int M, int V, int d) {
  extern __shared__ float hs[];  // [kRowsPerBlock][d]
  const int m0 = blockIdx.y * kRowsPerBlock;
  const int rm = min(kRowsPerBlock, M - m0);
  for (int i = threadIdx.x; i < kRowsPerBlock * d; i += blockDim.x)
    hs[i] = i < rm * d ? to_f(h[static_cast<size_t>(m0) * d + i]) : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kPerWarp = kVocabPerBlock / 8;
  for (int r = 0; r < kPerWarp; ++r) {
    const int v = blockIdx.x * kVocabPerBlock + warp * kPerWarp + r;
    if (v >= V) break;  // warp-uniform
    const float* e = E + static_cast<size_t>(v) * d;
    float acc[kRowsPerBlock];
#pragma unroll
    for (int j = 0; j < kRowsPerBlock; ++j) acc[j] = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float ev = __ldg(e + k);
#pragma unroll
      for (int j = 0; j < kRowsPerBlock; ++j) acc[j] = fmaf(hs[j * d + k], ev, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerBlock; ++j) {
      const float total = warp_sum(acc[j]);
      if (lane == j && j < rm) out[static_cast<size_t>(m0 + j) * V + v] = total;
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_ln(const void* x, const float* w, const float* b, void* y, int rows, int d, float eps,
                      cudaStream_t st) {
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  layer_norm_rows_kernel<Tin, Tout><<<blocks, threads, 0, st>>>(static_cast<const Tin*>(x), w, b,
                                                                 static_cast<Tout*>(y), rows, d, eps);
  return cudaGetLastError();
}

template <typename Th>
cudaError_t launch_readout(const void* h, const float* E, float* out, int M, int V, int d, cudaStream_t st) {
  const dim3 grid((V + kVocabPerBlock - 1) / kVocabPerBlock, (M + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = static_cast<size_t>(kRowsPerBlock) * d * sizeof(float);
  tied_readout_kernel<Th><<<grid, 256, smem, st>>>(static_cast<const Th*>(h), E, out, M, V, d);
  return cudaGetLastError();
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
