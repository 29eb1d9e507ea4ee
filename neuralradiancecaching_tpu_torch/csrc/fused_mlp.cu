// Fused forward of the radiance cache's tiny MLP, hand-written for Hopper
// (sm_90a), with a plain C entry point loaded through ctypes
// (neuralradiancecaching_tpu_torch/ops/fused_mlp.py).
//
// Replaces neuralradiancecaching_tpu/ops/pallas_mlp.py:_fused_kernel /
// apply_fused, the Pallas TPU kernel that kept all weights VMEM-resident and
// pushed a 512-row batch tile through every layer without an HBM round trip.
//
// What it computes: ops/mlp.py:apply for in_features == hidden == 64,
// out_features <= 64, any n_layers >= 2, ReLU or sigmoid after every hidden
// layer and optionally after the output layer, all in fp32.
//
// What bounds it: at the render's 262,144 rows the six layers are ~10.8
// GFLOP against ~70 MB of input and output (~150 FLOP/byte), so in exact
// fp32 it is bounded by the FP32 FMA rate, not by memory. Tensor cores
// (TF32/bf16) would move that bound but break fp32 parity; they are later
// work.
//
// Design (not a block-by-block copy of the Pallas grid):
//   * persistent blocks: grid = min(row tiles, 2 x SM count), each block
//     loads the packed weights (~84 KB at 6x64) into dynamic shared memory
//     ONCE and walks its row tiles with a grid-stride loop;
//   * one thread per row: the row's 64 activations live in registers for
//     all layers, so activations never touch shared or global memory;
//   * weight reads are warp-uniform float4 shared-memory broadcasts (one
//     LDS.128 feeds four FMAs of every lane).
//
// Packed parameter layout (built by the Python wrapper, 16-byte aligned):
//   for each hidden layer l < n_layers - 1:  W_l[64][64] row-major (in, out),
//                                            b_l[64]
//   output layer:                            W[64][out_pad], b[out_pad]
// where out_pad = round_up(out_features, 4) and the pad columns are zero.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;         // in_features == hidden
constexpr int kThreads = 128;  // rows per block iteration

__device__ __forceinline__ float activate(float v, int sigmoid) {
  if (sigmoid) return 1.0f / (1.0f + expf(-v));
  return v < 0.0f ? 0.0f : v;  // NaN propagates, like jnp.maximum
}

__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ params,
                     float* __restrict__ out, long long n_rows,
                     int n_hidden, int out_features, int out_pad,
                     int sigmoid, int output_act) {
  extern __shared__ float4 smem4[];
  const float* smem = reinterpret_cast<const float*>(smem4);

  const int n_vec = (n_hidden * (kD * kD + kD) + kD * out_pad + out_pad) / 4;
  const float4* p4 = reinterpret_cast<const float4*>(params);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) smem4[i] = p4[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       row < n_rows; row += stride) {
    float h[kD];
    const float4* xr = reinterpret_cast<const float4*>(x + row * kD);
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) {
      const float4 v = __ldg(xr + i);
      h[4 * i + 0] = v.x;
      h[4 * i + 1] = v.y;
      h[4 * i + 2] = v.z;
      h[4 * i + 3] = v.w;
    }

    const float* p = smem;
    for (int l = 0; l < n_hidden; ++l) {
      const float4* w = reinterpret_cast<const float4*>(p);
      const float* b = p + kD * kD;
      float acc[kD];
#pragma unroll
      for (int j = 0; j < kD; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float hk = h[k];
#pragma unroll
        for (int j4 = 0; j4 < kD / 4; ++j4) {
          const float4 wv = w[k * (kD / 4) + j4];
          acc[4 * j4 + 0] = fmaf(hk, wv.x, acc[4 * j4 + 0]);
          acc[4 * j4 + 1] = fmaf(hk, wv.y, acc[4 * j4 + 1]);
          acc[4 * j4 + 2] = fmaf(hk, wv.z, acc[4 * j4 + 2]);
          acc[4 * j4 + 3] = fmaf(hk, wv.w, acc[4 * j4 + 3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kD; ++j) h[j] = activate(acc[j] + b[j], sigmoid);
      p += kD * kD + kD;
    }

    const float4* w = reinterpret_cast<const float4*>(p);
    const float* b = p + kD * out_pad;
    const int n_out4 = out_pad / 4;
    float* o = out + row * out_features;
    for (int j4 = 0; j4 < n_out4; ++j4) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float4 wv = w[k * n_out4 + j4];
        a[0] = fmaf(h[k], wv.x, a[0]);
        a[1] = fmaf(h[k], wv.y, a[1]);
        a[2] = fmaf(h[k], wv.z, a[2]);
        a[3] = fmaf(h[k], wv.w, a[3]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * j4 + c;
        if (j < out_features) {
          const float v = a[c] + b[j];
          o[j] = output_act ? activate(v, sigmoid) : v;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for the packed weights.
long long fused_mlp_smem_bytes(int n_hidden, int out_pad) {
  return 4LL * (static_cast<long long>(n_hidden) * (kD * kD + kD) +
                static_cast<long long>(kD) * out_pad + out_pad);
}

// Launches the forward on `stream` (a cudaStream_t passed as a pointer).
// Returns cudaGetLastError() after the launch: a refused launch (too much
// shared memory, bad configuration) never runs and is only visible here.
int fused_mlp_forward(const float* x, const float* params, float* out,
                      long long n_rows, int n_hidden, int out_features,
                      int out_pad, int sigmoid, int output_act, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = fused_mlp_smem_bytes(n_hidden, out_pad);
  err = cudaFuncSetAttribute(fused_mlp_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= 0) return 0;
  const long long tiles = (n_rows + kThreads - 1) / kThreads;
  const long long cap = 2LL * n_sm;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  fused_mlp_fwd_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      x, params, out, n_rows, n_hidden, out_features, out_pad, sigmoid,
      output_act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
