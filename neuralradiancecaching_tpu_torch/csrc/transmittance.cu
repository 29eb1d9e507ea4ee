// The quadrature transmittance through the density corner table in two
// kernels, each with a plain C entry point loaded through ctypes
// (neuralradiancecaching_tpu_torch/ops/volume.py:transmittance): the
// density samples, one thread a sample, and the finish, one thread a
// segment.
//
// Replaces no Pallas kernel: the JAX package leaves GetTransmittance
// (nrc-train.comp:1032-1053) to XLA as plain array code, and so did the
// port, as about 40 launches a call that wrote every step's points, cell
// indices, corner rows, stacked weights and products to device memory and
// read them back. The density kernel runs the per-sample chain in registers
// and writes one float a sample: the (..., steps) densities that the
// wrapper sums with torch.sum, so the step sum is torch's own, in torch's
// own order, at any step count. The finish kernel then does the plain
// path's last five launches in one.
//
// What it computes, bit for bit what the plain torch path computes on the
// card (volume.transmittance_plain's `dens`) for a float32 corner table
// (build_corner_table: row (i+1, j+1, k+1) holds the 8 corners of base cell
// (i, j, k) in x-major order dx*4 + dy*2 + dz) and float32 segments. The
// wrapper hands in start and seg = end - start, computed by torch. Then for
// segment r and step s (sample r * steps + s):
//   frac  = s * rn(1 / steps)       torch's `arange / steps` multiplies by
//                                   the rounded reciprocal of a scalar
//   p     = start + frac * seg
//   uvw   = (p - center) / size + 0.5          (a true division)
//   t     = uvw * N - 0.5; i = floor(t); f = t - i
//   valid = -1 <= i <= N - 1 on every axis, i as torch's float -> integer
//           cast gives it (truncation; NaN -> 0, out of range saturates)
//   w     = (g|f)x * (g|f)y * (g|f)z in _lerp8's order, g = 1 - f
//   dens  = density_factor * (valid ? sum_k row[k] * w[k] : 0)
// and, with torch's sum over the steps, per segment
//   T     = |seg| > 0 ? exp(-(step_size * sum)) : 1
// Every operation is a separately rounded float32 operation, as torch's
// separate kernels round them: __fmul_rn, __fadd_rn, __fsub_rn and
// __fdiv_rn keep nvcc from contracting a multiply and an add into an FMA;
// floorf and expf are the library functions torch's kernels call (no
// fast-math flag; kernels.NVCC_FLAGS). The corner sum is _lerp8's torch.sum over the last
// dimension of 8, which on the card runs on 8 lanes of one block folded in
// halves (v[t] += v[t + h] for h = 4, 2, 1; probed on torch 2.11 / CUDA
// 12.8, H100, and kept as tests/test_torch_transmittance_kernel.py's
// test_torch_sum_order_probe): ((p0 + p4) + (p2 + p6)) + ((p1 + p5) +
// (p3 + p7)).
//
// What bounds it: each sample reads one 32-byte corner row (two 16-byte
// read-only loads) and writes 4 bytes, and does ~45 float operations. The
// table (53 MB for the 125x85x153 grid) is about the size of L2, and a
// warp's samples are neighbouring steps of one or two segments, which lie
// close together in the grid, so most rows come from L1 or L2; the bytes
// that must cross device memory are the samples' own 4 written here and
// read again by torch.sum. Samples outside the box skip their load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Volume {
  float cx, cy, cz;     // box centre
  float sx, sy, sz;     // box size
  float nxf, nyf, nzf;  // grid shape as floats
  int nx, ny, nz;       // grid shape
  int stride_x, stride_y;  // (ny+1)(nz+1), nz+1: rows of the corner table
  float density_factor;
};

// density_at(table, p): getDensity's factor times the trilinear fetch.
__device__ __forceinline__ float density(const float4* __restrict__ table,
                                         const Volume& v, float px, float py,
                                         float pz) {
  const float ux = __fadd_rn(__fdiv_rn(__fsub_rn(px, v.cx), v.sx), 0.5f);
  const float uy = __fadd_rn(__fdiv_rn(__fsub_rn(py, v.cy), v.sy), 0.5f);
  const float uz = __fadd_rn(__fdiv_rn(__fsub_rn(pz, v.cz), v.sz), 0.5f);
  const float tx = __fsub_rn(__fmul_rn(ux, v.nxf), 0.5f);
  const float ty = __fsub_rn(__fmul_rn(uy, v.nyf), 0.5f);
  const float tz = __fsub_rn(__fmul_rn(uz, v.nzf), 0.5f);
  const float fx0 = floorf(tx), fy0 = floorf(ty), fz0 = floorf(tz);
  // torch casts to int64; a 32-bit cast saturates beyond the grid alike and
  // maps NaN to 0 alike, so `valid` and the row are the same
  const int i = static_cast<int>(fx0), j = static_cast<int>(fy0),
            k = static_cast<int>(fz0);
  float sum = 0.0f;
  if (i >= -1 && i <= v.nx - 1 && j >= -1 && j <= v.ny - 1 && k >= -1 &&
      k <= v.nz - 1) {
    const int row = (i + 1) * v.stride_x + (j + 1) * v.stride_y + (k + 1);
    const float4 lo = __ldg(table + 2 * static_cast<int64_t>(row));
    const float4 hi = __ldg(table + 2 * static_cast<int64_t>(row) + 1);
    const float fx = __fsub_rn(tx, fx0), fy = __fsub_rn(ty, fy0),
                fz = __fsub_rn(tz, fz0);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy),
                gz = __fsub_rn(1.0f, fz);
    const float gg = __fmul_rn(gx, gy), gf = __fmul_rn(gx, fy),
                fg = __fmul_rn(fx, gy), ff = __fmul_rn(fx, fy);
    const float p0 = __fmul_rn(lo.x, __fmul_rn(gg, gz));
    const float p1 = __fmul_rn(lo.y, __fmul_rn(gg, fz));
    const float p2 = __fmul_rn(lo.z, __fmul_rn(gf, gz));
    const float p3 = __fmul_rn(lo.w, __fmul_rn(gf, fz));
    const float p4 = __fmul_rn(hi.x, __fmul_rn(fg, gz));
    const float p5 = __fmul_rn(hi.y, __fmul_rn(fg, fz));
    const float p6 = __fmul_rn(hi.z, __fmul_rn(ff, gz));
    const float p7 = __fmul_rn(hi.w, __fmul_rn(ff, fz));
    // torch.sum over 8 on the card: 8 lanes folded in halves
    sum = __fadd_rn(__fadd_rn(__fadd_rn(p0, p4), __fadd_rn(p2, p6)),
                    __fadd_rn(__fadd_rn(p1, p5), __fadd_rn(p3, p7)));
  }
  return __fmul_rn(sum, v.density_factor);
}

__global__ void __launch_bounds__(kThreads)
    quadrature_density_kernel(const float4* __restrict__ table,
                              const float* __restrict__ start,
                              const float* __restrict__ seg,
                              float* __restrict__ dens, int64_t samples,
                              int steps, float inv_steps, Volume v) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= samples) return;
  const int64_t r = n / steps;
  const float f = __fmul_rn(static_cast<float>(n - r * steps), inv_steps);
  dens[n] = density(table, v, __fadd_rn(start[3 * r], __fmul_rn(f, seg[3 * r])),
                    __fadd_rn(start[3 * r + 1], __fmul_rn(f, seg[3 * r + 1])),
                    __fadd_rn(start[3 * r + 2], __fmul_rn(f, seg[3 * r + 2])));
}

// The plain path's step_size * sum, exp(-.) and where(|seg| > 0, ., 1).
__global__ void __launch_bounds__(kThreads)
    quadrature_finish_kernel(const float* __restrict__ total,
                             const float* __restrict__ step_size,
                             const float* __restrict__ length,
                             float* __restrict__ out, int64_t rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  out[r] = length[r] > 0.0f ? expf(-__fmul_rn(step_size[r], total[r])) : 1.0f;
}

}  // namespace

extern "C" {

// The (rows, steps) density samples into `dens` on `stream`: `table` the
// (R, 8) float32 corner table of a (nx, ny, nz) grid, 16-byte aligned;
// `start`, `seg` (rows, 3), `dens` (rows, steps), all float32 and
// contiguous. Returns the launch's CUDA error.
int quadrature_densities(const void* table, const void* start,
                         const void* seg, void* dens, long long rows,
                         int steps, float center_x, float center_y,
                         float center_z, float size_x, float size_y,
                         float size_z, int nx, int ny, int nz,
                         float density_factor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  Volume v;
  v.cx = center_x;
  v.cy = center_y;
  v.cz = center_z;
  v.sx = size_x;
  v.sy = size_y;
  v.sz = size_z;
  v.nxf = static_cast<float>(nx);
  v.nyf = static_cast<float>(ny);
  v.nzf = static_cast<float>(nz);
  v.nx = nx;
  v.ny = ny;
  v.nz = nz;
  v.stride_y = nz + 1;
  v.stride_x = (ny + 1) * (nz + 1);
  v.density_factor = density_factor;
  // torch's `/ steps` by a scalar: times the float reciprocal
  const float inv_steps = 1.0f / static_cast<float>(steps);
  const long long samples = rows * steps;
  const long long blocks = (samples + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quadrature_density_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const float*>(start),
      static_cast<const float*>(seg), static_cast<float*>(dens), samples,
      steps, inv_steps, v);
  return static_cast<int>(cudaGetLastError());
}

// T for `rows` segments into `out` on `stream` from torch's step sums
// `total`, `step_size` and `length` (rows,), all float32 and contiguous.
// Returns the launch's CUDA error.
int quadrature_finish(const void* total, const void* step_size,
                      const void* length, void* out, long long rows,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quadrature_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(total), static_cast<const float*>(step_size),
      static_cast<const float*>(length), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
