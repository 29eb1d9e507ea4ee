// fp32 matrix product C = A @ B on Hopper's tensor cores (sm_90a) at fp32
// accuracy (3xTF32), with a plain C entry point loaded through ctypes
// (neuralradiancecaching_tpu_torch/ops/matmul.py).
//
// Replaces neuralradiancecaching_tpu/ops/pallas_matmul.py:_kernel / matmul,
// the Pallas TPU kernel that walked (256 x 256) output tiles over 512-deep
// K panels on the systolic array with an f32 VMEM accumulator, padding any
// shape to the tiles and slicing the result.
//
// What it computes: row-major A (M, K) times row-major B (K, N) into
// row-major C (M, N), fp32 in and out, any M, N, K >= 0.
//
// What bounds it: 2*M*N*K useful operations against 4*(M*K + K*N + M*N)
// bytes, ~680 FLOP a byte at 4096^3, so a large product is bounded by
// arithmetic. In plain fp32 FMAs that is the 67 TFLOP/s FP32 pipe, where
// the SIMT kernel this file held before (128x128x16 tiles, 8x8 register
// blocking) reached ~35 TFLOP/s and cuBLAS's SGEMM ~51. The tensor cores
// run TF32 at 495 TFLOP/s, but one TF32 pass keeps 11 significant bits of
// each operand and breaks the 2e-4 bound against torch.matmul at K = 512.
//
// Numerics, the 3xTF32 split: each operand x is written as big + small,
// big = tf32_rna(x), small = tf32_rna(x - big) (x - big is exact in fp32),
// and C = big_a.big_b + small_a.big_b + big_a.small_b. Products of TF32
// values are exact in the tensor core; the dropped small_a.small_b term
// and small's own rounding are ~2^-22 of each product. The tensor core
// does not round its fp32 accumulator to nearest at every MMA (it drops
// low bits), an error that grows with the number of MMAs summed into one
// accumulator: one accumulator over all of K lands farther from the
// float64 product than torch.matmul's in-order fp32 sum at K = 4096. So
// each stage's 12 MMAs (32 of K) sum into a fresh accumulator that is
// then added, rounded to nearest, into an fp32 total. chip_smoke.py logs
// both against the float64 product: torch.matmul sums K in order and lies
// farther than 2e-4 + 2e-4 |ref| from the exact product at a few dozen of
// the 16.8M outputs at 4096^3, so there this kernel and torch.matmul
// differ by more than that bound too.
// Useful work 137.4 GFLOP at 4096^3 is 412 GFLOP of TF32 MMA: 0.83 ms at
// 495 TFLOP/s, against 2.05 ms for fp32 FMAs at 67. (The alternative,
// three bf16 pieces with the six leading products, costs the same MMA
// time -- 6 passes at 989 vs 3 at 495 -- and was not built.) An operand
// of magnitude above ~3.4e38 * (1 - 2^-12) rounds its big piece to inf.
//
// Design:
//   * a pre-pass (split_rows_kernel, split_cols_kernel) writes each
//     operand's two pieces, K-major (wgmma takes TF32 operands K-major
//     only), into buffers the wrapper allocates: A's as (2, M, Kp), B's
//     transposed through shared memory as (2, N, Kp), Kp = K rounded up to
//     4 with zero columns, so every TMA row stride is a multiple of 16 B;
//   * the main kernel runs persistent CTAs (one per SM) that walk 128 x 128
//     output tiles, grouped 8 tile rows at a time for L2 reuse;
//   * in each CTA one producer warp keeps TMA loads of 32-deep K slices of
//     both pieces of both operands (64 KB a stage, 128-byte swizzle) in
//     flight into a 3-stage shared-memory ring guarded by full/empty
//     mbarriers; the out-of-bounds fill of TMA zero-fills ragged M, N, K;
//   * two consumer warpgroups, each owning 64 rows of the tile, issue
//     wgmma.mma_async m64n128k8 from shared memory (3 a k-step, 12 a
//     stage), release the stage to the producer once its MMAs retire, and
//     add the stage's sum into the fp32 total while the other warpgroup's
//     MMAs run;
//   * the epilogue stores the total straight from registers, predicated on
//     the ragged M and N edges, while the producer already loads the next
//     tile's stages.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // tile rows (M)
constexpr int kBN = 128;        // tile columns (N)
constexpr int kBK = 32;         // K slice a stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 2;   // consumer warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kGroupM = 8;      // tile rows walked together (L2 reuse)
constexpr int kPieceBytes = kBM * kBK * 4;       // 16 KB
constexpr int kStageBytes = 4 * kPieceBytes;     // A big/small, B big/small
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ---- the pre-pass: TF32 pieces, K-major, zero-padded to Kp columns -------

// A (rows, k) row-major -> pieces (2, rows, kp): a block walks whole rows.
__global__ void split_rows_kernel(const float* __restrict__ src,
                                  float* __restrict__ dst, long long rows,
                                  long long k, long long kp) {
  const long long plane = rows * kp;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    for (long long c = threadIdx.x; c < kp; c += blockDim.x) {
      const float x = c < k ? src[r * k + c] : 0.0f;
      const float big = tf32_rna(x);
      dst[r * kp + c] = big;
      dst[plane + r * kp + c] = tf32_rna(x - big);
    }
  }
}

// B (k, cols) row-major -> pieces (2, cols, kp), transposed through a
// 32 x 33 shared tile so both the reads and the writes are coalesced.
__global__ void split_cols_kernel(const float* __restrict__ src,
                                  float* __restrict__ dst, long long k,
                                  long long cols, long long kp) {
  __shared__ float tile[32][33];
  const long long c0 = static_cast<long long>(blockIdx.x) * 32;
  const long long k0 = static_cast<long long>(blockIdx.y) * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const long long kk = k0 + ty + i, cc = c0 + tx;
    tile[ty + i][tx] = (kk < k && cc < cols) ? src[kk * cols + cc] : 0.0f;
  }
  __syncthreads();
  const long long plane = cols * kp;
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const long long cc = c0 + ty + i, kk = k0 + tx;
    if (cc < cols && kk < kp) {
      const float x = tile[tx][ty + i];
      const float big = tf32_rna(x);
      dst[cc * kp + kk] = big;
      dst[plane + cc * kp + kk] = tf32_rna(x - big);
    }
  }
}

// ---- mbarriers, TMA, wgmma ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One 3-D TMA box (32 K x 128 rows x 2 pieces) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k),
      "r"(row), "r"(0)
      : "memory");
}

// wgmma shared-memory descriptor: K-major rows of 128 B in the 128-byte
// swizzle, 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 128 fp32, the warpgroup's fragment) = A (64 x 8) . B (8 x 128)^T
// + (scale_d ? d : 0), both TF32 operands K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The persistent tile walk shared by the producer and the consumers.
struct Tiles {
  int tiles_m, tiles_n;
  __device__ int count() const { return tiles_m * tiles_n; }
  __device__ void coords(int t, int& tm, int& tn) const {
    const int per_group = kGroupM * tiles_n;
    const int first = (t / per_group) * kGroupM;
    const int rows = min(tiles_m - first, kGroupM);
    tm = first + (t % per_group) % rows;
    tn = (t % per_group) / rows;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ c, int m, int n, int k_blocks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const Tiles tiles{(m + kBM - 1) / kBM, (n + kBN - 1) / kBN};
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer warp: one thread issues every TMA load ----------------
    if (threadIdx.x % 32 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
        int tm, tn;
        tiles.coords(t, tm, tn);
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* s = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load(s, &map_a, &full[stage], kb * kBK, tm * kBM);
          tma_load(s + 2 * kPieceBytes, &map_b, &full[stage], kb * kBK,
                   tn * kBN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ------------------------------------------------
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  float acc[64], total[64];  // this stage's MMA sum, the tile's fp32 sum
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
    int tm, tn;
    tiles.coords(t, tm, tn);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.0f;
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint8_t* s = smem + stage * kStageBytes;
      const uint8_t* a_big = s + wg * 64 * 128;  // this warpgroup's 64 rows
      const uint8_t* a_small = a_big + kPieceBytes;
      const uint8_t* b_big = s + 2 * kPieceBytes;
      const uint8_t* b_small = b_big + kPieceBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {  // 8 TF32 = 32 B a k-step
        wgmma_tf32(acc, smem_desc(a_small + 32 * kk),
                   smem_desc(b_big + 32 * kk), kk > 0);
        wgmma_tf32(acc, smem_desc(a_big + 32 * kk),
                   smem_desc(b_small + 32 * kk), 1);
        wgmma_tf32(acc, smem_desc(a_big + 32 * kk),
                   smem_desc(b_big + 32 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[stage]);
      // promote the stage's sum into the fp32 total (see the numerics
      // note above: the accumulator's error grows with its MMA count)
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // fragment (j, half, e): row 16*warp + lane/4 + 8*half, column
    // 8*j + 2*(lane%4) + e of this warpgroup's 64 x 128 block
    const long long row0 =
        static_cast<long long>(tm) * kBM + wg * 64 + warp * 16 + lane / 4;
    const int col0 = tn * kBN + 2 * (lane % 4);
    const bool pairs = (n % 2) == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = row0 + 8 * half;
        if (row >= m || col >= n) continue;
        const float v0 = total[4 * j + 2 * half];
        const float v1 = total[4 * j + 2 * half + 1];
        float* dst = c + row * n + col;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < n) dst[1] = v1;
        }
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API: fetched through the runtime, so
// the library links against nothing but cudart.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one operand's pieces (2, rows, kp): boxes of 32 K x
// 128 rows x both pieces, 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const float* pieces, long long rows,
              long long kp) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kp) * 4,
                                 static_cast<cuuint64_t>(rows * kp) * 4};
  const cuuint32_t box[3] = {kBK, kBM, 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(pieces), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Columns of each piece row: K rounded up to a multiple of 4.
long long matmul_padded_k(long long k) { return (k + 3) / 4 * 4; }

// C = A @ B on `stream` (a cudaStream_t passed as a pointer); A, B and C
// row-major and contiguous, `pieces_a` (2 * m * kp floats) and `pieces_b`
// (2 * n * kp floats) scratch the wrapper allocates, kp =
// matmul_padded_k(k). Runs the split pre-pass, then the tensor-core
// kernel. Returns the first CUDA error (a refused launch never runs and is
// only visible here), or cudaErrorInvalidValue for shapes beyond the
// kernel's 32-bit tile coordinates or a missing tensor-map entry point.
int matmul_f32(const float* a, const float* b, float* c, float* pieces_a,
               float* pieces_b, long long m, long long n, long long k,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0)
    return static_cast<int>(
        cudaMemsetAsync(c, 0, static_cast<size_t>(m * n) * 4, s));
  const long long kp = matmul_padded_k(k);
  if (m > 2147483647LL - kBM || n > 2147483647LL - kBN ||
      kp > 2147483647LL - kBK || (n + 31) / 32 > 2147483647LL ||
      (kp + 31) / 32 > 65535LL)
    return static_cast<int>(cudaErrorInvalidValue);

  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  split_rows_kernel<<<8 * n_sm, 256, 0, s>>>(a, pieces_a, m, k, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_cols_kernel<<<dim3(static_cast<unsigned>((n + 31) / 32),
                           static_cast<unsigned>((kp + 31) / 32)),
                      dim3(32, 8), 0, s>>>(b, pieces_b, k, n, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, pieces_a, m, kp) || !make_map(&map_b, pieces_b, n, kp))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(gemm_3xtf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < n_sm ? tiles : n_sm);
  gemm_3xtf32_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      map_a, map_b, c, static_cast<int>(m), static_cast<int>(n),
      static_cast<int>((kp + kBK - 1) / kBK));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
