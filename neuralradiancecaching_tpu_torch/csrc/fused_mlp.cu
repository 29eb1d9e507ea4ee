// Fused forward of the radiance cache's tiny MLP on Hopper's tensor cores
// (sm_90a) at fp32 accuracy, with a plain C entry point loaded through
// ctypes (neuralradiancecaching_tpu_torch/ops/fused_mlp.py).
//
// Replaces neuralradiancecaching_tpu/ops/pallas_mlp.py:_fused_kernel /
// apply_fused, the Pallas TPU kernel that kept all weights VMEM-resident and
// pushed a 512-row batch tile through every layer without an HBM round trip.
//
// What it computes: ops/mlp.py:apply for in_features == hidden == 64,
// out_features <= 64, any n_layers >= 2 that fits shared memory (7 in the
// f32 mode at out_features <= 8), ReLU or sigmoid after every hidden layer
// and optionally after the output layer, f32 activations and output. Two
// input modes, like the Pallas kernel: fp32 rows, or bf16 rows (the bf16
// query of config 5) with bf16-rounded weights and biases. The bf16 mode is
// the fp32 chain over bf16-rounded inputs, weights and biases -- what JAX's
// dot with preferred_element_type=float32 computes -- not a chain of bf16
// products, which would round every layer.
//
// What bounds it: 41,344 useful FLOP a row against 268 B (fp32 rows) or
// 140 B (bf16 rows) of input and output. The one-thread-a-row fp32 FMA
// kernel this file held before reached 18-20 TFLOP/s, 27-29% of the 67
// TFLOP/s FP32 pipe, with the tensor cores idle. On the tensor cores (989
// TFLOP/s bf16) the same work is bound by memory at 0.02 ms, so what bounds
// this design is the latency of the dependent layer chain of each 64-row
// tile, hidden by running 3 tiles per SM at once.
//
// Numerics, the split bf16 products: every fp32 value v is written as
// three bf16 pieces hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), which sum to v exactly (each residual is exact in fp32 and keeps at
// most 8 significant bits by the last piece). A product of two bf16 pieces
// is exact in the tensor core's fp32 accumulator, so what differs from the
// fp32 chain is the pieces dropped and the order of the fp32 sums:
//   * f32 mode: activations (and the input rows) and weights in three
//     pieces each; the six products of order >= 2^-16 (mid.mid, hi.lo,
//     lo.hi, hi.mid, mid.hi, hi.hi, issued smallest first into one
//     accumulator) -- the three dropped ones are ~2^-25 of each product;
//   * bf16 mode: weights and rows are bf16 already (one piece); layer 0 is
//     one pass, and every later layer splits its fp32 activation in three
//     (lo, mid, hi passes): the fp32 chain with exact products.
// So a row costs 13 (bf16) or 30 (f32) 64x64 MMA passes in the hidden
// layers, plus 3 or 6 of the 64x8 output layer.
//
// Non-finite inputs: splitting +-inf gives hi = +-inf and NaN mid and lo
// pieces, so a row holding NaN or inf gives NaN outputs (a non-finite row,
// as the plain version gives); rows never mix in the products, so other
// rows are untouched. ReLU is written v < 0 ? 0 : v so that NaN propagates.
//
// Design:
//   * the pack step (pack_kernel, one launch per weight set, called by the
//     wrapper's pack_params; its plain version is pack_params_plain) writes
//     the weights' pieces in wgmma's K-major 128-byte-swizzled B layout,
//     and the biases, into one buffer;
//   * persistent blocks, one per SM: the block copies that buffer into
//     shared memory once (cp.async), and its 3 warpgroups each walk their
//     own 64-row tiles;
//   * row tiles come in by cp.async into padded shared rows (conflict-free
//     fragment reads); a tile goes into registers at once, so its buffer
//     takes the warpgroup's next tile while this one computes;
//   * activations stay in registers as wgmma's register-A operand: the fp32
//     accumulator fragment of one m64n64k16 layer, after bias, activation
//     and split, is exactly the A fragment of the next (as FlashAttention-3
//     feeds P to P.V), so activations never touch shared or global memory;
//   * the output layer is one m64n8 MMA (out_features <= 8; m64n64 up to
//     64), and its stores are masked to out_features.
//
// Packed parameter layout (built by the Python wrapper, all offsets
// multiples of 1024 B up to the biases): P = 3 pieces (f32 mode) or 1
// (bf16 mode), NO = 8 (out_features <= 8) or 64;
//   for each hidden layer l:  P pieces of W_l^T, (64 out x 64 in) bf16
//   output layer:             P pieces of W^T, (NO x 64) bf16, zero-padded
//   biases:                   n_hidden x 64 fp32, then NO fp32
// where a (rows x 64) bf16 piece stores element (n, k) at
// n * 64 + ((k / 8) ^ (n % 8)) * 8 + k % 8 (the 128-byte swizzle).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // in_features == hidden
constexpr int kTile = 64;          // rows of a warpgroup's tile
constexpr int kPieceBytes = kD * kD * 2;  // one bf16 piece of a 64x64 layer

// The row types: the x-tile geometry and the pieces of each mode.
template <typename T>
struct Mode;
template <>
struct Mode<float> {
  static constexpr int kRowBytes = 72 * 4;  // 64 floats + 8 of padding
  static constexpr int kPieces = 3;         // weight (and input) pieces
  static constexpr int kWarpgroups = 3;
};
template <>
struct Mode<uint16_t> {                     // bf16 rows as raw 16-bit words
  static constexpr int kRowBytes = 72 * 2;
  static constexpr int kPieces = 1;
  static constexpr int kWarpgroups = 3;
};

__host__ __device__ constexpr long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr long long pack_bytes(int n_hidden, int n_out,
                                                   int pieces) {
  return round_up(static_cast<long long>(n_hidden) * pieces * kPieceBytes +
                      static_cast<long long>(pieces) * n_out * 128 +
                      4LL * (static_cast<long long>(n_hidden) * kD + n_out),
                  16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float activate(float v, int sigmoid) {
  if (sigmoid) return 1.0f / (1.0f + expf(-v));
  return v < 0.0f ? 0.0f : v;  // NaN propagates, like torch.relu
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring fp32 values -> their hi, mid, lo bf16 pairs (the lower
// column in the low half, as the A fragment holds it).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 fh = __bfloat1622float2(h);
  const float r0 = v0 - fh.x, r1 = v1 - fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 fm = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - fm.x, r1 - fm.y));
}

// ---- cp.async, barriers, wgmma ----------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// barrier among the 128 threads of one warpgroup (ids 1..3; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// B descriptor: K-major rows of 64 bf16 (128 B) in the 128-byte swizzle,
// 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x N fp32 fragment) += A (64 x 16 bf16, registers) . B (N x 16).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One pass: the 64 x 64 activation piece `a` (4 k-steps of 16) times one
// weight piece (N x 64, swizzled) into d.
template <int N>
__device__ __forceinline__ void mma_pass(float (&d)[N / 2],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* w) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_bf16<N>(d, a[ks], smem_desc(w + 32 * ks));
}

// One layer's MMAs: acc = act pieces x weight pieces, by the mode's passes
// (kFirst: the bf16 mode's layer 0, one pass over the bf16 rows). Every
// branch is resolved at compile time: a wgmma under a runtime branch makes
// ptxas serialize them. `piece_bytes` is one weight piece's size.
template <typename T, int N, bool kFirst>
__device__ __forceinline__ void layer_mma(float (&acc)[N / 2],
                                          const uint32_t (&a)[3][4][4],
                                          const uint8_t* w, int piece_bytes) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  wgmma_fence();
  if constexpr (Mode<T>::kPieces == 3) {  // f32 mode: the six leading products
    mma_pass<N>(acc, a[1], w + 1 * piece_bytes);  // mid.mid
    mma_pass<N>(acc, a[0], w + 2 * piece_bytes);  // hi.lo
    mma_pass<N>(acc, a[2], w);                    // lo.hi
    mma_pass<N>(acc, a[0], w + 1 * piece_bytes);  // hi.mid
    mma_pass<N>(acc, a[1], w);                    // mid.hi
    mma_pass<N>(acc, a[0], w);                    // hi.hi
  } else if constexpr (kFirst) {  // bf16 mode, layer 0: bf16 rows, one pass
    mma_pass<N>(acc, a[0], w);
  } else {  // bf16 mode: split activations, exact bf16 weights
    mma_pass<N>(acc, a[2], w);
    mma_pass<N>(acc, a[1], w);
    mma_pass<N>(acc, a[0], w);
  }
  wgmma_commit();
  wgmma_wait_all();
}

// A hidden layer's epilogue in registers: bias, activation and the split
// of accumulator block j = 2 s + h (columns 8 j + c + {0, 1}, rows r and
// r + 8) into the A-fragment register [s][2 h + half] of every piece.
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[32],
                                                const float* b, int c,
                                                int sigmoid,
                                                uint32_t (&a)[3][4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * s + h;
      const float2 bb = *reinterpret_cast<const float2*>(b + 8 * j + c);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        split3(activate(acc[4 * j + 2 * half] + bb.x, sigmoid),
               activate(acc[4 * j + 2 * half + 1] + bb.y, sigmoid),
               a[0][s][2 * h + half], a[1][s][2 * h + half],
               a[2][s][2 * h + half]);
    }
}

// The tile's rows from global memory into a padded shared buffer; rows past
// the end are zero-filled and never read from global memory.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x,
                                          long long row0, long long n_rows,
                                          uint8_t* buf, int tid) {
  constexpr int kChunks = kD * static_cast<int>(sizeof(T)) / 16;
  const uint8_t* base = reinterpret_cast<const uint8_t*>(x);
#pragma unroll
  for (int i = tid; i < kTile * kChunks; i += 128) {
    const int row = i / kChunks, ch = i % kChunks;
    const long long g = row0 + row;
    const bool valid = g < n_rows;
    cp_async16(buf + row * Mode<T>::kRowBytes + ch * 16,
               base + (valid ? g : 0) * kD * sizeof(T) + ch * 16, valid);
  }
}

// The A fragment of the input rows: thread (warp, lane) holds rows
// r = 16 warp + lane / 4 and r + 8, columns 16 s + 8 h + c + {0, 1},
// c = 2 (lane % 4), as register [s][2 h + half].
__device__ __forceinline__ void input_fragment(const uint8_t* buf, int r,
                                               int c, uint32_t (&a)[3][4][4],
                                               float) {
  const float* xs = reinterpret_cast<const float*>(buf);
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 v = *reinterpret_cast<const float2*>(
            xs + (r + 8 * half) * 72 + 16 * s + 8 * h + c);
        split3(v.x, v.y, a[0][s][2 * h + half], a[1][s][2 * h + half],
               a[2][s][2 * h + half]);
      }
}

__device__ __forceinline__ void input_fragment(const uint8_t* buf, int r,
                                               int c, uint32_t (&a)[3][4][4],
                                               uint16_t) {
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(buf);
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        a[0][s][2 * h + half] = *reinterpret_cast<const uint32_t*>(
            xs + (r + 8 * half) * 72 + 16 * s + 8 * h + c);
}

template <typename T, int kNout>
__global__ void __launch_bounds__(Mode<T>::kWarpgroups * 128, 1)
fused_mlp_kernel(const T* __restrict__ x, const uint8_t* __restrict__ pack,
                 float* __restrict__ out, long long n_rows, int n_hidden,
                 int out_features, int sigmoid, int output_act) {
  using M = Mode<T>;
  constexpr int kTileBytes = kTile * M::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const long long n_pack = pack_bytes(n_hidden, kNout, M::kPieces);
  uint8_t* tile_buf = smem + round_up(n_pack, 128) + wg * kTileBytes;
  const long long n_tiles = (n_rows + kTile - 1) / kTile;
  const long long stride =
      static_cast<long long>(gridDim.x) * M::kWarpgroups;
  long long tile = static_cast<long long>(blockIdx.x) * M::kWarpgroups + wg;

  // the weight pieces and biases, once per block, and each warpgroup's
  // first tile, all in flight together; wgmma reads the weights through
  // the async proxy, so they are fenced for it once they have landed
  for (int i = threadIdx.x; i < n_pack / 16; i += blockDim.x)
    cp_async16(smem + 16 * i, pack + 16 * i, true);
  if (tile < n_tiles) load_tile(x, tile * kTile, n_rows, tile_buf, tid);
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const long long out_off =
      static_cast<long long>(n_hidden) * M::kPieces * kPieceBytes;
  const uint8_t* w_out = smem + out_off;
  const float* bias = reinterpret_cast<const float*>(
      smem + out_off + M::kPieces * kNout * 128);

  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  for (; tile < n_tiles; tile += stride) {
    // the tile goes into registers at once, so its buffer takes the next
    // tile's copies while this one computes
    cp_async_wait<0>();
    warpgroup_sync(1 + wg);
    uint32_t a[3][4][4];
    input_fragment(tile_buf, r, c, a, T());
    warpgroup_sync(1 + wg);
    if (tile + stride < n_tiles)
      load_tile(x, (tile + stride) * kTile, n_rows, tile_buf, tid);
    cp_async_commit();

    {
      float acc[32];
      layer_mma<T, 64, true>(acc, a, smem, kPieceBytes);
      hidden_epilogue(acc, bias, c, sigmoid, a);
    }
    for (int l = 1; l < n_hidden; ++l) {
      float acc[32];
      layer_mma<T, 64, false>(acc, a, smem + l * M::kPieces * kPieceBytes,
                              kPieceBytes);
      hidden_epilogue(acc, bias + l * kD, c, sigmoid, a);
    }

    float acc[kNout / 2];
    layer_mma<T, kNout, false>(acc, a, w_out, kNout * 128);
    const float* b = bias + n_hidden * kD;
#pragma unroll
    for (int j = 0; j < kNout / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = tile * kTile + r + 8 * half;
        if (row >= n_rows) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + c + e;
          if (col >= out_features) continue;
          const float v = acc[4 * j + 2 * half + e] + b[col];
          out[row * out_features + col] = output_act ? activate(v, sigmoid) : v;
        }
      }
  }
  cp_async_wait<0>();
}

// ---- the pack step -------------------------------------------------------

constexpr int kMaxLayers = 32;

// The parameters' addresses, passed by value: W_l (64 x cols) and b_l
// (cols), row-major, fp32 or (params_bf16) bf16 words.
struct Params {
  const void* w[kMaxLayers];
  const void* b[kMaxLayers];
};

__device__ __forceinline__ float param(const void* p, long long i,
                                       int params_bf16) {
  if (params_bf16)
    return __uint_as_float(
        static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i]) << 16);
  return static_cast<const float*>(p)[i];
}

// Writes the packed buffer (layout above) of one weight set, each thread
// one bf16 word of a piece or one fp32 bias: the weight at that swizzled
// position, rounded to bf16 first in the bf16 mode, split as split3 splits
// an activation, and the piece's share kept. Bit for bit the layout of the
// wrapper's plain pack (fused_mlp.pack_params_plain).
__global__ void pack_kernel(Params prm, uint8_t* __restrict__ out,
                            int n_hidden, int out_features, int n_out,
                            int pieces, int round_bf16, int params_bf16) {
  const long long per_layer = static_cast<long long>(pieces) * kD * kD;
  const long long w_hidden = n_hidden * per_layer;
  const long long w_total = w_hidden + static_cast<long long>(pieces) *
                                           n_out * kD;
  const long long b_total = round_up(
      static_cast<long long>(n_hidden) * kD + n_out, 4);  // + the 16-B pad
  uint16_t* wout = reinterpret_cast<uint16_t*>(out);
  float* bout = reinterpret_cast<float*>(out + 2 * w_total);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < w_total + b_total; i += stride) {
    if (i >= w_total) {  // a bias, or the zero pad after them
      const long long j = i - w_total;
      const int layer = j < static_cast<long long>(n_hidden) * kD
                            ? static_cast<int>(j / kD) : n_hidden;
      const int n = static_cast<int>(j - static_cast<long long>(layer) * kD);
      const int cols = layer < n_hidden ? kD : out_features;
      float v = (layer <= n_hidden && n < cols)
                    ? param(prm.b[layer], n, params_bf16) : 0.0f;
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      bout[j] = v;
      continue;
    }
    int layer, piece;
    long long j = i;
    if (j < w_hidden) {
      layer = static_cast<int>(j / per_layer);
      j -= layer * per_layer;
      piece = static_cast<int>(j / (kD * kD));
      j -= static_cast<long long>(piece) * kD * kD;
    } else {
      layer = n_hidden;
      j -= w_hidden;
      piece = static_cast<int>(j / (n_out * kD));
      j -= static_cast<long long>(piece) * n_out * kD;
    }
    const int n = static_cast<int>(j / kD), kk = static_cast<int>(j % kD);
    const int k = (((kk >> 3) ^ (n & 7)) << 3) | (kk & 7);  // unswizzled
    const int cols = layer < n_hidden ? kD : out_features;
    float v = n < cols ? param(prm.w[layer], static_cast<long long>(k) * cols
                                                 + n, params_bf16)
                       : 0.0f;
    if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    uint32_t hi, mid, lo;
    split3(v, 0.0f, hi, mid, lo);
    const uint32_t word = piece == 0 ? hi : (piece == 1 ? mid : lo);
    wout[i] = static_cast<uint16_t>(word & 0xffffu);
  }
}

long long smem_bytes(int n_hidden, int n_out, int in_bf16) {
  const int pieces = in_bf16 ? Mode<uint16_t>::kPieces : Mode<float>::kPieces;
  const long long bufs =
      in_bf16 ? 1LL * Mode<uint16_t>::kWarpgroups * kTile *
                    Mode<uint16_t>::kRowBytes
              : 1LL * Mode<float>::kWarpgroups * kTile * Mode<float>::kRowBytes;
  return round_up(pack_bytes(n_hidden, n_out, pieces), 128) + bufs + 1024;
}

template <typename T, int kNout>
cudaError_t launch(const T* x, const uint8_t* pack, float* out,
                   long long n_rows, int n_hidden, int out_features,
                   int sigmoid, int output_act, int device,
                   cudaStream_t stream) {
  const long long smem = smem_bytes(n_hidden, kNout, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, kNout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (n_rows <= 0) return cudaSuccess;
  const long long tiles = (n_rows + kTile - 1) / kTile;
  const long long blocks =
      (tiles + Mode<T>::kWarpgroups - 1) / Mode<T>::kWarpgroups;
  const int grid = static_cast<int>(blocks < n_sm ? blocks : n_sm);
  fused_mlp_kernel<T, kNout>
      <<<grid, Mode<T>::kWarpgroups * 128, static_cast<size_t>(smem),
         stream>>>(x, pack, out, n_rows, n_hidden, out_features, sigmoid,
                   output_act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of the packed output layer: 8 for out_features <= 8, else 64.
int fused_mlp_out_cols(int out_features) { return out_features <= 8 ? 8 : 64; }

// Bytes of the packed weights (the wrapper's pack step writes exactly this
// many) and of the dynamic shared memory one block needs.
long long fused_mlp_pack_bytes(int n_hidden, int out_features, int in_bf16) {
  return pack_bytes(n_hidden, fused_mlp_out_cols(out_features),
                    in_bf16 ? 1 : 3);
}
long long fused_mlp_smem_bytes(int n_hidden, int out_features, int in_bf16) {
  return smem_bytes(n_hidden, fused_mlp_out_cols(out_features), in_bf16);
}

// Writes the packed weights of one weight set into `out`
// (fused_mlp_pack_bytes bytes) on `stream`: `w` and `b` hold the n_hidden
// + 1 layers' parameter addresses, fp32 or (params_bf16) bf16, row-major
// and contiguous; in the bf16 mode (in_bf16) the values are rounded to
// bf16 and packed as one piece. Returns the launch's CUDA error.
int fused_mlp_pack(const void* const* w, const void* const* b, void* out,
                   int n_hidden, int out_features, int in_bf16,
                   int params_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_hidden + 1 > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  Params prm = {};
  for (int l = 0; l <= n_hidden; ++l) {
    prm.w[l] = w[l];
    prm.b[l] = b[l];
  }
  const int n_out = fused_mlp_out_cols(out_features);
  const int pieces = in_bf16 ? 1 : 3;
  const long long work = pack_bytes(n_hidden, n_out, pieces) / 2;
  const long long blocks = (work + 255) / 256;
  pack_kernel<<<static_cast<int>(blocks < 1024 ? blocks : 1024), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      prm, static_cast<uint8_t*>(out), n_hidden, out_features, n_out, pieces,
      in_bf16, params_bf16);
  return static_cast<int>(cudaGetLastError());
}

// Launches the forward on `stream` (a cudaStream_t passed as a pointer);
// `x` holds fp32 rows, or bf16 rows when `in_bf16` is nonzero; `pack` is
// the packed weight buffer of that mode. Returns cudaGetLastError() after
// the launch: a refused launch (too much shared memory, bad configuration)
// never runs and is only visible here.
int fused_mlp_forward(const void* x, const void* pack, float* out,
                      long long n_rows, int n_hidden, int out_features,
                      int sigmoid, int output_act, int in_bf16, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(pack);
  const bool narrow = out_features <= 8;
  if (in_bf16) {
    const uint16_t* xb = static_cast<const uint16_t*>(x);
    err = narrow ? launch<uint16_t, 8>(xb, p, out, n_rows, n_hidden,
                                       out_features, sigmoid, output_act,
                                       device, s)
                 : launch<uint16_t, 64>(xb, p, out, n_rows, n_hidden,
                                        out_features, sigmoid, output_act,
                                        device, s);
  } else {
    const float* xf = static_cast<const float*>(x);
    err = narrow ? launch<float, 8>(xf, p, out, n_rows, n_hidden,
                                    out_features, sigmoid, output_act, device,
                                    s)
                 : launch<float, 64>(xf, p, out, n_rows, n_hidden,
                                     out_features, sigmoid, output_act,
                                     device, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
