// HiFi-GAN ResBlock1 for Hopper (sm_90a): three passes of
//   h += conv2(leaky(conv1_d(leaky(h) * mask) + b1) * mask) + b2
// on x [B, T, C] (f32 or bf16), f32 accumulation, SAME zero padding at the
// sequence edges (the mask zeroes every conv input outside [0, T)).
//
// Replaces tts_arabic_tpu/ops/hifigan_pallas.py::resblock_pallas (the wide
// variant, C >= 64: `_resblock_kernel` with `_unfold_matmul`) and
// ::resblock_pallas_packed (the narrow variant, C <= 32: `_packed_kernel`).
// Both compute what `_resblock_kernel` computes; the TPU's lane packing is
// not carried over. Rounding as there: every conv output is rounded to the
// storage type after its f32 bias add, and so are each leaky and each
// residual sum.
//
// Two designs, one per storage type.
//
// bf16 (the serving path): implicit-GEMM convs on the tensor cores.
// Each conv is out[t, co] = sum_j sum_ci A[t + (j - r)*d, ci] * W[j, ci, co],
// a GEMM with M = time rows, N = C_out, K = k*C_in. The A operand of tap j is
// the staged bf16 activation tile read j*d rows further down; `ldmatrix`
// takes one row address per lane, so the shift costs nothing and no im2col
// is written. `mma.sync.m16n8k16` (bf16 in, f32 accumulate) rather than
// `wgmma`: a wgmma shared-memory descriptor wants its A tile aligned to the
// swizzle atom, which a shift of (j - r)*d rows breaks, and wgmma with A in
// registers would still need these ldmatrix loads.
// - Tiles: 8 warps; the activation tiles are bf16 in shared memory with rows
//   padded by 16 bytes (kPad), so the 8 row addresses of an ldmatrix fall in
//   8 different bank groups.
// - Weights: the [k*C_in, C_out] matrix of each conv streams through shared
//   memory in K slices (kStages-deep ring of cp.async copies), the next slices
//   loading while the current one is multiplied; the stream runs on across
//   the block's convs, so conv2's first slices land during conv1.
// - Wide (C = 256/128/64): one pass per launch, as in the f32 design below.
//   A block computes both convs over BM = 128/256/512 GEMM rows (warps
//   2x4 / 4x2 / 8x1, 64x64 per warp: 128 f32 accumulators a thread) and
//   writes the BM - 2r rows whose conv2 inputs it has. leaky(x)*mask is
//   staged once; conv1's output Z overwrites it once every warp is done
//   with it (the accumulators hold the whole conv), conv2's rounded output
//   is staged over Z, and the residual add reads x again, coalesced.
//   Budget at k = 11, d = 5 (largest): C = 256: A (128 + 50 rows) * 528 B
//   = 93,984 B + 3 slices of 64 x 256 (33,792 B each) = 195,360 B;
//   C = 128: 306 * 272 + 3 * 17,408 = 135,456 B; C = 64: 562 * 144 +
//   3 * 9,216 = 108,576 B; of the 232,448 a block may use.
// - Narrow (C = 32, also 16 and 64): the whole ResBlock in one launch over a
//   tile of 512 rows (256 at C = 64) with 60-row halos at k = 11, in two bf16
//   buffers: the residual stream h and one buffer that holds leaky(h)*mask
//   for conv1 and then conv1's output for conv2. Warps split the m-tiles
//   (warp w takes w, w + 8, ...) and all of N; each conv's accumulators stay
//   in registers until every warp is done reading its input, so the output
//   can overwrite it. Budget at C = 32, k = 11: 2 * (512 + 120 + 16 rows)
//   * 80 B = 103,680 B + 3 slices of 128 x 32 (10,240 B) = 134,400 B.
// What bounds it: the operations (12 k C^2 FLOPs per row and pass set;
// x in and y out at 3.35 TB/s take less than the FLOPs at 989 TFLOP/s).
// Each block re-reads the weights from L2 once per conv, BM FLOPs per weight
// byte at M = BM rows, which keeps L2 off the critical path at BM >= 128;
// the halo rows (2r of BM wide, up to 12r of 512 narrow) are recomputed.
// What holds it below the bound (measured on an H100, see PERF.md): the
// main loop sustains about a quarter of the bf16 peak within a wave, and
// loading the next K step's fragments ahead of the current mma (with the
// m-tile guards as branches or as predicates) did not raise it. mma.sync
// does not reach wgmma's rate, and a wgmma warpgroup reads each B tile
// once for four warps where here every warp loads its own (the ldmatrix
// traffic, 128 B per mma at 64x64 a warp, is shared memory's whole rate at
// one mma per clock). Besides: one 8-warp block per SM leaves the tensor
// cores idle while x is staged and during the epilogues, and the grid's
// last wave runs part-full (C = 256 at 256 frames: 144 blocks, 132 SMs).
//
// f32 (compute_dtype=None, and the checks at 1e-4): the first design, kept
// as it was. Every FLOP a scalar fmaf on the f32 CUDA cores:
// - one block per (time tile, batch row), 256 threads; thread (co, ty) owns
//   output channel co and every ny-th chunk of ROWS consecutive time rows,
//   so weight reads [k, C_in, C_out] are coalesced over co and each weight
//   value feeds ROWS FMAs from registers;
// - the haloed input tile is staged once in shared memory as f32;
//   activations are read as float4 broadcasts (every thread of a warp reads
//   the same row), so shared memory has no bank conflicts.
// Shared memory decides its variants. A whole fused ResBlock at k=11 needs a
// halo of 60 rows per side and a residual buffer beside two conv buffers:
// three [tile + 120, C] f32 buffers, over 227 KB at C=256. So:
// - wide (C >= 64): one pass per launch (halo <= 30 rows), two buffers,
//   three launches per ResBlock, the residual read from global memory.
//   C=256, tile 32, k=11: (98 + 48) rows * 1 KB = 146 KB.
// - narrow (C <= 32, and C=64 for the checks): all three passes fused in
//   one launch, three buffers. C=32, tile 128, k=11: 3 * 264 rows * 128 B
//   = 101 KB; C=64, tile 64: 3 * 200 * 256 B = 154 KB.
// Its weights stay in global memory and L2. It is bound by the f32 FLOPs
// (67 TFLOP/s peak), with ~1.5 shared-memory loads per 4 FMAs.
//
// C interface for ctypes: pointers and the stream as void*, the return
// value is cudaGetLastError() after the launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // time rows per thread per chunk
constexpr float kSlope = 0.1f;     // LRELU_SLOPE
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// v rounded to the storage type T, kept as f32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename T> __device__ __forceinline__ float leaky(float v) {
  return rnd<T>(v > 0.f ? v : v * kSlope);
}

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// ---- f32: the CUDA-core kernels ---------------------------------------------

// acc[r] += sum_j sum_ci src[(r + j*step) * C + ci] * w[(j*C + ci)*C + co]
// for kRows consecutive output rows; src points at the row that output row
// 0 reads through tap 0. The order of the sum is fixed (taps, then input
// channels), so a row's value does not depend on its tile.
template <typename T>
__device__ __forceinline__ void conv_rows(float (&acc)[kRows],
                                          const float* src,
                                          const T* __restrict__ w, int C,
                                          int k, int step, int co) {
  for (int j = 0; j < k; ++j) {
    const float* s = src + j * step * C;
    const T* wj = w + (size_t)j * C * C + co;
    for (int ci = 0; ci < C; ci += 4) {
      const float w0 = to_f(wj[(size_t)(ci + 0) * C]);
      const float w1 = to_f(wj[(size_t)(ci + 1) * C]);
      const float w2 = to_f(wj[(size_t)(ci + 2) * C]);
      const float w3 = to_f(wj[(size_t)(ci + 3) * C]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(s + r * C + ci);
        float v = acc[r];
        v = fmaf(a.x, w0, v);
        v = fmaf(a.y, w1, v);
        v = fmaf(a.z, w2, v);
        v = fmaf(a.w, w3, v);
        acc[r] = v;
      }
    }
  }
}

// conv1 over `n_rows` rows (a multiple of kRows) into dst:
//   dst[i] = mask(t0 + i) * leaky(rnd(b1 + conv1_d(src)[i]))
// src row i + j*d is tap j of output row i.
template <typename T>
__device__ void conv1_stage(float* dst, const float* src, const T* w,
                            const float* b, int C, int k, int d, int n_rows,
                            int t0, int T_len) {
  const int co = threadIdx.x % C, ty = threadIdx.x / C;
  const int ny = blockDim.x / C;
  const float bias = b[co];
  for (int i0 = ty * kRows; i0 < n_rows; i0 += ny * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    conv_rows<T>(acc, src + (size_t)i0 * C, w, C, k, d, co);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + i0 + r;
      const bool in = t >= 0 && t < T_len;
      dst[(size_t)(i0 + r) * C + co] = in ? leaky<T>(rnd<T>(acc[r] + bias))
                                          : 0.f;
    }
  }
}

// One pass per launch (wide variant): y = x + conv2(leaky(conv1_d(leaky(x)
// * mask) + b1) * mask) + b2 for the output rows [t0, t0 + tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock1_pass_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      int T_len, int C, int k, int d, int tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = (k - 1) / 2;
  const int h1 = r * d, h2 = r;
  const int nz = round_up(tile + 2 * h2, kRows);
  const int na = nz + 2 * h1;
  float* A = smem;                      // [na, C]: leaky(x) * mask
  float* Z = smem + (size_t)na * C;     // [nz, C]: conv1 output
  const int t0 = blockIdx.x * tile;
  const size_t base = (size_t)blockIdx.y * T_len * C;
  const T* xb = x + base;
  T* yb = y + base;

  const int a0 = t0 - h2 - h1;          // time of A row 0
  for (int idx = threadIdx.x; idx < na * C; idx += blockDim.x) {
    const int t = a0 + idx / C;
    A[idx] = (t >= 0 && t < T_len)
                 ? leaky<T>(to_f(xb[(size_t)t * C + idx % C])) : 0.f;
  }
  __syncthreads();
  conv1_stage<T>(Z, A, w1, b1, C, k, d, nz, t0 - h2, T_len);
  __syncthreads();

  const int co = threadIdx.x % C, ty = threadIdx.x / C;
  const int ny = blockDim.x / C;
  const float bias = b2[co];
  for (int i0 = ty * kRows; i0 < tile; i0 += ny * kRows) {
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
    conv_rows<T>(acc, Z + (size_t)i0 * C, w2, C, k, 1, co);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int t = t0 + i0 + q;
      if (t < T_len) {
        const size_t o = (size_t)t * C + co;
        yb[o] = from_f<T>(to_f(xb[o]) + rnd<T>(acc[q] + bias));
      }
    }
  }
}

struct Dilations {
  int n;
  int d[4];
};

// The whole ResBlock in one launch (narrow variant). Buffers are indexed by
// window row w, time t = t0 - H + w, H the summed halo of all passes; each
// pass shrinks the valid margin e by r*(d + 1). Rows computed past a valid
// range (chunk rounding) read stale but finite values and only feed rows
// that are discarded, as in the Pallas kernel's overlap-discard.
template <typename T>
__global__ void __launch_bounds__(kThreads)
resblock1_fused_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const T* __restrict__ w1,
                       const float* __restrict__ b1,
                       const T* __restrict__ w2,
                       const float* __restrict__ b2, int T_len, int C, int k,
                       Dilations dil, int tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) H += r * (dil.d[p] + 1);
  const int nw = tile + 2 * H;
  const int nb = nw + kRows;            // slack for rounded chunks
  float* Hb = smem;                     // residual stream h
  float* A = Hb + (size_t)nb * C;       // leaky(h) * mask
  float* Z = A + (size_t)nb * C;        // conv1 output
  const int t0 = blockIdx.x * tile;
  const int w0 = t0 - H;                // time of window row 0
  const size_t base = (size_t)blockIdx.y * T_len * C;
  const T* xb = x + base;
  T* yb = y + base;

  for (int idx = threadIdx.x; idx < nb * C; idx += blockDim.x) {
    const int w = idx / C, t = w0 + w;
    Hb[idx] = (w < nw && t >= 0 && t < T_len)
                  ? to_f(xb[(size_t)t * C + idx % C]) : 0.f;
    Z[idx] = 0.f;
  }
  const int co = threadIdx.x % C, ty = threadIdx.x / C;
  const int ny = blockDim.x / C;
  int e = H;                            // valid margin of Hb on each side
  for (int p = 0; p < dil.n; ++p) {
    const int d = dil.d[p];
    const int e_out = e - r * (d + 1);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * C; idx += blockDim.x) {
      const int w = idx / C, t = w0 + w;
      A[idx] = (w < nw && t >= 0 && t < T_len) ? leaky<T>(Hb[idx]) : 0.f;
    }
    __syncthreads();
    // conv1 rows [lo_z, lo_z + nz): row w reads A[w + (j - r)*d]
    const int lo_z = H - e_out - r;
    const int nz = round_up(tile + 2 * (e_out + r), kRows);
    conv1_stage<T>(Z + (size_t)lo_z * C, A + (size_t)(lo_z - r * d) * C,
                   w1 + (size_t)p * k * C * C, b1 + p * C, C, k, d, nz,
                   w0 + lo_z, T_len);
    __syncthreads();
    // conv2 + residual on rows [lo_h, lo_h + nh): row w reads Z[w + j - r]
    const int lo_h = H - e_out;
    const int nh = round_up(tile + 2 * e_out, kRows);
    const T* w2p = w2 + (size_t)p * k * C * C;
    const float bias = b2[p * C + co];
    for (int i0 = ty * kRows; i0 < nh; i0 += ny * kRows) {
      float acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
      conv_rows<T>(acc, Z + (size_t)(lo_h + i0 - r) * C, w2p, C, k, 1, co);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        float* h = Hb + (size_t)(lo_h + i0 + q) * C + co;
        *h = rnd<T>(*h + rnd<T>(acc[q] + bias));
      }
    }
    e = e_out;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < tile * C; idx += blockDim.x) {
    const int t = t0 + idx / C;
    if (t < T_len) yb[(size_t)t * C + idx % C] = from_f<T>(Hb[H * C + idx]);
  }
}

bool shape_ok(int C, int k, int tile) {
  return C >= 4 && C % 4 == 0 && kThreads % C == 0 && k >= 1 && k % 2 == 1 &&
         tile > 0 && tile % kRows == 0;
}

int launch_pass_f32(const void* x, void* y, const void* w1, const void* b1,
                    const void* w2, const void* b2, int B, int T_len, int C,
                    int k, int d, int tile, cudaStream_t stream) {
  const int r = (k - 1) / 2;
  const int nz = round_up(tile + 2 * r, kRows);
  const size_t smem = (size_t)(nz + nz + 2 * r * d) * C * sizeof(float);
  if (!shape_ok(C, k, tile) || d < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_pass_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  resblock1_pass_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), T_len,
      C, k, d, tile);
  return (int)cudaGetLastError();
}

int launch_fused_f32(const void* x, void* y, const void* w1, const void* b1,
                     const void* w2, const void* b2, int B, int T_len, int C,
                     int k, Dilations dil, int tile, cudaStream_t stream) {
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) H += r * (dil.d[p] + 1);
  const size_t smem = (size_t)3 * (tile + 2 * H + kRows) * C * sizeof(float);
  if (!shape_ok(C, k, tile) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_fused_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  resblock1_fused_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), T_len,
      C, k, dil, tile);
  return (int)cudaGetLastError();
}

// ---- bf16: the tensor-core kernels ------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kPad = 8;       // bf16 elements (16 B) after each smem row
constexpr int kStages = 3;    // weight slices in the cp.async ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// two bf16 values in one word: leaky each, or the rounded sums a + b
__device__ __forceinline__ uint32_t leaky2(uint32_t v) {
  return pack2(leaky<bf16>(lo_f(v)), leaky<bf16>(hi_f(v)));
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return pack2(lo_f(a) + lo_f(b), hi_f(a) + hi_f(b));
}
__device__ __forceinline__ uint4 leaky8(uint4 v) {
  return make_uint4(leaky2(v.x), leaky2(v.y), leaky2(v.z), leaky2(v.w));
}
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                    add2(a.w, b.w));
}

// The weights of one launch as one stream of K slices. Conv c (pass c / 2,
// conv1 if c is even, else conv2) is a [k*C_in, C_out] matrix, cut into
// slices of KS rows (the conv's last one maybe shorter); slice g of the
// launch lands in ring stage g % kStages, rows padded to C + kPad.
template <int C, int KS>
struct WeightStream {
  const bf16* w1;      // [n_d, k, C_in, C_out]
  const bf16* w2;
  int kc;              // k * C: rows of one conv
  int per_conv;        // slices per conv
  int total;           // slices of the launch
  bf16* ring;          // [kStages][KS][C + kPad]

  __device__ const bf16* stage(int g) const {
    return ring + (g % kStages) * KS * (C + kPad);
  }

  // cp.async of slice g (nothing past the last); always one commit group
  __device__ void load(int g) const {
    if (g < total) {
      const int c = g / per_conv, s = g - c * per_conv;
      const int rows = min(KS, kc - s * KS);
      const bf16* src =
          ((c & 1) ? w2 : w1) + ((size_t)(c >> 1) * kc + s * KS) * C;
      bf16* dst = ring + (g % kStages) * KS * (C + kPad);
      constexpr int kChunks = C / 8;   // 16-byte chunks in a row
      for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
        const int row = i / kChunks, ch = i - row * kChunks;
        cp_async16(dst + row * (C + kPad) + ch * 8,
                   src + (size_t)row * C + ch * 8);
      }
    }
    cp_async_commit();
  }
};

// One conv as an implicit GEMM. The warp owns m-tiles mt = m_base +
// i * m_stride (i < MT, mt < n_mt) and n-tiles n_base / 8 + n (n < NT);
// acc[i][n] += sum over the conv's K rows (tap j, input channel ci) of
// act[row0 + 16 * mt + (row) + j * step][ci] * W[j * C + ci][col]. act is a
// bf16 smem tile, rows C + kPad apart. The conv's slices are g, g + 1, ...
// of the stream; `g` is advanced past them. Each slice starts with a block
// barrier, which also publishes the writes made to act before the call.
template <int C, int KS, int MT, int NT>
__device__ __forceinline__ void conv_mma(float (&acc)[MT][NT][4],
                                         const bf16* act, int row0, int step,
                                         int m_base, int m_stride, int n_mt,
                                         int n_base,
                                         const WeightStream<C, KS>& ws,
                                         int& g) {
  constexpr int S = C + kPad;
  const int lane = threadIdx.x & 31;
  // lane l addresses row (l & 15), column block (l >> 4) of a 16x16 tile
  const uint32_t a_lane =
      smem_u32(act + (row0 + (lane & 15)) * S + (lane >> 4) * 8);
  const int b_lane = (lane & 15) * S + n_base + (lane >> 4) * 8;
  for (int s = 0; s < ws.per_conv; ++s, ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // slice g landed; stage g - 1 free
    ws.load(g + kStages - 1);
    const int rows = min(KS, ws.kc - s * KS);
    const uint32_t b_stage = smem_u32(ws.stage(g) + b_lane);
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      if (kk >= rows) break;
      const int kg = s * KS + kk;
      const int tap = kg / C, ci = kg - tap * C;
      uint32_t b[NT][2];
#pragma unroll
      for (int nb = 0; nb < NT / 2; ++nb) {
        uint32_t q[4];
        ldmatrix_x4_trans(q, b_stage + (kk * S + nb * 16) * 2);
        b[2 * nb][0] = q[0];
        b[2 * nb][1] = q[1];
        b[2 * nb + 1][0] = q[2];
        b[2 * nb + 1][1] = q[3];
      }
      const uint32_t a_k = a_lane + (tap * step * S + ci) * 2;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = m_base + i * m_stride;
        if (mt < n_mt) {
          uint32_t a[4];
          ldmatrix_x4(a, a_k + mt * 16 * S * 2);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_bf16(acc[i][n], a, b[n][0], b[n][1]);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
}

// Calls f(i, n, h, row, col) for each accumulator pair the thread holds:
// acc[i][n][2h], acc[i][n][2h + 1] are (row, col) and (row, col + 1) of
// the conv's output, row counted from the first m-tile's first row.
template <int MT, int NT, typename F>
__device__ __forceinline__ void for_each_pair(int m_base, int m_stride,
                                              int n_mt, int n_base, F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = m_base + i * m_stride;
    if (mt >= n_mt) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(i, n, h, mt * 16 + (lane >> 2) + 8 * h,
          n_base + n * 8 + 2 * (lane & 3));
  }
}

// Wide variant, one pass per launch: GEMM rows kRowsM of both convs, warps
// kWarpsM x kWarpsN of 64 x 64.
template <int C>
struct Wide {
  static constexpr int kWarpsN = C / 64;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kRowsM = kWarpsM * 64;
  static constexpr int KS = 64;
  static size_t smem(int k, int d) {
    return ((size_t)(kRowsM + (k - 1) * d) + kStages * KS) * (C + kPad) * 2;
  }
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
resblock1_pass_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                          const bf16* __restrict__ w1,
                          const float* __restrict__ b1,
                          const bf16* __restrict__ w2,
                          const float* __restrict__ b2, int T_len, int k,
                          int d) {
  using W = Wide<C>;
  constexpr int BM = W::kRowsM, S = C + kPad, KS = W::KS;
  constexpr int kChunks = C / 8;
  extern __shared__ uint4 smem_v[];
  bf16* act = reinterpret_cast<bf16*>(smem_v);
  const int r = (k - 1) / 2;
  const int na = BM + 2 * r * d;        // rows of leaky(x) * mask
  const int per_conv = (k * C + KS - 1) / KS;
  const WeightStream<C, KS> ws{w1, w2, k * C, per_conv, 2 * per_conv,
                               act + na * S};
  for (int g = 0; g < kStages - 1; ++g) ws.load(g);

  // conv1 rows i <-> time t0 - r + i, act row i <-> time t0 - r - r*d + i;
  // conv2 rows i <-> time t0 + i, of which the first `tile` are written
  const int tile = BM - 2 * r;
  const int t0 = blockIdx.x * tile;
  const bf16* xb = x + (size_t)blockIdx.y * T_len * C;
  bf16* yb = y + (size_t)blockIdx.y * T_len * C;
  for (int i = threadIdx.x; i < na * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = t0 - r - r * d + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T_len)
      v = leaky8(__ldg(reinterpret_cast<const uint4*>(xb + (size_t)t * C) +
                       ch));
    *reinterpret_cast<uint4*>(act + row * S + ch * 8) = v;
  }

  const int warp = threadIdx.x >> 5;
  const int m_base = (warp / W::kWarpsN) * 4, n_base = (warp % W::kWarpsN) * 64;
  float acc[4][8][4];
  int g = 0;
  zero(acc);
  conv_mma<C, KS, 4, 8>(acc, act, 0, d, m_base, 1, BM / 16, n_base, ws, g);
  __syncthreads();                      // act is read; Z takes its place
  for_each_pair<4, 8>(m_base, 1, BM / 16, n_base,
                      [&](int i, int n, int h, int row, int col) {
    const int t = t0 - r + row;
    uint32_t z = 0;
    if (t >= 0 && t < T_len)
      z = pack2(leaky<bf16>(rnd<bf16>(acc[i][n][2 * h] + b1[col])),
                leaky<bf16>(rnd<bf16>(acc[i][n][2 * h + 1] + b1[col + 1])));
    *reinterpret_cast<uint32_t*>(act + row * S + col) = z;
  });
  // conv2 reads Z rows i + j: rows past BM hold leaky(x) (finite) and only
  // feed rows past the tile
  zero(acc);
  conv_mma<C, KS, 4, 8>(acc, act, 0, 1, m_base, 1, BM / 16, n_base, ws, g);
  __syncthreads();                      // Z is read; conv2's output over it
  for_each_pair<4, 8>(m_base, 1, BM / 16, n_base,
                      [&](int i, int n, int h, int row, int col) {
    *reinterpret_cast<uint32_t*>(act + row * S + col) =
        pack2(acc[i][n][2 * h] + b2[col], acc[i][n][2 * h + 1] + b2[col + 1]);
  });
  __syncthreads();
  for (int i = threadIdx.x; i < tile * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = t0 + row;
    if (t < T_len) {
      const uint4* src = reinterpret_cast<const uint4*>(xb + (size_t)t * C);
      reinterpret_cast<uint4*>(yb + (size_t)t * C)[ch] = add8(
          __ldg(src + ch), *reinterpret_cast<const uint4*>(act + row * S +
                                                           ch * 8));
    }
  }
}

// Narrow variant, the whole ResBlock over a tile of TILE rows; MT m-tiles
// per warp at most (the largest conv's rows over 16 * 8 warps).
template <int C, int TILE>
struct Narrow {
  static constexpr int KS = C >= 64 ? 64 : 128;
  static size_t smem(int H) {
    return ((size_t)2 * (TILE + 2 * H + 16) + kStages * KS) * (C + kPad) * 2;
  }
};

// Window row w <-> time t0 - H + w, as in resblock1_fused_kernel; pass p
// shrinks the valid margin e by r*(d_p + 1). conv1 computes rows
// [H - e_out - r, H + TILE + e_out + r), conv2 rows [H - e_out,
// H + TILE + e_out), each rounded up to whole m-tiles; the rounding's rows
// read stale, finite values and feed only rows that are discarded.
template <int C, int TILE, int MT>
__global__ void __launch_bounds__(kThreads, 1)
resblock1_fused_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                           const bf16* __restrict__ w1,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ w2,
                           const float* __restrict__ b2, int T_len, int k,
                           Dilations dil) {
  using N = Narrow<C, TILE>;
  constexpr int S = C + kPad, KS = N::KS, NT = C / 8;
  constexpr int kChunks = C / 8;
  extern __shared__ uint4 smem_v[];
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) H += r * (dil.d[p] + 1);
  const int nw = TILE + 2 * H;
  const int nb = nw + 16;
  bf16* hb = reinterpret_cast<bf16*>(smem_v);   // residual stream h
  bf16* az = hb + nb * S;               // leaky(h) * mask, then conv1's out
  const int per_conv = (k * C + KS - 1) / KS;
  const WeightStream<C, KS> ws{w1, w2, k * C, per_conv,
                               2 * dil.n * per_conv, az + nb * S};
  for (int g = 0; g < kStages - 1; ++g) ws.load(g);

  const int t0 = blockIdx.x * TILE;
  const int w0 = t0 - H;
  const bf16* xb = x + (size_t)blockIdx.y * T_len * C;
  bf16* yb = y + (size_t)blockIdx.y * T_len * C;
  for (int i = threadIdx.x; i < nb * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = w0 + row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < nw && t >= 0 && t < T_len)
      v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)t * C) + ch);
    *reinterpret_cast<uint4*>(hb + row * S + ch * 8) = v;
    *reinterpret_cast<uint4*>(az + row * S + ch * 8) = leaky8(v);
  }

  const int warp = threadIdx.x >> 5;
  float acc[MT][NT][4];
  int g = 0, e = H;
  for (int p = 0; p < dil.n; ++p) {
    const int d = dil.d[p];
    const int e_out = e - r * (d + 1);
    const int lo_z = H - e_out - r;
    const int mt_z = (TILE + 2 * (e_out + r) + 15) / 16;
    zero(acc);
    conv_mma<C, KS, MT, NT>(acc, az, lo_z - r * d, d, warp, 8, mt_z, 0, ws,
                            g);
    __syncthreads();                    // az is read; conv1's out over it
    const float* b1p = b1 + p * C;
    for_each_pair<MT, NT>(warp, 8, mt_z, 0,
                          [&](int i, int n, int h, int row, int col) {
      const int t = w0 + lo_z + row;
      uint32_t z = 0;
      if (t >= 0 && t < T_len)
        z = pack2(leaky<bf16>(rnd<bf16>(acc[i][n][2 * h] + b1p[col])),
                  leaky<bf16>(rnd<bf16>(acc[i][n][2 * h + 1] + b1p[col + 1])));
      *reinterpret_cast<uint32_t*>(az + (lo_z + row) * S + col) = z;
    });
    const int lo_h = H - e_out;
    const int mt_h = (TILE + 2 * e_out + 15) / 16;
    zero(acc);
    conv_mma<C, KS, MT, NT>(acc, az, lo_h - r, 1, warp, 8, mt_h, 0, ws, g);
    __syncthreads();                    // az is read; the next A over it
    const float* b2p = b2 + p * C;
    for_each_pair<MT, NT>(warp, 8, mt_h, 0,
                          [&](int i, int n, int h, int row, int col) {
      const int w = lo_h + row, t = w0 + w;
      uint32_t* hp = reinterpret_cast<uint32_t*>(hb + w * S + col);
      const uint32_t hv = *hp;
      const float c0 = rnd<bf16>(acc[i][n][2 * h] + b2p[col]);
      const float c1 = rnd<bf16>(acc[i][n][2 * h + 1] + b2p[col + 1]);
      const float h0 = rnd<bf16>(lo_f(hv) + c0);
      const float h1 = rnd<bf16>(hi_f(hv) + c1);
      *hp = pack2(h0, h1);
      uint32_t a = 0;
      if (w < nw && t >= 0 && t < T_len)
        a = pack2(leaky<bf16>(h0), leaky<bf16>(h1));
      *reinterpret_cast<uint32_t*>(az + w * S + col) = a;
    });
    e = e_out;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = t0 + row;
    if (t < T_len)
      reinterpret_cast<uint4*>(yb + (size_t)t * C)[ch] =
          *reinterpret_cast<const uint4*>(hb + (H + row) * S + ch * 8);
  }
}

template <int C>
int launch_pass_mma(const void* x, void* y, const void* w1, const void* b1,
                    const void* w2, const void* b2, int B, int T_len, int k,
                    int d, cudaStream_t stream) {
  const int r = (k - 1) / 2;
  const int tile = Wide<C>::kRowsM - 2 * r;
  const size_t smem = Wide<C>::smem(k, d);
  if (k < 1 || k % 2 == 0 || d < 1 || tile < 16 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_pass_mma_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  resblock1_pass_mma_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), T_len, k,
      d);
  return (int)cudaGetLastError();
}

template <int C, int TILE, int MT>
int launch_fused_mma(const void* x, void* y, const void* w1, const void* b1,
                     const void* w2, const void* b2, int B, int T_len, int k,
                     Dilations dil, cudaStream_t stream) {
  using N = Narrow<C, TILE>;
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) H += r * (dil.d[p] + 1);
  // the most m-tiles of any conv: conv1 of the pass with the widest margin
  int most = 0, e = H;
  for (int p = 0; p < dil.n; ++p) {
    e -= r * (dil.d[p] + 1);
    most = max(most, (TILE + 2 * (e + r) + 15) / 16);
  }
  const size_t smem = N::smem(H);
  if (k < 1 || k % 2 == 0 || most > 8 * MT || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_fused_mma_kernel<C, TILE, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + TILE - 1) / TILE, B);
  resblock1_fused_mma_kernel<C, TILE, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), T_len, k,
      dil);
  return (int)cudaGetLastError();
}

bool dilations_ok(int n_d, int d0, int d1, int d2, Dilations* dil) {
  *dil = Dilations{n_d, {d0, d1, d2, 0}};
  if (n_d < 1 || n_d > 3) return false;
  for (int p = 0; p < n_d; ++p)
    if (dil->d[p] < 1) return false;
  return true;
}

}  // namespace

extern "C" {

// Weights [k, C_in, C_out] in x's dtype, biases [C] f32, for this pass only.
int resblock1_pass_f32(const void* x, void* y, const void* w1,
                       const void* b1, const void* w2, const void* b2, int B,
                       int T_len, int C, int k, int d, int tile,
                       void* stream) {
  return launch_pass_f32(x, y, w1, b1, w2, b2, B, T_len, C, k, d, tile,
                         static_cast<cudaStream_t>(stream));
}

int resblock1_pass_bf16(const void* x, void* y, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        int B, int T_len, int C, int k, int d,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 256:
      return launch_pass_mma<256>(x, y, w1, b1, w2, b2, B, T_len, k, d, s);
    case 128:
      return launch_pass_mma<128>(x, y, w1, b1, w2, b2, B, T_len, k, d, s);
    case 64:
      return launch_pass_mma<64>(x, y, w1, b1, w2, b2, B, T_len, k, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Weights [n_d, k, C_in, C_out] in x's dtype, biases [n_d, C] f32; n_d <= 3
// dilations d0..d2 (the unused ones ignored).
int resblock1_fused_f32(const void* x, void* y, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        int B, int T_len, int C, int k, int n_d, int d0,
                        int d1, int d2, int tile, void* stream) {
  Dilations dil;
  if (!dilations_ok(n_d, d0, d1, d2, &dil)) return (int)cudaErrorInvalidValue;
  return launch_fused_f32(x, y, w1, b1, w2, b2, B, T_len, C, k, dil, tile,
                          static_cast<cudaStream_t>(stream));
}

int resblock1_fused_bf16(const void* x, void* y, const void* w1,
                         const void* b1, const void* w2, const void* b2,
                         int B, int T_len, int C, int k, int n_d, int d0,
                         int d1, int d2, void* stream) {
  Dilations dil;
  if (!dilations_ok(n_d, d0, d1, d2, &dil)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64:
      return launch_fused_mma<64, 256, 3>(x, y, w1, b1, w2, b2, B, T_len, k,
                                          dil, s);
    case 32:
      return launch_fused_mma<32, 512, 5>(x, y, w1, b1, w2, b2, B, T_len, k,
                                          dil, s);
    case 16:
      return launch_fused_mma<16, 512, 5>(x, y, w1, b1, w2, b2, B, T_len, k,
                                          dil, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
