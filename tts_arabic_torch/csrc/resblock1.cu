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
// Both storage types run the convs as implicit GEMMs on the tensor cores.
// Each conv is out[t, co] = sum_j sum_ci A[t + (j - r)*d, ci] * W[j, ci, co],
// a GEMM with M = time rows, N = C_out, K = k*C_in. The A operand of tap j is
// the staged activation tile read j*d rows further down; `ldmatrix` takes one
// row address per lane, so the shift costs nothing and no im2col is written.
// `mma.sync` rather than `wgmma`: a wgmma shared-memory descriptor wants its
// A tile aligned to the swizzle atom, which a shift of (j - r)*d rows breaks,
// and wgmma with A in registers would still need these ldmatrix loads.
// - Tiles: 8 warps; activation rows in shared memory are padded by 16 bytes
//   (kPad, kPadF), so the 8 row addresses of an ldmatrix fall in 8 different
//   bank groups.
// - Weights: the [k*C_in, C_out] matrix of each conv (`kernel_weights`, one
//   layout for both types) streams through shared memory in K slices
//   (kStages-deep ring of cp.async copies), the next slices loading while
//   the current one is multiplied; the stream runs on across the block's
//   convs, so conv2's first slices land during conv1.
// - Wide (C = 256/128/64): one pass per launch. A block computes both convs
//   over BM GEMM rows and writes the BM - 2r rows whose conv2 inputs it has.
//   leaky(x)*mask is staged once; conv1's output Z overwrites it once every
//   warp is done with it (the accumulators hold the whole conv), conv2's
//   rounded output is staged over Z, and the residual add reads x again,
//   coalesced.
// - Narrow (C = 32, also 16 and 64; in f32 also 8): the whole ResBlock in
//   one launch over a tile of TILE rows with the summed halo H of all passes
//   on each side (60 rows at k = 11), in two buffers: the residual stream h
//   and one that holds leaky(h)*mask for conv1 and then conv1's output for
//   conv2. Warps split the m-tiles (warp w takes w, w + 8, ...) and all of
//   N; each conv's accumulators stay in registers until every warp is done
//   reading its input, so the output can overwrite it.
// - Sum order: an output row's sum runs over the taps, then the input
//   channels, in K slices and in steps of the mma's K, whatever the row's
//   tile, T or batch row (no split-K), so a row's value does not depend on
//   where the call cut the sequence.
// What bounds both: the operations (12 k C^2 FLOPs per row and pass set;
// x in and y out at 3.35 TB/s take less than the FLOPs at the tensor rate).
// Each block re-reads the weights from L2 once per conv, 2 BM FLOPs per
// weight; the halo rows (2r of BM wide, up to 12r of a narrow tile) are
// recomputed.
//
// bf16 (the serving path): `mma.sync.m16n8k16` (bf16 in, f32 accumulate).
// - Wide: BM = 128/256/512 (warps 2x4 / 4x2 / 8x1, 64x64 per warp: 128 f32
//   accumulators a thread). Budget at k = 11, d = 5 (largest): C = 256:
//   A (128 + 50 rows) * 528 B = 93,984 B + 3 slices of 64 x 256 (33,792 B
//   each) = 195,360 B; C = 128: 306 * 272 + 3 * 17,408 = 135,456 B; C = 64:
//   562 * 144 + 3 * 9,216 = 108,576 B; of the 232,448 a block may use.
// - Narrow: tiles of 512 rows (256 at C = 64) in two bf16 buffers. Budget
//   at C = 32, k = 11: 2 * (512 + 120 + 16 rows) * 80 B = 103,680 B + 3
//   slices of 128 x 32 (10,240 B) = 134,400 B.
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
// f32 (compute_dtype=None: Tacotron2, vocoder training, the checks at
// 1e-4): 3xTF32 on the TF32 tensor cores, `mma.sync.m16n8k8.tf32` with f32
// accumulation. One TF32 product keeps 10 mantissa bits of each operand,
// about 1e-3 of the result, where the f32 checks allow 1e-4. So each
// operand is split, v ~ big + small with big = cvt.rna.tf32(v) and small =
// cvt.rna.tf32(v - big), and each K step runs three products into the same
// accumulators in a fixed order, big*small, small*big, then big*big; the
// dropped small*small is below 2^-22 of the product.
// - Where the split happens: at fragment load, for both operands. The
//   activations are staged in shared memory as f32; the weights land in
//   the ring as f32 and each lane splits the two B values it loads. The
//   result is the same bits whether the f32 weights were kept by
//   `kernel_weights` or made fresh by a training step.
// - A operand: `ldmatrix.x4` moves 16-bit pairs, so one x4 of f32 rows is a
//   16 x 8 block of 32-bit words: exactly the m16n8k8 A fragment.
// - B operand: the .col fragment wants K contiguous, the [k*C_in, C_out]
//   layout has N contiguous, and `ldmatrix.trans` exists only for 16-bit
//   elements. The weights keep the one layout of both types (the op, its
//   fake kernel and the baked bundles read it) and each lane reads its two
//   values with scalar loads from a ring whose rows are 8 words past a
//   multiple of 16 (ring_stride_f32): a fragment's four k rows fall in four
//   8-bank groups, so its 32 lanes hit 32 banks. A transposed f32 layout
//   ([n_d, C_out, k, C_in]) would let ldmatrix fetch B in 4 instructions a
//   K step instead of 16, at the price of a second kernel layout.
// - A warp runs its m-tiles in turn and, for each, the three products over
//   all its n-tiles in turn, so consecutive mma feed different accumulators.
// - Sum order and its rounding: a K step's three products gather in a
//   temporary that the first of them writes (the mma's C operand zero), and
//   the temporary is added to the conv's accumulators in IEEE f32. The
//   tensor cores round their f32 accumulator after every mma, and not to
//   nearest (measured on earlier generations: toward zero), so a sum kept
//   in them for long drifts. In the model of tests/test_torch_port_
//   resblock_tf32.py (each mma truncated), a C = 64, k = 11 block lies
//   9.1e-6 of its peak from float64 with one accumulator for the whole
//   conv, 4.3e-7 with a temporary of 4 K steps, where plain f32 lies
//   4.0e-7; at C = 32, k = 3: 1.4e-6, 4.8e-7 and 2.6e-7. On an H100 a
//   temporary of 4 K steps lay 2.4 times as far from float64 as the plain
//   f32 version at C = 16, k = 3; a temporary of one K step stays within
//   twice it at every width (tests/test_torch_port_cuda.py).
// - Shared memory is twice bf16's a row, so the f32 tiles are shorter,
//   and each wide width comes in two heights, tall (warps of 64 x 64) and
//   short (32 x 64, half the rows), chosen per launch by the grid's waves
//   (launch_pass_tf32). Budgets at k = 11 (wide d = 5 unless said, narrow
//   d = 1/3/5, H = 60), of the 232,448 bytes a block may use:
//   wide C = 256 tall: BM = 128 (warps 2x4), slices of 16 rows: at d = 3
//   (158 rows) * 1,040 B = 164,320 B + 3 slices of 16 x 264 words (16,896
//   B) = 215,008 B; d = 5 would need 235,808, so that pass runs short;
//   short: BM = 64, slices of 32: 114 * 1,040 + 3 * 33,792 = 219,936 B.
//   C = 128 tall: BM = 256 (warps 4x2): 306 * 528 + 3 * 17,408 = 213,792
//   B; short: BM = 128: 178 * 528 + 3 * 17,408 = 146,208 B. C = 64 tall:
//   BM = 512 (8x1): 562 * 272 + 3 * 9,216 = 180,512 B; short: BM = 256:
//   306 * 272 + 3 * 9,216 = 110,880 B. Narrow, 2 buffers of TILE + 2H + 16
//   rows, warps of (16 MT) x C: C = 64, TILE 128: 2 * 264 * 272 + 3 * 9,216
//   = 171,264 B; C = 32, TILE 512: 2 * 648 * 144 + 3 * 5,120 = 201,984 B;
//   C = 16: 2 * 648 * 80 + 3 * 3,072 = 112,896 B; C = 8: 2 * 648 * 48 + 3 *
//   1,024 = 65,280 B.
// - Its bound: the operations at 3xTF32's rate, 495 / 3 = 165 TFLOP/s
//   (three TF32 products per term). A short C = 256 tile re-reads the
//   weights from L2 at 32 FLOPs per byte (BM = 64), 5.2 TB/s at that rate;
//   a tall one at 64.
// - What holds it below the bound (measured on an H100, see PERF.md):
//   at Tacotron2's shapes the wide kernels reach about a quarter of it,
//   the narrow one a fifth, and at vocoder training's (batch 10-16, 256
//   to 8,192 rows) 14-17%. As in bf16, one 8-warp block an SM leaves the
//   tensor cores idle at every slice's barrier, while x is staged and in
//   the epilogues; each K step adds, per warp, 72 split instructions
//   (cvt, sub, cvt) and 64-128 IEEE adds to its 48-96 mma; and small
//   grids run 1-3 waves, the last part-full.
//
// C interface for ctypes: pointers and the stream as void*, the return
// value is cudaGetLastError() after the launch (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

struct Dilations {
  int n;
  int d[4];
};

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
// conv1 if c is even, else conv2) is a [k*C_in, C_out] matrix of E, cut into
// slices of KS rows (the conv's last one maybe shorter); slice g of the
// launch lands in ring stage g % kStages, rows S elements apart.
template <typename E, int C, int KS, int S>
struct WeightStream {
  const E* w1;         // [n_d, k, C_in, C_out]
  const E* w2;
  int kc;              // k * C: rows of one conv
  int per_conv;        // slices per conv
  int total;           // slices of the launch
  E* ring;             // [kStages][KS][S]

  __device__ const E* stage(int g) const {
    return ring + (g % kStages) * KS * S;
  }

  // cp.async of slice g (nothing past the last); always one commit group
  __device__ void load(int g) const {
    if (g < total) {
      const int c = g / per_conv, s = g - c * per_conv;
      const int rows = min(KS, kc - s * KS);
      const E* src =
          ((c & 1) ? w2 : w1) + ((size_t)(c >> 1) * kc + s * KS) * C;
      E* dst = ring + (g % kStages) * KS * S;
      constexpr int kPer = 16 / sizeof(E);   // elements in 16 bytes
      constexpr int kChunks = C / kPer;      // 16-byte chunks in a row
      for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
        const int row = i / kChunks, ch = i - row * kChunks;
        cp_async16(dst + row * S + ch * kPer,
                   src + (size_t)row * C + ch * kPer);
      }
    }
    cp_async_commit();
  }
};

template <int C, int KS>
using WeightStreamBf16 = WeightStream<bf16, C, KS, C + kPad>;

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
                                         const WeightStreamBf16<C, KS>& ws,
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
  const WeightStreamBf16<C, KS> ws{w1, w2, k * C, per_conv, 2 * per_conv,
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
  const WeightStreamBf16<C, KS> ws{w1, w2, k * C, per_conv,
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

// ---- f32: 3xTF32 on the tensor cores ----------------------------------------

constexpr int kPadF = 4;      // f32 elements (16 B) after each activation row

// Row stride (f32 elements) of the weight ring: 8 words past a multiple of
// 16, so the four k rows of a B fragment's scalar loads start 8 or 24 banks
// apart and a warp's 32 loads hit 32 banks.
__host__ __device__ constexpr int ring_stride_f32(int C) {
  return C % 16 == 8 ? C : C + 8;
}

template <int C, int KS>
using WeightStreamF32 = WeightStream<float, C, KS, ring_stride_f32(C)>;

// cvt.rna.tf32.f32: v rounded to 10 mantissa bits, to nearest with ties
// away from zero, the low 13 bits of the word zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v ~ big + small, both TF32; what is left is below 2^-21 |v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16x8, row) * b (8x8, col), TF32 in, f32 out
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky<float>(v.x), leaky<float>(v.y), leaky<float>(v.z),
                     leaky<float>(v.w));
}

// One f32 conv as an implicit GEMM in 3xTF32, as conv_mma does it in bf16:
// acc[i][n] += sum over the conv's K rows (tap j, input channel ci) of
// act[row0 + 16 * mt + (row) + j * step][ci] * W[j * C + ci][col], K in
// steps of 8; act is an f32 smem tile, rows C + kPadF apart. A K step's
// three products gather in a temporary that the first of them writes, and
// the temporary is added to acc in IEEE f32.
template <int C, int KS, int MT, int NT>
__device__ __forceinline__ void conv_tf32(float (&acc)[MT][NT][4],
                                          const float* act, int row0,
                                          int step, int m_base, int m_stride,
                                          int n_mt, int n_base,
                                          const WeightStreamF32<C, KS>& ws,
                                          int& g) {
  constexpr int SA = C + kPadF, SB = ring_stride_f32(C);
  const int lane = threadIdx.x & 31;
  // A: lane l addresses row (l & 15), words (l >> 4) * 4 of a 16x8 tile;
  // B: lane l reads k row (l & 3) (and + 4) of n column (l >> 2)
  const uint32_t a_lane =
      smem_u32(act + (row0 + (lane & 15)) * SA + (lane >> 4) * 4);
  const int b_lane = (lane & 3) * SB + n_base + (lane >> 2);
  for (int s = 0; s < ws.per_conv; ++s, ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // slice g landed; stage g - 1 free
    ws.load(g + kStages - 1);
    const int rows = min(KS, ws.kc - s * KS);
    const float* b_stage = ws.stage(g) + b_lane;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      if (kk >= rows) break;
      const int kg = s * KS + kk;
      const int tap = kg / C, ci = kg - tap * C;
      uint32_t bb[NT][2], bs[NT][2];   // big, small
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split_tf32(b_stage[kk * SB + n * 8], bb[n][0], bs[n][0]);
        split_tf32(b_stage[(kk + 4) * SB + n * 8], bb[n][1], bs[n][1]);
      }
      const uint32_t a_k = a_lane + (tap * step * SA + ci) * 4;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = m_base + i * m_stride;
        if (mt < n_mt) {
          uint32_t a[4], ab[4], as[4];
          ldmatrix_x4(a, a_k + mt * 16 * SA * 4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(__uint_as_float(a[q]), ab[q], as[q]);
          float t[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_tf32_first(t[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_tf32(t[n], as, bb[n][0], bb[n][1]);
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_tf32(t[n], ab, bb[n][0], bb[n][1]);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][n][q] += t[n][q];
        }
      }
    }
  }
}

// Wide variant in f32, one pass per launch: GEMM rows kRowsM of both convs,
// warps kWarpsM x kWarpsN of (16 MT) x 64, in two heights: MT = 4 (64 x 64
// a warp) and MT = 2 (32 x 64, half the rows a block, for grids that
// would leave a wave part-full). At C = 256 and MT = 4 the weight slices
// are 16 rows, so the 128-row tile fits beside them.
template <int C, int MT_>
struct WideF32 {
  static constexpr int kWarpsN = C / 64;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int MT = MT_;
  static constexpr int kRowsM = kWarpsM * 16 * MT;
  static constexpr int KS = C == 256 && MT == 4 ? 16 : 32;
  static size_t smem(int k, int d) {
    return ((size_t)(kRowsM + (k - 1) * d) * (C + kPadF) +
            (size_t)kStages * KS * ring_stride_f32(C)) * 4;
  }
};

template <int C, int MT_>
__global__ void __launch_bounds__(kThreads, 1)
resblock1_pass_tf32_kernel(const float* __restrict__ x, float* __restrict__ y,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2, int T_len, int k,
                           int d) {
  using W = WideF32<C, MT_>;
  constexpr int BM = W::kRowsM, S = C + kPadF, KS = W::KS, MT = W::MT;
  constexpr int kChunks = C / 4;
  extern __shared__ float4 smem_f[];
  float* act = reinterpret_cast<float*>(smem_f);
  const int r = (k - 1) / 2;
  const int na = BM + 2 * r * d;        // rows of leaky(x) * mask
  const int per_conv = (k * C + KS - 1) / KS;
  const WeightStreamF32<C, KS> ws{w1, w2, k * C, per_conv, 2 * per_conv,
                                  act + na * S};
  for (int g = 0; g < kStages - 1; ++g) ws.load(g);

  // conv1 rows i <-> time t0 - r + i, act row i <-> time t0 - r - r*d + i;
  // conv2 rows i <-> time t0 + i, of which the first `tile` are written
  const int tile = BM - 2 * r;
  const int t0 = blockIdx.x * tile;
  const float* xb = x + (size_t)blockIdx.y * T_len * C;
  float* yb = y + (size_t)blockIdx.y * T_len * C;
  for (int i = threadIdx.x; i < na * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = t0 - r - r * d + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T_len)
      v = leaky4(__ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C) +
                       ch));
    *reinterpret_cast<float4*>(act + row * S + ch * 4) = v;
  }

  const int warp = threadIdx.x >> 5;
  const int m_base = (warp / W::kWarpsN) * MT;
  const int n_base = (warp % W::kWarpsN) * 64;
  float acc[MT][8][4];
  int g = 0;
  zero(acc);
  conv_tf32<C, KS, MT, 8>(acc, act, 0, d, m_base, 1, BM / 16, n_base, ws, g);
  __syncthreads();                      // act is read; Z takes its place
  for_each_pair<MT, 8>(m_base, 1, BM / 16, n_base,
                       [&](int i, int n, int h, int row, int col) {
    const int t = t0 - r + row;
    float2 z = make_float2(0.f, 0.f);
    if (t >= 0 && t < T_len)
      z = make_float2(leaky<float>(acc[i][n][2 * h] + b1[col]),
                      leaky<float>(acc[i][n][2 * h + 1] + b1[col + 1]));
    *reinterpret_cast<float2*>(act + row * S + col) = z;
  });
  // conv2 reads Z rows i + j: rows past BM hold leaky(x) (finite) and only
  // feed rows past the tile
  zero(acc);
  conv_tf32<C, KS, MT, 8>(acc, act, 0, 1, m_base, 1, BM / 16, n_base, ws, g);
  __syncthreads();                      // Z is read; conv2's output over it
  for_each_pair<MT, 8>(m_base, 1, BM / 16, n_base,
                       [&](int i, int n, int h, int row, int col) {
    *reinterpret_cast<float2*>(act + row * S + col) =
        make_float2(acc[i][n][2 * h] + b2[col],
                    acc[i][n][2 * h + 1] + b2[col + 1]);
  });
  __syncthreads();
  for (int i = threadIdx.x; i < tile * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = t0 + row;
    if (t < T_len) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(
          xb + (size_t)t * C) + ch);
      const float4 b = *reinterpret_cast<const float4*>(act + row * S +
                                                        ch * 4);
      reinterpret_cast<float4*>(yb + (size_t)t * C)[ch] =
          make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
  }
}

// Narrow variant in f32, the whole ResBlock over a tile of TILE rows; MT
// m-tiles per warp at most (the largest conv's rows over 16 * 8 warps).
template <int C, int TILE>
struct NarrowF32 {
  static constexpr int KS = 32;
  static size_t smem(int H) {
    return ((size_t)2 * (TILE + 2 * H + 16) * (C + kPadF) +
            (size_t)kStages * KS * ring_stride_f32(C)) * 4;
  }
};

// Window row w <-> time t0 - H + w, as in resblock1_fused_mma_kernel, whose
// passes, margins and m-tile rounding it follows.
template <int C, int TILE, int MT>
__global__ void __launch_bounds__(kThreads, 1)
resblock1_fused_tf32_kernel(const float* __restrict__ x,
                            float* __restrict__ y,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ w2,
                            const float* __restrict__ b2, int T_len, int k,
                            Dilations dil) {
  using N = NarrowF32<C, TILE>;
  constexpr int S = C + kPadF, KS = N::KS, NT = C / 8;
  constexpr int kChunks = C / 4;
  extern __shared__ float4 smem_f[];
  const int r = (k - 1) / 2;
  int H = 0;
  for (int p = 0; p < dil.n; ++p) H += r * (dil.d[p] + 1);
  const int nw = TILE + 2 * H;
  const int nb = nw + 16;
  float* hb = reinterpret_cast<float*>(smem_f);  // residual stream h
  float* az = hb + nb * S;              // leaky(h) * mask, then conv1's out
  const int per_conv = (k * C + KS - 1) / KS;
  const WeightStreamF32<C, KS> ws{w1, w2, k * C, per_conv,
                                  2 * dil.n * per_conv, az + nb * S};
  for (int g = 0; g < kStages - 1; ++g) ws.load(g);

  const int t0 = blockIdx.x * TILE;
  const int w0 = t0 - H;
  const float* xb = x + (size_t)blockIdx.y * T_len * C;
  float* yb = y + (size_t)blockIdx.y * T_len * C;
  for (int i = threadIdx.x; i < nb * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = w0 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < nw && t >= 0 && t < T_len)
      v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C) + ch);
    *reinterpret_cast<float4*>(hb + row * S + ch * 4) = v;
    *reinterpret_cast<float4*>(az + row * S + ch * 4) = leaky4(v);
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
    conv_tf32<C, KS, MT, NT>(acc, az, lo_z - r * d, d, warp, 8, mt_z, 0, ws,
                             g);
    __syncthreads();                    // az is read; conv1's out over it
    const float* b1p = b1 + p * C;
    for_each_pair<MT, NT>(warp, 8, mt_z, 0,
                          [&](int i, int n, int h, int row, int col) {
      const int t = w0 + lo_z + row;
      float2 z = make_float2(0.f, 0.f);
      if (t >= 0 && t < T_len)
        z = make_float2(leaky<float>(acc[i][n][2 * h] + b1p[col]),
                        leaky<float>(acc[i][n][2 * h + 1] + b1p[col + 1]));
      *reinterpret_cast<float2*>(az + (lo_z + row) * S + col) = z;
    });
    const int lo_h = H - e_out;
    const int mt_h = (TILE + 2 * e_out + 15) / 16;
    zero(acc);
    conv_tf32<C, KS, MT, NT>(acc, az, lo_h - r, 1, warp, 8, mt_h, 0, ws, g);
    __syncthreads();                    // az is read; the next A over it
    const float* b2p = b2 + p * C;
    for_each_pair<MT, NT>(warp, 8, mt_h, 0,
                          [&](int i, int n, int h, int row, int col) {
      const int w = lo_h + row, t = w0 + w;
      float2* hp = reinterpret_cast<float2*>(hb + w * S + col);
      float2 hv = *hp;
      hv.x += acc[i][n][2 * h] + b2p[col];
      hv.y += acc[i][n][2 * h + 1] + b2p[col + 1];
      *hp = hv;
      float2 a = make_float2(0.f, 0.f);
      if (w < nw && t >= 0 && t < T_len)
        a = make_float2(leaky<float>(hv.x), leaky<float>(hv.y));
      *reinterpret_cast<float2*>(az + w * S + col) = a;
    });
    e = e_out;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i - row * kChunks;
    const int t = t0 + row;
    if (t < T_len)
      reinterpret_cast<float4*>(yb + (size_t)t * C)[ch] =
          *reinterpret_cast<const float4*>(hb + (H + row) * S + ch * 4);
  }
}

// The split the f32 kernels make, elementwise over n values: a probe that
// lets the tests hold the CPU model of cvt.rna.tf32.f32 to the card's bits.
__global__ void resblock1_tf32_split_kernel(const float* __restrict__ v,
                                            float* __restrict__ big,
                                            float* __restrict__ small,
                                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t b, s;
    split_tf32(v[i], b, s);
    big[i] = __uint_as_float(b);
    small[i] = __uint_as_float(s);
  }
}

template <int C, int MT>
int launch_pass_tf32_at(const void* x, void* y, const void* w1,
                        const void* b1, const void* w2, const void* b2, int B,
                        int T_len, int k, int d, cudaStream_t stream) {
  const int tile = WideF32<C, MT>::kRowsM - (k - 1);
  const size_t smem = WideF32<C, MT>::smem(k, d);
  cudaError_t err = cudaFuncSetAttribute(
      resblock1_pass_tf32_kernel<C, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + tile - 1) / tile, B);
  resblock1_pass_tf32_kernel<C, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), T_len, k,
      d);
  return (int)cudaGetLastError();
}

// The f32 pass at the tile height whose grid takes the least time: one
// block an SM (the registers allow no more), so a launch takes about its
// waves times a block's rows, over the height's rate (the short tile does
// 5/6 of the tall one's work in the same time); the taller where the two
// tie, the shorter where it alone fits (C = 256, k = 11, d = 5). Either
// height sums each row in the same order, so the choice changes no bit.
template <int C>
int launch_pass_tf32(const void* x, void* y, const void* w1, const void* b1,
                     const void* w2, const void* b2, int B, int T_len, int k,
                     int d, cudaStream_t stream) {
  using Tall = WideF32<C, 4>;
  using Short = WideF32<C, 2>;
  if (k < 1 || k % 2 == 0 || d < 1 || Short::kRowsM - (k - 1) < 16 ||
      Short::smem(k, d) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  auto waves = [&](int rows) {
    const long blocks = (long)(T_len + rows - k) / (rows - (k - 1)) * B;
    return (blocks + sms - 1) / sms;
  };
  const bool tall =
      Tall::kRowsM - (k - 1) >= 16 && Tall::smem(k, d) <= kMaxSmem &&
      5 * waves(Tall::kRowsM) * Tall::kRowsM <=
          6 * waves(Short::kRowsM) * Short::kRowsM;
  return tall ? launch_pass_tf32_at<C, 4>(x, y, w1, b1, w2, b2, B, T_len, k,
                                          d, stream)
              : launch_pass_tf32_at<C, 2>(x, y, w1, b1, w2, b2, B, T_len, k,
                                          d, stream);
}

template <int C, int TILE, int MT>
int launch_fused_tf32(const void* x, void* y, const void* w1, const void* b1,
                      const void* w2, const void* b2, int B, int T_len, int k,
                      Dilations dil, cudaStream_t stream) {
  using N = NarrowF32<C, TILE>;
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
      resblock1_fused_tf32_kernel<C, TILE, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + TILE - 1) / TILE, B);
  resblock1_fused_tf32_kernel<C, TILE, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), T_len, k,
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
                       int T_len, int C, int k, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 256:
      return launch_pass_tf32<256>(x, y, w1, b1, w2, b2, B, T_len, k, d, s);
    case 128:
      return launch_pass_tf32<128>(x, y, w1, b1, w2, b2, B, T_len, k, d, s);
    case 64:
      return launch_pass_tf32<64>(x, y, w1, b1, w2, b2, B, T_len, k, d, s);
  }
  return (int)cudaErrorInvalidValue;
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
                        int d1, int d2, void* stream) {
  Dilations dil;
  if (!dilations_ok(n_d, d0, d1, d2, &dil)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64:
      return launch_fused_tf32<64, 128, 2>(x, y, w1, b1, w2, b2, B, T_len, k,
                                           dil, s);
    case 32:
      return launch_fused_tf32<32, 512, 5>(x, y, w1, b1, w2, b2, B, T_len, k,
                                           dil, s);
    case 16:
      return launch_fused_tf32<16, 512, 5>(x, y, w1, b1, w2, b2, B, T_len, k,
                                           dil, s);
    case 8:
      return launch_fused_tf32<8, 512, 5>(x, y, w1, b1, w2, b2, B, T_len, k,
                                          dil, s);
  }
  return (int)cudaErrorInvalidValue;
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

// The f32 kernels' split of n values (v -> big, small), for the tests.
int resblock1_tf32_split(const void* v, void* big, void* small, int n,
                         void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  resblock1_tf32_split_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(big),
      static_cast<float*>(small), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
