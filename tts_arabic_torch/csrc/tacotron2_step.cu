// One predicated Tacotron2 decoder step (inference) as five kernels, for
// Hopper (sm_90a), in float32 or bfloat16.
//
// Replaces no TPU kernel: the JAX package leaves the decoder step to XLA
// (tts_arabic_tpu/models/tacotron2.py, its lax.while_loop body). Added for
// the decode step of tts_arabic_torch/models/tacotron2.py::_predicated_step,
// which the card ran as some 70 small ATen, cuBLAS and cuDNN launches a step
// inside the decode-block CUDA graph: each moved a few KB and left a gap of
// a couple of microseconds behind it. Here the step is five launches:
//
//   1. k_prenet      the prenet (2 x [linear, relu, keep mask x 1/(1-p)]) of
//                    the previous frame, the masks indexed by the device t;
//                    grid (B, prenet_dim / 32): layer 1 whole in every CTA,
//                    a 32-unit slice of layer 2
//   2. k_lstm_*      the attention LSTM: gates [4H, prenet + memory + H] of
//                    cat(prenet, context) and h, split over the card by
//                    hidden unit, 8 units (32 gate rows) a CTA; the cell in
//                    the epilogue, so no gate tensor reaches memory
//   3. k_attention   location-sensitive attention, one thread-block cluster
//                    of 8 CTAs a row, each over an eighth of the text: the
//                    query (a slice a CTA, gathered through distributed
//                    shared memory), the location conv and dense, the
//                    energies, the masked softmax (max and sum across the
//                    cluster) and the context (partial sums reduced across
//                    the cluster, a channel slice a CTA, in rank order)
//   4. k_lstm_*      the decoder LSTM, as 2 over cat(attention h, context)
//   5. k_out         the mel and gate projection, a CTA an output row; the
//                    commit of the new state into the carry, and, in the
//                    CTA that arrives last (a ticket), the bookkeeping: the
//                    gate's sigmoid against the threshold, finished,
//                    lengths, t, s and the run flag go
//
// Once a block, before the steps: k_att_prep casts the attention's small
// weights to f32 (the location dense transposed), and for bf16 the wrapper's
// k_pack casts every decoder parameter into one bf16 buffer in one launch
// (tacotron2_pack_bf16), from the parameters as they are then, so a weight
// changed in place reaches the next replay of a captured block.
//
// Every kernel returns when the run flag go is false, so a step past the
// segment's end writes nothing. New values go to scratch tensors and reach
// the carry only in k_out, after every read of the old ones. Each carried
// value is rounded to the state's dtype where it is produced, before any
// later use; sums stay in f32. The bf16 step rounds where the plain step's
// ATen ops round their outputs (the prenet's linear, the query, the location
// conv and dense, the energies' adds and tanh, the sigmoid), except inside
// the LSTM gates and the matrix products, which stay in f32 until the cell's
// outputs. f32 uses plain f32 FMAs (no TF32). Sums run in a fixed order, so
// the step is deterministic.
//
// The step's kernels are launched with programmatic dependent launch: each
// one starts while the one before it runs, loads what no kernel of the
// decode writes (the block's packed weights, the encoder's outputs) and then
// waits (griddepcontrol.wait) for the one before it to finish before it
// reads anything else or writes. That hides each launch behind the kernel
// before it and starts the LSTMs' weight stream early: 66 -> 57 us a step
// at [16, 240] in bf16 (PERF.md).
//
// What bounds it: bytes. One step reads the decoder's weights (19.2M at
// full width with 40 speakers: 38.5 MB in bf16, 11.5 us at 3.35 TB/s), the
// memory and its keys (16 x 240 rows: 5.9 MB in bf16) and a few hundred KB
// of state (port_bench/yardstick_tacotron2.py::decode_step_bound_s: 13.4 us
// at 16 rows and text 240). The design against it:
// - the LSTMs carry 92% of the weights. bf16 with widths in multiples of 32
//   runs them on the tensor cores (mma.sync m16n8k16, f32 accumulation):
//   a warp's A fragment is 16 gate rows read as 16-byte vectors straight
//   from global memory, its B fragment 8 batch rows of the input, k
//   permuted alike in both (lane c of a quad holds k 8c..8c+7 of a 32-k
//   chunk), so each load is one 16-byte vector and no shared memory is
//   needed; 8 warps split K and meet in shared memory. Each warp keeps a
//   ring of DEPTH chunks in flight. f32, or a width off the multiple, runs
//   the same split on the CUDA cores: a warp a hidden unit, lanes over K;
// - the attention fills 8 SMs a row (128 at 16 rows) through the cluster
//   and reads the memory once: its small weights and keys arrive by
//   cp.async, its memory rows straight into registers, all at the start;
//   the location conv slides its window through registers, the dense keeps
//   a column of its weights in registers;
// - the prenet and the projection are small (86K and 135K weights) and
//   spread over 8 and n_mels + 1 CTAs a row group, every load of a thread
//   issued before the first is used.
// Every row is read 8 elements (16 bytes in bf16) at a time, so the widths
// n_mels, prenet, memory, both LSTMs' and the attention's are multiples of
// 8; the wrapper checks them and the kernels' other limits.
//
// C interface: tacotron2_step(dtype, ptrs, dims, scalars, steps, stream)
// launches the block's preparation and `steps` steps (a decode block's) on
// the stream; ptrs, dims and scalars are laid out as the enums below and as
// tts_arabic_torch/ops/tacotron2_step.py builds them. Returns the first
// cudaError of a launch, 0 when all were taken. tacotron2_step_runs(device,
// dst, stream) copies the device's run counts of the kernels (enum Run) to
// dst in stream order: one thread of each launch's first CTA adds one when
// the kernel starts, so the steps of a replayed CUDA graph count as well as
// those the host launched.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

// pointers, as ops/tacotron2_step.py's _PTRS
enum Ptr {
  // the carry (state dtype unless noted)
  P_ATTN_H, P_ATTN_C, P_DEC_H, P_DEC_C,  // [B, A], [B, A], [B, D], [B, D]
  P_ATTN_WEIGHTS, P_ATTN_WEIGHTS_CUM,    // [B, T]
  P_ATTN_CONTEXT,                        // [B, M]
  P_PREV_FRAME,                          // [B, n_mels]
  P_FINISHED,                            // bool [B]
  P_LENGTHS,                             // int32 [B]
  P_T, P_S,                              // int64 [1]
  P_GO,                                  // bool [1]
  // the encoder's outputs
  P_MEMORY,                              // [B, T, M]
  P_PROCESSED_MEMORY,                    // [B, T, AH]
  P_MEMORY_MASK,                         // bool [B, T]
  // the buffers
  P_MEL,                                 // [B, S1, n_mels]
  P_GATE,                                // [B, S1]
  P_ALIGN,                               // [B, S1, T]
  // the weights, in the state dtype
  P_PRENET0, P_PRENET1,                  // [P, n_mels], [P, P]
  P_ATT_W_IH, P_ATT_W_HH,                // [4A, P + M], [4A, A]
  P_ATT_B_IH, P_ATT_B_HH,                // [4A]
  P_DEC_W_IH, P_DEC_W_HH,                // [4D, A + M], [4D, D]
  P_DEC_B_IH, P_DEC_B_HH,                // [4D]
  P_QUERY,                               // [AH, A]
  P_V,                                   // [1, AH]
  P_LOCATION_CONV,                       // [F, 2, KS]
  P_LOCATION_DENSE,                      // [AH, F]
  P_OUT_W,                               // [n_mels + 1, D + M]
  P_OUT_B,                               // [n_mels + 1]
  P_MASKS,     // bool [mask_rows, 2, B, P], or null (no prenet dropout)
  P_LIMIT,                               // int64 [1]
  // scratch: the step's new values, then the ticket
  P_S_PRE, P_S_ATTN_H, P_S_ATTN_C, P_S_DEC_H, P_S_DEC_C, P_S_ATTN_WEIGHTS,
  P_S_ATTN_WEIGHTS_CUM, P_S_ATTN_CONTEXT,
  P_S_GATE,                              // f32 [B]
  P_S_ATT_WEIGHTS,  // f32: location conv, dense transposed, v (att_prep)
  P_TICKET,                              // uint32 [1], zero between steps
  N_PTRS
};

enum Dim {
  D_B, D_T, D_NMELS, D_P, D_A, D_D, D_M, D_AH, D_F, D_KS, D_S1, D_MASK_ROWS,
  D_EARLY, N_DIMS
};

// each kernel's runs on the device since the library was loaded
enum Run {
  R_PRENET, R_ATTENTION_LSTM, R_ATTENTION, R_DECODER_LSTM, R_OUT,  // a step
  R_ATT_PREP, R_PACK,                                              // a block
  N_RUNS
};
__device__ unsigned long long g_runs[N_RUNS];

__device__ __forceinline__ void count_run(int run) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    atomicAdd(&g_runs[run], 1ull);
}

struct Args {
  void* p[N_PTRS];
  int B, T, n_mels, P, A, D, M, AH, F, KS, S1, mask_rows, early;
  float scale;      // the prenet's 1 / (1 - p)
  float threshold;  // the gate threshold, rounded to the state dtype
};

constexpr int CL = 8;          // CTAs of an attention cluster (one row)
constexpr int UNITS = 8;       // hidden units of an LSTM CTA
constexpr int THREADS = 256;
constexpr int ATT_THREADS = 256;
constexpr int DEPTH = 6;       // chunks in flight a warp (tensor-core cells)
constexpr float kNegInf = -__builtin_huge_valf();

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T, back in f32
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename X> __device__ __forceinline__ X* ptr(const Args& a, int i) {
  return reinterpret_cast<X*>(a.p[i]);
}

__device__ __forceinline__ bool running(const Args& a) {
  return *ptr<const bool>(a, P_GO);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// 8 consecutive elements from a 16-byte aligned address, as f32: one 16-byte
// load in bf16, two in f32. Every width the kernels load this way is a
// multiple of 8 (the wrapper checks), so the loads of a loop over a row are
// independent and issue together
__device__ __forceinline__ void load8(const bf16* p, float (&o)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// 8 elements held raw in registers (loaded early, converted when used)
template <typename T> struct Raw8;
template <> struct Raw8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// programmatic dependent launch: a step's kernel is launched while the one
// before it still runs (launch_dependents lets the next one start), and
// waits for it (griddepcontrol.wait: the previous grid complete, its
// writes visible) before it reads anything a kernel of the decode writes.
// Before the wait a kernel reads only what was written before the block's
// first step: the packed weights and the encoder's outputs. Both are no-ops
// for a kernel launched without the attribute
__device__ __forceinline__ void dependents_may_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// a 16-byte copy from global to shared memory that does not wait (cp.async)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float dot8(const float (&w)[8], const float* x,
                                      float acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(w[i], x[i], acc);
  return acc;
}

// ---- 1. the prenet ---------------------------------------------------------

// relu(linear) rounded to T, then the keep mask and the scale, rounded again
// (the plain step's relu(F.linear(x)) and where(mask, x * scale, 0))
template <typename T>
__device__ __forceinline__ float prenet_act(float acc, const bool* keep, int u,
                                            float scale) {
  float h = fmaxf(rnd<T>(acc), 0.f);
  if (keep) h = keep[u] ? rnd<T>(h * scale) : 0.f;
  return h;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) k_prenet(Args a) {
  // a thread a unit of layer 1 (P <= THREADS), a lane a 16-byte vector of
  // layer 2's rows (P <= 256), n_mels <= 128: the wrapper checks
  count_run(R_PRENET);
  extern __shared__ float sm[];
  float* x = sm;              // [n_mels]
  float* h1 = sm + a.n_mels;  // [P]
  const int b = blockIdx.x, u = threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u0 = blockIdx.y * 32 + warp * 4;  // layer 2: this warp's units
  // every weight this thread reads, before the wait
  float w0[16][8], w1[4][8];
  const int nv0 = a.n_mels / 8;
#pragma unroll
  for (int v = 0; v < 16; ++v)
    if (u < a.P && v < nv0)
      load8(ptr<const T>(a, P_PRENET0) + (size_t)u * a.n_mels + 8 * v, w0[v]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (u0 + q < a.P && lane < a.P / 8)
      load8(ptr<const T>(a, P_PRENET1) + (size_t)(u0 + q) * a.P + 8 * lane,
            w1[q]);
  dependents_may_launch();
  wait_for_previous();
  const bool go = running(a);
  const long long t = *ptr<const long long>(a, P_T);
  const T* prev = ptr<const T>(a, P_PREV_FRAME) + (size_t)b * a.n_mels;
  if (u < a.n_mels) x[u] = to_f(prev[u]);
  if (!go) return;
  const bool* masks = ptr<const bool>(a, P_MASKS);
  const long long tm = t < a.mask_rows ? t : a.mask_rows - 1;  // t < rows
  const bool* m0 = masks ? masks + ((tm * 2 + 0) * a.B + b) * (size_t)a.P
                         : nullptr;
  const bool* m1 = masks ? masks + ((tm * 2 + 1) * a.B + b) * (size_t)a.P
                         : nullptr;
  __syncthreads();
  if (u < a.P) {
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < 16; ++v)
      if (v < nv0) acc = dot8(w0[v], x + 8 * v, acc);
    h1[u] = prenet_act<T>(acc, m0, u, a.scale);
  }
  __syncthreads();
  T* out = ptr<T>(a, P_S_PRE) + (size_t)b * a.P;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float acc = 0.f;
    if (u0 + q < a.P && lane < a.P / 8) acc = dot8(w1[q], h1 + 8 * lane, 0.f);
    acc = warp_sum(acc);
    if (lane == 0 && u0 + q < a.P)
      out[u0 + q] = from_f<T>(prenet_act<T>(acc, m1, u0 + q, a.scale));
  }
}

// ---- 2, 4. the LSTM cells --------------------------------------------------

// one input segment of a cell: W's columns [0, width) in rows of ldw, against
// x [B, width]
template <typename T> struct Seg {
  const T* w;
  int ldw;
  const T* x;
  int width;
};

template <typename T> struct Cell {
  Seg<T> seg[3];
  int H;
  const T* b_ih;
  const T* b_hh;
  const T* c_old;  // [B, H]
  T* h_new;        // [B, H]
  T* c_new;        // [B, H]
};

// which 0: the attention LSTM over [prenet, context] and attention h;
// which 1: the decoder LSTM over [attention h (new), context (new)] and
// decoder h
template <typename T> __device__ Cell<T> cell_of(const Args& a, int which) {
  Cell<T> c;
  if (which == 0) {
    const T* wih = ptr<const T>(a, P_ATT_W_IH);
    c.seg[0] = {wih, a.P + a.M, ptr<const T>(a, P_S_PRE), a.P};
    c.seg[1] = {wih + a.P, a.P + a.M, ptr<const T>(a, P_ATTN_CONTEXT), a.M};
    c.seg[2] = {ptr<const T>(a, P_ATT_W_HH), a.A, ptr<const T>(a, P_ATTN_H),
                a.A};
    c.H = a.A;
    c.b_ih = ptr<const T>(a, P_ATT_B_IH);
    c.b_hh = ptr<const T>(a, P_ATT_B_HH);
    c.c_old = ptr<const T>(a, P_ATTN_C);
    c.h_new = ptr<T>(a, P_S_ATTN_H);
    c.c_new = ptr<T>(a, P_S_ATTN_C);
  } else {
    const T* wih = ptr<const T>(a, P_DEC_W_IH);
    c.seg[0] = {wih, a.A + a.M, ptr<const T>(a, P_S_ATTN_H), a.A};
    c.seg[1] = {wih + a.A, a.A + a.M, ptr<const T>(a, P_S_ATTN_CONTEXT),
                a.M};
    c.seg[2] = {ptr<const T>(a, P_DEC_W_HH), a.D, ptr<const T>(a, P_DEC_H),
                a.D};
    c.H = a.D;
    c.b_ih = ptr<const T>(a, P_DEC_B_IH);
    c.b_hh = ptr<const T>(a, P_DEC_B_HH);
    c.c_old = ptr<const T>(a, P_DEC_C);
    c.h_new = ptr<T>(a, P_S_DEC_H);
    c.c_new = ptr<T>(a, P_S_DEC_C);
  }
  return c;
}

// what a cell's epilogue thread reads besides the gates (both biases of its
// unit's four gates, the old c), loaded when the kernel starts: thread e
// owns unit e / NB, row e % NB (UNITS * NB <= THREADS)
struct CellIn {
  float bias[4];
  float c_old;
};

// the biases (weights: before the wait); c_old is read after it
// (cell_c_old)
template <typename T, int NB>
__device__ __forceinline__ CellIn cell_in(const Cell<T>& c, int j0, int b0,
                                          int nb) {
  CellIn in = {{0.f, 0.f, 0.f, 0.f}, 0.f};
  const int e = threadIdx.x, u = e / NB, b = e % NB, j = j0 + u;
  if (e < UNITS * NB && b < nb && j < c.H) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      in.bias[q] = to_f(c.b_ih[q * c.H + j]) + to_f(c.b_hh[q * c.H + j]);
  }
  return in;
}

template <typename T, int NB>
__device__ __forceinline__ void cell_c_old(const Cell<T>& c, int j0, int b0,
                                           int nb, CellIn& in) {
  const int e = threadIdx.x, u = e / NB, b = e % NB, j = j0 + u;
  if (e < UNITS * NB && b < nb && j < c.H)
    in.c_old = to_f(c.c_old[(size_t)(b0 + b) * c.H + j]);
}

// G [4][UNITS][NB]: the gates' sums of this CTA's units and rows -> the cell
// (PyTorch's gate order i, f, g, o; both biases added in f32; h from the
// unrounded c, as ATen's fused cell), h and c rounded to T
template <typename T, int NB>
__device__ void cell_epilogue(const Cell<T>& c, const float (*G)[UNITS][NB],
                              const CellIn& in, int j0, int b0, int nb) {
  const int e = threadIdx.x, u = e / NB, b = e % NB, j = j0 + u;
  if (e >= UNITS * NB || b >= nb || j >= c.H) return;
  float g[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) g[q] = G[q][u][b] + in.bias[q];
  const size_t o = (size_t)(b0 + b) * c.H + j;
  const float cn = sigmoid(g[1]) * in.c_old + sigmoid(g[0]) * tanhf(g[2]);
  c.c_new[o] = from_f<T>(cn);
  c.h_new[o] = from_f<T>(sigmoid(g[3]) * tanhf(cn));
}

// the CUDA-core cell: any width, f32 or bf16. A warp a unit (its four gate
// rows), lanes over K; NB batch rows a CTA (blockIdx.y the row group)
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS) k_lstm_fma(Args a, int which) {
  count_run(which == 0 ? R_ATTENTION_LSTM : R_DECODER_LSTM);
  const Cell<T> c = cell_of<T>(a, which);
  __shared__ float G[4][UNITS][NB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * UNITS, j = j0 + warp;
  const int b0 = blockIdx.y * NB, nb = min(NB, a.B - b0);
  CellIn in = cell_in<T, NB>(c, j0, b0, nb);
  dependents_may_launch();
  wait_for_previous();
  if (!running(a)) return;
  cell_c_old<T, NB>(c, j0, b0, nb, in);
  float acc[4][NB];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[q][b] = 0.f;
  if (j < c.H) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const Seg<T> sg = c.seg[s];
      const T* x = sg.x + (size_t)b0 * sg.width;
#pragma unroll 4
      for (int k = lane; k < sg.width; k += 32) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = to_f(sg.w[(size_t)(q * c.H + j) * sg.ldw + k]);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b < nb) {
            const float xv = to_f(x[(size_t)b * sg.width + k]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q][b] = fmaf(w[q], xv, acc[q][b]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float v = warp_sum(acc[q][b]);
      if (lane == 0) G[q][warp][b] = v;
    }
  __syncthreads();
  cell_epilogue<T, NB>(c, G, in, j0, b0, nb);
}

// the tensor-core cell: bf16, every segment width a multiple of 32, 16-byte
// aligned rows. m-tile 0 holds gates i (rows 0-7) and f (8-15) of the CTA's 8
// units, m-tile 1 gates g and o; NT n-tiles of 8 batch rows
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int NT> struct Chunk {
  uint4 w[4];   // gate rows i, f, g, o of unit grp: k 8c..8c+7
  uint4 x[NT];  // batch rows grp, grp + 8: the same k
};

// chunk ch's weight vectors (w) or input vectors (x; after the wait)
template <int NT>
__device__ __forceinline__ void load_chunk(const Cell<bf16>& c, int ch,
                                           int j0, int b0, int nb, int grp,
                                           int quad, Chunk<NT>& out, bool w,
                                           bool x) {
  // the segment of chunk ch, by selects (no indexed struct: registers)
  const int n0 = c.seg[0].width / 32, n1 = n0 + c.seg[1].width / 32;
  const Seg<bf16> sg = ch < n0 ? c.seg[0] : (ch < n1 ? c.seg[1] : c.seg[2]);
  const int k = (ch - (ch < n0 ? 0 : (ch < n1 ? n0 : n1))) * 32 + quad * 8;
  if (w) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out.w[q] = ldg16(sg.w + (size_t)(q * c.H + j0 + grp) * sg.ldw + k);
  }
  if (x) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int b = n * 8 + grp;
      out.x[n] = b < nb ? ldg16(sg.x + (size_t)(b0 + b) * sg.width + k)
                        : make_uint4(0, 0, 0, 0);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS) k_lstm_mma(Args a, int which) {
  count_run(which == 0 ? R_ATTENTION_LSTM : R_DECODER_LSTM);
  const Cell<bf16> c = cell_of<bf16>(a, which);
  __shared__ float red[THREADS / 32][32][17];
  __shared__ float G[4][UNITS][16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, quad = lane & 3;
  const int j0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * 16, nb = min(16, a.B - b0);
  const int total = (c.seg[0].width + c.seg[1].width + c.seg[2].width) / 32;
  CellIn in = cell_in<bf16, 16>(c, j0, b0, nb);
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;
  // a ring of DEPTH chunks a warp in flight: chunk ch of the warp's
  // sequence (warp, warp + 8, ...) lives in ring slot ch % DEPTH
  constexpr int W = THREADS / 32;
  Chunk<NT> ring[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)  // the weights, before the wait
    if (warp + d * W < total)
      load_chunk<NT>(c, warp + d * W, j0, b0, nb, grp, quad, ring[d], true,
                     false);
  dependents_may_launch();
  wait_for_previous();
  if (!running(a)) return;
  cell_c_old<bf16, 16>(c, j0, b0, nb, in);
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (warp + d * W < total)
      load_chunk<NT>(c, warp + d * W, j0, b0, nb, grp, quad, ring[d], false,
                     true);
  for (int it = 0; warp + it * W < total; it += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int ch = warp + (it + d) * W;
      if (ch < total) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint4 lo = ring[d].w[2 * m], hi = ring[d].w[2 * m + 1];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint4 x = ring[d].x[n];
            // k-step 0: k 8c..8c+3, k-step 1: 8c+4..8c+7 (the same
            // permutation of k in A and B)
            mma_bf16(acc[m][n], lo.x, hi.x, lo.y, hi.y, x.x, x.y);
            mma_bf16(acc[m][n], lo.z, hi.z, lo.w, hi.w, x.z, x.w);
          }
        }
        if (ch + DEPTH * W < total)
          load_chunk<NT>(c, ch + DEPTH * W, j0, b0, nb, grp, quad, ring[d],
                         true, true);
      }
    }
  }
  // the warps' partial sums, summed in warp order
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[warp][lane][(m * NT + n) * 4 + r] = acc[m][n][r];
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * 2 * NT * 4; e += blockDim.x) {
    const int l = e / (2 * NT * 4), i = e % (2 * NT * 4);
    float v = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) v += red[w][l][i];
    const int m = i / (NT * 4), n = (i / 4) % NT, r = i % 4;
    const int row = (l >> 2) + (r >= 2 ? 8 : 0);          // in the m-tile
    const int col = n * 8 + (l & 3) * 2 + (r & 1);         // batch row
    G[m * 2 + row / 8][row % 8][col] = v;
  }
  __syncthreads();
  cell_epilogue<bf16, 16>(c, G, in, j0, b0, nb);
}

// ---- 3. location-sensitive attention ---------------------------------------

// the attention's small weights in f32, once a block (they change only
// between blocks): the location conv as it is, the location dense
// transposed to [F][AH] (a lane a j reads a row of it), v; each part starts
// on a 16-byte boundary
struct AttLayout {
  int wc, wdt, v, total;  // offsets and size, in floats
};
__host__ __device__ inline AttLayout att_layout(int F, int KS, int AH) {
  AttLayout l;
  l.wc = 0;
  l.wdt = (F * 2 * KS + 3) / 4 * 4;
  l.v = l.wdt + F * AH;
  l.total = (l.v + AH + 3) / 4 * 4;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) k_att_prep(Args a) {
  count_run(R_ATT_PREP);
  const AttLayout l = att_layout(a.F, a.KS, a.AH);
  float* out = ptr<float>(a, P_S_ATT_WEIGHTS);
  const T* lconv = ptr<const T>(a, P_LOCATION_CONV);
  const T* ldense = ptr<const T>(a, P_LOCATION_DENSE);
  const T* vw = ptr<const T>(a, P_V);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < l.total;
       i += gridDim.x * blockDim.x) {
    float x = 0.f;
    if (i < a.F * 2 * a.KS) {
      x = to_f(lconv[i]);
    } else if (i >= l.wdt && i < l.v) {
      const int f = (i - l.wdt) / a.AH, j = (i - l.wdt) % a.AH;
      x = to_f(ldense[j * a.F + f]);
    } else if (i >= l.v && i < l.v + a.AH) {
      x = to_f(vw[i - l.v]);
    }
    out[i] = x;
  }
}

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(ATT_THREADS, 2)
    k_attention(Args a) {
  count_run(R_ATTENTION);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NW = ATT_THREADS / 32;
  const int T_ = a.T, AH = a.AH, F = a.F, KS = a.KS, M = a.M;
  const int pad = (KS - 1) / 2;
  const int chunk = (T_ + CL - 1) / CL;
  const int t0 = min(T_, rank * chunk), t1 = min(T_, t0 + chunk);
  const int nt = t1 - t0;
  const int per_q = (AH + CL - 1) / CL;
  const int wlen = chunk + KS - 1;
  const AttLayout lay = att_layout(F, KS, AH);
  const int nv = M / 8, groups = max(1, ATT_THREADS / nv);
  extern __shared__ __align__(16) float sm[];
  float* wts = sm;                             // [lay.total]: wc | wdt | v
  const float* wc = wts + lay.wc;              // [F][2][KS]
  const float* wdt = wts + lay.wdt;            // [F][AH]
  const float* v = wts + lay.v;                // [AH]
  T* pm = reinterpret_cast<T*>(wts + lay.total);  // [chunk][AH], raw
  const int chunk4 = (chunk + 3) / 4 * 4;
  float* conv = reinterpret_cast<float*>(
      pm + (size_t)chunk * AH);                // [chunk4][F]: location conv
  float* q_part = conv + chunk4 * F;           // [per_q]: this rank's query
  float* q = q_part + per_q;                   // [AH]: the whole query
  float* win = q + AH;                         // [2][wlen]: prev, cumulative
  float* e = win + 2 * wlen;                   // [chunk]: energies, weights
  float* keep = e + chunk;                     // [chunk]: the memory mask
  float* contrib = keep + chunk;               // [chunk][AH]: v_j tanh(.)
  float* part = contrib + chunk * AH;          // [groups][M]
  float* ctx = part + groups * M;              // [M]
  float* stat = ctx + M;                       // [2]: local max, local sum

  // everything this rank reads that the step did not write, in flight at
  // once: the small weights and this rank's keys by cp.async, the window
  // and mask by plain loads, this thread's memory rows into registers
  const float* prep = ptr<const float>(a, P_S_ATT_WEIGHTS);
  for (int i = threadIdx.x; i < lay.total / 4; i += blockDim.x)
    cp_async16(wts + 4 * i, prep + 4 * i);
  const T* pmem = ptr<const T>(a, P_PROCESSED_MEMORY) +
                  ((size_t)b * T_ + t0) * AH;
  for (int i = threadIdx.x; i < nt * AH / (16 / (int)sizeof(T));
       i += blockDim.x)
    cp_async16(reinterpret_cast<char*>(pm) + 16 * i,
               reinterpret_cast<const char*>(pmem) + 16 * i);
  const bool* mask = ptr<const bool>(a, P_MEMORY_MASK) + (size_t)b * T_;
  for (int i = threadIdx.x; i < nt; i += blockDim.x)
    keep[i] = mask[t0 + i] ? 1.f : 0.f;
  const T* mem = ptr<const T>(a, P_MEMORY) + ((size_t)b * T_ + t0) * M;
  const int g = threadIdx.x / nv, c8 = threadIdx.x % nv;
  const bool ctx_thread = g < groups;
  constexpr int R = sizeof(T) == 2 ? 12 : 6;  // rows held in registers
  Raw8<T> rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ctx_thread && g + r * groups < nt)
      rows[r].load(mem + (size_t)(g + r * groups) * M + 8 * c8);
  // the above reads only the encoder's outputs and the block's weights;
  // what the decode writes is read after the wait
  dependents_may_launch();
  wait_for_previous();
  if (!running(a)) {  // go is one flag: the whole cluster returns
    cp_async_wait_all();
    return;
  }
  const long long s = *ptr<const long long>(a, P_S);
  const bool fin = ptr<const bool>(a, P_FINISHED)[b];
  const T* att_prev = ptr<const T>(a, P_ATTN_WEIGHTS) + (size_t)b * T_;
  const T* att_cum = ptr<const T>(a, P_ATTN_WEIGHTS_CUM) + (size_t)b * T_;
  for (int i = threadIdx.x; i < 2 * wlen; i += blockDim.x) {
    const int pos = t0 - pad + i % wlen;
    win[i] = pos >= 0 && pos < T_
                 ? to_f((i < wlen ? att_prev : att_cum)[pos]) : 0.f;
  }

  // the query slice, its loads in flight beside those: rows [rank per_q,
  // +per_q) of W_q against the new attention h, a warp a row
  const T* h = ptr<const T>(a, P_S_ATTN_H) + (size_t)b * a.A;
  const T* wq = ptr<const T>(a, P_QUERY);
#pragma unroll 2
  for (int i = warp; i < per_q; i += NW) {
    const int o = rank * per_q + i;
    float acc = 0.f;
    if (o < AH) {
#pragma unroll 4
      for (int k = lane; k < a.A / 8; k += 32) {
        float w[8], x[8];
        load8(wq + (size_t)o * a.A + 8 * k, w);
        load8(h + 8 * k, x);
        acc = dot8(w, x, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) q_part[i] = rnd<T>(acc);
  }
  cp_async_wait_all();
  cluster.sync();  // every rank started, every query slice written
  for (int j = threadIdx.x; j < AH; j += blockDim.x)
    q[j] = cluster.map_shared_rank(q_part, j / per_q)[j % per_q];
  __syncthreads();

  // the location conv: a thread a filter and 4 positions, the window
  // slid through registers
  const int nblk = (nt + 3) / 4;
  for (int item = threadIdx.x; item < F * nblk; item += blockDim.x) {
    const int f = item % F, tq = 4 * (item / F);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float* wrow = wc + (f * 2 + ch) * KS;
      const float* xw = win + ch * wlen + tq;
      float x0 = xw[0], x1 = xw[1], x2 = xw[2];
      for (int k = 0; k < KS; ++k) {
        const float w = wrow[k], x3 = xw[k + 3];
        acc[0] = fmaf(w, x0, acc[0]);
        acc[1] = fmaf(w, x1, acc[1]);
        acc[2] = fmaf(w, x2, acc[2]);
        acc[3] = fmaf(w, x3, acc[3]);
        x0 = x1;
        x1 = x2;
        x2 = x3;
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (tq + p < nt) conv[(tq + p) * F + f] = rnd<T>(acc[p]);
  }
  __syncthreads();
  // the location dense, the keys and the query through tanh, times v: a
  // thread a j (its dense column in registers) and a group of positions
  {
    const int jg = blockDim.x / AH, j = threadIdx.x % AH;
    const int tg = threadIdx.x / AH;
    if (tg < jg) {
      float wd[32];
#pragma unroll
      for (int f = 0; f < 32; ++f) wd[f] = f < F ? wdt[f * AH + j] : 0.f;
      const float qj = q[j], vj = v[j];
#pragma unroll 2
      for (int t = tg; t < nt; t += jg) {
        const float4* c4 = reinterpret_cast<const float4*>(conv + t * F);
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int f4 = 0; f4 < 8; f4 += 2) {
          if (4 * f4 < F) {
            const float4 c = c4[f4];
            lo = fmaf(wd[4 * f4], c.x, lo);
            lo = fmaf(wd[4 * f4 + 1], c.y, lo);
            lo = fmaf(wd[4 * f4 + 2], c.z, lo);
            lo = fmaf(wd[4 * f4 + 3], c.w, lo);
          }
          if (4 * f4 + 4 < F) {
            const float4 c = c4[f4 + 1];
            hi = fmaf(wd[4 * f4 + 4], c.x, hi);
            hi = fmaf(wd[4 * f4 + 5], c.y, hi);
            hi = fmaf(wd[4 * f4 + 6], c.z, hi);
            hi = fmaf(wd[4 * f4 + 7], c.w, hi);
          }
        }
        const float x = rnd<T>(rnd<T>(qj + rnd<T>(lo + hi)) +
                               to_f(pm[t * AH + j]));
        contrib[t * AH + j] = vj * rnd<T>(tanhf(x));
      }
    }
  }
  __syncthreads();
  // the energies: a warp a position sums its contributions over j
  for (int t = warp; t < nt; t += NW) {
    float en = 0.f;
    for (int j = lane; j < AH; j += 32) en += contrib[t * AH + j];
    en = warp_sum(en);
    if (lane == 0) e[t] = keep[t] != 0.f ? rnd<T>(en) : rnd<T>(-1e9f);
  }
  __syncthreads();

  // the masked softmax over the row: max and sum across the cluster (warp
  // 0 reduces this rank's positions)
  if (warp == 0) {
    float mx = kNegInf;
    for (int i = lane; i < nt; i += 32) mx = fmaxf(mx, e[i]);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) stat[0] = mx;
  }
  cluster.sync();
  float mx = kNegInf;
  for (int r = 0; r < CL; ++r)
    mx = fmaxf(mx, *cluster.map_shared_rank(stat, r));
  if (warp == 0) {
    float sum = 0.f;
    for (int i = lane; i < nt; i += 32) sum += expf(e[i] - mx);
    sum = warp_sum(sum);
    if (lane == 0) stat[1] = sum;
  }
  cluster.sync();
  float total = 0.f;
  for (int r = 0; r < CL; ++r) total += *cluster.map_shared_rank(stat + 1, r);
  T* w_new = ptr<T>(a, P_S_ATTN_WEIGHTS) + (size_t)b * T_;
  T* cum_new = ptr<T>(a, P_S_ATTN_WEIGHTS_CUM) + (size_t)b * T_;
  T* align = ptr<T>(a, P_ALIGN) + ((size_t)b * a.S1 + s) * T_;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const float w = rnd<T>(expf(e[i] - mx) / total);
    e[i] = w;
    w_new[t0 + i] = from_f<T>(w);
    cum_new[t0 + i] = from_f<T>(win[wlen + pad + i] + w);
    align[t0 + i] = from_f<T>(fin ? 0.f : w);
  }
  __syncthreads();

  // the context over this rank's positions: a thread a group of positions
  // and 8 channels (its rows in registers since the start), the groups
  // summed in order; then the ranks' sums, in rank order, a channel slice
  // a rank
  if (ctx_thread && c8 < nv) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = g + r * groups;
      if (t < nt) {
        float x[8];
        rows[r].get(x);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(e[t], x[k], acc[k]);
      }
    }
    for (int t = g + R * groups; t < nt; t += groups) {
      float x[8];
      load8(mem + (size_t)t * M + 8 * c8, x);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(e[t], x[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) part[g * M + 8 * c8 + k] = acc[k];
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += part[gg * M + m];
    ctx[m] = acc;
  }
  cluster.sync();
  const int per_m = (M + CL - 1) / CL;
  T* ctx_new = ptr<T>(a, P_S_ATTN_CONTEXT) + (size_t)b * M;
  for (int m = rank * per_m + threadIdx.x; m < min(M, (rank + 1) * per_m);
       m += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < CL; ++r) acc += cluster.map_shared_rank(ctx, r)[m];
    ctx_new[m] = from_f<T>(acc);
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

// ---- 5. projection, commit, bookkeeping ------------------------------------

template <typename T>
__device__ void commit_state(const Args& a, int cta, int ctas) {
  // the carry's new values, from scratch (every reader of the old ones ran
  // in an earlier kernel of this step): each thread loads its elements of
  // all seven first, then stores them
  const int from[7] = {P_S_ATTN_H, P_S_ATTN_C, P_S_DEC_H, P_S_DEC_C,
                       P_S_ATTN_WEIGHTS, P_S_ATTN_WEIGHTS_CUM,
                       P_S_ATTN_CONTEXT};
  const int to[7] = {P_ATTN_H, P_ATTN_C, P_DEC_H, P_DEC_C, P_ATTN_WEIGHTS,
                     P_ATTN_WEIGHTS_CUM, P_ATTN_CONTEXT};
  const int n[7] = {a.B * a.A, a.B * a.A, a.B * a.D, a.B * a.D, a.B * a.T,
                    a.B * a.T, a.B * a.M};
  const int most = max(max(n[0], n[2]), max(n[4], n[6]));
  const int stride = ctas * blockDim.x;
  for (int i = cta * blockDim.x + threadIdx.x; i < most; i += stride) {
    T val[7];
#pragma unroll
    for (int p = 0; p < 7; ++p)
      if (i < n[p]) val[p] = ptr<const T>(a, from[p])[i];
#pragma unroll
    for (int p = 0; p < 7; ++p)
      if (i < n[p]) ptr<T>(a, to[p])[i] = val[p];
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(THREADS) k_out(Args a) {
  count_run(R_OUT);
  const int row = blockIdx.x;  // mel channel, or n_mels: the gate
  const int b0 = blockIdx.y * NB, nb = min(NB, a.B - b0);
  const int K = a.D + a.M;
  const T* w = ptr<const T>(a, P_OUT_W) + (size_t)row * K;
  const T* dh = ptr<const T>(a, P_S_DEC_H);
  const T* cx = ptr<const T>(a, P_S_ATTN_CONTEXT);
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const int ctas = gridDim.x * gridDim.y;
  // a thread 8 columns at a time: the weight's 16-byte vector (before the
  // wait) and every row's
  auto row_of = [&](int b, int k) {
    return k < a.D ? dh + (size_t)(b0 + b) * a.D + k
                   : cx + (size_t)(b0 + b) * a.M + k - a.D;
  };
  Raw8<T> w_first, x_first[NB];
  const bool first = threadIdx.x < K / 8;
  if (first) w_first.load(w + 8 * threadIdx.x);
  const float bias = to_f(ptr<const T>(a, P_OUT_B)[row]);
  dependents_may_launch();
  wait_for_previous();
  if (!running(a)) return;
  const long long s = *ptr<const long long>(a, P_S);
  const bool fin = threadIdx.x < nb &&
                   ptr<const bool>(a, P_FINISHED)[b0 + threadIdx.x];
  if (first) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) x_first[b].load(row_of(b, 8 * threadIdx.x));
  }
  // the commit depends on nothing this kernel computes: beside the loads
  commit_state<T>(a, cta, ctas);
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  if (first) {
    float wv[8];
    w_first.get(wv);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) {
        float x[8];
        x_first[b].get(x);
        acc[b] = dot8(wv, x, acc[b]);
      }
  }
  for (int v = threadIdx.x + blockDim.x; v < K / 8; v += blockDim.x) {
    const int k = 8 * v;
    float wv[8];
    load8(w + k, wv);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) {
        float x[8];
        load8(row_of(b, k), x);
        acc[b] = dot8(wv, x, acc[b]);
      }
  }
  __shared__ float red[THREADS / 32][NB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(acc[b]);
    if (lane == 0) red[warp][b] = v;
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    const int b = threadIdx.x, gb = b0 + b;
    float sum = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) sum += red[i][b];
    const float o = rnd<T>(sum + bias);
    if (row < a.n_mels) {
      ptr<T>(a, P_PREV_FRAME)[(size_t)gb * a.n_mels + row] = from_f<T>(o);
      ptr<T>(a, P_MEL)[((size_t)gb * a.S1 + s) * a.n_mels + row] =
          from_f<T>(fin ? 0.f : o);
    } else {
      ptr<T>(a, P_GATE)[(size_t)gb * a.S1 + s] = from_f<T>(o);
      ptr<float>(a, P_S_GATE)[gb] = o;
    }
  }

  // the CTA that arrives last keeps the books
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ptr<unsigned>(a, P_TICKET), 1u) == (unsigned)ctas - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  bool* fin_w = ptr<bool>(a, P_FINISHED);
  int* lengths = ptr<int>(a, P_LENGTHS);
  const float* gate = ptr<const float>(a, P_S_GATE);
  int open = 0;
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    const bool was = fin_w[b];
    // sigmoid(gate) > threshold in the state dtype, as the plain step
    const bool fired = rnd<T>(sigmoid(__ldcg(gate + b))) > a.threshold;
    fin_w[b] = was || fired;
    lengths[b] += was ? 0 : 1;
    open |= !(was || fired);
  }
  open = __syncthreads_or(open);
  if (threadIdx.x == 0) {
    const long long s1 = s + 1;
    *ptr<long long>(a, P_T) += 1;
    *ptr<long long>(a, P_S) = s1;
    *ptr<bool>(a, P_GO) =
        s1 < *ptr<const long long>(a, P_LIMIT) && (!a.early || open);
    *ptr<unsigned>(a, P_TICKET) = 0u;
  }
}

// ---- launches --------------------------------------------------------------

template <typename T>
size_t attention_smem(const Args& a) {
  const int chunk = (a.T + CL - 1) / CL, per_q = (a.AH + CL - 1) / CL;
  const int chunk4 = (chunk + 3) / 4 * 4;
  const int groups = std::max(1, ATT_THREADS / (a.M / 8));
  const AttLayout l = att_layout(a.F, a.KS, a.AH);
  return sizeof(float) * (size_t)l.total +
         sizeof(T) * (size_t)chunk * a.AH +
         sizeof(float) * (size_t)(chunk4 * a.F + per_q + a.AH +
                                  2 * (chunk + a.KS - 1) + 2 * chunk +
                                  chunk * a.AH + groups * a.M + a.M + 2);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the tensor cores take the cells when every segment is whole 32-k chunks of
// 16-byte aligned rows
bool mma_fits(const Args& a) {
  if (a.P % 32 || a.M % 32 || a.A % 32 || a.D % 32) return false;
  const int ps[] = {P_ATT_W_IH, P_ATT_W_HH, P_DEC_W_IH, P_DEC_W_HH,
                    P_S_PRE,    P_ATTN_CONTEXT, P_ATTN_H, P_S_ATTN_H,
                    P_S_ATTN_CONTEXT, P_DEC_H};
  for (int i : ps)
    if (!aligned16(a.p[i])) return false;
  return true;
}

// a launch on the stream, programmatically dependent on the one before it
template <typename... Params, typename... Actual>
cudaError_t launch_one(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t st, Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int NB>
cudaError_t launch_nb(const Args& a, bool mma, size_t att_smem,
                      cudaStream_t st) {
  const dim3 block(THREADS);
  const int groups = (a.B + NB - 1) / NB, groups16 = (a.B + 15) / 16;
  auto cell = [&](int which) {
    const int ctas = ((which == 0 ? a.A : a.D) + UNITS - 1) / UNITS;
    if (!mma)
      return launch_one(k_lstm_fma<T, NB>, dim3(ctas, groups), block, 0, st,
                        a, which);
    if (a.B <= 8)
      return launch_one(k_lstm_mma<1>, dim3(ctas, groups16), block, 0, st,
                        a, which);
    return launch_one(k_lstm_mma<2>, dim3(ctas, groups16), block, 0, st, a,
                      which);
  };
  cudaError_t err = launch_one(k_prenet<T>, dim3(a.B, (a.P + 31) / 32),
                               block, sizeof(float) * (a.n_mels + a.P), st,
                               a);
  if (err == cudaSuccess) err = cell(0);
  if (err == cudaSuccess)
    err = launch_one(k_attention<T>, dim3(CL, a.B), dim3(ATT_THREADS),
                     att_smem, st, a);
  if (err == cudaSuccess) err = cell(1);
  if (err == cudaSuccess)
    err = launch_one(k_out<T, NB>, dim3(a.n_mels + 1, groups), block, 0, st,
                     a);
  return err;
}

template <typename T>
cudaError_t launch(const Args& a, int steps, cudaStream_t st) {
  // above 48 KB the attention's shared memory is asked for once (on the
  // eager run before a capture, so never inside one)
  static size_t granted = 48 * 1024;
  const size_t att_smem = attention_smem<T>(a);
  if (att_smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        k_attention<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)att_smem);
    if (err != cudaSuccess) return err;
    granted = att_smem;
  }
  const bool mma = sizeof(T) == 2 && mma_fits(a);
  const AttLayout l = att_layout(a.F, a.KS, a.AH);
  // once a block, after the weights' pack and before the first step's
  // prenet, which waits for it (no early launch from here)
  k_att_prep<T><<<(l.total + THREADS - 1) / THREADS, THREADS, 0, st>>>(a);
  const cudaError_t prep = cudaGetLastError();
  if (prep != cudaSuccess) return prep;
  for (int i = 0; i < steps; ++i) {
    cudaError_t err;
    if (a.B <= 1) err = launch_nb<T, 1>(a, mma, att_smem, st);
    else if (a.B <= 4) err = launch_nb<T, 4>(a, mma, att_smem, st);
    else if (a.B <= 8) err = launch_nb<T, 8>(a, mma, att_smem, st);
    else err = launch_nb<T, 16>(a, mma, att_smem, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- the per-block weight pack ----------------------------------------------

// f32 parameters -> one bf16 buffer, blockIdx.y the tensor: the decoder's
// weights cast once a decode block, from the parameters as they are then
constexpr int MAX_PACK = 24;
struct Pack {
  const float* src[MAX_PACK];
  bf16* dst[MAX_PACK];
  long long n[MAX_PACK];
};

__global__ void __launch_bounds__(THREADS) k_pack(Pack p) {
  count_run(R_PACK);
  const float* src = p.src[blockIdx.y];
  bf16* dst = p.dst[blockIdx.y];
  const long long n = p.n[blockIdx.y];
  const long long step = 4ll * gridDim.x * blockDim.x;
  for (long long i = 4ll * (blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += step) {
    if (i + 4 <= n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 out;
      out.x = *reinterpret_cast<uint32_t*>(&lo);
      out.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + i) = out;
    } else {
      for (long long k = i; k < n; ++k) dst[k] = __float2bfloat16_rn(src[k]);
    }
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. ptrs [N_PTRS] (device addresses; P_MASKS 0
// when the prenet has no dropout), dims [N_DIMS], scalars [2]: the prenet
// scale and the gate threshold. Launches `steps` predicated steps.
int tacotron2_step(int dtype, const long long* ptrs, const int* dims,
                   const float* scalars, int steps, void* stream) {
  Args a;
  for (int i = 0; i < N_PTRS; ++i) a.p[i] = reinterpret_cast<void*>(ptrs[i]);
  a.B = dims[D_B];
  a.T = dims[D_T];
  a.n_mels = dims[D_NMELS];
  a.P = dims[D_P];
  a.A = dims[D_A];
  a.D = dims[D_D];
  a.M = dims[D_M];
  a.AH = dims[D_AH];
  a.F = dims[D_F];
  a.KS = dims[D_KS];
  a.S1 = dims[D_S1];
  a.mask_rows = dims[D_MASK_ROWS];
  a.early = dims[D_EARLY];
  a.scale = scalars[0];
  a.threshold = scalars[1];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<bf16>(a, steps, st)
                                     : launch<float>(a, steps, st);
  return (int)err;
}

// n f32 tensors srcs[i] of counts[i] elements -> bf16 at dsts[i] (16-byte
// aligned, as the sources), one launch
int tacotron2_pack_bf16(int n, const long long* srcs, const long long* dsts,
                        const long long* counts, void* stream) {
  if (n < 1 || n > MAX_PACK) return (int)cudaErrorInvalidValue;
  Pack p;
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    p.src[i] = reinterpret_cast<const float*>(srcs[i]);
    p.dst[i] = reinterpret_cast<bf16*>(dsts[i]);
    p.n[i] = counts[i];
    most = counts[i] > most ? counts[i] : most;
  }
  const long long want = (most + 4ll * THREADS - 1) / (4ll * THREADS);
  const int blocks = (int)(want < 264 ? (want > 0 ? want : 1) : 264);
  k_pack<<<dim3(blocks, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

// the run counts of `device` (N_RUNS of them, as enum Run) copied as
// 64-bit integers to the device buffer dst, in the order of `stream`
int tacotron2_step_runs(int device, void* dst, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbolAsync(dst, g_runs, sizeof(g_runs), 0,
                                  cudaMemcpyDeviceToDevice,
                                  static_cast<cudaStream_t>(stream));
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

}  // extern "C"
