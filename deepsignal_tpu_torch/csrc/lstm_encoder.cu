// Fused 3-layer x 2-direction TF-LSTMCell encoder: [B, T, 8H] layer-0
// projections -> [B, 2H] (concat of the last forward h2 and the first
// backward h2).
//
// Replaces the TPU kernel deepsignal_tpu/ops/pallas/lstm.py::_encoder_kernel
// (launched by bilstm_encoder_pallas).  What it computes is the same; the
// layout is not.  The TPU kernel kept all recurrent weights (about 10 MB in
// float32) and the 12 h/c states in VMEM and walked time as a sequential grid
// axis.  One H100 SM has 227 KB of shared memory, so here:
//
// - grid (ceil(B / BT), 2): one CTA owns one direction and BT batch rows; the
//   forward and backward stacks are independent, so they never meet.
// - H threads, thread j owns hidden unit j: it accumulates the four gate
//   columns j, H+j, 2H+j, 3H+j for its BT rows, so the cell update (c in
//   registers) never leaves the thread.  Neighbouring threads read
//   neighbouring weight addresses of the row-major [K, 4H] matrices, so
//   weight loads are coalesced.
// - the time loop (T) and the layer loop (3) run inside the CTA, in place of
//   the TPU's sequential grid axis.  h of the 3 layers lives in shared memory
//   as float ([3][BT][H], 48 KB at BT 16, H 256); each layer's new h is kept
//   in registers until every thread has read the old one.
// - weights stream from L2 (all recurrent weights fit in the 50 MB L2).
//
// What bounds it: the recurrent products are 365 GFLOP per batch of 4096
// (5.4 ms at the card's 67 TFLOP/s of float32 FMA; 0.37 ms at the bfloat16
// tensor-core rate), and they run here on the FMA units in both types.  On
// top of that every CTA re-reads its direction's recurrent weights (5H x 4H
// values) at every step: 512 CTAs x 17 steps x 5.2 MB = 45 GB of float32
// (23 GB of bfloat16) through L2 per batch, which at L2's few TB/s costs
// more than the FMAs.  A larger batch tile (fewer weight re-reads) and
// wgmma are the next steps.
//
// Numerics follow the TPU kernel: h and c are float32 state; h is rounded to
// the storage type before every product; products accumulate in float32;
// gate math is float32; upper-layer biases arrive as float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 16;            // batch rows per CTA
constexpr int MAX_H = 256;        // threads per CTA = H
constexpr float FORGET_BIAS = 1.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

struct Direction {
  const void* wh0;   // [H, 4H]  layer-0 recurrent rows
  const void* k1;    // [2H, 4H] layer 1: rows [0,H) input, [H,2H) recurrent
  const void* k2;    // [2H, 4H] layer 2
  const float* b1;   // [4H]
  const float* b2;   // [4H]
};

struct Params {
  const void* xp;    // [B, T, 2, 4H] layer-0 x @ W_x + b, fw then bw
  Direction dir[2];
  void* out;         // [B, 2H]
  int B, T, H;
};

// acc[r][g] += sum_k hs[r][k] * w[k][g*H + j], k in [0, K)
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[BT][4],
                                           const float* __restrict__ hs,
                                           const T* __restrict__ w, int K,
                                           int H, int j) {
  const int G = 4 * H;
  const T* wj = w + j;
  float wv[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) wv[kk][g] = to_f(wj[kk * G + g * H]);
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    // prefetch the next four weight rows while this one is used
    float wn[4][4];
    const int kn = k + 4 < K ? k + 4 : k;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wn[kk][g] = to_f(wj[(size_t)(kn + kk) * G + g * H]);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(hs + r * H + k);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float a = acc[r][g];
        a = fmaf(hv.x, wv[0][g], a);
        a = fmaf(hv.y, wv[1][g], a);
        a = fmaf(hv.z, wv[2][g], a);
        a = fmaf(hv.w, wv[3][g], a);
        acc[r][g] = a;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[kk][g] = wn[kk][g];
  }
}

// One layer of one step: gates -> (h, c) update -> h into shared memory.
// h_s is [3][BT][H]; layer L reads h_s[L-1] (already this step's) and
// h_s[L] (last step's), then overwrites h_s[L] after a barrier.
template <typename T, int L>
__device__ __forceinline__ void layer_step(const Params& p, int dir, int b0,
                                           int t, float* h_s,
                                           float (&c)[BT], float (&hn)[BT]) {
  const int H = p.H, G = 4 * H, j = threadIdx.x;
  const Direction d = dir == 0 ? p.dir[0] : p.dir[1];
  float acc[BT][4];
  if (L == 0) {
    const T* xp = static_cast<const T*>(p.xp);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = b0 + r;
      const T* x = xp + (((size_t)row * p.T + t) * 2 + dir) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = row < p.B ? to_f(x[g * H]) : 0.0f;
    }
    accumulate<T>(acc, h_s, static_cast<const T*>(d.wh0), H, H, j);
  } else {
    const float* bias = L == 1 ? d.b1 : d.b2;
    const T* k = static_cast<const T*>(L == 1 ? d.k1 : d.k2);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float bg = bias[g * H + j];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r][g] = bg;
    }
    accumulate<T>(acc, h_s + (L - 1) * BT * H, k, H, H, j);
    accumulate<T>(acc, h_s + L * BT * H, k + (size_t)H * G, H, H, j);
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    // gate order i, j, f, o (TF1 LSTMCell)
    const float cn = sigmoid(acc[r][2] + FORGET_BIAS) * c[r] +
                     sigmoid(acc[r][0]) * tanhf(acc[r][1]);
    c[r] = cn;
    hn[r] = sigmoid(acc[r][3]) * tanhf(cn);
  }
  __syncthreads();  // every thread has read h_s[L] of the last step
#pragma unroll
  for (int r = 0; r < BT; ++r)
    h_s[(L * BT + r) * H + j] = to_f(from_f<T>(hn[r]));
  __syncthreads();  // h_s[L] of this step is complete
}

template <typename T>
__global__ void __launch_bounds__(MAX_H, 1)
    lstm_encoder_kernel(const Params p) {
  extern __shared__ float h_s[];  // [3][BT][H]
  const int H = p.H, j = threadIdx.x;
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  float c0[BT], c1[BT], c2[BT], hn[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    c0[r] = c1[r] = c2[r] = 0.0f;
#pragma unroll
    for (int l = 0; l < 3; ++l) h_s[(l * BT + r) * H + j] = 0.0f;
  }
  __syncthreads();
  for (int s = 0; s < p.T; ++s) {
    const int t = dir == 0 ? s : p.T - 1 - s;
    layer_step<T, 0>(p, dir, b0, t, h_s, c0, hn);
    layer_step<T, 1>(p, dir, b0, t, h_s, c1, hn);
    layer_step<T, 2>(p, dir, b0, t, h_s, c2, hn);
  }
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int row = b0 + r;
    if (row < p.B) out[(size_t)row * 2 * H + dir * H + j] = from_f<T>(hn[r]);
  }
}

template <typename T>
int launch(const void* xp, const void* wh0f, const void* k1f, const void* k2f,
           const float* b1f, const float* b2f, const void* wh0b,
           const void* k1b, const void* k2b, const float* b1b,
           const float* b2b, void* out, int B, int steps, int H,
           void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0 || H > MAX_H || H % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xp = xp;
  p.dir[0] = Direction{wh0f, k1f, k2f, b1f, b2f};
  p.dir[1] = Direction{wh0b, k1b, k2b, b1b, b2b};
  p.out = out;
  p.B = B;
  p.T = steps;
  p.H = H;
  const int smem = 3 * BT * H * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_encoder_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BT - 1) / BT, 2);
  lstm_encoder_kernel<T><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.
int ds_lstm_encoder_f32(const void* xp, const void* wh0f, const void* k1f,
                        const void* k2f, const float* b1f, const float* b2f,
                        const void* wh0b, const void* k1b, const void* k2b,
                        const float* b1b, const float* b2b, void* out, int B,
                        int T, int H, void* stream) {
  return launch<float>(xp, wh0f, k1f, k2f, b1f, b2f, wh0b, k1b, k2b, b1b, b2b,
                       out, B, T, H, stream);
}

int ds_lstm_encoder_bf16(const void* xp, const void* wh0f, const void* k1f,
                         const void* k2f, const float* b1f, const float* b2f,
                         const void* wh0b, const void* k1b, const void* k2b,
                         const float* b1b, const float* b2b, void* out, int B,
                         int T, int H, void* stream) {
  return launch<__nv_bfloat16>(xp, wh0f, k1f, k2f, b1f, b2f, wh0b, k1b, k2b,
                               b1b, b2b, out, B, T, H, stream);
}

}  // extern "C"
