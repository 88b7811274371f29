// One layer-direction of the TF-LSTMCell scan: [B, T, 4H] input projections
// (x @ W_x + b, computed outside) -> [B, T, H], every step written at its
// absolute time index; with `reverse` the recurrence walks T-1 -> 0.
//
// Replaces the TPU kernel deepsignal_tpu/ops/pallas/lstm.py::_lstm_scan_kernel
// (launched by lstm_layer_pallas).  That kernel held one 512-row batch tile's
// h and c in VMEM scratch and W_h (1 MB in float32) in VMEM, and walked time
// as the sequential second grid axis.  Here:
//
// - grid ceil(B / BT): one CTA owns BT batch rows for all T steps; the time
//   loop runs inside the CTA in place of the TPU's sequential grid axis.
// - H threads, thread j owns hidden unit j: it accumulates the four gate
//   columns j, H+j, 2H+j, 3H+j of its BT rows, and its cell state stays in
//   registers.  Neighbouring threads read neighbouring addresses of xp, W_h
//   and out, so every global access is coalesced.
// - h of the BT rows lives in shared memory as float (rounded to the storage
//   type first); the new h waits in registers until every thread has read
//   the old one.
// - W_h streams from L2 (it is at most 4 MB) at every step.
//
// What bounds it: at the training shape (B 512, T 17, H 256) the recurrent
// products are 4.6 GFLOP per launch, which the card's 67 TFLOP/s of float32
// FMA does in 0.07 ms; they run here on the FMA units in both types.  Every
// CTA re-reads W_h at every step, so the L2 traffic is (B / BT) * T * |W_h|:
// 128 CTAs x 17 x 1 MB = 2.2 GB of float32 (1.1 GB of bfloat16) per launch,
// which at L2's few TB/s costs more than the FMAs.  The batch tile trades
// the two: BT 4 gives 128 CTAs at B 512, one per SM on 128 of the 132 SMs
// (K1's BT 16 would give 32 CTAs and leave 100 SMs idle); BT 8 would halve
// the L2 traffic and idle half the card.  wgmma tiles fed from shared memory
// and a cluster that shares W_h between CTAs are the next steps.
//
// Numerics follow the TPU kernel: h and c are float32 state; h is rounded to
// the storage type before every product; products accumulate in float32;
// gate math is float32; the output is rounded to the storage type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 4;             // batch rows per CTA
constexpr int MAX_H = 512;        // threads per CTA = H
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

// acc[r][g] += sum_k hs[r][k] * w[k][g*H + j], k in [0, H).  hs rows are HP
// floats apart (HP = H rounded up to 4, so each row is float4-aligned).
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[BT][4],
                                           const float* __restrict__ hs,
                                           const T* __restrict__ w, int H,
                                           int HP, int j) {
  const int G = 4 * H;
  const int K4 = H & ~3;
  const T* wj = w + j;
  if (K4 > 0) {
    float wv[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[kk][g] = to_f(wj[kk * G + g * H]);
#pragma unroll 1
    for (int k = 0; k < K4; k += 4) {
      // prefetch the next four weight rows while these are used
      float wn[4][4];
      const int kn = k + 4 < K4 ? k + 4 : k;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wn[kk][g] = to_f(wj[(size_t)(kn + kk) * G + g * H]);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + r * HP + k);
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
#pragma unroll 1
  for (int k = K4; k < H; ++k) {  // H not a multiple of 4
    float wv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) wv[g] = to_f(wj[(size_t)k * G + g * H]);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float hv = hs[r * HP + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hv, wv[g], acc[r][g]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_H)
    lstm_scan_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                     T* __restrict__ out, int B, int steps, int H,
                     int reverse) {
  extern __shared__ float h_s[];  // [BT][HP]
  const int j = threadIdx.x;
  const int HP = (H + 3) & ~3;
  const int G = 4 * H;
  const int b0 = blockIdx.x * BT;
  for (int i = j; i < BT * HP; i += blockDim.x) h_s[i] = 0.0f;
  float c[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) c[r] = 0.0f;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    float acc[BT][4];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int row = b0 + r;
      const T* x = xp + ((size_t)row * steps + t) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = row < B ? to_f(x[g * H]) : 0.0f;
    }
    accumulate<T>(acc, h_s, wh, H, HP, j);
    float hn[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      // gate order i, j, f, o (TF1 LSTMCell)
      const float cn = sigmoid(acc[r][2] + FORGET_BIAS) * c[r] +
                       sigmoid(acc[r][0]) * tanhf(acc[r][1]);
      c[r] = cn;
      hn[r] = sigmoid(acc[r][3]) * tanhf(cn);
    }
    __syncthreads();  // every thread has read the last step's h
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const T hr = from_f<T>(hn[r]);
      h_s[r * HP + j] = to_f(hr);
      const int row = b0 + r;
      if (row < B) out[((size_t)row * steps + t) * H + j] = hr;
    }
    __syncthreads();  // this step's h is complete
  }
}

template <typename T>
int launch(const void* xp, const void* wh, void* out, int B, int steps, int H,
           int reverse, void* stream) {
  if (B <= 0 || steps <= 0 || H <= 0 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  const int smem = BT * ((H + 3) & ~3) * (int)sizeof(float);
  const dim3 grid((B + BT - 1) / BT);
  lstm_scan_kernel<T><<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xp), static_cast<const T*>(wh),
      static_cast<T*>(out), B, steps, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the kernel was launched.
int ds_lstm_scan_f32(const void* xp, const void* wh, void* out, int B, int T,
                     int H, int reverse, void* stream) {
  return launch<float>(xp, wh, out, B, T, H, reverse, stream);
}

int ds_lstm_scan_bf16(const void* xp, const void* wh, void* out, int B, int T,
                      int H, int reverse, void* stream) {
  return launch<__nv_bfloat16>(xp, wh, out, B, T, H, reverse, stream);
}

}  // extern "C"
