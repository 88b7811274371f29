// Batch norm at inference and the relu after it in one pass over a [B, C, L]
// activation: models/layers.py::TFBatchNorm with the running statistics,
// and ConvBNRelu's relu.
//
// It replaces no TPU kernel: the JAX package leaves batch norm to XLA, which
// fuses the element-wise ops into one loop.  On the card torch ran it as
// seven [C]-sized ops for the factors and then four passes over the
// activation (x - mean, * k, + bias, relu), each of which reads and writes
// the whole tensor: 14.7 GB a 4,096-row forward in bfloat16 for the three
// batch-norm passes alone.
//
// What bounds it: device memory.  Each element is read once and written
// once (4 bytes in bfloat16, 8 in float32) for about ten float operations,
// far below the ~295 operations a byte at which the H100 stops being bound
// by memory.  So the design moves the fewest bytes at the highest rate:
//   - 16-byte vector loads and stores over the flattened tensor (8 bfloat16
//     or 4 float32 elements), each thread two vectors in flight;
//   - a grid of as many blocks as the card keeps resident, each striding
//     over the whole tensor;
//   - the per-channel factors computed once per block into shared memory
//     (3 floats a channel), while the block's first loads are in flight;
//   - no integer division per element or per vector: a vector may straddle
//     rows (L = 23 and 45 are not multiples of 8), so each thread carries
//     its position in the row and its channel with adds and compares, and
//     divides once, at its start.
// A tensor whose base is not on a 16-byte boundary takes the same kernel one
// element at a time.
//
// The bits are torch's.  torch rounds to the storage type after every op
// and computes each op in float32, so the kernel rounds at the same points,
// with __fsub_rn / __fmul_rn / __fadd_rn (the build leaves --fmad on, and a
// contracted multiply-add would round once where torch rounds twice):
//   factors  m = dt(mean), ve = dt(dt(var) + eps), inv = dt(rsqrtf(ve)),
//            k = dt(inv * dt(scale)), b = dt(bias)
//   output   y = dt(dt(dt(x - m) * k) + b)
//   relu     isnan(y) ? y : dt(fmaxf(y, 0)), torch's clamp_min
// where dt() rounds to the storage type (the identity in float32) and eps is
// the module's 0-d epsilon tensor of the storage type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
// the factors fit the 48 KB of dynamic shared memory a block has without
// opting in (Inception's widest batch norm has 256 channels)
constexpr int MAX_CHANNELS = 48 * 1024 / (3 * sizeof(float));

struct Params {
  const void* x;
  void* out;
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  const void* eps;
  long long n;
  int C;
  int L;
  int relu;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_float(from_float<T>(v));
}

template <typename T>
__device__ __forceinline__ T normalize(T x, float m, float k, float b,
                                       bool relu) {
  const T centred = from_float<T>(__fsub_rn(to_float(x), m));
  const T scaled = from_float<T>(__fmul_rn(to_float(centred), k));
  T y = from_float<T>(__fadd_rn(to_float(scaled), b));
  if (relu) {
    const float f = to_float(y);
    if (!isnan(f)) y = from_float<T>(fmaxf(f, 0.0f));
  }
  return y;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bn_relu_kernel(const Params p) {
  extern __shared__ float factors[];   // [3][C]: m, k, b
  float* fm = factors;
  float* fk = factors + p.C;
  float* fb = factors + 2 * p.C;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  using V = Pack<T, VEC>;

  const long long nvec = p.n / VEC;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  V a;
  if (v < nvec) a = reinterpret_cast<const V*>(x)[v];

  const float eps = to_float(*static_cast<const T*>(p.eps));
  for (int c = threadIdx.x; c < p.C; c += THREADS) {
    const float inv =
        rounded<T>(rsqrtf(rounded<T>(__fadd_rn(rounded<T>(p.var[c]), eps))));
    fm[c] = rounded<T>(p.mean[c]);
    fk[c] = rounded<T>(__fmul_rn(inv, rounded<T>(p.scale[c])));
    fb[c] = rounded<T>(p.bias[c]);
  }
  __syncthreads();

  // a grid stride moves the row position by ds and the channel by dc, plus
  // one where the position wraps
  const long long stride_rows = step * VEC / p.L;
  const int ds = static_cast<int>(step * VEC - stride_rows * p.L);
  const int dc = static_cast<int>(stride_rows % p.C);
  const long long row = v * VEC / p.L;
  int pos = static_cast<int>(v * VEC - row * p.L);
  int chan = static_cast<int>(row % p.C);
  const bool relu = p.relu != 0;
  for (; v < nvec; v += step) {
    V next;
    if (v + step < nvec) next = reinterpret_cast<const V*>(x)[v + step];
    V r;
    int q = pos, c = chan;
    float m = fm[c], k = fk[c], b = fb[c];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      r.e[j] = normalize<T>(a.e[j], m, k, b, relu);
      if (++q == p.L) {
        q = 0;
        c = c + 1 == p.C ? 0 : c + 1;
        m = fm[c];
        k = fk[c];
        b = fb[c];
      }
    }
    reinterpret_cast<V*>(out)[v] = r;
    a = next;
    pos += ds;
    chan += dc;
    if (pos >= p.L) {
      pos -= p.L;
      ++chan;
    }
    if (chan >= p.C) chan -= p.C;
  }

  // the last n % VEC elements, one a thread of block 0
  const long long e = nvec * VEC + threadIdx.x;
  if (blockIdx.x == 0 && e < p.n) {
    const int c = static_cast<int>(e / p.L % p.C);
    out[e] = normalize<T>(x[e], fm[c], fk[c], fb[c], relu);
  }
}

template <typename T, int VEC>
int launch(const Params& p, void* stream) {
  const int smem = static_cast<int>(3 * sizeof(float)) * p.C;
  const auto kernel = bn_relu_kernel<T, VEC>;
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const long long needed = (p.n / VEC + THREADS - 1) / THREADS;
  const long long blocks = std::max(
      1LL, std::min(needed, static_cast<long long>(sms) * std::max(per_sm, 1)));
  bn_relu_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bn_relu(const void* x, void* out, const void* mean, const void* var,
            const void* scale, const void* bias, const void* eps, long long n,
            int C, int L, int relu, void* stream) {
  if (n < 0 || C < 1 || C > MAX_CHANNELS || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, out, static_cast<const float*>(mean),
                 static_cast<const float*>(var),
                 static_cast<const float*>(scale),
                 static_cast<const float*>(bias), eps, n, C, L, relu};
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(x) |
                         reinterpret_cast<std::uintptr_t>(out)) % 16) == 0;
  return aligned ? launch<T, static_cast<int>(16 / sizeof(T))>(p, stream)
                 : launch<T, 1>(p, stream);
}

}  // namespace

extern "C" {

// Each launch returns a cudaError_t: 0 when the kernel was launched.  x and
// out are contiguous [B, C, L] tensors of the storage type with n = B C L
// elements; mean, var, scale and bias float32 [C]; eps a 0-d tensor of the
// storage type; relu 0 or 1.  At most 4,096 channels (their factors fill
// the 48 KB of shared memory a block has without opting in).
int ds_bn_relu_f32(const void* x, void* out, const void* mean,
                   const void* var, const void* scale, const void* bias,
                   const void* eps, long long n, int C, int L, int relu,
                   void* stream) {
  return bn_relu<float>(x, out, mean, var, scale, bias, eps, n, C, L, relu,
                        stream);
}

int ds_bn_relu_bf16(const void* x, void* out, const void* mean,
                    const void* var, const void* scale, const void* bias,
                    const void* eps, long long n, int C, int L, int relu,
                    void* stream) {
  return bn_relu<bf16>(x, out, mean, var, scale, bias, eps, n, C, L, relu,
                       stream);
}

}  // extern "C"
