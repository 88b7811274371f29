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
//     its position in the row, its channel and its batch with adds and
//     compares, and divides once, at its start.
// A tensor whose base is not on a 16-byte boundary takes the same kernel one
// element at a time.
//
// The output may come in groups of channels: the channels [first[g],
// first[g + 1]) of every row of x go to group g, a contiguous [B, C_g, L]
// block of the output, the groups one after another (one group, the
// default, is the [B, C, L] layout of x).  A batch norm over the stacked
// outputs of sibling convs (InceptionBlock's merged 1x1 convs) thus hands
// each sibling its own contiguous tensor, which a channel slice of one
// [B, C, L] output is not, at no extra pass.  Each block keeps a channel's
// group as two ints in shared memory beside its factors.  A vector lies
// inside one group where every group's first element in a row and a row's
// C L elements are whole vectors; else the kernel goes one element at a
// time.
//
// The bits are torch's.  torch rounds to the storage type after every op
// and computes each op in float32, so the kernel rounds at the same points,
// with __fsub_rn / __fmul_rn / __fadd_rn (the build leaves --fmad on, and a
// contracted multiply-add would round once where torch rounds twice):
//   factors  m = dt(mean), ve = dt(dt(var) + eps), inv = dt(rsqrtf(ve)),
//            k = dt(inv * dt(scale)), b = dt(bias)
//   output   y = dt(dt(dt(x - m) * k) + b)
//   relu     isnan(y) ? y : dt(fmaxf(y, 0)), torch's clamp_min, on the
//            leading relu_channels channels: 0 for none, C for all, and
//            between them for a batch norm over sibling convs' outputs
//            stacked, the relu's first (InceptionBlock's merged 1x1 convs)
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
// with groups, each channel's group (two ints) beside its factors
constexpr int MAX_GROUPED_CHANNELS = 48 * 1024 / (3 * sizeof(float) + 8);
constexpr int MAX_GROUPS = 8;

struct Params {
  const void* x;
  void* out;
  int groups;
  int first[MAX_GROUPS + 1];   // each group's first channel, then C
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  const void* eps;
  long long n;
  int C;
  int L;
  int relu_channels;
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

// GROUPED: the output comes in more than one group.  Element i of x, in
// row (batch, c) of [B, C, L], goes to i + ((B - 1) first - batch (C -
// C_g)) L of the output, its place in group g's [B, C_g, L] block, which
// starts at B first L.
template <typename T, int VEC, bool GROUPED>
__global__ void __launch_bounds__(THREADS) bn_relu_kernel(const Params p) {
  extern __shared__ __align__(8) unsigned char shared[];
  int2* group_of = reinterpret_cast<int2*>(shared);  // [C]: C - C_g, first
  float* fm = reinterpret_cast<float*>(shared + (GROUPED ? 8 * p.C : 0));
  float* fk = fm + p.C;
  float* fb = fm + 2 * p.C;
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
    if (GROUPED) {
      // constant indices: the parameters stay in the constant bank
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g)
        if (g < p.groups && c >= p.first[g] && c < p.first[g + 1])
          group_of[c] = make_int2(p.C - (p.first[g + 1] - p.first[g]),
                                  p.first[g]);
    }
  }
  __syncthreads();
  const long long batches = p.n / (static_cast<long long>(p.C) * p.L);

  // a grid stride moves the row position by ds, the channel by dc and the
  // batch by db, plus one where the one below wraps
  const long long stride_rows = step * VEC / p.L;
  const int ds = static_cast<int>(step * VEC - stride_rows * p.L);
  const int dc = static_cast<int>(stride_rows % p.C);
  const long long db = stride_rows / p.C;
  const long long row = v * VEC / p.L;
  int pos = static_cast<int>(v * VEC - row * p.L);
  int chan = static_cast<int>(row % p.C);
  long long batch = row / p.C;
  for (; v < nvec; v += step) {
    V next;
    if (v + step < nvec) next = reinterpret_cast<const V*>(x)[v + step];
    V r;
    int q = pos, c = chan;
    float m = fm[c], k = fk[c], b = fb[c];
    bool relu = c < p.relu_channels;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      r.e[j] = normalize<T>(a.e[j], m, k, b, relu);
      if (++q == p.L) {
        q = 0;
        c = c + 1 == p.C ? 0 : c + 1;
        m = fm[c];
        k = fk[c];
        b = fb[c];
        relu = c < p.relu_channels;
      }
    }
    long long o = v * VEC;
    if (GROUPED) {
      const int2 g = group_of[chan];
      o += ((batches - 1) * g.y - batch * g.x) * p.L;
    }
    *reinterpret_cast<V*>(out + o) = r;
    a = next;
    pos += ds;
    chan += dc;
    batch += db;
    if (pos >= p.L) {
      pos -= p.L;
      ++chan;
    }
    if (chan >= p.C) {
      chan -= p.C;
      ++batch;
    }
  }

  // the last n % VEC elements, one a thread of block 0
  const long long e = nvec * VEC + threadIdx.x;
  if (blockIdx.x == 0 && e < p.n) {
    const long long r = e / p.L;
    const int c = static_cast<int>(r % p.C);
    long long o = e;
    if (GROUPED) {
      const int2 g = group_of[c];
      o += ((batches - 1) * g.y - r / p.C * g.x) * p.L;
    }
    out[o] = normalize<T>(x[e], fm[c], fk[c], fb[c], c < p.relu_channels);
  }
}

template <typename T, int VEC, bool GROUPED>
int launch(const Params& p, void* stream) {
  const int smem = static_cast<int>(3 * sizeof(float) + (GROUPED ? 8 : 0)) *
                   p.C;
  const auto kernel = bn_relu_kernel<T, VEC, GROUPED>;
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
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bn_relu(const void* x, void* out, const void* mean, const void* var,
            const void* scale, const void* bias, const void* eps, long long n,
            int C, int L, int relu_channels, int groups,
            const int* group_channels, void* stream) {
  if (n < 0 || C < 1 || C > MAX_CHANNELS || L < 1 || relu_channels < 0 ||
      relu_channels > C || groups < 1 || groups > MAX_GROUPS ||
      (groups > 1 && C > MAX_GROUPED_CHANNELS))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, out, groups, {}, static_cast<const float*>(mean),
           static_cast<const float*>(var), static_cast<const float*>(scale),
           static_cast<const float*>(bias), eps, n, C, L, relu_channels};
  constexpr int VEC = static_cast<int>(16 / sizeof(T));
  // a vector of the fast path stays inside one group of one row
  bool whole = groups == 1 || static_cast<long long>(C) * L % VEC == 0;
  for (int g = 0; g < groups; ++g) {
    if (group_channels[g] < 1) return static_cast<int>(cudaErrorInvalidValue);
    p.first[g + 1] = p.first[g] + group_channels[g];
    whole = whole && static_cast<long long>(p.first[g]) * L % VEC == 0;
  }
  if (p.first[groups] != C) return static_cast<int>(cudaErrorInvalidValue);
  const bool vectors = whole && ((reinterpret_cast<std::uintptr_t>(x) |
                                  reinterpret_cast<std::uintptr_t>(out)) %
                                 16) == 0;
  if (groups == 1)
    return vectors ? launch<T, VEC, false>(p, stream)
                   : launch<T, 1, false>(p, stream);
  return vectors ? launch<T, VEC, true>(p, stream)
                 : launch<T, 1, true>(p, stream);
}

}  // namespace

extern "C" {

// Each launch returns a cudaError_t: 0 when the kernel was launched.  x and
// out are contiguous tensors of the storage type with n = B C L elements, x
// [B, C, L]; the output holds the groups' [B, C_g, L] blocks one after
// another, C_g = group_channels[g], the groups' channels summing to C (1 to
// 8 groups; one group is x's layout); mean, var, scale and bias float32
// [C]; eps a 0-d tensor of the storage type; relu_channels the number of
// leading channels the relu applies to, 0 (none) to C (all).  At most 4,096
// channels, 2,457 with more than one group (their factors and groups fill
// the 48 KB of shared memory a block has without opting in).
int ds_bn_relu_f32(const void* x, void* out, const void* mean,
                   const void* var, const void* scale, const void* bias,
                   const void* eps, long long n, int C, int L,
                   int relu_channels, int groups, const int* group_channels,
                   void* stream) {
  return bn_relu<float>(x, out, mean, var, scale, bias, eps, n, C, L,
                        relu_channels, groups, group_channels, stream);
}

int ds_bn_relu_bf16(const void* x, void* out, const void* mean,
                    const void* var, const void* scale, const void* bias,
                    const void* eps, long long n, int C, int L,
                    int relu_channels, int groups, const int* group_channels,
                    void* stream) {
  return bn_relu<bf16>(x, out, mean, var, scale, bias, eps, n, C, L,
                       relu_channels, groups, group_channels, stream);
}

}  // extern "C"
