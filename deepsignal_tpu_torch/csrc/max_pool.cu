// Max-pool of window 3 with TF's SAME padding over a [B, C, L] activation at
// inference: models/layers.py::max_pool_same, Inception's 14 pools (11 of
// stride 1 at the head of each block's branch 1, 3 of stride 2 between the
// stages).
//
// It replaces no TPU kernel: the JAX package leaves pooling to XLA's
// reduce_window (flax's nn.max_pool), which takes the -inf pad inside its
// window arithmetic.  On the card torch ran each pool as two passes: F.pad
// wrote a copy of the activation padded with -inf (a fill, then a strided
// copy), and F.max_pool1d read that copy through ATen's
// max_pool1d_with_indices, whose kernel (max_pool_forward_nchw) writes an
// int64 index beside every output value that nothing reads: ~11 GB a
// 4,096-row forward in bfloat16 for 2.78 GB of inputs read and outputs
// written.
//
// What bounds it: device memory.  Each input is read once and each output
// written once, for three compares an output.  So the design moves the
// fewest bytes at the highest rate:
//   - stride 1 (output as long as the input): 16-byte vector loads and
//     stores over the flattened tensor (8 bfloat16 or 4 float32 elements),
//     each thread's two neighbours taken from the neighbouring lanes'
//     vectors with warp shuffles (lane 0, lane 31 and the last vector load
//     theirs, with the next vector, so that no load waits alone).  A row's
//     first and last elements see the pad (-inf) beyond its edge.  A vector
//     may straddle rows (L = 45 and 23 are not multiples of 8), so each
//     thread carries its position in the row with adds and compares, and
//     divides once, at its start;
//   - stride 2 (half the output): one output a thread, its three inputs read
//     with loads that neighbouring threads coalesce, the row and the
//     position in it carried the same way;
//   - a grid of as many blocks as the card keeps resident, each striding
//     over the whole tensor; the wrapper asks for that count once per
//     device, dtype, stride and alignment (ds_max_pool_grid_*).
// A tensor whose base is not on a 16-byte boundary takes the stride-1
// kernel one element a thread.
//
// The bits are torch's.  ATen's kernel scans each window left to right in
// float, starting from -inf, and takes a value where it is greater than the
// max so far or NaN; so does take() below.  Hence the first of two equal
// values wins (the sign of a zero is kept as torch keeps it), a NaN anywhere
// in the window gives NaN (its payload may differ), and the pad never wins:
// it is -inf under a strict >.  fmaxf and __hmax would differ on both.
// Every other value is one of the inputs, exact in float, stored back as it
// was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

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

// ATen's step of the scan: a value greater than the max so far, or NaN
__device__ __forceinline__ void take(float v, float& m) {
  if (v > m || isnan(v)) m = v;
}

__device__ __forceinline__ float window_max(float left, float mid,
                                            float right) {
  float m = -INFINITY;
  take(left, m);
  take(mid, m);
  take(right, m);
  return m;
}

// One warp's step of the stride-1 kernel: a lane's vector, and the
// neighbours that no other lane of the warp holds
template <typename T, int VEC>
struct Span {
  Pack<T, VEC> p;
  float left;
  float right;
};

template <typename T, int VEC>
__device__ __forceinline__ Span<T, VEC> fetch(const T* __restrict__ x,
                                              long long n, long long nvec,
                                              long long v, int lane,
                                              int pos) {
  Span<T, VEC> s;
  s.left = s.right = -INFINITY;
  if (v < nvec) {
    s.p = reinterpret_cast<const Pack<T, VEC>*>(x)[v];
    const long long e0 = v * VEC;
    if (lane == 0 && pos != 0) s.left = to_float(x[e0 - 1]);
    if ((lane == 31 || v + 1 == nvec) && e0 + VEC < n)
      s.right = to_float(x[e0 + VEC]);
  }
  return s;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    max_pool3_s1_kernel(const T* __restrict__ x, T* __restrict__ out,
                        long long n, int L) {
  const int lane = threadIdx.x & 31;
  const long long nvec = n / VEC;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  // every lane of a warp runs each step of the loop (the shuffles need all
  // 32): the loop's test is on the warp's first vector
  long long base = static_cast<long long>(blockIdx.x) * THREADS +
                   (threadIdx.x - lane);
  long long v = base + lane;
  // the row position of the vector's first element, moved by ds a step
  const int ds = static_cast<int>(step * VEC % L);
  int pos = static_cast<int>(v * VEC % L);
  Span<T, VEC> cur = fetch<T, VEC>(x, n, nvec, v, lane, pos);
  for (; base < nvec; base += step, v += step) {
    const int next_pos = pos + ds >= L ? pos + ds - L : pos + ds;
    const Span<T, VEC> next =
        fetch<T, VEC>(x, n, nvec, v + step, lane, next_pos);
    const bool live = v < nvec;
    float a[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      a[j] = live ? to_float(cur.p.e[j]) : -INFINITY;
    float left = __shfl_up_sync(FULL, a[VEC - 1], 1);
    float right = __shfl_down_sync(FULL, a[0], 1);
    if (lane == 0) left = cur.left;
    if (lane == 31 || v + 1 == nvec) right = cur.right;
    if (live) {
      Pack<T, VEC> r;
      int q = pos;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float l = q == 0 ? -INFINITY : (j == 0 ? left : a[j - 1]);
        const float rt =
            q == L - 1 ? -INFINITY : (j == VEC - 1 ? right : a[j + 1]);
        r.e[j] = from_float<T>(window_max(l, a[j], rt));
        if (++q == L) q = 0;
      }
      reinterpret_cast<Pack<T, VEC>*>(out)[v] = r;
    }
    cur = next;
    pos = next_pos;
  }

  // the last n % VEC elements, one a thread of block 0
  const long long e = nvec * VEC + threadIdx.x;
  if (blockIdx.x == 0 && e < n) {
    const int q = static_cast<int>(e % L);
    const float l = q == 0 ? -INFINITY : to_float(x[e - 1]);
    const float rt = q == L - 1 ? -INFINITY : to_float(x[e + 1]);
    out[e] = from_float<T>(window_max(l, to_float(x[e]), rt));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    max_pool3_s2_kernel(const T* __restrict__ x, T* __restrict__ out,
                        long long rows, int L, int L_out, int pad_left) {
  const long long n_out = rows * L_out;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long o = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  long long row = o / L_out;
  int q = static_cast<int>(o - row * L_out);
  const long long d_row = step / L_out;
  const int dq = static_cast<int>(step - d_row * L_out);
  for (; o < n_out; o += step) {
    const T* in = x + row * L;
    const int i = 2 * q - pad_left;
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k)   // a position in the pad skips: -inf
      if (i + k >= 0 && i + k < L) take(to_float(in[i + k]), m);
    out[o] = from_float<T>(m);
    row += d_row;
    q += dq;
    if (q >= L_out) {
      q -= L_out;
      ++row;
    }
  }
}

template <typename T>
int grid(int stride, int aligned, int* blocks) {
  constexpr int VEC = static_cast<int>(16 / sizeof(T));
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  if (stride == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, max_pool3_s2_kernel<T>, THREADS, 0);
  else if (stride == 1 && aligned)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, max_pool3_s1_kernel<T, VEC>, THREADS, 0);
  else if (stride == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, max_pool3_s1_kernel<T, 1>, THREADS, 0);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

template <typename T>
int max_pool(const void* x, void* out, long long rows, int L, int stride,
             int blocks, void* stream) {
  if (rows < 0 || L < 1 || (stride != 1 && stride != 2) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L_out = (L + stride - 1) / stride;
  const long long n_out = rows * L_out;
  if (n_out == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const T* in = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  long long work;
  if (stride == 2) {
    // TF SAME: (L_out - 1) * 2 + 3 - L positions of pad, the extra one right
    const int pad = (L_out - 1) * 2 + 3 - L;
    work = (n_out + THREADS - 1) / THREADS;
    max_pool3_s2_kernel<T><<<static_cast<unsigned>(
                                 work < blocks ? work : blocks),
                             THREADS, 0, s>>>(in, o, rows, L, L_out, pad / 2);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(x) |
                         reinterpret_cast<std::uintptr_t>(out)) % 16) == 0;
  const long long n = rows * L;
  if (aligned) {
    constexpr int VEC = static_cast<int>(16 / sizeof(T));
    // at least one block: the tail's elements are block 0's
    work = (n / VEC + THREADS - 1) / THREADS;
    if (work < 1) work = 1;
    max_pool3_s1_kernel<T, VEC><<<static_cast<unsigned>(
                                      work < blocks ? work : blocks),
                                  THREADS, 0, s>>>(in, o, n, L);
  } else {
    work = (n + THREADS - 1) / THREADS;
    max_pool3_s1_kernel<T, 1><<<static_cast<unsigned>(
                                    work < blocks ? work : blocks),
                                THREADS, 0, s>>>(in, o, n, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The grid of a launch: how many blocks of the kernel for this stride and
// alignment (aligned: input and output on 16-byte boundaries) the current
// device keeps resident, into *blocks.  Returns a cudaError_t, 0 on success.
int ds_max_pool_grid_f32(int stride, int aligned, int* blocks) {
  return grid<float>(stride, aligned, blocks);
}

int ds_max_pool_grid_bf16(int stride, int aligned, int* blocks) {
  return grid<bf16>(stride, aligned, blocks);
}

// Each launch returns a cudaError_t: 0 when the kernel was launched.  x is a
// contiguous [rows, L] tensor of the storage type (rows = B C), out a
// contiguous [rows, ceil(L / stride)] one; stride 1 or 2, the window 3;
// blocks the grid's most blocks, from ds_max_pool_grid_* for the same
// stride and alignment.
int ds_max_pool_f32(const void* x, void* out, long long rows, int L,
                    int stride, int blocks, void* stream) {
  return max_pool<float>(x, out, rows, L, stride, blocks, stream);
}

int ds_max_pool_bf16(const void* x, void* out, long long rows, int L,
                     int stride, int blocks, void* stream) {
  return max_pool<bf16>(x, out, rows, L, stride, blocks, stream);
}

}  // extern "C"
