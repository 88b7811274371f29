// Fused 3-layer x 2-direction TF-LSTMCell encoder: [B, T, 8H] layer-0
// projections -> [B, 2H] (concat of the last forward h2 and the first
// backward h2).
//
// Replaces the TPU kernel deepsignal_tpu/ops/pallas/lstm.py::_encoder_kernel
// (launched by bilstm_encoder_pallas).  What it computes is the same; the
// layout is not.  The TPU kernel kept all recurrent weights (about 10 MB in
// float32) and the 12 h/c states in VMEM and walked time as a sequential grid
// axis.  One H100 SM has 227 KB of shared memory, so here the work of one
// direction and one batch tile is split over a thread-block cluster.
//
// Work.  Per direction and step, layer 0 multiplies h0 by its [H, 4H]
// recurrent rows (the input projection xp comes in precomputed); layers 1
// and 2 multiply concat(h_{L-1}, h_L) by their TF-layout [2H, 4H] kernels
// (rows [0, H) take the lower layer's h).  That is 5H x 4H weights per step,
// 2.62 MB in bfloat16 and 5.24 MB in float32 at H 256, and 2 x 5H x 4H
// FLOP per batch row: 365 GFLOP per batch of 4096 at T 17 (both directions).
//
// Partition.  A cluster of H / 64 CTAs (4 at H 256, 2 at H 128) owns one
// direction and one tile of BT batch rows.  CTA k of the cluster owns hidden
// units [64k, 64k + 64): it computes only those units' 4 x 64 gate columns,
// keeps their cell state c for the 3 layers in registers, and streams only
// its 256 columns of each weight matrix, so the four gates of a unit end in
// the same thread.  After each layer-step it pushes its 64 units of the new
// h into the h buffer of every CTA of the cluster through distributed shared
// memory.
//
// Two cluster barriers per layer-step, as in a single CTA, each split into
// an arrive and a wait with work between them.  A: the new h waits in
// registers until every CTA has read the old one; each CTA arrives after its
// product and waits after its cell update.  B: the next layer reads the new
// h only once it is complete; each CTA arrives after its stores, and the
// next layer (1 and 2) first multiplies its own recurrent half (rows
// [H, 2H), the old h_L) and waits before the half that reads h_{L-1}.
//
// Shared memory of one CTA (H 256; the tile plan in ops/cuda/lstm.py repeats
// this sum and the launch checks that both agree):
//   bfloat16, BT 64: h of 3 layers [3][64][256] bf16 96 KB, 3 weight stages
//     of [64 K-rows][256 cols] 32 KB each 96 KB, xp slice [64][256] 32 KB,
//     6 mbarriers 48 B: 229,424 bytes of the 232,448 a CTA may have.
//   float32, BT 32: h [3][32][256] f32 96 KB, 3 stages of [32][256] f32
//     32 KB each 96 KB, xp slice [32][256] 32 KB, mbarriers: 229,424.
// One CTA per SM, 256 threads (8 warps).  Registers: the accumulators (64
// floats bf16, 32 f32), c of the 3 layers (48 / 24), the thread's biases of
// the 3 layers (24 / 12) and the MMA or FMA operands; no spills.
//
// L2 weight traffic per batch of 4096 (H 256, T 17): every cluster streams
// its direction's 5H x 4H weights once per step.  bfloat16: 64 tiles x 2
// directions x 17 x 2.62 MB = 5.7 GB (the 16-row single-CTA design read
// 22.8 GB).  float32: 128 tiles x 2 x 17 x 5.24 MB = 22.8 GB (was 45.6 GB).
// At L2's ~5.5 TB/s that is ~1.0 ms (bf16) and ~4.1 ms (f32).  The card
// runs 30 clusters of 4 at once, so a batch of 4096 takes 5 waves of
// clusters in bfloat16 (128 clusters) and 9 in float32 (256).
//
// Products.
// - bfloat16: mma.sync.m16n8k16 bf16 x bf16 -> f32 on the tensor cores.
//   The weights keep the TF layout; a CTA stages its four column blocks
//   [K, g*H + 64k, +64), g = 0..3, side by side.  Of the CTA's [64 rows] x
//   [256 cols] product warp w takes all 64 rows (4 m16 tiles) and units
//   [8w, 8w + 8) of each gate (4 n8 tiles): 64 f32 accumulators a thread.
//   A (h) is read by ldmatrix.x4, B (a weight K-slice) by ldmatrix.x4.trans;
//   both buffers permute 16-byte chunks by (row & 7), so the 8 rows of an
//   8x8 matrix hit 8 different bank groups.  Thread (warp w, lane l) holds
//   rows 16m + l/4 + {0, 8} and units 8w + 2(l%4) + {0, 1}: 16 (row, unit)
//   cells x 4 gates.  365 GFLOP at 989 TFLOP/s is 0.37 ms, under the L2
//   time, so bfloat16 is bound by the weight stream and the 51 serial
//   layer-steps.
// - float32: full FP32 on the FMA units (no TF32: the float32 path is the
//   parity path).  The wrapper interleaves the gate columns of every kernel,
//   bias and of xp ([K, H/64, 64, 4]: CTA, unit, gate), so a CTA's 256
//   columns are contiguous and the four gates of a unit are one float4.
//   Warp w takes units [32 (w%2), +32) and rows [8 (w/2), +8), lane l unit
//   32 (w%2) + l: an 8 rows x 4 gates accumulator tile.  Per K-row a thread
//   loads one float4 of weights (a warp 512 contiguous bytes), per four
//   K-rows one float4 of h for each of its rows (the same address for the
//   whole warp): 3 loads per 32 FMAs.  365 GFLOP at 67 TFLOP/s is 5.4 ms;
//   that bounds float32, and its 22.8 GB of L2 reads overlap with it.
//
// Weight stream.  Every thread issues cp.async (16 B, L2 only) copies of the
// next K-slice (SLICE rows x the CTA's 256 columns) into a ring of STAGES
// buffers while the tensor cores or FMAs consume the current one.  Two
// mbarriers per stage replace a barrier of the whole CTA per slice: `full`
// completes when every thread's copies have landed
// (cp.async.mbarrier.arrive), `empty` when every thread has read the stage,
// and a thread refills a stage only after its `empty`, so warps drift by up
// to a slice.  The slice sequence is the same every step (layer 0: H / SLICE
// slices, layers 1 and 2: 2H / SLICE each, recurrent half first), so the
// copies run ahead across layer boundaries and through the epilogues and
// cluster barriers.  The xp slice of a step rides with that step's first
// weight slice.
//
// Ragged batch tiles read the last valid row's xp in place of rows >= B and
// write no output for them.
//
// Numerics follow the TPU kernel: h and c are float32 state; h is rounded to
// the storage type before every product (it is stored in that type); the
// products sum in float32; gate math is float32 (the sigmoid's exp by
// ex2.approx and a reciprocal, within 1e-6 of the library's); the upper-layer
// biases arrive as float32; gate order i, j, f, o with FORGET_BIAS 1.0 on f.
// Layer 0's input product x @ W_x comes in without its bias, and the kernel
// adds the bias as torch adds two tensors of the storage type (float32
// arithmetic, one rounding to the storage type), so xp + b is what the JAX
// package's `x @ w_x + bias` gives.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;         // 8 warps per CTA
constexpr int UNITS = 64;            // hidden units per CTA
constexpr int COLS = 4 * UNITS;      // gate columns per CTA
constexpr int MAX_SMEM = 232448;
constexpr float FORGET_BIAS = 1.0f;

template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BT = 64;       // batch rows per cluster
  static constexpr int SLICE = 64;    // K-rows per weight stage
  static constexpr int STAGES = 3;
};
template <> struct Tile<float> {
  static constexpr int BT = 32;
  static constexpr int SLICE = 32;
  static constexpr int STAGES = 3;
  static constexpr int RPT = 8;       // batch rows per thread
  static_assert(BT * UNITS == RPT * THREADS, "one unit, RPT rows a thread");
};

// The shape of one instantiation: storage type T, hidden size H.
template <typename T, int H_>
struct Cfg : Tile<T> {
  static constexpr int H = H_;
  static constexpr int G = 4 * H;          // gate columns of a kernel row
  static constexpr int NR = H / UNITS;     // CTAs per cluster
  static constexpr int L0 = H / Tile<T>::SLICE;  // slices of layer 0
  static constexpr int PER_STEP = 5 * L0;  // slices of one step
  static constexpr int SMEM =
      (3 * Tile<T>::BT * H + Tile<T>::STAGES * Tile<T>::SLICE * COLS +
       Tile<T>::BT * COLS) * (int)sizeof(T) + 2 * Tile<T>::STAGES * 8;
  static_assert(SMEM <= MAX_SMEM, "one CTA's shared memory");
  static_assert(H % Tile<T>::SLICE == 0 && NR <= 8, "tile");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// sigmoid by ex2.approx and a reciprocal (its result in (0, 1) needs no
// more); tanh by the library, whose error stays relative near 0, where h is
// small and a bfloat16 step is fine.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float lstm_cell(float& c, float gi, float gj,
                                           float gf, float go) {
  c = sigmoid(gf + FORGET_BIAS) * c + sigmoid(gi) * tanhf(gj);
  return sigmoid(go) * tanhf(c);
}

// Element offset of (row, col) in an h buffer [rows][width].  bfloat16:
// 16-byte chunks permuted by row & 7 (ldmatrix reads 8 rows of one chunk
// column at once), so adding a multiple of 8 to row adds that many rows of
// width and the readers and writers below fold it into immediates.
// float32: plain (all lanes of a warp read the same float4).
template <typename T, int WIDTH>
__device__ __forceinline__ int h_at(int row, int col) {
  if constexpr (sizeof(T) == 2)
    return row * WIDTH + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
  else
    return row * WIDTH + col;
}

// Element offset of (row, col) in a weight stage or the xp slice [rows][256]:
// bfloat16 permuted as h, float32 plain (its readers hit distinct banks).
template <typename T>
__device__ __forceinline__ int w_at(int row, int col) {
  if constexpr (sizeof(T) == 2)
    return h_at<T, COLS>(row, col);
  else
    return row * COLS + col;
}

// Global column of the CTA's 16-byte chunk cc (of COLS / E) in a [K, 4H]
// matrix, xp or bias: bfloat16 keeps the TF gate blocks (chunk cc is gate
// cc / 8, units 8 (cc % 8) ..); float32 arrives gate-interleaved, the CTA's
// 256 columns contiguous.
template <typename T, int H>
__device__ __forceinline__ int src_col(int cc, int u0) {
  if constexpr (sizeof(T) == 2)
    return (cc >> 3) * H + u0 + (cc & 7) * 8;
  else
    return 4 * u0 + cc * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// mbarriers in shared memory (`bar` is a shared address).  The ring of
// weight stages has two per stage: `full` completes when every thread's
// copies into the stage have landed, `empty` when every thread is done
// reading it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The cluster barrier in two halves; every thread of the cluster takes part.
// The release and acquire order this CTA's shared-memory reads and its
// stores into other CTAs against the other side of the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in CTA `rank` of the cluster of the local shared address a.
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Direction {
  const void* wh0;   // [H, 4H]  layer-0 recurrent rows
  const void* k1;    // [2H, 4H] layer 1: rows [0,H) input, [H,2H) recurrent
  const void* k2;    // [2H, 4H] layer 2
  const void* b0;    // [4H] layer 0, storage type
  const float* b1;   // [4H]
  const float* b2;   // [4H]
};

struct Params {
  const void* xp;    // [B, T, 2, 4H] layer-0 x @ W_x, fw then bw
  Direction dir[2];
  void* out;         // [B, 2H]
  int B, T;
};

// What a thread of one CTA keeps for the whole launch: its shared buffers,
// its place in the cluster, and the shared addresses it reads and stores
// at, less the parts that are immediates.
template <typename T>
struct Ctx {
  T* h;           // [3][BT][H]
  T* w;           // [STAGES][SLICE][COLS]
  T* x;           // [BT][COLS]
  uint32_t full, empty;  // shared addresses of the [STAGES] mbarriers
  const void* wmat[3];  // this direction's wh0, k1, k2
  int dir, b0, u0;
  // bf16: byte offset of the ldmatrix A row address for each 16 K-columns
  // of a slice; f32 (a_read[0]): element offset of the thread's first h row
  uint32_t a_read[4];
  uint32_t b_read;      // bf16: byte offset of the ldmatrix B row address in
                        // a stage; f32: element offset of the unit's gates
  uint32_t h_store[8];  // this thread's first h cell in each CTA of the
                        // cluster (shared::cluster addresses)
};

// The per-step sequence of weight K-slices, the same every step: layer 0's
// L0 slices of wh0; then for layer 1 the recurrent rows [H, 2H) of k1 and
// then its input rows [0, H); then layer 2 likewise.  issue(i) copies slice
// i (and, for a step's first slice, that step's xp slice) into the ring;
// the stage's `full` mbarrier completes when they have landed.
template <typename T, int H>
__device__ __forceinline__ void issue(const Params& p, const Ctx<T>& cx,
                                      int i) {
  using C = Cfg<T, H>;
  constexpr int E = 16 / (int)sizeof(T);      // elements per 16-byte chunk
  constexpr int CPR = COLS / E;                // chunks per stage row
  const int s = i / C::PER_STEP;
  if (s < p.T) {
    const int j = i - s * C::PER_STEP;
    const void* w;
    int k0;
    if (j < C::L0) {
      w = cx.wmat[0];
      k0 = j * C::SLICE;
    } else {
      const int q = (j - C::L0) % (2 * C::L0);
      w = j < 3 * C::L0 ? cx.wmat[1] : cx.wmat[2];
      k0 = q < C::L0 ? H + q * C::SLICE : (q - C::L0) * C::SLICE;
    }
    const uint32_t stage =
        smem_u32(cx.w + (i % C::STAGES) * C::SLICE * COLS);
    const int cc = threadIdx.x % CPR;
    const T* src = static_cast<const T*>(w) +
                   (size_t)(k0 + threadIdx.x / CPR) * C::G +
                   src_col<T, H>(cc, cx.u0);
    static_assert(C::SLICE * CPR % THREADS == 0, "whole copies a thread");
#pragma unroll
    for (int m = 0; m < C::SLICE * CPR / THREADS; ++m) {
      const int kr = threadIdx.x / CPR + m * (THREADS / CPR);
      cp_async16(stage + sizeof(T) * w_at<T>(kr, cc * E),
                 src + (size_t)m * (THREADS / CPR) * C::G);
    }
    if (j == 0) {
      const int t = cx.dir == 0 ? s : p.T - 1 - s;
      const T* xp = static_cast<const T*>(p.xp);
      static_assert(C::BT * CPR % THREADS == 0, "whole copies a thread");
#pragma unroll
      for (int m = 0; m < C::BT * CPR / THREADS; ++m) {
        const int r = threadIdx.x / CPR + m * (THREADS / CPR);
        const int row = min(cx.b0 + r, p.B - 1);
        cp_async16(smem_u32(cx.x + w_at<T>(r, cc * E)),
                   xp + (((size_t)row * p.T + t) * 2 + cx.dir) * C::G +
                       src_col<T, H>(cc, cx.u0));
      }
    }
    cp_async_arrive(cx.full + 8 * (i % C::STAGES));
  }
}

// ---------------------------------------------------------------- bfloat16

struct AccBf16 {
  float v[4][4][4];  // [m16 tile][gate][mma fragment]
};

// acc += h[64 rows][ka, ka + SLICE) @ stage[SLICE][COLS] on the tensor
// cores; `a` points at h's column ka.
template <int H, int SLICE>
__device__ __forceinline__ void slice_product(AccBf16& acc,
                                              const __nv_bfloat16* a,
                                              const __nv_bfloat16* w,
                                              const Ctx<__nv_bfloat16>& cx) {
  // a_read holds the permuted A offsets of a slice's four 16-column steps;
  // they repeat every 64 columns (8 chunks, the permutation's period)
  static_assert(SLICE == 64, "a slice is 64 K-rows");
  const uint32_t abase = smem_u32(a), stage = smem_u32(w);
#pragma unroll
  for (int kk = 0; kk < SLICE; kk += 16) {
    uint32_t fa[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)  // rows 16 mt: 16 mt H elements on
      ldmatrix_x4(fa[mt], abase + cx.a_read[kk / 16] + mt * 32 * H);
    uint32_t fb[4][2];
#pragma unroll
    for (int gp = 0; gp < 4; gp += 2)  // K-rows kk: kk COLS elements on
      ldmatrix_x4_trans(fb[gp][0], fb[gp][1], fb[gp + 1][0], fb[gp + 1][1],
                        stage + cx.b_read + kk * 2 * COLS + gp * 2 * UNITS);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        mma_bf16(acc.v[mt][g], fa[mt], fb[g][0], fb[g][1]);
  }
}

// ------------------------------------------------------------------ float32

struct AccF32 {
  float v[Tile<float>::RPT][4];  // [row][gate]
};

// acc += h[8 rows of this thread][ka, ka + SLICE) @ stage[SLICE][4 gates of
// this thread's unit]; the stage is [K][unit][gate].  `a` points at h's
// column ka (a warp reads one row's float4 at a time), `w` at the stage.
template <int H, int SLICE>
__device__ __forceinline__ void slice_product(AccF32& acc, const float* a,
                                              const float* w,
                                              const Ctx<float>& cx) {
  const float* ar = a + cx.a_read[0];
  const float* wc = w + cx.b_read;
#pragma unroll
  for (int k = 0; k < SLICE; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wv[kk] = *reinterpret_cast<const float4*>(wc + (k + kk) * COLS);
#pragma unroll
    for (int r = 0; r < Tile<float>::RPT; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(ar + r * H + k);
      float* s = acc.v[r];
      s[0] = fmaf(hv.x, wv[0].x, s[0]);
      s[1] = fmaf(hv.x, wv[0].y, s[1]);
      s[2] = fmaf(hv.x, wv[0].z, s[2]);
      s[3] = fmaf(hv.x, wv[0].w, s[3]);
      s[0] = fmaf(hv.y, wv[1].x, s[0]);
      s[1] = fmaf(hv.y, wv[1].y, s[1]);
      s[2] = fmaf(hv.y, wv[1].z, s[2]);
      s[3] = fmaf(hv.y, wv[1].w, s[3]);
      s[0] = fmaf(hv.z, wv[2].x, s[0]);
      s[1] = fmaf(hv.z, wv[2].y, s[1]);
      s[2] = fmaf(hv.z, wv[2].z, s[2]);
      s[3] = fmaf(hv.z, wv[2].w, s[3]);
      s[0] = fmaf(hv.w, wv[3].x, s[0]);
      s[1] = fmaf(hv.w, wv[3].y, s[1]);
      s[2] = fmaf(hv.w, wv[3].z, s[2]);
      s[3] = fmaf(hv.w, wv[3].w, s[3]);
    }
  }
}

// -------------------------------------------------------------- the kernel

// One layer of one step: the product over the layer's K-slices, the cell
// update in registers, then the new h into every CTA of the cluster.  `i` is
// the running slice index of the weight stream.  On entry the last cluster
// barrier phase (B of the layer below, or of layer 2 for layer 0) has been
// arrived at and not yet waited for; on exit this layer's B likewise.
template <typename T, int H, int L, typename Acc, typename Cell,
          typename Bias>
__device__ __forceinline__ void layer_step(const Params& p, const Ctx<T>& cx,
                                           int& i, int s, Cell& c,
                                           const Bias& bias) {
  using C = Cfg<T, H>;
  constexpr int BT = C::BT, SLICE = C::SLICE, STAGES = C::STAGES;
  constexpr int NSLICES = L == 0 ? C::L0 : 2 * C::L0;
  Acc acc;
#pragma unroll
  for (int q = 0; q < (int)(sizeof(Acc) / sizeof(float)); ++q)
    reinterpret_cast<float*>(&acc)[q] = 0.0f;
#pragma unroll 1
  for (int q = 0; q < NSLICES; ++q, ++i) {
    // layer 0 reads h0 (complete since layer 1 of the last step); layers 1
    // and 2 read their own old h first, then wait for B of the layer below
    // before reading its new h
    if (L > 0 && q == C::L0) cluster_wait();
    // slice i + STAGES - 1 refills the stage of slice i - 1 once every
    // thread is done with it; then wait for slice i to land
    if (i > 0)
      mbar_wait(cx.empty + 8 * ((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
    issue<T, H>(p, cx, i + STAGES - 1);
    mbar_wait(cx.full + 8 * (i % STAGES), (i / STAGES) & 1);
    const int src = L == 0 ? 0 : (q < C::L0 ? L : L - 1);
    const int ka = (q < C::L0 ? q : q - C::L0) * SLICE;
    slice_product<H, SLICE>(acc, cx.h + src * BT * H + ka,
                            cx.w + (i % STAGES) * SLICE * COLS, cx);
    mbar_arrive(cx.empty + 8 * (i % STAGES));
  }
  if (L == 0) cluster_wait();  // B of layer 2, last step: h2 complete
  cluster_arrive();            // A: this CTA is done reading the old h_L
  const bool last = L == 2 && s == p.T - 1;
  T* out = static_cast<T*>(p.out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    // cells: rows 16 mt + lane/4 + 8 hf, units 8 warp + 2 (lane%4) + e
    const int ul = warp * 8 + 2 * (lane & 3);
    uint32_t hn[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = mt * 16 + (lane >> 2) + 8 * hf;
        float pre[4][2];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float2 add = make_float2(bias[L][g][0], bias[L][g][1]);
          if (L == 0) {  // xp + b rounded as torch adds two bfloat16 tensors
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    cx.x + w_at<T>(row, g * UNITS + ul)));
            add = __bfloat1622float2(
                __floats2bfloat162_rn(xv.x + add.x, xv.y + add.y));
          }
          pre[g][0] = acc.v[mt][g][2 * hf] + add.x;
          pre[g][1] = acc.v[mt][g][2 * hf + 1] + add.y;
        }
        float h2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          h2[e] = lstm_cell(c[L][(mt * 2 + hf) * 2 + e], pre[0][e], pre[1][e],
                            pre[2][e], pre[3][e]);
        __nv_bfloat162 hb = __floats2bfloat162_rn(h2[0], h2[1]);
        hn[mt][hf] = *reinterpret_cast<uint32_t*>(&hb);
      }
    cluster_wait();  // A: every CTA has read h_L of the last step
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t off = 2 * (L * BT * H + (mt * 16 + 8 * hf) * H);
#pragma unroll
        for (int r = 0; r < C::NR; ++r)
          st_cluster(cx.h_store[r] + off, hn[mt][hf]);
        const int row = cx.b0 + mt * 16 + (lane >> 2) + 8 * hf;
        if (last && row < p.B)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * 2 * H +
                                       cx.dir * H + cx.u0 + ul) = hn[mt][hf];
      }
  } else {
    // cells: rows 8 (warp/2) + r, unit 32 (warp%2) + lane
    constexpr int RPT = Tile<float>::RPT;
    const int ul = (warp & 1) * 32 + lane, rg = warp >> 1;
    float hn[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float4 add = make_float4(bias[L][0], bias[L][1], bias[L][2], bias[L][3]);
      if (L == 0) {  // xp + b, one float32 rounding as in torch
        const float4 xv = *reinterpret_cast<const float4*>(
            cx.x + w_at<T>(rg * RPT + r, ul * 4));
        add = make_float4(xv.x + add.x, xv.y + add.y, xv.z + add.z,
                          xv.w + add.w);
      }
      hn[r] = lstm_cell(c[L][r], acc.v[r][0] + add.x, acc.v[r][1] + add.y,
                        acc.v[r][2] + add.z, acc.v[r][3] + add.w);
    }
    cluster_wait();  // A: every CTA has read h_L of the last step
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const uint32_t off = 4 * (L * BT * H + r * H);
#pragma unroll
      for (int q = 0; q < C::NR; ++q)
        st_cluster(cx.h_store[q] + off, __float_as_uint(hn[r]));
      const int row = cx.b0 + rg * RPT + r;
      if (last && row < p.B)
        out[(size_t)row * 2 * H + cx.dir * H + cx.u0 + ul] = hn[r];
    }
  }
  cluster_arrive();  // B: this CTA's part of the new h_L is stored
}

template <typename T, int H>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_encoder_kernel(const Params p) {
  using C = Cfg<T, H>;
  constexpr int BT = C::BT, SLICE = C::SLICE, STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ctx<T> cx;
  cx.h = reinterpret_cast<T*>(smem_raw);
  cx.w = cx.h + 3 * BT * H;
  cx.x = cx.w + STAGES * SLICE * COLS;
  cx.full = smem_u32(cx.x + BT * COLS);
  cx.empty = cx.full + 8 * STAGES;
  cx.dir = blockIdx.z;
  cx.b0 = blockIdx.y * BT;
  cx.u0 = (int)cg::this_cluster().block_rank() * UNITS;
  const Direction d = cx.dir == 0 ? p.dir[0] : p.dir[1];
  cx.wmat[0] = d.wh0;
  cx.wmat[1] = d.k1;
  cx.wmat[2] = d.k2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int hs;  // this thread's first h cell
  if constexpr (sizeof(T) == 2) {
    // ldmatrix.x4 row addresses: A, lanes 0-15 rows 0-15 of the first 8
    // K-columns, lanes 16-31 those of the next 8; B, lanes 0-15 K-rows 0-15
    // of gate gp, lanes 16-31 of gate gp + 1; this warp's 8 units
    const int r16 = lane & 15, hi = lane >> 4;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
      cx.a_read[kq] = 2 * h_at<T, H>(r16, kq * 16 + hi * 8);
    cx.b_read = 2 * w_at<T>(r16, hi * UNITS + warp * 8);
    hs = h_at<T, H>(lane >> 2, cx.u0 + warp * 8 + 2 * (lane & 3));
  } else {
    // warp w takes units [32 (w%2), +32) and rows [8 (w/2), +8); lane l
    // unit 32 (w%2) + l
    const int ul = (warp & 1) * 32 + lane, rg = warp >> 1;
    cx.a_read[0] = h_at<T, H>(rg * Tile<float>::RPT, 0);
    cx.b_read = ul * 4;
    hs = h_at<T, H>(rg * Tile<float>::RPT, cx.u0 + ul);
  }
#pragma unroll
  for (int r = 0; r < C::NR; ++r)
    cx.h_store[r] = map_rank(smem_u32(cx.h + hs), r);

  if (threadIdx.x == 0) {
    for (int q = 0; q < STAGES; ++q) {
      mbar_init(cx.full + 8 * q, THREADS);
      mbar_init(cx.empty + 8 * q, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = threadIdx.x; q < 3 * BT * H; q += THREADS) cx.h[q] = T(0.0f);
  __syncthreads();  // the mbarriers are set up and this CTA's h is zero
  for (int q = 0; q < STAGES - 1; ++q) issue<T, H>(p, cx, q);
  // every CTA of the cluster runs and has zeroed its h; layer 0 of step 0
  // waits for this as for layer 2's B
  cluster_arrive();

  // the biases of this thread's gate columns and its cells' c, per layer
  constexpr int CELLS = sizeof(T) == 2 ? 16 : Tile<float>::RPT;
  using Acc = typename std::conditional<sizeof(T) == 2, AccBf16, AccF32>::type;
  using Bias = typename std::conditional<sizeof(T) == 2, float[3][4][2],
                                         float[3][4]>::type;
  Bias bias;
  const float* upper[2] = {d.b1, d.b2};
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (sizeof(T) == 2) {  // units ul, ul + 1, TF gate blocks
        const int col = g * H + cx.u0 + warp * 8 + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bias[l][g][e] = l == 0 ? to_float(static_cast<const T*>(d.b0)[col + e])
                                 : upper[l - 1][col + e];
      } else {  // unit ul, gate-interleaved
        const int col = 4 * (cx.u0 + (warp & 1) * 32 + lane) + g;
        bias[l][g] = l == 0 ? static_cast<const float*>(d.b0)[col]
                            : upper[l - 1][col];
      }
    }
  float c[3][CELLS];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int q = 0; q < CELLS; ++q) c[l][q] = 0.0f;
  int i = 0;
#pragma unroll 1
  for (int s = 0; s < p.T; ++s) {
    layer_step<T, H, 0, Acc>(p, cx, i, s, c, bias);
    layer_step<T, H, 1, Acc>(p, cx, i, s, c, bias);
    layer_step<T, H, 2, Acc>(p, cx, i, s, c, bias);
  }
  cluster_wait();  // no CTA leaves while another may store into it
}

template <typename T, int H>
cudaLaunchConfig_t launch_config(int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  using C = Cfg<T, H>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::NR, (B + C::BT - 1) / C::BT, 2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::NR;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int H>
int launch_h(const Params& p, int rows, int cluster, int smem,
             cudaStream_t stream) {
  using C = Cfg<T, H>;
  // the tile plan the wrapper computed must be this build's
  if (rows != C::BT || cluster != C::NR || smem != C::SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_encoder_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T, H>(p.B, stream, attr);
  err = cudaLaunchKernelEx(&cfg, lstm_encoder_kernel<T, H>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* wh0f, const void* k1f, const void* k2f,
           const void* b0f, const float* b1f, const float* b2f,
           const void* wh0b, const void* k1b, const void* k2b,
           const void* b0b, const float* b1b, const float* b2b, void* out,
           int B, int steps, int H, int rows, int cluster, int smem,
           void* stream) {
  if (B <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.xp = xp;
  p.dir[0] = Direction{wh0f, k1f, k2f, b0f, b1f, b2f};
  p.dir[1] = Direction{wh0b, k1b, k2b, b0b, b1b, b2b};
  p.out = out;
  p.B = B;
  p.T = steps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 128) return launch_h<T, 128>(p, rows, cluster, smem, s);
  if (H == 256) return launch_h<T, 256>(p, rows, cluster, smem, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int H>
int active_clusters_h(int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_encoder_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<T, H>::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T, H>(4096, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, lstm_encoder_kernel<T, H>,
                                             &cfg);
}

template <typename T>
int active_clusters(int H, int* out) {
  if (H == 128) return active_clusters_h<T, 128>(out);
  if (H == 256) return active_clusters_h<T, 256>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when the kernel was launched.  xp is layer
// 0's input product x @ W_x without its bias b0, which the kernel adds (in
// the storage type, as torch adds it); b1 and b2 are float32.  H is 128 or
// 256; rows, cluster and smem are the wrapper's tile plan, and a plan that
// is not this build's returns cudaErrorInvalidValue.  The float32 kernels,
// biases and xp come gate-interleaved (ops/cuda/lstm.py::gate_interleave).
int ds_lstm_encoder_f32(const void* xp, const void* wh0f, const void* k1f,
                        const void* k2f, const void* b0f, const float* b1f,
                        const float* b2f, const void* wh0b, const void* k1b,
                        const void* k2b, const void* b0b, const float* b1b,
                        const float* b2b, void* out, int B, int T, int H,
                        int rows, int cluster, int smem, void* stream) {
  return launch<float>(xp, wh0f, k1f, k2f, b0f, b1f, b2f, wh0b, k1b, k2b, b0b,
                       b1b, b2b, out, B, T, H, rows, cluster, smem, stream);
}

int ds_lstm_encoder_bf16(const void* xp, const void* wh0f, const void* k1f,
                         const void* k2f, const void* b0f, const float* b1f,
                         const float* b2f, const void* wh0b, const void* k1b,
                         const void* k2b, const void* b0b, const float* b1b,
                         const float* b2b, void* out, int B, int T, int H,
                         int rows, int cluster, int smem, void* stream) {
  return launch<__nv_bfloat16>(xp, wh0f, k1f, k2f, b0f, b1f, b2f, wh0b, k1b,
                               k2b, b0b, b1b, b2b, out, B, T, H, rows, cluster,
                               smem, stream);
}

// How many clusters of the kernel the card runs at once (one wave).
int ds_lstm_encoder_active_clusters_f32(int H, int* out) {
  return active_clusters<float>(H, out);
}

int ds_lstm_encoder_active_clusters_bf16(int H, int* out) {
  return active_clusters<__nv_bfloat16>(H, out);
}

}  // extern "C"
