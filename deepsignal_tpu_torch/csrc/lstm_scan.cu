// One layer-direction of the TF-LSTMCell scan: [B, T, 4H] input products
// (x @ W_x, computed outside, without the bias) -> [B, T, H], every step
// written at its absolute time index; with `reverse` the recurrence walks
// T-1 -> 0.
//
// Replaces the TPU kernel deepsignal_tpu/ops/pallas/lstm.py::_lstm_scan_kernel
// (launched by lstm_layer_pallas).  That kernel held one 512-row batch tile's
// h and c in VMEM scratch and W_h (1 MB in float32) in VMEM, and walked time
// as the sequential second grid axis.  One H100 SM has 227 KB of shared
// memory, so here W_h is split over a thread-block cluster and stays in its
// shared memory for the whole scan (a persistent RNN).  Two variants, chosen
// by ops/cuda/lstm_scan.py::scan_plan:
//
// Resident (H 128 and 256, the shapes the model runs).  A cluster of H / U
// CTAs owns one tile of BT batch rows for all T steps; the time loop runs
// inside it in place of the TPU's sequential grid axis.  CTA k owns hidden
// units [U k, U k + U): it loads those units' four gate columns of W_h
// ([H, 4U]) into shared memory once (cp.async, completion on an mbarrier),
// keeps their c in registers, and after each step pushes its U units of the
// new h into the h buffer of every CTA of the cluster through distributed
// shared memory.  h is double-buffered, so one cluster barrier per step
// suffices: a CTA arrives after its pushes and waits before the next
// product; the buffer it pushes into was last read one step earlier, before
// the barrier it has already waited for.  Step 0 multiplies h = 0, which
// adds nothing, so it skips the product and the W_h load lands under it.
// Each thread loads its cells' xp for the next step into registers while
// this step computes (a step ahead, from L2/HBM), so xp takes no shared
// memory and the tile can be taller.  The kernel adds the bias to xp as
// torch adds two tensors of the storage type (float32 arithmetic, one
// rounding to the storage type), which is the plain version's
// `x @ W_x + b` bit for bit, and saves the wrapper an elementwise pass.
//
//   bfloat16: U 64, a cluster of 4 CTAs at H 256 (2 at H 128), BT 16 or 32
//     rows.  Shared memory of one CTA at H 256: W_h slice [256][256] bf16
//     128 KB, h [2][BT][256] bf16 (32 KB at BT 32), one mbarrier:
//     163,848 bytes at BT 32, of the 232,448 a CTA may have.  Products on
//     the tensor cores, mma.sync.m16n8k16 bf16 -> f32:
//     warp w takes all BT rows (BT/16 m16 tiles) and units [8w, 8w + 8) of
//     each gate (4 n8 tiles); A (h) by ldmatrix.x4, B (W_h) by
//     ldmatrix.x4.trans, both from buffers whose 16-byte chunks are permuted
//     by (row & 7).  Per step a CTA at BT 32 does 32 x 256 x 256 MACs: 1,024
//     mma, 128 per warp.
//   float32: U 32, a cluster of 8 CTAs at H 256 (4 at H 128), BT 32 or 40
//     rows.  W_h slice [256][128] f32 128 KB, h [2][BT][256] f32 (80 KB at
//     BT 40): 213,000 bytes at BT 40.  Full FP32 on the FMA units (no
//     TF32: float32 is the parity path).  The W_h load picks the columns
//     so that a unit's four gates are one float4 ([K][unit][gate]); warp w takes rows [BT/8 w, +BT/8), lane l unit l.  Per K-row a
//     thread loads one float4 of W_h (a warp 512 contiguous bytes), per four
//     K-rows one float4 of h per row (one address for the whole warp).  Per
//     step a CTA at BT 40 does 40 x 256 x 128 = 1.3 M FMA: ~5.5 us at 128
//     FMA per clock.
//
// The tile is the smaller of the two when the card runs all its clusters in
// one wave (`cudaOccupancyMaxActiveClusters`, ds_lstm_scan_active_clusters_*),
// else the larger: a serial scan that takes a second wave takes twice as
// long.  An H100 SXM runs 30 clusters of 4 and 15 of 8 at once, so the
// training batch of 512 takes bfloat16 BT 32 (16 clusters of 4, 64 SMs;
// BT 16 would need 32) and float32 BT 40 (13 clusters of 8, 104 SMs; BT 32
// would need 16).  The
// smaller tiles serve the call path's batches below 8, where a cluster does
// half (bfloat16) or four fifths (float32) of the larger tile's product.
//
// What bounds it.  The recurrent products are 4.6 GFLOP per launch at B 512,
// T 17, H 256, 5 us at the tensor cores' peak and 68 us on the FMA units;
// W_h now crosses L2 once per cluster and launch (8.4 MB bf16 in 16
// clusters, 13.6 MB f32 in 13), where the streaming design read it once per
// CTA and step (2.2 GB f32, 1.1 GB bf16).  What is left is latency: 17
// serial steps, each a product over K = H with 2 warps per scheduler to hide
// it (bfloat16: 16 dependent k-steps of mma), the cell update, the DSMEM
// push and one cluster barrier.  In float32 every warp also reads the whole
// W_h slice from shared memory, and those loads take dispatch slots from
// the FMAs.  chip_smoke.py times the kernel alone (`kernel_ms`); PERF.md has
// the H100's times.
//
// Streaming (every other H up to 512; at H 512 W_h is 2 MB bf16 and 4 MB
// f32, more than a cluster of 8 holds).  One CTA of H threads owns 4 batch
// rows, thread j hidden unit j; h lives in shared memory as float and W_h
// streams from L2 at every step: (B / 4) x T x |W_h| of L2 reads.  The
// resident design replaced it at H 128 and 256.
//
// Ragged batch tiles read the last valid row's xp in place of rows >= B and
// write no output for them.  Numerics follow the TPU kernel: h and c are
// float32 state; h is rounded to the storage type before every product;
// products accumulate in float32; gate math is float32 (the sigmoid by
// __expf and a reciprocal, tanh by the library); gate order i, j, f, o with
// FORGET_BIAS 1.0 on f; the output is rounded to the storage type.
//
// Backward (float32, H 128 and 256).  The TPU kernel has no gradient of its
// own (JAX differentiates the plain scan), so this one replaces none: it is
// the gradient of the plain version in float32, which the wrapper otherwise
// recomputes step by step under autograd (thousands of small launches a
// train step).  The wrapper works out the gate pre-activations of every step
// in one product, gates = [x_t, h_{t-1}] @ W + b over the saved output h, and
// after this kernel the whole-sequence products dW = [x, h_{t-1}]^T dg,
// d bias = sum dg and dx = dg W_x^T.  The kernel walks the scan backwards:
//
//   dh_t = dy_t + dg_{t+1} W_h^T                      (the serial part)
//   dc_t = dh_t o_t (1 - tanh^2 c_t) + dc_{t+1} f_{t+1}
//   dg_t = [dc_t j_t i_t (1 - i_t), dc_t i_t (1 - j_t^2),
//           dc_t c_{t-1} f_t (1 - f_t), dh_t tanh c_t o_t (1 - o_t)]
//
// with "t + 1" the scan's next step.  The layout is the forward's: a cluster
// of H / 32 CTAs owns a tile of BT rows for the whole scan, CTA k owns units
// [32 k, 32 k + 32) and holds their four gate columns of W_h, now as
// [unit][K][gate] so that lane l reads K-row l + 32 q as one float4.  First
// each thread rebuilds c of its cells for every step, in the forward's
// order, into a global scratch (its own cells only, padded rows included, so
// no thread reads another's), while W_h lands.  Then per step a thread turns
// dh of its cells into dg; the CTA's dg_t spans exactly its W_h columns, so
// its product dg_t W_h^T is a partial dh over all H units, [BT, H], summed
// over 4 x 32 columns.  Lane l of warp w holds rows [BT/8 w, +BT/8) of units
// l + 32 q, and unit l + 32 q belongs to CTA q: it stores that partial into
// CTA q's slot [row][sender][l] through distributed shared memory (a
// reduce-scatter), and after one cluster barrier each owner adds its H / 32
// slots.  The slots are double-buffered like the forward's h, and a warp's
// rows of the buffer it has just read hold its dg_t for the product (it is
// refilled only after the next barrier, which every thread of the cluster
// reaches after its product).  A full [BT, 4H] dg_t exchanged to every CTA
// would not fit: 327 KB at BT 40, double-buffered.
//
//   Shared memory of one CTA at H 256, BT 40: W_h slice 128 KB, slots
//     [2][BT][8][32] f32 80 KB, one mbarrier: 213,000 bytes, the forward's
//     own, so the forward's plan (tile and cluster) serves the backward; its
//     tile is chosen with the backward's own `active_clusters`.
//   Per step a CTA does 40 x 256 x 128 = 1.3 M FMA, as in the forward; each
//     warp reads the W_h slice once (8 x 4 wavefronts of 128 bits per unit)
//     and its rows of dg_t as broadcasts.  What bounds it is again latency:
//     T serial steps of a product, the cell math and one cluster barrier.
//   Its own bytes: gates and dg 2 x 35.7 MB at B 512, T 17, H 256, dy 8.9 MB,
//     c written once and read once (8.9 MB each way), W_h once per cluster.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;      // 8 warps per resident CTA
constexpr int MAX_SMEM = 232448;
constexpr int STREAM_BT = 4;      // batch rows per streaming CTA
constexpr int MAX_H = 512;        // streaming threads per CTA = H
constexpr float FORGET_BIAS = 1.0f;

// hidden units per resident CTA and the batch tiles each type is built for
template <typename T> struct Tiles;
template <> struct Tiles<bf16> {
  static constexpr int UNITS = 64;
  static constexpr int R0 = 16, R1 = 32;
};
template <> struct Tiles<float> {
  static constexpr int UNITS = 32;
  static constexpr int R0 = 32, R1 = 40;
};

// The shape of one resident instantiation: storage type T, hidden H, BT
// batch rows per cluster.
template <typename T, int H_, int BT_>
struct Cfg {
  static constexpr int H = H_, BT = BT_;
  static constexpr int G = 4 * H;             // gate columns of W_h
  static constexpr int UNITS = Tiles<T>::UNITS;
  static constexpr int COLS = 4 * UNITS;      // gate columns per CTA
  static constexpr int NR = H / UNITS;        // CTAs per cluster
  static constexpr int SMEM = (H * COLS + 2 * BT * H) * (int)sizeof(T) + 8;
  static_assert(SMEM <= MAX_SMEM, "one CTA's shared memory");
  static_assert(NR <= 8 && H % 64 == 0, "cluster");
  static_assert(BT % (sizeof(T) == 2 ? 16 : 8) == 0, "whole tiles a warp");
};

struct Params {
  const void* xp;    // [B, T, 4H] x @ W_x, without the bias
  const void* wh;    // [H, 4H] recurrent rows, TF layout
  const void* bias;  // [4H]
  void* out;         // [B, T, H]
  int B, T, reverse;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// sigmoid by __expf and a reciprocal (its result in (0, 1) needs no more);
// tanh by the library, whose error stays relative near 0
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float lstm_cell(float& c, float gi, float gj,
                                           float gf, float go) {
  c = sigmoid(gf + FORGET_BIAS) * c + sigmoid(gi) * tanhf(gj);
  return sigmoid(go) * tanhf(c);
}

// Element offset of (row, col) in a bfloat16 buffer [rows][WIDTH] whose
// 16-byte chunks are permuted by row & 7 (ldmatrix reads 8 rows of one chunk
// column at once, which then hit 8 different bank groups).  Adding a
// multiple of 8 to row, or of 64 to col, adds a constant.
template <int WIDTH>
__device__ __forceinline__ int swz(int row, int col) {
  return row * WIDTH + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
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

// ------------------------------------------------------- resident, bfloat16

// The CTA's W_h slice into shared memory, [H][256] permuted as swz: chunk cc
// of a row is gate cc / 8, units u0 + 8 (cc % 8) ..; then one arrive on
// `bar` per thread when its copies have landed.
template <int H>
__device__ __forceinline__ void load_wh(const bf16* wh, bf16* w, int u0,
                                        uint32_t bar) {
  constexpr int CPR = 32;  // 16-byte chunks per row of 256 columns
  static_assert(H * CPR % THREADS == 0, "whole copies a thread");
#pragma unroll 4
  for (int i = threadIdx.x; i < H * CPR; i += THREADS) {
    const int k = i / CPR, cc = i % CPR;
    cp_async16(smem_u32(w + swz<256>(k, cc * 8)),
               wh + (size_t)k * 4 * H + (cc >> 3) * H + u0 + (cc & 7) * 8);
  }
  cp_async_arrive(bar);
}

// The step's xp of this thread's cells: rows 16 mt + lane/4 + 8 hf, units
// ul, ul + 1 of each gate (one bfloat16 pair).
template <int H, int MT>
__device__ __forceinline__ void load_xp(uint32_t (&x)[MT][2][4],
                                        const Params& p, int b0, int u,
                                        int t) {
  const int lane = threadIdx.x & 31;
  const bf16* xp = static_cast<const bf16*>(p.xp);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = min(b0 + mt * 16 + (lane >> 2) + 8 * hf, p.B - 1);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          xp + ((size_t)row * p.T + t) * 4 * H + u);
#pragma unroll
      for (int g = 0; g < 4; ++g) x[mt][hf][g] = __ldg(src + g * H / 2);
    }
}

template <int H, int BT>
__device__ __forceinline__ void scan_bf16(const Params& p, const bf16* w,
                                          bf16* h, uint32_t bar, int u0,
                                          int b0) {
  using C = Cfg<bf16, H, BT>;
  constexpr int MT = BT / 16, UNITS = C::UNITS, COLS = C::COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ul = warp * 8 + 2 * (lane & 3);  // this thread's units ul, ul + 1
  // ldmatrix.x4 row addresses: A, lanes 0-15 rows 0-15 of the first 8
  // K-columns, lanes 16-31 those of the next 8 (they repeat every 64
  // columns); B, lanes 0-15 K-rows 0-15 of gate gp, lanes 16-31 of gate
  // gp + 1, this warp's 8 units
  const int r16 = lane & 15, hi = lane >> 4;
  uint32_t a_read[4];
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
    a_read[kq] = smem_u32(h) + 2 * swz<H>(r16, kq * 16 + hi * 8);
  const uint32_t b_read = smem_u32(w) + 2 * swz<COLS>(r16, hi * UNITS + warp * 8);
  // this thread's first h cell in every CTA of the cluster
  uint32_t h_store[C::NR];
#pragma unroll
  for (int r = 0; r < C::NR; ++r)
    h_store[r] = map_rank(smem_u32(h + swz<H>(lane >> 2, u0 + ul)), r);
  float bias[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias[g][e] = to_float(static_cast<const bf16*>(p.bias)[g * H + u0 + ul + e]);
  float c[MT][2][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[mt][q / 2][q % 2] = 0.0f;
  uint32_t xr[MT][2][4];
  load_xp<H, MT>(xr, p, b0, u0 + ul, p.reverse ? p.T - 1 : 0);
  bf16* out = static_cast<bf16*>(p.out);

#pragma unroll 1
  for (int s = 0; s < p.T; ++s) {
    const int t = p.reverse ? p.T - 1 - s : s;
    const int cur = s & 1;
    // the next step's xp lands while this one computes (the last step loads
    // its own again)
    const int sn = min(s + 1, p.T - 1);
    uint32_t xn[MT][2][4];
    load_xp<H, MT>(xn, p, b0, u0 + ul, p.reverse ? p.T - 1 - sn : sn);
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[mt][q / 4][q % 4] = 0.0f;
    // every CTA pushed h_s into buffer cur (step 0: every CTA runs)
    cluster_wait();
    if (s > 0) {  // h_0 = 0 adds nothing
      if (s == 1) mbar_wait(bar, 0);  // W_h has landed
      const uint32_t hb = cur * 2 * BT * H;
#pragma unroll 1
      for (int j = 0; j < H / 64; ++j)
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const int kk = j * 64 + kq * 16;
          uint32_t fa[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)  // rows 16 mt: 32 H bytes on
            ldmatrix_x4(fa[mt], a_read[kq] + hb + j * 128 + mt * 32 * H);
          uint32_t fb[4][2];
#pragma unroll
          for (int gp = 0; gp < 4; gp += 2)  // K-rows kk: 2 kk COLS bytes on
            ldmatrix_x4_trans(fb[gp][0], fb[gp][1], fb[gp + 1][0],
                              fb[gp + 1][1],
                              b_read + kk * 2 * COLS + gp * 2 * UNITS);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int g = 0; g < 4; ++g)
              mma_bf16(acc[mt][g], fa[mt], fb[g][0], fb[g][1]);
        }
    }
    // cells: rows 16 mt + lane/4 + 8 hf, units ul + e
    uint32_t hn[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float pre[4][2];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          // xp + b rounded as torch adds two bfloat16 tensors
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xr[mt][hf][g]));
          const float2 add = __bfloat1622float2(__floats2bfloat162_rn(
              xv.x + bias[g][0], xv.y + bias[g][1]));
          pre[g][0] = acc[mt][g][2 * hf] + add.x;
          pre[g][1] = acc[mt][g][2 * hf + 1] + add.y;
        }
        float h2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          h2[e] = lstm_cell(c[mt][hf][e], pre[0][e], pre[1][e], pre[2][e],
                            pre[3][e]);
        __nv_bfloat162 hv = __floats2bfloat162_rn(h2[0], h2[1]);
        hn[mt][hf] = *reinterpret_cast<uint32_t*>(&hv);
      }
    // h_{s+1} into buffer cur ^ 1 of every CTA: last read in step s - 1,
    // before the barrier waited for above
    const uint32_t nb = (cur ^ 1) * 2 * BT * H;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < C::NR; ++r)
          st_cluster(h_store[r] + nb + 2 * (mt * 16 + 8 * hf) * H,
                     hn[mt][hf]);
    cluster_arrive();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = b0 + mt * 16 + (lane >> 2) + 8 * hf;
        if (row < p.B)
          *reinterpret_cast<uint32_t*>(
              out + ((size_t)row * p.T + t) * H + u0 + ul) = hn[mt][hf];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 8; ++q) xr[mt][q / 4][q % 4] = xn[mt][q / 4][q % 4];
  }
}

// -------------------------------------------------------- resident, float32

// The CTA's W_h slice into shared memory as [H][32 units][4 gates], so that
// a unit's gates are one float4; 4-byte copies (the global gates of a unit
// are H apart), a warp reads 128 contiguous bytes of one gate.
template <int H>
__device__ __forceinline__ void load_wh(const float* wh, float* w, int u0,
                                        uint32_t bar) {
  constexpr int COLS = 128;
  static_assert(H * COLS % THREADS == 0, "whole copies a thread");
#pragma unroll 8
  for (int i = threadIdx.x; i < H * COLS; i += THREADS) {
    const int k = i / COLS, g = (i % COLS) / 32, u = i % 32;
    cp_async4(smem_u32(w + k * COLS + u * 4 + g),
              wh + (size_t)k * 4 * H + g * H + u0 + u);
  }
  cp_async_arrive(bar);
}

template <int H, int RPT>
__device__ __forceinline__ void load_xp(float (&x)[RPT][4], const Params& p,
                                        int row0, int u, int t) {
  const float* xp = static_cast<const float*>(p.xp);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float* src =
        xp + ((size_t)min(row0 + r, p.B - 1) * p.T + t) * 4 * H + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[r][g] = __ldg(src + g * H);
  }
}

template <int H, int BT>
__device__ __forceinline__ void scan_f32(const Params& p, const float* w,
                                         float* h, uint32_t bar, int u0,
                                         int b0) {
  using C = Cfg<float, H, BT>;
  constexpr int RPT = BT / 8, COLS = C::COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = b0 + warp * RPT;  // rows row0 + r, unit u0 + lane
  const float* wc = w + lane * 4;
  uint32_t h_store[C::NR];
#pragma unroll
  for (int q = 0; q < C::NR; ++q)
    h_store[q] = map_rank(smem_u32(h + warp * RPT * H + u0 + lane), q);
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    bias[g] = static_cast<const float*>(p.bias)[g * H + u0 + lane];
  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = 0.0f;
  float xr[RPT][4];
  load_xp<H, RPT>(xr, p, row0, u0 + lane, p.reverse ? p.T - 1 : 0);
  float* out = static_cast<float*>(p.out);

#pragma unroll 1
  for (int s = 0; s < p.T; ++s) {
    const int t = p.reverse ? p.T - 1 - s : s;
    const int cur = s & 1;
    const int sn = min(s + 1, p.T - 1);
    float xn[RPT][4];
    load_xp<H, RPT>(xn, p, row0, u0 + lane, p.reverse ? p.T - 1 - sn : sn);
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
    cluster_wait();  // every CTA pushed h_s into buffer cur
    if (s > 0) {     // h_0 = 0 adds nothing
      if (s == 1) mbar_wait(bar, 0);  // W_h has landed
      const float* ar = h + (cur * BT + warp * RPT) * H;
#pragma unroll 4
      for (int k = 0; k < H; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = *reinterpret_cast<const float4*>(wc + (k + kk) * COLS);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(ar + r * H + k);
          float* a = acc[r];
          a[0] = fmaf(hv.x, wv[0].x, a[0]);
          a[1] = fmaf(hv.x, wv[0].y, a[1]);
          a[2] = fmaf(hv.x, wv[0].z, a[2]);
          a[3] = fmaf(hv.x, wv[0].w, a[3]);
          a[0] = fmaf(hv.y, wv[1].x, a[0]);
          a[1] = fmaf(hv.y, wv[1].y, a[1]);
          a[2] = fmaf(hv.y, wv[1].z, a[2]);
          a[3] = fmaf(hv.y, wv[1].w, a[3]);
          a[0] = fmaf(hv.z, wv[2].x, a[0]);
          a[1] = fmaf(hv.z, wv[2].y, a[1]);
          a[2] = fmaf(hv.z, wv[2].z, a[2]);
          a[3] = fmaf(hv.z, wv[2].w, a[3]);
          a[0] = fmaf(hv.w, wv[3].x, a[0]);
          a[1] = fmaf(hv.w, wv[3].y, a[1]);
          a[2] = fmaf(hv.w, wv[3].z, a[2]);
          a[3] = fmaf(hv.w, wv[3].w, a[3]);
        }
      }
    }
    float hn[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)  // xp + b, one float32 rounding as in torch
      hn[r] = lstm_cell(c[r], acc[r][0] + (xr[r][0] + bias[0]),
                        acc[r][1] + (xr[r][1] + bias[1]),
                        acc[r][2] + (xr[r][2] + bias[2]),
                        acc[r][3] + (xr[r][3] + bias[3]));
    const uint32_t nb = (cur ^ 1) * 4 * BT * H;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int q = 0; q < C::NR; ++q)
        st_cluster(h_store[q] + nb + 4 * r * H, __float_as_uint(hn[r]));
    cluster_arrive();
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (row0 + r < p.B)
        out[((size_t)(row0 + r) * p.T + t) * H + u0 + lane] = hn[r];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) xr[r][g] = xn[r][g];
  }
}

// ----------------------------------------------------------- resident kernel

template <typename T, int H, int BT>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_resident_kernel(const Params p) {
  using C = Cfg<T, H, BT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);  // [H][COLS], W_h slice
  T* h = w + H * C::COLS;                 // [2][BT][H]
  const uint32_t bar = smem_u32(h + 2 * BT * H);
  const int u0 = (int)cg::this_cluster().block_rank() * C::UNITS;
  const int b0 = blockIdx.y * BT;
  if (threadIdx.x == 0) {
    mbar_init(bar, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_wh<H>(static_cast<const T*>(p.wh), w, u0, bar);
  // this CTA runs: the others may push h into it (step 0 waits for this)
  cluster_arrive();
  if constexpr (sizeof(T) == 2)
    scan_bf16<H, BT>(p, w, h, bar, u0, b0);
  else
    scan_f32<H, BT>(p, w, h, bar, u0, b0);
  if (p.T < 2) mbar_wait(bar, 0);  // no copy outlives the CTA
  cluster_wait();  // no CTA leaves while another may store into it
}

template <typename T, int H, int BT>
cudaLaunchConfig_t resident_config(int B, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  using C = Cfg<T, H, BT>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C::NR, (B + BT - 1) / BT);
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

template <typename T, int H, int BT>
cudaError_t allow_smem() {
  static bool done = false;  // once per instantiation and process
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_resident_kernel<T, H, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<T, H, BT>::SMEM);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int H, int BT>
int launch_resident(const Params& p, int cluster, int smem,
                    cudaStream_t stream) {
  using C = Cfg<T, H, BT>;
  // the plan the wrapper computed must be this build's
  if (cluster != C::NR || smem != C::SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T, H, BT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = resident_config<T, H, BT>(p.B, stream, attr);
  err = cudaLaunchKernelEx(&cfg, lstm_scan_resident_kernel<T, H, BT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int H, int BT>
int active_resident(int* out) {
  const cudaError_t err = allow_smem<T, H, BT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = resident_config<T, H, BT>(4096, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, lstm_scan_resident_kernel<T, H, BT>, &cfg);
}

// f(std::integral_constant H, std::integral_constant BT) for a built shape
template <typename T, typename F>
int by_shape(int H, int rows, F&& f) {
  using R = Tiles<T>;
  auto tile = [&](auto hc) -> int {
    if (rows == R::R0) return f(hc, std::integral_constant<int, R::R0>{});
    if (rows == R::R1) return f(hc, std::integral_constant<int, R::R1>{});
    return (int)cudaErrorInvalidValue;
  };
  if (H == 128) return tile(std::integral_constant<int, 128>{});
  if (H == 256) return tile(std::integral_constant<int, 256>{});
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int resident(const Params& p, int H, int rows, int cluster, int smem,
             void* stream) {
  if (p.B <= 0 || p.T <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape<T>(H, rows, [&](auto hc, auto bc) {
    return launch_resident<T, decltype(hc)::value, decltype(bc)::value>(
        p, cluster, smem, s);
  });
}

template <typename T>
int active_clusters(int H, int rows, int* out) {
  return by_shape<T>(H, rows, [&](auto hc, auto bc) {
    return active_resident<T, decltype(hc)::value, decltype(bc)::value>(out);
  });
}

// ------------------------------------------------- resident backward, float32

struct BackParams {
  const float* gates;  // [B, T, 4H] pre-activations [x_t, h_{t-1}] @ W + b
  const float* wh;     // [H, 4H] recurrent rows, TF layout
  const float* dy;     // [B, T, H] gradient of the output
  float* c;            // [tiles x BT, T, H] scratch: c of every cell and step
  float* dg;           // [B, T, 4H] gradient of the pre-activations
  int B, T, reverse;
};

// sigmoid as torch computes it (expf, a division): the backward's cost is
// not in its gate math
__device__ __forceinline__ float sigmoid_exact(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The CTA's W_h slice into shared memory as [32 units][H][4 gates], so that
// lane l reads the four gates of one unit at K-row l + 32 q as one float4.  A
// warp copies 4 units of 8 K-rows of one gate: 16 contiguous bytes a K-row
// from global memory, 8 banks of shared memory 4 times.
template <int H>
__device__ __forceinline__ void load_wh_by_unit(const float* wh, float* w,
                                                int u0, uint32_t bar) {
  static_assert(H * 128 % THREADS == 0, "whole copies a thread");
#pragma unroll 8
  for (int i = threadIdx.x; i < H * 128; i += THREADS) {
    const int j = i >> 5;
    const int u = ((j >> 2) & 7) * 4 + (i & 3);
    const int k = (j >> 5) * 8 + ((i >> 2) & 7);
    const int g = j & 3;
    cp_async4(smem_u32(w + (u * H + k) * 4 + g),
              wh + (size_t)k * 4 * H + g * H + u0 + u);
  }
  cp_async_arrive(bar);
}

// The four gate pre-activations of rows row0 + r (the last valid row in place
// of rows >= B), unit u, time t.
template <int H, int RPT>
__device__ __forceinline__ void load_gates(float (&x)[RPT][4],
                                           const BackParams& p, int row0,
                                           int u, int t) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float* src = p.gates +
                       ((size_t)min(row0 + r, p.B - 1) * p.T + t) * 4 * H + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) x[r][g] = __ldg(src + g * H);
  }
}

// What backward step s reads of this thread's cells: the gates and dy at the
// scan position T - 1 - s, and c one position earlier (0 before the first).
template <int H, int RPT>
__device__ __forceinline__ void load_step(float (&gt)[RPT][4],
                                          float (&dy)[RPT], float (&cp)[RPT],
                                          const BackParams& p, const float* cs,
                                          int row0, int u, int s) {
  const int pos = p.T - 1 - s;
  const int t = p.reverse ? p.T - 1 - pos : pos;
  const int tp = p.reverse ? t + 1 : t - 1;
  load_gates<H, RPT>(gt, p, row0, u, t);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    dy[r] = __ldg(p.dy + ((size_t)min(row0 + r, p.B - 1) * p.T + t) * H + u);
    // written by this thread in the sweep: an ordinary load
    cp[r] = pos > 0 ? cs[((size_t)r * p.T + tp) * H] : 0.0f;
  }
}

template <int H, int BT>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_backward_kernel(const BackParams p) {
  using C = Cfg<float, H, BT>;
  constexpr int U = C::UNITS, NR = C::NR, RPT = BT / 8;
  static_assert(U == 32 && NR >= 4, "lane l + 32 q is unit l of CTA q; a "
                "row's slots hold its 4 x 32 dg");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w = reinterpret_cast<float*>(smem_raw);  // [U][H][4], W_h slice
  float* slots = w + H * C::COLS;                 // [2][BT][NR][U]
  const uint32_t bar = smem_u32(slots + 2 * BT * H);
  const int rank = (int)cg::this_cluster().block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr0 = warp * RPT;                    // rows of the tile
  const int row0 = blockIdx.y * BT + tr0;        // rows of the padded batch
  const int u = rank * U + lane;                 // this thread's unit
  if (threadIdx.x == 0) {
    mbar_init(bar, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_wh_by_unit<H>(p.wh, w, rank * U, bar);
  cluster_arrive();  // this CTA runs: the others may store into it

  // c of this thread's cells at every step, in the forward's order
  float* cs = p.c + (size_t)row0 * p.T * H + u;  // row r, time t: (r T + t) H
  {
    float c[RPT], gt[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r) c[r] = 0.0f;
    load_gates<H, RPT>(gt, p, row0, u, p.reverse ? p.T - 1 : 0);
#pragma unroll 1
    for (int s = 0; s < p.T; ++s) {
      const int t = p.reverse ? p.T - 1 - s : s;
      const int sn = min(s + 1, p.T - 1);
      float gn[RPT][4];
      load_gates<H, RPT>(gn, p, row0, u, p.reverse ? p.T - 1 - sn : sn);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        c[r] = sigmoid_exact(gt[r][2] + FORGET_BIAS) * c[r] +
               sigmoid_exact(gt[r][0]) * tanhf(gt[r][1]);
        cs[((size_t)r * p.T + t) * H] = c[r];
#pragma unroll
        for (int g = 0; g < 4; ++g) gt[r][g] = gn[r][g];
      }
    }
  }

  // this thread's partial dh of row tr0 + r, unit lane of CTA q, goes to
  // CTA q's slot [tr0 + r][rank][lane]
  uint32_t push[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q)
    push[q] = map_rank(smem_u32(slots + tr0 * H + rank * U + lane), q);
  float gt[RPT][4], dy[RPT], cp[RPT], ct[RPT], dcf[RPT];
  load_step<H, RPT>(gt, dy, cp, p, cs, row0, u, 0);
  const int t0 = p.reverse ? 0 : p.T - 1;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    ct[r] = cs[((size_t)r * p.T + t0) * H];
    dcf[r] = 0.0f;  // dc_{t+1} f_{t+1}: nothing after the last step
  }

#pragma unroll 1
  for (int s = 0; s < p.T; ++s) {
    const int t = p.reverse ? s : p.T - 1 - s;
    const int cur = s & 1;
    float gn[RPT][4], dyn[RPT], cpn[RPT];
    load_step<H, RPT>(gn, dyn, cpn, p, cs, row0, u, min(s + 1, p.T - 1));
    // every CTA stored its partial dh of this step into slots cur (step 0:
    // every CTA runs)
    cluster_wait();
    float* rows = slots + (cur * BT + tr0) * H;  // this warp's rows of cur
    float dh[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      dh[r] = dy[r];
      if (s > 0) {
#pragma unroll
        for (int q = 0; q < NR; ++q) dh[r] += rows[r * H + q * U + lane];
      }
    }
    __syncwarp();  // the warp has read its rows of cur: they take its dg
    float4 dg[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float ig = sigmoid_exact(gt[r][0]), jg = tanhf(gt[r][1]);
      const float fg = sigmoid_exact(gt[r][2] + FORGET_BIAS);
      const float og = sigmoid_exact(gt[r][3]), tc = tanhf(ct[r]);
      const float dc = dh[r] * og * (1.0f - tc * tc) + dcf[r];
      dg[r] = make_float4(dc * jg * ig * (1.0f - ig), dc * ig * (1.0f - jg * jg),
                          dc * cp[r] * fg * (1.0f - fg),
                          dh[r] * tc * og * (1.0f - og));
      dcf[r] = dc * fg;
      if (row0 + r < p.B) {
        float* out = p.dg + ((size_t)(row0 + r) * p.T + t) * 4 * H + u;
        out[0] = dg[r].x;
        out[H] = dg[r].y;
        out[2 * H] = dg[r].z;
        out[3 * H] = dg[r].w;
      }
    }
    if (s + 1 < p.T) {  // the first step's dh is not needed
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        *reinterpret_cast<float4*>(rows + r * H + 4 * lane) = dg[r];
      __syncwarp();
      if (s == 0) mbar_wait(bar, 0);  // W_h has landed
      float acc[RPT][NR];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < NR; ++q) acc[r][q] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < U; ++k) {  // this CTA's units, four gates each
        float4 wv[NR];
#pragma unroll
        for (int q = 0; q < NR; ++q)
          wv[q] = *reinterpret_cast<const float4*>(w + (k * H + lane + 32 * q) * 4);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(rows + r * H + 4 * k);
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            float a = acc[r][q];
            a = fmaf(d.x, wv[q].x, a);
            a = fmaf(d.y, wv[q].y, a);
            a = fmaf(d.z, wv[q].z, a);
            a = fmaf(d.w, wv[q].w, a);
            acc[r][q] = a;
          }
        }
      }
      // into slots cur ^ 1 of every CTA: read there in step s - 1, before
      // the barrier waited for above
      const uint32_t nb = (cur ^ 1) * 4 * BT * H;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < NR; ++q)
          st_cluster(push[q] + nb + 4 * r * H, __float_as_uint(acc[r][q]));
    }
    cluster_arrive();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      ct[r] = cp[r];
      dy[r] = dyn[r];
      cp[r] = cpn[r];
#pragma unroll
      for (int g = 0; g < 4; ++g) gt[r][g] = gn[r][g];
    }
  }
  if (p.T < 2) mbar_wait(bar, 0);  // no copy outlives the CTA
  cluster_wait();  // no CTA leaves while another may store into it
}

template <int H, int BT>
cudaError_t allow_backward_smem() {
  static bool done = false;  // once per instantiation and process
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_backward_kernel<H, BT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<float, H, BT>::SMEM);
  done = err == cudaSuccess;
  return err;
}

template <int H, int BT>
int launch_backward(const BackParams& p, int cluster, int smem,
                    cudaStream_t stream) {
  using C = Cfg<float, H, BT>;
  if (cluster != C::NR || smem != C::SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_backward_smem<H, BT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      resident_config<float, H, BT>(p.B, stream, attr);
  err = cudaLaunchKernelEx(&cfg, lstm_scan_backward_kernel<H, BT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int H, int BT>
int active_backward(int* out) {
  const cudaError_t err = allow_backward_smem<H, BT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      resident_config<float, H, BT>(4096, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, lstm_scan_backward_kernel<H, BT>, &cfg);
}

// ---------------------------------------------------------------- streaming

// acc[r][g] += sum_k hs[r][k] * w[k][g*H + j], k in [0, H).  hs rows are HP
// floats apart (HP = H rounded up to 4, so each row is float4-aligned).
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[STREAM_BT][4],
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
      for (int g = 0; g < 4; ++g) wv[kk][g] = to_float(wj[kk * G + g * H]);
#pragma unroll 1
    for (int k = 0; k < K4; k += 4) {
      // prefetch the next four weight rows while these are used
      float wn[4][4];
      const int kn = k + 4 < K4 ? k + 4 : k;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wn[kk][g] = to_float(wj[(size_t)(kn + kk) * G + g * H]);
#pragma unroll
      for (int r = 0; r < STREAM_BT; ++r) {
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
    for (int g = 0; g < 4; ++g) wv[g] = to_float(wj[(size_t)k * G + g * H]);
#pragma unroll
    for (int r = 0; r < STREAM_BT; ++r) {
      const float hv = hs[r * HP + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hv, wv[g], acc[r][g]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_H)
    lstm_scan_streaming_kernel(const Params p, int H) {
  extern __shared__ float h_s[];  // [STREAM_BT][HP]
  const T* xp = static_cast<const T*>(p.xp);
  const T* wh = static_cast<const T*>(p.wh);
  const T* bias = static_cast<const T*>(p.bias);
  T* out = static_cast<T*>(p.out);
  const int j = threadIdx.x;
  const int HP = (H + 3) & ~3;
  const int G = 4 * H;
  const int b0 = blockIdx.x * STREAM_BT;
  for (int i = j; i < STREAM_BT * HP; i += blockDim.x) h_s[i] = 0.0f;
  float b[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = to_float(bias[g * H + j]);
  float c[STREAM_BT];
#pragma unroll
  for (int r = 0; r < STREAM_BT; ++r) c[r] = 0.0f;
  __syncthreads();
  for (int s = 0; s < p.T; ++s) {
    const int t = p.reverse ? p.T - 1 - s : s;
    float acc[STREAM_BT][4];
#pragma unroll
    for (int r = 0; r < STREAM_BT; ++r) {
      const int row = b0 + r;
      const T* x = xp + ((size_t)row * p.T + t) * G + j;
      // xp + b rounded as torch adds two tensors of the storage type
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = row < p.B ? to_float(from_float<T>(to_float(x[g * H]) + b[g]))
                              : 0.0f;
    }
    accumulate<T>(acc, h_s, wh, H, HP, j);
    float hn[STREAM_BT];
#pragma unroll
    for (int r = 0; r < STREAM_BT; ++r)
      hn[r] = lstm_cell(c[r], acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();  // every thread has read the last step's h
#pragma unroll
    for (int r = 0; r < STREAM_BT; ++r) {
      const T hr = from_float<T>(hn[r]);
      h_s[r * HP + j] = to_float(hr);
      const int row = b0 + r;
      if (row < p.B) out[((size_t)row * p.T + t) * H + j] = hr;
    }
    __syncthreads();  // this step's h is complete
  }
}

template <typename T>
int streaming(const Params& p, int H, int rows, int cluster, int smem,
              void* stream) {
  if (p.B <= 0 || p.T <= 0 || H <= 0 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  const int want = STREAM_BT * ((H + 3) & ~3) * (int)sizeof(float);
  if (rows != STREAM_BT || cluster != 1 || smem != want)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.B + STREAM_BT - 1) / STREAM_BT);
  lstm_scan_streaming_kernel<T>
      <<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(p, H);
  return (int)cudaGetLastError();
}

Params params(const void* xp, const void* wh, const void* bias, void* out,
              int B, int T, int reverse) {
  Params p;
  p.xp = xp;
  p.wh = wh;
  p.bias = bias;
  p.out = out;
  p.B = B;
  p.T = T;
  p.reverse = reverse;
  return p;
}

}  // namespace

extern "C" {

// Each launch returns a cudaError_t: 0 when the kernel was launched.  xp is
// x @ W_x without the bias, which the kernel adds; wh the [H, 4H] recurrent
// rows of the TF-layout kernel; bias [4H]; all in the storage type, TF gate
// order.  rows, cluster and smem are the wrapper's plan
// (ops/cuda/lstm_scan.py::scan_plan), and a plan that is not this build's
// returns cudaErrorInvalidValue.  The resident kernels take H 128 and 256,
// the streaming ones any H up to 512.
int ds_lstm_scan_resident_f32(const void* xp, const void* wh,
                              const void* bias, void* out, int B, int T,
                              int H, int reverse, int rows, int cluster,
                              int smem, void* stream) {
  return resident<float>(params(xp, wh, bias, out, B, T, reverse), H, rows,
                         cluster, smem, stream);
}

int ds_lstm_scan_resident_bf16(const void* xp, const void* wh,
                               const void* bias, void* out, int B, int T,
                               int H, int reverse, int rows, int cluster,
                               int smem, void* stream) {
  return resident<bf16>(params(xp, wh, bias, out, B, T, reverse), H, rows,
                        cluster, smem, stream);
}

int ds_lstm_scan_streaming_f32(const void* xp, const void* wh,
                               const void* bias, void* out, int B, int T,
                               int H, int reverse, int rows, int cluster,
                               int smem, void* stream) {
  return streaming<float>(params(xp, wh, bias, out, B, T, reverse), H, rows,
                          cluster, smem, stream);
}

int ds_lstm_scan_streaming_bf16(const void* xp, const void* wh,
                                const void* bias, void* out, int B, int T,
                                int H, int reverse, int rows, int cluster,
                                int smem, void* stream) {
  return streaming<bf16>(params(xp, wh, bias, out, B, T, reverse), H, rows,
                         cluster, smem, stream);
}

// How many clusters of the resident kernel at (H, rows) the card runs at
// once (one wave).
int ds_lstm_scan_active_clusters_f32(int H, int rows, int* out) {
  return active_clusters<float>(H, rows, out);
}

int ds_lstm_scan_active_clusters_bf16(int H, int rows, int* out) {
  return active_clusters<bf16>(H, rows, out);
}

// The backward of one float32 layer-direction at H 128 or 256: dg [B, T, 4H]
// from the gate pre-activations gates [B, T, 4H] ([x_t, h_{t-1}] @ W + b,
// without the forget bias), the recurrent rows wh [H, 4H] and the output's
// gradient dy [B, T, H]; c is a scratch of [tiles x rows, T, H] floats.  The
// plan is the forward's (rows, cluster and smem of scan_plan at H 128/256).
int ds_lstm_scan_backward_f32(const void* gates, const void* wh,
                              const void* dy, void* c, void* dg, int B, int T,
                              int H, int reverse, int rows, int cluster,
                              int smem, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  BackParams p;
  p.gates = static_cast<const float*>(gates);
  p.wh = static_cast<const float*>(wh);
  p.dy = static_cast<const float*>(dy);
  p.c = static_cast<float*>(c);
  p.dg = static_cast<float*>(dg);
  p.B = B;
  p.T = T;
  p.reverse = reverse;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape<float>(H, rows, [&](auto hc, auto bc) {
    return launch_backward<decltype(hc)::value, decltype(bc)::value>(
        p, cluster, smem, s);
  });
}

int ds_lstm_scan_backward_active_clusters_f32(int H, int rows, int* out) {
  return by_shape<float>(H, rows, [&](auto hc, auto bc) {
    return active_backward<decltype(hc)::value, decltype(bc)::value>(out);
  });
}

}  // extern "C"
