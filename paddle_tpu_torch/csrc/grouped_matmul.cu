// Grouped matmul over expert-sorted rows: the forward (also the input
// gradient, against the transposed weight) and the weight gradient.
//
// Replaces: paddle_tpu/kernels/pallas/grouped_matmul.py, `_fwd_kernel`
// launched by `_fwd_call` (the pallas_call at line 226) and `_dw_kernel`
// launched by `_dw_call` (line 287).
//
// Layout (grouped_metadata's): the rows of x are sorted by expert, group e
// starting at the tile-aligned row offsets[e] (a multiple of bm) with
// counts[e] rows; rows between groups are padding.
//
// grouped_mm_fwd computes out[r] = x[r] . w[e(r)] (+ b[e(r)]) over each
// group's live tiles: x [Tp, K], w [E, K, N] (or, transposed, w [E, N, K]
// read in place: out[r] = x[r] . w[e]^T, the input gradient dy . w^T of
// the TPU backward without materialising swapaxes(w)), b [E, N] or null,
// out [Tp, N] in x's dtype. Rows past a group's live tiles are not
// written. grouped_mm_dw computes dw[e] = sum over the group's rows r <
// offsets[e] + counts[e] of x[r]^T dy[r] into dw [E, K, N] float32; a row
// past counts[e] is never loaded (selection, not a multiply by 0), so a
// NaN in a padding row cannot reach dw.
//
// The routing never leaves the card: each block reads the group offsets
// and counts from device memory, as the TPU kernel's `pl.when(t <
// tcnt[e])` does.
//
// What bounds it on the H100. The MoE layer's products (16,384 routes, K
// and N 768 and 3072) do 2 * routes * K * N = 77.3 GFLOP on 0.2 GB: about
// 400 flops per byte, above the card's balance point, so operations bound
// them, and only the tensor cores come near that bound: the CUDA cores'
// float32 peak (67 TFLOP/s) holds any design on them. A 128 x 128 tile
// also reads its x tile N / 128 times and its weight tile once per token
// tile, about 2.5 GB a launch from L2 at the MoE shapes: a second bound,
// below the tensor cores' at the L2 read rate chip_smoke.py measures.
//
// The forward has two kernels; the wrapper (kernels/grouped_matmul.py,
// `gm_route`) picks one and passes it in, and a kernel that cannot take
// the inputs is an error, never a silent switch to another:
// - "wgmma" (`grouped_wgmma<T, TRANS>`: float32 or bf16, bm % 128 == 0,
//   K % 64 == 0, N % 8 == 0 unless TRANS, 16-byte aligned x and w), the
//   product on the tensor cores. A block of two warpgroups owns a 128
//   token x 128 column tile, 64 token rows each, A = the token tile
//   (K-major, as x lies) and B = the weight tile: for the forward w[e]
//   [K, N], N-contiguous, stored as two 64-column panels and read
//   MN-major (`mma_m64n128k16_ss_tb`); for the input gradient w[e] [N,
//   K], K-contiguous, read K-major (`mma_m64n128k16`). Since bm is a
//   multiple of 128, a token tile never straddles two experts. The grid
//   is (N / 128, Tp / 128), without the E axis of the CUDA-core kernel:
//   each block finds the group that owns its token tile from the
//   device's offsets and counts (at most E compares; `_tile_experts` is
//   its plain mirror) and returns only in the padding tail, so no SM
//   slot goes to a block that would return at once.
//   Arithmetic. float32 is split exactly into three bf16 pieces, hi + mid
//   + lo, by truncation (`split3`'s rule, wgmma.cuh), x and w both, and
//   each k16 step issues the six piece products whose order is at least
//   2^-16 of x w: (hi, hi), (hi, mid), (mid, hi), (mid, mid), (hi, lo),
//   (lo, hi). Each is exact in float32 (8 x 8 significant bits); each of
//   the three dropped ones is below 2^-22 |x w|, of the product's sign.
//   The tensor cores' float32 adder truncates: the products of a whole
//   K 3072 summed straight into one accumulator miss the float32 rule
//   (1e-6 |ref| + 1e-5 max|ref|) by 2.5-2.6 times on the MoE shapes
//   (chip_smoke.py --grouped-cost, build no_drain), so each 64-deep
//   stage's products go into a float32 partial that starts at zero and a
//   float32 add on the CUDA cores puts it on the accumulator (the
//   drain): 0.17-0.27 of the rule, at no cost
//   in time (the partial's wait replaces the wait for the previous
//   stage's products before its buffers are rewritten). The three largest
//   products alone would miss the rule by 2.4 times, TF32 (10 bits of
//   each operand) by far more (tests/test_torch_grouped_matmul.py). bf16
//   is one piece and one product a k16 step, the same body.
//   Both operands go through registers: each thread loads its 16-byte
//   chunks of x and w for stage kt + 2 after splitting stage kt + 1's
//   into their swizzled panels while stage kt's products run, 64 values
//   of K a stage, six 16 KB panels a stage, two stages (192 KB).
//   Non-finite values: a split puts inf whole into hi with mid = lo = 0,
//   so a cross product such as (hi, mid) of x = inf and a w exact in bf16
//   is inf x 0 = NaN where the float32 product is inf. The kernel splits
//   every value as if it were finite (no select, about half the split's
//   work of `split3`) and sums the remainders x - hi, which turn NaN for
//   an inf or a NaN; a block that split one redoes its tile with the
//   float32 FMA loop of grouped_gemm.cuh: exact IEEE products, rare,
//   outside the fast path (a fourth panel a piece with hi's non-finite
//   values zeroed would cost every block a third more shared memory a
//   stage, and a stage). Rows of a group past counts[e] are zero-filled
//   and never read, on both paths, so a NaN in a padding row reaches no
//   output; they are written as the bias alone. The epilogue moves the
//   tile through shared memory and writes the live rows in x's dtype with
//   16-byte stores. No atomics: a second launch gives the same bits.
//   What holds it (H100 80GB HBM3 at 700 W, the MoE shapes, float32):
//   0.82-0.94 ms against a six-product bound of 0.469 ms; without its
//   products 0.45-0.49 ms, without its split 0.68-0.78, without its loads
//   at most 5 % faster, and spilling (chip_smoke.py --grouped-cost). The
//   tiles' reads from L2 (2.47 GB a launch) take 0.356 ms at the 6.94
//   TB/s that chip_smoke.py's L2 probe reads (distinct addresses, no L1):
//   below the six-product bound and under half the kernel's time, so the
//   bytes alone do not hold it: the products and the split, which share
//   the SM's issue slots and shared memory, do.
// - "cuda_core" (`grouped_fwd<T, TRANS>`: everything else, bm 64, widths
//   off those multiples, unaligned views), the CUDA-core tile of
//   grouped_gemm.cuh: 128 x 128 outputs, 8 x 8 a thread, float32 FMAs,
//   near the CUDA cores' peak. Its grid is (N tiles, ceil(Tp / 128) row
//   tiles, E); a block past its group's live tiles returns at once.
//
// The weight gradient has two kernels too; the wrapper's `gm_dw_route`
// picks one and passes it in, under the same rule:
// - "wgmma" (`grouped_dw_wgmma<T>`: float32 or bf16, K % 8 == 0, N % 8
//   == 0, 16-byte aligned x and dy), the forward's ring and arithmetic
//   with the contraction moved to the group's rows. A block of two
//   warpgroups owns one 128 x 128 tile of dw[e]: 128 columns of x (M, 64
//   a warpgroup) by 128 columns of dy (N), and walks the group's rows
//   [offsets[e], offsets[e] + counts[e]) in 64-row stages. Both tiles are
//   rows of the contraction by contiguous columns, loaded as the
//   forward's weight tile (`mn_operand`), with the rows at or past the
//   group's end zero-filled without a read (`rows_below`: a NaN in a
//   padding row reaches no dw), and both are read MN-major
//   (`mma_m64n128k16_ss_tatb`). float32 x and dy are split into hi + mid
//   + lo and each k16 step issues the forward's six piece products into
//   a float32 partial drained each stage: a group's contraction runs to
//   thousands of rows, far past the K 3072 at which the undrained sum
//   already missed the float32 rule. bf16 is one piece and one product.
//   A block whose split met an inf or a NaN redoes its tile with the
//   float32 FMA loop of grouped_gemm.cuh (`GroupRows`), as the forward
//   does. The grid is (N tiles, K tiles, E), the experts' blocks in
//   expert order. One block owns a tile: no atomics, and two launches
//   give the same bits. An empty group writes zeros.
//   What holds it (H100 80GB HBM3 at 700 W, the MoE shapes, float32):
//   0.838-0.849 ms against a six-product bound of 0.469 ms (the parent
//   commit's CUDA-core `grouped_dw`, in turns: 1.755-1.769; bf16 0.283
//   against 2.215), 0.08-0.10 of the float32 rule; without its drain the
//   sum misses that rule 3.6-3.7 times. Without its products 0.48-0.52
//   ms, without its split 0.74-0.79, without its loads no faster
//   (chip_smoke.py --grouped-cost): the products and the split hold it,
//   as they hold the forward; the tiles' reads from L2 (2.42 GB a
//   launch) take 0.347 ms at the 6.96 TB/s of chip_smoke.py's L2 probe.
//   Groups differ in length (0 to 7,168 routes in the MoE phases'
//   gates), so the blocks of a long group run longer: blocks taken
//   largest group first would save 4.7-4.9 % of train_moe's dw time a
//   step (12 % on its worst launch) and 8.3 % of train_moe_quant's, 0.3-
//   0.5 % of a step (chip_smoke.py's dw_order phase), so the experts
//   stay in order.
// - "cuda_core" (`grouped_dw`: widths off multiples of 8, unaligned
//   views; grid (N tiles, K tiles, E)): the CUDA-core tile of
//   grouped_gemm.cuh with the block looping over its group's rows.
// No TMA, mbarrier ring or warp specialisation yet.

#include <type_traits>

#include "common.cuh"
#include "grouped_gemm.cuh"
#include "wgmma.cuh"

namespace {

using namespace ptt::gg;

// B tile of the forward: Bs[c][j] = w[k0 + c, n0 + j] of a row-major
// [K, N] matrix. Thread t reads contraction row t / 32, four columns.
template <typename T>
struct DenseB {
  const T* w;
  int K, N, n0;
  bool vec;
  int c, j4;

  __device__ DenseB(const T* w_, int K_, int N_, int n0_, bool vec_)
      : w(w_), K(K_), N(N_), n0(n0_), vec(vec_), c(threadIdx.x >> 5),
        j4((threadIdx.x & 31) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int k = k0 + c;
    const int n = n0 + j4;
    load4(w + (size_t)k * N + n, vec, k < K ? clamp4(N - n) : 0, r);
  }
  __device__ __forceinline__ void store(float (*bs)[kBN + kPad],
                                        const float* r) const {
    *reinterpret_cast<float4*>(&bs[c][j4]) = make_float4(r[0], r[1], r[2],
                                                         r[3]);
  }
};

// B tile read through the transpose: Bs[c][j] = w[n0 + j, k0 + c] of a
// row-major [N, K] matrix (the forward weight [K_fwd, N_fwd] seen from the
// input gradient, whose contraction is N_fwd). Thread t reads output
// column t / 2, four contraction indices.
template <typename T>
struct TransposedB {
  const T* w;
  int K, N, n0;
  bool vec;
  int j, c4;

  __device__ TransposedB(const T* w_, int K_, int N_, int n0_, bool vec_)
      : w(w_), K(K_), N(N_), n0(n0_), vec(vec_), j(threadIdx.x >> 1),
        c4((threadIdx.x & 1) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int n = n0 + j;
    const int k = k0 + c4;
    load4(w + (size_t)n * K + k, vec, n < N ? clamp4(K - k) : 0, r);
  }
  __device__ __forceinline__ void store(float (*bs)[kBN + kPad],
                                        const float* r) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[c4 + i][j] = r[i];
  }
};

// x [Tp, K] . w[e] -> out [Tp, N]; TRANS: w[e] is [N, K] and read
// transposed. One block per (N tile, row tile t of group e, e).
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_fwd(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out,
                const int* __restrict__ offsets,
                const int* __restrict__ counts, int Tp, int K, int N,
                int bm, int vec_a, int vec_b) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  const int live = live_rows(counts, e, bm);
  const int t0 = blockIdx.y * kBM;
  if (t0 >= live) return;               // past the group's live tiles
  const int row0 = offsets[e] + t0;
  const int row_end = min(offsets[e] + live, Tp);
  if (row0 >= row_end) return;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* we = w + (size_t)e * K * N;
  float acc[8][8];
  zero_acc(acc);
  const RowsA<T> la(x, K, row0, row_end, vec_a);
  if (TRANS) {
    const TransposedB<T> lb(we, K, N, n0, vec_b);
    mainloop(la, lb, K, sm, acc, tx, ty);
  } else {
    const DenseB<T> lb(we, K, N, n0, vec_b);
    mainloop(la, lb, K, sm, acc, tx, ty);
  }
  store_tile<T, T>(out, N, row0, row_end, n0,
                   bias != nullptr ? bias + (size_t)e * N : nullptr, acc,
                   tx, ty);
}

// dw tiles: the contraction runs over the group's rows. A: As[c][m] =
// x[r0 + k0 + c, m0 + m] (x^T); B: Bs[c][j] = dy[r0 + k0 + c, n0 + j].
// Thread t reads row t / 32, four consecutive columns; a row at or past
// r_end is not read.
template <typename T>
struct GroupRows {
  const T* a;
  int cols, r0, r_end, col0;
  bool vec;
  int c, j4;

  __device__ GroupRows(const T* a_, int cols_, int r0_, int r_end_,
                       int col0_, bool vec_)
      : a(a_), cols(cols_), r0(r0_), r_end(r_end_), col0(col0_),
        vec(vec_), c(threadIdx.x >> 5), j4((threadIdx.x & 31) * 4) {}

  __device__ __forceinline__ void load(int k0, float* r) const {
    const int row = r0 + k0 + c;
    const int col = col0 + j4;
    load4(a + (size_t)row * cols + col, vec,
          row < r_end ? clamp4(cols - col) : 0, r);
  }
  __device__ __forceinline__ void store(float (*s)[kBM + kPad],
                                        const float* r) const {
    *reinterpret_cast<float4*>(&s[c][j4]) = make_float4(r[0], r[1], r[2],
                                                        r[3]);
  }
};

// dw[e] [K, N] = sum over rows r in [offsets[e], offsets[e] + counts[e])
// of x[r]^T dy[r]. One block per (N tile, K tile, e); an empty group
// writes zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_dw(const T* __restrict__ x, const T* __restrict__ dy,
               float* __restrict__ dw, const int* __restrict__ offsets,
               const int* __restrict__ counts, int Tp, int K, int N,
               int vec_x, int vec_dy) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int r0 = offsets[e];
  const int cnt = max(0, min(counts[e], Tp - r0));
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
  zero_acc(acc);
  const GroupRows<T> la(x, K, r0, r0 + cnt, m0, vec_x);
  const GroupRows<T> lb(dy, N, r0, r0 + cnt, n0, vec_dy);
  mainloop(la, lb, cnt, sm, acc, tx, ty);
  store_tile<float, float>(dw + (size_t)e * K * N, N, m0, K, n0, nullptr,
                           acc, tx, ty);
}

// -- the tensor-core forward --------------------------------------------------

namespace wg = ptt::wg;

constexpr int kGN = 128;   // output columns a block: wgmma's N
constexpr int kGM = 128;   // token rows a block, 64 a warpgroup
constexpr int kGK = 64;    // K a stage: one 128-byte swizzled row of bf16
constexpr int kGThreads = 256;
constexpr int kGPanel = 128 * kGK * 2;  // one operand tile of one piece, 16 KB
constexpr int kGChunks = 4;  // 16-byte bf16 chunks a thread writes an operand

// A stage holds x's pieces (A), then w's (B), each piece a 16 KB tile on a
// 1024-byte boundary, as the swizzle needs.
template <typename T>
struct GwLayout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kPieces = kF32 ? 3 : 1;  // hi, mid, lo
  static constexpr int kProducts = kF32 ? 6 : 1;
  static constexpr int kB = kPieces * kGPanel;
  static constexpr int kStage = 2 * kB;          // 96 KB, 32 KB
  static constexpr int kSmem = 2 * kStage;       // two stages
  static constexpr int kEpiPitch = kGN + 16 / (int)sizeof(T);
};
static_assert(GwLayout<float>::kSmem <= 232448, "the float32 ring fits");
static_assert(kGM * GwLayout<float>::kEpiPitch * 4 <= GwLayout<float>::kSmem,
              "the epilogue tile fits");
static_assert(sizeof(Smem) <= GwLayout<__nv_bfloat16>::kSmem,
              "the FMA redo's tiles fit");

// The pieces of product q (0..5) of a k16 step, largest first: (hi, hi),
// (hi, mid), (mid, hi), (mid, mid), (hi, lo), (lo, hi). The three left
// out, (mid, lo), (lo, mid) and (lo, lo), are each below 2^-22 |x w|.
__host__ __device__ constexpr int piece_a(int q) {
  return (q == 2 || q == 3) ? 1 : (q == 5 ? 2 : 0);
}
__host__ __device__ constexpr int piece_b(int q) {
  return (q == 1 || q == 3) ? 1 : (q == 4 ? 2 : 0);
}

// The chunks one thread copies of an operand each stage: chunk i (8
// consecutive values of a row, one 16-byte bf16 chunk of every piece) for
// i < kGChunks, present when i < rows, else zeros without a read.
template <typename T>
struct GwOperand {
  const T* p;        // chunk 0 at stage 0
  int rows;          // chunks i < rows hold data
  long long step;    // elements between chunks i and i + 1
  long long stage;   // elements a stage moves along the contraction
  uint32_t off;      // byte offset of chunk 0 in a piece's tile
  uint32_t soff;     // bytes between chunks i and i + 1 in the tile
};

// A K-major tile of 128 rows [r0, r0 + 128) of a row-major matrix with ld
// columns along K, rows at or past r_end zero: x, and w[e] [N, K] read
// transposed. Thread t takes chunk t % 8 of rows t / 8 + 32 i.
template <typename T>
__device__ __forceinline__ GwOperand<T> kmajor_operand(const T* a, int ld,
                                                       int r0, int r_end) {
  const int t = threadIdx.x, c = t & 7, r = t >> 3;
  GwOperand<T> o;
  o.p = a + (size_t)(r0 + r) * ld + c * 8;
  o.rows = (r_end - r0 - r + 31) / 32;  // may be <= 0
  o.step = 32LL * ld;
  o.stage = kGK;
  o.off = wg::sw128(r, c);
  o.soff = 32 * 128;
  return o;
}

// An MN-major tile of w[e] [K, N] (N contiguous): rows k of the stage,
// columns [n0, n0 + 128) as two 64-column panels. Thread t takes chunk t
// % 16 (columns 8 (t % 16) ..) of rows t / 16 + 16 i; N % 8 == 0, so a
// chunk lies wholly inside N or wholly past it.
template <typename T>
__device__ __forceinline__ GwOperand<T> mn_operand(const T* w, int N,
                                                   int n0) {
  const int t = threadIdx.x, c = t & 15, r = t >> 4;
  GwOperand<T> o;
  o.p = w + (size_t)r * N + n0 + c * 8;
  o.rows = n0 + c * 8 < N ? kGChunks : 0;
  o.step = 16LL * N;
  o.stage = (long long)kGK * N;
  o.off = (c >> 3) * (64 * 128) + wg::sw128(r, c & 7);
  o.soff = 16 * 128;
  return o;
}

// o for stage kt of an MN-major operand whose contraction rows end `left`
// rows past this thread's first (row t / 16 of the stage's 64): chunks of
// rows at or past the end are zero-filled without a read
template <typename T>
__device__ __forceinline__ GwOperand<T> rows_below(GwOperand<T> o, int kt,
                                                   int left) {
  o.rows = min(o.rows, (left - kt * kGK + 15) >> 4);
  return o;
}

// A thread's chunks of one operand for a stage, in registers
template <typename T>
struct GwRaw;
template <>
struct GwRaw<float> {
  float4 v[kGChunks][2];
};
template <>
struct GwRaw<__nv_bfloat16> {
  uint4 v[kGChunks];
};

__device__ __forceinline__ void gw_load(const GwOperand<float>& o, int kt,
                                        GwRaw<float>& r) {
  const float* p = o.p + kt * o.stage;
#pragma unroll
  for (int i = 0; i < kGChunks; ++i) {
    if (i < o.rows) {
      const float4* q = reinterpret_cast<const float4*>(p + i * o.step);
      r.v[i][0] = q[0];
      r.v[i][1] = q[1];
    } else {
      r.v[i][0] = r.v[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void gw_load(const GwOperand<__nv_bfloat16>& o,
                                        int kt, GwRaw<__nv_bfloat16>& r) {
  const __nv_bfloat16* p = o.p + kt * o.stage;
#pragma unroll
  for (int i = 0; i < kGChunks; ++i)
    r.v[i] = i < o.rows ? *reinterpret_cast<const uint4*>(p + i * o.step)
                        : make_uint4(0u, 0u, 0u, 0u);
}

// The registers' chunks into a stage's piece tiles at `tile`; `nan` turns
// NaN if any value split is not finite.
__device__ __forceinline__ void gw_store(uint8_t* tile,
                                         const GwOperand<float>& o,
                                         const GwRaw<float>& r,
                                         float& nan) {
#pragma unroll
  for (int i = 0; i < kGChunks; ++i)
    wg::split_finite8(tile, o.off + i * o.soff, kGPanel, r.v[i][0],
                      r.v[i][1], nan);
}

// bf16: one piece, stored as it is (one product: no cross terms, so a
// non-finite value gives what the plain version gives)
__device__ __forceinline__ void gw_store(uint8_t* tile,
                                         const GwOperand<__nv_bfloat16>& o,
                                         const GwRaw<__nv_bfloat16>& r,
                                         float&) {
#pragma unroll
  for (int i = 0; i < kGChunks; ++i)
    *reinterpret_cast<uint4*>(tile + o.off + i * o.soff) = r.v[i];
}

// How a stage's tiles are read: A (x's pieces, 64 rows of M a warpgroup)
// K-major and B (w's) MN-major, the forward; both K-major, the input
// gradient against w [N, K] read in place; both MN-major, the weight
// gradient, whose x and dy tiles are rows of the contraction by
// contiguous columns.
constexpr int kFormFwd = 0, kFormDx = 1, kFormDw = 2;

// one k16 step's product q of this warpgroup's 64 rows into d: A at `a`
// (piece 0 of its rows), B at `b` (piece 0 of the B tile). A k16 step
// starts 32 bytes into a K-major row, 16 rows (2048 bytes) into an
// MN-major panel.
template <int F, int Q>
__device__ __forceinline__ void gw_mma(float (&d)[64], uint32_t a,
                                       uint32_t b, int j, int scale_d) {
  const uint32_t pa = a + piece_a(Q) * kGPanel;
  const uint32_t pb = b + piece_b(Q) * kGPanel;
  const uint64_t da = F == kFormDw
                          ? wg::desc_sw128_mn(pa + 2048 * j, 64 * 128)
                          : wg::desc_sw128(pa + 32 * j);
  const uint64_t db = F == kFormDx
                          ? wg::desc_sw128(pb + 32 * j)
                          : wg::desc_sw128_mn(pb + 2048 * j, 64 * 128);
  wg::mma_m64n128k16_ss<F == kFormDw, F != kFormDx>(d, da, db, scale_d);
}

// the stage's products (4 k16 steps x P products) into d; scale_d 0 on
// the first when `fresh`
template <int F, int P>
__device__ __forceinline__ void gw_stage(float (&d)[64], uint32_t a,
                                         uint32_t b, bool fresh) {
#pragma unroll
  for (int j = 0; j < kGK / 16; ++j) {
    const int s = !(fresh && j == 0);
    gw_mma<F, 0>(d, a, b, j, s);
    if constexpr (P == 6) {
      gw_mma<F, 1>(d, a, b, j, 1);
      gw_mma<F, 2>(d, a, b, j, 1);
      gw_mma<F, 3>(d, a, b, j, 1);
      gw_mma<F, 4>(d, a, b, j, 1);
      gw_mma<F, 5>(d, a, b, j, 1);
    }
  }
}

// The ring, shared by the forward and the weight gradient: KT stages of 64
// along the contraction. `load(kt, ra, rb)` fills the registers with stage
// kt's chunks of A (described by oa) and B (ob); stage kt + 2 is loaded
// while stage kt + 1 is split into the free buffers and stage kt's P
// products run into `part`, which the drain then adds to `acc`. `bad`
// turns NaN if a split value was not finite.
template <int F, int P, typename T, class Load>
__device__ __forceinline__ void gw_mainloop(uint8_t* smem, int KT, int g,
                                            const GwOperand<T>& oa,
                                            const GwOperand<T>& ob,
                                            Load load, float (&acc)[64],
                                            float (&part)[64], float& bad) {
  using L = GwLayout<T>;
  const uint32_t sbase = wg::smem_addr(smem);
  GwRaw<T> ra, rb;    // A and B of the stage after next
  load(0, ra, rb);
  gw_store(smem, oa, ra, bad);
  gw_store(smem + L::kB, ob, rb, bad);
  if (KT > 1) load(1, ra, rb);
  wg::fence_proxy_async();
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t st = sbase + (kt & 1) * L::kStage;
    const uint32_t a = st + g * 64 * 128;  // this warpgroup's 64 rows of M
    const uint32_t b = st + L::kB;
    wg::fence();
    gw_stage<F, P>(part, a, b, true);
    wg::commit();
    const bool more = kt + 1 < KT;
    if (more) {
      // while the products run: stage kt + 1 into the buffers that stage
      // kt - 1's products read (the drain after stage kt - 1 has waited
      // for them, and the barrier after it freed them)
      uint8_t* nx = smem + ((kt + 1) & 1) * L::kStage;
      gw_store(nx, oa, ra, bad);
      gw_store(nx + L::kB, ob, rb, bad);
      wg::fence_proxy_async();
      if (kt + 2 < KT) load(kt + 2, ra, rb);
    }
    // the drain: this stage's partial onto the accumulator
    wg::wait<0>();
    wg::fence_operand(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (more) __syncthreads();  // publishes stage kt + 1
  }
}

// x [Tp, K] . w[e] -> out [Tp, N] on the tensor cores; TRANS: w[e] is [N,
// K], read transposed. One block per (N tile, token tile); the grid has no
// expert axis.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kGThreads, 1)
    grouped_wgmma(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ out,
                  const int* __restrict__ offsets,
                  const int* __restrict__ counts, int E, int Tp, int K,
                  int N, int bm) {
  using L = GwLayout<T>;
  constexpr int P = L::kProducts;
  extern __shared__ __align__(1024) uint8_t gw_smem[];
  uint8_t* smem = gw_smem;
  if (wg::smem_addr(smem) & 1023) __trap();  // the swizzle needs it
  // the group that owns this token tile
  const int t0 = blockIdx.y * kGM;
  int e = -1, xend = 0, oend = 0;
  for (int i = 0; i < E; ++i) {
    const int o = offsets[i], live = live_rows(counts, i, bm);
    if (t0 >= o && t0 < o + live) {
      e = i;
      xend = min(o + counts[i], Tp);  // rows that hold a route
      oend = min(o + live, Tp);       // rows written
      break;
    }
  }
  if (e < 0) return;  // the padding tail past the groups
  const int n0 = blockIdx.x * kGN;
  const int t = threadIdx.x, lane = t & 31;
  const int g = t >> 7, warp = (t >> 5) & 3;  // warpgroup, warp within it
  const int KT = K / kGK;
  const T* we = w + (size_t)e * K * N;
  const GwOperand<T> ox = kmajor_operand(x, K, t0, xend);
  GwOperand<T> ow;
  if constexpr (TRANS)
    ow = kmajor_operand(we, K, n0, N);
  else
    ow = mn_operand(we, N, n0);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  float bad = 0.f;    // NaN once this thread split a non-finite value
  gw_mainloop<TRANS ? kFormDx : kFormFwd, P>(
      smem, KT, g, ox, ow,
      [&](int kt, GwRaw<T>& rx, GwRaw<T>& rw) {
        gw_load(ox, kt, rx);
        gw_load(ow, kt, rw);
      },
      acc, part, bad);
  const T* be = bias != nullptr ? bias + (size_t)e * N : nullptr;

  // a non-finite value anywhere in the block's operands: the tile again,
  // in float32 FMAs (the barrier also frees the ring: every product is done)
  if (__syncthreads_or(isnan(bad))) {
    Smem& sm = *reinterpret_cast<Smem*>(smem);
    float f[8][8];
    zero_acc(f);
    const int tx = t & 15, ty = t >> 4;
    const RowsA<T> la(x, K, t0, xend, true);
    if constexpr (TRANS)
      mainloop(la, TransposedB<T>(we, K, N, n0, true), K, sm, f, tx, ty);
    else
      mainloop(la, DenseB<T>(we, K, N, n0, true), K, sm, f, tx, ty);
    store_tile<T, T>(out, N, t0, oend, n0, be, f, tx, ty);
    return;
  }

  // epilogue: the tile through shared memory as out [kGM m][kGN n]
  constexpr int pitch = L::kEpiPitch;
  T* ep = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int m = g * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const float bv =
        (be != nullptr && n0 + n < N) ? ptt::to_float(be[n0 + n]) : 0.f;
    ep[m * pitch + n] = ptt::from_float<T>(acc[i] + bv);
  }
  __syncthreads();
  constexpr int V = 16 / (int)sizeof(T);  // values a 16-byte store
  const bool vec_out = N % V == 0;        // every out row 16-byte aligned
  for (int q = t; q < kGM * (kGN / V); q += kGThreads) {
    const int r = q / (kGN / V), c = q % (kGN / V);
    const int gm = t0 + r, gn = n0 + c * V;
    if (gm >= oend || gn >= N) continue;
    const T* src = ep + r * pitch + c * V;
    T* dst = out + (size_t)gm * N + gn;
    if (vec_out && gn + V <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < V && gn + i < N; ++i) dst[i] = src[i];
    }
  }
}

// -- the tensor-core weight gradient -----------------------------------------

// the weight gradient's shared memory: the ring, then the float32 output
// tile (pitch kGN + 4) for the epilogue's 16-byte stores
template <typename T>
struct DwLayout {
  static constexpr int kPitch = kGN + 4;
  static constexpr int kEpi = kGM * kPitch * 4;
  static constexpr int kSmem =
      GwLayout<T>::kSmem > kEpi ? GwLayout<T>::kSmem : kEpi;
};

// dw[e] [K, N] = sum over rows r in [offsets[e], offsets[e] + counts[e])
// of x[r]^T dy[r] on the tensor cores. Block (n tile, m tile, e) owns one
// 128 x 128 tile of dw[e] and walks the group's rows in 64-row stages;
// A = x's tile, B = dy's, both read MN-major. An empty group writes zeros.
template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
    grouped_dw_wgmma(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ dw, const int* __restrict__ offsets,
                     const int* __restrict__ counts, int Tp, int K, int N) {
  constexpr int P = GwLayout<T>::kProducts;
  extern __shared__ __align__(1024) uint8_t gw_smem[];
  uint8_t* smem = gw_smem;
  if (wg::smem_addr(smem) & 1023) __trap();  // the swizzle needs it
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int r0 = offsets[e];
  const int cnt = max(0, min(counts[e], Tp - r0));
  const int KT = (cnt + kGK - 1) / kGK;  // 64-row stages
  const int t = threadIdx.x, lane = t & 31;
  const int g = t >> 7, warp = (t >> 5) & 3;  // warpgroup, warp within it
  // x [rows, K] and dy [rows, N] from the group's first row; thread t's
  // first row is t / 16 of each stage
  const GwOperand<T> ox = mn_operand(x + (size_t)r0 * K, K, m0);
  const GwOperand<T> oy = mn_operand(dy + (size_t)r0 * N, N, n0);
  const int left = cnt - (t >> 4);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  float bad = 0.f;    // NaN once this thread split a non-finite value
  if (KT > 0)
    gw_mainloop<kFormDw, P>(
        smem, KT, g, ox, oy,
        [&](int kt, GwRaw<T>& rx, GwRaw<T>& ry) {
          gw_load(rows_below(ox, kt, left), kt, rx);
          gw_load(rows_below(oy, kt, left), kt, ry);
        },
        acc, part, bad);
  float* out = dw + (size_t)e * K * N;

  // a non-finite value anywhere in the block's operands: the tile again,
  // in float32 FMAs (the barrier also frees the ring: every product is done)
  if (__syncthreads_or(isnan(bad))) {
    Smem& sm = *reinterpret_cast<Smem*>(smem);
    float f[8][8];
    zero_acc(f);
    const int tx = t & 15, ty = t >> 4;
    const GroupRows<T> la(x, K, r0, r0 + cnt, m0, true);
    const GroupRows<T> lb(dy, N, r0, r0 + cnt, n0, true);
    mainloop(la, lb, cnt, sm, f, tx, ty);
    store_tile<float, float>(out, N, m0, K, n0, nullptr, f, tx, ty);
    return;
  }

  // epilogue: the tile through shared memory as dw[e] [kGM m][kGN n];
  // N % 8 == 0, so a 4-column chunk lies wholly inside N or past it
  constexpr int pitch = DwLayout<T>::kPitch;
  float* ep = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int m = g * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    ep[m * pitch + n] = acc[i];
  }
  __syncthreads();
  for (int q = t; q < kGM * (kGN / 4); q += kGThreads) {
    const int r = q / (kGN / 4), c = q % (kGN / 4);
    const int gm = m0 + r, gn = n0 + c * 4;
    if (gm < K && gn < N)
      *reinterpret_cast<float4*>(out + (size_t)gm * N + gn) =
          *reinterpret_cast<const float4*>(ep + r * pitch + c * 4);
  }
}

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % bytes) == 0;
}

constexpr int kRouteCudaCore = 0;  // route codes (kernels/grouped_matmul.py)
constexpr int kRouteWgmma = 1;

template <typename T>
int launch_cuda_core(const void* x, const void* w, const void* b, void* out,
                     const int* offsets, const int* counts, int E, int Tp,
                     int K, int N, int bm, int trans, cudaStream_t st) {
  const int vb = sizeof(T) * 4;
  // four consecutive elements along x's rows, and along w's contiguous dim
  const int vec_a = (K % 4 == 0) && aligned(x, vb);
  const int vec_b = (trans ? K % 4 == 0 : N % 4 == 0) && aligned(w, vb);
  const dim3 grid((N + kBN - 1) / kBN, (Tp + kBM - 1) / kBM, E);
  if (trans)
    grouped_fwd<T, true><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)out, offsets, counts, Tp,
        K, N, bm, vec_a, vec_b);
  else
    grouped_fwd<T, false><<<grid, kThreads, 0, st>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)out, offsets, counts, Tp,
        K, N, bm, vec_a, vec_b);
  return (int)cudaGetLastError();
}

template <typename T, bool TRANS>
int launch_wgmma(const void* x, const void* w, const void* b, void* out,
                 const int* offsets, const int* counts, int E, int Tp, int K,
                 int N, int bm, cudaStream_t st) {
  auto kernel = grouped_wgmma<T, TRANS>;
  constexpr int smem = GwLayout<T>::kSmem;
  static bool smem_set[ptt::kMaxDevices] = {};
  if (int e = ptt::raise_smem(kernel, smem, smem_set)) return e;
  const dim3 grid((N + kGN - 1) / kGN, (Tp + kGM - 1) / kGM);
  kernel<<<grid, kGThreads, smem, st>>>((const T*)x, (const T*)w,
                                        (const T*)b, (T*)out, offsets,
                                        counts, E, Tp, K, N, bm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, void* out,
               const int* offsets, const int* counts, int E, int Tp, int K,
               int N, int bm, int trans, int route, cudaStream_t st) {
  if (route == kRouteWgmma) {
    // token tiles inside one group, whole stages, whole 16-byte chunks of
    // the weight's rows, 16-byte aligned bases
    if (bm % kGM || K % kGK || (!trans && N % 8) || !aligned(x, 16) ||
        !aligned(w, 16))
      return (int)cudaErrorInvalidValue;
    if (trans)
      return launch_wgmma<T, true>(x, w, b, out, offsets, counts, E, Tp, K,
                                   N, bm, st);
    return launch_wgmma<T, false>(x, w, b, out, offsets, counts, E, Tp, K,
                                  N, bm, st);
  }
  if (route != kRouteCudaCore) return (int)cudaErrorInvalidValue;
  return launch_cuda_core<T>(x, w, b, out, offsets, counts, E, Tp, K, N, bm,
                             trans, st);
}

template <typename T>
int launch_dw(const void* x, const void* dy, void* dw, const int* offsets,
              const int* counts, int E, int Tp, int K, int N, int route,
              cudaStream_t st) {
  if (route == kRouteWgmma) {
    // whole 16-byte chunks of bf16 along x's and dy's rows, 16-byte
    // aligned bases (then every row of every group is aligned too)
    if (K % 8 || N % 8 || !aligned(x, 16) || !aligned(dy, 16))
      return (int)cudaErrorInvalidValue;
    auto kernel = grouped_dw_wgmma<T>;
    constexpr int smem = DwLayout<T>::kSmem;
    static bool smem_set[ptt::kMaxDevices] = {};
    if (int e = ptt::raise_smem(kernel, smem, smem_set)) return e;
    const dim3 grid((N + kGN - 1) / kGN, (K + kGM - 1) / kGM, E);
    kernel<<<grid, kGThreads, smem, st>>>(
        (const T*)x, (const T*)dy, (float*)dw, offsets, counts, Tp, K, N);
    return (int)cudaGetLastError();
  }
  if (route != kRouteCudaCore) return (int)cudaErrorInvalidValue;
  const int vb = sizeof(T) * 4;
  const int vec_x = (K % 4 == 0) && aligned(x, vb);
  const int vec_dy = (N % 4 == 0) && aligned(dy, vb);
  const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, E);
  grouped_dw<T><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, (float*)dw, offsets, counts, Tp, K, N,
      vec_x, vec_dy);
  return (int)cudaGetLastError();
}

}  // namespace

// x [Tp, K]; w [E, K, N], or [E, N, K] when trans (then out[r] = x[r] .
// w[e]^T); b [E, N] or null; out [Tp, N]; x, w, b and out share the dtype
// (0 = float32, 1 = bfloat16); offsets, counts [E] int32 on the card. All
// contiguous. route: 0 = cuda_core (`grouped_fwd`), 1 = wgmma
// (`grouped_wgmma`: bm % 128 == 0, K % 64 == 0, N % 8 == 0 unless trans,
// 16-byte aligned x and w). Returns the CUDA error code of the launch (0
// on success); cudaErrorInvalidValue for inputs the route does not take.
extern "C" int grouped_matmul_fwd(const void* x, const void* w,
                                  const void* b, void* out,
                                  const void* offsets, const void* counts,
                                  int E, int Tp, int K, int N, int bm,
                                  int trans, int dtype, int route,
                                  void* stream) {
  if (E <= 0 || Tp <= 0 || K <= 0 || N <= 0 || bm <= 0 ||
      (Tp + kBM - 1) / kBM > 65535 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  if (dtype == ptt::kFloat32)
    return launch_fwd<float>(x, w, b, out, off, cnt, E, Tp, K, N, bm, trans,
                             route, st);
  if (dtype == ptt::kBFloat16)
    return launch_fwd<__nv_bfloat16>(x, w, b, out, off, cnt, E, Tp, K, N,
                                     bm, trans, route, st);
  return (int)cudaErrorInvalidValue;
}

// x [Tp, K] and dy [Tp, N] of one dtype (0 = float32, 1 = bfloat16);
// dw [E, K, N] float32; offsets, counts [E] int32 on the card. All
// contiguous. route: 0 = cuda_core (`grouped_dw`), 1 = wgmma
// (`grouped_dw_wgmma`: K % 8 == 0, N % 8 == 0, 16-byte aligned x and dy).
// Returns the CUDA error code of the launch (0 on success);
// cudaErrorInvalidValue for inputs the route does not take.
extern "C" int grouped_matmul_dw(const void* x, const void* dy, void* dw,
                                 const void* offsets, const void* counts,
                                 int E, int Tp, int K, int N, int dtype,
                                 int route, void* stream) {
  if (E <= 0 || Tp <= 0 || K <= 0 || N <= 0 ||
      (K + kBM - 1) / kBM > 65535 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  if (dtype == ptt::kFloat32)
    return launch_dw<float>(x, dy, dw, off, cnt, E, Tp, K, N, route, st);
  if (dtype == ptt::kBFloat16)
    return launch_dw<__nv_bfloat16>(x, dy, dw, off, cnt, E, Tp, K, N, route,
                                    st);
  return (int)cudaErrorInvalidValue;
}
