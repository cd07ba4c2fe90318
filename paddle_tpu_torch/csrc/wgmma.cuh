// Hopper tensor-core primitives: warpgroup matrix multiply (`wgmma`) from
// shared memory, its descriptors, and 16-byte `cp.async` copies.
//
// What every primitive here assumes:
// - One warpgroup (128 consecutive threads, the first of them a multiple of
//   128) issues each wgmma together: fence, mma, commit and wait are
//   `.sync.aligned` and must be reached by all 128 threads.
// - Operand tiles are bf16, K-major (the contraction dim is contiguous), 64
//   values of K per row, so a row is 128 bytes, with the 128-byte swizzle:
//   16-byte chunk c of row r sits at byte r * 128 + ((c ^ (r & 7)) * 16)
//   (`sw128`). A tile's base is 1024-byte aligned (8 rows of 128 bytes,
//   one whole swizzle pattern), so the descriptor's base offset is 0.
// - The descriptor (`desc_sw128`) names that layout: the start address over
//   16, SBO 1024 bytes (the next 8-row group), LBO 1 (unused by a swizzled
//   K-major operand) and layout type 1 (128-byte swizzle). The k16 step j of
//   a 64-wide tile starts 32 * j bytes in: add 2 * j to the descriptor.
// - `mma_m64n128k16` computes D[64, 128] (+)= A[64, 16] . B[128, 16]^T with
//   both A and B K-major in shared memory (the `SS` form, no transpose
//   flags), float32 accumulators in registers. Thread t of the warpgroup
//   holds d[i] at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and
//   column 8 * (i / 4) + 2 * (t % 4) + i % 2. `scale_d` 0 writes D = A.B^T,
//   1 adds to it.
// - `mma_m64n64k16` is the same SS product at N 64 (32 accumulators a
//   thread, the same fragment rule).
// - The same 128B-swizzled tile also serves as an MN-major operand (the
//   N dim contiguous): a [rows, D] tile stored as D-panels of 64 values
//   (each panel rows x 128 bytes, the panels one after another) read as
//   B[N = D, K = rows]. `desc_sw128_mn` names it: LBO is the byte step
//   between 64-wide D-panels (rows * 128) and SBO 1024 bytes, the step
//   between 8-row groups along the contraction; the k16 step j starts 16
//   rows in, 2048 * j bytes (a multiple of 1024, so the base offset stays
//   0). A [64, 64] tile has one panel and N 64 never reads the LBO.
// - `mma_m64n128k16_ss_tb` is the SS form with B transposed (`tnspB` =
//   1): A K-major as above, B [K, N 128] stored as two N-panels of 64 and
//   read through `desc_sw128_mn`, as an N-contiguous weight [K, N] lands
//   when its rows are copied 16 bytes at a time.
// - `mma_m64n128k16_ss_tatb` transposes A too (`tnspA` = 1): A [K, M 64]
//   is one such M-panel (M = 64 is one swizzle atom wide, so its LBO is
//   never read), the same descriptor, as the columns of a row-major
//   [rows, M] matrix land when the rows are the contraction (the grouped
//   weight gradient's x). All three are `mma_m64n128k16_ss<TA, TB>`.
// - `mma_m64n{64,128}k16_rs_tb` is the RS form with B transposed: A
//   [64, 16] comes from registers, B through an MN-major descriptor
//   (`tnspB` = 1). Thread t's four A registers hold, as bf16 pairs with
//   the lower column in the low half, rows 16 * (t / 32) + (t % 32) / 4
//   (registers 0 and 2) and 8 more (1 and 3), columns 2 * (t % 4) + {0, 1}
//   (registers 0 and 1) and 8 more (2 and 3): exactly where k16 slice j of
//   a float32 accumulator D[64, N] keeps d[8j .. 8j + 7], so
//   `frag_a_hilo<j>` turns an accumulator into the A operand of the next
//   product without shared memory. It splits each float32 x into hi =
//   bf16(x) and lo = bf16(x - hi), so that two RS products, hi then lo,
//   into one float32 accumulator carry x to about 2^-16 of itself.
//   `split3` instead splits a float32 operand exactly into three bf16
//   pieces (truncated hi, mid, lo), and `split3_store8` writes eight of
//   them into three swizzled tiles (`split_finite8` the same for values
//   taken as finite, flagging the rest): three SS products against an
//   operand that is exact in bf16 (weight codes) give the float32
//   products; with both operands split, six of the nine piece products
//   do (csrc/grouped_matmul.cu).
// - The A registers are read while the wgmma runs: write them, then
//   `fence_operand(a)` and `fence()` before the wgmma, and leave them
//   unchanged until a `wait` that covers it.
// - Between a thread's own reads or writes of d and a wgmma on d, call
//   `fence()`; after `wait<N>()` and before d is read, `fence_operand(d)`
//   keeps the compiler from moving the read above the wait.
// - Shared memory written by ordinary stores or by cp.async and then read by
//   wgmma (the async proxy) needs `fence_proxy_async()` by the writing
//   threads before the barrier that publishes it.
// - `cp_async16` copies 16 bytes from global to shared memory, both 16-byte
//   aligned; with `valid` false it reads nothing and writes 16 zero bytes.
//   `load_panels` copies a 64-row tile into D-panels with it, and
//   `load_panels_strided` does the same from rows with any stride that
//   keeps them 16-byte aligned. `cp_async4` copies 4 bytes (a tile's
//   per-row int attributes).
#pragma once

#include <stdint.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {
namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..7) of row r in a 128B-swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;      // start address, 16-byte units
  d |= uint64_t(1) << 16;                    // LBO (unused here)
  d |= uint64_t(1024 >> 4) << 32;            // SBO: the next 8 rows
  d |= uint64_t(1) << 62;                    // 128-byte swizzle
  return d;
}

// the same tile read MN-major; panel_bytes = rows * 128, the D-panel step
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr,
                                                  uint32_t panel_bytes) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;             // start, 16-byte units
  d |= uint64_t((panel_bytes >> 4) & 0x3FFFu) << 16;  // LBO: next D-panel
  d |= uint64_t(1024 >> 4) << 32;  // SBO: next 8 rows of the contraction
  d |= uint64_t(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operand(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64, 128] (+)= A[64, 16] . B[16, 128] from shared memory (the SS form);
// TA, TB: A, B read MN-major (the `tnspA`, `tnspB` immediates), else
// K-major
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16_ss(float (&d)[64],
                                                  uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// both operands K-major
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  mma_m64n128k16_ss<0, 0>(d, da, db, scale_d);
}

// the SS product with B transposed: B [K 16, N 128] read MN-major through
// `desc_sw128_mn` (tnspB = 1), A K-major as in mma_m64n128k16
__device__ __forceinline__ void mma_m64n128k16_ss_tb(float (&d)[64],
                                                     uint64_t da,
                                                     uint64_t db,
                                                     int scale_d) {
  mma_m64n128k16_ss<0, 1>(d, da, db, scale_d);
}

// the SS product with A and B both transposed (tnspA = tnspB = 1): A [K
// 16, M 64] and B [K 16, N 128] each read MN-major through `desc_sw128_mn`
__device__ __forceinline__ void mma_m64n128k16_ss_tatb(float (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int scale_d) {
  mma_m64n128k16_ss<1, 1>(d, da, db, scale_d);
}

__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_m64n64k16_rs_tb(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void mma_m64n128k16_rs_tb(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// k16 slice J of a float32 accumulator as the A operand of an RS wgmma, in
// two parts: hi = bf16(x), lo = bf16(x - hi), round to nearest each
template <int J, int R>
__device__ __forceinline__ void frag_a_hilo(const float (&d)[R],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  static_assert(8 * J + 8 <= R, "the slice lies in the accumulator");
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[8 * J + 2 * i], x1 = d[8 * J + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// float32 x as three bf16 pieces with hi + mid + lo == x exactly: hi is
// the top 16 bits of x, r = x - hi (exact), mid the top 16 bits of r, and
// lo = r - mid, which keeps at most 8 significant bits and is exact in
// bf16 (for |x| >= 2^-100, where no piece falls below bf16's subnormal
// step). Truncation, not rounding, so hi cannot overflow near FLT_MAX. A
// non-finite x goes whole into hi, with a NaN's quiet bit set (a NaN whose
// payload sits in the low 16 bits alone would truncate to inf), and mid =
// lo = 0, so an inf times a code gives what the float32 product gives.
// Each piece is returned in the upper half of a 32-bit word.
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t hu = u & 0xFFFF0000u;
  const float r = x - __uint_as_float(hu);
  const uint32_t mu = __float_as_uint(r) & 0xFFFF0000u;
  const uint32_t lu = __float_as_uint(r - __uint_as_float(mu));
  const bool finite = (u & 0x7F800000u) != 0x7F800000u;
  h = finite ? hu : (hu | ((u & 0x007FFFFFu) ? 0x00400000u : 0u));
  m = finite ? mu : 0u;
  l = finite ? lu : 0u;
}

// hi, mid and lo of eight values (each piece in the upper half of a
// word) stored as three 16-byte chunks of bf16 at byte offset `off` of
// three tiles `panel` bytes apart from `base`, the first value in the low
// half of each word
__device__ __forceinline__ void store_pieces8(uint8_t* base, uint32_t off,
                                              int panel,
                                              const uint32_t (&h)[8],
                                              const uint32_t (&m)[8],
                                              const uint32_t (&l)[8]) {
  // __byte_perm(p, q, 0x7632): the upper halves of p (low) and q (high)
  *reinterpret_cast<uint4*>(base + off) = make_uint4(
      __byte_perm(h[0], h[1], 0x7632), __byte_perm(h[2], h[3], 0x7632),
      __byte_perm(h[4], h[5], 0x7632), __byte_perm(h[6], h[7], 0x7632));
  *reinterpret_cast<uint4*>(base + panel + off) = make_uint4(
      __byte_perm(m[0], m[1], 0x7632), __byte_perm(m[2], m[3], 0x7632),
      __byte_perm(m[4], m[5], 0x7632), __byte_perm(m[6], m[7], 0x7632));
  *reinterpret_cast<uint4*>(base + 2 * panel + off) = make_uint4(
      __byte_perm(l[0], l[1], 0x7632), __byte_perm(l[2], l[3], 0x7632),
      __byte_perm(l[4], l[5], 0x7632), __byte_perm(l[6], l[7], 0x7632));
}

// Eight consecutive float32 values (a, then b) split into three 16-byte
// chunks of bf16 (`split3`), stored at byte offset `off` of three tiles
// `panel` bytes apart from `base`: hi, mid, lo.
__device__ __forceinline__ void split3_store8(uint8_t* base, uint32_t off,
                                              int panel, float4 a,
                                              float4 b) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[8], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) split3(v[i], h[i], m[i], l[i]);
  store_pieces8(base, off, panel, h, m, l);
}

// `split3_store8` for values the caller treats as finite: `split3`'s
// rule without its handling of inf and NaN (about half the work). A
// non-finite x gives r = x - hi = NaN, and `nan` (the sum of every r)
// turns NaN with it, so the caller can set the pieces of such values
// aside.
__device__ __forceinline__ void split_finite8(uint8_t* base, uint32_t off,
                                              int panel, float4 a, float4 b,
                                              float& nan) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[8], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = __float_as_uint(v[i]) & 0xFFFF0000u;
    const float r = v[i] - __uint_as_float(h[i]);
    m[i] = __float_as_uint(r) & 0xFFFF0000u;
    l[i] = __float_as_uint(r - __uint_as_float(m[i]));
    nan += r;
  }
  store_pieces8(base, off, panel, h, m, l);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [r0, r0 + 64) of a bf16 matrix with a row stride (in elements, a
// multiple of 8, so every row stays 16-byte aligned) into a 64-row tile
// of D-panels at shared address dst (D / 64 panels of 64 x 128 bytes,
// 128B-swizzled), by the 128 threads of a warpgroup; rows at or past `hi`
// are zero-filled without a read. src 16-byte aligned (D a multiple of
// 64). The row stride is H * D or more for operands read in place from
// [B, S, H, D].
template <int D>
__device__ __forceinline__ void load_panels_strided(uint32_t dst,
                                                    const __nv_bfloat16* src,
                                                    long long row_stride,
                                                    int r0, int hi) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x % 128; i < 64 * C; i += 128) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < hi;
    cp_async16(dst + (c / 8) * 64 * 128 + sw128(r, c % 8),
               ok ? src + (r0 + r) * row_stride + c * 8 : src, ok);
  }
}

// the same tile of a row-major [S, D] matrix (row stride D)
template <int D>
__device__ __forceinline__ void load_panels(uint32_t dst,
                                            const __nv_bfloat16* src, int r0,
                                            int S) {
  load_panels_strided<D>(dst, src, D, r0, S);
}

// 4 bytes from global to shared memory, both 4-byte aligned; with `valid`
// false it reads nothing and writes 4 zero bytes
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace wg
}  // namespace ptt
