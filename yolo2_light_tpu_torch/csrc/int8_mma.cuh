// The int8 tensor-core building blocks of the hand kernels: asynchronous
// global->shared copies, ldmatrix fragment loads, the s8 MMA, and one warp's
// tile of MMAs over a 32-byte K step.
//
// Operand layouts in shared memory (what ldmatrix expects):
//   A: one row of 32 K bytes per output pixel (rows may be gathered: each
//      lane passes the address of its own row), row-major 16x32 per m16 tile;
//   B: one row of 32 K bytes per output channel (K contiguous), i.e. the
//      col-major 32x8 operand of mma.m16n8k32, two n8 tiles per ldmatrix.x4.
// Row strides must be multiples of 16 bytes; a stride of an odd number of
// 16-byte units keeps the eight rows of an 8x16-byte matrix in distinct bank
// groups, so ldmatrix is free of bank conflicts.
//
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8; gid = lane / 4,
// tig = lane % 4): a0/a1 rows gid/gid+8, K bytes 4*tig..+3; a2/a3 the same
// rows, K bytes 16+4*tig..+3; b0/b1 column gid, K bytes 4*tig..+3 and
// 16+4*tig..+3; c0,c1 row gid, columns 2*tig, 2*tig+1; c2,c3 row gid+8.

#pragma once

#include <cstdint>

namespace i8mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global->shared, bypassing L1; src-size 0 writes 16 zero bytes
// (out-of-image taps, ragged rows and channels) without reading `src`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes global->shared (four bf16 channels).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
}

// 4 bytes global->shared (rows whose length is not a multiple of 16 bytes).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared-memory address this lane passes to ldmatrix for an A m16 tile
// whose row for this lane starts at `row_addr`: lanes 0-15 give rows 0-15 at
// K bytes 0-15, lanes 16-31 the same rows at K bytes 16-31.
__device__ __forceinline__ uint32_t a_lane_offset(int lane) {
  return static_cast<uint32_t>((lane >> 4) << 4);
}

// The row (output channel, relative to an n16 pair) and K-byte offset this
// lane passes to ldmatrix for two n8 B tiles: matrices (n 0-7, K 0-15),
// (n 0-7, K 16-31), (n 8-15, K 0-15), (n 8-15, K 16-31).
__device__ __forceinline__ int b_lane_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ uint32_t b_lane_offset(int lane) {
  return static_cast<uint32_t>(((lane >> 3) & 1) << 4);
}

// One 32-byte K step of a warp's kMt x kNt tile of m16n8 MMAs. a_addr[i]:
// this lane's ldmatrix address in A m16 tile i (a_lane_offset included);
// b_addr: this lane's address for the first n16 pair (b_lane_row and
// b_lane_offset included); b_pair_stride: bytes between n16 pairs.
template <int kMt, int kNt>
__device__ __forceinline__ void warp_tile_k32(int (&acc)[kMt][kNt][4],
                                              const uint32_t (&a_addr)[kMt],
                                              uint32_t b_addr,
                                              uint32_t b_pair_stride) {
  static_assert(kNt % 2 == 0, "B tiles are loaded in n16 pairs");
  uint32_t a[kMt][4];
  uint32_t b[kNt / 2][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i) ldmatrix_x4(a[i], a_addr[i]);
#pragma unroll
  for (int j = 0; j < kNt / 2; ++j)
    ldmatrix_x4(b[j], b_addr + j * b_pair_stride);
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      mma_s8(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
}

// warp_tile_k32 split in two, so a caller can load the next K step's
// fragments before it issues this step's MMAs (ldmatrix and mma are
// volatile asm, which the compiler does not reorder).
template <int kMt, int kNt>
struct Frags {
  uint32_t a[kMt][4];
  uint32_t b[kNt / 2][4];
};

template <int kMt, int kNt>
__device__ __forceinline__ void load_frags(Frags<kMt, kNt>& f,
                                           const uint32_t (&a_addr)[kMt],
                                           uint32_t b_addr,
                                           uint32_t b_pair_stride) {
  static_assert(kNt % 2 == 0, "B tiles are loaded in n16 pairs");
#pragma unroll
  for (int i = 0; i < kMt; ++i) ldmatrix_x4(f.a[i], a_addr[i]);
#pragma unroll
  for (int j = 0; j < kNt / 2; ++j)
    ldmatrix_x4(f.b[j], b_addr + j * b_pair_stride);
}

template <int kMt, int kNt>
__device__ __forceinline__ void mma_frags(int (&acc)[kMt][kNt][4],
                                          const Frags<kMt, kNt>& f) {
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
      mma_s8(acc[i][j], f.a[i], f.b[j / 2][2 * (j & 1)],
             f.b[j / 2][2 * (j & 1) + 1]);
}

// Writes a warp's accumulators into an int32 tile in shared memory whose
// row `row0` column `col0` is the warp tile's origin (ld: row stride in
// int32 words, even).
template <int kMt, int kNt>
__device__ __forceinline__ void store_acc(int* tile, int ld, int row0,
                                          int col0,
                                          const int (&acc)[kMt][kNt][4],
                                          int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      int* p = tile + (row0 + 16 * i + gid) * ld + col0 + 8 * j + 2 * tig;
      *reinterpret_cast<int2*>(p) = make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(p + 8 * ld) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace i8mma
