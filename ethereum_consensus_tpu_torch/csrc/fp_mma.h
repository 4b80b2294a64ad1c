// The Montgomery product of BLS12-381's base field on the int8 tensor cores:
// a * b * 2^-384 mod p with the schoolbook product AND the Montgomery
// reduction as mma.sync.m16n8k32 steps (s8 x s8 -> s32). The "mxu"
// multiplier of the pairing tower: built with -DFP381_MUL_MXU, fp381::mul
// (fp381_core.h) and with it every product of fp_tower.h run here, one warp
// a product; B8 (mont_mxu.cu) runs 16 products a warp on the tile functions
// at the end of this file.
//
// Replaces the reference's (ethereum_consensus_tpu) ops/fq8.py:300 mont7r,
// with :265 _to7r, :280 product_cols7r and :102 _reduce8, selected there by
// ops/fql.py:117 set_multiplier("mxu") at :140. Like mont7r it splits each
// operand into seven-bit digits (signed int8: at most 127) and forms the
// digit columns of the schoolbook product as an integer matrix product.
// Operands below 2^385 have 55 digits, so a column is at most 55 * 127^2 <
// 2^20, exact in int32. R = 2^384, shared with the u64 builds; the output
// is canonical, equal bit for bit to the CIOS product of fp381_core.h.
//
// The reduction is three products, not byte rounds:
//   x = T mod 2^384        T = a * b, its low 55 columns carried to digits
//                          (digit 54 keeps 6 bits: 384 = 7 * 54 + 6)
//   m = x * n' mod 2^384   n' = -p^-1 mod 2^384, full width; the low 55
//                          columns, carried and cut the same way
//   U = T + m * p          every column below 2^21; U = 0 mod 2^384, and
//                          U / 2^384 < 2p: one conditional subtraction.
// n' and p are the same for every product: their tensor-core operands are
// constants (kLaneB below for the warp's product, a shared-memory table for
// B8's tiles).
//
// Mapping of one product on a warp: the 16 x 8 accumulator holds column
// alpha(r) + beta(n) at row r, column n, with alpha(r) = 16 (r mod 8) +
// 2 floor(r / 8) and beta(n) = 4 floor(n / 2) + (n mod 2), so that lane l's
// four accumulators are the columns 4l .. 4l + 3 (128 >= 109 columns). The A
// tile is Toeplitz, A[r][k] = a7[alpha(r) - k + 13], the B tile Hankel,
// B[k][n] = b7[k - 13 + beta(n)], with K = 96 (three k32 steps; the low 55
// columns need only the first two). Each lane holds one "digit word": the
// four digits 4l .. 4l + 3 of a value, one a byte (lanes 14 .. 31 hold 0).
// A fragment register is four consecutive digits, so it is two words from
// __shfl_sync and one __byte_perm. A carry pass is split across the warp:
// lane l packs its four columns into one value of weight 2^(28 l), keeps 28
// bits and hands the rest to lane l + 1 (__shfl_up_sync), and the last
// one-bit ripple is a carry-lookahead over three __ballot_sync masks. A
// lane's 28 carried bits are again its digit word. No thread repeats
// another's reduction; only the last conditional subtraction runs in every
// thread, which needs the value anyway.
//
// What bounds it on an H100: not the tensor cores (eight steps of 16K
// multiply-adds at 1,979 T op/s). The warp's product is a chain of
// dependent steps (the mma steps, three carry passes and the exchanges of
// fragments and carries between lanes), which a warp-per-lane kernel of few
// warps waits on; B8's tiles are bound by moving each product's fragments
// through shared memory (mont_mxu.cu).
//
// Outside nvcc (and in nvcc's host pass) the same steps run as a host
// emulation: 32 simulated lanes build their fragments with the same maps,
// the m16n8k32 product is taken over the matrices those fragments hold
// (scattered by the PTX ISA's layout tables for .s8), each lane's
// accumulators go back by the same tables, and the exchanges of the carry
// passes are array reads. A g++ test holds it against the CIOS product
// before the card sees it.

#pragma once

#include <stdint.h>

#include "fp381_core.h"

#ifdef __CUDACC__
#define FP_MMA_HD __host__ __device__ __forceinline__
#else
#define FP_MMA_HD inline
#endif

// n' = -p^-1 mod 2^384, least significant limb first
#define FP_MMA_NPRIME_LIMBS                                                \
  0xfffcfffdu, 0x89f3fffcu, 0xd9d113e8u, 0x286adb92u, 0xc8e30b48u,        \
      0x16ef2ef0u, 0x8eb2db4cu, 0x19ecca0eu, 0xe268cf58u, 0x68b316feu,    \
      0xfeaafc94u, 0xceb06106u
// the digit words of p and of n' (word q: digits 4q .. 4q + 3, one a byte)
#define FP_MMA_CONSTANT_WORDS                                              \
  {0x7f7e552bu, 0x7f3f7f7fu, 0x1f7f7f39u, 0x7f7f5615u, 0x31103d2bu,       \
   0x503d560fu, 0x7b1c6152u, 0x7961222bu, 0x235d1704u, 0x256b1a76u,       \
   0x5d1e6c43u, 0x73264931u, 0x0f28727fu, 0x00064011u, 0u, 0u},           \
  {0x7f737f7du, 0x797f7f4fu, 0x084f5109u, 0x6d645b1du, 0x5a20506au,       \
   0x78321c30u, 0x605b5e2eu, 0x472c5b34u, 0x4f33140eu, 0x34336b01u,       \
   0x185b7d62u, 0x7e250d0bu, 0x081b7d2au, 0x00335606u, 0u, 0u}
// Each lane's B fragment registers of the Hankel tiles of n' (two steps,
// two registers each) and of p (three steps), then two zero words: the
// b_register of those digit words at every lane, step and register.
#define FP_MMA_LANE_B                                                        \
  0x00000000u, 0x7f7f4f7fu, 0x321c305au, 0x336b014fu, 0x00000000u, 0x3f7f7f7fu, \
      0x3d560f31u, 0x6b1a7623u, 0x0640110fu, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x4f510979u, 0x5b5e2e78u, 0x5b7d6234u, 0x00000000u, 0x7f7f397fu, \
      0x1c615250u, 0x1e6c4325u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x645b1d08u, 0x2c5b3460u, 0x250d0b18u, 0x00000000u, 0x7f56151fu, \
      0x61222b7bu, 0x2649315du, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x737f7d00u, 0x20506a6du, 0x33140e47u, 0x1b7d2a7eu, 0x7e552b00u, 0x103d2b7fu, \
      0x5d170479u, 0x28727f73u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x797f7f4fu, 0x78321c30u, 0x34336b01u, 0x00000000u, 0x7f3f7f7fu, \
      0x503d560fu, 0x256b1a76u, 0x00064011u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x084f5109u, 0x605b5e2eu, 0x185b7d62u, 0x00000000u, 0x1f7f7f39u, \
      0x7b1c6152u, 0x5d1e6c43u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x6d645b1du, 0x472c5b34u, 0x7e250d0bu, 0x00000000u, 0x7f7f5615u, \
      0x7961222bu, 0x73264931u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f737f7du, 0x5a20506au, 0x4f33140eu, 0x081b7d2au, 0x7f7e552bu, 0x31103d2bu, \
      0x235d1704u, 0x0f28727fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x4f510979u, 0x5b5e2e78u, 0x5b7d6234u, 0x00000000u, 0x7f7f397fu, \
      0x1c615250u, 0x1e6c4325u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x645b1d08u, 0x2c5b3460u, 0x250d0b18u, 0x00000000u, 0x7f56151fu, \
      0x61222b7bu, 0x2649315du, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x737f7d00u, 0x20506a6du, 0x33140e47u, 0x1b7d2a7eu, 0x7e552b00u, 0x103d2b7fu, \
      0x5d170479u, 0x28727f73u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f7f4f7fu, 0x321c305au, 0x336b014fu, 0x33560608u, 0x3f7f7f7fu, 0x3d560f31u, \
      0x6b1a7623u, 0x0640110fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x084f5109u, 0x605b5e2eu, 0x185b7d62u, 0x00000000u, 0x1f7f7f39u, \
      0x7b1c6152u, 0x5d1e6c43u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x6d645b1du, 0x472c5b34u, 0x7e250d0bu, 0x00000000u, 0x7f7f5615u, \
      0x7961222bu, 0x73264931u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f737f7du, 0x5a20506au, 0x4f33140eu, 0x081b7d2au, 0x7f7e552bu, 0x31103d2bu, \
      0x235d1704u, 0x0f28727fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x797f7f4fu, 0x78321c30u, 0x34336b01u, 0x00335606u, 0x7f3f7f7fu, 0x503d560fu, \
      0x256b1a76u, 0x00064011u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x645b1d08u, 0x2c5b3460u, 0x250d0b18u, 0x00000000u, 0x7f56151fu, \
      0x61222b7bu, 0x2649315du, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x737f7d00u, 0x20506a6du, 0x33140e47u, 0x1b7d2a7eu, 0x7e552b00u, 0x103d2b7fu, \
      0x5d170479u, 0x28727f73u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f7f4f7fu, 0x321c305au, 0x336b014fu, 0x33560608u, 0x3f7f7f7fu, 0x3d560f31u, \
      0x6b1a7623u, 0x0640110fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x4f510979u, 0x5b5e2e78u, 0x5b7d6234u, 0x00000000u, 0x7f7f397fu, 0x1c615250u, \
      0x1e6c4325u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x00000000u, 0x6d645b1du, 0x472c5b34u, 0x7e250d0bu, 0x00000000u, 0x7f7f5615u, \
      0x7961222bu, 0x73264931u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f737f7du, 0x5a20506au, 0x4f33140eu, 0x081b7d2au, 0x7f7e552bu, 0x31103d2bu, \
      0x235d1704u, 0x0f28727fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x797f7f4fu, 0x78321c30u, 0x34336b01u, 0x00335606u, 0x7f3f7f7fu, 0x503d560fu, \
      0x256b1a76u, 0x00064011u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x084f5109u, 0x605b5e2eu, 0x185b7d62u, 0x00000000u, 0x1f7f7f39u, 0x7b1c6152u, \
      0x5d1e6c43u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x737f7d00u, 0x20506a6du, 0x33140e47u, 0x1b7d2a7eu, 0x7e552b00u, 0x103d2b7fu, \
      0x5d170479u, 0x28727f73u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f7f4f7fu, 0x321c305au, 0x336b014fu, 0x33560608u, 0x3f7f7f7fu, 0x3d560f31u, \
      0x6b1a7623u, 0x0640110fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x4f510979u, 0x5b5e2e78u, 0x5b7d6234u, 0x00000000u, 0x7f7f397fu, 0x1c615250u, \
      0x1e6c4325u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x645b1d08u, 0x2c5b3460u, 0x250d0b18u, 0x00000000u, 0x7f56151fu, 0x61222b7bu, \
      0x2649315du, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x7f737f7du, 0x5a20506au, 0x4f33140eu, 0x081b7d2au, 0x7f7e552bu, 0x31103d2bu, \
      0x235d1704u, 0x0f28727fu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x797f7f4fu, 0x78321c30u, 0x34336b01u, 0x00335606u, 0x7f3f7f7fu, 0x503d560fu, \
      0x256b1a76u, 0x00064011u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x084f5109u, 0x605b5e2eu, 0x185b7d62u, 0x00000000u, 0x1f7f7f39u, 0x7b1c6152u, \
      0x5d1e6c43u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
  0x6d645b1du, 0x472c5b34u, 0x7e250d0bu, 0x00000000u, 0x7f7f5615u, 0x7961222bu, \
      0x73264931u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u

namespace fp_mma {

constexpr int kWordLanes = 14;    // lanes whose digit words can be non-zero
constexpr int kSteps = 3;         // k32 steps of a whole product: K = 96
constexpr int kLowSteps = 2;      // k32 steps of a product's low 56 columns
constexpr int kShift = 13;        // A's and B's digit offset: the largest beta
constexpr int kChunkBits = 28;    // a lane's four columns: 4 x 7 bits
constexpr uint32_t kChunkMask = (1u << kChunkBits) - 1;
constexpr int kTopLane = 13;      // bits 364 .. 391: mod 2^384 keeps 20
constexpr uint32_t kTopMask = (1u << (384 - kChunkBits * kTopLane)) - 1;
constexpr int kLaneBWords = 12;   // a lane's row of kLaneB (10 registers, 2 zero)
constexpr int kMaxWarps = 8;      // warps a block of the mxu kernels may hold

// --- the PTX ISA's fragment layouts of mma.m16n8k32 with .s8 operands ------
// (groupID = lane >> 2, threadID_in_group = lane & 3)
// A (16 x 32, row-major): a0..a15 in four .b32 registers, element i in byte
// i & 3 of register i >> 2; row groupID (+8 for i in 4..7 and 12..15), column
// 4 threadID_in_group + (i & 3) (+16 for i >= 8).
FP_MMA_HD int a_row(int lane, int i) { return (lane >> 2) + (((i >> 2) & 1) << 3); }
FP_MMA_HD int a_col(int lane, int i) { return ((lane & 3) << 2) + (i & 3) + ((i >> 3) << 4); }
// B (32 x 8, column-major): b0..b7 in two .b32 registers; row
// 4 threadID_in_group + (i & 3) (+16 for i >= 4), column groupID.
FP_MMA_HD int b_row(int lane, int i) { return ((lane & 3) << 2) + (i & 3) + ((i >> 2) << 4); }
FP_MMA_HD int b_col(int lane, int i) {
  (void)i;
  return lane >> 2;
}
// C and D (16 x 8 .s32): c0..c3; row groupID (+8 for c2, c3), column
// 2 threadID_in_group + (i & 1).
FP_MMA_HD int c_row(int lane, int i) { return (lane >> 2) + ((i >> 1) << 3); }
FP_MMA_HD int c_col(int lane, int i) { return ((lane & 3) << 1) + (i & 1); }

// --- the Toeplitz and Hankel maps of one product ------------------------------
FP_MMA_HD int alpha(int row) { return 16 * (row & 7) + 2 * (row >> 3); }
FP_MMA_HD int beta(int col) { return 4 * (col >> 1) + (col & 1); }
// k = 32 step + the tile's column (A) or row (B)
FP_MMA_HD int a_digit(int step, int row, int col) {
  return alpha(row) + kShift - (32 * step + col);
}
FP_MMA_HD int b_digit(int step, int row, int col) { return 32 * step + row - kShift + beta(col); }
FP_MMA_HD int d_column(int row, int col) { return alpha(row) + beta(col); }

// Bytes of the pair {lo, hi} (lo's bytes 0..3, hi's 4..7) picked by the
// selector's four nibbles: PRMT.
FP_MMA_HD uint32_t byte_perm(uint32_t lo, uint32_t hi, uint32_t sel) {
#ifdef __CUDA_ARCH__
  return __byte_perm(lo, hi, sel);
#else
  const uint64_t both = lo | (static_cast<uint64_t>(hi) << 32);
  uint32_t r = 0;
  for (int e = 0; e < 4; ++e) {
    r |= static_cast<uint32_t>((both >> (8 * ((sel >> (4 * e)) & 7))) & 0xffu) << (8 * e);
  }
  return r;
#endif
}

// A fragment register of four digits from digit words: `src(q)` is word q
// (0 outside the value). Descending from digit d0 (the Toeplitz tiles) or
// ascending (the Hankel tiles).
template <class Src>
FP_MMA_HD uint32_t descending_register(const Src& src, int d0) {
  const int q = d0 >> 2;  // floor: d0 may be negative
  const uint32_t r0 = static_cast<uint32_t>(d0) & 3u;
  return byte_perm(src(q - 1), src(q), (r0 + 4) | (r0 + 3) << 4 | (r0 + 2) << 8 | (r0 + 1) << 12);
}

template <class Src>
FP_MMA_HD uint32_t ascending_register(const Src& src, int d0) {
  const int q = d0 >> 2;
  const uint32_t r0 = static_cast<uint32_t>(d0) & 3u;
  return byte_perm(src(q), src(q + 1), r0 | (r0 + 1) << 4 | (r0 + 2) << 8 | (r0 + 3) << 12);
}

// Fragment register `reg` of `lane` at `step`: A of the Toeplitz tile, B of
// the Hankel tile, of the value whose digit words `src` gives.
template <class Src>
FP_MMA_HD uint32_t a_register(const Src& src, int lane, int step, int reg) {
  const int d0 = a_digit(step, a_row(lane, 4 * reg), a_col(lane, 4 * reg));
  // alpha(row) = 2 (reg & 1) mod 4 and the column is 0 mod 4, so d0 mod 4
  // is fixed by reg: where it is 3, the four digits are one word, reversed
  if ((2 * (reg & 1) + kShift) % 4 == 3) return byte_perm(src(d0 >> 2), 0, 0x0123);
  return descending_register(src, d0);
}

template <class Src>
FP_MMA_HD uint32_t b_register(const Src& src, int lane, int step, int reg) {
  return ascending_register(src, b_digit(step, b_row(lane, 4 * reg), b_col(lane, 4 * reg)));
}

// 28 bits -> four 7-bit digits, one a byte
FP_MMA_HD uint32_t spread(uint32_t chunk) {
  return (chunk & 0x7fu) | ((chunk << 1) & 0x7f00u) | ((chunk << 2) & 0x7f0000u) |
         ((chunk << 3) & 0x7f000000u);
}

// Lane `lane`'s digit word of the 12 limbs (bits 28 lane .. 28 lane + 27).
FP_MMA_HD uint32_t digit_word(const uint32_t* limbs, int lane) {
  const int bit = kChunkBits * (lane < kWordLanes ? lane : 0);
  const int w = bit >> 5;
  const uint64_t pair =
      limbs[w] | (w + 1 < fp381::kLimbs ? static_cast<uint64_t>(limbs[w + 1]) << 32 : 0);
  const uint32_t word = spread(static_cast<uint32_t>(pair >> (bit & 31)) & kChunkMask);
  return lane < kWordLanes ? word : 0u;
}

// Four columns (weights 2^0, 2^7, 2^14, 2^21 of the chunk), non-negative, as
// one value.
FP_MMA_HD uint64_t pack(const int32_t* c) {
  return static_cast<uint64_t>(static_cast<uint32_t>(c[0])) +
         (static_cast<uint64_t>(static_cast<uint32_t>(c[1])) << 7) +
         (static_cast<uint64_t>(static_cast<uint32_t>(c[2])) << 14) +
         (static_cast<uint64_t>(static_cast<uint32_t>(c[3])) << 21);
}

// Lane `lane`'s 28 carried bits kept mod 2^384 (lanes past 13 hold none).
FP_MMA_HD uint32_t low_chunk(uint32_t chunk, int lane) {
  return lane < kTopLane ? chunk : lane == kTopLane ? chunk & kTopMask : 0u;
}

// The carry-lookahead of the last ripple: generate and propagate masks of
// the lanes -> the mask of lanes that take a carry in (the sum G + (G | P)
// carries exactly where a lane generates, or propagates one it takes).
FP_MMA_HD uint32_t carries_in(uint32_t generate, uint32_t propagate) {
  return (generate + (generate | propagate)) ^ propagate;
}

// Limb k (bits 384 + 32k ..) of the value whose 28-bit chunks are
// u0 = chunk l, u1 = chunk l + 1, u2 = chunk l + 2, l = (384 + 32k) / 28.
FP_MMA_HD int limb_chunk(int k) { return (384 + 32 * k) / kChunkBits; }
FP_MMA_HD uint32_t limb_from_chunks(int k, uint32_t u0, uint32_t u1, uint32_t u2) {
  const uint64_t bits = u0 | (static_cast<uint64_t>(u1) << 28) | (static_cast<uint64_t>(u2) << 56);
  return static_cast<uint32_t>(bits >> ((384 + 32 * k) % kChunkBits));
}

#ifdef __CUDACC__
__device__ __forceinline__ void mma_m16n8k32(int32_t* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Word q of the warp's digit words (`word` is this lane's): 0 for q < 0;
// lanes 14 .. 31 hold 0.
struct ShuffledWords {
  uint32_t word;
  __device__ __forceinline__ uint32_t operator()(int q) const {
    const uint32_t v = __shfl_sync(0xffffffffu, word, q & 31);
    return q < 0 ? 0u : v;
  }
};

// The warp's carry pass: lane l's four columns d -> its 28 carried bits of
// the value sum_l pack(d_l) 2^(28 l) (below 2^896).
__device__ __forceinline__ uint32_t carry_pass(const int32_t* d, int lane) {
  const uint64_t v = pack(d);
  uint32_t up = __shfl_up_sync(0xffffffffu, static_cast<uint32_t>(v >> kChunkBits), 1);
  if (lane == 0) up = 0;
  uint32_t w = static_cast<uint32_t>(v & kChunkMask) + up;  // below 2^28 + 2^16
  const uint32_t over = __ballot_sync(0xffffffffu, w >> kChunkBits);
  w = (w & kChunkMask) + (((over << 1) >> lane) & 1u);  // at most 2^28
  const uint32_t generate = __ballot_sync(0xffffffffu, w >> kChunkBits);
  w &= kChunkMask;
  const uint32_t propagate = __ballot_sync(0xffffffffu, w == kChunkMask);
  return (w + ((carries_in(generate, propagate) >> lane) & 1u)) & kChunkMask;
}

__device__ __align__(16) const uint32_t kLaneB[32][kLaneBWords] = {FP_MMA_LANE_B};

// Each warp's slice of the in-lane product: the operands' limbs, then the
// result's.
struct Scratch {
  uint32_t limbs[2][fp381::kLimbs];
  uint32_t out[fp381::kLimbs];
};
__shared__ __align__(16) Scratch g_scratch[kMaxWarps];
#endif

// --- the host emulation of the warp's steps ----------------------------------

namespace host {

constexpr uint32_t kLaneB[32][kLaneBWords] = {FP_MMA_LANE_B};

struct Words {
  const uint32_t* w;  // the lanes' words, or a constant's
  int count;
  uint32_t operator()(int q) const { return q < 0 || q >= count ? 0u : w[q]; }
};

// The m16n8k32 product of the matrices the lanes' registers hold, added to
// their accumulators.
inline void mma(const uint32_t (*ra)[4], const uint32_t (*rb)[2], int32_t (*acc)[4]) {
  int32_t ta[16][32] = {}, tb[32][8] = {};
  for (int lane = 0; lane < 32; ++lane) {
    for (int i = 0; i < 16; ++i) {
      ta[a_row(lane, i)][a_col(lane, i)] = static_cast<int8_t>(ra[lane][i >> 2] >> (8 * (i & 3)));
    }
    for (int i = 0; i < 8; ++i) {
      tb[b_row(lane, i)][b_col(lane, i)] = static_cast<int8_t>(rb[lane][i >> 2] >> (8 * (i & 3)));
    }
  }
  for (int lane = 0; lane < 32; ++lane) {
    for (int i = 0; i < 4; ++i) {
      int32_t sum = 0;
      for (int k = 0; k < 32; ++k) sum += ta[c_row(lane, i)][k] * tb[k][c_col(lane, i)];
      acc[lane][i] += sum;
    }
  }
}

inline void carry_pass(const int32_t (*d)[4], uint32_t* out) {
  uint64_t v[32];
  uint32_t w[32], over = 0, generate = 0, propagate = 0;
  for (int lane = 0; lane < 32; ++lane) v[lane] = pack(d[lane]);
  for (int lane = 0; lane < 32; ++lane) {
    const uint32_t up = lane == 0 ? 0u : static_cast<uint32_t>(v[lane - 1] >> kChunkBits);
    w[lane] = static_cast<uint32_t>(v[lane] & kChunkMask) + up;
    over |= (w[lane] >> kChunkBits) << lane;
  }
  for (int lane = 0; lane < 32; ++lane) {
    w[lane] = (w[lane] & kChunkMask) + (((over << 1) >> lane) & 1u);
    generate |= (w[lane] >> kChunkBits) << lane;
    w[lane] &= kChunkMask;
    propagate |= static_cast<uint32_t>(w[lane] == kChunkMask) << lane;
  }
  const uint32_t in = carries_in(generate, propagate);
  for (int lane = 0; lane < 32; ++lane) out[lane] = (w[lane] + ((in >> lane) & 1u)) & kChunkMask;
}

inline int32_t column_max(const int32_t (*d)[4], int lanes) {
  int32_t most = 0;
  for (int lane = 0; lane < lanes; ++lane) {
    for (int i = 0; i < 4; ++i) most = d[lane][i] > most ? d[lane][i] : most;
  }
  return most;
}

// The largest column of each stage: T = a * b, x * n' (its low 56), and
// U = T + m * p.
struct Stages {
  int32_t t, xn, u;
};

// The products' columns by the warp's steps: the digit words, then `steps`
// m16n8k32 steps of A = Toeplitz(src_a), B = Hankel(src_b) or (src_b null)
// the lanes' constant B registers from `constant`, added to acc.
inline void toeplitz_steps(const uint32_t* wa, const uint32_t* wb, int steps, int constant,
                           int32_t (*acc)[4]) {
  for (int step = 0; step < steps; ++step) {
    uint32_t ra[32][4], rb[32][2];
    for (int lane = 0; lane < 32; ++lane) {
      for (int reg = 0; reg < 4; ++reg) ra[lane][reg] = a_register(Words{wa, 32}, lane, step, reg);
      for (int reg = 0; reg < 2; ++reg) {
        rb[lane][reg] = wb ? b_register(Words{wb, 32}, lane, step, reg)
                           : kLaneB[lane][constant + 2 * step + reg];
      }
    }
    mma(ra, rb, acc);
  }
}

}  // namespace host

// The host emulation of one warp's product, step for step as mont runs on
// the card; `stages`, when given, gets each stage's largest column.
inline fp381::Fp mont_emulated(const fp381::Fp& a, const fp381::Fp& b,
                               host::Stages* stages = nullptr) {
  uint32_t wa[32], wb[32], wx[32], wm[32], chunks[32];
  for (int lane = 0; lane < 32; ++lane) {
    wa[lane] = digit_word(a.v, lane);
    wb[lane] = digit_word(b.v, lane);
  }
  int32_t d[32][4] = {}, dx[32][4] = {};
  host::toeplitz_steps(wa, wb, kSteps, 0, d);
  const int32_t t_max = host::column_max(d, 32);
  host::carry_pass(d, chunks);
  for (int lane = 0; lane < 32; ++lane) wx[lane] = spread(low_chunk(chunks[lane], lane));
  host::toeplitz_steps(wx, nullptr, kLowSteps, 0, dx);
  const int32_t xn_max = host::column_max(dx, kWordLanes);
  host::carry_pass(dx, chunks);
  for (int lane = 0; lane < 32; ++lane) wm[lane] = spread(low_chunk(chunks[lane], lane));
  host::toeplitz_steps(wm, nullptr, kSteps, 4, d);
  if (stages) *stages = host::Stages{t_max, xn_max, host::column_max(d, 32)};
  host::carry_pass(d, chunks);
  uint32_t limbs[fp381::kLimbs];
  for (int k = 0; k < fp381::kLimbs; ++k) {
    const int l = limb_chunk(k);
    limbs[k] = limb_from_chunks(k, chunks[l], chunks[l + 1], chunks[l + 2]);
  }
  return fp381::reduce_once(limbs, 0);
}

// a * b * 2^-384 mod p, canonical. On the card every thread of the warp
// calls it with the same operands (a warp-per-lane kernel), converged, and
// gets the product; elsewhere it is the host emulation.
FP381_MUL_CALL fp381::Fp mont(fp381::Fp a, fp381::Fp b) {
#ifdef __CUDA_ARCH__
  const int lane = threadIdx.x & 31;
  Scratch& s = g_scratch[threadIdx.x >> 5];
  __syncwarp();  // the warp's reads of the previous product's slice are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < fp381::kLimbs; i += 4) {
      *reinterpret_cast<uint4*>(&s.limbs[0][i]) =
          make_uint4(a.v[i], a.v[i + 1], a.v[i + 2], a.v[i + 3]);
      *reinterpret_cast<uint4*>(&s.limbs[1][i]) =
          make_uint4(b.v[i], b.v[i + 1], b.v[i + 2], b.v[i + 3]);
    }
  }
  __syncwarp();
  const ShuffledWords wa{digit_word(s.limbs[0], lane)}, wb{digit_word(s.limbs[1], lane)};
  int32_t d[4] = {0, 0, 0, 0};
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {  // T = a * b
    uint32_t ra[4], rb[2];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) ra[reg] = a_register(wa, lane, step, reg);
#pragma unroll
    for (int reg = 0; reg < 2; ++reg) rb[reg] = b_register(wb, lane, step, reg);
    mma_m16n8k32(d, ra, rb);
  }
  const uint4* lane_b = reinterpret_cast<const uint4*>(kLaneB[lane]);
  const uint4 b0 = __ldg(lane_b);
  const uint32_t nprime_b[4] = {b0.x, b0.y, b0.z, b0.w};
  const ShuffledWords wx{spread(low_chunk(carry_pass(d, lane), lane))};
  int32_t dx[4] = {0, 0, 0, 0};
#pragma unroll
  for (int step = 0; step < kLowSteps; ++step) {  // x * n', its low 56 columns
    uint32_t ra[4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) ra[reg] = a_register(wx, lane, step, reg);
    mma_m16n8k32(dx, ra, nprime_b + 2 * step);
  }
  const uint4 b1 = __ldg(lane_b + 1), b2 = __ldg(lane_b + 2);
  const uint32_t p_b[6] = {b1.x, b1.y, b1.z, b1.w, b2.x, b2.y};
  const ShuffledWords wm{spread(low_chunk(carry_pass(dx, lane), lane))};
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {  // U = T + m * p
    uint32_t ra[4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) ra[reg] = a_register(wm, lane, step, reg);
    mma_m16n8k32(d, ra, p_b + 2 * step);
  }
  const uint32_t u = carry_pass(d, lane);
  const int l = limb_chunk(lane);
  const uint32_t limb = limb_from_chunks(lane, __shfl_sync(0xffffffffu, u, l & 31),
                                         __shfl_sync(0xffffffffu, u, (l + 1) & 31),
                                         __shfl_sync(0xffffffffu, u, (l + 2) & 31));
  if (lane < fp381::kLimbs) s.out[lane] = limb;
  __syncwarp();
  uint32_t limbs[fp381::kLimbs];
#pragma unroll
  for (int i = 0; i < fp381::kLimbs; i += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(&s.out[i]);
    limbs[i] = v.x;
    limbs[i + 1] = v.y;
    limbs[i + 2] = v.z;
    limbs[i + 3] = v.w;
  }
  return fp381::reduce_once(limbs, 0);  // below 2p < 2^382
#else
  return mont_emulated(a, b);
#endif
}

// --- B8's tile: 16 products a warp, the batch as M of m16n8k32 ---------------
//
// A warp takes 16 products at once. Each product's T = a * b runs on the
// warp's Toeplitz steps above, and its columns go to the warp's slice (row
// i of `u`). Then the reductions are real GEMMs over the tile, the products
// as rows: the digits of x (two lanes a product carry its row) times the
// Toeplitz matrix of n' (64 x 56: two k32 steps by 7 n8 tiles), the digits
// of m times the Toeplitz matrix of p (64 x 112: two by 14) added to T's
// columns, and one lane a product runs the last carry pass (from bit 336:
// U's low bits are zero) and the conditional subtraction. The B fragments
// of both Toeplitz matrices are the same for every tile: a block builds
// them once, in shared memory.

constexpr int kTileRows = 16;
constexpr int kTileSteps = 2;    // K = 64 >= 55 digits
constexpr int kLowTiles = 7;     // n8 tiles of x * n' mod 2^384: 56 columns
constexpr int kFullTiles = 14;   // of m * p: 112 >= 109 columns
constexpr int kUStride = 116;    // words a row (29 x 16 bytes: no bank conflict a quarter warp)
constexpr int kMStride = 60;
constexpr int kXStride = 20;

// The B fragments of the Toeplitz matrices, B[k][c] = digit c - k of n'
// (`low`) or of p (`full`), a lane's two registers together.
struct TileTable {
  uint32_t low[kTileSteps][kLowTiles][32][2];
  uint32_t full[kTileSteps][kFullTiles][32][2];
};

constexpr int kWordPad = 24;      // zero words below a product's digit words: a_register's q >= -21
constexpr int kPaddedWords = kWordPad + 32;

// A warp's slice: `u` holds T's columns, then U's; `mc` the operands'
// limbs (a row: a's 12, then b's), then x * n''s columns, then the results'
// limbs (rows of 12); `x` the digit words of x, then of m, and before them
// (`words`, while the products' T = a * b run) the digit words of a
// product's a and b, word q at kWordPad + q and zero below, two products'
// apart.
struct TileSlice {
  int32_t u[kTileRows][kUStride];
  int32_t mc[kTileRows][kMStride];
  union {
    uint32_t x[kTileRows][kXStride];
    uint32_t words[2][2][kPaddedWords];
  };
};

// Register `reg` of `lane` at `step`, n8 tile `tile`, of the Toeplitz
// matrix of the constant whose digit words `src` gives.
template <class Src>
FP_MMA_HD uint32_t tile_b_register(const Src& src, int lane, int step, int tile, int reg) {
  return descending_register(src,
                             8 * tile + b_col(lane, 4 * reg) - 32 * step - b_row(lane, 4 * reg));
}

// Register `reg` of `lane` at `step` of the A tile whose rows are the
// products' digit words (row-major bytes, kXStride words a row).
FP_MMA_HD uint32_t row_a_register(const uint32_t* x, int lane, int step, int reg) {
  return x[a_row(lane, 4 * reg) * kXStride + 8 * step + (a_col(lane, 4 * reg) >> 2)];
}

// The carry pass of a product's row mod 2^384, on two lanes: half 0 takes
// chunks 0 .. 6, half 1 chunks 7 .. 13 (the last cut to 20 bits) from a
// carry in of 0, then adds half 0's carry out (below 2^16) and ripples it.
constexpr int kHalfChunks = kWordLanes / 2;

// A half's chunks of four columns, carried from 0; returns the carry out.
FP_MMA_HD uint32_t half_chunks(const int32_t* cols, int half, uint32_t* chunks) {
  uint64_t carry = 0;
  FP381_UNROLL
  for (int j = 0; j < kHalfChunks; ++j) {
    const uint64_t v = pack(cols + 4 * (kHalfChunks * half + j)) + carry;
    carry = v >> kChunkBits;
    chunks[j] = static_cast<uint32_t>(v & kChunkMask);
  }
  return static_cast<uint32_t>(carry);
}

// A half's digit words once `carry` (half 0's carry out for half 1, else
// 0) is in; half 1 also writes the zero words 14 and 15.
FP_MMA_HD void half_words(uint32_t* chunks, uint32_t carry, int half, uint32_t* words) {
  FP381_UNROLL
  for (int j = 0; j < kHalfChunks; ++j) {
    const uint32_t v = chunks[j] + carry;
    carry = v >> kChunkBits;
    words[kHalfChunks * half + j] = spread(low_chunk(v & kChunkMask, kHalfChunks * half + j));
  }
  if (half) words[kWordLanes] = words[kWordLanes + 1] = 0;
}

// One lane's last pass over its product's row of U = T + m * p (112
// columns): U / 2^384 as 12 limbs, then the conditional subtraction. U is 0
// mod 2^384, so every chunk below bit 364 carries to zero: chunk q's carry
// in is -pack_q mod 2^28 (below 2^16), and the carry into chunk 13 follows
// from chunk 12 alone. The pass starts there.
FP_MMA_HD fp381::Fp row_finish(const int32_t* cols) {
  uint32_t limbs[fp381::kLimbs];
  const uint64_t low = pack(cols + 4 * (kTopLane - 1));
  uint64_t carry = (low + ((0 - low) & kChunkMask)) >> kChunkBits, bits = 0;
  int held = 0, k = 0;
  FP381_UNROLL
  for (int q = kTopLane; q < kFullTiles * 8 / 4; ++q) {  // chunks 13 .. 27
    const uint64_t v = pack(cols + 4 * q) + carry;
    carry = v >> kChunkBits;
    const uint64_t chunk = v & kChunkMask;
    if (q == kTopLane) {  // bits 384 .. 391
      bits = chunk >> (384 - kChunkBits * kTopLane);
      held = kChunkBits * (kTopLane + 1) - 384;
    } else {
      bits |= chunk << held;
      held += kChunkBits;
      if (held >= 32 && k < fp381::kLimbs) {
        limbs[k++] = static_cast<uint32_t>(bits);
        bits >>= 32;
        held -= 32;
      }
    }
  }
  return fp381::reduce_once(limbs, 0);  // below 2p < 2^382
}

namespace host {

constexpr uint32_t kConstantWords[2][16] = {FP_MMA_CONSTANT_WORDS};  // p, n'

// A row's carry pass on its two lanes, half 0's carry handed to half 1.
inline void row_low_digits(const int32_t* cols, uint32_t* words) {
  uint32_t chunks[2][kHalfChunks];
  const uint32_t carry = half_chunks(cols, 0, chunks[0]);
  half_chunks(cols, 1, chunks[1]);
  half_words(chunks[0], 0, 0, words);
  half_words(chunks[1], carry, 1, words);
}

inline void tile_table(TileTable& t) {
  for (int lane = 0; lane < 32; ++lane) {
    for (int step = 0; step < kTileSteps; ++step) {
      for (int reg = 0; reg < 2; ++reg) {
        for (int tile = 0; tile < kLowTiles; ++tile) {
          t.low[step][tile][lane][reg] =
              tile_b_register(Words{kConstantWords[1], 16}, lane, step, tile, reg);
        }
        for (int tile = 0; tile < kFullTiles; ++tile) {
          t.full[step][tile][lane][reg] =
              tile_b_register(Words{kConstantWords[0], 16}, lane, step, tile, reg);
        }
      }
    }
  }
}

// The tile GEMM `tiles` n8 tiles wide: A from the rows of `x`, B from
// `table`, C from and D to `cols` (rows of `stride` words; C zero when
// `accumulate` is false).
template <int Tiles>
inline void tile_gemm(const uint32_t* x, const uint32_t (*table)[Tiles][32][2], int32_t* cols,
                      int stride, bool accumulate) {
  for (int tile = 0; tile < Tiles; ++tile) {
    int32_t acc[32][4];
    for (int lane = 0; lane < 32; ++lane) {
      for (int i = 0; i < 4; ++i) {
        acc[lane][i] = accumulate ? cols[c_row(lane, i) * stride + 8 * tile + c_col(lane, i)] : 0;
      }
    }
    for (int step = 0; step < kTileSteps; ++step) {
      uint32_t ra[32][4], rb[32][2];
      for (int lane = 0; lane < 32; ++lane) {
        for (int reg = 0; reg < 4; ++reg) ra[lane][reg] = row_a_register(x, lane, step, reg);
        for (int reg = 0; reg < 2; ++reg) rb[lane][reg] = table[step][tile][lane][reg];
      }
      mma(ra, rb, acc);
    }
    for (int lane = 0; lane < 32; ++lane) {
      for (int i = 0; i < 4; ++i) {
        cols[c_row(lane, i) * stride + 8 * tile + c_col(lane, i)] = acc[lane][i];
      }
    }
  }
}

}  // namespace host

// The host emulation of B8: n products of (n, 12) limbs, 16 a tile, step for
// step as mont_mxu.cu's warp runs a tile (a partial last tile's missing rows
// are zero operands and are not stored).
inline void mont_tile_emulated(const uint32_t* a, const uint32_t* b, int64_t n, uint32_t* out) {
  static TileTable table;
  static TileSlice s;
  host::tile_table(table);
  for (int64_t base = 0; base < n; base += kTileRows) {
    for (int i = 0; i < kTileRows; ++i) {
      for (int w = 0; w < fp381::kLimbs; ++w) {
        const bool live = base + i < n;
        s.mc[i][w] = static_cast<int32_t>(live ? a[(base + i) * fp381::kLimbs + w] : 0u);
        s.mc[i][fp381::kLimbs + w] =
            static_cast<int32_t>(live ? b[(base + i) * fp381::kLimbs + w] : 0u);
      }
    }
    for (int i = 0; i < kTileRows; ++i) {  // T = a * b, a product at a time
      const uint32_t* limbs = reinterpret_cast<const uint32_t*>(s.mc[i]);
      uint32_t wa[32], wb[32];
      for (int lane = 0; lane < 32; ++lane) {
        wa[lane] = digit_word(limbs, lane);
        wb[lane] = digit_word(limbs + fp381::kLimbs, lane);
      }
      int32_t d[32][4] = {};
      host::toeplitz_steps(wa, wb, kSteps, 0, d);
      for (int lane = 0; lane < kFullTiles * 2; ++lane) {
        for (int c = 0; c < 4; ++c) s.u[i][4 * lane + c] = d[lane][c];
      }
    }
    for (int i = 0; i < kTileRows; ++i) host::row_low_digits(s.u[i], s.x[i]);  // x
    host::tile_gemm<kLowTiles>(&s.x[0][0], table.low, &s.mc[0][0], kMStride, false);
    for (int i = 0; i < kTileRows; ++i) host::row_low_digits(s.mc[i], s.x[i]);  // m
    host::tile_gemm<kFullTiles>(&s.x[0][0], table.full, &s.u[0][0], kUStride, true);
    for (int i = 0; i < kTileRows && base + i < n; ++i) {
      const fp381::Fp r = row_finish(s.u[i]);
      for (int w = 0; w < fp381::kLimbs; ++w) out[(base + i) * fp381::kLimbs + w] = r.v[w];
    }
  }
}

}  // namespace fp_mma
