// The design of csrc/fp_mma.h before its reduction became products: the
// byte-round reduction that every thread of the warp repeats. Kept as a
// measured form (tools/mxu_forms.py builds the mxu libraries and B8 on it
// beside the program's); not part of the program.
//
// The Montgomery product of BLS12-381's base field on the int8 tensor cores:
// one warp computes one product a * b * 2^-384 mod p with three
// mma.sync.m16n8k32 steps (s8 x s8 -> s32), then a byte-granular
// Montgomery reduction. The "mxu" multiplier of the pairing tower: built
// with -DFP381_MUL_MXU, fp381::mul (fp381_core.h) and with it every product
// of fp_tower.h run here.
//
// Replaces the reference's (ethereum_consensus_tpu) ops/fq8.py:300 mont7r,
// with :265 _to7r, :280 product_cols7r and :102 _reduce8, selected there by
// ops/fql.py:117 set_multiplier("mxu") at :140. Like mont7r it splits each
// operand into 58 seven-bit digits (signed int8: at most 127), forms the 115
// digit columns of the schoolbook product as an integer matrix product
// (58 terms of at most 127^2: below 2^20, exact in int32), regroups them to
// byte weight and reduces byte by byte; R = 2^384 takes 48 byte rounds
// where the reference's R' = 2^416 takes 52. The output is canonical, equal
// bit for bit to the CIOS product of fp381_core.h.
//
// Mapping: one warp per product, the operands replicated in every thread
// (each thread of a warp-per-lane kernel holds the lane's whole values, so
// control flow is uniform across the warp, as mma.sync.aligned requires).
// The 16 x 8 accumulator holds column r + 16n at row r, column n (128 >= 115
// columns). The A tile is Toeplitz, A[r][j'] = a7[r - j'], the B tile
// B[j'][n] = b7[j' + 16n], with j' over [-57, 15] (73 values, padded to
// K = 96: three k32 steps); out-of-range digits are 0, so the sum over j' is
// sum_j a7[r + 16n - j] b7[j], column r + 16n. Lane 0 puts the operands'
// limbs in the warp's slice of shared memory, each thread reads the digits
// of its own fragment bytes from them, and after the three steps each
// thread writes its four accumulators back to the slice (512 bytes) and
// reads all 115 columns: every thread then runs the same reduction on the
// same columns.
//
// What bounds it on an H100: not the tensor cores. Three m16n8k32 steps
// are 48K multiply-adds a product at 1,979 T op/s; the 48 byte rounds of
// the reduction are 2,304 32-bit multiply-adds on the CUDA cores, which
// every thread of the warp repeats, and a batch of products must also read
// its operands and write its results (144 bytes a product at 3.35 TB/s).
// The design answers correctness first: mma.sync (a warp's tile, registers
// in and out) rather than wgmma (a warpgroup's 64-row tile from shared
// memory), and the reduction on the CUDA cores. No operand is shared across
// lanes, as in the reference's batched matvec: the modulus p and
// n' = -p^-1 are the only operands common to every product, and sending
// m * p through a real GEMM that shares them is later work.
//
// Outside nvcc (and in nvcc's host pass) the product is a host emulation:
// 32 simulated lanes build their fragments with the same maps, the
// m16n8k32 product is taken over the matrices those fragments hold
// (scattered by the PTX ISA's layout tables for .s8), and each lane's
// accumulators go back by the same tables. A g++ test holds it against the
// CIOS product before the card sees it.

#pragma once

#include <stdint.h>

#include "fp381_core.h"

#ifdef __CUDACC__
#define FP_MMA_HD __host__ __device__ __forceinline__
#else
#define FP_MMA_HD inline
#endif

namespace fp_mma {

constexpr int kDigits = 58;       // 7-bit digits of an operand (the reference's L7R)
constexpr int kColumns = 115;     // digit columns of the product
constexpr int kAccColumns = 128;  // the 16 x 8 accumulator
constexpr int kSteps = 3;         // k32 steps: K = 96 >= the 73 shifts
constexpr int kShift = 57;        // j' = k - 57
constexpr int kWords = 14;        // 12 limbs and two zero words (digit 57 reads word 13)
constexpr int kByteColumns = 100;
constexpr int kRounds = 48;       // R = 2^384 = 2^(8 * 48)
constexpr uint32_t kN0Byte = 253;  // -p^-1 mod 2^8
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

// --- the Toeplitz and Hankel maps -------------------------------------------
// k = 32 step + the tile's column (A) or row (B) runs over j' = k - 57
FP_MMA_HD int a_digit(int step, int row, int col) { return row + kShift - (32 * step + col); }
FP_MMA_HD int b_digit(int step, int row, int col) { return 32 * step + row - kShift + 16 * col; }
FP_MMA_HD int d_column(int row, int col) { return row + 16 * col; }

// Digit d (bits 7d .. 7d + 6) of the value in w[0 .. kWords), 0 outside
// [0, kDigits).
FP_MMA_HD uint32_t digit7(const uint32_t* w, int d) {
  if (d < 0 || d >= kDigits) return 0;
  const int bit = 7 * d;
  const uint64_t pair = static_cast<uint64_t>(w[bit >> 5]) |
                        (static_cast<uint64_t>(w[(bit >> 5) + 1]) << 32);
  return static_cast<uint32_t>(pair >> (bit & 31)) & 0x7fu;
}

// Fragment register `reg` of `lane` at `step`: four digits, one a byte.
FP_MMA_HD uint32_t a_register(const uint32_t* w, int lane, int step, int reg) {
  uint32_t r = 0;
  FP381_UNROLL
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * reg + e;
    r |= digit7(w, a_digit(step, a_row(lane, i), a_col(lane, i))) << (8 * e);
  }
  return r;
}

FP_MMA_HD uint32_t b_register(const uint32_t* w, int lane, int step, int reg) {
  uint32_t r = 0;
  FP381_UNROLL
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * reg + e;
    r |= digit7(w, b_digit(step, b_row(lane, i), b_col(lane, i))) << (8 * e);
  }
  return r;
}

// The 115 digit columns (weight 2^(7i), each below 2^20) of T = a * b ->
// T * 2^-384 mod p, canonical. Column i goes to byte (7i) / 8 shifted by
// (7i) % 8 (a byte column takes at most two: below 2^28). Round i picks
// m = t_i n' mod 2^8, which clears byte i of T + m p 2^(8i), and carries
// t_i >> 8 up; a round adds below 2^16 to a column, so every column stays
// below 2^29. After 48 rounds columns 48 .. 99 hold (T + M p) / 2^384 < 2p:
// one carry pass to 32-bit limbs and one conditional subtraction.
FP_MMA_HD fp381::Fp reduce_columns(const int32_t* cols) {
  const uint32_t p[fp381::kLimbs] = {FP381_P_LIMBS};
  uint32_t t[kByteColumns];
  FP381_UNROLL
  for (int i = 0; i < kByteColumns; ++i) t[i] = 0;
  FP381_UNROLL
  for (int i = 0; i < kColumns; ++i) t[(7 * i) >> 3] += static_cast<uint32_t>(cols[i]) << ((7 * i) & 7);
  FP381_UNROLL
  for (int i = 0; i < kRounds; ++i) {
    const uint32_t m = (t[i] * kN0Byte) & 0xffu;
    FP381_UNROLL
    for (int j = 0; j < 48; ++j) t[i + j] += m * ((p[j >> 2] >> (8 * (j & 3))) & 0xffu);
    t[i + 1] += t[i] >> 8;
  }
  uint32_t limbs[fp381::kLimbs];
  uint32_t carry = 0;
  FP381_UNROLL
  for (int k = 0; k < fp381::kLimbs; ++k) {
    uint32_t word = 0;
    FP381_UNROLL
    for (int e = 0; e < 4; ++e) {
      const uint32_t v = t[kRounds + 4 * k + e] + carry;
      word |= (v & 0xffu) << (8 * e);
      carry = v >> 8;
    }
    limbs[k] = word;
  }
  uint32_t top = 0;  // bytes 96 .. 99: zero, since the value is below 2p < 2^382
  FP381_UNROLL
  for (int e = 0; e < 4; ++e) {
    const uint32_t v = t[kRounds + 48 + e] + carry;
    top |= (v & 0xffu) << (8 * e);
    carry = v >> 8;
  }
  return fp381::reduce_once(limbs, top);
}

#ifdef __CUDACC__
// Each warp's slice: the operands' limbs, then the accumulator columns.
struct Scratch {
  uint32_t w[2][kWords];
  int32_t acc[kAccColumns];
};
__shared__ Scratch g_scratch[kMaxWarps];

#ifdef __CUDA_ARCH__
__device__ __forceinline__ void mma_m16n8k32(int32_t* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif
#endif

// The host emulation of one warp's product: the same fragments, the
// m16n8k32 product over the matrices they hold, the same accumulators.
inline fp381::Fp mont_emulated(const fp381::Fp& a, const fp381::Fp& b) {
  uint32_t w[2][kWords] = {};
  for (int i = 0; i < fp381::kLimbs; ++i) {
    w[0][i] = a.v[i];
    w[1][i] = b.v[i];
  }
  int32_t acc[32][4] = {};
  for (int step = 0; step < kSteps; ++step) {
    int32_t ta[16][32] = {}, tb[32][8] = {};
    for (int lane = 0; lane < 32; ++lane) {
      for (int i = 0; i < 16; ++i) {
        const uint32_t reg = a_register(w[0], lane, step, i >> 2);
        ta[a_row(lane, i)][a_col(lane, i)] = static_cast<int8_t>(reg >> (8 * (i & 3)));
      }
      for (int i = 0; i < 8; ++i) {
        const uint32_t reg = b_register(w[1], lane, step, i >> 2);
        tb[b_row(lane, i)][b_col(lane, i)] = static_cast<int8_t>(reg >> (8 * (i & 3)));
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
  int32_t cols[kAccColumns];
  for (int lane = 0; lane < 32; ++lane) {
    for (int i = 0; i < 4; ++i) cols[d_column(c_row(lane, i), c_col(lane, i))] = acc[lane][i];
  }
  return reduce_columns(cols);
}

// a * b * 2^-384 mod p, canonical. On the card every thread of the warp
// calls it with the same operands (a warp-per-lane kernel) and gets the
// product; elsewhere it is the host emulation.
FP381_MUL_CALL fp381::Fp mont(fp381::Fp a, fp381::Fp b) {
#ifdef __CUDA_ARCH__
  const int lane = threadIdx.x & 31;
  Scratch& s = g_scratch[threadIdx.x >> 5];
  __syncwarp();  // the warp's reads of the previous product's slice are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < fp381::kLimbs; ++i) {
      s.w[0][i] = a.v[i];
      s.w[1][i] = b.v[i];
    }
#pragma unroll
    for (int i = fp381::kLimbs; i < kWords; ++i) s.w[0][i] = s.w[1][i] = 0;
  }
  __syncwarp();
  int32_t d[4] = {0, 0, 0, 0};
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    uint32_t ra[4], rb[2];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) ra[reg] = a_register(s.w[0], lane, step, reg);
#pragma unroll
    for (int reg = 0; reg < 2; ++reg) rb[reg] = b_register(s.w[1], lane, step, reg);
    __syncwarp();  // mma.sync.aligned: the whole warp, converged
    mma_m16n8k32(d, ra, rb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s.acc[d_column(c_row(lane, i), c_col(lane, i))] = d[i];
  __syncwarp();
  return reduce_columns(s.acc);
#else
  return mont_emulated(a, b);
#endif
}

}  // namespace fp_mma
