// B8 alone: the batched Montgomery product of n independent operand pairs
// on the int8 tensor cores, for Hopper (sm_90a). The counterpart of calling
// the reference's ethereum_consensus_tpu/ops/fq8.py:300 mont7r on a batch,
// as its tests do (tests/test_ops_pairing.py:233-305); its arithmetic is
// fp_mma.h's (the digits, the Toeplitz steps, the reduction as products),
// the same that the mxu builds of pairing.cu and g1_sum.cu call for every
// Fp product, here on a tile of 16 products a warp.
//
// In and out: (n, 12) uint32 limbs, least significant first, Montgomery
// form with R = 2^384, canonical (below p); out = a * b * 2^-384 mod p.
//
// Design: a persistent grid, two blocks of 8 warps an SM, each warp taking
// tiles of 16 products in turn (the last tile may be partial: its missing
// rows are zero operands and are not stored). A tile's operands arrive as 16-byte
// loads spread over the lanes (1,536 bytes: three a lane), its results
// leave the same way. Each product's T = a * b runs on the warp's three
// Toeplitz steps; the two reductions are GEMMs over the whole tile with the
// products as the rows of A: x (16 x 64 digits) times Toeplitz(n') (64 x
// 56) and m times Toeplitz(p) (64 x 112), added to T's columns. The B
// fragments of both Toeplitz matrices are built once a block into shared
// memory. Two lanes a product run its carry passes for x and m (a half of
// the row each, the upper half taking the lower's carry), and one lane the
// last one (from bit 336, since U's low bits are zero) with the
// conditional subtraction.
//
// What bounds it on an H100: the least work is 144 bytes a product (two
// operands read, one result written) at 3.35 TB/s, 0.045 ms at 2^20
// products, above the 288 multiply-adds of one CIOS product at the card's
// integer rate. Measured on an H100, this kernel is bound instead by moving
// each product's a * b fragments through shared memory: 18 registers a lane
// in 30 loads from the product's zero-padded digit words (so no register
// tests its word's index, as the warp's product in fp_mma.h must), and the
// product's columns out, about 40 wavefronts a product. Timed alone over
// the same tiles, the products with the loads and stores take about 60% of
// the kernel's time, the reduction with them (the carry passes: x's and m's
// 14 chunks of four columns on two lanes, the last pass's 16 on one; 42 mma
// steps of the shared GEMMs) about 48%, the loads and stores alone 17%.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_mma.h"

namespace {

using fp_mma::kTileRows;
using fp_mma::kTileSteps;
using fp_mma::TileSlice;
using fp_mma::TileTable;

constexpr int kWarps = 8;  // two blocks an SM: 16 warps
constexpr int kVectors = kTileRows * fp381::kLimbs / 4;  // 16-byte vectors of a tile's operand

struct Shared {
  TileTable table;
  TileSlice slice[kWarps];
};

__device__ const uint32_t kConstantWords[2][16] = {FP_MMA_CONSTANT_WORDS};  // p, n'

// Word q of a product's digit words in the warp's slice, zero-padded: no
// test of q.
struct PaddedWords {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t operator()(int q) const { return w[fp_mma::kWordPad + q]; }
};

struct ConstantWords {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t operator()(int q) const {
    return q < 0 || q >= 16 ? 0u : __ldg(w + q);
  }
};

// The tile GEMM Tiles n8 tiles wide: A from the digit rows `x`, B from
// `table` (a TileTable's array), C from and D to `cols` (rows of Stride
// words; C zero unless Accumulate).
template <int Tiles, int Stride, bool Accumulate>
__device__ __forceinline__ void tile_gemm(const uint32_t* x, const uint32_t* table, int32_t* cols,
                                          int lane) {
  uint32_t ra[kTileSteps][4];
#pragma unroll
  for (int step = 0; step < kTileSteps; ++step) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) ra[step][reg] = fp_mma::row_a_register(x, lane, step, reg);
  }
#pragma unroll
  for (int tile = 0; tile < Tiles; ++tile) {
    // rows groupID and groupID + 8, columns 2 threadID_in_group (+1)
    int2* top = reinterpret_cast<int2*>(cols + fp_mma::c_row(lane, 0) * Stride + 8 * tile +
                                        fp_mma::c_col(lane, 0));
    int2* bottom = reinterpret_cast<int2*>(cols + fp_mma::c_row(lane, 2) * Stride + 8 * tile +
                                           fp_mma::c_col(lane, 2));
    int32_t d[4] = {0, 0, 0, 0};
    if (Accumulate) {
      const int2 t = *top, b = *bottom;
      d[0] = t.x;
      d[1] = t.y;
      d[2] = b.x;
      d[3] = b.y;
    }
#pragma unroll
    for (int step = 0; step < kTileSteps; ++step) {
      const uint2 rb =
          *reinterpret_cast<const uint2*>(table + 2 * (32 * (Tiles * step + tile) + lane));
      const uint32_t regs[2] = {rb.x, rb.y};
      fp_mma::mma_m16n8k32(d, ra[step], regs);
    }
    *top = make_int2(d[0], d[1]);
    *bottom = make_int2(d[2], d[3]);
  }
}

// The Toeplitz matrices' B fragments, once a block: n' for x * n', p for m * p.
__device__ __forceinline__ void build_table(TileTable& table) {
  constexpr int kEntries = kTileSteps * (fp_mma::kLowTiles + fp_mma::kFullTiles) * 32;
  for (int i = threadIdx.x; i < kEntries; i += blockDim.x) {
    const int lane = i & 31, step = (i >> 5) % kTileSteps, tile = (i >> 5) / kTileSteps;
    const bool low = tile < fp_mma::kLowTiles;
    const int t = low ? tile : tile - fp_mma::kLowTiles;
    const ConstantWords src{kConstantWords[low ? 1 : 0]};
    uint32_t* dst = low ? table.low[step][t][lane] : table.full[step][t][lane];
    dst[0] = fp_mma::tile_b_register(src, lane, step, t, 0);
    dst[1] = fp_mma::tile_b_register(src, lane, step, t, 1);
  }
}

// The tile's operands: a's vectors, then b's, into rows of the staging (a,
// then b); rows past n are zero.
__device__ __forceinline__ void load_tile(TileSlice& s, const uint4* __restrict__ a,
                                          const uint4* __restrict__ b, int64_t n, int64_t base,
                                          int lane) {
  for (int j = lane; j < 2 * kVectors; j += 32) {
    const int v = j % kVectors, row = v / 3, part = v % 3;
    const bool is_b = j >= kVectors;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (base + row < n) w = __ldg((is_b ? b : a) + (base + row) * 3 + part);
    *reinterpret_cast<uint4*>(&s.mc[row][(is_b ? fp381::kLimbs : 0) + 4 * part]) = w;
  }
  if (lane < fp_mma::kWordPad) {  // the zeros below the digit words
    s.words[0][0][lane] = s.words[0][1][lane] = s.words[1][0][lane] = s.words[1][1][lane] = 0;
  }
  __syncwarp();
}

// T = a * b of the tile's products, a product at a time on the warp's
// Toeplitz steps: row i of `u` gets product i's columns below 112.
__device__ __forceinline__ void tile_products(TileSlice& s, int lane) {
#pragma unroll 1
  for (int i = 0; i < kTileRows; ++i) {
    const uint32_t* limbs = reinterpret_cast<const uint32_t*>(s.mc[i]);
    uint32_t(*words)[fp_mma::kPaddedWords] = s.words[i & 1];
    words[0][fp_mma::kWordPad + lane] = fp_mma::digit_word(limbs, lane);
    words[1][fp_mma::kWordPad + lane] = fp_mma::digit_word(limbs + fp381::kLimbs, lane);
    __syncwarp();
    const PaddedWords wa{words[0]}, wb{words[1]};
    int32_t d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int step = 0; step < fp_mma::kSteps; ++step) {
      uint32_t ra[4], rb[2];
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) ra[reg] = fp_mma::a_register(wa, lane, step, reg);
#pragma unroll
      for (int reg = 0; reg < 2; ++reg) rb[reg] = fp_mma::b_register(wb, lane, step, reg);
      fp_mma::mma_m16n8k32(d, ra, rb);
    }
    if (lane < 2 * fp_mma::kFullTiles) {
      *reinterpret_cast<int4*>(&s.u[i][4 * lane]) = make_int4(d[0], d[1], d[2], d[3]);
    }
  }
  __syncwarp();
}

// A row's carry pass mod 2^384 on lanes r and r + 16 (fp_mma.h's halves):
// the digit words of x or m.
__device__ __forceinline__ void row_low_digits(const int32_t* cols, uint32_t* words,
                                               int lane) {
  const int half = lane / kTileRows;
  uint32_t chunks[fp_mma::kHalfChunks];
  const uint32_t carry = fp_mma::half_chunks(cols, half, chunks);
  const uint32_t from_low = __shfl_up_sync(0xffffffffu, carry, kTileRows);
  fp_mma::half_words(chunks, half ? from_low : 0u, half, words);
}

// The reduction of the tile's T: x (two lanes a row), x * n' over the tile,
// m (two lanes a row), T + m * p over the tile, and the last pass with the
// conditional subtraction (a lane a row): the results' limbs in rows of mc.
__device__ __forceinline__ void tile_reduce(TileSlice& s, const TileTable& table, int lane) {
  row_low_digits(s.u[lane % kTileRows], s.x[lane % kTileRows], lane);  // x
  __syncwarp();
  tile_gemm<fp_mma::kLowTiles, fp_mma::kMStride, false>(&s.x[0][0], &table.low[0][0][0][0],
                                                         &s.mc[0][0], lane);
  __syncwarp();
  row_low_digits(s.mc[lane % kTileRows], s.x[lane % kTileRows], lane);  // m
  __syncwarp();
  tile_gemm<fp_mma::kFullTiles, fp_mma::kUStride, true>(&s.x[0][0], &table.full[0][0][0][0],
                                                        &s.u[0][0], lane);
  __syncwarp();
  if (lane < kTileRows) {
    const fp381::Fp r = fp_mma::row_finish(s.u[lane]);
#pragma unroll
    for (int k = 0; k < fp381::kLimbs; k += 4) {
      *reinterpret_cast<uint4*>(&s.mc[lane][k]) =
          make_uint4(r.v[k], r.v[k + 1], r.v[k + 2], r.v[k + 3]);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store_tile(const TileSlice& s, uint4* __restrict__ out, int64_t n,
                                           int64_t base, int lane) {
  for (int j = lane; j < kVectors; j += 32) {
    const int row = j / 3, part = j % 3;
    if (base + row < n) {
      out[(base + row) * 3 + part] = *reinterpret_cast<const uint4*>(&s.mc[row][4 * part]);
    }
  }
  __syncwarp();  // the slice is read before the next tile's operands land
}

__global__ void __launch_bounds__(32 * kWarps, 2)
    mont_mxu_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, int64_t n,
                    uint4* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  build_table(sh.table);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  TileSlice& s = sh.slice[threadIdx.x >> 5];
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); tile < tiles;
       tile += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t base = tile * kTileRows;
    load_tile(s, a, b, n, base, lane);
    tile_products(s, lane);
    tile_reduce(s, sh.table, lane);
    store_tile(s, out, n, base, lane);
  }
}

// The persistent grid: as many blocks as the card holds at once, or fewer
// when the tiles run out.
template <class Kernel>
int64_t grid_blocks(Kernel kernel, int64_t n) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(sizeof(Shared)));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, sizeof(Shared));
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t wanted = (tiles + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return wanted < resident ? wanted : resident;
}

}  // namespace

// a, b, out: (n, 12) uint32, contiguous and 16-byte aligned on the current
// device; launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mont_mxu_launch(const void* a, const void* b, int64_t n, void* out,
                               void* stream) {
  if (n <= 0 || n > (int64_t{1} << 32)) return static_cast<int>(cudaErrorInvalidValue);
  mont_mxu_kernel<<<static_cast<unsigned>(grid_blocks(mont_mxu_kernel, n)), 32 * kWarps,
                    sizeof(Shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), n, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
