// The whole-list form of the swap-or-not shuffle, for a measured comparison
// with B4 (ethereum_consensus_tpu_torch/csrc/shuffle.cu); not part of the
// program. Round r maps position j of a list to position flip(j) when the
// bit at max(j, flip(j)) of its row is set; applied to positions in reverse
// round order, from the identity, it gives out[i] =
// compute_shuffled_index(i) directly: one coalesced pass over an int32
// list a round (90 launches), no scatter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void whole_list_round(const int64_t* __restrict__ pivots, int r,
                                 const uint8_t* __restrict__ row, int64_t count,
                                 const int32_t* __restrict__ in, int32_t* __restrict__ out32,
                                 int64_t* __restrict__ out64) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (j >= count) return;
  const uint32_t n = static_cast<uint32_t>(count), jj = static_cast<uint32_t>(j);
  uint32_t flip = static_cast<uint32_t>(__ldg(pivots + r)) + n - jj;
  if (flip >= n) flip -= n;
  const uint32_t pos = jj > flip ? jj : flip;
  const uint32_t src = ((__ldg(row + (pos >> 3)) >> (pos & 7)) & 1) ? flip : jj;
  const int32_t val = in ? in[src] : static_cast<int32_t>(src);
  if (out64) {
    out64[j] = val;
  } else {
    out32[j] = val;
  }
}

}  // namespace

// pivots (rounds,) int64, sources (rounds, row_bytes) uint8, scratch
// (2 count,) int32, out (count,) int64 on the current device; count below
// 2^31, rounds at least 1. Returns the CUDA error (0 = launched).
extern "C" int whole_list_launch(const void* pivots, const void* sources, int64_t row_bytes,
                                 int rounds, int64_t count, void* scratch, void* out,
                                 void* stream) {
  if (count <= 0 || rounds < 1 || count >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* lists[2] = {static_cast<int32_t*>(scratch), static_cast<int32_t*>(scratch) + count};
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  const int32_t* in = nullptr;
  for (int r = rounds - 1, i = 0; r >= 0; --r, ++i) {
    int32_t* o32 = r == 0 ? nullptr : lists[i & 1];
    whole_list_round<<<blocks, 256, 0, st>>>(
        static_cast<const int64_t*>(pivots), r,
        static_cast<const uint8_t*>(sources) + r * row_bytes, count, in, o32,
        r == 0 ? static_cast<int64_t*>(out) : nullptr);
    in = o32;
  }
  return static_cast<int>(cudaGetLastError());
}
