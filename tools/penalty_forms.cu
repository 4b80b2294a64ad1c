// Measured grids of the inactivity-penalties kernel (csrc/altair_sweeps.cu),
// for tools/step_penalty_forms.py: the program's kernel on other grids, and
// its copy with the chunks dealt round the blocks first (warp w of block b
// of G starting at chunk w G + b, so that 1,024 chunks at 2^18 reach every
// block; the order of this kernel's first design). These are measurements,
// not part of the program.
//
//   blocks_per_sm > 0  that many blocks an SM, no more than a validator a
//                      thread (the program: a chunk a warp, 2,048
//                      validators a block, altair_core::chunk_grid);
//   round_robin        the chunks dealt round the blocks first.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I ethereum_consensus_tpu_torch/csrc \
//        -o libpenalty_forms.so tools/penalty_forms.cu

#include "altair_sweeps.cu"

namespace {

// The current device's SMs (cached a device), 0 where the runtime cannot
// say.
int64_t device_sms() {
  static int cached[64];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (cached[device] == 0 &&
      cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    cached[device] = 0;
  }
  return cached[device];
}

// The program's kernel with the chunks dealt round the blocks first.
__global__ void __launch_bounds__(kThreads)
    round_robin_penalties_kernel(altair_core::PenaltyColumns c,
                                 udiv64_core::UDiv64 by_denominator) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = static_cast<int64_t>(threadIdx.x >> 5) * gridDim.x + blockIdx.x; k < c.chunks;
       k += warps) {
    ulonglong2 eff[kChunkSteps], score[kChunkSteps];
    unsigned flags[kChunkSteps];
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = altair_core::chunk_index(k, j, lane);
      eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.eff + i));
      score[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.scores + i));
      flags[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.not_target + i));
    }
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = altair_core::chunk_index(k, j, lane);
      *reinterpret_cast<ulonglong2*>(c.out + i) = make_ulonglong2(
          altair_core::inactivity_penalty(eff[j].x, score[j].x, flags[j] & 0xffu,
                                          by_denominator),
          altair_core::inactivity_penalty(eff[j].y, score[j].y, flags[j] >> 8, by_denominator));
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = altair_core::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    c.out[i] = altair_core::inactivity_penalty(c.eff[i], c.scores[i], c.not_target[i] != 0,
                                               by_denominator);
  }
}

}  // namespace

// The program's kernel (or, with round_robin, its copy that deals the
// chunks round the blocks) on the grid of `blocks_per_sm`; returns the
// launch's error.
extern "C" int penalty_form_launch(int blocks_per_sm, int round_robin, const void* eff,
                                   const void* scores,
                                   const void* not_target, int64_t n, uint64_t denominator,
                                   void* out, void* stream) {
  if (n < 0 || denominator == 0 || blocks_per_sm <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int64_t sms = device_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t grid = (n + kThreads - 1) / kThreads;
  if (grid > sms * blocks_per_sm) grid = sms * blocks_per_sm;
  const auto kernel = round_robin ? round_robin_penalties_kernel : inactivity_penalties_kernel;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      altair_core::penalty_columns(eff, scores, not_target, n, out),
      udiv64_core::prepare(denominator));
  return static_cast<int>(cudaGetLastError());
}
