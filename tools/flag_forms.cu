// The flag deltas' measured alternative (tools/merkle_flag_forms.py), over
// the device functions of csrc/altair_sweeps.cu: two launches, the partial
// sums with the penalties and then the rewards (each block adding the
// partials, every column read again), in place of one cooperative launch
// with a grid sync. Not part of the program.

#include "altair_sweeps.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
    flag_sums_kernel(FlagColumns c, altair_core::FlagSweep s, uint64_t weight, int is_head,
                     uint64_t* __restrict__ partials) {
  __shared__ uint64_t warp_sums[kWarps];
  Kept kept;
  sums_and_penalties(c, s, weight, is_head != 0, partials, warp_sums, kept);
}

__global__ void __launch_bounds__(kThreads)
    flag_rewards_kernel(FlagColumns c, altair_core::FlagSweep s, uint64_t weight, int leaking,
                        const uint64_t* __restrict__ partials, int count) {
  __shared__ uint64_t warp_sums[kWarps];
  Kept none;
  none.valid = false;
  const uint64_t total = gathered_sum(partials, count, warp_sums);
  rewards_pass(c, s, udiv64_core::divide(total, s.increment), weight, leaking != 0, none);
}

int launch(const void* eff, const void* participating, const void* eligible, int64_t n,
           uint64_t total_active, uint64_t weight, uint64_t increment,
           uint64_t base_reward_factor, uint64_t weight_denominator, int leaking, int is_head,
           void* sum_scratch, int64_t scratch_words, void* rewards, void* penalties,
           void* stream, bool sums, bool apply) {
  if (n <= 0 || increment == 0 || weight_denominator == 0 || total_active == 0 ||
      (total_active / increment) * weight_denominator == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FlagColumns c = flag_columns(eff, participating, eligible, n, rewards, penalties);
  const altair_core::FlagSweep sweep =
      altair_core::flag_sweep(total_active, increment, base_reward_factor, weight_denominator);
  const int64_t grid = (n + 8 * kThreads - 1) / (8 * kThreads);
  const int64_t parts = grid < scratch_words ? grid : scratch_words;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* partials = static_cast<uint64_t*>(sum_scratch);
  if (sums) {
    flag_sums_kernel<<<static_cast<unsigned>(parts), kThreads, 0, s>>>(c, sweep, weight, is_head,
                                                                        partials);
  }
  if (apply) {
    flag_rewards_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        c, sweep, weight, leaking, partials, static_cast<int>(parts));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flag_deltas_launch's arguments: both launches, the first alone, the second
// alone (on the partials the first left).
extern "C" int flag_deltas_two_launch(const void* eff, const void* participating,
                                      const void* eligible, int64_t n, uint64_t total_active,
                                      uint64_t weight, uint64_t increment,
                                      uint64_t base_reward_factor, uint64_t weight_denominator,
                                      int leaking, int is_head, void* sum_scratch,
                                      int64_t scratch_words, void* rewards, void* penalties,
                                      void* stream) {
  return launch(eff, participating, eligible, n, total_active, weight, increment,
                base_reward_factor, weight_denominator, leaking, is_head, sum_scratch,
                scratch_words, rewards, penalties, stream, true, true);
}

extern "C" int flag_sums_launch(const void* eff, const void* participating, const void* eligible,
                                int64_t n, uint64_t total_active, uint64_t weight,
                                uint64_t increment, uint64_t base_reward_factor,
                                uint64_t weight_denominator, int leaking, int is_head,
                                void* sum_scratch, int64_t scratch_words, void* rewards,
                                void* penalties, void* stream) {
  return launch(eff, participating, eligible, n, total_active, weight, increment,
                base_reward_factor, weight_denominator, leaking, is_head, sum_scratch,
                scratch_words, rewards, penalties, stream, true, false);
}

extern "C" int flag_apply_launch(const void* eff, const void* participating, const void* eligible,
                                 int64_t n, uint64_t total_active, uint64_t weight,
                                 uint64_t increment, uint64_t base_reward_factor,
                                 uint64_t weight_denominator, int leaking, int is_head,
                                 void* sum_scratch, int64_t scratch_words, void* rewards,
                                 void* penalties, void* stream) {
  return launch(eff, participating, eligible, n, total_active, weight, increment,
                base_reward_factor, weight_denominator, leaking, is_head, sum_scratch,
                scratch_words, rewards, penalties, stream, false, true);
}
