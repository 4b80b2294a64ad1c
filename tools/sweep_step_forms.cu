// Measured forms of the inactivity-updates kernel (csrc/altair_sweeps.cu)
// and of B5-hysteresis (csrc/sweeps.cu), for tools/sweep_forms.py: the
// programs' lanes on warp chunks of 1, 2, 4 and 8 steps (64 validators a
// step, a chunk a warp), for the updates the leak state a template argument
// or a kernel argument, the update lane as selects, and probes that store
// the words as read (not checked; the compiler may drop the loads whose words
// go unused). These are measurements, not part of the program.
//
// The updates (update_form_launch); "program" is the program's kernel,
// inactivity_updates_kernel<steps>, whatever steps its launcher would take:
//
//   form  steps  leak      lane
//      1      4  template  the update
//      2      2  argument  the update (program)
//      3      1  argument  the update (program)
//      4      2  template  the update
//      5      4  argument  none: the scores stored as read (probe)
//      6      8  argument  the update (program)
//      7      4  argument  the update as selects (update_select)
//      8      2  argument  the update as selects
//      9      1  argument  the update as selects
//     10      4  argument  the update (program)
//
// B5-hysteresis (hysteresis_form_launch): `steps` 1, 2, 4 or 8 on the
// program's lane; 0, four steps storing the effective balances as read
// (probe).

#include "altair_sweeps.cu"
#include "sweeps_core.h"

namespace {

// altair_core::inactivity_update written as selects only: both moves made,
// then picked, with no early return. Put in place of the header's lane it
// gave B3's update apply entry a 16-byte frame and spill (64 registers).
__device__ __forceinline__ uint64_t update_select(uint64_t score, bool participating, bool eligible,
                                                  uint64_t bias, uint64_t recovery_rate,
                                                  bool leaking) {
  const uint64_t moved = participating ? score - (score != 0) : score + bias;
  const uint64_t recovered = moved - altair_core::umin(recovery_rate, moved);
  const uint64_t out = leaking ? moved : recovered;
  return eligible ? out : score;
}

// kLeak: -1 the leak state from the argument, 0 or 1 fixed; kUpdate false
// stores the scores as read; kSelect the lane as update_select.
template <int kSteps, int kLeak, bool kUpdate, bool kSelect = false>
__global__ void __launch_bounds__(kThreads)
    update_form_kernel(altair_core::UpdateColumns c, uint64_t bias, uint64_t recovery_rate,
                       bool leaking_arg) {
  constexpr int64_t kSpan = 64 * kSteps;
  const bool leaking = kLeak < 0 ? leaking_arg : kLeak == 1;
  const auto update = [&](uint64_t score, unsigned part, unsigned elig) {
    if (!kUpdate) return score;
    return kSelect ? update_select(score, part, elig, bias, recovery_rate, leaking)
                   : altair_core::inactivity_update(score, part, elig, bias, recovery_rate, leaking);
  };
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    ulonglong2 score[kSteps];
    unsigned part[kSteps], elig[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = k * kSpan + 64 * j + 2 * lane;
      score[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.scores + i));
      part[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.participating + i));
      elig[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.eligible + i));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = k * kSpan + 64 * j + 2 * lane;
      *reinterpret_cast<ulonglong2*>(c.out + i) =
          make_ulonglong2(update(score[j].x, part[j] & 0xffu, elig[j] & 0xffu),
                          update(score[j].y, part[j] >> 8, elig[j] >> 8));
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = c.chunks * kSpan + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < c.n; i += threads) {
    c.out[i] = update(c.scores[i], c.participating[i], c.eligible[i]);
  }
}

template <int kSteps, int kLeak, bool kUpdate, bool kSelect = false>
int launch(const void* scores, const void* participating, const void* eligible, int64_t n,
           uint64_t bias, uint64_t recovery_rate, bool leaking, void* out, cudaStream_t stream) {
  update_form_kernel<kSteps, kLeak, kUpdate, kSelect>
      <<<static_cast<unsigned>(altair_core::chunk_grid<kSteps>(n)), kThreads, 0, stream>>>(
          altair_core::update_columns<kSteps>(scores, participating, eligible, n, out), bias,
          recovery_rate, leaking);
  return static_cast<int>(cudaGetLastError());
}

// B5-hysteresis on chunks of kSteps steps; kUpdate false stores the
// effective balances as read.
template <int kSteps, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
    hysteresis_form_kernel(sweeps_core::BalanceColumns c, sweeps_core::Hysteresis h) {
  constexpr int64_t kSpan = 64 * kSteps;
  const auto update = [&](uint64_t balance, uint64_t effective) {
    return kUpdate ? sweeps_core::effective_balance_update(balance, effective, h) : effective;
  };
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    ulonglong2 bal[kSteps], eff[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = k * kSpan + 64 * j + 2 * lane;
      bal[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.balances + i));
      eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.effective + i));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = k * kSpan + 64 * j + 2 * lane;
      *reinterpret_cast<ulonglong2*>(c.out + i) =
          make_ulonglong2(update(bal[j].x, eff[j].x), update(bal[j].y, eff[j].y));
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = c.chunks * kSpan + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < c.n; i += threads) {
    c.out[i] = update(c.balances[i], c.effective[i]);
  }
}

template <int kSteps, bool kUpdate>
int launch_hysteresis(sweeps_core::BalanceColumns c, const sweeps_core::Hysteresis& h,
                      cudaStream_t stream) {
  constexpr int64_t kSpan = 64 * kSteps;
  const bool vector = altair_core::aligned(c.balances, 16) &&
                      altair_core::aligned(c.effective, 16) && altair_core::aligned(c.out, 16);
  c.chunks = vector ? c.n / kSpan : 0;
  const int64_t per_block = int64_t{kWarps} * kSpan;
  const int64_t grid = c.n > per_block ? (c.n + per_block - 1) / per_block : 1;
  hysteresis_form_kernel<kSteps, kUpdate><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(c, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B5-hysteresis on chunks of `steps` steps (0: the probe), the program's
// launcher's arguments; returns the launch's error.
extern "C" int hysteresis_form_launch(int steps, const void* balances, const void* effective,
                                      int64_t n, uint64_t increment, uint64_t max_effective,
                                      uint64_t down, uint64_t up, void* out, void* stream) {
  if (n < 0 || increment == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const sweeps_core::BalanceColumns c = sweeps_core::balance_columns(balances, effective, n, out);
  const sweeps_core::Hysteresis h = sweeps_core::hysteresis(increment, max_effective, down, up);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (steps) {
    case 0: return launch_hysteresis<4, false>(c, h, s);
    case 1: return launch_hysteresis<1, true>(c, h, s);
    case 2: return launch_hysteresis<2, true>(c, h, s);
    case 4: return launch_hysteresis<4, true>(c, h, s);
    case 8: return launch_hysteresis<8, true>(c, h, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Form `form` (the table above) on the program's columns; returns the
// launch's error.
extern "C" int update_form_launch(int form, const void* scores, const void* participating,
                                  const void* eligible, int64_t n, uint64_t bias,
                                  uint64_t recovery_rate, int leaking, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool leak = leaking != 0;
#define FORM_ARGS scores, participating, eligible, n, bias, recovery_rate, leak, out, s
  switch (form) {
    case 1: return leak ? launch<4, 1, true>(FORM_ARGS) : launch<4, 0, true>(FORM_ARGS);
    case 2: return launch_updates<2>(FORM_ARGS);
    case 3: return launch_updates<1>(FORM_ARGS);
    case 4: return leak ? launch<2, 1, true>(FORM_ARGS) : launch<2, 0, true>(FORM_ARGS);
    case 5: return launch<4, -1, false>(FORM_ARGS);
    case 6: return launch_updates<8>(FORM_ARGS);
    case 7: return launch<4, -1, true, true>(FORM_ARGS);
    case 8: return launch<2, -1, true, true>(FORM_ARGS);
    case 9: return launch<1, -1, true, true>(FORM_ARGS);
    case 10: return launch_updates<4>(FORM_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FORM_ARGS
}
