// The swap-or-not shuffle's schedule on a CTA's shared memory, as __host__
// __device__ functions: the plan (how much of each round's source row a
// CTA holds, and how many rounds a load stages), the bytes of a row that a
// round reads, and a round's step for one index.
//
// The arithmetic of the Hopper kernel in shuffle.cu. The header is plain
// C++ outside nvcc, so g++ builds the same functions, and a host version of
// the kernel's schedule (shuffle_host: every CTA's ring of stage
// buffers as arrays, filled and read in the kernel's order), for the CPU
// tests that hold it against the spec's compute_shuffled_index.
//
// A round r maps index i to flip = (pivot_r + count - i) mod count when bit
// (max(i, flip) mod 8) of byte max(i, flip) / 8 of the round's source row
// is set, and keeps i otherwise. The source row of round r concatenates
// sha256(seed || r || chunk) for every 256-index chunk; the pivots and rows
// are a host precompute.
//
// Half a row. With pivot P, an index i <= P has flip P - i, so max(i, flip)
// lies in [ceil(P / 2), P]; an index i > P has flip P + count - i, so it
// lies in [ceil((P + count) / 2), count - 1]. A round reads only those two
// position ranges, about count / 16 bytes of its row: half of it. For rows
// of kHalfRowMin bytes or more the kernel copies just them, widened to
// 16-byte bounds, one after the other; smaller rows it copies whole, the
// rows of a stage in one copy (two copies of a few hundred bytes a round
// would cost more than they save). Either is the round's "span" (span_of),
// at most max_span bytes at any pivot.
//
// The plan. Every CTA holds whole windows of a span, so every lookup reads
// the CTA's own shared memory. The budget is cut into `buffers` stage
// buffers, a ring: while one is read the others load. A window is the whole
// span when the longest span fits a buffer; else a buffer, and a span takes
// several windows ("parts"), looked up in turn: an index's position in a
// round does not change when the round swaps it, so each index is decided
// in exactly one part. A chunk is one window of one round; a stage is as
// many chunks as a buffer holds.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SHUFFLE_HD __host__ __device__ __forceinline__
#else
#define SHUFFLE_HD inline
#endif

#ifndef __CUDA_ARCH__
#include <cstring>
#include <vector>
#endif

namespace shuffle_core {

SHUFFLE_HD int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

constexpr int64_t kHalfRowMin = 16384;

SHUFFLE_HD bool half_rows(int64_t row_bytes) { return row_bytes >= kHalfRowMin; }

// The bytes of a row that a round reads at pivot P, widened to 16-byte
// bounds: [a_lo, a_lo + a_len), then [b_lo, b_lo + b_len) (b_len 0 when no
// index lies above P); a whole row is [0, row_bytes), with b_lo = a_len so
// that every position's offset is its byte. T holds 2 count.
template <typename T>
struct Span {
  T a_lo, a_len, b_lo, b_len;
};

template <typename T>
SHUFFLE_HD Span<T> span_of(T pivot, T count, T row_bytes) {
  Span<T> s;
  if (!half_rows(static_cast<int64_t>(row_bytes))) {
    s.a_lo = 0;
    s.a_len = s.b_lo = row_bytes;
    s.b_len = 0;
    return s;
  }
  s.a_lo = (((pivot + 1) >> 1) >> 3) & ~T{15};
  s.a_len = ((pivot >> 3) | 15) + 1 - s.a_lo;
  const T b0 = ((pivot + count + 1) >> 1) >> 3, b1 = (count - 1) >> 3;
  s.b_lo = b0 & ~T{15};
  s.b_len = b0 <= b1 ? (b1 | 15) + 1 - s.b_lo : 0;
  return s;
}

// The longest span at any pivot: half rows each range at most a sixteenth
// of the positions around it plus a byte, widened by up to 30 bytes
SHUFFLE_HD int64_t max_span(int64_t count, int64_t row_bytes) {
  return half_rows(row_bytes) ? ceil_div(count, 16) + 80 : row_bytes;
}

struct Plan {
  int64_t count;
  int rounds;
  int64_t row_bytes;  // a round's row in `sources` (a multiple of 16)
  int buffers;        // stage buffers a CTA, a ring: the others load while one is read
  int parts;          // windows a span is cut into
  int64_t window;     // bytes of a span one window covers (a multiple of 16)
  int per_stage;      // chunks (a window of a round) a stage holds
  int stages;         // chunks over per_stage, rounded up (0 without rounds)
};

// budget: a CTA's shared bytes for its stage buffers
SHUFFLE_HD Plan make_plan(int64_t count, int rounds, int64_t row_bytes, int buffers,
                          int64_t budget) {
  Plan p;
  p.count = count;
  p.rounds = rounds;
  p.row_bytes = row_bytes;
  p.buffers = buffers;
  const int64_t each = budget / buffers / 16 * 16;
  const int64_t span = ceil_div(max_span(count, row_bytes), 16) * 16;
  p.window = span <= each ? span : each;
  p.parts = static_cast<int>(ceil_div(span, p.window));
  const int64_t chunks = static_cast<int64_t>(rounds) * p.parts;
  int64_t per = each / p.window;
  if (per > chunks) per = chunks;
  if (per < 1) per = 1;
  p.per_stage = static_cast<int>(per);
  p.stages = static_cast<int>(ceil_div(chunks, per));
  return p;
}

// Copy i (0 or 1) of chunk (round r, part): the part's window [part
// window, + window) of the round's span, as pieces of the row's two
// ranges: `len` bytes (0: none) of the table from `src`, to `dst` in the
// chunk's window
SHUFFLE_HD void chunk_copy(const Plan& p, const Span<int64_t>& s, int r, int part, int i, int64_t& src,
                           int64_t& dst, int64_t& len) {
  const int64_t lo = part * p.window, hi = lo + p.window;
  // copy 0 holds span bytes [0, a_len), copy 1 [a_len, a_len + b_len)
  const int64_t from = i == 0 ? 0 : s.a_len, to = i == 0 ? s.a_len : s.a_len + s.b_len;
  const int64_t start = from > lo ? from : lo, end = to < hi ? to : hi;
  len = end > start ? end - start : 0;
  src = static_cast<int64_t>(r) * p.row_bytes + (i == 0 ? s.a_lo : s.b_lo) + (start - from);
  dst = start - lo;
}

// One round's flip of idx: (pivot + count - idx) mod count, for idx and
// pivot below count (so one conditional subtraction reduces it; Idx holds
// 2 count)
template <typename Idx>
SHUFFLE_HD Idx flip_of(Idx idx, Idx pivot, Idx count) {
  Idx flip = pivot + count - idx;
  if (flip >= count) flip -= count;
  return flip;
}

// The offset in a round's span of the byte that holds position pos
template <typename Idx>
SHUFFLE_HD Idx span_offset(Idx pos, Idx pivot, Idx a_lo, Idx a_len, Idx b_lo) {
  return pos <= pivot ? (pos >> 3) - a_lo : a_len + (pos >> 3) - b_lo;
}

#ifndef __CUDA_ARCH__
// The kernel's schedule on the host: `blocks` CTAs, each of `threads`
// threads holding `per` indices (CTA b's thread t holds indices base + (b
// per + j) threads + t of each batch), the ring of stage buffers of every
// CTA filled and read in the kernel's order (stage v + buffers loads into
// stage v's buffer once the CTA has read it). out: (count,) with out[i] =
// compute_shuffled_index(i). Returns false if a copy would leave its
// window or its row, or not be of 16-byte multiples.
inline bool shuffle_host(const Plan& p, const int64_t* pivots, const uint8_t* sources,
                         int blocks, int threads, int per, int64_t* out) {
  const int64_t buffer = p.per_stage * p.window;
  const int64_t chunks = static_cast<int64_t>(p.rounds) * p.parts;
  const int64_t batch_indices = static_cast<int64_t>(blocks) * threads * per;
  const int64_t total = ceil_div(p.count, batch_indices) * p.stages;
  std::vector<std::vector<uint8_t>> smem(blocks,
                                         std::vector<uint8_t>(p.buffers * buffer, 0xa5));
  std::vector<uint64_t> idx(static_cast<std::size_t>(blocks) * threads * per);
  bool inside = true;
  // stage v into buffer v % buffers of every CTA
  auto load = [&](int64_t v) {
    const int64_t s = v % p.stages;
    for (int64_t c = s * p.per_stage; c < chunks && c < (s + 1) * p.per_stage; ++c) {
      const int r = static_cast<int>(c / p.parts), part = static_cast<int>(c % p.parts);
      const Span<int64_t> span = span_of<int64_t>(pivots[r], p.count, p.row_bytes);
      for (int i = 0; i < 2; ++i) {
        int64_t src, dst, len;
        chunk_copy(p, span, r, part, i, src, dst, len);
        if (len == 0) continue;
        inside &= dst >= 0 && dst + len <= p.window && src >= r * p.row_bytes &&
                  src + len <= (r + 1) * p.row_bytes && src % 16 == 0 && len % 16 == 0;
        const int64_t at = (v % p.buffers) * buffer + (c - s * p.per_stage) * p.window + dst;
        for (int b = 0; b < blocks; ++b) {
          std::memcpy(smem[b].data() + at, sources + src, static_cast<std::size_t>(len));
        }
      }
    }
  };
  if (p.stages == 0) {
    for (int64_t i = 0; i < p.count; ++i) out[i] = i;
    return true;
  }
  for (int64_t v = 0; v < p.buffers && v < total; ++v) load(v);
  for (int64_t v = 0; v < total; ++v) {
    const int64_t s = v % p.stages, base = (v / p.stages) * batch_indices;
    for (int b = 0; b < blocks; ++b) {
      for (int t = 0; t < threads; ++t) {
        for (int j = 0; j < per; ++j) {
          const int64_t i = base + (static_cast<int64_t>(b) * per + j) * threads + t;
          uint64_t& x = idx[(static_cast<std::size_t>(b) * threads + t) * per + j];
          if (s == 0) x = i < p.count ? static_cast<uint64_t>(i) : 0;
          for (int ci = 0; ci < p.per_stage; ++ci) {
            const int64_t c = s * p.per_stage + ci;
            if (c >= chunks) break;
            const int r = static_cast<int>(c / p.parts), part = static_cast<int>(c % p.parts);
            const uint64_t pivot = static_cast<uint64_t>(pivots[r]);
            const Span<int64_t> span = span_of<int64_t>(pivots[r], p.count, p.row_bytes);
            const uint64_t flip = flip_of<uint64_t>(x, pivot, static_cast<uint64_t>(p.count));
            const uint64_t pos = x > flip ? x : flip;
            const int64_t rel =
                static_cast<int64_t>(span_offset<uint64_t>(pos, pivot, span.a_lo, span.a_len,
                                                           span.b_lo)) -
                part * p.window;
            if (rel < 0 || rel >= p.window) continue;
            const uint8_t byte = smem[b][(v % p.buffers) * buffer + ci * p.window + rel];
            if ((byte >> (pos & 7)) & 1) x = flip;
          }
          if (s == p.stages - 1 && i < p.count) out[i] = static_cast<int64_t>(x);
        }
      }
    }
    if (v + p.buffers < total) load(v + p.buffers);
  }
  return inside;
}
#endif

}  // namespace shuffle_core
