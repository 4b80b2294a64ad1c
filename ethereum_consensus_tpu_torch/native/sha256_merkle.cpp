// Native SHA-256 merkle kernels (the CPU-side hot path of SSZ
// hash_tree_root).
//
// Fills the role the reference fills with native crypto (sha2 crate /
// blst's C, SURVEY.md L0): a from-scratch C++ SHA-256 specialized for the
// 64-byte two-children message of binary merkleization, with whole-level
// and whole-tree entry points so the Python merkleizer can hand off entire
// reductions in one call.
//
// Build: g++ -O3 -march=native -shared -fPIC sha256_merkle.cpp -o ...
// ABI (ctypes):
//   void ec_hash_level(const uint8_t* in, uint8_t* out, size_t n_pairs);
//   void ec_merkle_root(const uint8_t* chunks, size_t count, uint32_t depth,
//                       const uint8_t* zero_hashes, uint8_t* out32);
//   uint64_t ec_version(void);

#include <cstdint>
#include <cstring>
#include <vector>

// 8-way AVX2 multi-buffer path: the merkle level is 8+ independent
// 64-byte messages — the ideal multi-buffer case. Pure integer AVX2
// (no SHA-NI).
#if defined(__AVX2__) && defined(__x86_64__)
#define EC_AVX2_ACTIVE 1
#endif

// the AVX-512 kernel below is compiled with target attributes on any
// x86-64 build (runtime-dispatched), so the intrinsics header is needed
// even when the baseline ISA has no AVX2
#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

inline uint32_t load_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline void store_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

inline void compress(uint32_t state[8], const uint32_t w_in[16]) {
  uint32_t w[64];
  std::memcpy(w, w_in, 16 * sizeof(uint32_t));
  for (int t = 16; t < 64; ++t) {
    uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
    uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int t = 0; t < 64; ++t) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[t] + w[t];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  state[0] += a;
  state[1] += b;
  state[2] += c;
  state[3] += d;
  state[4] += e;
  state[5] += f;
  state[6] += g;
  state[7] += h;
}

// the constant second block of a 64-byte message (0x80 pad + bit length 512)
constexpr uint32_t PAD_BLOCK[16] = {0x80000000, 0, 0, 0, 0, 0, 0, 0,
                                    0,          0, 0, 0, 0, 0, 0, 512};

// SHA-256 of exactly 64 bytes (one merkle pair) — two compressions, the
// second over a constant schedule.
inline void sha256_64(const uint8_t* in, uint8_t* out) {
  uint32_t state[8];
  std::memcpy(state, H0, sizeof(H0));
  uint32_t w[16];
  for (int i = 0; i < 16; ++i) w[i] = load_be32(in + 4 * i);
  compress(state, w);
  compress(state, PAD_BLOCK);
  for (int i = 0; i < 8; ++i) store_be32(out + 4 * i, state[i]);
}

// message schedule of the constant pad block, computed once (shared by
// the AVX2 and AVX-512 multi-buffer kernels)
struct PadSchedule {
  uint32_t w[64];
  PadSchedule() {
    std::memcpy(w, PAD_BLOCK, 16 * sizeof(uint32_t));
    for (int t = 16; t < 64; ++t) {
      uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
      uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
      w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
  }
};
const PadSchedule PAD_SCHED;

#ifdef EC_AVX2_ACTIVE

inline __m256i rotr8(__m256i x, int n) {
  return _mm256_or_si256(_mm256_srli_epi32(x, n),
                         _mm256_slli_epi32(x, 32 - n));
}

#define EC_ROUND8(wt)                                                        \
  do {                                                                       \
    __m256i S1 = _mm256_xor_si256(_mm256_xor_si256(rotr8(e, 6), rotr8(e, 11)),\
                                  rotr8(e, 25));                             \
    __m256i ch = _mm256_xor_si256(_mm256_and_si256(e, f),                    \
                                  _mm256_andnot_si256(e, g));                \
    __m256i t1 = _mm256_add_epi32(                                           \
        _mm256_add_epi32(_mm256_add_epi32(h, S1), ch),                       \
        _mm256_add_epi32(_mm256_set1_epi32(int(K[t])), (wt)));               \
    __m256i S0 = _mm256_xor_si256(_mm256_xor_si256(rotr8(a, 2), rotr8(a, 13)),\
                                  rotr8(a, 22));                             \
    __m256i maj = _mm256_xor_si256(                                          \
        _mm256_xor_si256(_mm256_and_si256(a, b), _mm256_and_si256(a, c)),    \
        _mm256_and_si256(b, c));                                             \
    __m256i t2 = _mm256_add_epi32(S0, maj);                                  \
    h = g; g = f; f = e; e = _mm256_add_epi32(d, t1);                        \
    d = c; c = b; b = a; a = _mm256_add_epi32(t1, t2);                       \
  } while (0)

// eight independent 64-byte messages -> eight 32-byte digests, lanes
// transposed across one ymm register per word
inline void sha256_64_x8(const uint8_t* in, uint8_t* out) {
  __m256i a = _mm256_set1_epi32(int(H0[0]));
  __m256i b = _mm256_set1_epi32(int(H0[1]));
  __m256i c = _mm256_set1_epi32(int(H0[2]));
  __m256i d = _mm256_set1_epi32(int(H0[3]));
  __m256i e = _mm256_set1_epi32(int(H0[4]));
  __m256i f = _mm256_set1_epi32(int(H0[5]));
  __m256i g = _mm256_set1_epi32(int(H0[6]));
  __m256i h = _mm256_set1_epi32(int(H0[7]));

  // block 1: the data block, schedule extended in a 16-entry ring
  __m256i w[16];
  for (int t = 0; t < 16; ++t) {
    w[t] = _mm256_set_epi32(
        int(load_be32(in + 7 * 64 + 4 * t)), int(load_be32(in + 6 * 64 + 4 * t)),
        int(load_be32(in + 5 * 64 + 4 * t)), int(load_be32(in + 4 * 64 + 4 * t)),
        int(load_be32(in + 3 * 64 + 4 * t)), int(load_be32(in + 2 * 64 + 4 * t)),
        int(load_be32(in + 1 * 64 + 4 * t)), int(load_be32(in + 0 * 64 + 4 * t)));
  }
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      __m256i w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      __m256i s0 = _mm256_xor_si256(
          _mm256_xor_si256(rotr8(w15, 7), rotr8(w15, 18)),
          _mm256_srli_epi32(w15, 3));
      __m256i s1 = _mm256_xor_si256(
          _mm256_xor_si256(rotr8(w2, 17), rotr8(w2, 19)),
          _mm256_srli_epi32(w2, 10));
      w[t & 15] = _mm256_add_epi32(
          _mm256_add_epi32(w[t & 15], s0),
          _mm256_add_epi32(w[(t - 7) & 15], s1));
    }
    EC_ROUND8(w[t & 15]);
  }
  __m256i sa = _mm256_add_epi32(a, _mm256_set1_epi32(int(H0[0])));
  __m256i sb = _mm256_add_epi32(b, _mm256_set1_epi32(int(H0[1])));
  __m256i sc = _mm256_add_epi32(c, _mm256_set1_epi32(int(H0[2])));
  __m256i sd = _mm256_add_epi32(d, _mm256_set1_epi32(int(H0[3])));
  __m256i se = _mm256_add_epi32(e, _mm256_set1_epi32(int(H0[4])));
  __m256i sf = _mm256_add_epi32(f, _mm256_set1_epi32(int(H0[5])));
  __m256i sg = _mm256_add_epi32(g, _mm256_set1_epi32(int(H0[6])));
  __m256i sh = _mm256_add_epi32(h, _mm256_set1_epi32(int(H0[7])));

  // block 2: constant schedule, no extension work
  a = sa; b = sb; c = sc; d = sd; e = se; f = sf; g = sg; h = sh;
  for (int t = 0; t < 64; ++t) {
    EC_ROUND8(_mm256_set1_epi32(int(PAD_SCHED.w[t])));
  }
  a = _mm256_add_epi32(a, sa);
  b = _mm256_add_epi32(b, sb);
  c = _mm256_add_epi32(c, sc);
  d = _mm256_add_epi32(d, sd);
  e = _mm256_add_epi32(e, se);
  f = _mm256_add_epi32(f, sf);
  g = _mm256_add_epi32(g, sg);
  h = _mm256_add_epi32(h, sh);

  alignas(32) uint32_t lanes[8][8];
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[0]), a);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[1]), b);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[2]), c);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[3]), d);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[4]), e);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[5]), f);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[6]), g);
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes[7]), h);
  for (int lane = 0; lane < 8; ++lane) {
    for (int i = 0; i < 8; ++i) {
      store_be32(out + 32 * lane + 4 * i, lanes[i][lane]);
    }
  }
}

#undef EC_ROUND8

#endif  // EC_AVX2_ACTIVE

#if defined(__x86_64__)
#define EC_AVX512_COMPILED 1
#define EC_SHA512_TARGET \
  __attribute__((target("avx512f,avx512bw,avx512dq,avx512vl")))

// 16-way AVX-512 multi-buffer path: same transposed-lane scheme as the
// AVX2 kernel, but with the ISA doing real work per instruction — native
// 32-bit rotates (vprord) replace the shift/shift/or triple, and
// vpternlogd fuses ch, maj, and each three-way xor into single ops.
// Runtime-dispatched (the .so is built per machine, but the check stays
// dynamic so a cached binary can never fault on a non-AVX-512 host).

#define EC_ROUND16(wt)                                                       \
  do {                                                                       \
    __m512i S1 = _mm512_ternarylogic_epi32(                                  \
        _mm512_ror_epi32(e, 6), _mm512_ror_epi32(e, 11),                     \
        _mm512_ror_epi32(e, 25), 0x96);                                      \
    __m512i ch = _mm512_ternarylogic_epi32(e, f, g, 0xCA);                   \
    __m512i t1 = _mm512_add_epi32(                                           \
        _mm512_add_epi32(_mm512_add_epi32(h, S1), ch),                       \
        _mm512_add_epi32(_mm512_set1_epi32(int(K[t])), (wt)));               \
    __m512i S0 = _mm512_ternarylogic_epi32(                                  \
        _mm512_ror_epi32(a, 2), _mm512_ror_epi32(a, 13),                     \
        _mm512_ror_epi32(a, 22), 0x96);                                      \
    __m512i maj = _mm512_ternarylogic_epi32(a, b, c, 0xE8);                  \
    __m512i t2 = _mm512_add_epi32(S0, maj);                                  \
    h = g; g = f; f = e; e = _mm512_add_epi32(d, t1);                        \
    d = c; c = b; b = a; a = _mm512_add_epi32(t1, t2);                       \
  } while (0)

// sixteen independent 64-byte messages -> sixteen 32-byte digests
EC_SHA512_TARGET inline void sha256_64_x16(const uint8_t* in, uint8_t* out) {
  __m512i a = _mm512_set1_epi32(int(H0[0]));
  __m512i b = _mm512_set1_epi32(int(H0[1]));
  __m512i c = _mm512_set1_epi32(int(H0[2]));
  __m512i d = _mm512_set1_epi32(int(H0[3]));
  __m512i e = _mm512_set1_epi32(int(H0[4]));
  __m512i f = _mm512_set1_epi32(int(H0[5]));
  __m512i g = _mm512_set1_epi32(int(H0[6]));
  __m512i h = _mm512_set1_epi32(int(H0[7]));

  __m512i w[16];
  for (int t = 0; t < 16; ++t) {
    alignas(64) uint32_t lanes[16];
    for (int lane = 0; lane < 16; ++lane)
      lanes[lane] = load_be32(in + lane * 64 + 4 * t);
    w[t] = _mm512_load_si512(reinterpret_cast<const __m512i*>(lanes));
  }
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      __m512i w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      __m512i s0 = _mm512_ternarylogic_epi32(
          _mm512_ror_epi32(w15, 7), _mm512_ror_epi32(w15, 18),
          _mm512_srli_epi32(w15, 3), 0x96);
      __m512i s1 = _mm512_ternarylogic_epi32(
          _mm512_ror_epi32(w2, 17), _mm512_ror_epi32(w2, 19),
          _mm512_srli_epi32(w2, 10), 0x96);
      w[t & 15] = _mm512_add_epi32(
          _mm512_add_epi32(w[t & 15], s0),
          _mm512_add_epi32(w[(t - 7) & 15], s1));
    }
    EC_ROUND16(w[t & 15]);
  }
  __m512i sa = _mm512_add_epi32(a, _mm512_set1_epi32(int(H0[0])));
  __m512i sb = _mm512_add_epi32(b, _mm512_set1_epi32(int(H0[1])));
  __m512i sc = _mm512_add_epi32(c, _mm512_set1_epi32(int(H0[2])));
  __m512i sd = _mm512_add_epi32(d, _mm512_set1_epi32(int(H0[3])));
  __m512i se = _mm512_add_epi32(e, _mm512_set1_epi32(int(H0[4])));
  __m512i sf = _mm512_add_epi32(f, _mm512_set1_epi32(int(H0[5])));
  __m512i sg = _mm512_add_epi32(g, _mm512_set1_epi32(int(H0[6])));
  __m512i sh = _mm512_add_epi32(h, _mm512_set1_epi32(int(H0[7])));

  a = sa; b = sb; c = sc; d = sd; e = se; f = sf; g = sg; h = sh;
  for (int t = 0; t < 64; ++t) {
    EC_ROUND16(_mm512_set1_epi32(int(PAD_SCHED.w[t])));
  }
  a = _mm512_add_epi32(a, sa);
  b = _mm512_add_epi32(b, sb);
  c = _mm512_add_epi32(c, sc);
  d = _mm512_add_epi32(d, sd);
  e = _mm512_add_epi32(e, se);
  f = _mm512_add_epi32(f, sf);
  g = _mm512_add_epi32(g, sg);
  h = _mm512_add_epi32(h, sh);

  alignas(64) uint32_t lanes[8][16];
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[0]), a);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[1]), b);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[2]), c);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[3]), d);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[4]), e);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[5]), f);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[6]), g);
  _mm512_store_si512(reinterpret_cast<__m512i*>(lanes[7]), h);
  for (int lane = 0; lane < 16; ++lane) {
    for (int i = 0; i < 8; ++i) {
      store_be32(out + 32 * lane + 4 * i, lanes[i][lane]);
    }
  }
}

#undef EC_ROUND16

EC_SHA512_TARGET inline void hash_level_x16(const uint8_t* in, uint8_t* out,
                                            size_t n16) {
  for (size_t i = 0; i < n16; ++i) {
    sha256_64_x16(in + 64 * 16 * i, out + 32 * 16 * i);
  }
}

inline bool avx512_available() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512bw") &&
                         __builtin_cpu_supports("avx512dq") &&
                         __builtin_cpu_supports("avx512vl");
  return ok;
}
#endif  // __x86_64__

}  // namespace

extern "C" {

// Hash one merkle level: in = n_pairs 64-byte messages, out = n_pairs
// 32-byte digests. in/out may not alias.
void ec_hash_level(const uint8_t* in, uint8_t* out, size_t n_pairs) {
  size_t i = 0;
#ifdef EC_AVX512_COMPILED
  if (avx512_available() && n_pairs >= 16) {
    size_t n16 = n_pairs / 16;
    hash_level_x16(in, out, n16);
    i = 16 * n16;
  }
#endif
#ifdef EC_AVX2_ACTIVE
  for (; i + 8 <= n_pairs; i += 8) {
    sha256_64_x8(in + 64 * i, out + 32 * i);
  }
#endif
  for (; i < n_pairs; ++i) {
    sha256_64(in + 64 * i, out + 32 * i);
  }
}

// Full tree reduction: `chunks` holds `count` populated 32-byte leaves of a
// depth-`depth` virtual tree; `zero_hashes` is depth+1 cached zero-subtree
// roots (32 bytes each). Writes the 32-byte root to `out32`. Matches the
// Python merkleizer bit-for-bit (zero-padding odd levels with the level's
// zero hash).
void ec_merkle_root(const uint8_t* chunks, size_t count, uint32_t depth,
                    const uint8_t* zero_hashes, uint8_t* out32) {
  if (count == 0) {
    std::memcpy(out32, zero_hashes + 32 * size_t(depth), 32);
    return;
  }
  std::vector<uint8_t> nodes(chunks, chunks + 32 * count);
  std::vector<uint8_t> next;
  for (uint32_t level = 0; level < depth; ++level) {
    size_t n = nodes.size() / 32;
    if (n % 2 == 1) {
      nodes.insert(nodes.end(), zero_hashes + 32 * size_t(level),
                   zero_hashes + 32 * size_t(level) + 32);
      ++n;
    }
    next.resize(32 * (n / 2));
    ec_hash_level(nodes.data(), next.data(), n / 2);
    nodes.swap(next);
  }
  std::memcpy(out32, nodes.data(), 32);
}

uint64_t ec_version(void) { return 1; }

}  // extern "C"
