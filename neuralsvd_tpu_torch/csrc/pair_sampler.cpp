// Class-balanced pair sampler: the native host-side data path of the CDK
// loader (neuralsvd_tpu_torch/data/native.py).
//
// The CDK training loop needs, per batch, one (sketch, photo) index pair per
// slot where both items come from the same class, classes cycling in a fresh
// random order each cycle.  At batch 4096 a Python loop over random.choice
// costs milliseconds between device steps; this fills the index arrays in
// microseconds.
//
// The port's own copy of the JAX package's sampler: the same
// splitmix64-seeded xoshiro256** stream per (seed, batch_counter), the same
// Lemire bounded draw and Fisher-Yates shuffle, so the same arguments give
// the same indices bit for bit.  Plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 pair_sampler.cpp -o libpair_sampler.so
// (data/native.py builds it at first use into csrc/build/).

#include <cstdint>
#include <vector>

namespace {

struct Xoshiro256ss {
  uint64_t s[4];

  static uint64_t splitmix64(uint64_t& x) {
    x += 0x9E3779B97f4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }

  explicit Xoshiro256ss(uint64_t seed) {
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(seed);
  }

  static uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // unbiased bounded draw (Lemire)
  uint32_t bounded(uint32_t n) {
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    uint32_t lo = (uint32_t)m;
    if (lo < n) {
      uint32_t threshold = (uint32_t)(-(int32_t)n) % n;
      while (lo < threshold) {
        m = (uint64_t)(uint32_t)next() * n;
        lo = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

}  // namespace

extern "C" {

// offsets: (n_classes + 1,) prefix sums into flat index arrays.
// out_*: (batch_size,) int32 buffers filled by this call.
void sample_pairs(const int32_t* sk_offsets, const int32_t* sk_flat,
                  const int32_t* ph_offsets, const int32_t* ph_flat,
                  int32_t n_classes, int32_t batch_size,
                  uint64_t seed, uint64_t counter,
                  int32_t* out_sk, int32_t* out_ph, int32_t* out_cls) {
  uint64_t mix = seed;
  Xoshiro256ss rng(Xoshiro256ss::splitmix64(mix) ^
                   (counter * 0xD1B54A32D192ED03ULL + 1));

  std::vector<int32_t> order(n_classes);
  for (int32_t i = 0; i < n_classes; ++i) order[i] = i;

  int32_t filled = 0;
  while (filled < batch_size) {
    // fresh shuffle each cycle through the class list (Fisher–Yates)
    for (int32_t i = n_classes - 1; i > 0; --i) {
      int32_t j = (int32_t)rng.bounded((uint32_t)(i + 1));
      int32_t tmp = order[i];
      order[i] = order[j];
      order[j] = tmp;
    }
    for (int32_t i = 0; i < n_classes && filled < batch_size; ++i) {
      int32_t c = order[i];
      int32_t sk_lo = sk_offsets[c], sk_n = sk_offsets[c + 1] - sk_lo;
      int32_t ph_lo = ph_offsets[c], ph_n = ph_offsets[c + 1] - ph_lo;
      if (sk_n <= 0 || ph_n <= 0) continue;
      out_sk[filled] = sk_flat[sk_lo + (int32_t)rng.bounded((uint32_t)sk_n)];
      out_ph[filled] = ph_flat[ph_lo + (int32_t)rng.bounded((uint32_t)ph_n)];
      out_cls[filled] = c;
      ++filled;
    }
  }
}

// Gather rows: out[i, :] = src[idx[i], :].  float32, used to materialize
// the batch without numpy fancy-indexing overhead on large feature banks.
void gather_rows_f32(const float* src, const int32_t* idx, int32_t n_rows,
                     int32_t dim, float* out) {
  for (int32_t i = 0; i < n_rows; ++i) {
    const float* s = src + (int64_t)idx[i] * dim;
    float* d = out + (int64_t)i * dim;
    for (int32_t j = 0; j < dim; ++j) d[j] = s[j];
  }
}

}  // extern "C"
