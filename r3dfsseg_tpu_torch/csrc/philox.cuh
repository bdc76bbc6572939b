// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11; the Random123 constants) and the attention dropout mask built
// on it.
//
// The TPU kernels seed the TPU's generator per (batch, 256-row query tile)
// (r3dfsseg_tpu/ops/pallas_attention.py:70,99), which ties the mask to the
// tiling.  Here the mask is a pure function of (seed, b, i, j): the word
// for query row i and key column j of cloud b is element j % 4 of
// Philox4x32-10 at counter (j / 4, i, b, 0) with key (seed_lo, seed_hi).
// b is the cloud's index in the whole batch: a call on a shard of it (a
// data-parallel rank's rows) passes the shard's first cloud as b0 and its
// cloud b hashes b0 + b, so the shards draw the whole batch's mask.
// The entry is kept iff (word >> 8) >= threshold, threshold =
// ceil(rate * 2^24) -- the integer form of the TPU kernel's
// u = (bits >> 8) * 2^-24 >= rate -- and a kept entry is scaled by
// 1 / (1 - rate).  So the forward and the backward may tile differently,
// and ops/cuda_attention.py computes the same bits in plain PyTorch.
#pragma once

#include <cstdint>

namespace r3d {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// What the mask needs: the key, the keep threshold, the scale of a kept
// entry and the batch offset b0 of the call's first cloud.
struct Dropout {
  uint32_t seed_lo, seed_hi, threshold;
  float scale;
  uint32_t b0;

  // The four words of keys 4 * j4 .. 4 * j4 + 3 on query row i of the
  // call's cloud b (cloud b0 + b of the whole batch).
  __device__ __forceinline__ uint4 words(int b, int i, int j4) const {
    return philox4x32_10(make_uint4(static_cast<uint32_t>(j4), static_cast<uint32_t>(i),
                                    static_cast<uint32_t>(b) + b0, 0u),
                         seed_lo, seed_hi);
  }

  __device__ __forceinline__ uint32_t kept(uint32_t word) const {
    return (word >> 8) >= threshold ? 1u : 0u;
  }

  // The mask factor of an entry: 0 or `scale`.
  __device__ __forceinline__ float factor(uint32_t word) const {
    return (word >> 8) >= threshold ? scale : 0.f;
  }
};

}  // namespace r3d
