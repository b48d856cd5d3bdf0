// Kernel B0: counter-based threefry2x32 as a device function.
//
// Replaces repro/kernels/rng.py (threefry2x32, uniform_from_bits, draws3),
// which the Pallas sweep kernels inline.  Pure uint32 integer math, so the
// card gives the same bits as the JAX package and as the plain PyTorch
// version in ../rng.py.  Streams are indexed by (seed, global chain index,
// step, draw): results do not depend on how chains are blocked.
#pragma once
#include <cstdint>

namespace sa {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// Standard 20-round threefry2x32 (Random123), rotation schedule
// {13, 15, 26, 6, 17, 29, 16, 24}, key parity 0x1BD11BDA.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int block = 0; block < 5; ++block) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x0 += x1;
            x1 = rotl32(x1, rot[(block * 4 + i) % 8]);
            x1 ^= x0;
        }
        x0 += ks[(block + 1) % 3];
        x1 += ks[(block + 2) % 3] + static_cast<uint32_t>(block + 1);
    }
}

// uint32 -> float32 uniform in [0, 1) from the top 24 bits (exact).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
    return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// The paper's three draws for step `step` of chain `cidx`: coordinate bits,
// value uniform, accept uniform.  2*step wraps modulo 2^32 as in the JAX
// package.
__device__ __forceinline__ void draws3(uint32_t seed, uint32_t cidx,
                                       uint32_t step, uint32_t& rbits,
                                       float& uval, float& uacc) {
    uint32_t a0 = cidx, a1 = 0u;
    threefry2x32(seed, step * 2u, a0, a1);
    uint32_t b0 = cidx, b1 = 1u;
    threefry2x32(seed, step * 2u + 1u, b0, b1);
    rbits = a0;
    uval = uniform_from_bits(a1);
    uacc = uniform_from_bits(b0);
}

}  // namespace sa
