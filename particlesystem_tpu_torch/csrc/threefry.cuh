// Threefry-2x32 device code, shared by csrc/threefry.cu (the random fields)
// and csrc/emitter_frame.cu (the emitter's spawn rows): the hash, a uniform
// float of one counter, the lattice unit vector of three uniforms and the
// frame's key of a purpose key, each bit for bit what
// particlesystem_tpu_torch/core/rng.py computes:
//
//   threefry2x32(k, (x1, x2))  20 rounds; ks = (k1, k2, k1^k2^0x1BD11BDA);
//                              rotations (13,15,26,6) then (17,29,16,24);
//                              after group i, x1 += ks[(i+1)%3] and
//                              x2 += ks[(i+2)%3] + i + 1
//   fold_in(k, d)              threefry2x32(k, (0, d))
//   element i of a draw        b1 ^ b2 of threefry2x32(k, (i >> 32, i))
//   uniform                    bitcast_f32((bits >> 9) | 0x3F800000) - 1
//   lattice unit vector        three ints floor(u*100) - 50, divided by
//                              their norm; the all-zero draw gives +x
//
// Exactness: every float operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so no FMA
// contraction fuses the lattice's u*100; the square root is the correctly
// rounded float32 root, which is what the plain version's float64 root
// rounded once gives.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ps_threefry {

constexpr uint32_t PARITY = 0x1BD11BDAu;

struct Key {
    uint32_t k1, k2;
};

__device__ __forceinline__ int rotation(int group, int j)
{
    return group % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                          : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

__device__ __forceinline__ uint2 threefry(uint32_t k1, uint32_t k2,
                                          uint32_t x1, uint32_t x2)
{
    const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ PARITY};
    x1 += ks[0];
    x2 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x1 += x2;
            x2 = __funnelshift_l(x2, x2, rotation(i, j)) ^ x1;
        }
        x1 += ks[(i + 1) % 3];
        x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
    return make_uint2(x1, x2);
}

// element i of a draw under key (k1, k2): the counter's high word too
__device__ __forceinline__ float uniform(uint32_t k1, uint32_t k2,
                                         unsigned long long i)
{
    const uint2 h = threefry(k1, k2, static_cast<uint32_t>(i >> 32),
                             static_cast<uint32_t>(i));
    const uint32_t bits = h.x ^ h.y;
    return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float lattice_int(float u)
{
    return static_cast<float>(
        static_cast<int>(floorf(__fmul_rn(u, 100.0f))) - 50);
}

// the unit vector of three uniforms, written to out[0..2]
__device__ __forceinline__ void lattice(float u0, float u1, float u2,
                                        float* out)
{
    const float v0 = lattice_int(u0);
    const float v1 = lattice_int(u1);
    const float v2 = lattice_int(u2);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(v0, v0), __fmul_rn(v1, v1)),
                               __fmul_rn(v2, v2));
    const float mag = __fsqrt_rn(sq);
    if (mag > 0.0f) {
        out[0] = __fdiv_rn(v0, mag);
        out[1] = __fdiv_rn(v1, mag);
        out[2] = __fdiv_rn(v2, mag);
    } else {
        out[0] = 1.0f;
        out[1] = 0.0f;
        out[2] = 0.0f;
    }
}

// fold_in(k, frame): the frame's key of purpose key k, the frame read from
// device memory (a 0-dim int64, masked to 32 bits)
__device__ __forceinline__ uint2 at_frame(Key k, const long long* frame)
{
    return threefry(k.k1, k.k2, 0u, static_cast<uint32_t>(*frame));
}

}  // namespace ps_threefry
