// Threefry-2x32 random fields for Hopper (sm_90a).
//
// Replaces XLA's fused draw of the JAX package's per-frame random fields:
// particlesystem_tpu/core/rng.py:53 _per_tag_u01 (a vmap of fold_in and
// uniform, one fused elementwise computation under jit; there is no Pallas
// kernel), reached by models/nbody.py:334 frame_fields, and the flat
// jax.random.uniform draws of models/emitter.py:68 spawn_fields and of
// models/nbody.py init_fill.  Computes what
// particlesystem_tpu_torch/core/rng.py computes as int64 tensor ops (its
// plain version, through ops/rng_kernel.py), bit for bit, with the hash,
// the uniforms and the lattice of csrc/threefry.cuh (shared with
// csrc/emitter_frame.cu).
//
// Two entry points:
//
//   ps_nbody_frame_fields  one thread a tag (int64 tags, masked to 32 bits):
//                          uvec (T, 3) the lattice vector of 3 uniforms
//                          under fold_in(kU, tag); fert (T,) lo + u*span,
//                          u under fold_in(kF, tag); kU and kF are
//                          fold_in(purpose key, frame)
//   ps_flat_fields         up to 4 flat draws into one float32 buffer, one
//                          after the other: uniforms, lo + u*span, or
//                          lattice unit vectors (3 counters a row), each
//                          under fold_in(purpose key, frame) with up to
//                          two constant words folded in after it (the
//                          spawn draws' salt, then 1; init_fill's split
//                          index i, since split(k)[i] = fold_in(k, i))
//
// The frame is read from device memory (a 0-dim int64, masked to 32 bits):
// a CUDA graph that captures a launch replays it at each frame's own
// index, where a frame key in the parameter block would freeze the
// captured frame's.  The purpose keys and the words, the same every
// frame, travel in the parameter block.  Each block derives its keys once
// (one lane of its first warp a key) into shared memory, and its threads
// read them after one __syncthreads().
//
// What bounds it on the card: the instruction rate.  A hash is about 72
// integer instructions (per round one add, one SHF, one LOP3; then the key
// injections; ptxas spreads the adds over IADD3 and IMAD, so they go to
// the INT32 and the FMA lanes alike), an n-body tag costs 6 hashes (two
// fold_ins, four draws) against 24 bytes (8 in, 16 out), and each block
// 2 more for its keys (a flat draw: 1 to 3 a draw): at the 1M plateau
// prefix of 786,432 tags (3,072 blocks of 256) some 3.4e8 instructions at
// 128 lanes an SM a clock, against 18.9 MB at 3.35 TB/s, so the
// instructions take about twice as long as the bytes.
//
// What the design does about it: each hash lives in registers, its rounds
// unrolled, each rotation one funnel shift; a tag's six hashes run in one
// thread and nothing intermediate touches device memory (the plain version
// writes some 170 int64 tensors a hash).  One thread an item over a
// grid-stride loop.
//
// Exactness: every float operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn), so no FMA contraction fuses lo + u*span; the
// lattice's exactness is threefry.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using ps_threefry::Key;
using ps_threefry::at_frame;
using ps_threefry::lattice;
using ps_threefry::threefry;
using ps_threefry::uniform;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;
constexpr int MAX_DRAWS = 4;
constexpr int MAX_WORDS = 2;
enum Kind : int { UNIT = 0, AFFINE = 1, LATTICE = 2 };

struct Draw {
    uint32_t k1, k2;   // purpose key
    int n_words;       // words folded in after the frame
    uint32_t words[MAX_WORDS];
    long long start;   // first item of the draw, over all draws' items
    long long offset;  // first float of its output in the buffer
    int kind;
    float lo, span;
};

struct Draws {
    Draw d[MAX_DRAWS];
    int n;
    long long items;
};

__global__ void __launch_bounds__(THREADS) nbody_frame_fields(
    const long long* __restrict__ tags, long long n, float* __restrict__ uvec,
    float* __restrict__ fert, const long long* __restrict__ frame, Key pu,
    Key pf, float lo, float span)
{
    __shared__ uint2 keys[2];
    if (threadIdx.x < 2) keys[threadIdx.x] = at_frame(threadIdx.x ? pf : pu,
                                                      frame);
    __syncthreads();
    const uint2 ku = keys[0];
    const uint2 kf = keys[1];
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         t < n; t += stride) {
        const uint32_t tag = static_cast<uint32_t>(tags[t]);
        const uint2 k = threefry(ku.x, ku.y, 0u, tag);
        lattice(uniform(k.x, k.y, 0), uniform(k.x, k.y, 1),
                uniform(k.x, k.y, 2), uvec + 3 * t);
        const uint2 f = threefry(kf.x, kf.y, 0u, tag);
        fert[t] = __fadd_rn(lo, __fmul_rn(uniform(f.x, f.y, 0), span));
    }
}

__global__ void __launch_bounds__(THREADS) flat_fields(
    float* __restrict__ out, const long long* __restrict__ frame, Draws draws)
{
    // draw g's key, by lane g of the first warp (every index into the
    // parameter block constant, so nothing of it is copied to the stack)
    __shared__ uint2 keys[MAX_DRAWS];
#pragma unroll
    for (int g = 0; g < MAX_DRAWS; ++g) {
        if (threadIdx.x == g && g < draws.n) {
            const Draw& d = draws.d[g];
            uint2 k = at_frame(Key{d.k1, d.k2}, frame);
#pragma unroll
            for (int j = 0; j < MAX_WORDS; ++j)
                if (j < d.n_words) k = threefry(k.x, k.y, 0u, d.words[j]);
            keys[g] = k;
        }
    }
    __syncthreads();
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         w < draws.items; w += stride) {
        Draw d = draws.d[0];
        int g = 0;
#pragma unroll
        for (int h = 1; h < MAX_DRAWS; ++h)
            if (h < draws.n && w >= draws.d[h].start) {
                d = draws.d[h];
                g = h;
            }
        const uint2 k = keys[g];
        const unsigned long long i = w - d.start;
        if (d.kind == LATTICE) {
            lattice(uniform(k.x, k.y, 3 * i), uniform(k.x, k.y, 3 * i + 1),
                    uniform(k.x, k.y, 3 * i + 2), out + d.offset + 3 * i);
        } else {
            const float u = uniform(k.x, k.y, i);
            out[d.offset + i] =
                d.kind == AFFINE ? __fadd_rn(d.lo, __fmul_rn(u, d.span)) : u;
        }
    }
}

int blocks_for(long long items)
{
    const long long b = (items + THREADS - 1) / THREADS;
    return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// uvec (n, 3) and fert (n,) float32 of the n int64 tags at the frame
// *frame (a device pointer); (pu1, pu2) and (pf1, pf2) are the UVEC and
// FERT purpose keys, lo and span float32.
extern "C" int ps_nbody_frame_fields(
    const long long* tags, long long n, float* uvec, float* fert,
    const long long* frame, unsigned int pu1, unsigned int pu2,
    unsigned int pf1, unsigned int pf2, float lo, float span, void* stream)
{
    if (n < 0 || frame == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    nbody_frame_fields<<<blocks_for(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        tags, n, uvec, fert, frame, Key{pu1, pu2}, Key{pf1, pf2}, lo, span);
    return static_cast<int>(cudaGetLastError());
}

// n_draws draws into out at the frame *frame (a device pointer), one after
// the other: draw g has purpose key (keys[2g], keys[2g+1]) and n_words[g]
// words words[2g..] folded in after the frame, items[g] items of kind
// kinds[g] (UNIT and AFFINE: one float an item; LATTICE: a row of 3
// floats) and, for AFFINE, lo = affine[2g], span = affine[2g+1].  keys,
// n_words, words, items, kinds and affine are host arrays.
extern "C" int ps_flat_fields(
    float* out, int n_draws, const long long* frame, const unsigned int* keys,
    const int* n_words, const unsigned int* words, const long long* items,
    const int* kinds, const float* affine, void* stream)
{
    if (n_draws < 1 || n_draws > MAX_DRAWS || frame == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    Draws draws = {};
    long long start = 0, offset = 0;
    for (int g = 0; g < n_draws; ++g) {
        if (items[g] < 0 || kinds[g] < UNIT || kinds[g] > LATTICE
            || n_words[g] < 0 || n_words[g] > MAX_WORDS)
            return static_cast<int>(cudaErrorInvalidValue);
        draws.d[g] = Draw{keys[2 * g], keys[2 * g + 1], n_words[g],
                          {words[2 * g], words[2 * g + 1]}, start, offset,
                          kinds[g], affine[2 * g], affine[2 * g + 1]};
        start += items[g];
        offset += kinds[g] == LATTICE ? 3 * items[g] : items[g];
    }
    draws.n = n_draws;
    draws.items = start;
    if (start == 0) return 0;
    flat_fields<<<blocks_for(start), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(out, frame, draws);
    return static_cast<int>(cudaGetLastError());
}
