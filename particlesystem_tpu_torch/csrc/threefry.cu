// Threefry-2x32 random fields for Hopper (sm_90a).
//
// Replaces XLA's fused draw of the JAX package's per-frame random fields:
// particlesystem_tpu/core/rng.py:53 _per_tag_u01 (a vmap of fold_in and
// uniform, one fused elementwise computation under jit; there is no Pallas
// kernel), reached by models/nbody.py:334 frame_fields, and the flat
// jax.random.uniform draws of models/emitter.py:68 spawn_fields, and
// models/nbody.py init_fill whole, its draws and its writes.  Computes what
// particlesystem_tpu_torch/core/rng.py computes as int64 tensor ops (its
// plain version, through ops/rng_kernel.py), bit for bit, with the hash,
// the uniforms and the lattice of csrc/threefry.cuh (shared with
// csrc/emitter_frame.cu).
//
// Three entry points:
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
//   ps_nbody_fill          a whole fresh n-body state (init_fill) in one
//                          launch: slot i < n drawn from init_fill's four
//                          draws at frame 0 (below), every other slot
//                          zero and dead, tag[i] = i
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

// ps_nbody_fill: replaces the composition of ~20 launches that
// models/nbody.py init_fill made on a card (the flat draw above, the sign's
// where and the multiplies, zero_state's nine fills, five slice writes and
// the tags' arange), and with it the fused XLA draw and writes of
// particlesystem_tpu/models/nbody.py init_fill.  Bit for bit that
// composition: slot i < n takes r (3), u_sign (3), age and life with the
// counters flat_fields gives those draws' items (3i + c, and i), under the
// keys fold_in(fold_in(purpose key, 0), word) of words 0-3 (split(k, 4)),
// derived once a block; pos = (sign * r) * half_extent, sign +1 where
// u_sign >= 0.5, age and life lo + u*span, w = weight, alive = 1, vel,
// acc and parent 0.
//
// What bounds it on the card: the bytes.  The state is 58 B a slot (pos,
// vel, acc 12 each; w, age, life 4 each; alive, parent 1 each; tag 8),
// 121.6 MB at 2,097,152 slots, 0.036 ms at 3.35 TB/s; 1,048,576 particles'
// eight hashes are 0.018 ms at 72 instructions a hash.  What the design
// does about it:
//  * a block fills a tile of 1,024 slots, four a thread, and every store
//    of a warp is one contiguous run of 16 bytes a thread (the flags 4):
//    w, age, life and the flags straight from the thread's registers; pos
//    through shared memory, so that thread k writes the tile's float4s k,
//    k + 256, k + 512; vel, acc and the tags from the index alone.  (Four
//    slots' pos, vel and acc written by their own thread, three float4s
//    48 bytes apart from lane to lane, halved the rate on an H100: 0.09
//    ms where a memset of the same bytes takes 0.039.)
//  * tiles go in the order 0, h, 1, h + 1, ... (h half the tiles): a fill
//    of half the slots, as the reference's twice-as-many slots make it,
//    gives each SM drawn tiles beside tiles that are only written, so the
//    hashes overlap the stores (0.054 -> 0.049 ms at 1M);
//  * at most 64 registers, four blocks an SM; the draws stay in registers
//    and nothing is read from device memory.
constexpr int FILL_SLOTS = 4;
constexpr int FILL_TILE = FILL_SLOTS * THREADS;   // slots a block iteration
constexpr int FILL_KEYS = 4;

struct FillOut {
    float* pos;
    float* vel;
    float* acc;
    float* w;
    float* age;
    float* life;
    uint8_t* alive;
    uint8_t* parent;
    long long* tag;
};

struct FillArgs {
    uint32_t k1, k2;               // the FILL purpose key
    uint32_t words[FILL_KEYS];     // r, u_sign, age, life: split indices
    long long n, slots;
    float half_extent, weight;
    float age_lo, age_span, life_lo, life_span;
};

__global__ void __launch_bounds__(THREADS, 4)
    nbody_fill(FillOut o, FillArgs a)
{
    // draw g's key fold_in(fold_in(purpose key, frame 0), words[g]), by
    // lane g of the first warp (each index into the parameter block
    // constant, so nothing of it is copied to the stack)
    __shared__ uint2 keys[FILL_KEYS];
    __shared__ float4 stage[3 * THREADS];   // a tile's pos, in slot order
#pragma unroll
    for (int g = 0; g < FILL_KEYS; ++g) {
        if (threadIdx.x == g) {
            const uint2 k = threefry(a.k1, a.k2, 0u, 0u);
            keys[g] = threefry(k.x, k.y, 0u, a.words[g]);
        }
    }
    __syncthreads();
    const uint2 kr = keys[0], ks = keys[1], ka = keys[2], kf = keys[3];
    const int tid = threadIdx.x;
    const long long tiles = (a.slots + FILL_TILE - 1) / FILL_TILE;
    const long long half = (tiles + 1) / 2;
    for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
        // tiles in the order 0, half, 1, half + 1, ...
        const long long t0 = ((b & 1) ? half + b / 2 : b / 2) * FILL_TILE;
        const long long s0 = t0 + FILL_SLOTS * tid;   // this thread's slots
        float pos[3 * FILL_SLOTS], w[FILL_SLOTS], age[FILL_SLOTS],
            life[FILL_SLOTS];
        uint32_t alive = 0;
#pragma unroll
        for (int j = 0; j < FILL_SLOTS; ++j) {
            const long long i = s0 + j;
            if (i < a.n) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const unsigned long long q = 3ull * i + c;
                    const float r = uniform(kr.x, kr.y, q);
                    const float u = uniform(ks.x, ks.y, q);
                    pos[3 * j + c] = __fmul_rn(u >= 0.5f ? r : -r,
                                               a.half_extent);
                }
                age[j] = __fadd_rn(a.age_lo, __fmul_rn(uniform(ka.x, ka.y, i),
                                                       a.age_span));
                life[j] = __fadd_rn(
                    a.life_lo, __fmul_rn(uniform(kf.x, kf.y, i), a.life_span));
                w[j] = a.weight;
                alive |= 1u << (8 * j);
            } else {
#pragma unroll
                for (int c = 0; c < 3; ++c) pos[3 * j + c] = 0.0f;
                age[j] = life[j] = w[j] = 0.0f;
            }
        }
        if (t0 + FILL_TILE <= a.slots) {
            // a whole tile (the branch is the block's): every store of a
            // warp one contiguous run of 16 (the flags 4) bytes a thread
            *reinterpret_cast<float4*>(o.w + s0) =
                make_float4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<float4*>(o.age + s0) =
                make_float4(age[0], age[1], age[2], age[3]);
            *reinterpret_cast<float4*>(o.life + s0) =
                make_float4(life[0], life[1], life[2], life[3]);
            *reinterpret_cast<uint32_t*>(o.alive + s0) = alive;
            *reinterpret_cast<uint32_t*>(o.parent + s0) = 0u;
            // pos, 48 bytes a thread, goes through shared memory so that
            // thread k writes the tile's float4s k, k + THREADS, ...
#pragma unroll
            for (int k = 0; k < 3; ++k)
                stage[3 * tid + k] = make_float4(pos[4 * k], pos[4 * k + 1],
                                                 pos[4 * k + 2],
                                                 pos[4 * k + 3]);
            __syncthreads();
            float4* p = reinterpret_cast<float4*>(o.pos + 3 * t0);
            float4* v = reinterpret_cast<float4*>(o.vel + 3 * t0);
            float4* c = reinterpret_cast<float4*>(o.acc + 3 * t0);
            const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                p[k * THREADS + tid] = stage[k * THREADS + tid];
                v[k * THREADS + tid] = zero;
                c[k * THREADS + tid] = zero;
            }
            longlong2* t = reinterpret_cast<longlong2*>(o.tag + t0);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const long long e = t0 + 2 * (k * THREADS + tid);
                t[k * THREADS + tid] = make_longlong2(e, e + 1);
            }
            __syncthreads();   // the stage is free for the next tile
        } else {
            // the last, partial tile: one slot at a time (unrolled, so the
            // arrays stay in registers)
#pragma unroll
            for (int j = 0; j < FILL_SLOTS; ++j) {
                const long long i = s0 + j;
                if (i >= a.slots) break;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    o.pos[3 * i + c] = pos[3 * j + c];
                    o.vel[3 * i + c] = 0.0f;
                    o.acc[3 * i + c] = 0.0f;
                }
                o.w[i] = w[j];
                o.age[i] = age[j];
                o.life[i] = life[j];
                o.alive[i] = static_cast<uint8_t>((alive >> (8 * j)) & 1u);
                o.parent[i] = 0;
                o.tag[i] = i;
            }
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

// A fresh n-body state of `slots` slots, n of them drawn (0 <= n <= slots):
// pos, vel, acc (slots, 3) and w, age, life (slots,) float32, alive and
// parent (slots,) bool, tag (slots,) int64, every pointer 16-byte aligned.
// (k1, k2) is the FILL purpose key, w0-w3 the split indices of the draws
// r, u_sign, age and life; half_extent, weight and the affine lo / span
// float32.
extern "C" int ps_nbody_fill(
    float* pos, float* vel, float* acc, float* w, float* age, float* life,
    unsigned char* alive, unsigned char* parent, long long* tag, long long n,
    long long slots, unsigned int k1, unsigned int k2, unsigned int w0,
    unsigned int w1, unsigned int w2, unsigned int w3, float half_extent,
    float weight, float age_lo, float age_span, float life_lo,
    float life_span, void* stream)
{
    if (n < 0 || n > slots) return static_cast<int>(cudaErrorInvalidValue);
    if (slots == 0) return 0;
    const void* ptrs[] = {pos, vel, acc, w, age, life, alive, parent, tag};
    for (const void* p : ptrs)
        if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0)
            return static_cast<int>(cudaErrorInvalidValue);
    const FillOut o{pos, vel, acc, w, age, life, alive, parent, tag};
    const FillArgs a{k1, k2, {w0, w1, w2, w3}, n, slots, half_extent,
                     weight, age_lo, age_span, life_lo, life_span};
    const long long groups = (slots + FILL_SLOTS - 1) / FILL_SLOTS;
    nbody_fill<<<blocks_for(groups), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(o, a);
    return static_cast<int>(cudaGetLastError());
}
