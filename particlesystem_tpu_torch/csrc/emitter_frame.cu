// The emitter engine's frame around the physics kernel, for Hopper (sm_90a).
//
// Replaces XLA's fusions of the JAX engine's jitted frame
// (particlesystem_tpu/runtime/engine.py:186 _frame; there is no Pallas
// kernel): the spawn rows of particlesystem_tpu/models/emitter.py:68
// spawn_fields with pack_spawn_rows(_slim) and the window's padding, the
// ring allocator's write particlesystem_tpu/ops/fused_step.py:181
// ring_spawn, and the frame's bookkeeping.  Computes what
// particlesystem_tpu_torch/ops/engine_kernels.py's plain versions compute
// (models/emitter.spawn_fields + fused_step.pack_spawn_rows(_slim) + the
// padding; fused_step.ring_spawn; the cursor's remainder and the copies),
// bit for bit.  Three entry points, launched in this order around the
// physics kernel (csrc/physics_step.cu), which reads the window they write:
//
//   ps_emitter_spawn  one thread a row j of the padded window of w rows:
//                     the frame's keys ku = fold_in(fold_in(purpose key,
//                     frame), salt) and kd = fold_in(ku, 1); the row's
//                     uniforms 0-4 of the (total, 8) draw under ku
//                     (counters 8j..8j+4) and its lattice unit vector
//                     under kd (counters 3j..3j+2); valid = the row's
//                     index in its emitter < floor(accum + rate); pos, vel
//                     and life (packed8, age 0) or the death frame
//                     frame + life * (1/dt) (slim), into rows (n_fields, w)
//                     and valid (w,); rows j >= total zero and invalid (with
//                     no emitter, row 0 is the plain version's placeholder:
//                     zeros, life 0).  accum' = want - floor(want) goes to
//                     a scratch (no emitter: accum copied), since every
//                     row reads accum while the launch runs.
//   ps_emitter_ring   one block: ranks the valid rows by a block scan over
//                     the window, writes the row of rank r at cursor + r
//                     (rows past n_real land in the shadow), then, when
//                     the write wrapped, copies the shadow's first
//                     cursor + nv - n_real rows onto the head and zeroes
//                     the shadow; cursor <- (cursor + nv) mod n_real.  The
//                     cursor is read by every thread before thread 0
//                     writes it, behind the block's __syncthreads().
//   ps_emitter_tail   one block: accum <- accum'; the strided and select
//                     allocators' cursor <- (cursor + w) mod slots (ring's
//                     moved in ps_emitter_ring); frame <- frame + 1, after
//                     every reader of the frame in the stream.
//
// The frame, the cursor and accum live in device memory, so a CUDA graph
// of the frame draws each replay's own randomness and carries its own
// bookkeeping; the per-row constants (models/emitter.SpawnTable) are one
// float32 table in device memory, column-major (column c of row j at
// c * total + j, then the emitters' rates), and the rows' emitter index.
//
// What bounds it on the card: nothing but a launch's latency.  On the
// bench scene (1,669 rows in a window of 2,048) the spawn kernel hashes
// 8 counters a row (13,352 hashes, ~72 integer instructions each) and
// moves ~200 KB; the ring write ~110 KB; the tail some 40 bytes: each is
// a fraction of a microsecond of the card's rates, against about one
// microsecond of latency for a kernel in a graph.  What the design does
// about it: it replaces some 45 small eager operations a frame (each a
// launch) with three launches (four for ring), with nothing intermediate
// in device memory: a row's hashes and its math stay in one thread.
//
// Exactness: the plain version on the card is torch's eager CUDA
// operations, each one rounding: the products and sums here are
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's order (no FMA
// contraction), the cube root is pow(double, 1/3) rounded once (what
// cbrt_f32's float64 pow does), the square root __fsqrt_rn (sqrt_f32's
// float64 root rounded once), sin and cos the float32 sinf and cosf that
// torch's float32 sin and cos call, and slim's life / dt the product
// life * (1/dt) with 1/dt rounded to float32 on the host, which is how
// torch's CUDA division by a Python scalar computes it.

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
constexpr int RING_THREADS = 1024;
constexpr int TAIL_THREADS = 128;
constexpr int MAX_FIELDS = 8;
// 2*pi rounded to float32 (models/emitter.TWO_PI)
constexpr float TWO_PI = 6.28318530717958647692f;

// the spawn table's columns (models/emitter.SpawnTable.COLUMNS)
enum Column : int {
    POS0 = 0,      // 3
    RADIUS = 3,
    BASIS = 4,     // 9: b0, b1, b2, 3 each
    CONE = 13,
    SPEED0 = 14,
    JITTER = 15,
    LMIN = 16,
    LSPAN = 17,
    LOCAL = 18,    // the row's index among its emitter's rows
    N_COLUMNS = 19
};

struct Fields {
    float* f[MAX_FIELDS];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(THREADS) emitter_spawn(
    const float* __restrict__ table, const int* __restrict__ row_emitter,
    int total, int n_emitters, const float* __restrict__ accum,
    float* __restrict__ accum_out, const long long* __restrict__ frame,
    Key purpose, uint32_t salt, float* __restrict__ rows,
    unsigned char* __restrict__ valid, int w, int slim, float inv_dt)
{
    // the frame's two keys, once a block
    __shared__ uint2 keys[2];
    if (threadIdx.x == 0) {
        const uint2 kf = at_frame(purpose, frame);
        const uint2 ku = threefry(kf.x, kf.y, 0u, salt);
        keys[0] = ku;
        keys[1] = threefry(ku.x, ku.y, 0u, 1u);
    }
    __syncthreads();
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= w) return;
    const long long t = total;
    if (j < n_emitters) {
        const float want = add(accum[j], table[N_COLUMNS * t + j]);
        accum_out[j] = sub(want, floorf(want));
    } else if (n_emitters == 0 && j == 0) {
        accum_out[0] = accum[0];
    }

    // x, y, z, vx, vy, vz, age (packed8) or death (slim), life
    float out[MAX_FIELDS] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    bool ok = false;
    if (j < total) {
        const uint2 ku = keys[0];
        const uint2 kd = keys[1];
        const unsigned long long c = 8ull * j;
        const float u0 = uniform(ku.x, ku.y, c);
        const float u1 = uniform(ku.x, ku.y, c + 1);
        const float u2 = uniform(ku.x, ku.y, c + 2);
        const float u3 = uniform(ku.x, ku.y, c + 3);
        const float u4 = uniform(ku.x, ku.y, c + 4);
        float dir[3];
        const unsigned long long d = 3ull * j;
        lattice(uniform(kd.x, kd.y, d), uniform(kd.x, kd.y, d + 1),
                uniform(kd.x, kd.y, d + 2), dir);
        const auto col = [&](int k) { return table[k * t + j]; };

        const int e = row_emitter[j];
        const float want = add(accum[e], table[N_COLUMNS * t + e]);
        ok = col(LOCAL) < floorf(want);

        // position: uniform in a ball of radius around pos0
        const float r = mul(col(RADIUS),
                            __double2float_rn(pow(static_cast<double>(u0),
                                                  1.0 / 3.0)));
#pragma unroll
        for (int k = 0; k < 3; ++k) out[k] = add(col(POS0 + k), mul(dir[k], r));
        // velocity: cone around the emitter direction
        const float theta = mul(col(CONE), __fsqrt_rn(u1));
        const float phi = mul(TWO_PI, u2);
        const float ct = cosf(theta);
        const float st = sinf(theta);
        const float a1 = mul(st, cosf(phi));
        const float a2 = mul(st, sinf(phi));
        const float speed = mul(col(SPEED0),
                                add(1.0f, mul(col(JITTER),
                                              sub(mul(2.0f, u3), 1.0f))));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float dv = add(add(mul(ct, col(BASIS + k)),
                                     mul(a1, col(BASIS + 3 + k))),
                                 mul(a2, col(BASIS + 6 + k)));
            out[3 + k] = mul(dv, speed);
        }
        out[7] = add(col(LMIN), mul(u4, col(LSPAN)));
    }
    valid[j] = ok;
    // slim: the death frame of every packed row (with no emitter, the
    // placeholder row 0: frame + 0)
    if (slim && j < (total > 0 ? total : 1))
        out[6] = add(__ll2float_rn(*frame), mul(out[7], inv_dt));
    const int nf = slim ? 7 : 8;
#pragma unroll
    for (int f = 0; f < MAX_FIELDS; ++f)
        if (f < nf) rows[static_cast<long long>(f) * w + j] = out[f];
}

__global__ void __launch_bounds__(RING_THREADS) emitter_ring(
    Fields fs, int nf, long long n_real, const float* __restrict__ rows,
    const unsigned char* __restrict__ valid, int w, int* __restrict__ cursor)
{
    constexpr int WARPS = RING_THREADS / 32;
    static_assert(WARPS == 32, "one warp scans the warps' counts");
    __shared__ int before[WARPS];
    __shared__ int chunk;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long c = *cursor;
    int nv = 0;
    for (int start = 0; start < w; start += RING_THREADS) {
        const int j = start + threadIdx.x;
        const bool v = j < w && valid[j];
        const unsigned ballot = __ballot_sync(0xffffffffu, v);
        if (lane == 0) before[warp] = __popc(ballot);
        __syncthreads();
        if (warp == 0) {
            const int own = before[lane];
            int x = own;
#pragma unroll
            for (int dd = 1; dd < 32; dd <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, x, dd);
                if (lane >= dd) x += y;
            }
            before[lane] = x - own;
            if (lane == 31) chunk = x;
        }
        __syncthreads();
        if (v) {
            const long long p =
                c + nv + before[warp] + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
            for (int f = 0; f < MAX_FIELDS; ++f)
                if (f < nf) fs.f[f][p] = rows[static_cast<long long>(f) * w + j];
        }
        nv += chunk;
        // the counts are reused, and the writes must be seen by the fold
        __syncthreads();
    }
    const long long wrapped = c + nv - n_real;
    if (wrapped > 0) {   // the same branch for every thread of the block
        const long long fold = wrapped < n_real ? wrapped : n_real;
        for (long long i = threadIdx.x; i < fold; i += RING_THREADS) {
#pragma unroll
            for (int f = 0; f < MAX_FIELDS; ++f)
                if (f < nf) fs.f[f][i] = fs.f[f][n_real + i];
        }
        __syncthreads();
        for (long long i = threadIdx.x; i < w; i += RING_THREADS) {
#pragma unroll
            for (int f = 0; f < MAX_FIELDS; ++f)
                if (f < nf) fs.f[f][n_real + i] = 0.f;
        }
    }
    if (threadIdx.x == 0) *cursor = static_cast<int>((c + nv) % n_real);
}

__global__ void __launch_bounds__(TAIL_THREADS) emitter_tail(
    float* __restrict__ accum, const float* __restrict__ accum_next,
    int n_accum, int* __restrict__ cursor, int advance, long long slots,
    long long* __restrict__ frame)
{
    for (int i = threadIdx.x; i < n_accum; i += TAIL_THREADS)
        accum[i] = accum_next[i];
    if (threadIdx.x == 0) {
        if (advance)
            *cursor = static_cast<int>(
                (static_cast<long long>(*cursor) + advance) % slots);
        *frame += 1;
    }
}

}  // namespace

// The padded spawn window of the frame *frame (a device int64): table
// (N_COLUMNS * total + n_emitters) float32 and row_emitter (total,) int32
// on the device; accum (max(1, n_emitters),) read, accum_out written;
// (pk1, pk2) the EMIT purpose key of the scene's seed and salt the word
// folded in after the frame; rows (7 or 8, w) float32 and valid (w,) bytes
// written; inv_dt the float32 1/dt (slim only).
extern "C" int ps_emitter_spawn(
    const float* table, const int* row_emitter, int total, int n_emitters,
    const float* accum, float* accum_out, const long long* frame,
    unsigned int pk1, unsigned int pk2, unsigned int salt, float* rows,
    unsigned char* valid, int w, int slim, float inv_dt, void* stream)
{
    if (total < 0 || n_emitters < 0 || (total == 0) != (n_emitters == 0)
        || w < (total > 0 ? total : 1) || frame == nullptr
        || accum == nullptr || accum_out == nullptr || rows == nullptr
        || valid == nullptr || (total > 0 && (table == nullptr
                                              || row_emitter == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (w + THREADS - 1) / THREADS;
    emitter_spawn<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        table, row_emitter, total, n_emitters, accum, accum_out, frame,
        Key{pk1, pk2}, salt, rows, valid, w, slim, inv_dt);
    return static_cast<int>(cudaGetLastError());
}

// The ring allocator's write of the window rows (nf, w) / valid (w,) into
// the nf fields of n_real + w slots each, at the device int32 *cursor,
// which it advances.
extern "C" int ps_emitter_ring(
    float* f0, float* f1, float* f2, float* f3, float* f4, float* f5,
    float* f6, float* f7, int nf, long long n_real, const float* rows,
    const unsigned char* valid, int w, int* cursor, void* stream)
{
    if (nf < 7 || nf > MAX_FIELDS || n_real <= 0 || w <= 0
        || cursor == nullptr || rows == nullptr || valid == nullptr
        || (nf == 8 && f7 == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Fields fs = {{f0, f1, f2, f3, f4, f5, f6, f7}};
    emitter_ring<<<1, RING_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        fs, nf, n_real, rows, valid, w, cursor);
    return static_cast<int>(cudaGetLastError());
}

// The frame's bookkeeping: accum (n_accum,) <- accum_next; the device
// int32 *cursor <- (*cursor + advance) mod slots when advance is not 0;
// the device int64 *frame <- *frame + 1.
extern "C" int ps_emitter_tail(
    float* accum, const float* accum_next, int n_accum, int* cursor,
    int advance, long long slots, long long* frame, void* stream)
{
    if (n_accum < 1 || advance < 0 || (advance && (cursor == nullptr
                                                   || slots <= 0))
        || frame == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    emitter_tail<<<1, TAIL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        accum, accum_next, n_accum, cursor, advance, slots, frame);
    return static_cast<int>(cudaGetLastError());
}
