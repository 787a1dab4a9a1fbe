// The n-body frame's per-row work around the pair kernel, for Hopper
// (sm_90a): binning, snapshot, chunk table, lifecycle and spawn.
//
// Replaces XLA's fusions of the JAX package's jitted frame,
// particlesystem_tpu/models/nbody.py::step_fields (:271-331) with
// impl="blocks": the torus wrap and cell ids (ops/grid.py:34-60), prepare
// (ops/neighbor_blocks.py:118-295) less its lax.sort, unsort_outputs
// (:520-541) and lifecycle_update (models/nbody.py:117-268).  There is no
// Pallas kernel here; the port's plain versions, which these kernels equal
// bit for bit, are ops/frame_kernels.py's *_plain functions, built on
// ops/grid.py, ops/neighbor_blocks.py, models/nbody.py and ops/compact.py.
// The frame on the card is
//
//   A ps_nbody_cells     one thread a slot: wrap, cell, sort key
//                        alive ? cell : num_cells (int32) and, where the
//                        frame's rows outgrow the L2 cache, the slot's
//                        32-byte record {x, y, z, w, age, okey(tag), slot,
//                        0} (int32 bits), written for every slot, dead
//                        ones too: a dead row's snapshot carries its raw
//                        position and its age gates its collision key;
//                        without records a dead slot's position is not
//                        read
//     torch.sort(key, stable=True)
//   B ps_cell_starts     one thread a sorted row: starts[k] = r for k in
//                        (skey[r-1], skey[r]]; nothing else, so no block
//                        waits on another
//   C ps_block_prepare   one CTA a block of b sorted rows, 4 consecutive
//                        rows a thread: the snapshot f (7, N) and i (2, N)
//                        from one record a row gathered through order (or,
//                        without records, from the state's arrays), the
//                        in-cell rank and overflow, the out-of-band bands,
//                        the inverse permutation inv[order[r]] = r, the
//                        block's valid cell range, its 9 stencil ranges and
//                        its chunk table (NB, c_max, 4); and the counts:
//                        the row that ends a cell holds the cell's count
//                        (rank + 1), which goes into the largest cell (one
//                        atomicMax a block) and, on the cubic grid, into
//                        its chunk's counter
//     the pair kernel (neighbor_blocks.cu)
//   D ps_nbody_lifecycle one thread a slot, slot order: the pair outputs
//                        read through inv (the pass may have more rows
//                        than the slots: a rank's halo and padding rows
//                        follow its own), kill/touch and the mine-side
//                        age window, the five flags, clamped Euler, the
//                        wrap (pos_w is recomputed here from pos), aging,
//                        explosion; explode/free flags and their counts a
//                        tile of 256 slots; its block 0 reduces C's chunk
//                        counters (where the pass has them: the cubic
//                        grid's) to the largest chunk and zeroes them
//   E ps_nbody_spawn     a memset of its status words, then two kernels.
//                        spawn_rank: one pass with a decoupled look-back
//                        (Merrill and Garland 2016), a block a tile of
//                        4096 slots; the tile's prefix of exploding and
//                        free slots from the tiles' status words (or D's
//                        counts), its slots ranked against the budget e =
//                        min(max_spawns, n) into the tables src[i] and
//                        tgt[i]; the last tile writes the statistics, k =
//                        min(n_child, n_free, e) among them.  spawn_write
//                        (a dependent launch): child i of src[i] into
//                        tgt[i] for i < k, k read on the device.
//
// Statistics go into one int64 buffer (ops/frame_kernels.STATS; zeroed by
// the wrapper), by integer atomics only, so they do not depend on the order
// in which blocks run.
//
// In place: D may write the state it reads (out == in), since each thread
// reads its slot's fields before it writes them and touches no other slot;
// E reads exploding parents and writes free slots, which are disjoint.  So
// D's and E's state pointers are not __restrict__.
//
// Exactness: every float operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn) in the plain version's order, so nvcc
// contracts nothing into an FMA: vel*dt + ((0.5*acc)*dt)*dt, then the clamp,
// pos + dx, the wrap's shift d*cell_size (d negated first on the y and z
// axes), vel + acc*dt, age + dt, uvec*speed.  The clamps pass NaN through
// as torch.clamp does.  Records carry floats as their bits, ids and tags
// as integers.
//
// What bounds them on the card: bytes.  A reads 13 bytes a slot and writes
// 4, or with records reads 29 and writes 36; B reads 4 a row; C reads 12 a
// row in order, gathers 28 through order (one 32-byte record, or pos, age,
// w and tag from their arrays) and writes 41; D 79 in (gathered through
// inv) and 51 out,
// E 8 bytes of counts a 256 slots, a byte a slot of the tiles it ranks
// and some 100 a child.  The design keeps each pass to one read of its
// inputs: no intermediate touches device memory, every mask and count
// lives in registers, a block reduces in registers before it touches
// shared or global memory, C's 9 ranges are 9 threads (each range's start
// is clipped by the previous range's end, which has a closed form).  E's
// ranks are one pass whose blocks never wait on another block, so no block
// sits alone on the card and no launch waits for a scan; a tile whose
// prefix holds e or more of each kind it has leaves before it reads its
// flags.  Its status words are zeroed by a memset on the same stream
// (a node of the frame's graph), never by the host.  On a plateau frame (a
// few children) E is bounded by the latency of its chain (memset, counts,
// look-back, flags, tables, then the write kernel's reads), not by bytes;
// on a burst frame by the children's scattered sectors: each child reads
// its parent's four arrays and writes nine, a sector or more each, where
// the bytes count 94.  A gathered row moves whole 32-byte sectors:
// C's record is one sector where the state's arrays cost four or five.
// That pays only where the arrays outgrow the L2 cache (the frame's rows
// times 28 bytes, ops/frame_kernels.records_pay): below it the gathers hit
// the L2 and the record's 32 bytes written and read a slot cost more than
// they save, so A writes none and C gathers the arrays.  Each of C's
// threads starts the loads of its four rows before it uses any.  D still
// gathers through inv.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // A, B, D, E: threads a block
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;          // slots a tile of D's counts (D's
                                       // block; ops/frame_kernels.TILE)
constexpr int SPAWN_TILE = 4096;       // slots a ranking tile of E
                                       // (ops/frame_kernels.SPAWN_TILE)
constexpr int SPAWN_PASSES = SPAWN_TILE / THREADS;   // flags a thread
static_assert(SPAWN_PASSES % 16 == 0, "E loads its flags 16 at a time");
constexpr int DIRECT = 4096;           // E: most of D's counts a block
                                       // sums for its prefix, no look-back
constexpr int WRITE_BLOCKS = 1;        // E's write blocks an SM
constexpr int WRITE_BATCH = 4;         // E's children a thread at a time
constexpr int PREP_THREADS = 128;      // C: threads a block
constexpr int ROWS = 4;                // C: consecutive sorted rows a thread
constexpr int R = 9;                   // stencil ranges a block
constexpr long long ALIGN = 128;       // chunk starts align to 128 columns
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

// the statistics buffer, in ops/frame_kernels.STATS order; then one
// counter a chunk
enum Stat {
    N_ALIVE, N_AGE_DEATHS, N_COLLISION_KILLS, N_OVERFLOW_KILLS, N_SURVIVALS,
    N_SPAWNED, N_SPAWN_CAPPED, N_LISTED_DROPPED, MAX_CELL, MAX_CHUNK,
    N_TAIL_ALIVE, N_STATS
};

struct Grid {
    int g, half;
    float inv, cs;   // float32(1 / cell_size), float32(cell_size)
};

struct State {
    float *pos, *vel, *acc, *w, *age, *life;
    unsigned char *alive, *parent;
    long long* tag;
};

struct Prep {
    long long n;
    int b, num_cells, row_stride, plane_stride, cap, c_max, ch;
    int g, cd, cf;   // the cubic grid's chunks (cf = 0: none counted)
    float kid_age, life;
    int offs[R];     // the stencil's cell offsets, ascending
};

// where C reads a sorted row's fields: A's records (two int4 a slot), or,
// with rec null, the state's arrays (the frame below the L2, and prepare)
struct Rows {
    const int4* rec;
    const float *pos, *age, *w;
    const long long* tags;
    const int* ids;   // null: the slot
};

// a row's fields as bits: x, y, z, w, age, okey(tag), id
struct Row {
    int v[7];
};

struct Life {
    long long n;
    float dt, life, kid_age, max_dx, max_v, speed;
    Grid gr;
};

__device__ __forceinline__ void add_stat(long long* stats, int i, long long v)
{
    if (v)
        atomicAdd(reinterpret_cast<unsigned long long*>(stats + i),
                  static_cast<unsigned long long>(v));
}

__device__ __forceinline__ int floor_mod(int a, int m)
{
    const int r = a % m;
    return r < 0 ? r + m : r;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi)
{
    return x < lo ? lo : (x > hi ? hi : x);
}

// ops/neighbor.collision_okey: the tag's low 32 bits as int32, INT32_MIN
// lifted to INT32_MIN + 1
__device__ __forceinline__ int okey(long long tag)
{
    const int k = static_cast<int>(static_cast<uint32_t>(tag));
    return k == INT_MIN ? INT_MIN + 1 : k;
}

// ops/grid.wrap_positions: (x, y, z) shifted by whole cells into the box;
// returns the wrapped (i1, i2, i3)
__device__ __forceinline__ int3 wrap(float& x, float& y, float& z,
                                     const Grid& gr)
{
    const int i1 = static_cast<int>(floorf(__fmul_rn(-y, gr.inv))) + gr.half;
    const int i2 = static_cast<int>(floorf(__fmul_rn(x, gr.inv))) + gr.half;
    const int i3 = static_cast<int>(floorf(__fmul_rn(-z, gr.inv))) + gr.half;
    const int w1 = floor_mod(i1, gr.g);
    const int w2 = floor_mod(i2, gr.g);
    const int w3 = floor_mod(i3, gr.g);
    x = __fadd_rn(x, __fmul_rn(static_cast<float>(w2 - i2), gr.cs));
    y = __fadd_rn(y, __fmul_rn(-static_cast<float>(w1 - i1), gr.cs));
    z = __fadd_rn(z, __fmul_rn(-static_cast<float>(w3 - i3), gr.cs));
    return make_int3(w1, w2, w3);
}

// the largest of the block's non-negative values, in every thread
__device__ long long block_max(long long v)
{
    __shared__ long long part[32];
#pragma unroll
    for (int o = 16; o; o >>= 1) v = max(v, __shfl_down_sync(FULL, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0;
    for (int i = 0; i < (blockDim.x >> 5); ++i) v = max(v, part[i]);
    return v;
}

// A: the sort key of every slot and, unless rec is null, its record
__global__ void __launch_bounds__(THREADS) nbody_cells(
    const float* __restrict__ pos, const unsigned char* __restrict__ alive,
    const float* __restrict__ age, const float* __restrict__ w,
    const long long* __restrict__ tags, long long n, Grid gr,
    int* __restrict__ key, int4* __restrict__ rec)
{
    const long long s = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x;
    if (s >= n) return;
    const bool live = alive[s];
    // without records a dead slot's position is not read
    if (!live && !rec) {
        key[s] = gr.g * gr.g * gr.g;
        return;
    }
    float x = pos[3 * s], y = pos[3 * s + 1], z = pos[3 * s + 2];
    if (rec) {
        rec[2 * s] = make_int4(__float_as_int(x), __float_as_int(y),
                               __float_as_int(z), __float_as_int(w[s]));
        rec[2 * s + 1] = make_int4(__float_as_int(age[s]), okey(tags[s]),
                                   static_cast<int>(s), 0);
    }
    if (!live) {
        key[s] = gr.g * gr.g * gr.g;
        return;
    }
    const int3 c = wrap(x, y, z, gr);
    key[s] = (c.z * gr.g + c.x) * gr.g + c.y;
}

// B: starts = searchsorted(skey, arange(num_cells + 2)): the thread of
// row r writes the starts of the keys in (skey[r-1], skey[r]], each key's
// once
__global__ void __launch_bounds__(THREADS) cell_starts(
    const int* __restrict__ skey, long long n, int num_cells,
    int* __restrict__ starts)
{
    const long long r = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x;
    if (r > n) return;
    const int lo = r == 0 ? -1 : skey[r - 1];
    const int hi = r == n ? num_cells + 1 : skey[r];
    for (int k = lo + 1; k <= hi; ++k) starts[k] = static_cast<int>(r);
}

// the chunk of cell k of the cubic grid (ops/grid.chunk_occupancy's order)
__device__ __forceinline__ int chunk_of(int k, const Prep& p)
{
    const int i3 = k / (p.g * p.g), rem = k % (p.g * p.g);
    return ((i3 / p.cd) * p.cf + rem / p.g / p.cd) * p.cf + rem % p.g / p.cd;
}

template <bool RECORD>
__device__ __forceinline__ Row load_row(const Rows& s, long long o)
{
    if constexpr (RECORD) {
        const int4 a = __ldg(s.rec + 2 * o), b = __ldg(s.rec + 2 * o + 1);
        return Row{{a.x, a.y, a.z, a.w, b.x, b.y, b.z}};
    } else {
        return Row{{__float_as_int(__ldg(s.pos + 3 * o)),
                    __float_as_int(__ldg(s.pos + 3 * o + 1)),
                    __float_as_int(__ldg(s.pos + 3 * o + 2)),
                    __float_as_int(__ldg(s.w + o)),
                    __float_as_int(__ldg(s.age + o)), okey(__ldg(s.tags + o)),
                    s.ids ? __ldg(s.ids + o) : static_cast<int>(o)}};
    }
}

// C: the kernel inputs of one block of p.b sorted rows (p.b a multiple of
// ROWS), ROWS consecutive rows a thread
template <bool RECORD>
__global__ void __launch_bounds__(PREP_THREADS) block_prepare(
    Rows src, const int* __restrict__ skey,
    const long long* __restrict__ order, const int* __restrict__ starts,
    Prep p, float* __restrict__ f, int* __restrict__ iout,
    int* __restrict__ chunks, int* __restrict__ inv,
    unsigned char* __restrict__ overflow_s, long long* stats)
{
    __shared__ int cmin, cmax, occ;
    __shared__ long long astart[R], lead[R], tot[R], cum[R];
    __shared__ int nact;
    if (threadIdx.x == 0) {
        cmin = BIG;
        cmax = -BIG;
        occ = 0;
    }
    __syncthreads();
    const long long n = p.n;
    const long long r0 = static_cast<long long>(blockIdx.x) * p.b;
    unsigned long long* chunk =
        reinterpret_cast<unsigned long long*>(stats + N_STATS);
    int lmin = BIG, lmax = -BIG, best = 0;
    for (int t = ROWS * threadIdx.x; t < p.b; t += ROWS * PREP_THREADS) {
        const long long r = r0 + t;
        // every load of the thread's rows before any use: the keys and the
        // order as vectors, then each row's fields and its cell's bounds
        const int4 k4 = *reinterpret_cast<const int4*>(skey + r);
        const longlong2 oa = *reinterpret_cast<const longlong2*>(order + r);
        const longlong2 ob =
            *reinterpret_cast<const longlong2*>(order + r + 2);
        const int sk[ROWS] = {k4.x, k4.y, k4.z, k4.w};
        const long long o[ROWS] = {oa.x, oa.y, ob.x, ob.y};
        Row row[ROWS];
        int first[ROWS], next[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            row[i] = load_row<RECORD>(src, o[i]);
            first[i] = __ldg(starts + sk[i]);
            next[i] = __ldg(starts + sk[i] + 1);
        }
        float out[7][ROWS];
        int id[ROWS], cg[ROWS];
        unsigned char ovf[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            const long long ri = r + i;
            inv[o[i]] = static_cast<int>(ri);
            const int rank = static_cast<int>(ri - first[i]);
            const bool in_grid = sk[i] < p.num_cells;
            const bool valid = in_grid && rank < p.cap;
            ovf[i] = in_grid && rank >= p.cap;
            const float a = __int_as_float(row[i].v[4]);
            const bool ok = valid && a >= p.kid_age;
            const float base = valid ? -10.0f : -4194304.0f;
            const float bad_a = __fsub_rn(
                base, static_cast<float>(2 * static_cast<int>(ri % 524288)));
            const float bad_b = __fsub_rn(
                base, static_cast<float>(2 * static_cast<int>(ri % 524287)));
            const int i3 = sk[i] / p.plane_stride;
            const int rem = sk[i] % p.plane_stride;
            out[0][i] = __int_as_float(row[i].v[0]);
            out[1][i] = __int_as_float(row[i].v[1]);
            out[2][i] = __int_as_float(row[i].v[2]);
            out[3][i] = ok ? static_cast<float>(rem / p.row_stride) : bad_a;
            out[4][i] = ok ? static_cast<float>(rem % p.row_stride) : bad_b;
            out[5][i] = ok ? static_cast<float>(i3) : bad_a;
            out[6][i] = __int_as_float(row[i].v[3]);
            id[i] = row[i].v[6];
            cg[i] = a <= p.life ? row[i].v[5] : INT_MIN;
            if (valid) {
                lmin = min(lmin, sk[i]);
                lmax = max(lmax, sk[i]);
            }
            // the row that ends its cell holds the cell's count
            if (in_grid && ri + 1 == next[i]) {
                best = max(best, rank + 1);
                if (p.cf)
                    atomicAdd(chunk + chunk_of(sk[i], p),
                              static_cast<unsigned long long>(rank + 1));
            }
        }
#pragma unroll
        for (int k = 0; k < 7; ++k)
            *reinterpret_cast<float4*>(f + k * n + r) =
                make_float4(out[k][0], out[k][1], out[k][2], out[k][3]);
        *reinterpret_cast<int4*>(iout + r) =
            make_int4(id[0], id[1], id[2], id[3]);
        *reinterpret_cast<int4*>(iout + n + r) =
            make_int4(cg[0], cg[1], cg[2], cg[3]);
        *reinterpret_cast<uchar4*>(overflow_s + r) =
            make_uchar4(ovf[0], ovf[1], ovf[2], ovf[3]);
    }
    lmin = __reduce_min_sync(FULL, lmin);
    lmax = __reduce_max_sync(FULL, lmax);
    best = __reduce_max_sync(FULL, best);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(&cmin, lmin);
        atomicMax(&cmax, lmax);
        atomicMax(&occ, best);
    }
    __syncthreads();
    if (threadIdx.x == R && occ)   // the largest cell: one atomic a block
        atomicMax(reinterpret_cast<unsigned long long*>(stats + MAX_CELL),
                  static_cast<unsigned long long>(occ));
    if (threadIdx.x < R) {
        // range q of the 9, ascending, its start clipped past the previous
        // ranges' end: their ends ascend with the offsets, so that end is
        // range q-1's own
        const int q = threadIdx.x;
        // p.offs[q] and p.offs[q - 1] by constant indices, which keeps p
        // out of local memory
        int off = 0, off_prev = 0;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            if (k == q) off = p.offs[k];
            if (k + 1 == q) off_prev = p.offs[k];
        }
        const bool empty = cmax < cmin;
        const long long prev_hi =
            q ? static_cast<long long>(cmax) + 1 + off_prev : -BIG;
        const long long lo = max(static_cast<long long>(cmin) - 1 + off,
                                 prev_hi + 1);
        const long long hi = static_cast<long long>(cmax) + 1 + off;
        const long long rs = starts[min(max(lo, 0ll),
                                        (long long)p.num_cells)];
        const long long re = starts[min(max(hi + 1, 0ll),
                                        (long long)p.num_cells)];
        const long long count = !empty && re > rs ? re - rs : 0;
        astart[q] = rs / ALIGN * ALIGN;
        lead[q] = rs - astart[q];
        tot[q] = lead[q] + count;
        cum[q] = count > 0 ? (tot[q] + p.ch - 1) / p.ch : 0;   // chunks
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long c = 0;
        for (int q = 0; q < R; ++q) cum[q] = c += cum[q];   // inclusive
        if (c > p.c_max) add_stat(stats, N_LISTED_DROPPED, c - p.c_max);
        nact = static_cast<int>(min(c, static_cast<long long>(p.c_max)));
    }
    __syncthreads();
    for (int j = threadIdx.x; j < p.c_max; j += PREP_THREADS) {
        int4 row = make_int4(0, 0, 0, nact);
        if (j < nact) {
            int q = 0;
            while (cum[q] <= j) ++q;   // searchsorted(cum, j, right=True)
            const long long c_in = j - (q ? cum[q - 1] : 0);
            row.x = static_cast<int>(astart[q] + c_in * p.ch);
            row.y = static_cast<int>(min(max(lead[q] - c_in * p.ch, 0ll),
                                         (long long)p.ch));
            row.z = static_cast<int>(min(max(tot[q] - c_in * p.ch, 0ll),
                                         (long long)p.ch));
        }
        reinterpret_cast<int4*>(chunks)[
            static_cast<long long>(blockIdx.x) * p.c_max + j] = row;
    }
}

// D: the lifecycle of every slot, in slot order
__global__ void __launch_bounds__(THREADS) nbody_lifecycle(
    State in, State out, const float* __restrict__ acc_s, long long n_rows,
    const int* __restrict__ gmax_s,
    const unsigned char* __restrict__ overflow_s,
    const int* __restrict__ inv, const float* __restrict__ uvec, Life c,
    int n_chunks, unsigned char* __restrict__ flags, int* __restrict__ tiles,
    long long* stats)
{
    __shared__ int counts[7];
    if (threadIdx.x < 7) counts[threadIdx.x] = 0;
    __syncthreads();
    const long long n = c.n;
    const long long s = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x;
    bool die_age = false, die_coll = false, ovf = false, survive = false;
    bool alive2 = false, explode = false;
    if (s < n) {
        // every read of the slot before any write (out may be in)
        const int q = inv[s];
        const float a[3] = {acc_s[q], acc_s[n_rows + q],
                            acc_s[2 * n_rows + q]};
        const int gm = gmax_s[q];
        ovf = overflow_s[q];
        float p[3] = {in.pos[3 * s], in.pos[3 * s + 1], in.pos[3 * s + 2]};
        const float v[3] = {in.vel[3 * s], in.vel[3 * s + 1],
                            in.vel[3 * s + 2]};
        const float w0 = in.w[s], age0 = in.age[s], life0 = in.life[s];
        const bool alive = in.alive[s], parent0 = in.parent[s];
        const long long tag = in.tag[s];

        const bool win = age0 >= c.kid_age && age0 <= c.life;
        const bool kill = gm > okey(tag) && win;
        const bool touch = gm > INT_MIN && win;
        const bool alive1 = alive && !ovf;
        die_age = alive1 && age0 > c.life;
        die_coll = alive1 && !die_age && kill;
        const bool dead_now = die_age || die_coll || ovf;
        survive = alive1 && !die_age && !die_coll && touch;
        const bool normal = alive1 && !die_age && !die_coll && !survive;
        const float age1 = __fadd_rn(age0, c.dt);
        explode = normal && age1 >= life0 && !parent0;
        alive2 = alive1 && !dead_now;

        float np[3], nv[3];
        if (normal) {
            for (int k = 0; k < 3; ++k) {
                float dx = __fadd_rn(
                    __fmul_rn(v[k], c.dt),
                    __fmul_rn(__fmul_rn(__fmul_rn(0.5f, a[k]), c.dt), c.dt));
                np[k] = __fadd_rn(p[k], clampf(dx, -c.max_dx, c.max_dx));
                nv[k] = clampf(__fadd_rn(v[k], __fmul_rn(a[k], c.dt)),
                               -c.max_v, c.max_v);
            }
            wrap(np[0], np[1], np[2], c.gr);
        } else if (dead_now) {
            np[0] = np[1] = np[2] = 0.0f;
        } else {
            wrap(p[0], p[1], p[2], c.gr);   // pos_w
            np[0] = p[0];
            np[1] = p[1];
            np[2] = p[2];
        }
        if (!normal)
            for (int k = 0; k < 3; ++k)
                nv[k] = dead_now || survive ? 0.0f : v[k];
        if (explode)
            for (int k = 0; k < 3; ++k)
                nv[k] = __fmul_rn(uvec[3 * s + k], c.speed);
        for (int k = 0; k < 3; ++k) {
            out.pos[3 * s + k] = np[k];
            out.vel[3 * s + k] = nv[k];
            out.acc[3 * s + k] = normal ? a[k] : 0.0f;
        }
        out.age[s] = normal ? age1 : (dead_now || survive ? 0.0f : age0);
        out.w[s] = dead_now ? 0.0f : w0;
        out.life[s] = dead_now ? 0.0f : life0;
        out.alive[s] = alive2;
        out.parent[s] = (!(dead_now || survive) && parent0) || explode;
        if (out.tag != in.tag) out.tag[s] = tag;
        flags[s] = static_cast<unsigned char>(explode | (!alive2 << 1));
    }
    const bool free_slot = s < n && !alive2;
    const bool mine[7] = {die_age, die_coll, ovf, survive, alive2, explode,
                          free_slot};
    int m[7];
    for (int k = 0; k < 7; ++k) m[k] = __popc(__ballot_sync(FULL, mine[k]));
    if ((threadIdx.x & 31) == 0)
        for (int k = 0; k < 7; ++k)
            if (m[k]) atomicAdd(&counts[k], m[k]);
    __syncthreads();
    if (threadIdx.x < 5) {
        const int slot[5] = {N_AGE_DEATHS, N_COLLISION_KILLS,
                             N_OVERFLOW_KILLS, N_SURVIVALS, N_ALIVE};
        add_stat(stats, slot[threadIdx.x], counts[threadIdx.x]);
    } else if (threadIdx.x < 7) {
        tiles[2 * blockIdx.x + threadIdx.x - 5] = counts[threadIdx.x];
    }
    if (blockIdx.x || !n_chunks) return;
    // block 0: the largest of C's chunk counters, which it leaves zero, so
    // that the next frame (or a timing loop) counts from zero too
    unsigned long long* chunk =
        reinterpret_cast<unsigned long long*>(stats + N_STATS);
    long long most = 0;
    for (int k = threadIdx.x; k < n_chunks; k += THREADS)
        most = max(most, static_cast<long long>(chunk[k]));
    most = block_max(most);   // every thread's reads are done
    if (threadIdx.x == 0) stats[MAX_CHUNK] = most;
    for (int k = threadIdx.x; k < n_chunks; k += THREADS) chunk[k] = 0;
}

// E's status word of a ranking tile: bits 62-63 the status (0 not yet
// published, AGG the tile's own counts, PRE its inclusive prefix), bits
// 31-61 the exploding and bits 0-30 the free slots, so a sum of counts
// never carries into the next field while n < 2^31 (the wrapper refuses
// more).  A word carries all that its reader takes from it, so the loads
// and stores are relaxed: no other data is published with it.
constexpr unsigned long long ST_AGG = 1ull << 62, ST_PRE = 2ull << 62;
constexpr unsigned long long COUNT_MASK = (1ull << 31) - 1;
constexpr int SUBTILES = SPAWN_TILE / TILE;   // D's tiles in one of E's
static_assert(SUBTILES <= 32, "a warp sums one of E's tiles, a lane each");

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p)
{
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v)
{
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long pack_counts(int ex, int fr)
{
    return static_cast<unsigned long long>(ex) << 31
           | static_cast<unsigned>(fr);
}

// (explode, free) counts summed over the warp, packed as in a status word
__device__ __forceinline__ unsigned long long warp_sum_counts(
    unsigned long long v)
{
    const unsigned ex = __reduce_add_sync(
        FULL, static_cast<unsigned>(v >> 31 & COUNT_MASK));
    const unsigned fr = __reduce_add_sync(
        FULL, static_cast<unsigned>(v & COUNT_MASK));
    return static_cast<unsigned long long>(ex) << 31 | fr;
}

// ranking tile j's counts, summed by one thread from D's
__device__ __forceinline__ unsigned long long counts_of(
    const int2* __restrict__ tiles, int n_tiles, int j)
{
    int ex = 0, fr = 0;
#pragma unroll
    for (int q = 0; q < SUBTILES; ++q) {
        const int d = j * SUBTILES + q;
        if (d < n_tiles) {
            const int2 c = tiles[d];
            ex += c.x;
            fr += c.y;
        }
    }
    return pack_counts(ex, fr);
}

// tile t's inclusive prefix published, the tile's prefix and counts into
// shared memory; the last tile, whose prefix is the totals, writes the
// statistics, k among them
__device__ __forceinline__ void publish(
    unsigned long long* status, int t, unsigned long long before,
    unsigned long long own, int e, long long* stats,
    unsigned long long* tile_before, unsigned long long* tile_counts)
{
    store_status(status + t, ST_PRE | (before + own));
    *tile_before = before;
    *tile_counts = own;
    if (t == gridDim.x - 1) {
        const long long total = before + own;
        const long long n_child = total >> 31;
        const long long n_free = total & COUNT_MASK;
        const long long k = min(min(n_child, n_free),
                                static_cast<long long>(e));
        stats[N_SPAWNED] = k;
        stats[N_SPAWN_CAPPED] = min(n_child, static_cast<long long>(e)) - k;
        add_stat(stats, N_ALIVE, k);
    }
}

// exclusive prefix sums over the block of (lo, hi), packed lo | hi << 16
// (each sum < 2^16); called by every thread
__device__ __forceinline__ int block_exclusive_scan(int lo, int hi)
{
    __shared__ int warp_sums[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int v = lo | hi << 16;
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += up;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    int before = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i)
        if (i < warp) before += warp_sums[i];
    return before + inc - v;
}

// E, first kernel: one block a ranking tile of SPAWN_TILE slots, ranking
// both kinds against the budget e, so that no launch needs k before it
// ranks.  The tile's prefix: where at most DIRECT of D's counts lie
// before it, the whole block sums them; further on, warp 0 publishes the
// tile's own counts and looks back over the status words of the 32 tiles
// before it at a time, to the nearest inclusive prefix.  A word not yet
// published is summed from D's counts instead, so no block ever waits on
// another, and blockIdx can be the tile (no ticket is needed).  It
// publishes its inclusive prefix; the last tile, whose prefix is the
// totals, writes the statistics, k among them.  A tile whose prefix holds
// e or more of each kind it has leaves before it reads its flags.
// Otherwise each thread loads its 16 flags at once, a block scan ranks
// them, and the tile's exploding, then free, slots gather in shared memory
// in slot order: the exploding slot of rank r < e goes into src[r], the
// free slot of rank r < e into tgt[r], whole lines at a time.
__global__ void __launch_bounds__(THREADS) spawn_rank(
    const unsigned char* __restrict__ flags, const int2* __restrict__ tiles,
    long long n, int n_tiles, int e, unsigned long long* status,
    int* __restrict__ src, int* __restrict__ tgt, long long* stats)
{
    __shared__ unsigned long long tile_before, tile_counts;
    const int t = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (t * SUBTILES <= DIRECT) {
        // few tiles before this one: their counts straight from D's, the
        // whole block at once, and no look-back
        __shared__ unsigned long long part[WARPS];
        int ex = 0, fr = 0;
        for (int d = threadIdx.x; d < t * SUBTILES; d += THREADS) {
            const int2 c = tiles[d];
            ex += c.x;
            fr += c.y;
        }
        const unsigned long long ws = warp_sum_counts(pack_counts(ex, fr));
        if (lane == 0) part[warp] = ws;
        __syncthreads();
        if (warp == 0) {
            const int d = t * SUBTILES + lane;
            const int2 c = lane < SUBTILES && d < n_tiles ? tiles[d]
                                                          : make_int2(0, 0);
            const unsigned long long own = warp_sum_counts(
                pack_counts(c.x, c.y));
            unsigned long long before = 0;
#pragma unroll
            for (int i = 0; i < WARPS; ++i) before += part[i];
            if (lane == 0) publish(status, t, before, own, e, stats,
                                   &tile_before, &tile_counts);
        }
    } else if (warp == 0) {
        const int d = t * SUBTILES + lane;
        const int2 c = lane < SUBTILES && d < n_tiles ? tiles[d]
                                                      : make_int2(0, 0);
        const unsigned long long own = warp_sum_counts(pack_counts(c.x,
                                                                   c.y));
        if (lane == 0) store_status(status + t, ST_AGG | own);
        // lane i reads the word of tile last - i; the warp sums back to
        // the nearest inclusive prefix
        unsigned long long before = 0;
        for (int last = t - 1; last >= 0; last -= 32) {
            const int j = last - lane;
            unsigned long long w = j >= 0 ? load_status(status + j) : ST_PRE;
            if (!(w >> 62)) w = counts_of(tiles, n_tiles, j);
            const unsigned pre = __ballot_sync(FULL, (w >> 62) == 2);
            const int stop = pre ? __ffs(pre) - 1 : 31;
            before += warp_sum_counts(lane <= stop ? w & ~(3ull << 62) : 0);
            if (pre) break;
        }
        if (lane == 0) publish(status, t, before, own, e, stats,
                               &tile_before, &tile_counts);
    }
    __syncthreads();
    // the write kernel may launch once every block is past this point (it
    // waits for this grid's end): its launch overlaps the ranks
    asm volatile("griddepcontrol.launch_dependents;");
    const unsigned long long before = tile_before, own = tile_counts;
    const long long ex0 = before >> 31, fr0 = before & COUNT_MASK;
    const bool rank_ex = ex0 < e && own >> 31;
    const bool rank_fr = fr0 < e && (own & COUNT_MASK);
    if (!rank_ex && !rank_fr) return;   // the same for the whole block
    // the thread's SPAWN_PASSES consecutive flags, SPAWN_PASSES / 16
    // loads of 16 bytes
    const long long s0 = static_cast<long long>(t) * SPAWN_TILE
                         + SPAWN_PASSES * threadIdx.x;
    unsigned w[SPAWN_PASSES / 4] = {};
    if (s0 + SPAWN_PASSES <= n) {
#pragma unroll
        for (int q = 0; q < SPAWN_PASSES / 16; ++q) {
            const uint4 v = reinterpret_cast<const uint4*>(flags + s0)[q];
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
    } else {   // the last tile's end
#pragma unroll
        for (int j = 0; j < SPAWN_PASSES; ++j)
            if (s0 + j < n)
                w[j / 4] |= static_cast<unsigned>(flags[s0 + j])
                            << 8 * (j % 4);
    }
    int ce = 0, cf = 0;
#pragma unroll
    for (int q = 0; q < SPAWN_PASSES / 4; ++q) {
        ce += __popc(w[q] & 0x01010101u);
        cf += __popc(w[q] >> 1 & 0x01010101u);
    }
    // the tile's exploding slots, then its free ones, each in slot order,
    // gathered in shared memory so that the tables are written whole
    // lines at a time
    __shared__ int slots[SPAWN_TILE];
    const int n_ex = rank_ex ? static_cast<int>(own >> 31) : 0;
    const int n_fr = rank_fr ? static_cast<int>(own & COUNT_MASK) : 0;
    // explode counts in the low half, free in the high half (a tile <
    // 2^16 slots)
    const int lower = block_exclusive_scan(rank_ex ? ce : 0,
                                           rank_fr ? cf : 0);
    int le = lower & 0xffff, lf = n_ex + (lower >> 16);
#pragma unroll
    for (int j = 0; j < SPAWN_PASSES; ++j) {
        const unsigned fl = w[j / 4] >> 8 * (j % 4);
        const int s = static_cast<int>(s0) + j;
        if (rank_ex && (fl & 1)) slots[le++] = s;
        if (rank_fr && (fl & 2)) slots[lf++] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_ex && ex0 + i < e; i += THREADS)
        src[ex0 + i] = slots[i];
    for (int i = threadIdx.x; i < n_fr && fr0 + i < e; i += THREADS)
        tgt[fr0 + i] = slots[n_ex + i];
}

// E, second kernel: child i of parent src[i] into free slot tgt[i], for i
// < k = stats[N_SPAWNED] (the first kernel's), one block an SM striding
// over the children, WRITE_BATCH a thread at a time: their parents' reads
// before any of their writes, neighbouring lanes on neighbouring children
__global__ void __launch_bounds__(THREADS) spawn_write(
    State out, const float* __restrict__ fert,
    const long long* __restrict__ frame, const long long* stats,
    float weight, const int* __restrict__ src, const int* __restrict__ tgt)
{
    // launched early (programmatic dependent launch): wait until the rank
    // kernel has ended and its writes are visible
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const long long k = stats[N_SPAWNED];
    // core/rng.tag_mix: tag * 2654435761 + frame * 2246822519 + 977 mod 2^32
    const uint32_t mix =
        static_cast<uint32_t>(*frame) * 2246822519u + 977u;
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    for (long long i0 = static_cast<long long>(blockIdx.x) * THREADS
                        + threadIdx.x;
         i0 < k; i0 += WRITE_BATCH * stride) {
        long long a[WRITE_BATCH], b[WRITE_BATCH];
        float p[WRITE_BATCH][3], v[WRITE_BATCH][3], life[WRITE_BATCH];
        uint32_t tag[WRITE_BATCH];
#pragma unroll
        for (int q = 0; q < WRITE_BATCH; ++q) {
            const long long i = i0 + q * stride;
            a[q] = i < k ? src[i] : -1;
            b[q] = i < k ? tgt[i] : -1;
        }
#pragma unroll
        for (int q = 0; q < WRITE_BATCH; ++q) {
            if (a[q] < 0) continue;
            for (int j = 0; j < 3; ++j) {
                p[q][j] = out.pos[3 * a[q] + j];
                v[q][j] = out.vel[3 * a[q] + j];   // explosion velocity
            }
            life[q] = fert[a[q]];
            tag[q] = static_cast<uint32_t>(out.tag[a[q]]) * 2654435761u
                     + mix;
        }
#pragma unroll
        for (int q = 0; q < WRITE_BATCH; ++q) {
            if (a[q] < 0) continue;
            const long long d = b[q];
            for (int j = 0; j < 3; ++j) {
                out.pos[3 * d + j] = p[q][j];
                out.vel[3 * d + j] = -v[q][j];
                out.acc[3 * d + j] = 0.0f;
            }
            out.w[d] = weight;
            out.age[d] = 0.0f;
            out.life[d] = life[q];
            out.alive[d] = 1;
            out.parent[d] = 0;
            out.tag[d] = static_cast<long long>(tag[q]);
        }
    }
}

// an empty kernel: one launch's floor, which chip_smoke.py times in a CUDA
// graph beside E's
__global__ void empty_kernel() {}

int blocks_for(long long items, int threads)
{
    return static_cast<int>((items + threads - 1) / threads);
}

State state(float* const* f, unsigned char* const* b, long long* tag)
{
    return State{f[0], f[1], f[2], f[3], f[4], f[5], b[0], b[1], tag};
}

}  // namespace

// C entry points, bound with ctypes; each launches on the given stream and
// returns the launch's CUDA error (0 on success).  Host arrays (offs,
// consts, fields) are read before the launch.

// A: key (n,) int32 of pos (n, 3) float32 and alive (n,) bool on a cubic
// grid of g cells an axis (inv_cell = float32(1 / cell_size)), and, unless
// rec is null, rec (n, 8) int32, 32-byte aligned: each slot's {x, y, z, w,
// age} bits, okey of its tag (int64), the slot and 0
extern "C" int ps_nbody_cells(const float* pos, const unsigned char* alive,
                              const float* age, const float* w,
                              const long long* tags, long long n, int g,
                              float inv_cell, float cell_size, int* key,
                              int* rec, void* stream)
{
    if (n < 0 || g <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    nbody_cells<<<blocks_for(n, THREADS), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        pos, alive, age, w, tags, n, Grid{g, g / 2, inv_cell, cell_size},
        key, reinterpret_cast<int4*>(rec));
    return static_cast<int>(cudaGetLastError());
}

// B: starts (num_cells + 2,) int32 of the sorted keys skey (n,) int32, each
// in [0, num_cells]
extern "C" int ps_cell_starts(const int* skey, long long n, int num_cells,
                              int* starts, void* stream)
{
    if (n < 0 || num_cells <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cell_starts<<<blocks_for(n + 1, THREADS), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(skey, n, num_cells,
                                                       starts);
    return static_cast<int>(cudaGetLastError());
}

// C: snapshot f (7, n) float32 and i (2, n) int32, chunks (n / b, c_max, 4)
// int32, inv (n,) int32 and overflow_s (n,) bool of the rows sorted by skey
// (16-byte aligned) through order (int64, 16-byte aligned).  The rows'
// fields come from rec (A's records, 32-byte aligned) or, where rec is
// null, from pos, age, w, tags and ids (int32; null: the slot).  offs
// (host, 9) the ascending stencil offsets.  stats[N_LISTED_DROPPED]
// accumulates, stats[MAX_CELL] takes the largest cell and, where cf > 0
// (the cubic grid of g cells an axis in chunks of cd cells), the chunk
// counters after N_STATS add the cells' counts.  n a multiple of b, b of 4.
extern "C" int ps_block_prepare(
    const int* rec, const float* pos, const float* age, const float* w,
    const long long* tags, const int* ids, const int* skey,
    const long long* order, const int* starts, long long n, int b,
    int num_cells, int row_stride, int plane_stride, const int* offs,
    int cap, float kid_age, float life, int c_max, int ch, int g, int cd,
    int cf, float* f, int* iout, int* chunks, int* inv,
    unsigned char* overflow_s, long long* stats, void* stream)
{
    if (n < 0 || b <= 0 || b % ROWS || n % b || c_max <= 0 || ch <= 0
            || num_cells <= 0 || row_stride <= 0 || plane_stride <= 0
            || (cf && (g <= 0 || cd <= 0))
            || (!rec && !(pos && age && w && tags)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    Prep p{n, b, num_cells, row_stride, plane_stride, cap, c_max, ch,
           g, cd, cf, kid_age, life, {}};
    for (int q = 0; q < R; ++q) p.offs[q] = offs[q];
    const Rows src{reinterpret_cast<const int4*>(rec), pos, age, w, tags,
                   ids};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned blocks = static_cast<unsigned>(n / b);
    if (rec)
        block_prepare<true><<<blocks, PREP_THREADS, 0, st>>>(
            src, skey, order, starts, p, f, iout, chunks, inv, overflow_s,
            stats);
    else
        block_prepare<false><<<blocks, PREP_THREADS, 0, st>>>(
            src, skey, order, starts, p, f, iout, chunks, inv, overflow_s,
            stats);
    return static_cast<int>(cudaGetLastError());
}

// D: the lifecycle of n slots.  fields (host, 16 pointers): in pos, vel, w,
// age, life, out pos, vel, acc, w, age, life; then alive, parent in, alive,
// parent out (bools, in bools) and the tags in and out (tags, 2); out may
// be in.  acc_s (3, n_rows), gmax_s, overflow_s (n_rows,) in sorted order
// of a pass over n_rows >= n rows, read through the first n entries of inv
// (slot -> sorted row); uvec (n, 3).  consts (host): dt, particle_life,
// kid_age, max_dx, max_v, explosion_speed, float32(1 / cell_size),
// cell_size.  Writes flags (n,) uint8 (1 explode, 2 free) and tiles
// (ceil(n / 256), 2) int32; with n_chunks > 0, stats[MAX_CHUNK] the largest
// of the n_chunks counters after N_STATS, which it zeroes (n_chunks = 0: a
// pass without them, and stats[MAX_CHUNK] is left alone).
extern "C" int ps_nbody_lifecycle(
    float* const* fields, unsigned char* const* bools, long long* const* tags,
    const float* acc_s, long long n_rows, const int* gmax_s,
    const unsigned char* overflow_s, const int* inv, const float* uvec,
    long long n, const float* consts, int g, int n_chunks,
    unsigned char* flags, int* tiles, long long* stats, void* stream)
{
    if (n < 0 || n_rows < n || g <= 0 || n_chunks < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    float* fi[6] = {fields[0], fields[1], nullptr, fields[2], fields[3],
                    fields[4]};
    const State in = state(fi, bools, tags[0]);
    const State out = state(fields + 5, bools + 2, tags[1]);
    const Life c{n, consts[0], consts[1], consts[2], consts[3], consts[4],
                 consts[5], Grid{g, g / 2, consts[6], consts[7]}};
    nbody_lifecycle<<<blocks_for(n, THREADS), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        in, out, acc_s, n_rows, gmax_s, overflow_s, inv, uvec, c, n_chunks,
        flags, tiles, stats);
    return static_cast<int>(cudaGetLastError());
}

// E: tiles (ceil(n / 256), 2) int32, D's counts, and flags (n,) uint8,
// D's; fields (host): pos, vel, acc, w, age, life; bools: alive, parent;
// the state written in place.  scratch (ceil(n / SPAWN_TILE) + e,) 64-bit
// words: the status words, zeroed here by a memset before the first
// kernel, then the tables src and tgt (e int32 each); frame a device
// pointer to the frame (int64).  0 < e <= n < 2^31.
extern "C" int ps_nbody_spawn(
    float* const* fields, unsigned char* const* bools, long long* tag,
    const float* fert, const long long* frame, const unsigned char* flags,
    const int* tiles, long long n, int e, float weight, long long* scratch,
    long long* stats, void* stream)
{
    if (n <= 0 || n > INT_MAX || e <= 0 || e > n || frame == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rank = blocks_for(n, SPAWN_TILE);
    unsigned long long* status =
        reinterpret_cast<unsigned long long*>(scratch);
    int* src = reinterpret_cast<int*>(scratch + n_rank);
    err = cudaMemsetAsync(status, 0, sizeof(long long) * n_rank, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    spawn_rank<<<n_rank, THREADS, 0, st>>>(
        flags, reinterpret_cast<const int2*>(tiles), n, blocks_for(n, TILE),
        e, status, src, src + e, stats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the write kernel as a programmatic dependent launch, so that its
    // launch overlaps the rank kernel
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(min(blocks_for(e, THREADS), WRITE_BLOCKS * sms));
    cfg.blockDim = dim3(THREADS);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, spawn_write, state(fields, bools, tag),
                             fert, frame,
                             static_cast<const long long*>(stats), weight,
                             static_cast<const int*>(src),
                             static_cast<const int*>(src + e));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// the empty kernel, once
extern "C" int ps_empty(void* stream)
{
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
