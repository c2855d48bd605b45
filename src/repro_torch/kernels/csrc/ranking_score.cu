// Eq.-16 ranking kernel for Hopper (sm_90a): scores plus the masked victim
// selection of the delayed-hit simulator's commit step, in one launch.
//
// Replaces the Pallas kernels of src/repro/kernels/ranking_score.py:
//   rank_select(top)  <- _rank_select_kernel  (ranking_victim_order)
//   rank_select(1)    <- _rank_kernel         (ranking_scores)
//
// What bounds it on this card: memory.  Per element it reads four f32
// streams (lam, z, resid, sizes) and one bool (cached), writes one f32
// score, and does about 15 flops and one sqrt: 21 bytes against ~15
// operations, far below the H100's ~20 flops/byte balance point.  At
// N = 2^20 the bound is ~22 MB / 3.35 TB/s = 6.573 us.
//
// Design: one pass over the inputs, one launch, no serial merge.
// - Each CTA of 256 threads owns a tile of 4096 elements, 16 a thread as
//   four 16-byte loads of every f32 stream (a warp's load covers 512
//   contiguous bytes) and four 4-byte loads of the mask; a full tile at
//   aligned addresses takes the vector path, the ragged last tile (and a
//   misaligned view) the guarded scalar path.  At 2^20 that is 256 CTAs,
//   all resident at once on 132 SMs, so every load is in flight together.
// - top <= 8 (every call of the simulator: top 8, and 1 for the argmin)
//   takes the sorting-network kernel, rank_topk_kernel<K> (K = 1 or 8),
//   with no serial rounds: each thread sorts its 16 keys into its K least
//   (bitonic networks on registers), a butterfly of shuffles merges the
//   sorted K-lists across the warp (merge = min against the partner's list
//   reversed, then half-cleaners), warp 0 merges the 8 warps' lists the
//   same way, and the tile's K keys go to scratch.  The last CTA to finish
//   (a self-resetting atomic ticket in a one-int device buffer the wrapper
//   keeps per device and stream, as in decode_attention.cu) merges every
//   tile's list: each thread folds one list in 256 into its own, then the
//   warp and block butterflies.  A single-tile input (fig2's table of 100
//   objects) skips the ticket and writes the output directly.
// - top > 8 takes rank_select_kernel: each warp emits its `top` least keys
//   in `top` rounds (a shuffle butterfly finds the warp's least; only the
//   lane that held it rescans its 16 registers), warp 0 merges the 8 warp
//   lists one lane a list, and the last CTA merges the tile lists in groups
//   of 32 (heads read from L2 one step ahead), level by level.
// The design this replaces ran `top` rounds of a block-wide argmin with
// two barriers each, then a second, one-CTA kernel that re-read all
// 8,192 candidates from global memory in each of its `top` rounds: 50.82
// us at 2^20 against 18.82 us now, and 26.50 us against 9.09 us at N = 100
// (ranking_scores: 14.56 against 11.04 us), on one H100 at 700 W
// (chip_smoke.py phase 1).  What is left above the bound is the launch,
// and the selection, which runs after the tile's loads and does not
// overlap them: about 8 us at top 8, under 1 us at top 1.
//
// Keys: a score counts only where the object is cached and the score is
// below 3.4e38; every other element has key +inf (judged by value, never by
// index).  Ties always go to the lower index, and +inf keys are ordered by
// index too, so the victim order is exactly the first `top` entries of a
// stable ascending sort of the masked scores.  Elements past N carry the
// phantom key (+inf, INT_MAX), which sorts after every real element.
//
// Build with --fmad=false and without --use_fast_math: every product and
// sum below then rounds once, in the order written, like the plain PyTorch
// version (repro_torch/kernels/ref.py), so the scores agree bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                           // elements a 16-byte load
constexpr int kLoads = 4;                         // loads a stream a thread
constexpr int kPerThread = kVec * kLoads;         // 16
constexpr int kTile = kThreads * kPerThread;      // 4096
constexpr int kWarpElems = 32 * kPerThread;       // 512
constexpr int kMaxTop = 1024;
constexpr int kGroup = 32;                        // lists a warp merges
constexpr int kNetTop = 8;                        // sorting-network path
constexpr int kPhantom = 0x7fffffff;
constexpr float kSentinel = 3.4e38f;

struct Key {
    float v;
    int i;
};

__device__ __forceinline__ bool key_less(Key a, Key b) {
    return a.v < b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Key key_min(Key a, Key b) {
    return key_less(b, a) ? b : a;
}

// The warp's least key; every lane gets it.
__device__ __forceinline__ Key warp_min(Key k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        Key o;
        o.v = __shfl_xor_sync(0xffffffffu, k.v, off);
        o.i = __shfl_xor_sync(0xffffffffu, k.i, off);
        k = key_min(k, o);
    }
    return k;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;      // NaN passes through, as torch.clamp
}

__device__ __forceinline__ float eq16(float lam, float z, float r, float s,
                                      float omega) {
    float z2 = z * z;
    float e = z + lam * z2;
    float var = z2 + 6.0f * lam * z2 * z + 5.0f * lam * lam * z2 * z2;
    return (e + omega * sqrtf(var)) /
           (clamp_min(r, 1e-6f) * clamp_min(s, 1e-6f));
}

__device__ __forceinline__ Key make_key(float f, bool cached, int64_t e) {
    Key k;
    k.v = (cached && f < kSentinel) ? f : INFINITY;
    k.i = (int)e;
    return k;
}

// The least of the thread's keys strictly above `after`.
__device__ __forceinline__ Key least_above(const Key (&keys)[kPerThread],
                                           Key after) {
    Key m = {INFINITY, kPhantom};
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
        if (key_less(after, keys[k])) m = key_min(m, keys[k]);
    return m;
}

template <bool kL2>
__device__ __forceinline__ Key load_key(const Key* p) {
    if (kL2) {               // written by other CTAs: read through L2
        const int2 r = __ldcg(reinterpret_cast<const int2*>(p));
        Key k;
        k.v = __int_as_float(r.x);
        k.i = r.y;
        return k;
    }
    return *p;
}

// One warp merges `count` (<= 32) ascending lists of `len` keys, list l at
// lists + l * len, into their `top` least: to dst, or to (out_v, out_i)
// when out_v is given.  Lane l holds list l's head and the key after it.
template <bool kL2>
__device__ void merge_lists(const Key* lists, int count, int len, int top,
                            Key* dst, float* out_v, int* out_i) {
    const int lane = threadIdx.x & 31;
    const Key phantom = {INFINITY, kPhantom};
    const Key* mine = lists + (int64_t)lane * len;
    int pos = 0;
    Key head = phantom, next = phantom;
    if (lane < count) {
        head = load_key<kL2>(mine);
        if (len > 1) next = load_key<kL2>(mine + 1);
    }
    for (int r = 0; r < top; ++r) {
        const Key win = warp_min(head);
        if (lane == 0) {
            if (out_v != nullptr) {
                out_v[r] = win.v;
                out_i[r] = win.i;
            } else {
                dst[r] = win;
            }
        }
        if (lane < count && head.i == win.i) {
            ++pos;
            head = next;
            next = pos + 1 < len ? load_key<kL2>(mine + pos + 1) : phantom;
        }
    }
}

// Score the CTA's tile (stores the scores) and make each thread's 16
// masked keys; elements past n get the phantom key.
__device__ __forceinline__ void load_tile(
        const float* __restrict__ lam, const float* __restrict__ z,
        const float* __restrict__ resid, const float* __restrict__ sizes,
        const uint8_t* __restrict__ cached, float omega, int64_t n, int vec,
        float* __restrict__ scores, Key (&keys)[kPerThread]) {
    const int tid = threadIdx.x;
    const int64_t base = (int64_t)blockIdx.x * kTile;
    if (vec && base + kTile <= n) {
        float4 a[kLoads], b[kLoads], c[kLoads], d[kLoads];
        uchar4 m[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
            const int64_t e = base + (int64_t)(k * kThreads + tid) * kVec;
            a[k] = __ldg(reinterpret_cast<const float4*>(lam + e));
            b[k] = __ldg(reinterpret_cast<const float4*>(z + e));
            c[k] = __ldg(reinterpret_cast<const float4*>(resid + e));
            d[k] = __ldg(reinterpret_cast<const float4*>(sizes + e));
            m[k] = __ldg(reinterpret_cast<const uchar4*>(cached + e));
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
            const int64_t e = base + (int64_t)(k * kThreads + tid) * kVec;
            float4 f;
            f.x = eq16(a[k].x, b[k].x, c[k].x, d[k].x, omega);
            f.y = eq16(a[k].y, b[k].y, c[k].y, d[k].y, omega);
            f.z = eq16(a[k].z, b[k].z, c[k].z, d[k].z, omega);
            f.w = eq16(a[k].w, b[k].w, c[k].w, d[k].w, omega);
            *reinterpret_cast<float4*>(scores + e) = f;
            keys[k * kVec + 0] = make_key(f.x, m[k].x, e);
            keys[k * kVec + 1] = make_key(f.y, m[k].y, e + 1);
            keys[k * kVec + 2] = make_key(f.z, m[k].z, e + 2);
            keys[k * kVec + 3] = make_key(f.w, m[k].w, e + 3);
        }
    } else {
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
                const int64_t e =
                    base + (int64_t)(k * kThreads + tid) * kVec + v;
                if (e < n) {
                    const float f =
                        eq16(lam[e], z[e], resid[e], sizes[e], omega);
                    scores[e] = f;
                    keys[k * kVec + v] = make_key(f, cached[e], e);
                } else {
                    keys[k * kVec + v] = {INFINITY, kPhantom};
                }
            }
        }
    }
}

// The last CTA of the launch to get here returns true (a self-resetting
// ticket); every CTA's writes before the call are then visible to it.
__device__ __forceinline__ bool last_to_finish(unsigned* ticket) {
    __shared__ bool is_last;
    __threadfence();                 // this tile's list is visible
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned t = atomicAdd(ticket, 1u);
        is_last = t == gridDim.x - 1;
        if (is_last) *ticket = 0;    // ready for the next launch
    }
    __syncthreads();
    if (is_last) __threadfence();
    return is_last;
}

__global__ void __launch_bounds__(kThreads)
rank_select_kernel(const float* __restrict__ lam,
                   const float* __restrict__ z,
                   const float* __restrict__ resid,
                   const float* __restrict__ sizes,
                   const uint8_t* __restrict__ cached,
                   float omega, int64_t n, int top, int vec,
                   float* __restrict__ scores, Key* __restrict__ cand,
                   unsigned* __restrict__ ticket, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
    extern __shared__ Key warp_lists[];          // kWarps x wl
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    Key keys[kPerThread];
    load_tile(lam, z, resid, sizes, cached, omega, n, vec, scores, keys);

    // --- each warp: its `wl` least keys, ascending, into shared memory ----
    const int wl = top < kWarpElems ? top : kWarpElems;
    Key* my_list = warp_lists + warp * wl;
    Key mine = least_above(keys, {-INFINITY, -1});
    for (int r = 0; r < wl; ++r) {
        const Key win = warp_min(mine);
        if (lane == 0) my_list[r] = win;
        if (mine.i == win.i) mine = least_above(keys, win);
    }
    __syncthreads();

    // --- warp 0: the tile's `top` least, from the 8 warp lists -------------
    const bool single = gridDim.x == 1;
    if (warp == 0) {
        if (single)
            merge_lists<false>(warp_lists, kWarps, wl, top, nullptr, out_v,
                               out_i);
        else
            merge_lists<false>(warp_lists, kWarps, wl, top,
                               cand + (int64_t)blockIdx.x * top, nullptr,
                               nullptr);
    }
    if (single) return;

    // --- the last tile to finish merges every tile's list ------------------
    if (!last_to_finish(ticket)) return;
    const Key* src = cand;
    Key* dst = cand + (int64_t)gridDim.x * top;
    int count = gridDim.x;
    while (count > kGroup) {
        const int groups = (count + kGroup - 1) / kGroup;
        for (int g = warp; g < groups; g += kWarps) {
            const int c = count - g * kGroup;
            merge_lists<true>(src + (int64_t)g * kGroup * top,
                              c < kGroup ? c : kGroup, top, top,
                              dst + (int64_t)g * top, nullptr, nullptr);
        }
        __syncthreads();             // this level's lists are complete
        src = dst;
        dst += (int64_t)groups * top;
        count = groups;
    }
    if (warp == 0)
        merge_lists<true>(src, count, top, top, nullptr, out_v, out_i);
}

// --- the sorting-network path: top <= K, K a power of two ------------------
// Every list below is K keys ascending.  Compare-exchange puts the lesser
// key first.
__device__ __forceinline__ void cx(Key& a, Key& b) {
    const bool swap = key_less(b, a);
    const Key lo = swap ? b : a;
    b = swap ? a : b;
    a = lo;
}

// Sort K keys ascending (bitonic network; every index is static).
template <int K>
__device__ __forceinline__ void sort_keys(Key (&a)[K]) {
#pragma unroll
    for (int size = 2; size <= K; size <<= 1)
#pragma unroll
        for (int stride = size / 2; stride > 0; stride >>= 1)
#pragma unroll
            for (int i = 0; i < K; ++i) {
                const int j = i ^ stride;
                if (j > i) {
                    if ((i & size) == 0) cx(a[i], a[j]);
                    else cx(a[j], a[i]);
                }
            }
}

// a <- the K least of a and b, ascending: min(a[i], b[K-1-i]) is bitonic
// and holds them; half-cleaners sort it.
template <int K>
__device__ __forceinline__ void merge_least(Key (&a)[K], const Key (&b)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = key_min(a[i], b[K - 1 - i]);
#pragma unroll
    for (int stride = K / 2; stride > 0; stride >>= 1)
#pragma unroll
        for (int i = 0; i < K; ++i)
            if ((i ^ stride) > i) cx(a[i], a[i ^ stride]);
}

// Butterfly over lanes at xor distance 1, 2, .., `width` / 2: afterwards
// each lane of a group of `width` holds the group's K least.
template <int K>
__device__ __forceinline__ void merge_across(Key (&a)[K], int width) {
    for (int off = 1; off < width; off <<= 1) {
        Key b[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            b[i].v = __shfl_xor_sync(0xffffffffu, a[i].v, off);
            b[i].i = __shfl_xor_sync(0xffffffffu, a[i].i, off);
        }
        merge_least(a, b);
    }
}

// The CTA's K least from every thread's `a` (all threads call it); warp 0
// returns with them, in every lane.
template <int K>
__device__ __forceinline__ void block_least(Key (&a)[K]) {
    __shared__ Key warp_best[kWarps][K];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    merge_across(a, 32);
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i) warp_best[warp][i] = a[i];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i)
            a[i] = lane < kWarps ? warp_best[lane][i]
                                 : Key{INFINITY, kPhantom};
        merge_across(a, kWarps);
    }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
rank_topk_kernel(const float* __restrict__ lam,
                 const float* __restrict__ z,
                 const float* __restrict__ resid,
                 const float* __restrict__ sizes,
                 const uint8_t* __restrict__ cached,
                 float omega, int64_t n, int top, int vec,
                 float* __restrict__ scores, Key* __restrict__ cand,
                 unsigned* __restrict__ ticket, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
    static_assert(kPerThread % K == 0, "K must divide a thread's keys");
    Key keys[kPerThread];
    load_tile(lam, z, resid, sizes, cached, omega, n, vec, scores, keys);

    // --- each thread: its K least keys, sorted -----------------------------
    Key best[K];
#pragma unroll
    for (int i = 0; i < K; ++i) best[i] = keys[i];
    sort_keys(best);
#pragma unroll
    for (int g = 1; g < kPerThread / K; ++g) {
        Key t[K];
#pragma unroll
        for (int i = 0; i < K; ++i) t[i] = keys[g * K + i];
        sort_keys(t);
        merge_least(best, t);
    }

    // --- the tile's K least: across the warp, then across the 8 warps ------
    block_least(best);
    const bool single = gridDim.x == 1;
    if (threadIdx.x == 0) {
        if (single) {
            for (int i = 0; i < top; ++i) {
                out_v[i] = best[i].v;
                out_i[i] = best[i].i;
            }
        } else {
#pragma unroll
            for (int i = 0; i < K; ++i)
                cand[(int64_t)blockIdx.x * K + i] = best[i];
        }
    }
    if (single || !last_to_finish(ticket)) return;

    // --- the last tile: every tile's list, a thread taking one in 256 ------
#pragma unroll
    for (int i = 0; i < K; ++i) best[i] = {INFINITY, kPhantom};
    for (int64_t t = threadIdx.x; t < gridDim.x; t += kThreads) {
        Key b[K];
#pragma unroll
        for (int i = 0; i < K; ++i) b[i] = load_key<true>(cand + t * K + i);
        merge_least(best, b);
    }
    block_least(best);
    if (threadIdx.x == 0) {
        for (int i = 0; i < top; ++i) {
            out_v[i] = best[i].v;
            out_i[i] = best[i].i;
        }
    }
}

bool aligned(const void* p, uintptr_t a) {
    return ((uintptr_t)p & (a - 1)) == 0;
}

}  // namespace

extern "C" {

// Scores for all n elements and the `top` least masked keys, ascending, in
// (out_v, out_i).  cand is scratch of 2 * max(top, 8) Keys (8 bytes each)
// a tile, which bounds every merge level of both paths (unused for
// n <= 4096), and ticket one zeroed unsigned int that the kernel leaves
// zeroed.
int rank_select(const void* lam, const void* z, const void* resid,
                const void* sizes, const void* cached, float omega,
                int64_t n, int top, void* scores, void* cand, void* ticket,
                void* out_v, void* out_i, void* stream) {
    if (n <= 0 || n > 0x7ffffffeLL || top < 1 || top > kMaxTop ||
        top > n)
        return (int)cudaErrorInvalidValue;
    const int64_t grid = (n + kTile - 1) / kTile;
    const int vec = aligned(lam, 16) && aligned(z, 16) &&
                    aligned(resid, 16) && aligned(sizes, 16) &&
                    aligned(scores, 16) && aligned(cached, 4);
    cudaStream_t st = (cudaStream_t)stream;
#define RANK_ARGS                                                           \
    (const float*)lam, (const float*)z, (const float*)resid,                \
        (const float*)sizes, (const uint8_t*)cached, omega, n, top, vec,    \
        (float*)scores, (Key*)cand, (unsigned*)ticket, (float*)out_v,       \
        (int*)out_i
    if (top == 1) {
        rank_topk_kernel<1><<<(unsigned)grid, kThreads, 0, st>>>(RANK_ARGS);
    } else if (top <= kNetTop) {
        rank_topk_kernel<kNetTop><<<(unsigned)grid, kThreads, 0, st>>>(
            RANK_ARGS);
    } else {
        const int wl = top < kWarpElems ? top : kWarpElems;
        const size_t smem = sizeof(Key) * kWarps * wl;
        rank_select_kernel<<<(unsigned)grid, kThreads, smem, st>>>(
            RANK_ARGS);
    }
#undef RANK_ARGS
    return (int)cudaGetLastError();
}

}  // extern "C"
