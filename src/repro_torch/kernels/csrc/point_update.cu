// The replay engine's point updates for Hopper (sm_90a), as a journal: one
// launch applies, in order, every serve, commit and cached-bit write the
// engine queued since the state was last read, in place.
//
// Replaces no TPU kernel of its own.  The JAX reference computes these
// updates inside its compiled scan (src/repro/core/simulator.py: the serve
// at :536, the commit's finalize at :413-430), writing the fields with
// scatters and accumulating agg_sum, agg_sq_sum and agg_cnt through
// lane_add, the add half of the Pallas lane_scatter kernel
// (src/repro/kernels/lane_scatter.py:95).  The port's engine decides
// everything on the host from its mirror and reads the card only to score
// and to pick a victim, so every write between two reads can wait and go
// out in one launch (kernels/point_update.py queues them).
//
// Design: one CTA a lane, threads over ops.  The CTA copies the block's
// used words into shared memory (the parameter space serves divergent
// reads one address at a time), stages each op's object at its lane and
// chains the ops at each object in journal order (each op finds its next
// by a forward scan of the staged objects: K^2 / 2 shared reads at worst,
// broadcast across a warp; a flush holds a handful of ops, at most
// 1,361).  The first op at an object loads the point's 12 f32 fields and
// 2 flags once, follows the chain in registers and stores the point once:
// a touched point costs one HBM load and one store however many ops touch
// it, and the chains at distinct objects run in parallel.  What bounds
// it: the launch, since a point is ~100 bytes; the ops ride in the
// kernel's parameter block (no host-to-device copy).  Three block sizes
// (512 B, 4 KB, 32,760 B; a launch pushes its whole parameter struct);
// the wrapper starts a new block when one is full.
//
// Arithmetic: each operation rounds once (__fadd_rn, __fmul_rn, ...; the
// file is also built with --fmad=false), in the order of the plain
// versions point_serve_ref / point_commit_ref in kernels/ref.py, so the
// two agree bit for bit.  max() propagates NaN and keeps the first
// argument on ties, as torch.maximum and torch.clamp do.
//
// Parameter block (int32 words; the host side is kernels/point_update.py):
//   w[0] lanes in this launch (nl), w[1] first lane, w[2] L, w[3] N,
//   w[4..5] values (f32 [12, L, N]), w[6..7] flags (bool [2, L, N]),
//   w[8..9] a slot table's key_tab (i32 [N]), w[10..11] its sizes (f32 [N]),
//   w[12..13] the lanes' constants (i32 [L, 4]: flags 2 GreedyDual, 4 its
//   rate cost; cold_rate, gap_alpha as f32 bits; unused), w[14] ops (K),
//   w[15] estimate_z, w[16] eps (f32 bits), w[17] the block's used words
//   (set at launch), w[18..19] unused;
//   then K op headers of 6 words: code (bits 0-1 the kind: 0 serve,
//   1 commit, 2 cached-bit set; flags 4 per-lane idx, 8 per-lane z,
//   16 per-lane size, 32 per-lane GreedyDual clock, 64 a first touch,
//   128 the set's value), the idx of every lane, t, z, size (f32 bits),
//   the offset of the op's data;
//   then the ops' data, from word 20 + 6 K: a first touch's (key, z prior),
//   then nl words each of idx, z, size and clock, those the code names.
//   An idx below 0 leaves the lane's point untouched (masked, not due).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHead = 20;
constexpr int kOp = 6;
constexpr int kSmall = 128, kMedium = 1024, kLarge = 8190;

enum { kServe = 0, kCommit = 1, kSet = 2 };
enum { kIdx = 4, kZ = 8, kSize = 16, kClock = 32, kFresh = 64, kValue = 128 };
enum { kGd = 2, kGdRate = 4 };

// rows of the f32 state (repro_torch.core.state.F32_FIELDS)
enum { CT, IT, LA, FA, GM, CNT, ZE, AS, AQ, AC, EP, GH, kFields };

template <int kWords>
struct Block {
    int32_t w[kWords];
};

__device__ __forceinline__ float mx(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return a < b ? b : a;
}

__device__ __forceinline__ float f32(int32_t bits) {
    return __int_as_float(bits);
}

template <typename T>
__device__ __forceinline__ T* ptr(const int32_t* w) {
    return (T*)((uint64_t)(uint32_t)w[0] | ((uint64_t)(uint32_t)w[1] << 32));
}

// GreedyDual cost: mean aggregate delay (times the arrival rate on
// rate-cost lanes) over the size.
__device__ __forceinline__ float gd_cost(const float* f, float size,
                                         bool rate, float cold_rate,
                                         float eps) {
    float cost = f[AC] > 0.f ? __fdiv_rn(f[AS], mx(f[AC], 1.f)) : f[ZE];
    const float lam =
        f[CNT] >= 2.f ? __fdiv_rn(1.f, mx(f[GM], eps)) : cold_rate;
    if (rate) cost = __fmul_rn(cost, lam);
    return __fdiv_rn(cost, mx(size, eps));
}

// One op's per-lane operands, read from its header or its data.
struct Op {
    int code;
    float t, z, size, clock;
    int32_t key;
    float z_prior;
};

__device__ __forceinline__ Op read_op(const int32_t* o, const int32_t* data,
                                      int nl, int k_lane) {
    Op op;
    op.code = o[0];
    op.t = f32(o[2]);
    op.z = f32(o[3]);
    op.size = f32(o[4]);
    op.clock = 0.f;
    int at = o[5];
    if (op.code & kFresh) {
        op.key = data[at];
        op.z_prior = f32(data[at + 1]);
        at += 2;
    }
    if (op.code & kIdx) at += nl;
    if (op.code & kZ) { op.z = f32(data[at + k_lane]); at += nl; }
    if (op.code & kSize) { op.size = f32(data[at + k_lane]); at += nl; }
    if (op.code & kClock) op.clock = f32(data[at + k_lane]);
    return op;
}

// A serve at the point (g, hit, in_flight) held in registers.
__device__ __forceinline__ void serve(float* g, bool& hit_bit, bool& infl_bit,
                                      const Op& op, int lane_flags,
                                      float cold_rate, float gap_alpha,
                                      float eps, const int32_t* h,
                                      int64_t i) {
    const float t = op.t, z = op.z, size = op.size;
    bool hit, delayed;
    if (op.code & kFresh) {                     // a slot's first touch
        ptr<int32_t>(h + 8)[i] = op.key;
        ptr<float>(h + 10)[i] = size;
        for (int f = 0; f < kFields; ++f) g[f] = 0.f;
        g[CT] = INFINITY;
        g[LA] = -INFINITY;
        g[FA] = -INFINITY;
        g[ZE] = op.z_prior;
        hit = delayed = false;
    } else {
        hit = hit_bit;
        delayed = infl_bit;
    }
    const bool miss = !(hit | delayed);
    const float ct = g[CT];
    const float lat =
        hit ? 0.f : (delayed ? mx(__fsub_rn(ct, t), 0.f) : z);

    float v[kFields];
    for (int f = 0; f < kFields; ++f) v[f] = g[f];
    v[CT] = miss ? __fadd_rn(t, z) : ct;
    v[IT] = miss ? t : g[IT];
    v[EP] = miss ? z : __fadd_rn(g[EP], delayed ? lat : 0.f);
    const float cnt = g[CNT];
    const float gap = __fsub_rn(t, g[LA]);
    const float gm0 = g[GM];
    const float a_eff = mx(gap_alpha, __fdiv_rn(1.f, mx(cnt, 1.f)));
    v[GM] = cnt <= 0.f ? gm0
          : (cnt == 1.f ? gap
                        : __fadd_rn(gm0, __fmul_rn(a_eff,
                                                   __fsub_rn(gap, gm0))));
    v[FA] = cnt == 0.f ? t : g[FA];
    v[LA] = t;
    v[CNT] = __fadd_rn(cnt, 1.f);
    if ((lane_flags & kGd) && hit)
        v[GH] = __fadd_rn(op.clock, gd_cost(v, size, lane_flags & kGdRate,
                                            cold_rate, eps));
    for (int f = 0; f < kFields; ++f) g[f] = v[f];
    hit_bit = hit;
    infl_bit = miss | delayed;
}

// The commit of the point's outstanding fetch.
__device__ __forceinline__ void commit(float* v, bool& infl_bit,
                                       const Op& op, int lane_flags,
                                       float cold_rate, bool estimate_z,
                                       float eps) {
    const float realized = __fsub_rn(v[CT], v[IT]);
    const float ep = v[EP];
    // the episode's statistics: the reference's lane_add, as adds
    v[AS] = __fadd_rn(v[AS], ep);
    v[AQ] = __fadd_rn(v[AQ], __fmul_rn(ep, ep));
    v[AC] = __fadd_rn(v[AC], 1.f);
    v[EP] = 0.f;
    v[CT] = INFINITY;
    if (estimate_z)
        v[ZE] = __fadd_rn(__fmul_rn(0.7f, v[ZE]), __fmul_rn(0.3f, realized));
    if (lane_flags & kGd)
        v[GH] = __fadd_rn(op.clock, gd_cost(v, op.size, lane_flags & kGdRate,
                                            cold_rate, eps));
    infl_bit = false;
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
journal_kernel(const __grid_constant__ Block<kWords> b) {
    constexpr int kMaxOps = (kWords - kHead) / kOp;
    __shared__ int32_t s_w[kWords];             // the block's used words
    __shared__ int32_t s_idx[kMaxOps];          // each op's object here
    __shared__ int16_t s_next[kMaxOps];         // its next op at the object
    __shared__ uint8_t s_first[kMaxOps];        // no earlier op at it
    const int n_used = b.w[17], n_ops = b.w[14];
    for (int w = threadIdx.x; w < n_used; w += blockDim.x) s_w[w] = b.w[w];
    __syncthreads();

    const int32_t* h = s_w;
    const int nl = h[0], k_lane = blockIdx.x;
    const int64_t lanes = h[2], n = h[3], lane = h[1] + k_lane;
    const int32_t* ops = h + kHead;
    const int32_t* data = ops + kOp * n_ops;
    // each op's object at this lane (-1: the lane is left out)
    for (int k = threadIdx.x; k < n_ops; k += blockDim.x) {
        const int32_t* o = ops + k * kOp;
        int32_t i = o[1];
        if (o[0] & kIdx)
            i = data[o[5] + ((o[0] & kFresh) ? 2 : 0) + k_lane];
        s_idx[k] = i;
        s_first[k] = i >= 0;
    }
    __syncthreads();
    // chain the ops at each object in journal order: a forward scan for
    // the next one (shared reads, broadcast across a warp)
    for (int k = threadIdx.x; k < n_ops; k += blockDim.x) {
        const int32_t i = s_idx[k];
        int next = -1;
        if (i >= 0)
            for (int j = k + 1; j < n_ops; ++j)
                if (s_idx[j] == i) { next = j; break; }
        s_next[k] = (int16_t)next;
        if (next >= 0) s_first[next] = 0;
    }
    __syncthreads();

    const int32_t* lc = ptr<int32_t>(h + 12) + lane * 4;
    const int lane_flags = lc[0];
    const float cold_rate = f32(lc[1]), gap_alpha = f32(lc[2]);
    const bool estimate_z = h[15] != 0;
    const float eps = f32(h[16]);
    float* values = ptr<float>(h + 4);
    uint8_t* flags = ptr<uint8_t>(h + 6);

    // the first op at each object walks its chain: one load, one store
    for (int k = threadIdx.x; k < n_ops; k += blockDim.x) {
        if (!s_first[k]) continue;
        const int64_t i = s_idx[k];
        float g[kFields];
        for (int f = 0; f < kFields; ++f)
            g[f] = values[(f * lanes + lane) * n + i];
        bool hit = flags[lane * n + i] != 0;
        bool infl = flags[(lanes + lane) * n + i] != 0;
        for (int j = k; j >= 0; j = s_next[j]) {
            const Op op = read_op(ops + j * kOp, data, nl, k_lane);
            switch (op.code & 3) {
            case kServe:
                serve(g, hit, infl, op, lane_flags, cold_rate, gap_alpha,
                      eps, h, i);
                break;
            case kCommit:
                commit(g, infl, op, lane_flags, cold_rate, estimate_z, eps);
                break;
            default:
                hit = (op.code & kValue) != 0;
            }
        }
        for (int f = 0; f < kFields; ++f)
            values[(f * lanes + lane) * n + i] = g[f];
        flags[lane * n + i] = hit;
        flags[(lanes + lane) * n + i] = infl;
    }
}

template <int kWords>
int launch(const int32_t* head, int n_head, const int32_t* data, int n_data,
           cudaStream_t s) {
    Block<kWords> b;
    memcpy(b.w, head, sizeof(int32_t) * (size_t)n_head);
    memcpy(b.w + n_head, data, sizeof(int32_t) * (size_t)n_data);
    b.w[17] = n_head + n_data;
    journal_kernel<kWords><<<(unsigned)head[0], kThreads, 0, s>>>(b);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over a journal: the header and the op headers (``head``,
// ``n_head`` words), then the ops' data (``data``, ``n_data`` words),
// copied into one parameter block (layout above).
int point_journal(const void* head, int n_head, const void* data, int n_data,
                  void* stream) {
    const int32_t* w = (const int32_t*)head;
    const int32_t* d = (const int32_t*)data;
    cudaStream_t s = (cudaStream_t)stream;
    const int total = n_head + n_data;
    if (n_head < kHead || n_data < 0 || total > kLarge ||
        n_head != kHead + kOp * w[14] || w[0] < 0)
        return (int)cudaErrorInvalidValue;
    if (w[0] == 0 || w[14] == 0) return (int)cudaGetLastError();
    if (total <= kSmall) return launch<kSmall>(w, n_head, d, n_data, s);
    if (total <= kMedium) return launch<kMedium>(w, n_head, d, n_data, s);
    return launch<kLarge>(w, n_head, d, n_data, s);
}

}  // extern "C"
