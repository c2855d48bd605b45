// The replay engine's point update for Hopper (sm_90a): one launch serves a
// request, or commits a fetch, at one object per lane of the simulator's
// state, in place.
//
// Replaces no TPU kernel of its own.  The JAX reference computes these
// updates inside its compiled scan (src/repro/core/simulator.py: the serve
// at :536, the commit's finalize at :413-430), writing the fields with
// scatters and accumulating agg_sum, agg_sq_sum and agg_cnt through
// lane_add, the add half of the Pallas lane_scatter kernel
// (src/repro/kernels/lane_scatter.py:95).  The port's host loop used to
// read every field at the object back, compute on the host and write with
// csrc/lane_scatter.cu: one device round trip a serve and a commit.  This
// kernel does that arithmetic on the card, so a serve or a commit costs
// one launch and no read-back; its adds are the lane_add of the reference.
//
// What bounds it: the launch.  A lane touches 14 fields of one object
// (~100 bytes) and does ~30 flops, so bytes and operations are nothing;
// one thread a lane, and the lane records ride in the kernel's parameter
// block (no host-to-device copy).  Three block sizes (512 B, 4 KB,
// 32,760 B; a launch pushes its whole parameter struct) fit 13, 125 and
// 1,021 lanes; the wrapper cuts larger engines into several launches.
//
// Arithmetic: each operation rounds once (__fadd_rn, __fmul_rn, ...; the
// file is also built with --fmad=false), in the order of the plain
// versions point_serve_ref / point_commit_ref in kernels/ref.py, so the
// two agree bit for bit.  max() propagates NaN and keeps the first
// argument on ties, as torch.maximum and torch.clamp do.
//
// Parameter block (int32 words; the host side is kernels/point_update.py):
//   w[0] lanes in this launch, w[1] first lane, w[2] L, w[3] N,
//   w[4..5] values (f32 [12, L, N]), w[6..7] flags (bool [2, L, N]),
//   w[8..9] a slot table's key_tab (i32 [N]), w[10..11] its sizes (f32 [N]),
//   w[12] serve: the request time t (f32 bits); commit: estimate_z,
//   w[13] serve: a first touch (the slot takes an object), w[14] its id,
//   w[15] its z prior (f32 bits), w[16] eps (f32 bits), w[17..19] unused,
//   then 8 words a lane: idx, flags (1 active / due, 2 GreedyDual,
//   4 GreedyDual's rate cost), z, gd_clock, size, cold_rate, gap_alpha
//   (f32 bits), unused.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHead = 20;
constexpr int kLane = 8;
constexpr int kSmall = 128, kMedium = 1024, kLarge = 8190;

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

template <int kWords>
__global__ void __launch_bounds__(kThreads)
serve_kernel(const __grid_constant__ Block<kWords> b) {
    const int32_t* h = b.w;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= h[0]) return;
    const int32_t* r = h + kHead + k * kLane;
    if (!(r[1] & 1)) return;                    // masked lane: untouched
    const int64_t lanes = h[2], n = h[3], lane = h[1] + k, i = r[0];
    float* values = ptr<float>(h + 4);
    uint8_t* flags = ptr<uint8_t>(h + 6);
    const float t = f32(h[12]), z = f32(r[2]), size = f32(r[4]);
    const float eps = f32(h[16]);

    float g[kFields];
    bool hit, delayed;
    if (h[13]) {                                // a slot's first touch
        ptr<int32_t>(h + 8)[i] = h[14];
        ptr<float>(h + 10)[i] = size;
        for (int f = 0; f < kFields; ++f) g[f] = 0.f;
        g[CT] = INFINITY;
        g[LA] = -INFINITY;
        g[FA] = -INFINITY;
        g[ZE] = f32(h[15]);
        hit = delayed = false;
    } else {
        for (int f = 0; f < kFields; ++f)
            g[f] = values[(f * lanes + lane) * n + i];
        hit = flags[lane * n + i] != 0;
        delayed = flags[(lanes + lane) * n + i] != 0;
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
    const float a_eff = mx(f32(r[6]), __fdiv_rn(1.f, mx(cnt, 1.f)));
    v[GM] = cnt <= 0.f ? gm0
          : (cnt == 1.f ? gap
                        : __fadd_rn(gm0, __fmul_rn(a_eff,
                                                   __fsub_rn(gap, gm0))));
    v[FA] = cnt == 0.f ? t : g[FA];
    v[LA] = t;
    v[CNT] = __fadd_rn(cnt, 1.f);
    if ((r[1] & 2) && hit)
        v[GH] = __fadd_rn(f32(r[3]),
                          gd_cost(v, size, r[1] & 4, f32(r[5]), eps));

    for (int f = 0; f < kFields; ++f)
        values[(f * lanes + lane) * n + i] = v[f];
    flags[lane * n + i] = hit;
    flags[(lanes + lane) * n + i] = miss | delayed;
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
commit_kernel(const __grid_constant__ Block<kWords> b) {
    const int32_t* h = b.w;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= h[0]) return;
    const int32_t* r = h + kHead + k * kLane;
    if (!(r[1] & 1)) return;                    // no due commit: untouched
    const int64_t lanes = h[2], n = h[3], lane = h[1] + k, j = r[0];
    float* values = ptr<float>(h + 4);
    uint8_t* flags = ptr<uint8_t>(h + 6);
    float v[kFields];
    for (int f = 0; f < kFields; ++f)
        v[f] = values[(f * lanes + lane) * n + j];
    const float realized = __fsub_rn(v[CT], v[IT]);
    const float ep = v[EP];
    // the episode's statistics: the reference's lane_add, as adds
    v[AS] = __fadd_rn(v[AS], ep);
    v[AQ] = __fadd_rn(v[AQ], __fmul_rn(ep, ep));
    v[AC] = __fadd_rn(v[AC], 1.f);
    v[EP] = 0.f;
    v[CT] = INFINITY;
    if (h[12])
        v[ZE] = __fadd_rn(__fmul_rn(0.7f, v[ZE]), __fmul_rn(0.3f, realized));
    if (r[1] & 2)
        v[GH] = __fadd_rn(f32(r[3]), gd_cost(v, f32(r[4]), r[1] & 4,
                                             f32(r[5]), f32(h[16])));
    const int changed[] = {AS, AQ, AC, EP, CT, ZE, GH};
    for (int f : changed) values[(f * lanes + lane) * n + j] = v[f];
    flags[(lanes + lane) * n + j] = 0;          // in_flight
}

template <int kWords>
int launch(bool serve, const int32_t* words, int n_words, cudaStream_t s) {
    Block<kWords> b;
    memcpy(b.w, words, sizeof(int32_t) * (size_t)n_words);
    const unsigned grid = (unsigned)((words[0] + kThreads - 1) / kThreads);
    if (serve)
        serve_kernel<kWords><<<grid, kThreads, 0, s>>>(b);
    else
        commit_kernel<kWords><<<grid, kThreads, 0, s>>>(b);
    return (int)cudaGetLastError();
}

int dispatch(bool serve, const void* words, int n_words, void* stream) {
    const int32_t* w = (const int32_t*)words;
    cudaStream_t s = (cudaStream_t)stream;
    if (n_words < kHead || n_words > kLarge ||
        n_words != kHead + kLane * w[0])
        return (int)cudaErrorInvalidValue;
    if (w[0] <= 0) return (int)cudaGetLastError();
    if (n_words <= kSmall) return launch<kSmall>(serve, w, n_words, s);
    if (n_words <= kMedium) return launch<kMedium>(serve, w, n_words, s);
    return launch<kLarge>(serve, w, n_words, s);
}

}  // namespace

extern "C" {

// One serve launch over the lanes of a parameter block (layout above).
int point_serve(const void* words, int n_words, void* stream) {
    return dispatch(true, words, n_words, stream);
}

// One commit launch over the lanes of a parameter block.
int point_commit(const void* words, int n_words, void* stream) {
    return dispatch(false, words, n_words, stream);
}

}  // extern "C"
