// Decode attention kernels for Hopper (sm_90a): one new token per sequence
// against a ring-buffer KV cache, with GQA, sliding window, sink positions
// and tanh softcap.
//
// Replaces the Pallas kernel _dec_kernel of
// src/repro/kernels/decode_attention.py (decode_attention).
//
// Semantics are those of the plain version (kernels/ref.py), as in
// flash_attention.cu: f32 logits scaled by dh^-1/2, softcap before the
// mask, the finite -1e30 sentinel for masked slots and -inf past Sc, p in
// f32, out = acc / max(l, 1e-30) rounded once to the output type.  The
// cache is read in its (B, Sc, KV, dh) layout through its strides; the
// ring buffer's k_pos may be in any order, with -1 in empty slots.
//
// What bounds it on the card.  A decode step reads the whole cache once:
// at Sc = 2048 with 32 KV heads of 64 in bf16 that is 16.8 MB a layer
// (5.0 us at 3.35 TB/s) for 2 * 2 * Sc * H * dh = 16.8 MFLOP, so bytes
// bound it, and the card's 132 SMs must all stream.  Both dtypes take the
// same kernels; f32 arithmetic on the CUDA cores is far from the limit.
//
// Layout: split the cache, then merge (flash-decoding).  As on the TPU,
// the query tile of a block is the GQA group: G q heads of one KV head,
// with G the least of 1, 2, 4, 8 that holds the group (a larger group
// takes several tiles, each reading the cache).  The TPU kernel walks
// the cache on its sequential grid axis; here the cache is cut into
// n_split ranges of split_len slots (chosen by the wrapper from Sc and
// the SM count, so that about two blocks land on each SM), and the grid
// is (B * KV * q tiles, n_split).  Inside a block each of 8 warps streams
// its own rows of the range: a row of dh values is read by dh*size/16
// lanes, 16 bytes each, straight into registers (no shared-memory
// staging), the next step's rows issued before this step's are used, and
// keeps its own online-softmax state (m, l, acc); the warps' states are
// merged through shared memory at the end.  Each split writes its
// (m, l, acc) in f32 to scratch; the last block of a q tile to finish
// (an atomic ticket per tile, which that block sets back to 0 for the
// next launch) merges them: M = max m_s, l = sum l_s e^(m_s - M),
// acc = sum acc_s e^(m_s - M), out = acc / max(l, 1e-30), eight splits'
// partials loaded at once.  With one split the block writes out itself.
// A separate merge kernel, and a merge across a thread-block cluster
// through distributed shared memory, were both slower on an H100: at
// this size the merge's latency, not its bytes, is what counts.
//
// Masked splits.  A split whose slots are all empty or masked ends with
// m_s = -1e30 and l_s = its slot count: its weight e^(-1e30 - M) is
// exactly 0 when another split saw a key, and 1 for every split when none
// did, so a row with no visible key averages v over all Sc slots, as the
// plain version does.  Splits cover only [0, Sc) (the wrapper makes every
// one non-empty); a warp's rows past its split's end get -inf (weight 0).
#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kU = 2;           // row loads of K and of V a lane has in flight

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int Sc, int H, int KV, int group, int n_gt,
                    int split_len, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                    int64_t v_sh, float scale, int window, float softcap,
                    int sink) {
    constexpr int VPL = 16 / sizeof(T);   // values a 16-byte load holds
    constexpr int CPR = D / VPL;          // lanes a cache row
    constexpr int RPW = 32 / CPR;         // rows a warp loads at once
    static_assert(CPR <= 32 && 32 % CPR == 0, "a row spans 1-32 lanes");
    __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
    __shared__ float sm_acc[kWarps][G][D];
    __shared__ int sm_last;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gt = blockIdx.x % n_gt, bk = blockIdx.x / n_gt;
    const int b = bk / KV, kvh = bk % KV;
    const int g0 = gt * G, gn = min(G, group - g0);
    const int h0 = kvh * group + g0;             // first q head of the tile
    const int split = blockIdx.y, n_split = gridDim.y;
    const int s0 = split * split_len, s1 = min(Sc, s0 + split_len);
    const int rr = lane / CPR, c = lane % CPR;   // row in a load, chunk
    const T* kb = k + b * k_sb + kvh * k_sh + c * VPL;
    const T* vb = v + b * v_sb + kvh * v_sh + c * VPL;

    // the warp's rows: kU * RPW consecutive slots a step, warps interleaved;
    // each step's loads go out before the previous step's arithmetic
    constexpr int kStep = kU * RPW;
    uint4 kr[kU], vr[kU];
    int kp[kU];
    auto load = [&](int base) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const int slot = base + u * RPW + rr;
            const bool ok = slot < s1;
            const int64_t row = ok ? slot : 0;
            kr[u] = ld16(kb + row * k_ss, ok);
            vr[u] = ld16(vb + row * v_ss, ok);
            kp[u] = ok ? __ldg(k_pos + slot) : -1;
        }
    };
    int base = s0 + warp * kStep;
    if (base < s1) load(base);

    // this lane's chunk of every q row, in f32
    const int qp = q_pos[0];
    float qv[G][VPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const uint4 u = ld16(q + b * q_sb + (int64_t)(h0 + min(g, gn - 1)) *
                                                q_sh + c * VPL, g < gn);
        unpack(u, qv[g], T());
    }
    float m[G], l[G], acc[G][VPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[g][i] = 0.f;
    }

    for (; base < s1; base += kWarps * kStep) {
        float kf[kU][VPL], vf[kU][VPL];
        bool in[kU], vis[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            unpack(kr[u], kf[u], T());
            unpack(vr[u], vf[u], T());
            in[u] = base + u * RPW + rr < s1;
            vis[u] = in[u] && visible(qp, kp[u], window, sink);
        }
        if (base + kWarps * kStep < s1) load(base + kWarps * kStep);

#pragma unroll
        for (int g = 0; g < G; ++g) {
            float x[kU];
            float mx = -INFINITY;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                float d = 0.f;
#pragma unroll
                for (int i = 0; i < VPL; ++i) d = fmaf(qv[g][i], kf[u][i], d);
#pragma unroll
                for (int off = CPR / 2; off > 0; off >>= 1)
                    d += __shfl_xor_sync(0xffffffffu, d, off);
                float xx = d * scale;
                if (softcap > 0.f) xx = softcap * tanhf(xx / softcap);
                x[u] = !in[u] ? -INFINITY : (vis[u] ? xx : kNegInf);
                mx = fmaxf(mx, x[u]);
            }
#pragma unroll
            for (int off = CPR; off < 32; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[g], mx);
            const float alpha = expf(m[g] - m_new);
            m[g] = m_new;
            l[g] *= alpha;
#pragma unroll
            for (int i = 0; i < VPL; ++i) acc[g][i] *= alpha;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const float p = expf(x[u] - m_new);
                l[g] += p;
#pragma unroll
                for (int i = 0; i < VPL; ++i)
                    acc[g][i] = fmaf(p, vf[u][i], acc[g][i]);
            }
        }
    }

    // --- the warp's rows summed (m is uniform over the warp) --------------
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = CPR; off < 32; off <<= 1) {
            l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
            for (int i = 0; i < VPL; ++i)
                acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        }
        if (rr == 0) {
#pragma unroll
            for (int i = 0; i < VPL; ++i)
                sm_acc[warp][g][c * VPL + i] = acc[g][i];
        }
        if (lane == 0) {
            sm_m[warp][g] = m[g];
            sm_l[warp][g] = l[g];
        }
    }
    __syncthreads();

    // --- the warps merged; out, or this split's partial state --------------
    for (int i = tid; i < gn * D; i += kThreads) {
        const int g = i / D, d = i % D;
        float M = sm_m[0][g];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float e = expf(sm_m[w][g] - M);
            L += sm_l[w][g] * e;
            A += sm_acc[w][g][d] * e;
        }
        const int64_t bh = (int64_t)b * H + h0 + g;
        if (n_split == 1) {
            store(out + bh * D + d, A / fmaxf(L, 1e-30f));
        } else {
            float* pr = part + (bh * n_split + split) * (D + 2);
            pr[2 + d] = A;
            if (d == 0) {
                pr[0] = M;
                pr[1] = L;
            }
        }
    }
    if (n_split == 1) return;

    // --- the last split of the q tile to finish merges all of them ---------
    __threadfence();                 // this split's state is visible
    __syncthreads();
    if (tid == 0) {
        const int t = atomicAdd(tickets + blockIdx.x, 1);
        sm_last = t == n_split - 1;
        if (sm_last) tickets[blockIdx.x] = 0;   // ready for the next launch
    }
    __syncthreads();
    if (!sm_last) return;
    __threadfence();
    // eight splits' (m, l, acc[d]) loaded at once, merged online
    for (int i = tid; i < gn * D; i += kThreads) {
        const int g = i / D, d = i % D;
        const int64_t bh = (int64_t)b * H + h0 + g;
        const float* pr = part + bh * n_split * (D + 2);
        float M = kNegInf, L = 0.f, A = 0.f;
        for (int s8 = 0; s8 < n_split; s8 += 8) {
            float ms[8], ls[8], as[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const bool ok = s8 + j < n_split;
                const float* ps = pr + (int64_t)(ok ? s8 + j : 0) * (D + 2);
                ms[j] = ok ? __ldcg(ps) : kNegInf;
                ls[j] = ok ? __ldcg(ps + 1) : 0.f;
                as[j] = ok ? __ldcg(ps + 2 + d) : 0.f;
            }
            float Mb = M;
#pragma unroll
            for (int j = 0; j < 8; ++j) Mb = fmaxf(Mb, ms[j]);
            const float r = expf(M - Mb);
            L *= r;
            A *= r;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                if (s8 + j < n_split) {
                    const float e = expf(ms[j] - Mb);
                    L += ls[j] * e;
                    A += as[j] * e;
                }
            }
            M = Mb;
        }
        store(out + bh * D + d, A / fmaxf(L, 1e-30f));
    }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* out, float* part, int* tickets, int B,
           int Sc, int H, int KV, int n_split, int split_len,
           const int64_t* st, float scale, int window, float softcap,
           int sink, cudaStream_t stream) {
    const int group = H / KV;
    const int n_gt = (group + G - 1) / G;
    const dim3 grid((unsigned)(B * KV * n_gt), (unsigned)n_split);
    decode_split_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, q_pos, k_pos, (T*)out, part,
        tickets, Sc, H, KV, group, n_gt, split_len, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], scale, window, softcap, sink);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_tile(int G, const void* q, const void* k, const void* v,
                  const int* q_pos, const int* k_pos, void* out, float* part,
                  int* tickets, int B, int Sc, int H, int KV, int n_split,
                  int split_len, const int64_t* st, float scale, int window,
                  float softcap, int sink, cudaStream_t s) {
#define DECODE_LAUNCH(G_)                                                  \
    return launch<T, D, G_>(q, k, v, q_pos, k_pos, out, part, tickets, B, \
                            Sc, H, KV, n_split, split_len, st, scale,      \
                            window, softcap, sink, s)
    switch (G) {
        case 1: DECODE_LAUNCH(1);
        case 2: DECODE_LAUNCH(2);
        case 4: DECODE_LAUNCH(4);
        case 8: DECODE_LAUNCH(8);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DECODE_LAUNCH
}

template <typename T>
int dispatch(int D, int G, const void* q, const void* k, const void* v,
             const int* q_pos, const int* k_pos, void* out, float* part,
             int* tickets, int B, int Sc, int H, int KV, int n_split,
             int split_len, const int64_t* st, float scale, int window,
             float softcap, int sink, cudaStream_t s) {
#define DECODE_TILE(D_)                                                    \
    return dispatch_tile<T, D_>(G, q, k, v, q_pos, k_pos, out, part,      \
                                tickets, B, Sc, H, KV, n_split, split_len, \
                                st, scale, window, softcap, sink, s)
    switch (D) {
        case 16: DECODE_TILE(16);
        case 32: DECODE_TILE(32);
        case 64: DECODE_TILE(64);
        case 128: DECODE_TILE(128);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DECODE_TILE
}

}  // namespace

extern "C" {

// q (B,1,H,D) with strides (batch, head); k/v (B,Sc,KV,D) with strides
// (batch, slot, head); every last axis contiguous; out (B,1,H,D)
// contiguous.  G is the q tile (1, 2, 4 or 8 heads of a group); the cache
// is cut into n_split ranges of split_len slots, every one non-empty; part
// is f32 scratch of B*H*n_split*(D+2) values and tickets B*KV*ceil(group/G)
// ints, zero before the launch and zero again after it (both unused when
// n_split is 1).  dtype 0 = f32, 1 = bf16.  Returns cudaGetLastError().
int decode_attention(const void* q, const void* k, const void* v,
                     const void* q_pos, const void* k_pos, void* out,
                     void* part, void* tickets, int B, int Sc, int H,
                     int KV, int D, int G, int n_split, int split_len,
                     int64_t q_sb, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                     int64_t v_ss, int64_t v_sh, float scale, int window,
                     float softcap, int sink, int dtype, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    if (Sc <= 0 || KV <= 0 || H % KV != 0 || n_split <= 0 ||
        split_len <= 0 || (int64_t)(n_split - 1) * split_len >= Sc ||
        (int64_t)n_split * split_len < Sc)
        return (int)cudaErrorInvalidValue;
    const int64_t st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    const int* qp = (const int*)q_pos;
    const int* kp = (const int*)k_pos;
    float* pt = (float*)part;
    int* tk = (int*)tickets;
    switch (dtype) {
        case 0:
            return dispatch<float>(D, G, q, k, v, qp, kp, out, pt, tk, B, Sc,
                                   H, KV, n_split, split_len, st, scale,
                                   window, softcap, sink, s);
        case 1:
            return dispatch<__nv_bfloat16>(D, G, q, k, v, qp, kp, out, pt,
                                           tk, B, Sc, H, KV, n_split,
                                           split_len, st, scale, window,
                                           softcap, sink, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
