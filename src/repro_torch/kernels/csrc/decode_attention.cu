// Decode attention kernel for Hopper (sm_90a): one new token per sequence
// against a ring-buffer KV cache, with GQA, sliding window, sink positions
// and tanh softcap.
//
// Replaces the Pallas kernel _dec_kernel of
// src/repro/kernels/decode_attention.py (decode_attention).
//
// Layout.  As on the TPU, the query tile of a block is the GQA group: one
// block per (batch row, KV head, up to G q heads of its group), with G the
// least of 1, 2, 4, 8, 16 that holds the group (a template parameter, so an
// MHA block does the work of one row, not sixteen).  The TPU
// kernel walks key blocks on its sequential minor grid axis; here a loop
// inside the block walks the cache in tiles of kBK slots, each staged in
// shared memory in f32, and keeps the online-softmax state (m, l, acc) in
// registers.  The cache is read in its (B, Sc, KV, dh) layout through its
// strides; slots past Sc are masked in the kernel.  The ring buffer's
// k_pos may be in any order, with -1 in empty slots.
//
// Semantics are those of the plain version (kernels/ref.py), as in
// flash_attention.cu: f32 logits scaled by dh^-1/2, softcap before the
// mask, the finite -1e30 sentinel for masked slots and -inf past Sc, p in
// f32, out = acc / max(l, 1e-30) rounded once to the output type.
//
// What bounds it on the card.  A decode step reads the whole cache once:
// at Sc = 2048 with 32 KV heads of 64 in bf16 that is 16.8 MB a layer
// (~5 us at 3.35 TB/s) for 2 * 2 * Sc * H * dh = 16.8 MFLOP, so bytes
// bound it.  This first version stages each tile through shared memory
// with 16-byte loads, several in flight per thread, and runs one block per
// (b, KV head): at batch 1 that is 32 blocks for 132 SMs, so it cannot
// reach the bound; a split over the cache (a second pass merging partial
// softmax states) is later work.
// Thread c of the block scores slot c of the tile for every q row; in the
// product with v, thread (g, d) sums its share of the tile's slots into
// column d, and the shares are added once at the end.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;   // one cache slot of the tile per thread
constexpr int kBK = 128;        // cache slots per tile
constexpr int kWarps = kThreads / 32;

template <int D, int G>
constexpr size_t smem_bytes() {
    return (size_t)(G * D + kBK * (D + 1) + kBK * D + G * kBK +
                    kWarps * G) * sizeof(float) +
           (size_t)kBK * sizeof(int);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ q_pos,
              const int* __restrict__ k_pos, T* __restrict__ out, int Sc,
              int H, int KV, int group, int64_t q_sb, int64_t q_sh,
              int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
              int64_t v_ss, int64_t v_sh, float scale, int window,
              float softcap, int sink) {
    constexpr int DP = D + 1;
    constexpr int kKG = kThreads / D;    // slot shares in the p.v product
    constexpr int kPer = kBK / kKG;      // slots per share
    static_assert(kKG * G * D <= kBK * DP, "final sums must fit in Ks");
    extern __shared__ float smem[];
    float* Qs = smem;                    // [G][D]
    float* Ks = Qs + G * D;              // [kBK][DP]
    float* Vs = Ks + kBK * DP;           // [kBK][D]
    float* Ps = Vs + kBK * D;            // [G][kBK]
    float* red = Ps + G * kBK;           // [kWarps][G]
    int* kps = (int*)(red + kWarps * G);   // [kBK]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
    const int g0 = blockIdx.y * G;
    const int gn = min(G, group - g0);
    const int h0 = kvh * group + g0;     // first q head of this block
    const int qp = q_pos[0];

    // the q rows as a (gn, D) matrix with row stride q_sh
    load_tile<T, G, D, D, kThreads>(q + b * q_sb + h0 * q_sh, q_sh, 0, gn,
                                    Qs, tid);
    const T* kb = k + b * k_sb + kvh * k_sh;
    const T* vb = v + b * v_sb + kvh * v_sh;

    const int kg = tid / D, dcol = tid % D;
    float m[G], l[G], acc[G], alpha[G], s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
        acc[g] = 0.f;
    }

    for (int k0 = 0; k0 < Sc; k0 += kBK) {
        __syncthreads();                 // the last tile's smem is consumed
        kps[tid] = k0 + tid < Sc ? k_pos[k0 + tid] : -1;
        load_tile<T, kBK, D, DP, kThreads>(kb, k_ss, k0, Sc, Ks, tid);
        load_tile<T, kBK, D, D, kThreads>(vb, v_ss, k0, Sc, Vs, tid);
        __syncthreads();

        // --- logits of slot c = tid for every q row ----------------------
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float kv = Ks[tid * DP + d];
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] = fmaf(Qs[g * D + d], kv, s[g]);
        }
        const bool in_range = k0 + tid < Sc;
        const bool vis = in_range && visible(qp, kps[tid], window, sink);
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float x = s[g] * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            s[g] = !in_range ? -INFINITY : (vis ? x : kNegInf);
        }

        // --- tile max per row over the block ---------------------------
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float x = s[g];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
            if (lane == 0) red[warp * G + g] = x;
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float mx = red[g];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w * G + g]);
            const float m_new = fmaxf(m[g], mx);
            alpha[g] = expf(m[g] - m_new);
            s[g] = expf(s[g] - m_new);
            m[g] = m_new;
        }
        __syncthreads();                 // red is reused for the sums

        // --- tile sum per row; p to shared memory -------------------------
#pragma unroll
        for (int g = 0; g < G; ++g) {
            Ps[g * kBK + tid] = s[g];
            float x = s[g];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                x += __shfl_xor_sync(0xffffffffu, x, off);
            if (lane == 0) red[warp * G + g] = x;
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float sum = red[g];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) sum += red[w * G + g];
            l[g] = l[g] * alpha[g] + sum;
            acc[g] *= alpha[g];
        }

        // --- acc += p . v over this thread's share of the tile ------------
#pragma unroll 4
        for (int cc = 0; cc < kPer; ++cc) {
            const int c = kg * kPer + cc;
            const float vv = Vs[c * D + dcol];
#pragma unroll
            for (int g = 0; g < G; ++g)
                acc[g] = fmaf(Ps[g * kBK + c], vv, acc[g]);
        }
    }

    // --- add the shares, divide, store -----------------------------------
    __syncthreads();
    float* sums = Ks;                    // [kKG][G][D]
#pragma unroll
    for (int g = 0; g < G; ++g) sums[(kg * G + g) * D + dcol] = acc[g];
    if (tid == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) red[g] = l[g];
    }
    __syncthreads();
    for (int i = tid; i < gn * D; i += kThreads) {
        const int g = i / D, d = i % D;
        float a = 0.f;
        for (int j = 0; j < kKG; ++j) a += sums[(j * G + g) * D + d];
        store(out + ((int64_t)b * H + h0 + g) * D + d,
              a / fmaxf(red[g], 1e-30f));
    }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* out, int B, int Sc, int H, int KV,
           const int64_t* st, float scale, int window, float softcap,
           int sink, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D, G>();
    // Set on every launch: the attribute belongs to the current device.
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int group = H / KV;
    const dim3 grid((unsigned)(B * KV), (unsigned)((group + G - 1) / G));
    decode_kernel<T, D, G><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, q_pos, k_pos, (T*)out, Sc, H,
        KV, group, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        scale, window, softcap, sink);
    return (int)cudaGetLastError();
}

// The q-row tile: the least of 1, 2, 4, 8, 16 that holds the GQA group.
template <typename T, int D>
int dispatch_group(int group, const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos, void* out, int B,
                   int Sc, int H, int KV, const int64_t* st, float scale,
                   int window, float softcap, int sink, cudaStream_t s) {
#define DECODE_LAUNCH(G)                                                   \
    return launch<T, D, G>(q, k, v, q_pos, k_pos, out, B, Sc, H, KV, st,  \
                           scale, window, softcap, sink, s)
    if (group <= 1) DECODE_LAUNCH(1);
    if (group <= 2) DECODE_LAUNCH(2);
    if (group <= 4) DECODE_LAUNCH(4);
    if (group <= 8) DECODE_LAUNCH(8);
    DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const int* q_pos, const int* k_pos, void* out, int B, int Sc,
             int H, int KV, const int64_t* st, float scale, int window,
             float softcap, int sink, cudaStream_t s) {
    const int group = H / KV;
    switch (D) {
        case 16:
            return dispatch_group<T, 16>(group, q, k, v, q_pos, k_pos, out,
                                         B, Sc, H, KV, st, scale, window,
                                         softcap, sink, s);
        case 32:
            return dispatch_group<T, 32>(group, q, k, v, q_pos, k_pos, out,
                                         B, Sc, H, KV, st, scale, window,
                                         softcap, sink, s);
        case 64:
            return dispatch_group<T, 64>(group, q, k, v, q_pos, k_pos, out,
                                         B, Sc, H, KV, st, scale, window,
                                         softcap, sink, s);
        case 128:
            return dispatch_group<T, 128>(group, q, k, v, q_pos, k_pos, out,
                                          B, Sc, H, KV, st, scale, window,
                                          softcap, sink, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q (B,1,H,D) with strides (batch, head); k/v (B,Sc,KV,D) with strides
// (batch, slot, head); every last axis contiguous; out (B,1,H,D)
// contiguous.  dtype 0 = f32, 1 = bf16.  Returns cudaGetLastError().
int decode_attention(const void* q, const void* k, const void* v,
                     const void* q_pos, const void* k_pos, void* out, int B,
                     int Sc, int H, int KV, int D, int64_t q_sb,
                     int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                     int window, float softcap, int sink, int dtype,
                     void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    if (Sc <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
    const int64_t st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    const int* qp = (const int*)q_pos;
    const int* kp = (const int*)k_pos;
    switch (dtype) {
        case 0:
            return dispatch<float>(D, q, k, v, qp, kp, out, B, Sc, H, KV, st,
                                   scale, window, softcap, sink, s);
        case 1:
            return dispatch<__nv_bfloat16>(D, q, k, v, qp, kp, out, B, Sc, H,
                                           KV, st, scale, window, softcap,
                                           sink, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
