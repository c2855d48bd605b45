// Prefill attention kernel for Hopper (sm_90a): causal online-softmax
// attention with GQA, sliding window, sink positions and tanh softcap.
//
// Replaces the Pallas kernel _fa_kernel of
// src/repro/kernels/flash_attention.py (flash_attention).
//
// Layout.  One block per (batch row, q head, tile of kBQ queries).  The TPU
// kernel carries the running max m, denominator l and output acc across
// its sequential minor grid axis over key tiles; here a loop inside the
// block walks the key tiles and keeps m, l and acc in registers, in f32.
// q, k and v are read in their public (B, S, heads, dh) layout through
// their strides (no transposed copies), 16 bytes at a time, and the
// ragged edges of Sq and Sk are masked in the kernel (no padding).  q head
// h reads KV head h / (H / KV).
//
// Semantics are those of the plain version (kernels/ref.py):
//   logits = (q . k) * dh^-1/2;  softcap: c * tanh(logits / c);
//   masked (causal, window, sink, k_pos < 0) -> -1e30, a finite sentinel;
//   online softmax in f32, p kept in f32 for the product with v;
//   out = acc / max(l, 1e-30), rounded once to the output type.
// Keys past Sk get -inf (weight exactly 0), so a row with no visible key
// averages v over the Sk real keys, as the plain softmax does.  A tile
// that no row of the block can see is skipped once every row of the block
// has seen a visible key: for such a row the tile adds p = exp(-1e30 - m)
// = 0 and alpha = 1 exactly, so skipping changes no bit.  Causal prefill
// thus skips the tiles above the diagonal.
//
// What bounds it on the card.  Causal attention at S = 2048, 32 heads of
// 64 does 2 * 2 * S^2/2 * H * dh = 17.2 GFLOP a layer against 8.4 MB of
// q, k, v and out: operations bound it (~17 us at 989 TFLOP/s bf16).  This
// first version multiplies in f32 on the CUDA cores (67 TFLOP/s at most),
// from shared memory, with each thread owning an 8 x 4 tile of logits and
// an 8 x dh/16 tile of the output; tensor cores (wgmma) and TMA are later
// work.  Products are explicit fmaf; the build's --fmad=false keeps every
// other multiply and add unfused.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;   // 8 row groups x 16 column lanes
constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per tile
constexpr int kRows = 8;        // queries per thread (kBQ / 8 row groups)
constexpr int kCols = 4;        // keys per thread (kBK / 16 lanes)
template <int D>
constexpr size_t smem_bytes() {
    return (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                    kBQ * (kBK + 1)) * sizeof(float) +
           (size_t)(kBQ + kBK) * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ k_pos, T* __restrict__ out, int Sq,
             int Sk, int H, int group, int64_t q_sb, int64_t q_ss,
             int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
             int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
             int window, float softcap, int sink) {
    constexpr int DP = D + 1;        // padded rows: no bank conflicts
    constexpr int PP = kBK + 1;
    constexpr int kOut = D / 16;     // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                // [kBQ][DP]
    float* Ks = Qs + kBQ * DP;       // [kBK][DP]
    float* Vs = Ks + kBK * DP;       // [kBK][D]
    float* Ps = Vs + kBK * D;        // [kBQ][PP]
    int* qps = (int*)(Ps + kBQ * PP);  // [kBQ]
    int* kps = qps + kBQ;            // [kBK]

    const int tid = threadIdx.x;
    const int ty = tid >> 4, tx = tid & 15;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int q0 = blockIdx.y * kBQ;
    const T* qb = q + b * q_sb + h * q_sh;
    const T* kb = k + b * k_sb + (h / group) * k_sh;
    const T* vb = v + b * v_sb + (h / group) * v_sh;

    load_tile<T, kBQ, D, DP, kThreads>(qb, q_ss, q0, Sq, Qs, tid);
    if (tid < kBQ) qps[tid] = q0 + tid < Sq ? q_pos[q0 + tid] : 0;

    bool row_ok[kRows];
    float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        row_ok[i] = q0 + ty * kRows + i < Sq;
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int o = 0; o < kOut; ++o) acc[i][o] = 0.f;
    }

    for (int k0 = 0; k0 < Sk; k0 += kBK) {
        __syncthreads();             // the last tile's smem is consumed
        if (tid < kBK) kps[tid] = k0 + tid < Sk ? k_pos[k0 + tid] : -1;
        __syncthreads();

        // --- skip a tile no row sees, once every row has seen a key -----
        int any_vis = 0, all_seen = 1;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (!row_ok[i]) continue;
            if (m[i] == kNegInf) all_seen = 0;
            const int qp = qps[ty * kRows + i];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int c = tx + 16 * j;
                if (k0 + c < Sk && visible(qp, kps[c], window, sink))
                    any_vis = 1;
            }
        }
        any_vis = __syncthreads_or(any_vis);
        all_seen = __syncthreads_and(all_seen);
        if (!any_vis && all_seen) continue;

        load_tile<T, kBK, D, DP, kThreads>(kb, k_ss, k0, Sk, Ks, tid);
        load_tile<T, kBK, D, D, kThreads>(vb, v_ss, k0, Sk, Vs, tid);
        __syncthreads();

        // --- logits: this thread's rows ty*8+i, keys tx+16j --------------
        float s[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float qv[kRows], kv[kCols];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
                qv[i] = Qs[(ty * kRows + i) * DP + d];
#pragma unroll
            for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
                for (int j = 0; j < kCols; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

        // --- online softmax; a row's 16 lanes share one half-warp ---------
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int qp = qps[ty * kRows + i];
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int c = tx + 16 * j;
                float x = s[i][j] * scale;
                if (softcap > 0.f) x = softcap * tanhf(x / softcap);
                if (k0 + c >= Sk)
                    x = -INFINITY;
                else if (!visible(qp, kps[c], window, sink))
                    x = kNegInf;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
#pragma unroll
            for (int o = 0; o < kOut; ++o) acc[i][o] *= alpha;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                Ps[(ty * kRows + i) * PP + tx + 16 * j] = s[i][j];
        }
        __syncthreads();

        // --- acc += p . v (p in f32) --------------------------------------
#pragma unroll 4
        for (int c = 0; c < kBK; ++c) {
            float pv[kRows], vv[kOut];
#pragma unroll
            for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * PP + c];
#pragma unroll
            for (int o = 0; o < kOut; ++o) vv[o] = Vs[c * D + tx + 16 * o];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
                for (int o = 0; o < kOut; ++o)
                    acc[i][o] = fmaf(pv[i], vv[o], acc[i][o]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        if (!row_ok[i]) continue;
        const int qi = q0 + ty * kRows + i;
        T* ob = out + ((int64_t)b * Sq + qi) * H * D + (int64_t)h * D;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int o = 0; o < kOut; ++o) store(ob + tx + 16 * o, acc[i][o] / den);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* out, int B, int Sq, int Sk, int H,
           int KV, const int64_t* st, float scale, int window,
           float softcap, int sink, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D>();
    // Set on every launch: the attribute belongs to the current device.
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
    flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, q_pos, k_pos, (T*)out, Sq, Sk,
        H, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], scale, window, softcap, sink);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const int* q_pos, const int* k_pos, void* out, int B, int Sq,
             int Sk, int H, int KV, const int64_t* st, float scale,
             int window, float softcap, int sink, cudaStream_t s) {
    switch (D) {
        case 16:
            return launch<T, 16>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                 KV, st, scale, window, softcap, sink, s);
        case 32:
            return launch<T, 32>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                 KV, st, scale, window, softcap, sink, s);
        case 64:
            return launch<T, 64>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                 KV, st, scale, window, softcap, sink, s);
        case 128:
            return launch<T, 128>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                  KV, st, scale, window, softcap, sink, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q (B,Sq,H,D), k/v (B,Sk,KV,D) with strides (batch, seq, head) and a
// contiguous last axis; out (B,Sq,H,D) contiguous.  dtype 0 = f32,
// 1 = bf16.  Returns cudaGetLastError() after the launch.
int flash_attention(const void* q, const void* k, const void* v,
                    const void* q_pos, const void* k_pos, void* out, int B,
                    int Sq, int Sk, int H, int KV, int D, int64_t q_sb,
                    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    float scale, int window, float softcap, int sink,
                    int dtype, void* stream) {
    if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
    if (Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
    const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    const int* qp = (const int*)q_pos;
    const int* kp = (const int*)k_pos;
    switch (dtype) {
        case 0:
            return dispatch<float>(D, q, k, v, qp, kp, out, B, Sq, Sk, H, KV,
                                   st, scale, window, softcap, sink, s);
        case 1:
            return dispatch<__nv_bfloat16>(D, q, k, v, qp, kp, out, B, Sq,
                                           Sk, H, KV, st, scale, window,
                                           softcap, sink, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
