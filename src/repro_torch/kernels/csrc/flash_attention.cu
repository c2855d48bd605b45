// Prefill attention kernels for Hopper (sm_90a): causal online-softmax
// attention with GQA, sliding window, sink positions and tanh softcap.
//
// Replaces the Pallas kernel _fa_kernel of
// src/repro/kernels/flash_attention.py (flash_attention).
//
// Semantics are those of the plain version (kernels/ref.py):
//   logits = (q . k) * dh^-1/2;  softcap: c * tanh(logits / c);
//   masked (causal, window, sink, k_pos < 0) -> -1e30, a finite sentinel;
//   online softmax in f32, p kept in f32 for the product with v;
//   out = acc / max(l, 1e-30), rounded once to the output type.
// Keys past Sk get -inf (weight exactly 0), so a row with no visible key
// averages v over the Sk real keys, as the plain softmax does.  q, k and v
// are read in their public (B, S, heads, dh) layout through their strides
// (no transposed copies), 16 bytes at a time, and the ragged edges of Sq
// and Sk are masked in the kernel (no padding).  q head h reads KV head
// h / (H / KV).  As on the TPU, the running max m, denominator l and
// output acc of a query tile are carried across the key tiles, here by a
// loop inside the block, in registers, in f32.
//
// Tile skip.  A key tile is skipped when no row of the block can see any
// of its keys and every row has already seen a visible key: for such a
// row the tile adds p = exp(-1e30 - m) = 0 with alpha = 1 exactly, so the
// skip changes no bit.  Causal prefill thus skips the tiles above the
// diagonal, a window with a sink the tiles outside both.
//
// What bounds it on the card.  Causal attention at S = 2048, 32 heads of
// 64 does 2 * 2 * S(S+1)/2 * H * dh = 17.2 GFLOP a layer against 8.4 MB of
// q, k, v and out: operations bound it (17.4 us at 989 TFLOP/s bf16).
//
// bf16 (what the models serve): flash_mma_kernel, on the tensor cores.
// One block of 4 warps per (batch row, q head, tile of 64 queries); each
// warp owns 16 query rows.  Its Q fragment is loaded once (ldmatrix) and
// stays in registers; S = Q K^T runs as mma.sync m16n8k16 (bf16 in, f32
// accumulate: the products of bf16 values are exact in f32, so only the
// order of the sums differs from the plain version); the online softmax
// works on the accumulator fragments, with the row max and sum over the
// four lanes of a quad.  P stays in registers: the m16n8k16 accumulator
// layout is the A-operand layout of the next mma.  The plain version (and
// the JAX kernel) keeps P in f32, so P is split into hi = bf16(P) and
// lo = bf16(P - hi) and both go through the tensor cores into one f32
// accumulator (V is exact in bf16; P keeps about 16 significant bits).
// That doubles the P.V products: the split work is 1.5 x 17.2 GFLOP, a
// bound of ~26 us.  PyTorch's SDPA rounds P to bf16 once, so it does the
// smaller, coarser work.  K and V stay bf16 in shared memory, in a
// two-stage ring filled by 16-byte cp.async (zero-filled past Sk), so
// tile j+1 arrives while tile j is computed; rows are padded by 16 bytes,
// so ldmatrix (V with .trans) meets no bank conflicts.  Heavy query tiles
// (the last ones of a causal prefill) are launched first.  Which key
// tiles a block must walk is decided from the positions alone, 32 tiles
// at a time, before their loads are issued.  e^x is taken as
// 2^(x log2 e).  Up to dh 64 the registers are held to 128 a thread so
// four blocks (16 warps) share an SM: the softmax arithmetic on the CUDA
// cores then overlaps other warps' mma.  mma.sync reaches only part of
// the tensor cores' rate; wgmma with TMA producers is later work.
//
// f32 (the check route: phase 4's f32 cases and the full-width f32 logit
// checks of chip_smoke.py): flash_kernel, the CUDA-core kernel of the
// first port, with f32 products from shared memory (fmaf; the build's
// --fmad=false keeps every other multiply and add unfused), each thread
// owning an 8 x 4 tile of logits and an 8 x dh/16 tile of the output.
#include <climits>

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------
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


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kMWarps = 4;
constexpr int kMThreads = 32 * kMWarps;
constexpr int kMBQ = 16 * kMWarps;   // queries per block, 16 a warp
constexpr int kMBK = 64;             // keys per tile
constexpr int kQW = kMBQ / 32;       // warps that span the query tile

// Shared memory: Q [kMBQ][D+8], K and V [2][kMBK][D+8] (bf16), the key
// positions [2][kMBK], and 16 ints of block state.
template <int D>
constexpr size_t mma_smem_bytes() {
    return (size_t)(kMBQ + 4 * kMBK) * (D + 8) * sizeof(bf16) +
           (size_t)(2 * kMBK + 16) * sizeof(int);
}

// e^x as 2^(x log2 e): one multiply and the hardware's exp2, where expf
// spends a range reduction (relative error ~|x| 6e-8, far inside the
// bounds; masked logits still give exactly 0 or 1).
__device__ __forceinline__ float fexp(float x) {
    return exp2f(x * 1.4426950408889634f);
}

// Up to dh 64 four blocks share an SM (at most 128 registers a thread);
// at dh 128 the accumulators need more, and two do.
template <int D>
__global__ void __launch_bounds__(kMThreads, D <= 64 ? 4 : 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ k_pos, bf16* __restrict__ out,
                 int Sq, int Sk, int H, int group, int64_t q_sb,
                 int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 float scale, int window, float softcap, int sink) {
    constexpr int P = D + 8;          // row pitch (elements): 16 bytes pad
    constexpr int CPR = D / 8;        // 16-byte chunks a row
    constexpr int KT = D / 16;        // k steps of Q K^T
    constexpr int NT = kMBK / 8;      // key columns of 8 in S
    constexpr int DT = D / 8;         // output columns of 8
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kMBQ][P]
    bf16* Ks = Qs + kMBQ * P;                       // [2][kMBK][P]
    bf16* Vs = Ks + 2 * kMBK * P;                   // [2][kMBK][P]
    int* kps = reinterpret_cast<int*>(Vs + 2 * kMBK * P);   // [2][kMBK]
    int* info = kps + 2 * kMBK;                     // [16]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kMBQ;   // heavy tiles first
    const bf16* qb = q + b * q_sb + h * q_sh;
    const bf16* kb = k + b * k_sb + (h / group) * k_sh;
    const bf16* vb = v + b * v_sb + (h / group) * v_sh;

    // --- the Q tile to shared memory (zeros past Sq) ------------------------
    for (int c = tid; c < kMBQ * CPR; c += kMThreads) {
        const int r = c / CPR, cc = c % CPR;
        const bool ok = q0 + r < Sq;
        cp_async16(smem_addr(Qs + r * P + cc * 8),
                   qb + (ok ? (int64_t)(q0 + r) * q_ss : 0) + cc * 8, ok);
    }

    // --- the block's position range --------------------------------------
    if (warp < kQW) {
        const bool ok = q0 + tid < Sq;
        const int p = ok ? q_pos[q0 + tid] : 0;
        const int mn = __reduce_min_sync(0xffffffffu, ok ? p : INT_MAX);
        const int mx = __reduce_max_sync(0xffffffffu, ok ? p : INT_MIN);
        if (lane == 0) {
            info[8 + 2 * warp] = mn;
            info[8 + 2 * warp + 1] = mx;
        }
    }
    // this thread's rows of S and of the output
    const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
    const bool ok0 = q0 + r0 < Sq, ok1 = q0 + r1 < Sq;
    const int qp0 = ok0 ? q_pos[q0 + r0] : 0;
    const int qp1 = ok1 ? q_pos[q0 + r1] : 0;
    __syncthreads();
    int qmin = info[8], qmax = info[9];
#pragma unroll
    for (int w = 1; w < kQW; ++w) {
        qmin = min(qmin, info[8 + 2 * w]);
        qmax = max(qmax, info[9 + 2 * w]);
    }

    // --- which key tiles to walk, from the positions alone ----------------
    // A key may be seen by some row of the block (maybe), is seen by every
    // row (all), and a tile is full when all its keys are in range and
    // seen by every row (no mask to apply).  Bits for 32 tiles at a time.
    const int ntiles = (Sk + kMBK - 1) / kMBK;
    int chunk = -1;
    uint32_t maybe_bits = 0, all_bits = 0, full_bits = 0;
    bool seen_all = false;       // every row has a visible key behind it
    auto classify = [&](int c) {          // block-uniform; 3 barriers
        __syncthreads();
        if (tid == 0) {
            info[4] = 0;
            info[5] = 0;
            info[6] = 0;
        }
        __syncthreads();
        for (int i = 0; i < 32 * kMBK / kMThreads; ++i) {
            const int key = c * 32 * kMBK + i * kMThreads + tid;
            const int t = (i * kMThreads + tid) / kMBK;   // warp-uniform
            const bool in = key < Sk;
            const int kp = in ? k_pos[key] : -1;
            const bool maybe =
                in && kp >= 0 && kp <= qmax &&
                (window <= 0 || kp > qmin - window || (sink > 0 && kp < sink));
            const bool all =
                in && kp >= 0 && kp <= qmin &&
                (window <= 0 || kp > qmax - window || (sink > 0 && kp < sink));
            const bool any_maybe = __any_sync(0xffffffffu, maybe);
            const bool any_all = __any_sync(0xffffffffu, all);
            const bool every_all = __all_sync(0xffffffffu, all);
            if (lane == 0) {
                if (any_maybe) atomicOr((unsigned*)&info[4], 1u << t);
                if (any_all) atomicOr((unsigned*)&info[5], 1u << t);
                if (!every_all) atomicOr((unsigned*)&info[6], 1u << t);
            }
        }
        __syncthreads();
        maybe_bits = (uint32_t)info[4];
        all_bits = (uint32_t)info[5];
        full_bits = ~(uint32_t)info[6];
        chunk = c;
    };
    // the first tile at or after t to walk (ntiles: none)
    auto next_tile = [&](int t) -> int {
        while (t < ntiles) {
            if ((t >> 5) != chunk) classify(t >> 5);
            if (!seen_all) return t;
            const uint32_t m = maybe_bits & (0xffffffffu << (t & 31));
            if (m) return (chunk << 5) + __ffs(m) - 1;
            t = (chunk + 1) << 5;
        }
        return ntiles;
    };
    auto load_kv = [&](int t, int st) {
        const int k0 = t * kMBK;
        for (int c = tid; c < kMBK * CPR; c += kMThreads) {
            const int r = c / CPR, cc = c % CPR;
            const bool ok = k0 + r < Sk;
            const int64_t row = ok ? k0 + r : 0;
            cp_async16(smem_addr(Ks + (st * kMBK + r) * P + cc * 8),
                       kb + row * k_ss + cc * 8, ok);
            cp_async16(smem_addr(Vs + (st * kMBK + r) * P + cc * 8),
                       vb + row * v_ss + cc * 8, ok);
        }
        if (tid < kMBK) {
            const bool ok = k0 + tid < Sk;
            cp_async4(smem_addr(kps + st * kMBK + tid),
                      k_pos + (ok ? k0 + tid : 0), ok);
        }
    };

    int cur = next_tile(0);               // always 0: no row has seen a key
    bool cur_full = (full_bits >> (cur & 31)) & 1u;
    if ((all_bits >> (cur & 31)) & 1u) seen_all = true;
    load_kv(cur, 0);
    cp_async_commit();                    // group: Q and the first tile

    uint32_t qf[KT][4];
    float o[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    bool have_q = false;
    int st = 0;

    while (cur < ntiles) {
        // --- issue the next tile's loads, then wait for this one's -------
        const int nxt = next_tile(cur + 1);
        bool nxt_full = false;
        if (nxt < ntiles) {
            nxt_full = (full_bits >> (nxt & 31)) & 1u;
            if ((all_bits >> (nxt & 31)) & 1u) seen_all = true;
            load_kv(nxt, st ^ 1);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (!have_q) {
#pragma unroll
            for (int kt = 0; kt < KT; ++kt)
                ldmatrix_x4(qf[kt],
                            smem_addr(Qs + (warp * 16 + (lane & 15)) * P +
                                      kt * 16 + (lane >> 4) * 8));
            have_q = true;
        }
        const bf16* Kt = Ks + st * kMBK * P;
        const bf16* Vt = Vs + st * kMBK * P;
        const int* kpt = kps + st * kMBK;
        const int k0 = cur * kMBK;

        // --- S = Q K^T on the tensor cores ---------------------------------
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
            for (int kt = 0; kt < KT; ++kt) {
                uint32_t kf[4];
                ldmatrix_x4(kf, smem_addr(
                    Kt + (16 * j + (lane & 7) + 8 * (lane >> 4)) * P
                    + kt * 16 + 8 * ((lane >> 3) & 1)));
                mma_bf16(s[2 * j], qf[kt], kf[0], kf[1]);
                mma_bf16(s[2 * j + 1], qf[kt], kf[2], kf[3]);
            }
        }

        // --- scale, softcap, mask; online softmax on the fragments ------
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale;
                if (softcap > 0.f) x = softcap * tanhf(x / softcap);
                if (!cur_full) {
                    const int c = 8 * j + 2 * (lane & 3) + (e & 1);
                    if (k0 + c >= Sk)
                        x = -INFINITY;
                    else if (!visible(e < 2 ? qp0 : qp1, kpt[c], window,
                                      sink))
                        x = kNegInf;
                }
                s[j][e] = x;
            }
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = fexp(m0 - mn0), a1 = fexp(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            s[j][0] = fexp(s[j][0] - mn0);
            s[j][1] = fexp(s[j][1] - mn0);
            s[j][2] = fexp(s[j][2] - mn1);
            s[j][3] = fexp(s[j][3] - mn1);
            sum0 += s[j][0] + s[j][1];
            sum1 += s[j][2] + s[j][3];
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
            sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
        }
        l0 = l0 * a0 + sum0;
        l1 = l1 * a1 + sum1;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
            o[j][0] *= a0;
            o[j][1] *= a0;
            o[j][2] *= a1;
            o[j][3] *= a1;
        }

        // --- O += (P_hi + P_lo) V, P from the registers -----------------
#pragma unroll
        for (int j = 0; j < kMBK / 16; ++j) {
            uint32_t pa[kPTerms][4];      // A fragments, one per term
            split_bf16(s[2 * j][0], s[2 * j][1], &pa[0][0], 4);
            split_bf16(s[2 * j][2], s[2 * j][3], &pa[0][1], 4);
            split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], &pa[0][2], 4);
            split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], &pa[0][3], 4);
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, smem_addr(
                    Vt + (16 * j + (lane & 7) + 8 * ((lane >> 3) & 1)) * P
                    + 16 * dp + 8 * (lane >> 4)));
#pragma unroll
                for (int i = 0; i < kPTerms; ++i) {
                    mma_bf16(o[2 * dp], pa[i], vf[0], vf[1]);
                    mma_bf16(o[2 * dp + 1], pa[i], vf[2], vf[3]);
                }
            }
        }
        __syncthreads();       // this stage is consumed before it refills
        cur = nxt;
        cur_full = nxt_full;
        st ^= 1;
    }
    cp_async_wait<0>();

    // --- out = acc / max(l, 1e-30), rounded once --------------------------
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    bf16* ob = out + ((int64_t)b * Sq + q0) * H * D + (int64_t)h * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        if (ok0)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + (int64_t)r0 * H * D + col) =
                __floats2bfloat162_rn(o[j][0] / d0, o[j][1] / d0);
        if (ok1)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + (int64_t)r1 * H * D + col) =
                __floats2bfloat162_rn(o[j][2] / d1, o[j][3] / d1);
    }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* q_pos,
               const int* k_pos, void* out, int B, int Sq, int Sk, int H,
               int KV, const int64_t* st, float scale, int window,
               float softcap, int sink, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D>();
    // Set on every launch: the attribute belongs to the current device.
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
    flash_kernel<float, D><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, q_pos, k_pos,
        (float*)out, Sq, Sk, H, H / KV, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale, window, softcap, sink);
    return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int* q_pos,
               const int* k_pos, void* out, int B, int Sq, int Sk, int H,
               int KV, const int64_t* st, float scale, int window,
               float softcap, int sink, cudaStream_t stream) {
    constexpr size_t smem = mma_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kMBQ - 1) / kMBQ));
    flash_mma_kernel<D><<<grid, kMThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, q_pos, k_pos,
        (bf16*)out, Sq, Sk, H, H / KV, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale, window, softcap, sink);
    return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* q_pos, const int* k_pos, void* out, int B, int Sq,
           int Sk, int H, int KV, const int64_t* st, float scale, int window,
           float softcap, int sink, cudaStream_t s) {
    switch (dtype) {
        case 0:
            return launch_f32<D>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                 KV, st, scale, window, softcap, sink, s);
        case 1:
            return launch_mma<D>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                 KV, st, scale, window, softcap, sink, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q (B,Sq,H,D), k/v (B,Sk,KV,D) with strides (batch, seq, head) and a
// contiguous last axis; out (B,Sq,H,D) contiguous.  dtype 0 = f32 (the
// CUDA-core kernel), 1 = bf16 (the tensor-core kernel).  Returns
// cudaGetLastError() after the launch.
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
#define FLASH_LAUNCH(D_)                                                    \
    return launch<D_>(dtype, q, k, v, qp, kp, out, B, Sq, Sk, H, KV, st,   \
                      scale, window, softcap, sink, s)
    switch (D) {
        case 16: FLASH_LAUNCH(16);
        case 32: FLASH_LAUNCH(32);
        case 64: FLASH_LAUNCH(64);
        case 128: FLASH_LAUNCH(128);
        default: return (int)cudaErrorInvalidValue;
    }
#undef FLASH_LAUNCH
}

}  // extern "C"
