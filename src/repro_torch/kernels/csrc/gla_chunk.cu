// Chunked gated linear attention for Hopper (sm_90a): the mLSTM (xLSTM)
// and Mamba/SSD (Hymba) recurrence
//
//   S_t = f_t S_{t-1} + i_t k_t v_t^T,  n_t = f_t n_{t-1} + i_t k_t,
//   y_t = q_t^T S_t  [/ max(|q_t . n_t|, 1)],   q scaled by dk^-1/2,
//
// evaluated chunkwise.  Replaces the Pallas kernel _gla_kernel of
// src/repro/kernels/gla_chunk.py (gla_chunk).
//
// Layout.  The TPU grid is (batch*heads, chunks) with the chunk axis run in
// order, carrying the (dk x dv) f32 state and the (dk,) normaliser in VMEM
// scratch.  Here one block per (batch row, head, slice of kDVT columns of
// dv) loops over the chunks itself.  The hazard is the size of the state:
// at dk = dv = 512 (xLSTM) it is 1 MB of f32 a head, and a block has at
// most 227 KB of shared memory.  So dv is split across blocks: a block
// keeps its dk x kDVT slice of the state (64 KB at dk = 512) and the whole
// normaliser in shared memory.  The scores A and the normaliser do not
// depend on dv, so every dv-slice block recomputes them (duplicated work
// in this first version) and only slice 0 writes the final normaliser.
//
// Per chunk of L <= 256 positions (bc = the within-chunk cumulative log
// decay, computed by the wrapper with torch.cumsum, as the JAX wrapper
// computes it outside its kernel):
//   1. v's column slice for the chunk is staged in shared memory, and the
//      state-carry weights w_s = exp(bc_end - bc_s + li_s) are formed;
//   2. the chunk is walked in row tiles of kRT queries.  For each, q and k
//      are streamed in dk slices of kKT: the tile's scores q_t . k_s
//      (s < the tile's end), its decayed read of the carried state
//      q_t . S[:, slice] and q_t . n accumulate in registers;
//      A_ts = (q_t . k_s) exp(bc_t - bc_s + li_s) is formed for s <= t
//      only (above the diagonal the exp may overflow, and 0 * inf is NaN);
//      y_t = sum_s A_ts v_s + exp(bc_t) q_t . S, divided by
//      max(|sum_s A_ts + exp(bc_t) q_t . n|, 1) when normalising;
//   3. after every row tile has read the old state, the state and the
//      normaliser take the chunk: S = exp(bc_end) S + (k w)^T v,
//      n = exp(bc_end) n + sum_s k_s w_s.
// q, k and v are read in their public (B, S, H, d) layout through their
// strides, 16 bytes at a time (the wrapper checks alignment); ragged
// chunk, dk and dv edges are masked here.  An initial (S0, n0) may be
// given (zeros when null).  Products are explicit fmaf in f32 on the CUDA
// cores (the build's --fmad=false keeps every other multiply and add
// unfused), as the JAX kernel multiplies in f32; tensor cores are later
// work.
//
// What bounds it on the card.  For an xLSTM layer (4 heads, dk = dv = 512)
// at a 2048-token prefill the recurrence needs ~10.7 GFLOP on and below
// the chunks' diagonals (~11 us at 989 TFLOP/s bf16, 160 us at 67 TFLOP/s
// f32) and moves ~38 MB (~11 us at 3.35 TB/s).  For a Hymba layer (25
// heads, dk 16, dv 128, 2304 padded tokens) ~2.6 GFLOP and ~33 MB: bytes
// bound it.  This version is far from either: it multiplies in f32 on the
// CUDA cores, recomputes the L x L scores in each of the dv / kDVT column
// blocks, and fills 64 (xLSTM) or 100 (Hymba) of the 132 SMs with one
// block each, at batch 1.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kRT = 32;          // queries per row tile (4 per warp)
constexpr int kKT = 32;          // dk slice streamed per step
constexpr int kKP = kKT + 1;     // padded pitch: conflict-free column reads
constexpr int kDVT = 32;         // dv columns per block (one per lane)
constexpr int kMaxL = 256;       // longest chunk
constexpr int kAP = kMaxL + 1;   // pitch of the score rows
constexpr int kRows = kRT / 8;   // query rows per warp
constexpr int kCols = kMaxL / 32;  // score columns per lane

size_t smem_floats(int dk) {
    return (size_t)dk * kDVT + dk + 3 * kMaxL + kMaxL * kDVT + kRT * kAP +
           kRT * kKP + kMaxL * kKP;
}

// Rows [0, nrows) of a row-strided matrix (row stride ss elements) into
// dst (pitch P) as f32: columns [c0, c0 + 32) of the row, each times
// rowmul[r] (or mul when rowmul is null).  Rows at or past nvalid and
// columns at or past d are zeros.  16-byte loads, up to four in flight per
// thread before any is stored; d is a multiple of the vector width.
template <typename T, int P>
__device__ __forceinline__ void load_cols(const T* __restrict__ src,
                                          int64_t ss, int nrows, int nvalid,
                                          int c0, int d, const float* rowmul,
                                          float mul, float* dst, int tid) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = 32 / V;
    constexpr int BATCH = 4;
    const int total = nrows * CPR;
    for (int base = 0; base < total; base += BATCH * kThreads) {
        uint4 u[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int c = base + tid + i * kThreads;
            const int r = c / CPR, col = c0 + (c % CPR) * V;
            u[i] = make_uint4(0u, 0u, 0u, 0u);
            if (c < total && r < nvalid && col < d)
                u[i] = *reinterpret_cast<const uint4*>(
                    src + (int64_t)r * ss + col);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int c = base + tid + i * kThreads;
            if (c >= total) break;
            const int r = c / CPR;
            float f[V];
            unpack(u[i], f, T());
            const float m = rowmul ? rowmul[r] : mul;
            float* o = dst + r * P + (c % CPR) * V;
#pragma unroll
            for (int j = 0; j < V; ++j) o[j] = f[j] * m;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bc,
           const float* __restrict__ li, const float* __restrict__ s0,
           const float* __restrict__ n0, T* __restrict__ y,
           float* __restrict__ sT, float* __restrict__ nT, int S, int H,
           int dk, int dv, int L, int64_t q_sb, int64_t q_ss, int64_t q_sh,
           int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
           int64_t v_ss, int64_t v_sh, float scale, int normalize) {
    extern __shared__ float smem[];
    float* Ss = smem;                    // [dk][kDVT] state slice
    float* ns = Ss + dk * kDVT;          // [dk] normaliser
    float* bcs = ns + dk;                // [kMaxL] cumulative log decay
    float* lis = bcs + kMaxL;            // [kMaxL] log input gate
    float* ws = lis + kMaxL;             // [kMaxL] state-carry weights
    float* Vs = ws + kMaxL;              // [kMaxL][kDVT] v's column slice
    float* As = Vs + kMaxL * kDVT;       // [kRT][kAP] the tile's scores
    float* Qs = As + kRT * kAP;          // [kRT][kKP] q slice (scaled)
    float* Ks = Qs + kRT * kKP;          // [kMaxL][kKP] k slice

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H;
    const int v0 = blockIdx.y * kDVT;
    const bool col_ok = v0 + lane < dv;
    const T* qb = q + b * q_sb + h * q_sh;
    const T* kb = k + b * k_sb + h * k_sh;
    const T* vb = v + b * v_sb + h * v_sh;
    const float* bcb = bc + (int64_t)bh * S;
    const float* lib = li + (int64_t)bh * S;

    for (int i = tid; i < dk * kDVT; i += kThreads) {
        const int c = v0 + i % kDVT;
        Ss[i] = (s0 != nullptr && c < dv)
                    ? s0[((int64_t)bh * dk + i / kDVT) * dv + c] : 0.f;
    }
    for (int i = tid; i < dk; i += kThreads)
        ns[i] = n0 != nullptr ? n0[(int64_t)bh * dk + i] : 0.f;

    for (int c0 = 0; c0 < S; c0 += L) {
        __syncthreads();                 // the last chunk's smem is consumed
        for (int t = tid; t < L; t += kThreads) {
            bcs[t] = bcb[c0 + t];
            lis[t] = lib[c0 + t];
        }
        load_cols<T, kDVT>(vb + c0 * v_ss, v_ss, L, L, v0, dv, nullptr, 1.f,
                           Vs, tid);
        __syncthreads();
        const float b_end = bcs[L - 1];
        for (int t = tid; t < L; t += kThreads)
            ws[t] = expf(b_end - bcs[t] + lis[t]);

        for (int r0 = 0; r0 < L; r0 += kRT) {
            const int cend = min(r0 + kRT, L);     // keys s < cend
            const int jn = (cend + 31) / 32;       // live score columns
            float acc[kRows][kCols], yi[kRows], ni[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                yi[i] = 0.f;
                ni[i] = 0.f;
#pragma unroll
                for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
            }
            for (int k0 = 0; k0 < dk; k0 += kKT) {
                __syncthreads();         // Qs, Ks of the last step consumed
                load_cols<T, kKP>(qb + (c0 + r0) * q_ss, q_ss, kRT, L - r0,
                                  k0, dk, nullptr, scale, Qs, tid);
                load_cols<T, kKP>(kb + c0 * k_ss, k_ss, 32 * jn, cend, k0,
                                  dk, nullptr, 1.f, Ks, tid);
                __syncthreads();
                const int dn = min(kKT, dk - k0);
#pragma unroll 4
                for (int d = 0; d < dn; ++d) {
                    float qv[kRows];
#pragma unroll
                    for (int i = 0; i < kRows; ++i)
                        qv[i] = Qs[(warp * kRows + i) * kKP + d];
                    const float sv = Ss[(k0 + d) * kDVT + lane];
                    const float nv = ns[k0 + d];
#pragma unroll
                    for (int j = 0; j < kCols; ++j) {
                        if (j < jn) {
                            const float kv = Ks[(lane + 32 * j) * kKP + d];
#pragma unroll
                            for (int i = 0; i < kRows; ++i)
                                acc[i][j] = fmaf(qv[i], kv, acc[i][j]);
                        }
                    }
#pragma unroll
                    for (int i = 0; i < kRows; ++i) {
                        yi[i] = fmaf(qv[i], sv, yi[i]);
                        ni[i] = fmaf(qv[i], nv, ni[i]);
                    }
                }
            }

            // --- decay mask (s <= t only), scores to smem, row sums --------
            float rsum[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int tr = warp * kRows + i;     // row within the tile
                const int t = r0 + tr;               // row within the chunk
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    if (j < jn) {
                        const int s = lane + 32 * j;
                        float a = 0.f;
                        if (s <= t && t < L)
                            a = acc[i][j] *
                                expf(bcs[t] - bcs[s] + lis[s]);
                        As[tr * kAP + s] = a;
                        sum += a;
                    }
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    sum += __shfl_xor_sync(0xffffffffu, sum, off);
                rsum[i] = sum;
            }
            __syncwarp();                // a warp reads only its own rows

            // --- y = A v + exp(bc_t) q.S [/ den] --------------------------
            float yv[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) yv[i] = 0.f;
            for (int s = 0; s < cend; ++s) {
                const float vv = Vs[s * kDVT + lane];
#pragma unroll
                for (int i = 0; i < kRows; ++i)
                    yv[i] = fmaf(As[(warp * kRows + i) * kAP + s], vv, yv[i]);
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int t = r0 + warp * kRows + i;
                if (t >= L || !col_ok) continue;
                const float dec = expf(bcs[t]);
                float out = yv[i] + dec * yi[i];
                if (normalize)
                    out = out / fmaxf(fabsf(rsum[i] + dec * ni[i]), 1.f);
                store(y + (((int64_t)b * S + c0 + t) * H + h) * dv + v0 + lane,
                      out);
            }
        }

        // --- state carry, after every row tile has read the old state -----
        const float eb = expf(b_end);
        for (int k0 = 0; k0 < dk; k0 += kKT) {
            __syncthreads();             // old state read; Ks consumed
            load_cols<T, kKP>(kb + c0 * k_ss, k_ss, L, L, k0, dk, ws, 1.f,
                              Ks, tid);
            __syncthreads();
            const int dn = min(kKT, dk - k0);
            float su[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) su[i] = 0.f;
            for (int s = 0; s < L; ++s) {
                const float vv = Vs[s * kDVT + lane];
#pragma unroll
                for (int i = 0; i < kRows; ++i)
                    su[i] = fmaf(Ks[s * kKP + warp * kRows + i], vv, su[i]);
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int kk = warp * kRows + i;
                if (kk < dn) {
                    float* sp = Ss + (k0 + kk) * kDVT + lane;
                    *sp = eb * *sp + su[i];
                }
            }
            if (warp == 0 && lane < dn) {
                float sn = 0.f;
                for (int s = 0; s < L; ++s) sn += Ks[s * kKP + lane];
                ns[k0 + lane] = eb * ns[k0 + lane] + sn;
            }
        }
    }

    __syncthreads();
    for (int i = tid; i < dk * kDVT; i += kThreads) {
        const int c = v0 + i % kDVT;
        if (c < dv) sT[((int64_t)bh * dk + i / kDVT) * dv + c] = Ss[i];
    }
    if (blockIdx.y == 0)
        for (int i = tid; i < dk; i += kThreads)
            nT[(int64_t)bh * dk + i] = ns[i];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bc,
           const float* li, const float* s0, const float* n0, void* y,
           float* sT, float* nT, int B, int S, int H, int dk, int dv, int L,
           const int64_t* st, float scale, int normalize,
           cudaStream_t stream) {
    const size_t smem = smem_floats(dk) * sizeof(float);
    // Set on every launch: the attribute belongs to the current device.
    cudaError_t e = cudaFuncSetAttribute(
        gla_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(B * H), (unsigned)((dv + kDVT - 1) / kDVT));
    gla_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, bc, li, s0, n0, (T*)y, sT,
        nT, S, H, dk, dv, L, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], scale, normalize);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k (B,S,H,dk) and v (B,S,H,dv) with strides (batch, seq, head) and a
// contiguous last axis; bc, li (B*H, S) f32 contiguous, bc the within-chunk
// cumulative log forget gate; s0 (B,H,dk,dv), n0 (B,H,dk) f32 or null;
// y (B,S,H,dv) contiguous in q's dtype; sT, nT like s0, n0.  S is a
// multiple of the chunk L (1 <= L <= 256); dk and dv multiples of 8.
// dtype 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the launch.
int gla_chunk(const void* q, const void* k, const void* v, const void* bc,
              const void* li, const void* s0, const void* n0, void* y,
              void* sT, void* nT, int B, int S, int H, int dk, int dv, int L,
              int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
              int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
              int64_t v_sh, float scale, int normalize, int dtype,
              void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
    if (L <= 0 || L > kMaxL || S % L != 0 || dk <= 0 || dv <= 0 ||
        dk % 8 != 0 || dv % 8 != 0 ||
        smem_floats(dk) * sizeof(float) > 232448)
        return (int)cudaErrorInvalidValue;
    const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    const float* f_bc = (const float*)bc;
    const float* f_li = (const float*)li;
    const float* f_s0 = (const float*)s0;
    const float* f_n0 = (const float*)n0;
    switch (dtype) {
        case 0:
            return launch<float>(q, k, v, f_bc, f_li, f_s0, f_n0, y,
                                 (float*)sT, (float*)nT, B, S, H, dk, dv, L,
                                 st, scale, normalize, s);
        case 1:
            return launch<__nv_bfloat16>(q, k, v, f_bc, f_li, f_s0, f_n0, y,
                                         (float*)sT, (float*)nT, B, S, H, dk,
                                         dv, L, st, scale, normalize, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
