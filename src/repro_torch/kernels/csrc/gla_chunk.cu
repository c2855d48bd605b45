// Chunked gated linear attention for Hopper (sm_90a): the mLSTM (xLSTM)
// and Mamba/SSD (Hymba) recurrence
//
//   S_t = f_t S_{t-1} + i_t k_t v_t^T,  n_t = f_t n_{t-1} + i_t k_t,
//   y_t = q_t^T S_t  [/ max(|q_t . n_t|, 1)],   q scaled by dk^-1/2,
//
// evaluated chunkwise.  Replaces the Pallas kernel _gla_kernel of
// src/repro/kernels/gla_chunk.py (gla_chunk), whose grid (batch*heads,
// chunks) runs the chunks in order and carries the f32 (dk x dv) state
// and the (dk,) normaliser in VMEM from one chunk to the next.  q, k and v
// are read in their public (B, S, H, d) layout through their strides, 16
// bytes at a time (the wrapper checks alignment); ragged chunk, dk and dv
// edges are masked here.  An initial (S0, n0) may be given (zeros when
// null).  bc is the within-chunk inclusive cumulative log forget gate, li
// the log input gate.
//
// bf16 (what the models serve): the tensor-core route, four launches a
// call.  On Hopper nothing carries over between blocks, so the carry is
// taken out of the chunk loop:
//   1. gla_state_kernel, one block per (chunk, 64 dk rows, 64 dv
//      columns): the chunk's gates (bc by a block scan of log f, written
//      out for the later launches) and its own contribution
//      dS_c = (k w)^T v, dn_c = sum_s k_s w_s, w_s = exp(bc_end - bc_s +
//      li_s), on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//      accumulate): k arrives by ldmatrix.trans as the A operand, each
//      value is scaled by its w in f32 and split into bf16 hi = bf16(x)
//      and lo = bf16(x - hi), and both terms meet bf16 v (exact) in one
//      f32 accumulator; k w keeps about 16 significant bits.
//   2. gla_scan_kernel, elementwise over (B*H, dk, dv) and serial over the
//      chunks, in f32: S_in[0] = S0, S_in[c+1] = exp(bc_end_c) S_in[c] +
//      dS_c (and n); each entering state from chunk 1 on (chunk 0's too
//      when S0 is given) is stored as bf16 hi and lo planes, the last is
//      sT, nT.
//   3. gla_score_kernel, one block per (chunk, 64 x 64 tile on or below
//      its diagonal): A_ts = (q_t . k_s) exp(bc_t - bc_s + li_s) for
//      s <= t (above the diagonal the exp may overflow, and 0 * inf is
//      NaN), q and k bf16 (exact), to an f32 scratch with the rows' sums
//      per tile (the normaliser's).  Once per chunk, not once per dv tile.
//   4. gla_out_kernel, one block per (chunk and R query rows, batch row
//      and head, 128 dv columns), heavy row tiles first; R = 128 at large
//      dk (S_in is read once per 128 rows), 64 at small dk (more blocks).
//      acc = q . (S_in_hi + S_in_lo) times exp(bc_t) (the decayed read of
//      the state; q bf16, the decay a row factor after the product), then
//      acc += (A_hi + A_lo) v over the keys up to each warp's last row;
//      y = scale acc, divided by max(|scale (sum_s A_ts + exp(bc_t) q .
//      n_in)|, 1) when normalising.  q and S_in stages (32 dk rows) and
//      A and v stages (32 keys) come through a 3-slot cp.async ring.
// The scratch (allocated by the wrapper): the chunks' own f32 states and
// their entering states as bf16 hi + lo, nc*B*H*dk*dv*(4 + 4) bytes (67
// MB at xLSTM-350M's prefill), and the f32 scores, nc*B*H*AP*AP*65/64*4
// bytes (AP = 64 ceil(L / 64): 8.5 MB there).  No atomics: every result
// is the same from run to run.  ref.gla_chunk_split emulates this route's
// order and rounding.
//
// f32 (the check route: phase 6's f32 cases and the full-width f32 logit
// checks of chip_smoke.py): gla_kernel, the CUDA-core kernel of the first
// port, one launch.  bc comes from the wrapper (torch.cumsum, as the JAX
// wrapper forms it outside its kernel).  One block per (batch row, head,
// 32 columns of dv) walks the chunks in order with its dk x 32 slice of
// the state and the normaliser in shared memory; every dv slice
// recomputes the L x L scores, and every product is an explicit fmaf in
// f32 (the build's --fmad=false keeps every other multiply and add
// unfused).
//
// What bounds it on the card.  For an xLSTM layer (4 heads, dk = dv =
// 512) at a 2048-token prefill the recurrence needs ~10.8 GFLOP on and
// below the chunks' diagonals (~11 us at 989 TFLOP/s bf16) and moves
// ~38 MB (~11 us at 3.35 TB/s).  The bf16 route's split work is ~20.4
// GFLOP (q k^T once; A v, q S_in and (k w)^T v twice), ~21 us, and its
// scratch round trips (each written once, read at least once) bring its
// bytes to ~174 MB, ~52 us: the scratch, not the products, is this
// design's own floor.  For a Hymba layer (25 heads, dk 16, dv 128, 2304
// padded tokens) ~2.6 GFLOP and ~34 MB (~10 us), ~115 MB with the scratch
// (~34 us): bytes bound it.
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
template <int P>
__device__ __forceinline__ void load_cols(const float* __restrict__ src,
                                          int64_t ss, int nrows, int nvalid,
                                          int c0, int d, const float* rowmul,
                                          float mul, float* dst, int tid) {
    constexpr int V = 4;
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
            unpack(u[i], f, 0.f);
            const float m = rowmul ? rowmul[r] : mul;
            float* o = dst + r * P + (c % CPR) * V;
#pragma unroll
            for (int j = 0; j < V; ++j) o[j] = f[j] * m;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
gla_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bc,
           const float* __restrict__ li, const float* __restrict__ s0,
           const float* __restrict__ n0, float* __restrict__ y,
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
    const float* qb = q + b * q_sb + h * q_sh;
    const float* kb = k + b * k_sb + h * k_sh;
    const float* vb = v + b * v_sb + h * v_sh;
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
        load_cols<kDVT>(vb + c0 * v_ss, v_ss, L, L, v0, dv, nullptr, 1.f,
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
                load_cols<kKP>(qb + (c0 + r0) * q_ss, q_ss, kRT, L - r0,
                                  k0, dk, nullptr, scale, Qs, tid);
                load_cols<kKP>(kb + c0 * k_ss, k_ss, 32 * jn, cend, k0,
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
            load_cols<kKP>(kb + c0 * k_ss, k_ss, L, L, k0, dk, ws, 1.f,
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

int launch_f32(const void* q, const void* k, const void* v, const float* bc,
               const float* li, const float* s0, const float* n0, void* y,
               float* sT, float* nT, int B, int S, int H, int dk, int dv,
               int L, const int64_t* st, float scale, int normalize,
               cudaStream_t stream) {
    const size_t smem = smem_floats(dk) * sizeof(float);
    // Set on every launch: the attribute belongs to the current device.
    cudaError_t e = cudaFuncSetAttribute(
        gla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(B * H), (unsigned)((dv + kDVT - 1) / kDVT));
    gla_kernel<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, bc, li, s0, n0,
        (float*)y, sT, nT, S, H, dk, dv, L, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], scale, normalize);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core route
// ---------------------------------------------------------------------------
// gla_state_kernel: one block (4 warps, 16 dk rows each) per (chunk, dk
// tile, dv tile), the chunk's keys in 64-key stages through a 2-slot ring
constexpr int kSThreads = 128;
constexpr int kSD = 64;          // dk rows per block
constexpr int kSV = 64;          // dv columns per block
constexpr int kSK = 64;          // keys per stage
static_assert(2 * kSThreads >= kMaxL, "the gate scan: two positions a thread");
constexpr int kSStages = 2;
// gla_scan_kernel: one thread per 4 elements of the states (then of the
// normalisers)
constexpr int kScanThreads = 256;
// gla_score_kernel: one block (4 warps: 2 of 32 query rows x 2 of 32
// keys) per (chunk, 64 x 64 tile of its scores on or below the diagonal),
// dk in 64-column stages through a 2-slot ring
constexpr int kAThreads = 128;
constexpr int kAT = 64;          // tile rows and keys
constexpr int kAD = 64;          // dk columns per stage
constexpr int kAStages = 2;
// gla_out_kernel<R>: one block (R / 16 warps: R / 32 of 32 query rows x 2
// of 64 dv columns) per (chunk and R query rows, batch row and head, 128
// dv columns); a kOStages-slot ring of S_in stages (q and S_in for kOD dk
// rows) and key stages (A and v for kOK keys)
constexpr int kOV = 128;         // dv columns per block
constexpr int kOWV = 64;         // dv columns per warp
constexpr int kOD = 32;          // dk rows of S_in per stage
constexpr int kOK = 32;          // keys per key stage
constexpr int kOStages = 3;
constexpr int kORDK = 64;        // above this dk (rounded up to 16), 128
                                 // query rows a block, else 64
constexpr int kOQP = kOD + 8;    // bf16 row pitches carry 16 bytes of pad,
constexpr int kOVP = kOV + 8;    // so ldmatrix meets no bank conflicts
constexpr int kOAP = kOK + 8;    // f32 pitch of A: float2 reads conflict-free

struct __align__(16) ScoreStage {
    bf16 q[kAT][kAD + 8];        // q's (rows x dk slice)
    bf16 k[kAT][kAD + 8];        // k's (keys x dk slice)
};

struct __align__(16) StateStage {
    bf16 k[kSK][kSD + 8];        // k's (keys x dk slice), bf16 as loaded
    bf16 v[kSK][kSV + 8];        // v's (keys x dv slice)
};

// A packed bf16 pair of k, each value times its f32 weight (one f32
// rounding, as the plain version forms k w), as kPTerms bf16 terms.
__device__ __forceinline__ void scale_split(uint32_t a, float w0, float w1,
                                            uint32_t* t) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a));
    split_bf16(f.x * w0, f.y * w1, t, 4);
}

// One chunk's gates and own state, for one (dk tile, dv tile):
//   bc = the within-chunk inclusive cumsum of log f (and li = log i) of
//   the chunk, from the (B, S, H) gates, to bc, li [BH][S] (by the blocks
//   of tile (0, 0), for the later kernels);
//   dS_c = (k w)^T v and dn_c = sum_s k_s w_s, w_s = exp(bc_end - bc_s +
//   li_s), to the f32 scratch dS [nc][BH][dk][dv], dN [nc][BH][dk].
__global__ void __launch_bounds__(kSThreads)
gla_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const float* __restrict__ lf, const float* __restrict__ lg,
                 float* __restrict__ bc, float* __restrict__ li,
                 float* __restrict__ dS, float* __restrict__ dN, int S,
                 int H, int dk, int dv, int L, int64_t k_sb, int64_t k_ss,
                 int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    StateStage* stg = reinterpret_cast<StateStage*>(smem_raw);
    float* ws = reinterpret_cast<float*>(stg + kSStages);   // [kMaxL]
    float* wsum = ws + kMaxL;                               // [warps]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int nc = S / L;
    const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
    const int BH = gridDim.x / nc, b = bh / H, h = bh % H;
    const int d0 = blockIdx.y * kSD, c0 = blockIdx.z * kSV;
    const int64_t cb = (int64_t)c * L;
    const bf16* kb = k + b * k_sb + h * k_sh + cb * k_ss;
    const bf16* vb = v + b * v_sb + h * v_sh + cb * v_ss;
    const int items = (L + kSK - 1) / kSK;
    const bool rows_live = d0 + 16 * warp < dk;          // warp-uniform
    const bool own_n = blockIdx.z == 0 && tid < kSD && d0 + tid < dk;
    constexpr int NJ = kSV / 8;

    auto issue = [&](int it) {
        StateStage& sg = stg[it % kSStages];
        const int s0 = it * kSK, nvalid = L - s0;
        for (int ch = tid; ch < kSK * (kSD / 8); ch += kSThreads) {
            const int r = ch / (kSD / 8), cc = (ch % (kSD / 8)) * 8;
            const bool ok = r < nvalid && d0 + cc < dk;
            cp_async16(smem_addr(&sg.k[r][cc]),
                       kb + (ok ? (int64_t)(s0 + r) * k_ss + d0 + cc : 0),
                       ok);
        }
        for (int ch = tid; ch < kSK * (kSV / 8); ch += kSThreads) {
            const int r = ch / (kSV / 8), cc = (ch % (kSV / 8)) * 8;
            const bool ok = r < nvalid && c0 + cc < dv;
            cp_async16(smem_addr(&sg.v[r][cc]),
                       vb + (ok ? (int64_t)(s0 + r) * v_ss + c0 + cc : 0),
                       ok);
        }
    };
#pragma unroll
    for (int p = 0; p < kSStages - 1; ++p) {
        if (p < items) issue(p);
        cp_async_commit();
    }

    // --- the gates, while the first stages load: thread tid holds the
    // positions 2 tid and 2 tid + 1 (L <= 2 kSThreads) ----------------------
    {
        const int s0 = 2 * tid, s1 = s0 + 1;
        const int64_t gs = ((int64_t)b * S + cb) * H + h;   // (b, c L, h)
        const float f0 = s0 < L ? lf[gs + (int64_t)s0 * H] : 0.f;
        const float f1 = s1 < L ? lf[gs + (int64_t)s1 * H] : 0.f;
        const float i0 = s0 < L ? lg[gs + (int64_t)s0 * H] : 0.f;
        const float i1 = s1 < L ? lg[gs + (int64_t)s1 * H] : 0.f;
        float x = f0 + f1;                         // warp scan of the pairs
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(0xffffffffu, x, off);
            if (lane >= off) x += y;
        }
        float ex = __shfl_up_sync(0xffffffffu, x, 1);
        if (lane == 0) ex = 0.f;
        if (lane == 31) wsum[warp] = x;
        __syncthreads();
        float pre = 0.f;
        for (int w = 0; w < warp; ++w) pre += wsum[w];
        const float b0 = (pre + ex) + f0, b1 = b0 + f1;
        if (s0 < L) ws[s0] = b0;
        if (s1 < L) ws[s1] = b1;
        __syncthreads();
        const float bend = ws[L - 1];
        if (blockIdx.y == 0 && blockIdx.z == 0) {
            float* bcb = bc + (int64_t)bh * S + cb;
            float* lib = li + (int64_t)bh * S + cb;
            if (s0 < L) { bcb[s0] = b0; lib[s0] = i0; }
            if (s1 < L) { bcb[s1] = b1; lib[s1] = i1; }
        }
        __syncthreads();             // bend read before ws is rewritten
        if (s0 < L) ws[s0] = expf(bend - b0 + i0);
        if (s1 < L) ws[s1] = expf(bend - b1 + i1);
        for (int s = L + tid; s < items * kSK; s += kSThreads) ws[s] = 0.f;
    }

    float ds[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    float nd = 0.f;

    for (int it = 0; it < items; ++it) {
        if (it + kSStages - 1 < items) issue(it + kSStages - 1);
        cp_async_commit();
        cp_async_wait<kSStages - 1>();
        __syncthreads();
        StateStage& sg = stg[it % kSStages];
        const float* wi = ws + it * kSK;
        // --- dS += (k w)^T v: k as the A operand (ldmatrix.trans), k w
        // split into bf16 hi + lo, v by ldmatrix.trans as the B operand --
        if (rows_live) {
#pragma unroll
            for (int kk = 0; kk < kSK / 16; ++kk) {
                uint32_t a[4], pa[kPTerms][4];
                ldmatrix_x4_trans(a, smem_addr(
                    &sg.k[16 * kk + (lane & 7) + 8 * (lane >> 4)]
                         [16 * warp + 8 * ((lane >> 3) & 1)]));
                const float* w = wi + 16 * kk + 2 * t4;
                scale_split(a[0], w[0], w[1], &pa[0][0]);
                scale_split(a[1], w[0], w[1], &pa[0][1]);
                scale_split(a[2], w[8], w[9], &pa[0][2]);
                scale_split(a[3], w[8], w[9], &pa[0][3]);
#pragma unroll
                for (int dp = 0; dp < kSV / 16; ++dp) {
                    uint32_t vf[4];
                    ldmatrix_x4_trans(vf, smem_addr(
                        &sg.v[16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)]
                             [16 * dp + 8 * (lane >> 4)]));
#pragma unroll
                    for (int i = 0; i < kPTerms; ++i) {
                        mma_bf16(ds[2 * dp], pa[i], vf[0], vf[1]);
                        mma_bf16(ds[2 * dp + 1], pa[i], vf[2], vf[3]);
                    }
                }
            }
        }
        if (own_n)           // dn: sum_s k_s w_s in f32, in key order
#pragma unroll 8
            for (int s = 0; s < kSK; ++s)
                nd += __bfloat162float(sg.k[s][tid]) * wi[s];
        __syncthreads();     // this stage is consumed before it refills
    }

    const int64_t rowb = ((int64_t)c * BH + bh) * dk;
    const int ra = d0 + 16 * warp + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int col = c0 + 8 * j + 2 * t4;
        if (col >= dv) continue;
        if (ra < dk)
            *reinterpret_cast<float2*>(dS + (rowb + ra) * dv + col) =
                make_float2(ds[j][0], ds[j][1]);
        if (rb < dk)
            *reinterpret_cast<float2*>(dS + (rowb + rb) * dv + col) =
                make_float2(ds[j][2], ds[j][3]);
    }
    if (own_n) dN[rowb + d0 + tid] = nd;
}

// The scan over chunks, elementwise, in f32: S_in[0] = S0 (or zeros),
// S_in[c+1] = exp(bc_end_c) S_in[c] + dS_c, the same for n.  Each S_in[c]
// goes to the scratch as bf16 hi and lo planes (chunk 0's only when there
// is an initial state: else it is zero, and gla_out_kernel skips it), each
// n_in[c] in f32; the last state is sT, nT.
__device__ __forceinline__ void store_state(float4 x, bf16* hi, bf16* lo) {
    uint32_t t0[kPTerms], t1[kPTerms];
    split_bf16(x.x, x.y, t0, 1);
    split_bf16(x.z, x.w, t1, 1);
    *reinterpret_cast<uint2*>(hi) = make_uint2(t0[0], t1[0]);
    *reinterpret_cast<uint2*>(lo) = make_uint2(t0[1], t1[1]);
}

__global__ void __launch_bounds__(kScanThreads)
gla_scan_kernel(const float* __restrict__ dS, const float* __restrict__ dN,
                const float* __restrict__ bc, const float* __restrict__ s0,
                const float* __restrict__ n0, bf16* __restrict__ s_hi,
                bf16* __restrict__ s_lo, float* __restrict__ n_in,
                float* __restrict__ sT, float* __restrict__ nT, int BH,
                int S, int dk, int dv, int L) {
    const int64_t ns = (int64_t)BH * dk * dv, nn = (int64_t)BH * dk;
    const int64_t i = ((int64_t)blockIdx.x * kScanThreads + threadIdx.x) * 4;
    const bool state = i < ns;
    if (!state && i >= ns + nn) return;
    const int64_t e = state ? i : i - ns;         // element of S or of n
    const int64_t stride = state ? ns : nn;       // one chunk's elements
    const float* d = (state ? dS : dN) + e;
    const float* init = state ? s0 : n0;
    const float* bcb = bc + (e / (state ? (int64_t)dk * dv : dk)) * S;
    const int nc = S / L;
    float4 run = init != nullptr
                     ? *reinterpret_cast<const float4*>(init + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < nc; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(d + c * stride);
        const float f = expf(bcb[(int64_t)c * L + L - 1]);
        if (c > 0 || init != nullptr) {
            if (state)
                store_state(run, s_hi + c * stride + e,
                            s_lo + c * stride + e);
            else
                *reinterpret_cast<float4*>(n_in + c * stride + e) = run;
        }
        run = make_float4(f * run.x + x.x, f * run.y + x.y,
                          f * run.z + x.z, f * run.w + x.w);
    }
    *reinterpret_cast<float4*>((state ? sT : nT) + e) = run;
}

// gla_score_kernel: A_ts = (q_t . k_s) exp(bc_t - bc_s + li_s) for s <= t
// (0 above the diagonal), to the f32 scratch A [BH*nc][AP][AP] with
// AP = 64 ceil(L / 64), and each row's sum over the tile's keys to
// rsum [BH*nc][AP / 64][AP]; one block per (chunk, 64 x 64 tile on or
// below the diagonal), dk in 64-column stages through a 2-slot ring.
__global__ void __launch_bounds__(kAThreads)
gla_score_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const float* __restrict__ bc, const float* __restrict__ li,
                 float* __restrict__ A, float* __restrict__ rsum, int S,
                 int H, int dk, int L, int64_t q_sb, int64_t q_ss,
                 int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    ScoreStage* stg = reinterpret_cast<ScoreStage*>(smem_raw);
    float* bcr = reinterpret_cast<float*>(stg + kAStages);   // [kAT] rows
    float* bck = bcr + kAT;                                  // [kAT] keys
    float* lik = bck + kAT;                                  // [kAT] keys
    float* red = lik + kAT;                                  // [2][kAT]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wr = warp & 1, wc = warp >> 1;   // 32 rows, 32 keys a warp
    const int g = lane >> 2, t4 = lane & 3;
    const int nc = S / L, RT = (L + kAT - 1) / kAT, AP = RT * kAT;
    const int bhc = blockIdx.x, bh = bhc / nc, c = bhc % nc;
    const int b = bh / H, h = bh % H;
    int ti = (int)((sqrtf(8.f * blockIdx.y + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.y) ++ti;
    while (ti * (ti + 1) / 2 > (int)blockIdx.y) --ti;
    const int tj = blockIdx.y - ti * (ti + 1) / 2;  // key tile, <= ti
    const int t0 = ti * kAT, s0 = tj * kAT;
    const int64_t cb = (int64_t)c * L;
    const bf16* qb = q + b * q_sb + h * q_sh + cb * q_ss;
    const bf16* kb = k + b * k_sb + h * k_sh + cb * k_ss;
    const int dk16 = (dk + 15) & ~15, items = (dk16 + kAD - 1) / kAD;

    auto issue = [&](int it) {
        ScoreStage& sg = stg[it % kAStages];
        const int d0 = it * kAD;
        for (int ch = tid; ch < 2 * kAT * (kAD / 8); ch += kAThreads) {
            const bool isk = ch >= kAT * (kAD / 8);
            const int cq = isk ? ch - kAT * (kAD / 8) : ch;
            const int r = cq / (kAD / 8), cc = (cq % (kAD / 8)) * 8;
            const int row = (isk ? s0 : t0) + r;
            const bool ok = row < L && d0 + cc < dk;
            const int64_t o = ok ? (int64_t)row * (isk ? k_ss : q_ss) + d0 +
                                       cc : 0;
            cp_async16(smem_addr(isk ? &sg.k[r][cc] : &sg.q[r][cc]),
                       (isk ? kb : qb) + o, ok);
        }
    };
    const float* bcb = bc + (int64_t)bh * S + cb;
    const float* lib = li + (int64_t)bh * S + cb;
    if (tid < kAT) {
        const bool okr = t0 + tid < L, oks = s0 + tid < L;
        cp_async4(smem_addr(bcr + tid), bcb + (okr ? t0 + tid : 0), okr);
        cp_async4(smem_addr(bck + tid), bcb + (oks ? s0 + tid : 0), oks);
        cp_async4(smem_addr(lik + tid), lib + (oks ? s0 + tid : 0), oks);
    }
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

#pragma unroll
    for (int p = 0; p < kAStages - 1; ++p) {
        if (p < items) issue(p);
        cp_async_commit();
    }
    for (int it = 0; it < items; ++it) {
        if (it + kAStages - 1 < items) issue(it + kAStages - 1);
        cp_async_commit();
        cp_async_wait<kAStages - 1>();
        __syncthreads();
        ScoreStage& sg = stg[it % kAStages];
        const int nk = min(kAD, dk16 - it * kAD) / 16;
        for (int kk = 0; kk < nk; ++kk) {
            uint32_t qa[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                ldmatrix_x4(qa[mi], smem_addr(
                    &sg.q[32 * wr + 16 * mi + (lane & 15)]
                         [16 * kk + 8 * (lane >> 4)]));
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                uint32_t kf[4];
                ldmatrix_x4(kf, smem_addr(
                    &sg.k[32 * wc + 16 * np + (lane & 7) + 8 * (lane >> 4)]
                         [16 * kk + 8 * ((lane >> 3) & 1)]));
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    mma_bf16(acc[mi][2 * np], qa[mi], kf[0], kf[1]);
                    mma_bf16(acc[mi][2 * np + 1], qa[mi], kf[2], kf[3]);
                }
            }
        }
        __syncthreads();     // this stage is consumed before it refills
    }
    cp_async_wait<0>();

    // --- decay mask (s <= t only: above the diagonal exp may overflow, and
    // 0 * inf is NaN), the tile to A, row sums over its 64 keys ----------
    float* Ab = A + (int64_t)bhc * AP * AP;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = 32 * wr + 16 * mi + g + 8 * hf, t = t0 + r;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int cs = 32 * wc + 8 * j + 2 * t4, s = s0 + cs;
                float a0 = 0.f, a1 = 0.f;
                if (t < L) {
                    if (s <= t)
                        a0 = acc[mi][j][2 * hf] *
                             expf(bcr[r] - bck[cs] + lik[cs]);
                    if (s + 1 <= t)
                        a1 = acc[mi][j][2 * hf + 1] *
                             expf(bcr[r] - bck[cs + 1] + lik[cs + 1]);
                }
                *reinterpret_cast<float2*>(Ab + (int64_t)t * AP + s) =
                    make_float2(a0, a1);
                sum += a0 + a1;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (t4 == 0) red[wc * kAT + r] = sum;
        }
    __syncthreads();
    if (tid < kAT)
        rsum[((int64_t)bhc * RT + tj) * AP + t0 + tid] =
            red[tid] + red[kAT + tid];
}

// gla_out_kernel<R> (R query rows a block): bytes of a ring slot, the
// larger of an S_in stage and a key stage (see the kernel); its shared
// memory, kOStages slots, then the rows' bc [R], the rows' sums over each
// 64-key tile [AP / 64][R], n_in [dk16] and the column-warps' parts of
// q . n_in [2][R] (f32): at chunk 256 93 KB (dk 512, R 128) or 69 KB
// (dk 16, R 64).
__host__ __device__ constexpr int out_slot_bytes(int R) {
    return R * kOAP * 4 + kOK * kOVP * 2 > (R * kOQP + 2 * kOD * kOVP) * 2
               ? R * kOAP * 4 + kOK * kOVP * 2
               : (R * kOQP + 2 * kOD * kOVP) * 2;
}
size_t out_smem_bytes(int R, int dk, int L) {
    const int dk16 = (dk + 15) & ~15;
    const int RTa = (L + kAT - 1) / kAT;
    return (size_t)kOStages * out_slot_bytes(R) +
           (size_t)(R + RTa * R + dk16 + 2 * R) * sizeof(float);
}

// R = 128 where dk is large: q . S_in reads S_in once per 128 rows; R = 64
// for small dk: more blocks, each with less to wait for.  The register cap
// lets two (R 128) or three (R 64) blocks share an SM: at R 128 that was
// faster than one block without the cap's few spills (xLSTM's shape).
template <int R>
__global__ void __launch_bounds__(2 * R, R == 128 ? 2 : 3)
gla_out_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
               const float* __restrict__ bc, const float* __restrict__ A,
               const float* __restrict__ rsum, const bf16* __restrict__ s_hi,
               const bf16* __restrict__ s_lo, const float* __restrict__ n_in,
               bf16* __restrict__ y, int S, int H, int dk, int dv, int L,
               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t v_sb,
               int64_t v_ss, int64_t v_sh, float scale, int normalize,
               int has_init) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int kOR = R, kORW = R / 32, kOThreads = 2 * R;
    constexpr int kOSlotB = out_slot_bytes(R);
    const int dk16 = (dk + 15) & ~15, sd = min(kOD, dk16);
    const int nc = S / L, RT = (L + kOR - 1) / kOR;
    const int RTa = (L + kAT - 1) / kAT, AP = RTa * kAT;  // the scores'
    unsigned char* ring = smem_raw;                             // slots
    float* bcq = reinterpret_cast<float*>(ring + kOStages * kOSlotB);
    float* rsq = bcq + kOR;                                     // [RTa][kOR]
    float* nin = rsq + RTa * kOR;                               // [dk16]
    float* qns = nin + dk16;                                    // [2][kOR]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wr = warp % kORW, wc = warp / kORW;   // 32 rows, 64 columns
    const int g = lane >> 2, t4 = lane & 3;
    const int c = blockIdx.x % nc, ti = RT - 1 - blockIdx.x / nc;
    const int t0 = ti * kOR;                   // heavy row tiles first
    const int bh = blockIdx.y, BH = gridDim.y, b = bh / H, h = bh % H;
    const int bhc = bh * nc + c;
    const int v0 = blockIdx.z * kOV, vw = kOWV * wc;   // warp's columns
    const int kend = min(t0 + kOR, L);    // keys [0, kend) reach the rows
    const int64_t cb = (int64_t)c * L;
    const bf16* qb = q + b * q_sb + h * q_sh + cb * q_ss;
    const bf16* vb = v + b * v_sb + h * v_sh + cb * v_ss;
    const float* Ab = A + (int64_t)bhc * AP * AP + (int64_t)t0 * AP;
    const bool inter = c > 0 || has_init;
    const int NI = inter ? (dk16 + sd - 1) / sd : 0;   // S_in stages
    const int items = NI + (kend + kOK - 1) / kOK;     // + key stages
    const int64_t srow = ((int64_t)c * BH + bh) * dk;  // S_in[c]'s row 0

    // --- with stage 0: the rows' bc and sums, n_in ------------------------
    if (tid < kOR) {
        const bool ok = t0 + tid < L;
        cp_async4(smem_addr(bcq + tid),
                  bc + (int64_t)bh * S + cb + (ok ? t0 + tid : 0), ok);
    }
    if (normalize) {                     // 64-key tiles j <= the row's
        const int nj = (kend - 1) / kAT + 1;
        for (int i = tid; i < nj * kOR; i += kOThreads) {
            const int j = i / kOR, r = i % kOR;
            const bool ok = t0 + r < L && j <= (t0 + r) / kAT;
            cp_async4(smem_addr(rsq + i),
                      rsum + (ok ? ((int64_t)bhc * RTa + j) * AP + t0 + r
                                 : 0), ok);
        }
        if (inter)                       // zeros past dk
            for (int i = tid; i < dk16; i += kOThreads)
                cp_async4(smem_addr(nin + i), n_in + srow + (i < dk ? i : 0),
                          i < dk);
    }

    // An S_in stage: q [kOR][kOD + 8], S_in hi and lo [kOD][kOVP] (bf16); a
    // key stage: A [kOR][kOAP] (f32) and v [kOK][kOVP] (bf16).
    auto issue = [&](int it) {
        unsigned char* sl = ring + (it % kOStages) * kOSlotB;
        if (it < NI) {                      // dk rows [r0, r0 + sd)
            bf16* qs = reinterpret_cast<bf16*>(sl);
            bf16* hs = qs + kOR * kOQP;
            const int r0 = it * sd;
            for (int ch = tid; ch < kOR * (kOD / 8); ch += kOThreads) {
                const int r = ch / (kOD / 8), cc = (ch % (kOD / 8)) * 8;
                const bool ok = t0 + r < L && r0 + cc < dk;
                cp_async16(smem_addr(qs + r * kOQP + cc),
                           qb + (ok ? (int64_t)(t0 + r) * q_ss + r0 + cc : 0),
                           ok);
            }
            for (int ch = tid; ch < sd * (kOV / 8); ch += kOThreads) {
                const int r = ch / (kOV / 8), cc = (ch % (kOV / 8)) * 8;
                const bool ok = r0 + r < dk && v0 + cc < dv;
                const int64_t o = ok ? (srow + r0 + r) * dv + v0 + cc : 0;
                cp_async16(smem_addr(hs + r * kOVP + cc), s_hi + o, ok);
                cp_async16(smem_addr(hs + (kOD + r) * kOVP + cc), s_lo + o,
                           ok);
            }
        } else {                            // keys [k0, k0 + kOK)
            float* as = reinterpret_cast<float*>(sl);
            bf16* vs = reinterpret_cast<bf16*>(sl + kOR * kOAP * 4);
            const int k0 = (it - NI) * kOK;
            for (int ch = tid; ch < kOR * (kOK / 4); ch += kOThreads) {
                const int r = ch / (kOK / 4), cc = (ch % (kOK / 4)) * 4;
                const bool ok = t0 + r < L;
                cp_async16(smem_addr(as + r * kOAP + cc),
                           Ab + (ok ? (int64_t)r * AP + k0 + cc : 0), ok);
            }
            for (int ch = tid; ch < kOK * (kOV / 8); ch += kOThreads) {
                const int r = ch / (kOV / 8), cc = (ch % (kOV / 8)) * 8;
                const bool ok = k0 + r < kend && v0 + cc < dv;
                cp_async16(smem_addr(vs + r * kOVP + cc),
                           vb + (ok ? (int64_t)(k0 + r) * v_ss + v0 + cc : 0),
                           ok);
            }
        }
    };

    constexpr int NJ = kOWV / 8;
    float acc[2][NJ][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    float qn[4] = {0.f, 0.f, 0.f, 0.f};   // q . n_in of row 32 wr + lane
    const bool warp_live = t0 + 32 * wr < kend;   // warp-uniform
    const int wmax = t0 + 32 * wr + 31;           // the warp's last row

#pragma unroll
    for (int p = 0; p < kOStages - 1; ++p) {
        if (p < items) issue(p);
        cp_async_commit();
    }
    for (int it = 0; it < items; ++it) {
        if (it + kOStages - 1 < items) issue(it + kOStages - 1);
        cp_async_commit();
        cp_async_wait<kOStages - 1>();
        __syncthreads();
        const unsigned char* sl = ring + (it % kOStages) * kOSlotB;

        if (warp_live && it < NI) {
            // --- acc += q . (S_in_hi + S_in_lo), dk rows [r0, r0 + sd) ----
            const bf16* qs = reinterpret_cast<const bf16*>(sl);
            const bf16* hs = qs + kOR * kOQP;
            const bf16* ls = hs + kOD * kOVP;
            const int r0 = it * sd, nk = min(sd, dk16 - r0) / 16;
            if (normalize && 16 * wc < sd) {
                // q . n_in of row 32 wr + lane over the stage's dk columns
                // [16 wc, 16 wc + 16), in f32 (the column-warps' parts are
                // added in the epilogue)
                const bf16* qr = qs + (32 * wr + lane) * kOQP + 16 * wc;
                const float* nr = nin + r0 + 16 * wc;
#pragma unroll
                for (int h8 = 0; h8 < 2; ++h8) {
                    float f[8];
                    unpack(*reinterpret_cast<const uint4*>(qr + 8 * h8), f,
                           bf16());
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        qn[e & 3] += f[e] * nr[8 * h8 + e];
                }
            }
            for (int kk = 0; kk < nk; ++kk) {
                uint32_t qa[2][4];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
                    ldmatrix_x4(qa[mi], smem_addr(
                        qs + (32 * wr + 16 * mi + (lane & 15)) * kOQP +
                        16 * kk + 8 * (lane >> 4)));
                const int brow =
                    (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kOVP +
                    vw + 8 * (lane >> 4);
#pragma unroll
                for (int dp = 0; dp < kOWV / 16; ++dp) {
                    uint32_t bh4[4], bl4[4];
                    ldmatrix_x4_trans(bh4, smem_addr(hs + brow + 16 * dp));
                    ldmatrix_x4_trans(bl4, smem_addr(ls + brow + 16 * dp));
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi) {
                        mma_bf16(acc[mi][2 * dp], qa[mi], bh4[0], bh4[1]);
                        mma_bf16(acc[mi][2 * dp + 1], qa[mi], bh4[2], bh4[3]);
                        mma_bf16(acc[mi][2 * dp], qa[mi], bl4[0], bl4[1]);
                        mma_bf16(acc[mi][2 * dp + 1], qa[mi], bl4[2], bl4[3]);
                    }
                }
            }
            if (it == NI - 1) {          // the decayed read: rows times e^bc_t
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int r = 32 * wr + 16 * mi + g + 8 * hf;
                        const float d = t0 + r < kend ? expf(bcq[r]) : 0.f;
#pragma unroll
                        for (int j = 0; j < NJ; ++j) {
                            acc[mi][j][2 * hf] *= d;
                            acc[mi][j][2 * hf + 1] *= d;
                        }
                    }
            }
        } else if (warp_live) {
            // --- acc += (A_hi + A_lo) v over the stage's keys, 16 at a
            // time, up to the warp's last row ------------------------------
            const float* as = reinterpret_cast<const float*>(sl);
            const bf16* vs =
                reinterpret_cast<const bf16*>(sl + kOR * kOAP * 4);
            const int kbase = (it - NI) * kOK;
#pragma unroll
            for (int ks = 0; ks < kOK / 16; ++ks) {
                if (kbase + 16 * ks > wmax) break;
                uint32_t pa[2][kPTerms][4];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const float* ar = as + (32 * wr + 16 * mi + g) * kOAP +
                                      16 * ks + 2 * t4;
                    const float2 x00 = *reinterpret_cast<const float2*>(ar);
                    const float2 x10 =
                        *reinterpret_cast<const float2*>(ar + 8 * kOAP);
                    const float2 x01 =
                        *reinterpret_cast<const float2*>(ar + 8);
                    const float2 x11 =
                        *reinterpret_cast<const float2*>(ar + 8 * kOAP + 8);
                    split_bf16(x00.x, x00.y, &pa[mi][0][0], 4);
                    split_bf16(x10.x, x10.y, &pa[mi][0][1], 4);
                    split_bf16(x01.x, x01.y, &pa[mi][0][2], 4);
                    split_bf16(x11.x, x11.y, &pa[mi][0][3], 4);
                }
                const int vrow =
                    (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * kOVP +
                    vw + 8 * (lane >> 4);
#pragma unroll
                for (int dp = 0; dp < kOWV / 16; ++dp) {
                    uint32_t vf[4];
                    ldmatrix_x4_trans(vf, smem_addr(vs + vrow + 16 * dp));
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                        for (int i = 0; i < kPTerms; ++i) {
                            mma_bf16(acc[mi][2 * dp], pa[mi][i], vf[0],
                                     vf[1]);
                            mma_bf16(acc[mi][2 * dp + 1], pa[mi][i], vf[2],
                                     vf[3]);
                        }
                }
            }
        }
        __syncthreads();       // this slot is consumed before it refills
    }
    cp_async_wait<0>();
    if (normalize && inter) {            // the column-warps' parts of q . n
        qns[wc * kOR + 32 * wr + lane] = (qn[0] + qn[1]) + (qn[2] + qn[3]);
        __syncthreads();
    }
    if (!warp_live) return;

    // --- y = scale acc [/ max(|scale (sum_s A_ts + e^bc_t q . n_in)|, 1)] --
    bf16* yb = y + (((int64_t)b * S + cb + t0) * H + h) * dv;
    const int64_t ys = (int64_t)H * dv;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = 32 * wr + 16 * mi + g + 8 * hf;
            if (t0 + r >= kend) continue;
            float den = 1.f;
            if (normalize) {
                float rs = 0.f;          // 64-key tiles in order
                for (int j = 0; j <= (t0 + r) / kAT; ++j)
                    rs += rsq[j * kOR + r];
                const float qd =
                    inter ? expf(bcq[r]) * (qns[r] + qns[kOR + r]) : 0.f;
                den = fmaxf(fabsf(scale * (rs + qd)), 1.f);
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int col = v0 + vw + 8 * j + 2 * t4;
                if (col < dv)
                    *reinterpret_cast<__nv_bfloat162*>(yb + r * ys + col) =
                        __floats2bfloat162_rn(
                            scale * acc[mi][j][2 * hf] / den,
                            scale * acc[mi][j][2 * hf + 1] / den);
            }
        }
}

// The f32 scratch: dS [nc][BH][dk][dv], dN and n_in [nc][BH][dk], then
// The f32 scratch: dS [nc][BH][dk][dv], dN and n_in [nc][BH][dk], then
// The f32 scratch: dS [nc][BH][dk][dv], dN and n_in [nc][BH][dk], then
// A [BH*nc][AP][AP] and rsum [BH*nc][AP/64][AP] with AP = 64 ceil(L/64).
int launch_mma(const void* q, const void* k, const void* v, const float* lf,
               const float* lg, float* bc, float* li, const float* s0,
               const float* n0, void* y, float* sT, float* nT, bf16* s_hi,
               float* scr, int B, int S, int H, int dk, int dv, int L,
               const int64_t* st, float scale, int normalize,
               cudaStream_t stream) {
    const int BH = B * H, nc = S / L;
    const int RT = (L + kAT - 1) / kAT, AP = RT * kAT;
    const int64_t ns = (int64_t)nc * BH * dk * dv, nn = (int64_t)nc * BH * dk;
    bf16* s_lo = s_hi + ns;
    float* dS = scr;
    float* dN = dS + ns;
    float* n_in = dN + nn;
    float* A = n_in + nn;
    float* rsum = A + (int64_t)BH * nc * AP * AP;
    // Set on every launch: the attribute belongs to the current device.
    const size_t s_smem =
        kSStages * sizeof(StateStage) + (kMaxL + kSThreads / 32) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        gla_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)s_smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 sgrid((unsigned)(BH * nc), (unsigned)((dk + kSD - 1) / kSD),
                     (unsigned)((dv + kSV - 1) / kSV));
    gla_state_kernel<<<sgrid, kSThreads, s_smem, stream>>>(
        (const bf16*)k, (const bf16*)v, lf, lg, bc, li, dS, dN, S, H, dk, dv,
        L, st[3], st[4], st[5], st[6], st[7], st[8]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int64_t n4 = ((int64_t)BH * dk * dv + (int64_t)BH * dk) / 4;
    gla_scan_kernel<<<(unsigned)((n4 + kScanThreads - 1) / kScanThreads),
                      kScanThreads, 0, stream>>>(
        dS, dN, bc, s0, n0, s_hi, s_lo, n_in, sT, nT, BH, S, dk, dv, L);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t a_smem = kAStages * sizeof(ScoreStage) + 5 * kAT * 4;
    e = cudaFuncSetAttribute(gla_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)a_smem);
    if (e != cudaSuccess) return (int)e;
    gla_score_kernel<<<dim3((unsigned)(BH * nc), (unsigned)(RT * (RT + 1) / 2)),
                       kAThreads, a_smem, stream>>>(
        (const bf16*)q, (const bf16*)k, bc, li, A, rsum, S, H, dk, L, st[0],
        st[1], st[2], st[3], st[4], st[5]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int R = ((dk + 15) & ~15) > kORDK ? 128 : 64;
    auto out = R == 128 ? gla_out_kernel<128> : gla_out_kernel<64>;
    const size_t o_smem = out_smem_bytes(R, dk, L);
    e = cudaFuncSetAttribute(out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)o_smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 ogrid((unsigned)(nc * ((L + R - 1) / R)), (unsigned)BH,
                     (unsigned)((dv + kOV - 1) / kOV));
    out<<<ogrid, 2 * R, o_smem, stream>>>(
        (const bf16*)q, (const bf16*)v, bc, A, rsum, s_hi, s_lo, n_in,
        (bf16*)y, S, H, dk, dv, L, st[0], st[1], st[2], st[6], st[7], st[8],
        scale, normalize, s0 != nullptr);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k (B,S,H,dk) and v (B,S,H,dv) with strides (batch, seq, head) and a
// contiguous last axis; s0 (B,H,dk,dv), n0 (B,H,dk) f32 or null; y
// (B,S,H,dv) contiguous in q's dtype; sT, nT like s0, n0.  S is a multiple
// of the chunk L (1 <= L <= 256); dk and dv multiples of 8, dk <= 512.
// dtype 0 = f32, the CUDA-core kernel, one launch: bc, li (B*H, S) f32
// contiguous are its inputs, bc the within-chunk cumulative log forget
// gate; lf, lg, scr_s, scr_f are unused.  dtype 1 = bf16, the tensor-core
// route, four launches: lf, lg are the log gates (B,S,H) f32 contiguous,
// and bc, li (B*H, S) f32 are written by the first launch; with nc = S/L
// and AP = 64 ceil(L/64), scr_s holds 2*nc*B*H*dk*dv bf16 (the entering
// states' hi and lo planes) and scr_f nc*B*H*(dk*dv + 2*dk + AP*AP*65/64)
// f32 (the chunks' own states and normalisers, the entering normalisers,
// the decayed scores and their row sums per key tile).
// Returns cudaGetLastError() after the last launch.
int gla_chunk(const void* q, const void* k, const void* v, void* bc,
              void* li, const void* lf, const void* lg, const void* s0,
              const void* n0, void* y, void* sT, void* nT, void* scr_s,
              void* scr_f, int B, int S, int H, int dk, int dv, int L,
              int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
              int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
              int64_t v_sh, float scale, int normalize, int dtype,
              void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
    if (L <= 0 || L > kMaxL || S % L != 0 || dk <= 0 || dv <= 0 ||
        dk % 8 != 0 || dv % 8 != 0 || dk > 512)
        return (int)cudaErrorInvalidValue;
    const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
    cudaStream_t s = (cudaStream_t)stream;
    const float* f_s0 = (const float*)s0;
    const float* f_n0 = (const float*)n0;
    switch (dtype) {
        case 0:
            if (smem_floats(dk) * sizeof(float) > 232448)
                return (int)cudaErrorInvalidValue;
            return launch_f32(q, k, v, (const float*)bc, (const float*)li,
                              f_s0, f_n0, y, (float*)sT, (float*)nT, B, S, H,
                              dk, dv, L, st, scale, normalize, s);
        case 1:
            if (lf == nullptr || lg == nullptr || scr_s == nullptr ||
                scr_f == nullptr)
                return (int)cudaErrorInvalidValue;
            return launch_mma(q, k, v, (const float*)lf, (const float*)lg,
                              (float*)bc, (float*)li, f_s0, f_n0, y,
                              (float*)sT, (float*)nT, (bf16*)scr_s,
                              (float*)scr_f, B, S, H, dk, dv, L, st, scale,
                              normalize, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
