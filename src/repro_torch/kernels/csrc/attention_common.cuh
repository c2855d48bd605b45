// Shared device helpers of the attention kernels (flash_attention.cu,
// decode_attention.cu): the mask, the f32 conversions, the tile loader and
// the asynchronous copies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The finite mask sentinel of the JAX kernels and the plain versions: a
// masked logit is -1e30, never -inf, so exp(m_prev - m_cur) is never
// exp(-inf + inf).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(int qp, int kp, int window,
                                        int sink) {
    bool keep = (kp <= qp) && (kp >= 0);
    if (window > 0) {
        bool in_win = kp > qp - window;
        if (sink > 0) in_win = in_win || (kp < sink);
        keep = keep && in_win;
    }
    return keep;
}

// 16 bytes of T (4 f32 or 8 bf16) as f32.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
    }
}

// Rows [r0, r0 + ROWS) of a (rows, D) matrix with row stride ss (elements)
// into dst as f32 with row pitch P; rows at or past n are zeros.  16-byte
// loads, eight in flight per thread before any is stored, so a tile costs
// one or two trips to memory, not one per element.  The wrapper checks
// that every row start is 16-byte aligned.
template <typename T, int ROWS, int D, int P, int kThreads>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t ss, int r0, int n,
                                          float* dst, int tid) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = D / V;
    constexpr int CH = ROWS * CPR;
    constexpr int BATCH = 8;
    for (int c0 = 0; c0 < CH; c0 += BATCH * kThreads) {
        uint4 u[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int c = c0 + tid + i * kThreads;
            const int r = c / CPR;
            u[i] = make_uint4(0u, 0u, 0u, 0u);
            if (c < CH && r0 + r < n)
                u[i] = *reinterpret_cast<const uint4*>(
                    src + (int64_t)(r0 + r) * ss + (c % CPR) * V);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int c = c0 + tid + i * kThreads;
            if (c >= CH) break;
            float f[V];
            unpack(u[i], f, T());
            float* d = dst + (c / CPR) * P + (c % CPR) * V;
#pragma unroll
            for (int j = 0; j < V; ++j) d[j] = f[j];
        }
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros when !ok (the
// source address must still be valid).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
