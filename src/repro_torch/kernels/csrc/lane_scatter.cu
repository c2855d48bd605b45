// Lane-scatter kernels for Hopper (sm_90a): x[l, idx[l]] = val[l] (set) or
// x[l, idx[l]] += val[l] (add; logical OR on bool) over [L, N] state.
//
// Replaces the Pallas kernel _scatter_kernel of
// src/repro/kernels/lane_scatter.py (lane_scatter_set / lane_scatter_add).
//
// The TPU kernel copies every row through VMEM and patches one element, so
// it moves 2 * L * N elements and returns a new array.  These kernels
// update the state in place: one thread per row touches the one addressed
// element.  The port updates in place to save that copy; nothing else
// holds the old state.  What bounds them is the launch itself: a write
// moves a few bytes a row (L <= 64 here), so its time is the card's launch
// latency, not bandwidth or arithmetic.
//
// Two entry points:
//   lane_scatter        one write, operands in device memory (the per-row
//                       wrappers lane_scatter_set / lane_scatter_add);
//   lane_scatter_batch  a list of writes in ONE launch (the simulator's
//                       serve and commit writes).  The host packs every
//                       write's descriptor, indices and values into the
//                       kernel's parameter block (a struct passed by value:
//                       512 B, or 32,760 bytes, which CUDA allows since
//                       12.1 on sm_70+), so the batch needs no
//                       host-to-device copy and no staging buffer; a launch
//                       is all it costs.
//
// Batch layout (int32 words; the host side is kernels/lane_scatter.py):
//   w[0] targets T, w[1] rows R over all targets,
//   then T target records of 8 words:
//     ptr lo, ptr hi, n, rows, first row (global), dtype, first write,
//     writes,
//   then the write records of 2 words: add flag, word offset of the
//     write's rows indices followed by its rows values (f32 bits, i32, or
//     0/1 for bool).
// One thread per (target, row) walks that target's writes in list order,
// so a later write to the same element wins.  The host never puts two
// overlapping targets into one launch, so threads never alias.  An index
// outside [0, n) is skipped; the host encodes a masked-off (valid == 0)
// row as index -1, so it keeps its bits.
//
// Lockstep masking (lane_scatter): where valid is given and valid[l] is 0,
// lane l keeps its own bits (no store).  Bool state is torch's 1-byte bool;
// add on bool is a logical OR.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTargetWords = 8;
constexpr int kWriteWords = 2;
constexpr int kSmallWords = 128;    // 512 bytes: a serve's or a commit's
constexpr int kLargeWords = 8190;   // 32,760 bytes: CUDA >= 12.1, sm_70+

template <typename T, bool kAdd>
__global__ void lane_scatter_kernel(T* __restrict__ x,
                                    const int* __restrict__ idx,
                                    const T* __restrict__ val,
                                    const uint8_t* __restrict__ valid,
                                    int64_t lanes, int64_t n) {
    const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= lanes) return;
    if (valid != nullptr && !valid[l]) return;
    const int64_t j = idx[l];
    if (j < 0 || j >= n) return;
    T* p = x + l * n + j;
    if (kAdd) {
        *p = *p + val[l];
    } else {
        *p = val[l];
    }
}

__global__ void lane_or_kernel(uint8_t* __restrict__ x,
                               const int* __restrict__ idx,
                               const uint8_t* __restrict__ val,
                               const uint8_t* __restrict__ valid,
                               int64_t lanes, int64_t n) {
    const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= lanes) return;
    if (valid != nullptr && !valid[l]) return;
    const int64_t j = idx[l];
    if (j < 0 || j >= n) return;
    uint8_t* p = x + l * n + j;
    *p = (uint8_t)((*p != 0) | (val[l] != 0));
}

template <typename T>
void launch(void* x, const void* idx, const void* val, const void* valid,
            int64_t lanes, int64_t n, int add, cudaStream_t stream) {
    const unsigned grid = (unsigned)((lanes + kThreads - 1) / kThreads);
    if (add) {
        lane_scatter_kernel<T, true><<<grid, kThreads, 0, stream>>>(
            (T*)x, (const int*)idx, (const T*)val, (const uint8_t*)valid,
            lanes, n);
    } else {
        lane_scatter_kernel<T, false><<<grid, kThreads, 0, stream>>>(
            (T*)x, (const int*)idx, (const T*)val, (const uint8_t*)valid,
            lanes, n);
    }
}

template <int kWords>
struct Batch {
    int32_t w[kWords];
};

// Apply one write's element to row `r` of a target: set, add, or OR.
__device__ __forceinline__ void apply(char* row, int dtype, int add,
                                      int64_t j, int32_t v) {
    if (dtype == 0) {
        float* p = (float*)row + j;
        *p = add ? *p + __int_as_float(v) : __int_as_float(v);
    } else if (dtype == 1) {
        int* p = (int*)row + j;
        *p = add ? *p + v : v;
    } else {
        uint8_t* p = (uint8_t*)row + j;
        *p = (uint8_t)(add ? ((*p != 0) | (v != 0)) : (v != 0));
    }
}

template <int kWords>
__global__ void __launch_bounds__(kThreads)
lane_batch_kernel(const __grid_constant__ Batch<kWords> b) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= b.w[1]) return;
    const int nt = b.w[0];
    // this thread's target: the last one whose first row is <= g
    int t = 0;
    while (t + 1 < nt && b.w[2 + (t + 1) * kTargetWords + 4] <= g) ++t;
    const int32_t* td = b.w + 2 + t * kTargetWords;
    const uint64_t ptr = (uint64_t)(uint32_t)td[0] |
                         ((uint64_t)(uint32_t)td[1] << 32);
    const int64_t n = td[2];
    const int rows = td[3];
    const int r = g - td[4];
    const int dtype = td[5];
    const int esize = dtype == 2 ? 1 : 4;
    char* row = (char*)ptr + (int64_t)r * n * esize;
    const int32_t* wd = b.w + 2 + nt * kTargetWords;
    const int w_end = td[6] + td[7];
    for (int w = td[6]; w < w_end; ++w) {
        const int add = wd[w * kWriteWords];
        const int off = wd[w * kWriteWords + 1];
        const int64_t j = b.w[off + r];
        if (j < 0 || j >= n) continue;
        apply(row, dtype, add, j, b.w[off + rows + r]);
    }
}

template <int kWords>
int launch_batch(const int32_t* words, int n_words, cudaStream_t s) {
    Batch<kWords> b;
    memcpy(b.w, words, sizeof(int32_t) * (size_t)n_words);
    const int rows = words[1];
    const unsigned grid = (unsigned)((rows + kThreads - 1) / kThreads);
    lane_batch_kernel<kWords><<<grid, kThreads, 0, s>>>(b);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = i32, 2 = bool (1 byte).  valid may be null.
int lane_scatter(void* x, const void* idx, const void* val,
                 const void* valid, int64_t lanes, int64_t n, int dtype,
                 int add, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (lanes <= 0) return (int)cudaGetLastError();
    switch (dtype) {
        case 0:
            launch<float>(x, idx, val, valid, lanes, n, add, s);
            break;
        case 1:
            launch<int>(x, idx, val, valid, lanes, n, add, s);
            break;
        case 2:
            if (add) {
                const unsigned grid =
                    (unsigned)((lanes + kThreads - 1) / kThreads);
                lane_or_kernel<<<grid, kThreads, 0, s>>>(
                    (uint8_t*)x, (const int*)idx, (const uint8_t*)val,
                    (const uint8_t*)valid, lanes, n);
            } else {
                launch<uint8_t>(x, idx, val, valid, lanes, n, 0, s);
            }
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// One launch applying a packed batch of writes (layout above); the block
// is copied into the kernel's parameters, the 512 B variant when it fits:
// a launch pushes the whole parameter struct, used or not (chip_smoke.py
// phase 1 times the serve's write in both variants).
int lane_scatter_batch(const void* words, int n_words, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* w = (const int32_t*)words;
    if (n_words < 2 || n_words > kLargeWords)
        return (int)cudaErrorInvalidValue;
    if (w[1] <= 0) return (int)cudaGetLastError();
    if (n_words <= kSmallWords)
        return launch_batch<kSmallWords>(w, n_words, s);
    return launch_batch<kLargeWords>(w, n_words, s);
}

}  // extern "C"
