// Lane-scatter kernel for Hopper (sm_90a): x[l, idx[l]] = val[l] (set) or
// x[l, idx[l]] += val[l] (add; logical OR on bool) over [L, N] state.
//
// Replaces the Pallas kernel _scatter_kernel of
// src/repro/kernels/lane_scatter.py (lane_scatter_set / lane_scatter_add).
//
// The TPU kernel copies every row through VMEM and patches one element, so
// it moves 2 * L * N elements and returns a new array.  This kernel updates
// the state in place: one thread per lane reads idx, val (and valid) and
// touches the one addressed element.  The port updates in place to save
// that copy; nothing else holds the old state.  What bounds it is the
// launch itself: it moves a few bytes a lane (L <= 64 here), so its time is
// the card's launch latency, not bandwidth or arithmetic.
//
// Lockstep masking: where valid is given and valid[l] is 0, lane l keeps
// its own bits (no store).  Bool state is torch's 1-byte bool; add on bool
// is a logical OR.  An index outside [0, N) is skipped, never written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

}  // extern "C"
