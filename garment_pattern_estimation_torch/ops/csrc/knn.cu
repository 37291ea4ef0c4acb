// Standalone kNN ids for Hopper (sm_90a), small D: points (B, N, D) f32,
// D <= 16 -> ids (B, N, k) i32, slot 0 the query itself, slots 1..k-1 the
// k-1 smallest (quantized squared distance, column) pairs over the other
// points, ties to the lower column.
//
// Replaces the TPU kernel garment_pattern_estimation_tpu/ops/knn.py:
// _knn_kernel_direct (knn_pallas, D <= 16). The TPU kernel packs 11-bit
// tile-local columns and merges its column tiles on (quantized distance,
// global id); the selection here is edgeconv_select.cuh's select_small_c,
// whose one ranking key carries the global column (int32 up to 2048
// columns, int64 beyond), so no merge pass exists. Distances are exact f32
// summed per dimension in dimension order without FMA, so the ids equal
// the plain PyTorch version's (ops/knn.py: knn_reference) bit for bit.
//
// What bounds it on an H100 SXM. At the stress shape (B=128, N=10000,
// D=3, k=5) the distances are 3 D B N^2 = 1.15e11 f32 operations, 1.7 ms
// at 67 TFLOP/s, against 35 MB of compulsory traffic (the points read once,
// the ids written once), 0.01 ms at 3.35 TB/s: bound by operations (the
// selection's compares and inserts, about as many again, are not counted).
//
// Design: one block of 256 threads per (batch element, 16 query rows), the
// query tiles of one cloud adjacent in the grid; keys staged in shared
// memory in windows of up to 2048 columns (24 KB at D = 3); each query's
// 16 threads keep their best k-1 in registers and merge them with half-warp
// shuffles. Left on the table: the window is not double-buffered, and each
// block re-reads the cloud's keys from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_KNN_N = 1 << 24;    // keeps every int index product in range

struct Params {
    const float* x;               // (B, N, D) f32
    int* idx;                     // (B, N, K) i32
    int N, D, window;
};

template <int K, bool TILED>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [TM][K]
    float* keys = reinterpret_cast<float*>(smem + HEADER_BYTES);
    const int b = blockIdx.y, n0 = blockIdx.x * TM, t = threadIdx.x;
    const int N = p.N;
    const float* xb = p.x + static_cast<size_t>(b) * N * p.D;

    if constexpr (K == 1) {
        if (t < TM) sidx[t] = min(n0 + t, N - 1);
    } else {
        select_small_c<K, TILED>(N, p.D, xb, n0, keys, sidx, p.window);
    }
    __syncthreads();
    if (t < TM * K) {
        const int n = n0 + t / K;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * K + t % K] = sidx[t];
    }
}

template <int K, bool TILED>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
    auto kernel = knn_kernel<K, TILED>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + TM - 1) / TM, B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool TILED>
cudaError_t launch_k(int k, const Params& p, int B, size_t smem, cudaStream_t stream) {
    switch (k) {
        case 1: return launch<1, TILED>(p, B, smem, stream);
        case 2: return launch<2, TILED>(p, B, smem, stream);
        case 3: return launch<3, TILED>(p, B, smem, stream);
        case 4: return launch<4, TILED>(p, B, smem, stream);
        case 5: return launch<5, TILED>(p, B, smem, stream);
        case 6: return launch<6, TILED>(p, B, smem, stream);
        case 7: return launch<7, TILED>(p, B, smem, stream);
        case 8: return launch<8, TILED>(p, B, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Launches the kNN on `stream`: x (B, N, D) f32 -> idx (B, N, k) i32. The
// int64 ranking runs when N > 2048 or when tile_n > 0 (which also sets the
// key window, at most 2048 columns); tile_n = 0 chooses by N. Returns the
// CUDA error code (0 = ok); an argument the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int knn_forward(const void* x, void* idx, int B, int N, int D, int k,
                           int tile_n, void* stream) {
    if (B < 1 || B > 65535 || N < 1 || N > MAX_KNN_N || D < 1 || D > SMALL_C_MAX
            || k < 1 || k > MAX_K || k > N || tile_n < 0 || tile_n > MAX_N)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.idx = static_cast<int*>(idx);
    p.N = N; p.D = D;
    const bool tiled = N > MAX_N || tile_n > 0;
    p.window = small_c_window(N, D, tiled, tile_n);
    const size_t smem = HEADER_BYTES + select_bytes(N, D, tiled, p.window);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = tiled ? launch_k<true>(k, p, B, smem, s)
                                  : launch_k<false>(k, p, B, smem, s);
    return static_cast<int>(err);
}
