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
// at 67 TFLOP/s (0.86 ms over unordered pairs), against 35 MB of
// compulsory traffic (the points read once, the ids written once), 0.01 ms
// at 3.35 TB/s: bound by operations. Per ordered pair the kernel issues
// about ten instructions (three subtracts, three multiplies, two adds, the
// reject compare, a share of the branch), so the issue rate, not the f32
// peak, sets its pace, and every insert a warp takes costs on top.
//
// Design: one block of 256 threads per (batch element, SMALL_QB = 128
// query rows), the query blocks of one cloud adjacent in the grid, so the
// cloud stays in L2; select_small_c register-tiles 4 query rows per thread
// against one key lane per warp, stages 2048-column windows double-
// buffered with cp.async, rejects almost every pair with one 32-bit
// compare before any insert, keeps its lists in 32-bit keys (lane-local
// columns, N <= 16384; int64 global keys beyond) and shares each row's
// limit across the 8 key lanes every 512 columns; the lists of the 8 key
// lanes merge at the end. Left on the table: each unordered pair is
// computed in both directions, and a warp still takes the insert path on
// many of its first steps, while its 128 lists fill. k = 17..128 run the
// capacity instances K = 32, 64, 128 (select_small_c_large: a warp list
// per query row, 32 query rows a block; edgeconv_select.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_KNN_N = 1 << 24;    // keeps every int index product in range

struct Params {
    const float* x;               // (B, N, D) f32
    int* idx;                     // (B, N, k) i32
    int N, D, k, window;
};

template <int K, bool TILED, int CD, bool LANE32>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const Params p) {
    constexpr int QB = select_rows(true, TILED, K);
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [QB][K]
    const int b = blockIdx.y, n0 = blockIdx.x * QB, t = threadIdx.x;
    const int N = p.N;
    const float* xb = p.x + static_cast<size_t>(b) * N * p.D;

    if constexpr (K == 1) {
        if (t < QB) sidx[t] = min(n0 + t, N - 1);
    } else if constexpr (K > MAX_K) {
        select_small_c_large<K, CD>(N, p.D, xb, n0, smem + header_bytes(QB, K), sidx, p.k);
    } else {
        select_small_c<K, TILED, CD, LANE32>(N, p.D, xb, n0, smem + header_bytes(SMALL_QB, K),
                                             sidx, p.window, p.k);
    }
    __syncthreads();
    const int k = filled_slots<K>(p.k);
    for (int e = t; e < QB * k; e += THREADS) {
        const int q = e / k, s = e - q * k, n = n0 + q;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * k + s] = sidx[q * K + s];
    }
}

template <int K, bool TILED, int CD, bool LANE32>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
    auto kernel = knn_kernel<K, TILED, CD, LANE32>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = select_rows(true, TILED, K);
    const dim3 grid((p.N + QB - 1) / QB, B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool TILED, int CD, bool LANE32>
cudaError_t launch_k(int k, const Params& p, int B, size_t smem, cudaStream_t stream) {
    switch (k) {
        case 1: return launch<1, false, 3, true>(p, B, smem, stream);   // no selection
        case 2: return launch<2, TILED, CD, LANE32>(p, B, smem, stream);
        case 3: return launch<3, TILED, CD, LANE32>(p, B, smem, stream);
        case 4: return launch<4, TILED, CD, LANE32>(p, B, smem, stream);
        case 5: return launch<5, TILED, CD, LANE32>(p, B, smem, stream);
        case 6: return launch<6, TILED, CD, LANE32>(p, B, smem, stream);
        case 7: return launch<7, TILED, CD, LANE32>(p, B, smem, stream);
        case 8: return launch<8, TILED, CD, LANE32>(p, B, smem, stream);
        case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
            return launch<MAX_K, TILED, CD, LANE32>(p, B, smem, stream);
        default: break;
    }
    switch (instance_k(k)) {          // one instance per capacity, any N
        case 32: return launch<32, false, CD, true>(p, B, smem, stream);
        case 64: return launch<64, false, CD, true>(p, B, smem, stream);
        case LARGE_K_MAX: return launch<LARGE_K_MAX, false, CD, true>(p, B, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The instantiation for (tiled, key dimensions, N).
template <bool TILED, int CD>
cudaError_t launch_n(int k, const Params& p, int B, size_t smem, cudaStream_t stream) {
    return p.N <= MAX_LANE32_N ? launch_k<TILED, CD, true>(k, p, B, smem, stream)
                               : launch_k<TILED, CD, false>(k, p, B, smem, stream);
}

}  // namespace

// Launches the kNN on `stream`: x (B, N, D) f32 -> idx (B, N, k) i32. The
// int64 ranking runs when N > 2048 or when tile_n > 0 (which also caps the
// key window at tile_n columns, at most 2048); tile_n = 0 chooses by N.
// Returns the CUDA error code (0 = ok); an argument the kernel does not
// take returns cudaErrorInvalidValue.
extern "C" int knn_forward(const void* x, void* idx, int B, int N, int D, int k,
                           int tile_n, void* stream) {
    if (B < 1 || B > 65535 || N < 1 || N > MAX_KNN_N || D < 1 || D > SMALL_C_MAX
            || k < 1 || k > LARGE_K_MAX || k > N || tile_n < 0 || tile_n > MAX_N)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.idx = static_cast<int*>(idx);
    p.N = N; p.D = D; p.k = k;
    const bool tiled = N > MAX_N || tile_n > 0;
    p.window = small_c_window(N, D, tile_n);
    const size_t smem = header_bytes(select_rows(true, tiled, instance_k(k)), instance_k(k))
                        + select_bytes(D, tiled, p.window, k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool xyz = small_c_dims(D) == 3;
    const cudaError_t err =
        tiled ? (xyz ? launch_n<true, 3>(k, p, B, smem, s) : launch_n<true, SMALL_C_MAX>(k, p, B, smem, s))
              : (xyz ? launch_k<false, 3, true>(k, p, B, smem, s)
                     : launch_k<false, SMALL_C_MAX, true>(k, p, B, smem, s));
    return static_cast<int>(err);
}
