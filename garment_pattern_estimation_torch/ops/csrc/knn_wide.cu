// Standalone kNN ids for Hopper (sm_90a), wide D: points (B, N, D) f32,
// D > 16 -> ids (B, N, k) i32, slot 0 the query itself, slots
// 1..k-1 the k-1 smallest (squared distance, column) pairs over the other
// points, ranked by the full f32 distance (not quantized), ties to the
// lower column.
//
// Replaces the TPU kernels garment_pattern_estimation_tpu/ops/knn.py:
// _knn_kernel (keys resident in VMEM) and _knn_kernel_hbm (key tiles
// double-buffered from HBM), knn_pallas's D > 16 path. The split between
// the two is a TPU memory-space choice; here the keys always stream from
// device memory through shared memory (one cloud's split rows, 9.6 MB at
// (10^4, 150), stay in L2 while the cloud's query blocks, adjacent in the
// grid, run). Distances are the TPU kernels' arithmetic:
// q_norm + k_norm - 2 * cross, cross the six partial products of the 3-term
// bf16 truncation splits (hi, mid, lo) of _CROSS_PAIRS[3]. Every product is
// of two bf16-exact values, so it is exact on bf16 tensor cores (as on the
// TPU's MXU); the tensor core sums each 16-deep step, the steps are added
// in f32, small products first (edgeconv_select.cuh: select_wide), so the
// sum's order is not the JAX package's. The distance is not clamped at
// 0: near duplicates may give a negative one, which ranks below every
// positive one (RankExact). The plain PyTorch version is ops/knn.py:
// knn_reference (wide_sq_dists + select_exact); its sums run in cuBLAS's
// order, so ids may differ from it at near ties only.
//
// What bounds it on an H100 SXM. At the chunked training's conv1 shape
// (B=128, N=10000, D=150, k=5) the six split products are
// 6 x 2 D = 1800 operations per distance, 2.3e13 over every ordered pair
// (1.15e13 over unordered pairs, 11.6 ms at 989 TFLOP/s), against 0.8 GB
// of compulsory traffic (0.23 ms at 3.35 TB/s): bound by operations, and
// by the f32 add of each 16-deep step to the pair's sum: 6 x 10 = 60 adds
// per ordered pair, 7.7e11 (23 ms at one warp instruction per clock per
// sub-partition).
//
// Design: split_rows_kernel writes each point once as three bf16 chunks
// (zero-padded to Dp = 160) and its norm; then, for k <= 16 and D <= 160,
// knn_wide_stream_kernel runs select_stream (edgeconv_select.cuh) over
// (batch element, 128 query rows) blocks: a producer warp keeps four
// 64-key units of one chunk in flight with TMA, two consumer warpgroups
// run the cross terms on wgmma m64n64k16 from shared memory and add each
// 16-deep step in f32 in select_wide's order, then each (query, key) pair's
// distance is checked against its thread's current (k-1)-th key. A block
// streams its cloud's three chunks from L2 once for 128 rows: 9.6 MB, 97 GB
// at (128, 10^4, 150) (193 GB at 64 rows). Measured there on an H100 SXM at
// 700 W (k = 5): 80 ms, against 138 ms for select_wide. Elsewhere (D > 160,
// where its 3 x 128 query rows do not fit shared memory with the ring, or
// k > 16) one block of 256 threads per (batch element, 64 query rows) runs
// select_wide: keys in 64-key units double-buffered with cp.async,
// mma.sync m16n8k16 from ldmatrix fragments; 108 KB of shared memory at
// D = 150. Left on the table: each unordered pair is computed in both
// directions (a symmetric schedule would merge candidates across blocks),
// the f32 adds (fixed by the arithmetic), and the split chunks cost 1.6
// times the f32 cloud's L2 traffic.
// k = 17..128 run the capacity instances K = 32 (64 query rows a block),
// 64 and 128 (32 rows: their warp lists take QB K 8 bytes); a block's
// shared memory is at most 206 KB (D = 256, K = 32). D > 256 stages the
// rows 256 features at a time (select_wide_general, the K = 16 instance for
// every k <= 16): the same shared memory as D = 256.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_KNN_N = 1 << 24;
constexpr int SPLITS = 3;

struct Params {
    const void* split;            // split_rows_kernel's output for the B N points
    int* idx;                     // (B, N, k) i32
    int N, D, k;
    size_t P;                     // B N
};

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_wide_kernel(const Params p) {
    constexpr int QB = select_rows(false, true, K);
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [QB][K]
    unsigned char* work = smem + header_bytes(QB, K);
    const int b = blockIdx.y, n0 = blockIdx.x * QB, t = threadIdx.x;
    const int N = p.N;

    if constexpr (K == 1) {
        if (t < QB) sidx[t] = min(n0 + t, N - 1);
    } else {
        select_wide<K, RankExact, SPLITS, QB, false>(
            N, cloud_rows(p.split, p.P, p.D, SPLITS, b, N), n0, work, sidx, p.k);
    }
    __syncthreads();
    const int k = filled_slots<K>(p.k);
    for (int e = t; e < QB * k; e += THREADS) {
        const int q = e / k, s = e - q * k, n = n0 + q;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * k + s] = sidx[q * K + s];
    }
}

// D past WIDE_C_MAX: the rows staged in chunks (select_wide_general); the
// K = 16 instance serves every k <= 16 (it fills the first k slots).
template <int K>
__global__ void __launch_bounds__(THREADS)
knn_wide_general_kernel(const Params p) {
    constexpr int QB = select_rows(false, true, K);
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [QB][K]
    const int b = blockIdx.y, n0 = blockIdx.x * QB, t = threadIdx.x, N = p.N;
    select_wide_general<K, RankExact, SPLITS, QB, false>(
        N, cloud_rows(p.split, p.P, p.D, SPLITS, b, N), n0, smem + header_bytes(QB, K), sidx,
        p.k);
    __syncthreads();
    for (int e = t; e < QB * p.k; e += THREADS) {
        const int q = e / p.k, s = e - q * p.k, n = n0 + q;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * p.k + s] = sidx[q * K + s];
    }
}

// The wide-D kNN on Hopper (select_stream, edgeconv_select.cuh): ids into
// a.ids, for D <= WIDE_C_MAX where its shared memory fits (stream_fits).
template <int K>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
knn_wide_stream_kernel(const __grid_constant__ CUtensorMap rows, const StreamArgs a) {
    extern __shared__ unsigned char smem[];
    select_stream<K, RankExact, SPLITS, false>(&rows, a, blockIdx.y, blockIdx.x * STREAM_QB,
                                               smem);
}

cudaError_t launch_stream_k(int k, const Params& p, int B, cudaStream_t stream) {
    const StreamArgs a{p.idx, nullptr, p.N, p.D, p.k, p.P};
    switch (k) {
        case 2: return launch_stream(knn_wide_stream_kernel<2>, p.split, a, B, SPLITS, 2, stream);
        case 3: return launch_stream(knn_wide_stream_kernel<3>, p.split, a, B, SPLITS, 3, stream);
        case 4: return launch_stream(knn_wide_stream_kernel<4>, p.split, a, B, SPLITS, 4, stream);
        case 5: return launch_stream(knn_wide_stream_kernel<5>, p.split, a, B, SPLITS, 5, stream);
        case 6: return launch_stream(knn_wide_stream_kernel<6>, p.split, a, B, SPLITS, 6, stream);
        case 7: return launch_stream(knn_wide_stream_kernel<7>, p.split, a, B, SPLITS, 7, stream);
        case 8: return launch_stream(knn_wide_stream_kernel<8>, p.split, a, B, SPLITS, 8, stream);
        default:
            return launch_stream(knn_wide_stream_kernel<MAX_K>, p.split, a, B, SPLITS, MAX_K,
                                 stream);
    }
}

template <int K, bool GENERAL = false>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
    void (*kernel)(const Params);
    if constexpr (GENERAL)
        kernel = knn_wide_general_kernel<K>;
    else
        kernel = knn_wide_kernel<K>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = select_rows(false, true, K);
    const dim3 grid((p.N + QB - 1) / QB, B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch knn_wide_forward needs for (B, N, D).
extern "C" size_t knn_wide_scratch_bytes(int B, int N, int D) {
    return split_bytes(static_cast<size_t>(B) * N, D, SPLITS);
}

// Launches the wide-D kNN on `stream`: x (B, N, D) f32, D > 16 ->
// idx (B, N, k) i32; `scratch` holds knn_wide_scratch_bytes(B, N, D) bytes
// (the split rows). Returns the CUDA error code (0 = ok); an argument the
// kernel does not take returns cudaErrorInvalidValue.
extern "C" int knn_wide_forward(const void* x, void* idx, void* scratch, size_t scratch_bytes,
                                int B, int N, int D, int k, void* stream) {
    if (B < 1 || B > 65535 || N < 1 || N > MAX_KNN_N || D <= SMALL_C_MAX
            || k < 1 || k > LARGE_K_MAX || k > N
            || scratch_bytes < knn_wide_scratch_bytes(B, N, D))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.split = scratch;
    p.idx = static_cast<int*>(idx);
    p.N = N; p.D = D; p.k = k;
    p.P = static_cast<size_t>(B) * N;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_split<SPLITS>(static_cast<const float*>(x), p.P, D, scratch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (stream_fits(p.P, D, SPLITS, k)) return static_cast<int>(launch_stream_k(k, p, B, s));
    if (D > WIDE_C_MAX) {             // the K = 16 instance serves every k <= 16
        const int K = k == 1 ? 1 : instance_k(k < MAX_K ? MAX_K : k);
        const size_t smem = header_bytes(select_rows(false, true, K), K)
                            + wide_bytes(D, SPLITS, sizeof(RankExact::T), K, true);
        switch (K) {
            case 1: return static_cast<int>(launch<1>(p, B, smem, s));
            case MAX_K: return static_cast<int>(launch<MAX_K, true>(p, B, smem, s));
            case 32: return static_cast<int>(launch<32, true>(p, B, smem, s));
            case 64: return static_cast<int>(launch<64, true>(p, B, smem, s));
            default: return static_cast<int>(launch<LARGE_K_MAX, true>(p, B, smem, s));
        }
    }
    const size_t smem = header_bytes(select_rows(false, true, instance_k(k)), instance_k(k))
                        + wide_bytes(D, SPLITS, sizeof(RankExact::T), instance_k(k), true);
    switch (k) {
        case 1: return static_cast<int>(launch<1>(p, B, smem, s));
        case 2: return static_cast<int>(launch<2>(p, B, smem, s));
        case 3: return static_cast<int>(launch<3>(p, B, smem, s));
        case 4: return static_cast<int>(launch<4>(p, B, smem, s));
        case 5: return static_cast<int>(launch<5>(p, B, smem, s));
        case 6: return static_cast<int>(launch<6>(p, B, smem, s));
        case 7: return static_cast<int>(launch<7>(p, B, smem, s));
        case 8: return static_cast<int>(launch<8>(p, B, smem, s));
        case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
            return static_cast<int>(launch<MAX_K>(p, B, smem, s));
        default: break;
    }
    switch (instance_k(k)) {
        case 32: return static_cast<int>(launch<32>(p, B, smem, s));
        case 64: return static_cast<int>(launch<64>(p, B, smem, s));
        case LARGE_K_MAX: return static_cast<int>(launch<LARGE_K_MAX>(p, B, smem, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
