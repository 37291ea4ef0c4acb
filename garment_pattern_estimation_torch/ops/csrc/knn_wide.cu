// Standalone kNN ids for Hopper (sm_90a), wide D: points (B, N, D) f32,
// 16 < D <= 256 -> ids (B, N, k) i32, slot 0 the query itself, slots
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
// of compulsory traffic (0.23 ms at 3.35 TB/s): bound by operations.
//
// Design: split_rows_kernel writes each point once as three bf16 chunks
// (zero-padded to Dp = 160) and its norm; then one block of 256 threads per
// (batch element, 64 query rows) runs select_wide: the queries' chunks in
// shared memory, keys streamed in 64-key units of one chunk, double-
// buffered with cp.async, cross terms by mma.sync m16n8k16 bf16 from
// ldmatrix fragments, each (query, key) pair packed and rejected against
// the thread's current (k-1)-th key before any insert. Shared memory at
// D = 150 is 108 KB, so two blocks share an SM. Left on the table: each
// unordered pair is computed in both directions (a symmetric schedule
// would merge candidates across blocks), mma.sync instead of wgmma with
// TMA, and the split chunks cost 1.6 times the f32 cloud's L2 traffic.
// k = 17..128 run the capacity instances K = 32 (64 query rows a block),
// 64 and 128 (32 rows: their warp lists take QB K 8 bytes); a block's
// shared memory is at most 206 KB (D = 256, K = 32).

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

template <int K>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
    auto kernel = knn_wide_kernel<K>;
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

// Launches the wide-D kNN on `stream`: x (B, N, D) f32, 16 < D <= 256 ->
// idx (B, N, k) i32; `scratch` holds knn_wide_scratch_bytes(B, N, D) bytes
// (the split rows). Returns the CUDA error code (0 = ok); an argument the
// kernel does not take returns cudaErrorInvalidValue.
extern "C" int knn_wide_forward(const void* x, void* idx, void* scratch, size_t scratch_bytes,
                                int B, int N, int D, int k, void* stream) {
    if (B < 1 || B > 65535 || N < 1 || N > MAX_KNN_N || D <= SMALL_C_MAX
            || D > WIDE_C_MAX || k < 1 || k > LARGE_K_MAX || k > N
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
