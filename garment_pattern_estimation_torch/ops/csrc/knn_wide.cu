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
// global memory (the cloud, 6 MB at (10^4, 150), stays in L2 while the
// cloud's query blocks, adjacent in the grid, run). Distances are the
// TPU kernels' arithmetic: q_norm + k_norm - 2 * cross, cross from 3-term
// bf16 truncation splits (hi, mid, lo) summing six partial products in
// _CROSS_PAIRS[3] order, ((((p00 + p01) + p10) + p11) + p02) + p20. Every
// product is of two bf16-exact values, exact in f32, and each of the six
// accumulates with one fmaf per dimension. The distance is not clamped at
// 0: near duplicates may give a negative one, which must rank below every
// positive one, so the key maps the f32 bits to an order-preserving
// unsigned integer (-0 sent to +0 first, so the two tie as the float
// compare ties them) above the 32-bit column. The plain PyTorch version is
// ops/knn.py: knn_reference (wide_sq_dists + select_exact); its sums run in
// cuBLAS's order, so ids may differ from it at near ties only.
//
// What bounds it on an H100 SXM. At the chunked training's conv1 shape
// (B=128, N=10000, D=150, k=5) the six split products are
// 6 * 2 B N^2 D = 2.3e13 operations, 23 ms on bf16 tensor cores at
// 989 TFLOP/s, against 0.8 GB of compulsory traffic (points read once, ids
// written once), 0.23 ms at 3.35 TB/s: bound by operations. This kernel
// runs them as f32 FMAs on the CUDA cores (67 TFLOP/s: 340 ms at best),
// plus one sorted insert per (query, key) pair.
//
// Design: edgeconv_select.cuh's select_wide_c with the three-term split:
// one block of 256 threads per (batch element, 16 query rows), the query
// tiles of one cloud adjacent in the grid; the queries' three chunks staged
// in shared memory (3 x D x 16 floats); keys staged in 128-key tiles; each
// thread computes 8 queries x 1 key with six accumulators each; each
// query's 16 lanes keep their best k-1 keys in registers and merge them
// with half-warp shuffles. Left on the table: tensor-core products, a
// double-buffered key tile, an early reject before the insert.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_KNN_N = 1 << 24;
constexpr int SPLITS = 3;

// (distance, column) ranked by the exact f32 value, then the column.
struct RankExact {
    using T = unsigned long long;
    static constexpr T MAX = ~0ULL;
    __device__ static __forceinline__ T pack(float dist, int col) {
        unsigned bits = __float_as_uint(dist);
        if (bits == 0x80000000u) bits = 0u;                       // -0 ranks as +0
        // negative: flip every bit; non-negative: set the sign bit
        bits ^= (bits & 0x80000000u) ? 0xffffffffu : 0x80000000u;
        return (static_cast<T>(bits) << 32) | static_cast<unsigned>(col);
    }
    __device__ static __forceinline__ int column(T v) {
        return static_cast<int>(v & 0xffffffffULL);
    }
};

struct Params {
    const float* x;               // (B, N, D) f32
    int* idx;                     // (B, N, K) i32
    int N, D;
};

template <int K>
__device__ void select_wide_exact(int N, int D, const float* xb, int n0,
                                  float* work, int* sidx) {
    using R = RankExact;
    using T = R::T;
    const int t = threadIdx.x;
    float* keys = work;                                     // [D][KT_STRIDE]
    float* q_split = keys + ((D * KT_STRIDE + 3) & ~3);     // [3][D][TM]
    float* q_norm = q_split + SPLITS * D * TM;              // [TM]
    T* dist = reinterpret_cast<T*>(q_norm + TM);            // [TM][KT], 16-byte aligned

    for (int e = t; e < TM * D; e += THREADS) {
        const int qq = e / D, c = e - qq * D;
        float r = xb[static_cast<size_t>(min(n0 + qq, N - 1)) * D + c];
#pragma unroll
        for (int s = 0; s < SPLITS; ++s) {
            const float chunk = trunc_bf16(r);
            q_split[(s * D + c) * TM + qq] = chunk;
            r = r - chunk;              // exact: chunk is r truncated (Sterbenz)
        }
    }
    if (t < TM) {
        const float* row = xb + static_cast<size_t>(min(n0 + t, N - 1)) * D;
        float s = 0.f;
        for (int c = 0; c < D; ++c) s = fmaf(row[c], row[c], s);
        q_norm[t] = s;
    }

    const int q = t / LANES_PER_QUERY, lane = t % LANES_PER_QUERY;
    T best[K - 1];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) best[i] = R::MAX;

    // distance phase: thread owns key j of the tile and 8 queries
    const int j = t % KT, qh = t / KT;
    for (int jt = 0; jt < N; jt += KT) {
        __syncthreads();                  // the previous tile is consumed
        for (int e = t; e < KT * D; e += THREADS) {
            const int jj = e / D, c = e - jj * D;
            const int gj = jt + jj;
            keys[c * KT_STRIDE + jj] = gj < N ? xb[static_cast<size_t>(gj) * D + c] : 0.f;
        }
        __syncthreads();

        // p00, p01, p10, p11, p02, p20 for each of the 8 queries
        float acc[6][8];
#pragma unroll
        for (int m = 0; m < 6; ++m)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[m][i] = 0.f;
        float k_norm = 0.f;
        for (int c = 0; c < D; ++c) {
            const float kv = keys[c * KT_STRIDE + j];
            const float k0 = trunc_bf16(kv);
            const float r1 = kv - k0;
            const float k1 = trunc_bf16(r1);
            const float k2 = trunc_bf16(r1 - k1);
            k_norm = fmaf(kv, kv, k_norm);
            float qv[SPLITS][8];
#pragma unroll
            for (int s = 0; s < SPLITS; ++s) {
                const float4* q4 = reinterpret_cast<const float4*>(
                    q_split + (s * D + c) * TM + qh * 8);
                const float4 a = q4[0], b = q4[1];
                qv[s][0] = a.x; qv[s][1] = a.y; qv[s][2] = a.z; qv[s][3] = a.w;
                qv[s][4] = b.x; qv[s][5] = b.y; qv[s][6] = b.z; qv[s][7] = b.w;
            }
            // every product is of two bf16-exact values: exact in f32
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                acc[0][i] = fmaf(qv[0][i], k0, acc[0][i]);
                acc[1][i] = fmaf(qv[0][i], k1, acc[1][i]);
                acc[2][i] = fmaf(qv[1][i], k0, acc[2][i]);
                acc[3][i] = fmaf(qv[1][i], k1, acc[3][i]);
                acc[4][i] = fmaf(qv[0][i], k2, acc[4][i]);
                acc[5][i] = fmaf(qv[2][i], k0, acc[5][i]);
            }
        }
        const int gj = jt + j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int qi = qh * 8 + i;
            const float cross = ((((acc[0][i] + acc[1][i]) + acc[2][i]) + acc[3][i])
                                 + acc[4][i]) + acc[5][i];
            // 2 * cross is exact, so a contraction into one FMA rounds alike
            const float dd = (q_norm[qi] + k_norm) - 2.f * cross;
            dist[qi * KT + j] = (gj >= N || gj == n0 + qi) ? R::MAX : R::pack(dd, gj);
        }
        __syncthreads();

        // selection phase: the two queries of a warp read opposite halves
        // of the bank space
#pragma unroll
        for (int m = 0; m < KT / LANES_PER_QUERY; ++m) {
            const int col = lane + LANES_PER_QUERY * ((m + (q & 1)) % (KT / LANES_PER_QUERY));
            insert(best, dist[q * KT + col]);
        }
    }
    const int nq = min(n0 + q, N - 1);
    if (lane == 0) sidx[q * K] = nq;
    merge_lists<K, R>(best, sidx, q, lane, nq);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_wide_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [TM][K]
    float* work = reinterpret_cast<float*>(smem + HEADER_BYTES);
    const int b = blockIdx.y, n0 = blockIdx.x * TM, t = threadIdx.x;
    const int N = p.N;
    const float* xb = p.x + static_cast<size_t>(b) * N * p.D;

    if constexpr (K == 1) {
        if (t < TM) sidx[t] = min(n0 + t, N - 1);
    } else {
        select_wide_exact<K>(N, p.D, xb, n0, work, sidx);
    }
    __syncthreads();
    if (t < TM * K) {
        const int n = n0 + t / K;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * K + t % K] = sidx[t];
    }
}

template <int K>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
    auto kernel = knn_wide_kernel<K>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + TM - 1) / TM, B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Launches the wide-D kNN on `stream`: x (B, N, D) f32, 16 < D <= 256 ->
// idx (B, N, k) i32. Returns the CUDA error code (0 = ok); an argument the
// kernel does not take returns cudaErrorInvalidValue.
extern "C" int knn_wide_forward(const void* x, void* idx, int B, int N, int D, int k,
                                void* stream) {
    if (B < 1 || B > 65535 || N < 1 || N > MAX_KNN_N || D <= SMALL_C_MAX
            || D > WIDE_C_MAX || k < 1 || k > MAX_K || k > N)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.idx = static_cast<int*>(idx);
    p.N = N; p.D = D;
    const size_t smem = HEADER_BYTES + align16(static_cast<size_t>(D) * KT_STRIDE * 4)
                        + static_cast<size_t>(SPLITS) * D * TM * 4 + TM * 4
                        + TM * KT * sizeof(RankExact::T);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
        case 1: return static_cast<int>(launch<1>(p, B, smem, s));
        case 2: return static_cast<int>(launch<2>(p, B, smem, s));
        case 3: return static_cast<int>(launch<3>(p, B, smem, s));
        case 4: return static_cast<int>(launch<4>(p, B, smem, s));
        case 5: return static_cast<int>(launch<5>(p, B, smem, s));
        case 6: return static_cast<int>(launch<6>(p, B, smem, s));
        case 7: return static_cast<int>(launch<7>(p, B, smem, s));
        case 8: return static_cast<int>(launch<8>(p, B, smem, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
