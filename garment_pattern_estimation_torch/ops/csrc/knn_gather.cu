// kNN + neighbour gather for Hopper (sm_90a), forward and backward: the
// training path's EdgeConv input, (B, N, C) -> neighbour rows slot-major
// (B, k, N, C) plus ids (B, N, k), and the scatter-add of the neighbour
// cotangents back into dx (B, N, C).
//
// Replaces the TPU kernels garment_pattern_estimation_tpu/ops/knn_gather.py:
//   knn_gather_fwd_kernel  <- _fwd_kernel, both variants (SMALL_C: C <= 16,
//                             exact f32 distances and rows; wide: 16 < C <= 256,
//                             split-product distances, rows hi + lo or hi);
//   knn_gather_bwd_kernel  <- _bwd_kernel.
// The plain PyTorch versions with the same numerics are ops/knn_gather.py:
// knn_gather_reference and knn_gather_backward_reference.
//
// Forward. One block of 256 threads per (batch element, query rows: 128
// for small C, 16 for wide C).
// The selection is edgeconv_select.cuh, the same code as the fused EdgeConv
// kernel, so its ids are the fused kernel's. Then the k slot rows are
// written with threads along C: for one slot the block's output rows are
// contiguous, so the stores are coalesced. Slot 0 is the query's own f32
// row; slots 1..k-1 are exact rows (small C) or hi + lo (hi when n_chunks
// is 1) of the truncation split (wide C).
//
// Backward. Deterministic, no float atomics: one block of 256 threads per
// (batch element, 32 target rows). Phase 1 scans the batch element's
// N (k-1) ids in a fixed order and compacts those that point into the
// block's targets into shared memory, in scan order (warp ballots and a
// prefix over the 8 warps). Phase 2 gives each target to one warp, lanes
// along C: the target's own slot-0 cotangent first, then its contributions
// in scan order. The same inputs give bitwise-equal dx on every run. Slot 0
// is added at full f32. With n_chunks = 2 the slots >= 1 are too: the TPU
// kernel's two bf16 chunks exist because TPU f32 dots round their inputs,
// and hi + lo is the f32 value. With n_chunks = 1 (the bf16 compute mode)
// each slot >= 1 cotangent is truncated to its top bf16 chunk as it is
// read, as the TPU kernel scatters only that chunk; the sum stays f32.
//
// What bounds them on an H100 SXM, at the attention model's training step
// (B=30, N=2000, k=5). Forward, wide C (C=150): 1.08e11 FLOP of
// split-product distances (3 x 2 x B N^2 C, bf16-exact operands) against
// 216 MB of compulsory traffic (x read once, 180 MB of slot rows and the ids
// written once): 0.11 ms at 989 TFLOP/s against 0.065 ms at 3.35 TB/s,
// bound by operations. Forward, small C (C=3): 1.1e9 f32 FLOP of distances,
// 0.016 ms at 67 TFLOP/s, bound by operations. Backward, C=150: 180 MB of
// cotangents read and 36 MB of dx written, 0.065 ms, bound by bytes.
// The wide-C selection is select_wide_c (split products on bf16 tensor
// cores after split_rows_kernel, launched first into the caller's scratch),
// with 16 query rows per block. Left on the table: each unordered pair's
// distance is computed in both directions, and the backward re-reads the
// ids once per block (from L2) instead of building the transposed graph
// once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int BWD_TARGETS = 32;                 // target rows per backward block
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_C_PER_LANE = WIDE_C_MAX / 32;
constexpr int ENTRY_BITS = 16;                  // compacted entry: target << 16 | entry id

struct FwdParams {
    const float* x;               // (B, N, C) f32
    float* nbr;                   // (B, K, N, C) f32
    int* idx;                     // (B, N, K) i32
    int B, N, C, n_chunks;
    int window;                   // small C: the key window (columns)
    const void* split;            // wide C: split_rows_kernel's output for the B N points
    size_t P;                     // B N
};

struct BwdParams {
    const int* idx;               // (B, N, K) i32
    const float* g;               // (B, K, N, C) f32
    float* dx;                    // (B, N, C) f32
    int B, N, C, K;
};

// Query rows per forward block: select_small_c's for small C, TM for wide C.
template <bool SMALL_C> __host__ __device__ constexpr int fwd_rows() { return SMALL_C ? SMALL_QB : TM; }

template <int K, bool SMALL_C, int CD>
__global__ void __launch_bounds__(THREADS)
knn_gather_fwd_kernel(const FwdParams p) {
    constexpr int QB = fwd_rows<SMALL_C>();
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [QB][K]
    unsigned char* work = smem + QB * MAX_K * 4;
    const int b = blockIdx.y, n0 = blockIdx.x * QB, t = threadIdx.x;
    const int N = p.N, C = p.C;
    const float* xb = p.x + static_cast<size_t>(b) * N * C;

    if constexpr (K == 1) {
        if (t < QB) sidx[t] = min(n0 + t, N - 1);
    } else if constexpr (SMALL_C) {
        select_small_c<K, false, CD>(N, C, xb, n0, work, sidx, p.window);
    } else {
        select_wide_c<K, false, TM>(N, cloud_rows(p.split, p.P, C, 2, b, N), n0, work, sidx);
    }
    __syncthreads();

    for (int e = t; e < QB * K; e += THREADS) {
        const int n = n0 + e / K;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * K + e % K] = sidx[e];
    }

    const int rows = min(QB, N - n0);
#pragma unroll
    for (int s = 0; s < K; ++s) {
        float* out = p.nbr + ((static_cast<size_t>(b) * K + s) * N + n0) * C;
        for (int e = t; e < rows * C; e += THREADS) {
            const int qq = e / C, c = e - qq * C;
            const float v = xb[sidx[qq * K + s] * C + c];
            float o = v;                  // slot 0 and small C: the exact row
            if (!SMALL_C && s > 0) {
                const float hi = trunc_bf16(v);
                o = p.n_chunks == 2 ? hi + trunc_bf16(v - hi) : hi;
            }
            out[e] = o;
        }
    }
}

template <int CHUNKS>
__global__ void __launch_bounds__(BWD_THREADS)
knn_gather_bwd_kernel(const BwdParams p) {
    extern __shared__ int entries[];              // [N (K-1)]: compacted, scan order
    __shared__ int warp_hits[BWD_WARPS];
    __shared__ int n_found;
    const int b = blockIdx.y, t0 = blockIdx.x * BWD_TARGETS, t = threadIdx.x;
    const int lane = t % 32, warp = t / 32;
    const int N = p.N, C = p.C, K = p.K;
    const int* idxb = p.idx + static_cast<size_t>(b) * N * K;
    const int n_entries = N * (K - 1);            // entry e: query e / (K-1), slot 1 + e % (K-1)

    // ---- phase 1: the entries whose id falls in [t0, t0 + 32), in scan order ----
    if (t == 0) n_found = 0;
    __syncthreads();
    for (int e0 = 0; e0 < n_entries; e0 += BWD_THREADS) {
        const int e = e0 + t;
        int local = -1;
        if (e < n_entries) {
            const int n = e / (K - 1), s = 1 + e % (K - 1);
            local = idxb[n * K + s] - t0;
        }
        const bool hit = local >= 0 && local < BWD_TARGETS;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) warp_hits[warp] = __popc(mask);
        __syncthreads();
        int base = n_found;
        for (int w = 0; w < warp; ++w) base += warp_hits[w];
        if (hit) entries[base + __popc(mask & ((1u << lane) - 1u))] = (local << ENTRY_BITS) | e;
        __syncthreads();
        if (t == 0) {
            int total = n_found;
            for (int w = 0; w < BWD_WARPS; ++w) total += warp_hits[w];
            n_found = total;
        }
        __syncthreads();
    }
    const int found = n_found;

    // ---- phase 2: one warp per target, lanes along C ----
    for (int local = warp; local < BWD_TARGETS; local += BWD_WARPS) {
        const int target = t0 + local;
        if (target >= N) break;
        float acc[BWD_C_PER_LANE];
        const float* g0 = p.g + (static_cast<size_t>(b) * K * N + target) * C;   // slot 0
#pragma unroll
        for (int i = 0; i < BWD_C_PER_LANE; ++i) {
            const int c = lane + 32 * i;
            acc[i] = c < C ? g0[c] : 0.f;
        }
        for (int m0 = 0; m0 < found; m0 += 32) {
            const int m = m0 + lane;
            const int v = m < found ? entries[m] : -1;
            unsigned hits = __ballot_sync(0xffffffffu, m < found && (v >> ENTRY_BITS) == local);
            while (hits) {
                const int src = __ffs(hits) - 1;
                hits &= hits - 1u;
                const int e = __shfl_sync(0xffffffffu, v, src) & ((1 << ENTRY_BITS) - 1);
                const int n = e / (K - 1), s = 1 + e % (K - 1);
                const float* gr = p.g + ((static_cast<size_t>(b) * K + s) * N + n) * C;
#pragma unroll
                for (int i = 0; i < BWD_C_PER_LANE; ++i) {
                    const int c = lane + 32 * i;
                    if (c < C) acc[i] += CHUNKS == 1 ? trunc_bf16(gr[c]) : gr[c];
                }
            }
        }
        float* out = p.dx + (static_cast<size_t>(b) * N + target) * C;
#pragma unroll
        for (int i = 0; i < BWD_C_PER_LANE; ++i) {
            const int c = lane + 32 * i;
            if (c < C) out[c] = acc[i];
        }
    }
}

template <int K, bool SMALL_C, int CD>
cudaError_t launch_fwd(const FwdParams& p, size_t smem, cudaStream_t stream) {
    auto kernel = knn_gather_fwd_kernel<K, SMALL_C, CD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = fwd_rows<SMALL_C>();
    const dim3 grid((p.N + QB - 1) / QB, p.B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool SMALL_C, int CD>
cudaError_t launch_fwd_k(int k, const FwdParams& p, size_t smem, cudaStream_t stream) {
    switch (k) {
        case 1: return launch_fwd<1, SMALL_C, CD>(p, smem, stream);
        case 2: return launch_fwd<2, SMALL_C, CD>(p, smem, stream);
        case 3: return launch_fwd<3, SMALL_C, CD>(p, smem, stream);
        case 4: return launch_fwd<4, SMALL_C, CD>(p, smem, stream);
        case 5: return launch_fwd<5, SMALL_C, CD>(p, smem, stream);
        case 6: return launch_fwd<6, SMALL_C, CD>(p, smem, stream);
        case 7: return launch_fwd<7, SMALL_C, CD>(p, smem, stream);
        case 8: return launch_fwd<8, SMALL_C, CD>(p, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

bool valid_shape(int B, int N, int C, int k) {
    return B >= 1 && N >= 1 && N <= MAX_N && C >= 1 && C <= WIDE_C_MAX
           && k >= 1 && k <= MAX_K && k <= N;
}

}  // namespace

// Bytes of the scratch knn_gather_forward needs for (B, N, C): the split
// rows of the wide-C selection, none for small C.
extern "C" size_t knn_gather_scratch_bytes(int B, int N, int C) {
    return C <= SMALL_C_MAX ? 0 : split_bytes(static_cast<size_t>(B) * N, C, 2);
}

// Launches the knn_gather forward on `stream`: x (B, N, C) f32 ->
// nbr (B, k, N, C) f32 and idx (B, N, k) i32; `scratch` holds
// knn_gather_scratch_bytes(B, N, C) bytes. Returns the CUDA error code
// (0 = ok); an argument the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int knn_gather_forward(const void* x, void* nbr, void* idx,
                                  void* scratch, size_t scratch_bytes,
                                  int B, int N, int C, int k, int n_chunks,
                                  void* stream) {
    if (!valid_shape(B, N, C, k) || (n_chunks != 1 && n_chunks != 2)
            || scratch_bytes < knn_gather_scratch_bytes(B, N, C))
        return static_cast<int>(cudaErrorInvalidValue);
    FwdParams p{};
    p.x = static_cast<const float*>(x);
    p.nbr = static_cast<float*>(nbr);
    p.idx = static_cast<int*>(idx);
    p.B = B; p.N = N; p.C = C; p.n_chunks = n_chunks;
    p.split = scratch;
    p.P = static_cast<size_t>(B) * N;
    const bool small_c = C <= SMALL_C_MAX;
    p.window = small_c ? small_c_window(N, C, 0) : 0;
    const size_t smem = (small_c ? SMALL_QB : TM) * MAX_K * 4 + select_bytes(C, false, p.window);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!small_c && k > 1) {
        const cudaError_t err = launch_split<2>(p.x, p.P, C, scratch, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const cudaError_t err =
        !small_c ? launch_fwd_k<false, 0>(k, p, smem, s)
                 : (small_c_dims(C) == 3 ? launch_fwd_k<true, 3>(k, p, smem, s)
                                         : launch_fwd_k<true, SMALL_C_MAX>(k, p, smem, s));
    return static_cast<int>(err);
}

// Launches the knn_gather backward on `stream`: idx (B, N, k) i32 and
// g (B, k, N, C) f32 -> dx (B, N, C) f32, every element written; slots
// >= 1 at full f32 (n_chunks = 2) or truncated to bf16 (n_chunks = 1).
// Returns the CUDA error code (0 = ok).
extern "C" int knn_gather_backward(const void* idx, const void* g, void* dx,
                                   int B, int N, int C, int k, int n_chunks,
                                   void* stream) {
    if (!valid_shape(B, N, C, k) || (n_chunks != 1 && n_chunks != 2))
        return static_cast<int>(cudaErrorInvalidValue);
    BwdParams p{};
    p.idx = static_cast<const int*>(idx);
    p.g = static_cast<const float*>(g);
    p.dx = static_cast<float*>(dx);
    p.B = B; p.N = N; p.C = C; p.K = k;
    const size_t smem = static_cast<size_t>(N) * (k - 1) * 4;
    auto kernel = n_chunks == 1 ? knn_gather_bwd_kernel<1> : knn_gather_bwd_kernel<2>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + BWD_TARGETS - 1) / BWD_TARGETS, B);
    kernel<<<grid, BWD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
