// kNN + neighbour gather for Hopper (sm_90a), forward and backward: the
// training path's EdgeConv input, (B, N, C) -> neighbour rows slot-major
// (B, k, N, C) plus ids (B, N, k), and the scatter-add of the neighbour
// cotangents back into dx (B, N, C).
//
// Replaces the TPU kernels garment_pattern_estimation_tpu/ops/knn_gather.py:
//   knn_gather_fwd_kernel  <- _fwd_kernel, both variants (SMALL_C: C <= 16,
//                             exact f32 distances and rows; wide: 16 < C <= 256,
//                             split-product distances, rows hi + lo or hi);
//   knn_gather_csr_kernel + knn_gather_sum_kernel  <- _bwd_kernel.
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
// Backward. Deterministic, no float atomics, in two kernels. The TPU
// kernel carries a scatter-add through its sequential grid; on Hopper each
// target row instead gathers its own contributions, from the transposed
// neighbour graph built once per batch element:
//   knn_gather_csr_kernel  one block of 1024 threads per batch element, all
//     in shared memory: the targets of the N (k-1) entries (entry e = query
//     n, slot s >= 1 with e = n (k-1) + s - 1), each warp's counts per target
//     over its contiguous slice of entries, an exclusive prefix over the
//     warps and then over the targets (the CSR offsets), and a stable fill of
//     each target's list in ascending e (ranks within a warp step from
//     twelve ballots). Counts and order are fixed, so no atomics are
//     needed; a hub that every query names keeps all N (k-1) entries.
//   knn_gather_sum_kernel  one warp per SUM_TARGETS consecutive targets,
//     lanes along C with vector loads where C and the pointers allow
//     (float4, float2, else float). The warp walks its targets' rows as one
//     stream (each target's slot-0 row, then its list), one load of the
//     offsets for all of them and one load of the list per 32 rows, and
//     loads SUM_ROWS rows before it adds them, so several rows are in
//     flight per warp and few loads wait on others. The adds run slot 0
//     first, then ascending e, the order of the kernel this one replaced,
//     so the same inputs give bitwise-equal dx on every run.
// k = 9..16 run the selection's K = 16 instance (edgeconv_select.cuh),
// which writes its first k slots; k = 17..128 the capacity instances K =
// 32, 64, 128 (warp lists, edgeconv_select.cuh). The CSR build keeps the
// lists in shared memory while they fit (N (k-1) <= 14,336 entries at N =
// 2048, k = 8); past that (N = 2000, k = 10: 244 KB) it fills them in
// place in the caller's scratch, in the same order. Above k = 16 neither
// the 16-bit targets (N (k-1) of them, 520 KB at N = 2048, k = 128) nor
// the 16-bit counts (a hub's list reaches N (k-1) > 65535) fit, so
// knn_gather_csr_large_kernel builds the same CSR from int counts:
// shared-memory atomic counts per target (their sums do not depend on the
// order), a scan, and a fill by one warp walking the entries in ascending
// order (ranks within a step from __match_any_sync), targets staged from
// the ids by the whole block.
// Slot 0 is added at full f32. With n_chunks = 2 the slots >= 1 are too:
// the TPU kernel's two bf16 chunks exist because TPU f32 dots round their
// inputs, and hi + lo is the f32 value. With n_chunks = 1 (the bf16 compute
// mode) each slot >= 1 cotangent is truncated to its top bf16 chunk as it is
// read, as the TPU kernel scatters only that chunk; the sum stays f32. The
// CSR (offsets (B, N + 1) and entries (B, N (k-1)), int32) lives in the
// caller's scratch, knn_gather_bwd_scratch_bytes(B, N, k).
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
// distance is computed in both directions; the backward's CSR kernel runs
// B blocks only, and the sum waits for it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int CSR_THREADS = 1024;               // CSR build: one block per batch element
constexpr int CSR_WARPS = CSR_THREADS / 32;
constexpr int CSR_LOADS = 8;                    // ids each thread loads before it stores them
constexpr int SUM_THREADS = 256;                // sum: one warp per SUM_TARGETS target rows
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int SUM_TARGETS = 8;                  // consecutive targets per warp
constexpr int SUM_ROWS = 8;                     // rows a warp loads before adding them
constexpr int SUM_MIN_BLOCKS = 2;               // resident blocks per SM the registers allow
constexpr int LANE_FLOATS = WIDE_C_MAX / 32;    // floats of one row per lane (C <= 256)
constexpr unsigned short NO_TARGET = 0xffff;    // an id outside [0, N): contributes nothing

struct FwdParams {
    const float* x;               // (B, N, C) f32
    float* nbr;                   // (B, k, N, C) f32
    int* idx;                     // (B, N, k) i32
    int B, N, C, k, n_chunks;
    int window;                   // small C: the key window (columns)
    const void* split;            // wide C: split_rows_kernel's output for the B N points
    size_t P;                     // B N
};

struct BwdParams {
    const int* idx;               // (B, N, K) i32
    const float* g;               // (B, K, N, C) f32
    float* dx;                    // (B, N, C) f32
    int* offsets;                 // (B, N + 1) i32: each target's list in `entries`
    int* entries;                 // (B, N (K-1)) i32: entry ids, ascending within a target
    int B, N, C, K;
    bool lists_in_smem;           // the CSR build fills its lists in shared memory
};

// Query rows per forward block: select_small_c's for small C, TM for wide C
// (select_rows: the large-k selections' above MAX_K).
template <bool SMALL_C, int K> __host__ __device__ constexpr int fwd_rows() {
    return select_rows(SMALL_C, false, K);
}

template <int K, bool SMALL_C, int CD>
__global__ void __launch_bounds__(THREADS)
knn_gather_fwd_kernel(const FwdParams p) {
    constexpr int QB = fwd_rows<SMALL_C, K>();
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [QB][K]
    unsigned char* work = smem + header_bytes(QB, K);
    const int b = blockIdx.y, n0 = blockIdx.x * QB, t = threadIdx.x;
    const int N = p.N, C = p.C;
    const float* xb = p.x + static_cast<size_t>(b) * N * C;

    if constexpr (K == 1) {
        if (t < QB) sidx[t] = min(n0 + t, N - 1);
    } else if constexpr (SMALL_C && K > MAX_K) {
        select_small_c_large<K, CD>(N, C, xb, n0, work, sidx, p.k);
    } else if constexpr (SMALL_C) {
        select_small_c<K, false, CD>(N, C, xb, n0, work, sidx, p.window, p.k);
    } else {
        select_wide_c<K, false, QB>(N, cloud_rows(p.split, p.P, C, 2, b, N), n0, work, sidx,
                                    p.k);
    }
    __syncthreads();

    const int k = filled_slots<K>(p.k);
    for (int e = t; e < QB * k; e += THREADS) {
        const int q = e / k, s = e - q * k, n = n0 + q;
        if (n < N) p.idx[(static_cast<size_t>(b) * N + n) * k + s] = sidx[q * K + s];
    }

    const int rows = min(QB, N - n0);
    if constexpr (K > MAX_K) {        // the k slots, not unrolled
        for (int s = 0; s < k; ++s) {
            float* out = p.nbr + ((static_cast<size_t>(b) * k + s) * N + n0) * C;
            for (int e = t; e < rows * C; e += THREADS) {
                const int qq = e / C, c = e - qq * C;
                const float v = xb[sidx[qq * K + s] * C + c];
                float o = v;
                if (!SMALL_C && s > 0) {
                    const float hi = trunc_bf16(v);
                    o = p.n_chunks == 2 ? hi + trunc_bf16(v - hi) : hi;
                }
                out[e] = o;
            }
        }
        return;
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
        if (K > EXACT_K && s >= k) break;
        float* out = p.nbr + ((static_cast<size_t>(b) * k + s) * N + n0) * C;
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

// Shared bytes of the CSR build: the offsets (N + 1 ints, padded to 16
// bytes), each warp's 16-bit count per target, each entry's 16-bit target
// (padded to 4 bytes) and, `with_lists`, the filled lists (N (k-1) ints):
// 225,296 bytes at N = 2048, k = 8, within the 232,448 a block may take;
// without the lists 200,720 at N = 2048, k = 16.
constexpr size_t MAX_BLOCK_SMEM = 232448;
__host__ __device__ inline size_t csr_smem_bytes(int N, int K, bool with_lists) {
    const size_t E = static_cast<size_t>(N) * (K - 1);
    return static_cast<size_t>((N + 4) / 4 * 4) * 4 + static_cast<size_t>(CSR_WARPS) * N * 2
           + (E + 1) / 2 * 4 + (with_lists ? E * 4 : 0);
}

// The lanes of this warp whose target equals this lane's (NO_TARGET counts
// as 2048): twelve ballots, one per bit of the target.
__device__ __forceinline__ unsigned same_target(int target) {
    const int key = min(target, MAX_N);
    unsigned mask = 0xffffffffu;
#pragma unroll
    for (int bit = 0; bit < 12; ++bit) {
        const unsigned ones = __ballot_sync(0xffffffffu, (key >> bit) & 1);
        mask &= (key >> bit) & 1 ? ones : ~ones;
    }
    return mask;
}

__global__ void __launch_bounds__(CSR_THREADS)
knn_gather_csr_kernel(const BwdParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = p.N, K = p.K, E = N * (K - 1);
    int* off = reinterpret_cast<int*>(smem);                                  // [N + 1]
    unsigned short* cnt = reinterpret_cast<unsigned short*>(smem + (N + 4) / 4 * 16);  // [warps][N]
    unsigned short* tgt = cnt + CSR_WARPS * N;                                // [E]
    __shared__ int warp_sum[CSR_WARPS];
    const int b = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int* idxb = p.idx + static_cast<size_t>(b) * N * K;
    int* entries = p.entries + static_cast<size_t>(b) * E;
    // the filled lists: in shared memory, copied out at the end, or in place
    int* lists = p.lists_in_smem ? reinterpret_cast<int*>(tgt + (E + 1) / 2 * 2)  // [E]
                                 : entries;

    // ---- the target of every entry; counts to zero ----
    for (int i0 = 0; i0 < N * K; i0 += CSR_LOADS * CSR_THREADS) {
        int id[CSR_LOADS];
#pragma unroll
        for (int j = 0; j < CSR_LOADS; ++j) {
            const int i = i0 + j * CSR_THREADS + t;
            id[j] = i < N * K ? idxb[i] : 0;
        }
#pragma unroll
        for (int j = 0; j < CSR_LOADS; ++j) {
            const int i = i0 + j * CSR_THREADS + t;
            const int n = i / K, s = i - n * K;
            if (i < N * K && s > 0)
                tgt[n * (K - 1) + s - 1] = id[j] >= 0 && id[j] < N
                    ? static_cast<unsigned short>(id[j]) : NO_TARGET;
        }
    }
    for (int i = t; i < CSR_WARPS * N / 2; i += CSR_THREADS)
        reinterpret_cast<unsigned*>(cnt)[i] = 0u;
    __syncthreads();

    // ---- each warp counts its contiguous slice of entries, per target ----
    const int seg = (E + CSR_WARPS - 1) / CSR_WARPS;
    const int lo = min(E, warp * seg), hi = min(E, lo + seg);
    unsigned short* wcnt = cnt + warp * N;
    for (int e0 = lo; e0 < hi; e0 += 32) {
        const int e = e0 + lane;
        const int target = e < hi ? tgt[e] : NO_TARGET;
        const unsigned same = same_target(target);
        if (target != NO_TARGET && lane == __ffs(same) - 1)
            wcnt[target] += static_cast<unsigned short>(__popc(same));
        __syncwarp();
    }
    __syncthreads();

    // ---- per target: exclusive prefix over the warps, total into off ----
    for (int v = t; v < N; v += CSR_THREADS) {
        int run = 0;
        for (int w = 0; w < CSR_WARPS; ++w) {
            const int c = cnt[w * N + v];
            cnt[w * N + v] = static_cast<unsigned short>(run);
            run += c;
        }
        off[v] = run;
    }
    __syncthreads();

    // ---- exclusive scan of the totals: each thread owns `per` (<= 2) ----
    const int per = (N + CSR_THREADS - 1) / CSR_THREADS;
    int own[2] = {0, 0}, sum = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int i = t * per + j;
        own[j] = j < per && i < N ? off[i] : 0;
        sum += own[j];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = warp_sum[lane];
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int y = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += y;
        }
        warp_sum[lane] = w;
    }
    __syncthreads();
    int base = incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int i = t * per + j;
        if (j < per && i < N) off[i] = base;
        base += own[j];
    }
    if (t == 0) off[N] = warp_sum[CSR_WARPS - 1];
    __syncthreads();
    int* offsets = p.offsets + static_cast<size_t>(b) * (N + 1);
    for (int i = t; i <= N; i += CSR_THREADS) offsets[i] = off[i];

    // ---- stable fill: the warps' slices in order, each slice in order;
    // then, from shared memory, one coalesced copy out ----
    for (int e0 = lo; e0 < hi; e0 += 32) {
        const int e = e0 + lane;
        const int target = e < hi ? tgt[e] : NO_TARGET;
        const unsigned same = same_target(target);
        if (target != NO_TARGET)
            lists[off[target] + wcnt[target] + __popc(same & ((1u << lane) - 1u))] = e;
        __syncwarp();
        if (target != NO_TARGET && lane == __ffs(same) - 1)
            wcnt[target] += static_cast<unsigned short>(__popc(same));
        __syncwarp();
    }
    if (!p.lists_in_smem) return;
    __syncthreads();
    for (int i = t; i < off[N]; i += CSR_THREADS) entries[i] = lists[i];
}

// The CSR of knn_gather_csr_kernel for k > MAX_K: one block of CSR_THREADS
// per batch element; shared memory holds the offsets (N + 1 ints), the
// targets' counts and then fill cursors (N), and a stage of CSR_STAGE
// targets. Entry e = n (k-1) + s - 1 of every (query n, slot s >= 1); an
// id outside [0, N) has no target.
constexpr int CSR_STAGE = 4096;

__host__ __device__ inline size_t csr_large_smem_bytes(int N) {
    return (static_cast<size_t>(2) * N + 1 + CSR_STAGE) * 4;
}

__global__ void __launch_bounds__(CSR_THREADS)
knn_gather_csr_large_kernel(const BwdParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = p.N, K = p.K, E = N * (K - 1);
    int* off = reinterpret_cast<int*>(smem);          // [N + 1]
    int* cur = off + N + 1;                            // [N]: counts, then cursors
    int* stage = cur + N;                              // [CSR_STAGE]
    const int b = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int* idxb = p.idx + static_cast<size_t>(b) * N * K;
    int* entries = p.entries + static_cast<size_t>(b) * E;
    auto target = [&](int e) {
        const int n = e / (K - 1), s = e - n * (K - 1) + 1;
        const int id = idxb[n * K + s];
        return id >= 0 && id < N ? id : -1;
    };

    for (int v = t; v < N; v += CSR_THREADS) cur[v] = 0;
    __syncthreads();
    for (int e = t; e < E; e += CSR_THREADS) {
        const int id = target(e);
        if (id >= 0) atomicAdd(cur + id, 1);
    }
    __syncthreads();
    if (warp == 0) {                  // exclusive scan of the counts
        int run = 0;
        for (int v0 = 0; v0 < N; v0 += 32) {
            const int v = v0 + lane;
            const int c = v < N ? cur[v] : 0;
            int incl = c;
#pragma unroll
            for (int d = 1; d < 32; d *= 2) {
                const int y = __shfl_up_sync(0xffffffffu, incl, d);
                if (lane >= d) incl += y;
            }
            if (v < N) off[v] = cur[v] = run + incl - c;
            run += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (lane == 0) off[N] = run;
    }
    __syncthreads();
    int* offsets = p.offsets + static_cast<size_t>(b) * (N + 1);
    for (int i = t; i <= N; i += CSR_THREADS) offsets[i] = off[i];

    // stable fill: warp 0 places the staged entries in ascending order
    for (int s0 = 0; s0 < E; s0 += CSR_STAGE) {
        const int sn = min(CSR_STAGE, E - s0);
        for (int i = t; i < sn; i += CSR_THREADS) stage[i] = target(s0 + i);
        __syncthreads();
        if (warp == 0) {
            for (int i0 = 0; i0 < sn; i0 += 32) {
                const int i = i0 + lane;
                const int tg = i < sn ? stage[i] : -1;
                const unsigned same = __match_any_sync(0xffffffffu, tg);
                if (tg >= 0) entries[cur[tg] + __popc(same & ((1u << lane) - 1u))] = s0 + i;
                __syncwarp();
                if (tg >= 0 && lane == __ffs(same) - 1) cur[tg] += __popc(same);
                __syncwarp();
            }
        }
        __syncthreads();
    }
}

template <int VEC> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

// Loads this lane's vectors of one row (vector j = lane + 32 i) into out.
template <int VEC>
__device__ __forceinline__ void load_row(const float* row, int cv, int lane,
                                         float (&out)[LANE_FLOATS]) {
    using V = typename VecOf<VEC>::T;
    const V* src = reinterpret_cast<const V*>(row);
#pragma unroll
    for (int i = 0; i < LANE_FLOATS / VEC; ++i) {
        const int j = lane + 32 * i;
        if (j < cv) {
            const V v = __ldg(src + j);
            const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
            for (int c = 0; c < VEC; ++c) out[i * VEC + c] = f[c];
        }
    }
}

// Stores this lane's vectors of a row (vector j = lane + 32 i) from acc.
template <int VEC>
__device__ __forceinline__ void store_row(float* row, int cv, int lane,
                                          const float (&acc)[LANE_FLOATS]) {
    using V = typename VecOf<VEC>::T;
    V* dst = reinterpret_cast<V*>(row);
#pragma unroll
    for (int i = 0; i < LANE_FLOATS / VEC; ++i) {
        const int j = lane + 32 * i;
        if (j < cv) {
            V v;
            float* f = reinterpret_cast<float*>(&v);
#pragma unroll
            for (int c = 0; c < VEC; ++c) f[c] = acc[i * VEC + c];
            dst[j] = v;
        }
    }
}

// One warp sums SUM_TARGETS consecutive targets as one stream of rows: for
// each target its slot-0 row, then its list's rows in ascending e. Lane i
// holds the stream position S_i where target i starts; each group of 32
// stream items gets its source rows from one load of the list, and the rows
// are loaded SUM_ROWS at a time before they are added.
template <int CHUNKS, int VEC>
__global__ void __launch_bounds__(SUM_THREADS, SUM_MIN_BLOCKS)
knn_gather_sum_kernel(const BwdParams p) {
    const int b = blockIdx.y, lane = threadIdx.x % 32;
    const int t0 = (blockIdx.x * SUM_WARPS + threadIdx.x / 32) * SUM_TARGETS;
    if (t0 >= p.N) return;
    const int N = p.N, C = p.C, K = p.K, cv = C / VEC;
    const int nt = min(SUM_TARGETS, N - t0);
    const int* list = p.entries + static_cast<size_t>(b) * N * (K - 1);
    const float* gb = p.g + static_cast<size_t>(b) * K * N * C;
    float* dxb = p.dx + (static_cast<size_t>(b) * N + t0) * C;

    const int my_off = lane <= nt ? p.offsets[static_cast<size_t>(b) * (N + 1) + t0 + lane] : 0;
    const int base = __shfl_sync(0xffffffffu, my_off, 0);
    const int start = my_off - base + lane;                 // S_lane, lane <= nt
    const int total = __shfl_sync(0xffffffffu, start, nt);  // items in the stream

    float acc[LANE_FLOATS] = {};
    int cur = 0;                                            // target acc belongs to
    for (int m0 = 0; m0 < total; m0 += 32) {
        // this lane's item m: its target ti, position within it, source row
        const int m = m0 + lane;
        int ti = -1;
        for (int j = 0; j < nt; ++j) ti += __shfl_sync(0xffffffffu, start, j) <= m;
        const int first = __shfl_sync(0xffffffffu, start, ti);    // S_ti
        const int pos = m - first;
        int src = (t0 + ti) * C;                             // slot 0
        if (m < total && pos > 0) {
            const int e = list[base + first - ti + pos - 1];
            const int n = e / (K - 1), s = 1 + e - n * (K - 1);
            src = (s * N + n) * C;
        }
        const int count = min(32, total - m0);
        for (int j0 = 0; j0 < count; j0 += SUM_ROWS) {
            float rows[SUM_ROWS][LANE_FLOATS];
            int row_target[SUM_ROWS], row_pos[SUM_ROWS];
#pragma unroll
            for (int r = 0; r < SUM_ROWS; ++r) {
                const int from = __shfl_sync(0xffffffffu, src, j0 + r);
                row_target[r] = __shfl_sync(0xffffffffu, ti, j0 + r);
                row_pos[r] = __shfl_sync(0xffffffffu, pos, j0 + r);
                if (j0 + r < count) load_row<VEC>(gb + from, cv, lane, rows[r]);
            }
#pragma unroll
            for (int r = 0; r < SUM_ROWS; ++r) {
                if (j0 + r >= count) break;
                if (row_pos[r] == 0) {                      // a new target: slot 0
                    if (m0 + j0 + r > 0) store_row<VEC>(dxb + cur * C, cv, lane, acc);
                    cur = row_target[r];
#pragma unroll
                    for (int i = 0; i < LANE_FLOATS; ++i) acc[i] = rows[r][i];
                } else {
#pragma unroll
                    for (int i = 0; i < LANE_FLOATS; ++i)
                        acc[i] += CHUNKS == 1 ? trunc_bf16(rows[r][i]) : rows[r][i];
                }
            }
        }
    }
    store_row<VEC>(dxb + cur * C, cv, lane, acc);
}

template <int CHUNKS, int VEC>
cudaError_t launch_sum(const BwdParams& p, cudaStream_t stream) {
    constexpr int per_block = SUM_WARPS * SUM_TARGETS;
    const dim3 grid((p.N + per_block - 1) / per_block, p.B);
    knn_gather_sum_kernel<CHUNKS, VEC><<<grid, SUM_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

template <int CHUNKS>
cudaError_t launch_sum_vec(int vec, const BwdParams& p, cudaStream_t stream) {
    switch (vec) {
        case 4: return launch_sum<CHUNKS, 4>(p, stream);
        case 2: return launch_sum<CHUNKS, 2>(p, stream);
        default: return launch_sum<CHUNKS, 1>(p, stream);
    }
}

template <int K, bool SMALL_C, int CD>
cudaError_t launch_fwd(const FwdParams& p, size_t smem, cudaStream_t stream) {
    auto kernel = knn_gather_fwd_kernel<K, SMALL_C, CD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = fwd_rows<SMALL_C, K>();
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
        case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
            return launch_fwd<MAX_K, SMALL_C, CD>(p, smem, stream);
        default: break;
    }
    switch (instance_k(k)) {
        case 32: return launch_fwd<32, SMALL_C, CD>(p, smem, stream);
        case 64: return launch_fwd<64, SMALL_C, CD>(p, smem, stream);
        case LARGE_K_MAX: return launch_fwd<LARGE_K_MAX, SMALL_C, CD>(p, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

bool valid_shape(int B, int N, int C, int k) {
    return B >= 1 && N >= 1 && N <= MAX_N && C >= 1 && C <= WIDE_C_MAX
           && k >= 1 && k <= LARGE_K_MAX && k <= N;
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
    p.B = B; p.N = N; p.C = C; p.k = k; p.n_chunks = n_chunks;
    p.split = scratch;
    p.P = static_cast<size_t>(B) * N;
    const bool small_c = C <= SMALL_C_MAX;
    p.window = small_c ? small_c_window(N, C, 0) : 0;
    const size_t smem = header_bytes(select_rows(small_c, false, instance_k(k)), instance_k(k))
                        + select_bytes(C, false, p.window, k);
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

// Bytes of the scratch knn_gather_backward needs for (B, N, k): the CSR of
// the transposed neighbour graph, offsets (B, N + 1) and entries
// (B, N (k-1)), int32.
extern "C" size_t knn_gather_bwd_scratch_bytes(int B, int N, int k) {
    return static_cast<size_t>(B) * (N + 1) * 4 + static_cast<size_t>(B) * N * (k - 1) * 4;
}

// Launches the knn_gather backward on `stream`: idx (B, N, k) i32 and
// g (B, k, N, C) f32 -> dx (B, N, C) f32, every element written; slots
// >= 1 at full f32 (n_chunks = 2) or truncated to bf16 (n_chunks = 1); an
// id outside [0, N) adds nothing. `scratch` holds
// knn_gather_bwd_scratch_bytes(B, N, k) bytes. Returns the CUDA error code
// (0 = ok); an argument the kernels do not take returns
// cudaErrorInvalidValue.
extern "C" int knn_gather_backward(const void* idx, const void* g, void* dx,
                                   void* scratch, size_t scratch_bytes,
                                   int B, int N, int C, int k, int n_chunks,
                                   void* stream) {
    if (!valid_shape(B, N, C, k) || (n_chunks != 1 && n_chunks != 2)
            || scratch_bytes < knn_gather_bwd_scratch_bytes(B, N, k))
        return static_cast<int>(cudaErrorInvalidValue);
    BwdParams p{};
    p.idx = static_cast<const int*>(idx);
    p.g = static_cast<const float*>(g);
    p.dx = static_cast<float*>(dx);
    p.offsets = static_cast<int*>(scratch);
    p.entries = p.offsets + static_cast<size_t>(B) * (N + 1);
    p.B = B; p.N = N; p.C = C; p.K = k;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k > MAX_K) {
        const size_t smem = csr_large_smem_bytes(N);
        err = cudaFuncSetAttribute(knn_gather_csr_large_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        knn_gather_csr_large_kernel<<<B, CSR_THREADS, smem, s>>>(p);
    } else {
        p.lists_in_smem = csr_smem_bytes(N, k, true) <= MAX_BLOCK_SMEM;
        const size_t smem = csr_smem_bytes(N, k, p.lists_in_smem);
        err = cudaFuncSetAttribute(
            knn_gather_csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        knn_gather_csr_kernel<<<B, CSR_THREADS, smem, s>>>(p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // vector width: rows start on C-float boundaries, so C and the base
    // pointers decide the alignment
    const uintptr_t base = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
    const int vec = C % 4 == 0 && base % 16 == 0 ? 4 : C % 2 == 0 && base % 8 == 0 ? 2 : 1;
    err = n_chunks == 1 ? launch_sum_vec<1>(vec, p, s) : launch_sum_vec<2>(vec, p, s);
    return static_cast<int>(err);
}
