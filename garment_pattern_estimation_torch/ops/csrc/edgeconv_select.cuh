// Neighbour selection shared by the fused EdgeConv kernel
// (fused_edgeconv.cu), the knn_gather forward kernel (knn_gather.cu) and the
// standalone kNN kernels (knn.cu; knn_wide.cu takes the constants, `insert`
// and `merge_lists` with a ranking key of its own).
//
// One block of THREADS threads selects, for TM query rows of one batch
// element, slot 0 = the query itself and slots 1..k-1 = the k-1 smallest
// (quantized squared distance, column) pairs over the other columns, compared
// lexicographically: the distance's f32 bits with the low 11 bits cleared,
// ties to the lower column. Two encodings of that pair (Rank below):
//   TILED = false  N <= 2048: one int32, the column in the cleared 11 bits;
//   TILED = true   N <= 16384 (fused) or any N (knn.cu): one int64, the
//                  quantized bits above a 32-bit column, so the column is
//                  global whatever N is.
// Both order the same pairs the same way; the int32 form is the single-tile
// kernels' own, kept for N <= 2048.
//   select_small_c  C <= 16: exact f32 distances summed per dimension in
//                   dimension order without FMA; keys staged through shared
//                   memory in windows of `window` columns (all N columns
//                   when not tiled);
//   select_wide_c   16 < C <= 256: q_norm + k_norm - 2 * cross, cross from
//                   the three bf16 truncation-split products
//                   hi.hi + hi.lo + lo.hi, keys streamed in 128-key tiles.
// The plain PyTorch version with the same numerics is
// ops/edgeconv.py: edgeconv_select (ops/knn.py: select_ranked).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace knn_select {

constexpr int TM = 16;            // query rows per block
constexpr int THREADS = 256;
constexpr int LANES_PER_QUERY = THREADS / TM;
constexpr int KT = 128;           // key tile of the wide path
constexpr int KT_STRIDE = KT + 1; // padded: the transposing tile store is conflict-free
constexpr int IDX_MASK = (1 << 11) - 1;
constexpr int MAX_N = 1 << 11;    // the int32 encoding's column bound
constexpr int SMALL_C_MAX = 16;
constexpr int WIDE_C_MAX = 256;
constexpr int MAX_K = 8;
constexpr int HEADER_BYTES = TM * MAX_K * 4;       // the selected neighbour ids
// floats of one staged key window of the tiled small-C path (24 KB): 2048
// columns at C = 3, the TPU kernel's column tile
constexpr int SMALL_WINDOW_FLOATS = 6144;

__device__ __forceinline__ float trunc_bf16(float v) {
    return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

template <bool TILED> struct Rank;

template <> struct Rank<false> {
    using T = int;
    static constexpr T MAX = 0x7fffffff;
    __device__ static __forceinline__ T pack(float dist, int col) {
        return (__float_as_int(dist) & ~IDX_MASK) | col;
    }
    __device__ static __forceinline__ int column(T v) { return v & IDX_MASK; }
};

template <> struct Rank<true> {
    using T = long long;
    static constexpr T MAX = 0x7fffffffffffffffLL;
    __device__ static __forceinline__ T pack(float dist, int col) {
        return (static_cast<long long>(__float_as_int(dist) & ~IDX_MASK) << 32) | col;
    }
    __device__ static __forceinline__ int column(T v) {
        return static_cast<int>(v & 0xffffffffLL);
    }
};

// sorted insert of v into the ascending list `best`
template <typename T, int M>
__device__ __forceinline__ void insert(T (&best)[M], T v) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
        const T lo = best[i] < v ? best[i] : v;
        v = best[i] < v ? v : best[i];
        best[i] = lo;
    }
}

// The 16 lanes of one query (a half warp) merge their lists: k-1 rounds of
// a min over the half warp; the lane holding the winner pops it. R is a
// ranking key type: Rank<TILED> here, or knn_wide.cu's exact-value key.
template <int K, typename R>
__device__ __forceinline__ void merge_lists(typename R::T (&best)[K - 1],
                                            int* sidx, int q, int lane, int self) {
#pragma unroll
    for (int s = 0; s < K - 1; ++s) {
        typename R::T m = best[0];
#pragma unroll
        for (int off = LANES_PER_QUERY / 2; off > 0; off >>= 1) {
            const typename R::T o = __shfl_xor_sync(0xffffffffu, m, off);
            m = o < m ? o : m;
        }
        if (best[0] == m) {
#pragma unroll
            for (int i = 0; i < K - 2; ++i) best[i] = best[i + 1];
            best[K - 2] = R::MAX;
        }
        if (lane == 0) sidx[q * K + s + 1] = (m == R::MAX) ? self : R::column(m);
    }
}

// Fills sidx[TM][K] for queries n0 .. n0 + TM - 1 of the batch element at
// xb (N, C); a query row past N repeats row N - 1. `keys` holds
// C * window floats; not TILED, window is N.
template <int K, bool TILED>
__device__ void select_small_c(int N, int C, const float* xb, int n0,
                               float* keys, int* sidx, int window) {
    using R = Rank<TILED>;
    const int t = threadIdx.x;
    const int q = t / LANES_PER_QUERY, lane = t % LANES_PER_QUERY;
    const int n = n0 + q;
    const int nq = min(n, N - 1);
    float qx[SMALL_C_MAX];
#pragma unroll
    for (int c = 0; c < SMALL_C_MAX; ++c) qx[c] = c < C ? xb[nq * C + c] : 0.f;

    typename R::T best[K - 1];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) best[i] = R::MAX;
    for (int w0 = 0; w0 < N; w0 += window) {
        const int wn = min(window, N - w0);
        __syncthreads();                  // the previous window is consumed
        const float* src = xb + static_cast<size_t>(w0) * C;
        for (int e = t; e < wn * C; e += THREADS) {
            const int j = e / C, c = e - j * C;
            keys[c * wn + j] = src[e];
        }
        __syncthreads();
        for (int j = lane; j < wn; j += LANES_PER_QUERY) {
            // exact f32 in dimension order, d*d then add: no FMA
            // contraction, so the bits equal the plain version's
            float dist = 0.f;
#pragma unroll
            for (int c = 0; c < SMALL_C_MAX; ++c) {
                if (c < C) {
                    const float df = __fsub_rn(qx[c], keys[c * wn + j]);
                    const float sq = __fmul_rn(df, df);
                    dist = c == 0 ? sq : __fadd_rn(dist, sq);
                }
            }
            const int gj = w0 + j;
            insert(best, gj == n ? R::MAX : R::pack(dist, gj));
        }
    }
    if (lane == 0) sidx[q * K] = nq;
    merge_lists<K, Rank<TILED>>(best, sidx, q, lane, nq);
}

// As select_small_c for 16 < C <= 256; `work` holds select_bytes(N, C, TILED, 0).
template <int K, bool TILED>
__device__ void select_wide_c(int N, int C, const float* xb, int n0,
                              float* work, int* sidx) {
    using R = Rank<TILED>;
    using T = typename R::T;
    const int t = threadIdx.x;
    float* keys = work;                                     // [C][KT_STRIDE]
    float* q_hi = keys + ((C * KT_STRIDE + 3) & ~3);        // [C][TM]
    float* q_lo = q_hi + C * TM;                            // [C][TM]
    float* q_norm = q_lo + C * TM;                          // [TM]
    T* dist = reinterpret_cast<T*>(q_norm + TM);            // [TM][KT], 16-byte aligned

    for (int e = t; e < TM * C; e += THREADS) {
        const int qq = e / C, c = e - qq * C;
        const float v = xb[min(n0 + qq, N - 1) * C + c];
        const float hi = trunc_bf16(v);
        q_hi[c * TM + qq] = hi;
        q_lo[c * TM + qq] = trunc_bf16(v - hi);
    }
    if (t < TM) {
        const float* row = xb + min(n0 + t, N - 1) * C;
        float s = 0.f;
        for (int c = 0; c < C; ++c) s = fmaf(row[c], row[c], s);
        q_norm[t] = s;
    }

    const int q = t / LANES_PER_QUERY, lane = t % LANES_PER_QUERY;
    const int n = n0 + q;
    T best[K - 1];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) best[i] = R::MAX;

    // distance phase: thread owns key j of the tile and 8 queries
    const int j = t % KT, qh = t / KT;
    for (int jt = 0; jt < N; jt += KT) {
        __syncthreads();                  // the previous tile is consumed
        for (int e = t; e < KT * C; e += THREADS) {
            const int jj = e / C, c = e - jj * C;
            const int gj = jt + jj;
            keys[c * KT_STRIDE + jj] = gj < N ? xb[gj * C + c] : 0.f;
        }
        __syncthreads();

        float hh[8], hl[8], lh[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) hh[i] = hl[i] = lh[i] = 0.f;
        float k_norm = 0.f;
        for (int c = 0; c < C; ++c) {
            const float kv = keys[c * KT_STRIDE + j];
            const float k_hi = trunc_bf16(kv);
            const float k_lo = trunc_bf16(kv - k_hi);
            k_norm = fmaf(kv, kv, k_norm);
            const float4* qh4 = reinterpret_cast<const float4*>(q_hi + c * TM + qh * 8);
            const float4* ql4 = reinterpret_cast<const float4*>(q_lo + c * TM + qh * 8);
            const float4 h0 = qh4[0], h1 = qh4[1], l0 = ql4[0], l1 = ql4[1];
            const float qhv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
            const float qlv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
            // every product is of two bf16-exact values: exact in f32
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                hh[i] = fmaf(qhv[i], k_hi, hh[i]);
                hl[i] = fmaf(qhv[i], k_lo, hl[i]);
                lh[i] = fmaf(qlv[i], k_hi, lh[i]);
            }
        }
        const int gj = jt + j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int qi = qh * 8 + i;
            const float cross = (hh[i] + hl[i]) + lh[i];
            const float dd = fmaxf((q_norm[qi] + k_norm) - 2.f * cross, 0.f);
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
    const int nq = min(n, N - 1);
    if (lane == 0) sidx[q * K] = nq;
    merge_lists<K, Rank<TILED>>(best, sidx, q, lane, nq);
}

inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// The key window of the small-C selection: all N columns when not tiled,
// else `tile_n` columns when given, else SMALL_WINDOW_FLOATS / C.
inline int small_c_window(int N, int C, bool tiled, int tile_n) {
    if (!tiled) return N;
    const int w = tile_n > 0 ? tile_n : SMALL_WINDOW_FLOATS / C;
    return w < N ? w : N;
}

// Shared-memory bytes the selection of (N, C) needs, beyond HEADER_BYTES.
inline size_t select_bytes(int N, int C, bool tiled, int window) {
    if (C <= SMALL_C_MAX) return static_cast<size_t>(C) * window * 4;
    const size_t key_bytes = tiled ? sizeof(long long) : sizeof(int);
    return align16(static_cast<size_t>(C) * KT_STRIDE * 4)
           + 2 * static_cast<size_t>(C) * TM * 4 + TM * 4 + TM * KT * key_bytes;
}

}  // namespace knn_select
