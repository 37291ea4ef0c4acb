// Neighbour selection shared by the fused EdgeConv kernel
// (fused_edgeconv.cu) and the knn_gather forward kernel (knn_gather.cu).
//
// One block of THREADS threads selects, for TM query rows of one batch
// element, slot 0 = the query itself and slots 1..k-1 = the k-1 smallest
// packed values over the other columns: the squared distance's f32 bits
// with the low 11 bits replaced by the column (ties to the lower column).
//   select_small_c  C <= 16: exact f32 distances summed per dimension in
//                   dimension order without FMA, all keys in shared memory;
//   select_wide_c   16 < C <= 256: q_norm + k_norm - 2 * cross, cross from
//                   the three bf16 truncation-split products
//                   hi.hi + hi.lo + lo.hi, keys streamed in 128-key tiles.
// The plain PyTorch version with the same numerics is
// ops/edgeconv.py: edgeconv_select.
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
constexpr int MAX_N = 1 << 11;
constexpr int PACK_MAX = 0x7fffffff;
constexpr int SMALL_C_MAX = 16;
constexpr int WIDE_C_MAX = 256;
constexpr int MAX_K = 8;
constexpr int HEADER_BYTES = TM * MAX_K * 4;       // the selected neighbour ids

__device__ __forceinline__ float trunc_bf16(float v) {
    return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

__device__ __forceinline__ int pack(float dist, int col) {
    return (__float_as_int(dist) & ~IDX_MASK) | col;
}

// sorted insert of v into the ascending list `best`
template <int M>
__device__ __forceinline__ void insert(int (&best)[M], int v) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
        const int lo = min(best[i], v);
        v = max(best[i], v);
        best[i] = lo;
    }
}

// The 16 lanes of one query (a half warp) merge their lists: k-1 rounds of
// a min over the half warp; the lane holding the winner pops it.
template <int K>
__device__ __forceinline__ void merge_lists(int (&best)[K - 1], int* sidx,
                                            int q, int lane, int self) {
#pragma unroll
    for (int s = 0; s < K - 1; ++s) {
        int m = best[0];
#pragma unroll
        for (int off = LANES_PER_QUERY / 2; off > 0; off >>= 1)
            m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (best[0] == m) {
#pragma unroll
            for (int i = 0; i < K - 2; ++i) best[i] = best[i + 1];
            best[K - 2] = PACK_MAX;
        }
        if (lane == 0) sidx[q * K + s + 1] = (m == PACK_MAX) ? self : (m & IDX_MASK);
    }
}

// Fills sidx[TM][K] for queries n0 .. n0 + TM - 1 of the batch element at
// xb (N, C); a query row past N repeats row N - 1. `keys` holds C * N floats.
template <int K>
__device__ void select_small_c(int N, int C, const float* xb, int n0,
                               float* keys, int* sidx) {
    const int t = threadIdx.x;
    for (int e = t; e < N * C; e += THREADS) {
        const int j = e / C, c = e - j * C;
        keys[c * N + j] = xb[e];
    }
    const int q = t / LANES_PER_QUERY, lane = t % LANES_PER_QUERY;
    const int n = n0 + q;
    const int nq = min(n, N - 1);
    float qx[SMALL_C_MAX];
#pragma unroll
    for (int c = 0; c < SMALL_C_MAX; ++c) qx[c] = c < C ? xb[nq * C + c] : 0.f;
    __syncthreads();

    int best[K - 1];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) best[i] = PACK_MAX;
    for (int j = lane; j < N; j += LANES_PER_QUERY) {
        // exact f32 in dimension order, d*d then add: no FMA contraction,
        // so the bits equal the plain version's
        float dist = 0.f;
#pragma unroll
        for (int c = 0; c < SMALL_C_MAX; ++c) {
            if (c < C) {
                const float df = __fsub_rn(qx[c], keys[c * N + j]);
                const float sq = __fmul_rn(df, df);
                dist = c == 0 ? sq : __fadd_rn(dist, sq);
            }
        }
        insert(best, j == n ? PACK_MAX : pack(dist, j));
    }
    if (lane == 0) sidx[q * K] = nq;
    merge_lists<K>(best, sidx, q, lane, nq);
}

// As select_small_c for 16 < C <= 256; `work` holds select_bytes(N, C).
template <int K>
__device__ void select_wide_c(int N, int C, const float* xb, int n0,
                              float* work, int* sidx) {
    const int t = threadIdx.x;
    float* keys = work;                                     // [C][KT_STRIDE]
    float* q_hi = keys + ((C * KT_STRIDE + 3) & ~3);        // [C][TM]
    float* q_lo = q_hi + C * TM;                            // [C][TM]
    float* q_norm = q_lo + C * TM;                          // [TM]
    int* dist = reinterpret_cast<int*>(q_norm + TM);        // [TM][KT]

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
    int best[K - 1];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) best[i] = PACK_MAX;

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
            dist[qi * KT + j] = (gj >= N || gj == n0 + qi) ? PACK_MAX : pack(dd, gj);
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
    merge_lists<K>(best, sidx, q, lane, nq);
}

inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// Shared-memory bytes the selection of (N, C) needs, beyond HEADER_BYTES.
inline size_t select_bytes(int N, int C) {
    if (C <= SMALL_C_MAX) return static_cast<size_t>(C) * N * 4;
    return align16(static_cast<size_t>(C) * KT_STRIDE * 4)
           + 2 * static_cast<size_t>(C) * TM * 4 + TM * 4 + TM * KT * 4;
}

}  // namespace knn_select
