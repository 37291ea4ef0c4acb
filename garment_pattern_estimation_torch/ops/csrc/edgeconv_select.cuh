// Neighbour selection shared by the fused EdgeConv kernel
// (fused_edgeconv.cu), the knn_gather forward kernel (knn_gather.cu) and the
// standalone kNN kernels (knn.cu takes select_small_c; knn_wide.cu takes
// select_wide with the exact ranking key RankExact).
//
// A block of THREADS threads selects, for its query rows of one batch
// element, slot 0 = the query itself and slots 1..k-1 = the k-1 smallest
// (distance key, column) pairs over the other columns, ties to the lower
// column. The fused layer and knn_gather rank the quantized distance (its
// f32 bits with the low 11 bits cleared, clamped at 0), in two encodings
// (Rank below):
//   TILED = false  N <= 2048: one int32, the column in the cleared 11 bits;
//   TILED = true   N <= 16384 (fused) or any N (knn.cu): one int64, the
//                  quantized bits above a 32-bit column, so the column is
//                  global whatever N is.
// Both order the same pairs the same way.
//   select_small_c  C <= 16, 16 query rows: exact f32 distances summed per
//                   dimension in dimension order without FMA; keys staged
//                   through shared memory in windows of `window` columns;
//   select_wide     16 < C <= 256, QB query rows (16, or WIDE_QB = 64 for
//                   the kernels that stream a whole 10^4-point cloud):
//                   q_norm + k_norm - 2 * cross on bf16 tensor cores.
//
// select_wide. split_rows_kernel first writes every point once into
// device memory as SPLITS bf16 truncation chunks (hi, lo[, lo2]), each
// zero-padded to a depth Dp that is a multiple of 16, plus the point's
// squared norm (summed in f64, rounded to f32), so a query's and a key's
// norm are the same value. cross is the sum of the split products
// q_a . k_b with a + b < SPLITS (2 chunks: hl, lh, hh; 3 chunks: the six
// of _CROSS_PAIRS[3]); every product is of two bf16-exact values, so
// mma.sync m16n8k16 bf16 x bf16 -> f32 computes it exactly. The products
// run in the order small first, hi.hi last; each 16-deep step is summed by
// the tensor core from zero and added to the pair's running sum in f32,
// rounded to nearest. The tensor core aligns the addends of an MMA to the
// largest and truncates the bits shifted out, so one chain of MMAs would
// lose up to an ulp of the running sum per product, enough to move ids
// past the near-tie bound at the stress shapes; per step it loses at most
// an ulp of one 16-term partial. Integer coordinates keep every partial
// sum exact, and a pair's value does not depend on where it falls in a
// tile. Per block: the queries' chunks stay
// in shared memory; keys stream in units of one chunk of KT keys (with
// their norms), double-buffered with cp.async so the load of unit u+1
// overlaps the MMAs on unit u; rows are padded by 16 bytes, so ldmatrix
// reads them without bank conflicts. Warps tile the block as WQ query
// groups of 16 rows x WK key groups of NT * 8 columns; each thread owns two
// query rows and 2 NT columns of a tile and keeps, per row, a sorted list
// of its k-1 best keys in registers, inserting a pair only if it beats the
// list's last key (after the first tiles almost every pair stops at that
// one compare). At the end the lists go through shared memory, 16 lanes
// per query, and merge with half-warp shuffles (merge_lists).
//
// What bounds select_wide on an H100 SXM: at the stress shapes (10^4
// points, D = 150) the products are 2 x 3 (or 6) x 160 operations per
// ordered pair on the tensor cores, which mma.sync issues at roughly two
// thirds of the wgmma rate; ldmatrix traffic (384 bytes of shared memory
// per MMA at QB = 64), the f32 add of every step's four sums per thread
// and each block's pass over its cloud's chunks in L2 are of the same
// order. Left: each unordered pair is computed twice (once
// per direction), wgmma and TMA are not used, and the epilogue's packing
// and compare run for every pair on the CUDA cores.
//
// The plain PyTorch versions with the same ranking are ops/edgeconv.py:
// edgeconv_select and ops/knn.py: knn_reference; their sums run in
// cuBLAS's order, so ids may differ from them at near ties only.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace knn_select {

constexpr int TM = 16;            // query rows per block (small C; wide C up to 2048)
constexpr int WIDE_QB = 64;       // query rows per block of the streaming wide kernels
constexpr int THREADS = 256;
constexpr int LANES_PER_QUERY = THREADS / TM;
constexpr int IDX_MASK = (1 << 11) - 1;
constexpr int MAX_N = 1 << 11;    // the int32 encoding's column bound
constexpr int SMALL_C_MAX = 16;
constexpr int WIDE_C_MAX = 256;
constexpr int MAX_K = 8;
constexpr int HEADER_BYTES = TM * MAX_K * 4;       // the selected neighbour ids
constexpr int WIDE_HEADER_BYTES = WIDE_QB * MAX_K * 4;
// floats of one staged key window of the tiled small-C path (24 KB): 2048
// columns at C = 3, the TPU kernel's column tile
constexpr int SMALL_WINDOW_FLOATS = 6144;
constexpr int DEPTH_STEP = 16;    // the MMA depth; chunks are zero-padded to it
constexpr int ROW_PAD = 8;        // bf16 per staged row beyond the depth (16 bytes)

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

// (distance, column) ranked by the exact f32 value, then the column: the
// bits map to an order-preserving unsigned integer (-0 sent to +0 first,
// so the two tie as the float compare ties them) above the 32-bit column.
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
// ranking key type: Rank<TILED> or RankExact.
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

// ---- the wide selection on bf16 tensor cores ----

__host__ __device__ inline int padded_depth(int C) { return (C + DEPTH_STEP - 1) / DEPTH_STEP * DEPTH_STEP; }

// Bytes of split_rows_kernel's output for P points of C dimensions: the
// chunks (bf16, chunk-major), then the f32 norms.
inline size_t split_bytes(size_t P, int C, int splits) {
    return static_cast<size_t>(splits) * P * padded_depth(C) * 2 + P * 4;
}

// One warp per point of x (P, C): chunk s of point p at
// split[(s * P + p) * Dp], zero beyond C; norm[p] = sum of x^2, summed in
// f64 and rounded to f32.
template <int SPLITS>
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* x, size_t P, int C, int Dp, uint16_t* split, float* norm) {
    const size_t p = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (p >= P) return;
    const float* row = x + p * C;
    float v[WIDE_C_MAX / 32];
#pragma unroll
    for (int i = 0; i < WIDE_C_MAX / 32; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < C ? row[c] : 0.f;
        if (c < Dp) {
            float r = v[i];
#pragma unroll
            for (int s = 0; s < SPLITS; ++s) {
                const float chunk = trunc_bf16(r);
                split[(s * P + p) * Dp + c] = static_cast<uint16_t>(__float_as_uint(chunk) >> 16);
                r = r - chunk;            // exact: chunk is r truncated
            }
        }
    }
    // the norm in f64 (each square exact, the sum's error far below an f32
    // ulp), rounded once to f32; a fixed reduction order
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < WIDE_C_MAX / 32; ++i) {
        const double vd = v[i];
        s = __fma_rn(vd, vd, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) norm[p] = static_cast<float>(s);
}

// Splits x (P, C) into `scratch` (split_bytes(P, C, SPLITS) bytes).
template <int SPLITS>
inline cudaError_t launch_split(const float* x, size_t P, int C, void* scratch,
                                cudaStream_t stream) {
    uint16_t* split = static_cast<uint16_t*>(scratch);
    float* norm = reinterpret_cast<float*>(
        static_cast<unsigned char*>(scratch) + split_bytes(P, C, SPLITS) - P * 4);
    const size_t blocks = (P + 7) / 8;
    split_rows_kernel<SPLITS><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        x, P, C, padded_depth(C), split, norm);
    return cudaGetLastError();
}

// One cloud's rows in split_rows_kernel's output.
struct SplitRows {
    const uint16_t* split;        // chunk 0 of the cloud's first point
    size_t chunk_stride;          // elements from one chunk to the next: P * Dp
    const float* norm;            // the cloud's norms
    int Dp;
};

__device__ __forceinline__ SplitRows cloud_rows(const void* scratch, size_t P, int C,
                                                int splits, int b, int N) {
    const int Dp = padded_depth(C);
    const uint16_t* split = static_cast<const uint16_t*>(scratch);
    const float* norm = reinterpret_cast<const float*>(
        static_cast<const unsigned char*>(scratch) + static_cast<size_t>(splits) * P * Dp * 2);
    const size_t first = static_cast<size_t>(b) * N;
    return {split + first * Dp, P * Dp, norm + first, Dp};
}

// Warp tiling of a QB-row query block: WQ groups of 16 rows x WK groups of
// NT * 8 key columns; KT = WK * NT * 8 keys per tile.
template <int QB> struct WideTile;
template <> struct WideTile<TM> { static constexpr int WQ = 1, WK = 8, NT = 2; };
template <> struct WideTile<WIDE_QB> { static constexpr int WQ = 4, WK = 2, NT = 4; };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

// d = a (16 x 16, row) . b (16 x 8, col), summed from zero
__device__ __forceinline__ void mma_bf16_from_zero(float (&d)[4], const unsigned (&a)[4],
                                                   unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Shared-memory bytes of select_wide for C dimensions: the queries' chunks
// and norms plus two key units, or the candidate lists of the final merge
// (which reuse the same bytes), whichever is larger.
template <int QB>
inline size_t wide_select_bytes(int C, int splits, size_t key_bytes) {
    using Tile = WideTile<QB>;
    constexpr int KT = Tile::WK * Tile::NT * 8;
    const size_t rs = padded_depth(C) + ROW_PAD;
    const size_t staged = static_cast<size_t>(splits) * QB * rs * 2 + QB * 4
                          + 2 * (KT * rs * 2 + KT * 4);
    const size_t cand = static_cast<size_t>(QB) * 4 * Tile::WK * (MAX_K - 1) * key_bytes;
    return staged > cand ? staged : cand;
}

// Fills sidx[QB][K] for queries n0 .. n0 + QB - 1 of one cloud of N points
// (`rows`, split into SPLITS chunks); a query row past N repeats row
// N - 1. R ranks the distance q_norm + k_norm - 2 * cross, clamped at 0 if
// CLAMP. `work` holds wide_select_bytes<QB>(C, SPLITS, sizeof(R::T)).
template <int K, typename R, int SPLITS, int QB, bool CLAMP>
__device__ void select_wide(int N, const SplitRows rows, int n0, unsigned char* work,
                            int* sidx) {
    using T = typename R::T;
    using Tile = WideTile<QB>;
    constexpr int NT = Tile::NT;
    constexpr int KT = Tile::WK * NT * 8;
    constexpr int LISTS = 4 * Tile::WK;           // candidate lists per query row
    const int Dp = rows.Dp, RS = Dp + ROW_PAD, pieces = Dp / 8;
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int wq = warp % Tile::WQ, wk = warp / Tile::WQ;
    uint16_t* q_split = reinterpret_cast<uint16_t*>(work);            // [SPLITS][QB][RS]
    float* q_norm = reinterpret_cast<float*>(q_split + SPLITS * QB * RS);   // [QB]
    unsigned char* stages = reinterpret_cast<unsigned char*>(q_norm + QB);
    const int stage_bytes = KT * RS * 2 + KT * 4;  // [KT][RS] bf16, then [KT] norms

    for (int e = t; e < SPLITS * QB * pieces; e += THREADS) {
        const int s = e / (QB * pieces), r = e - s * QB * pieces;
        const int qq = r / pieces, pc = r - qq * pieces;
        const size_t n = min(n0 + qq, N - 1);
        cp_async16(q_split + (s * QB + qq) * RS + pc * 8,
                   rows.split + s * rows.chunk_stride + n * Dp + pc * 8);
    }
    for (int e = t; e < QB; e += THREADS) cp_async4(q_norm + e, rows.norm + min(n0 + e, N - 1));

    // unit u: key chunk SPLITS - 1 - u % SPLITS of the keys of tile u / SPLITS
    auto issue = [&](int u) {
        const int jt = (u / SPLITS) * KT, kc = SPLITS - 1 - u % SPLITS;
        unsigned char* st = stages + (u & 1) * stage_bytes;
        uint16_t* keys = reinterpret_cast<uint16_t*>(st);
        float* k_norm = reinterpret_cast<float*>(st + KT * RS * 2);
        const uint16_t* src = rows.split + kc * rows.chunk_stride;
        for (int e = t; e < KT * pieces; e += THREADS) {
            const int jj = e / pieces, pc = e - jj * pieces;
            const size_t j = min(jt + jj, N - 1);
            cp_async16(keys + jj * RS + pc * 8, src + j * Dp + pc * 8);
        }
        for (int e = t; e < KT; e += THREADS) cp_async4(k_norm + e, rows.norm + min(jt + e, N - 1));
        cp_async_commit();
    };

    T best[2][K - 1];                 // rows wq * 16 + lane / 4 (+ 8), ascending
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < K - 1; ++i) best[h][i] = R::MAX;
    float acc[NT][4];
    float qn[2] = {0.f, 0.f};
    const int row0 = wq * 16 + lane / 4;
    // ldmatrix row addresses: A rows of the warp's 16 queries (x4: rows
    // 0-7 / 8-15, depth 0-7 / 8-15), B rows of two 8-key groups (x4: keys
    // 0-7 / 8-15, depth 0-7 / 8-15)
    const int a_off = (wq * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS + (lane / 16) * 8;
    const int b_off = (wk * NT * 8 + lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;

    const int units = (N + KT - 1) / KT * SPLITS;
    issue(0);                         // one group with the queries
    for (int u = 0; u < units; ++u) {
        if (u + 1 < units) {
            issue(u + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (u == 0) {
            qn[0] = q_norm[row0];
            qn[1] = q_norm[row0 + 8];
        }
        const int kc = SPLITS - 1 - u % SPLITS;
        if (kc == SPLITS - 1) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        }
        const unsigned char* st = stages + (u & 1) * stage_bytes;
        const uint16_t* keys = reinterpret_cast<const uint16_t*>(st) + b_off;
        // query chunks SPLITS - 1 - kc down to 0: the products of this key
        // chunk, the smaller first. Each 16-deep step is summed by the
        // tensor core from zero and added to the running sum in f32
        // (round to nearest): the tensor core aligns an MMA's addends to
        // the largest and truncates the bits shifted out, so chaining the
        // steps would lose up to an ulp of the running sum per product.
        for (int qc = SPLITS - 1 - kc; qc >= 0; --qc) {
            const uint16_t* qa = q_split + qc * QB * RS + a_off;
#pragma unroll 2
            for (int ks = 0; ks < Dp; ks += DEPTH_STEP) {
                unsigned a[4];
                ldmatrix_x4(a, qa + ks);
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    unsigned b[4];
                    ldmatrix_x4(b, keys + np * 16 * RS + ks);
                    float step[2][4];
                    mma_bf16_from_zero(step[0], a, b[0], b[1]);
                    mma_bf16_from_zero(step[1], a, b[2], b[3]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc[2 * np][e] = __fadd_rn(acc[2 * np][e], step[0][e]);
                        acc[2 * np + 1][e] = __fadd_rn(acc[2 * np + 1][e], step[1][e]);
                    }
                }
            }
        }
        if (kc == 0) {                // the tile's cross terms are complete
            const int jt = (u / SPLITS) * KT;
            const float* k_norm = reinterpret_cast<const float*>(st + KT * RS * 2);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e / 2;
                    const int col = wk * NT * 8 + nt * 8 + 2 * (lane % 4) + e % 2;
                    const int gj = jt + col;
                    // 2 * cross is exact, so a contraction into one FMA rounds alike
                    float dd = (qn[h] + k_norm[col]) - 2.f * acc[nt][e];
                    if (CLAMP) dd = fmaxf(dd, 0.f);
                    if (gj < N && gj != n0 + row0 + 8 * h) {
                        const T v = R::pack(dd, gj);
                        if (v < best[h][K - 2]) insert(best[h], v);
                    }
                }
            }
        }
        __syncthreads();              // the unit's stage is consumed
    }

    // merge: every thread's two lists through shared memory, then 16 lanes
    // per query row
    T* cand = reinterpret_cast<T*>(work);         // [QB][LISTS][K - 1]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
            cand[((row0 + 8 * h) * LISTS + wk * 4 + lane % 4) * (K - 1) + i] = best[h][i];
    __syncthreads();
    const int hq = t / LANES_PER_QUERY, hl = t % LANES_PER_QUERY;
#pragma unroll 1
    for (int q0 = 0; q0 < QB; q0 += THREADS / LANES_PER_QUERY) {
        const int q = q0 + hq;
        T mine[K - 1];
#pragma unroll
        for (int i = 0; i < K - 1; ++i) mine[i] = R::MAX;
        for (int l = hl; l < LISTS; l += LANES_PER_QUERY) {
#pragma unroll
            for (int i = 0; i < K - 1; ++i) {
                const T v = cand[(q * LISTS + l) * (K - 1) + i];
                if (v < mine[K - 2]) insert(mine, v);
            }
        }
        const int nq = min(n0 + q, N - 1);
        if (hl == 0) sidx[q * K] = nq;
        merge_lists<K, R>(mine, sidx, q, hl, nq);
    }
}

// The fused layer's and knn_gather's wide selection: 2 chunks, the
// quantized ranking of Rank<TILED>, distances clamped at 0.
template <int K, bool TILED, int QB>
__device__ void select_wide_c(int N, const SplitRows rows, int n0, unsigned char* work,
                              int* sidx) {
    select_wide<K, Rank<TILED>, 2, QB, true>(N, rows, n0, work, sidx);
}

inline size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

// The key window of the small-C selection: all N columns when not tiled,
// else `tile_n` columns when given, else SMALL_WINDOW_FLOATS / C.
inline int small_c_window(int N, int C, bool tiled, int tile_n) {
    if (!tiled) return N;
    const int w = tile_n > 0 ? tile_n : SMALL_WINDOW_FLOATS / C;
    return w < N ? w : N;
}

// Shared-memory bytes the selection of (N, C) needs beyond its header:
// small C the key window; wide C select_wide_c's, with WIDE_QB query rows
// when tiled and TM otherwise.
inline size_t select_bytes(int N, int C, bool tiled, int window) {
    if (C <= SMALL_C_MAX) return static_cast<size_t>(C) * window * 4;
    return tiled ? wide_select_bytes<WIDE_QB>(C, 2, sizeof(long long))
                 : wide_select_bytes<TM>(C, 2, sizeof(int));
}

}  // namespace knn_select
