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
//
// k. The kernels are instantiated at K = k for k <= EXACT_K = 8 and once
// at K = MAX_K = 16 for every k in 9..16: that instance keeps each query's
// ranked list of the K - 1 best pairs and fills slots 1..k-1 from its
// head (the order by key and column is total, so the head is the k-1
// best); slots k..K-1 repeat the query. The selected ids of a query row
// take slot_capacity(K) ints of shared memory, 8 for K <= 8 as before the
// K = 16 instance existed, and the candidate lists of the merge are sized
// alike, so the K <= 8 instances keep their shared-memory layout.
//   select_small_c  C <= 16, SMALL_QB = 128 query rows: exact f32
//                   distances summed per dimension in dimension order
//                   without FMA; keys staged through shared memory in
//                   windows of `window` columns (see below);
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
// select_small_c. Each warp is one key lane: warp w visits the columns
// w, w + 8, w + 16, ... of every window in ascending order, and its 32
// threads each hold SMALL_QT = 4 query rows (lane, lane + 32, ...) in
// registers, so one staged key (one 16-byte shared load at C <= 3, all
// lanes on the same address) serves four pairs. Windows of keys are
// double-buffered with cp.async. Each thread keeps, per query row, a
// sorted list of its k-1 best packed keys and `lim`, the quantized
// distance of the list's last entry. Invariant: a thread sees its columns
// in ascending order, so every held entry has a lower column than the
// pair in hand; a pair whose distance bits are not below `lim` has a
// quantized distance at or above the last entry's and, on a tie, a
// higher column, so it ranks after the last entry and is rejected by that
// one 32-bit compare, exactly. Only the rare pair that passes is checked
// against the query's own column and inserted. Every SMALL_SYNC_COLS
// columns the 8 lanes of a query row share their lists' last distances:
// the least of them bounds the row's (k-1)-th best, so each lane also
// rejects what lies above it (a lane's own list fills slowly, and a warp
// whose 128 lists each insert now and then would take the insert path on
// almost every step). Ties between threads are
// settled by the merge, which ranks (quantized distance, global column).
// The per-pair arithmetic is __fsub_rn / __fmul_rn / __fadd_rn in
// dimension order; dimensions past C are zero in the queries and the keys,
// and adding +0 to a non-negative sum keeps its bits, so the ids equal
// the plain version's bit for bit. A warp takes two columns per step and
// branches once for its 8 pairs: only when one of them passes does it
// check them again one by one, in column order.
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

constexpr int TM = 16;            // query rows per block of the wide selection up to 2048
constexpr int SMALL_QT = 4;           // query rows per thread of the small-C selection
constexpr int SMALL_QB = 32 * SMALL_QT;  // query rows per block of the small-C selection
constexpr int WIDE_QB = 64;       // query rows per block of the streaming wide kernels
constexpr int THREADS = 256;
constexpr int LANES_PER_QUERY = THREADS / TM;
constexpr int IDX_MASK = (1 << 11) - 1;
constexpr int MAX_N = 1 << 11;    // the int32 encoding's column bound
constexpr int SMALL_C_MAX = 16;
constexpr int WIDE_C_MAX = 256;
constexpr int EXACT_K = 8;        // k at or below: an instance of its own
constexpr int MAX_K = 16;         // the one instance for EXACT_K < k <= MAX_K
constexpr int SMALL_LISTS = THREADS / 32;          // key lanes (warps) of the small-C selection

// The instance that serves k, and the ids a query row keeps in shared
// memory for instance K (the header and the candidate lists are sized by it).
__host__ __device__ constexpr int instance_k(int k) { return k <= EXACT_K ? k : MAX_K; }
__host__ __device__ constexpr int slot_capacity(int K) { return K <= EXACT_K ? EXACT_K : MAX_K; }
// The selected neighbour ids of QB query rows (the kernels' header).
__host__ __device__ constexpr int header_bytes(int QB, int K) { return QB * slot_capacity(K) * 4; }
// The slots instance K fills with neighbours for a launch of k: K itself
// unless K is the shared MAX_K instance.
template <int K> __device__ __forceinline__ int filled_slots(int k) {
    return K <= EXACT_K ? K : k;
}
// bytes of one staged key window of the small-C selection (32 KB): 2048
// columns at C <= 3 (16 bytes a key), the TPU kernel's column tile
constexpr int SMALL_STAGE_BYTES = 32768;
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
    // the quantized distance bits of v (all ones for MAX, an empty slot)
    __device__ static __forceinline__ unsigned limit(T v) {
        return v == MAX ? 0xffffffffu : static_cast<unsigned>(v & ~IDX_MASK);
    }
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
    __device__ static __forceinline__ unsigned limit(T v) {
        return v == MAX ? 0xffffffffu : static_cast<unsigned>(v >> 32);
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

// The small-C selection's per-lane list key. LANE32 (N <= 16384): one
// int32, the quantized distance above the lane-local column m = column >> 3
// (a lane sees the columns w, w + 8, ... of windows whose starts are
// multiples of 16, so m is unique and ascends with the column, and fits the
// 11 cleared bits); integer min/max make its sorted insert cheap. Else the
// global key Rank<TILED>. global() turns a list entry into the merge's
// Rank<TILED> key.
template <bool LANE32, bool TILED> struct ListRank;

template <bool TILED> struct ListRank<true, TILED> : Rank<false> {
    __device__ static __forceinline__ typename Rank<TILED>::T global(T v, int lane_column) {
        if (v == MAX) return Rank<TILED>::MAX;
        return Rank<TILED>::pack(__int_as_float(v & ~IDX_MASK),
                                 ((v & IDX_MASK) << 3) | lane_column);
    }
};

template <bool TILED> struct ListRank<false, TILED> : Rank<TILED> {
    __device__ static __forceinline__ typename Rank<TILED>::T global(
            typename Rank<TILED>::T v, int) {
        return v;
    }
};

constexpr int MAX_LANE32_N = 8 * (IDX_MASK + 1);   // 16384 columns

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

// The 16 lanes of one query (a half warp) merge their lists: K-1 rounds of
// a min over the half warp; the lane holding the winner pops it. R is a
// ranking key type: Rank<TILED> or RankExact. Slots past the launch's k
// (filled_slots) take the query itself.
template <int K, typename R>
__device__ __forceinline__ void merge_lists(typename R::T (&best)[K - 1],
                                            int* sidx, int q, int lane, int self, int k) {
    const int filled = filled_slots<K>(k);
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
        if (lane == 0) sidx[q * K + s + 1] = (m == R::MAX || s + 1 >= filled) ? self
                                                                             : R::column(m);
    }
}

// The k-1 best of the candidate lists cand[QB][lists][K - 1] (each
// ascending) per query row, into sidx[q * K + 1 ..]; slot 0 is the query
// row n0 + q, clamped to N - 1 (a row past N repeats row N - 1). 16 lanes
// per query row: each inserts its share of the lists, then merge_lists.
template <int K, typename R>
__device__ void merge_candidates(const typename R::T* cand, int lists, int QB, int N,
                                 int n0, int* sidx, int k) {
    using T = typename R::T;
    const int t = threadIdx.x;
    const int hq = t / LANES_PER_QUERY, hl = t % LANES_PER_QUERY;
#pragma unroll 1
    for (int q0 = 0; q0 < QB; q0 += THREADS / LANES_PER_QUERY) {
        const int q = q0 + hq;
        T mine[K - 1];
#pragma unroll
        for (int i = 0; i < K - 1; ++i) mine[i] = R::MAX;
        for (int l = hl; l < lists; l += LANES_PER_QUERY) {
#pragma unroll
            for (int i = 0; i < K - 1; ++i) {
                const T v = cand[(q * lists + l) * (K - 1) + i];
                if (v < mine[K - 2]) insert(mine, v);
            }
        }
        const int nq = min(n0 + q, N - 1);
        if (hl == 0) sidx[q * K] = nq;
        merge_lists<K, R>(mine, sidx, q, hl, nq, k);
    }
}

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

// The dimensions select_small_c computes for C: 3 (C <= 3, the xyz
// clouds) or 16; the floats a staged key takes: 4 or 16.
__host__ __device__ constexpr int small_c_dims(int C) { return C <= 3 ? 3 : SMALL_C_MAX; }
__host__ __device__ constexpr int small_key_floats(int CD) { return CD == 3 ? 4 : SMALL_C_MAX; }
__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// keys staged per window: the window padded to whole two-key steps of the
// 8 key lanes
__host__ __device__ constexpr int small_window_stride(int window) {
    return round_up(window, 2 * SMALL_LISTS);
}
constexpr float FAR_KEY = 3.0e38f;    // a padded key: (q - FAR_KEY)^2 is +inf
constexpr int SMALL_SYNC_COLS = 512;  // columns between shares of the lanes' limits

// Fills sidx[SMALL_QB][K] for queries n0 .. n0 + SMALL_QB - 1 of the
// batch element at xb (N, C), C <= CD = small_c_dims(C); a query row past
// N repeats row N - 1. `work` holds small_select_bytes(window, C, TILED, K)
// bytes; keys are staged `window` columns at a time; k is the launch's.
template <int K, bool TILED, int CD, bool LANE32 = true>
__device__ void select_small_c(int N, int C, const float* xb, int n0,
                               unsigned char* work, int* sidx, int window, int k) {
    using R = Rank<TILED>;                    // the merge's key: global columns
    using LR = ListRank<LANE32, TILED>;       // the lanes' lists' key
    using T = typename LR::T;
    constexpr int KF = small_key_floats(CD);
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    float* stages = reinterpret_cast<float*>(work);               // [2][stride][KF]
    if (C < CD) {                     // dimensions past C stay zero
        for (int e = t; e < 2 * small_window_stride(window) * KF; e += THREADS) stages[e] = 0.f;
        __syncthreads();
    }
    // per query row and key lane: the quantized distance of the lane's
    // list's last entry, shared every SMALL_SYNC_COLS columns
    unsigned* shared_last = reinterpret_cast<unsigned*>(
        stages + 2 * small_window_stride(window) * KF);             // [SMALL_QB][SMALL_LISTS]
    float qx[SMALL_QT][CD];
    int self[SMALL_QT];
    T best[SMALL_QT][K - 1];
    unsigned lim[SMALL_QT], bound[SMALL_QT];
#pragma unroll
    for (int i = 0; i < SMALL_QT; ++i) {
        self[i] = n0 + lane + 32 * i;
        const int nq = min(self[i], N - 1);
#pragma unroll
        for (int c = 0; c < CD; ++c) qx[i][c] = c < C ? xb[nq * C + c] : 0.f;
#pragma unroll
        for (int j = 0; j < K - 1; ++j) best[i][j] = LR::MAX;
        lim[i] = bound[i] = 0xffffffffu;
    }

    // a window's keys padded to a multiple of 2 * SMALL_LISTS with far keys
    // (their distances overflow to +inf), so each warp takes two keys per
    // step; a padded key is never inserted (j < wn below)
    const int stride = small_window_stride(window);
    const int windows = (N + window - 1) / window;
    auto issue = [&](int w) {
        float* st = stages + (w & 1) * stride * KF;
        const int w0 = w * window, wn = min(window, N - w0);
        const float* src = xb + static_cast<size_t>(w0) * C;
        for (int e = t; e < wn * C; e += THREADS) {
            const int j = e / C;
            cp_async4(st + j * KF + (e - j * C), src + e);
        }
        for (int e = wn * KF + t; e < round_up(wn, 2 * SMALL_LISTS) * KF; e += THREADS)
            st[e] = FAR_KEY;
        cp_async_commit();
    };
    issue(0);
    for (int w = 0; w < windows; ++w) {
        if (w + 1 < windows) {
            issue(w + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* keys = stages + (w & 1) * stride * KF;
        const int w0 = w * window, wn = min(window, N - w0);
        const int wn_pad = round_up(wn, 2 * SMALL_LISTS);
        for (int j0 = 0; j0 < wn_pad; j0 += SMALL_SYNC_COLS) {
            const int j1 = min(j0 + SMALL_SYNC_COLS, wn_pad);
#pragma unroll 2
            for (int j = j0 + warp; j < j1; j += 2 * SMALL_LISTS) {
                // columns j and j + SMALL_LISTS against the thread's query rows
                float dist[2][SMALL_QT];
                bool pass = false;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    float kx[KF];
#pragma unroll
                    for (int v = 0; v < KF / 4; ++v) {
                        const float4 f = reinterpret_cast<const float4*>(
                            keys + (j + u * SMALL_LISTS) * KF)[v];
                        kx[4 * v] = f.x; kx[4 * v + 1] = f.y; kx[4 * v + 2] = f.z; kx[4 * v + 3] = f.w;
                    }
#pragma unroll
                    for (int i = 0; i < SMALL_QT; ++i) {
                        // exact f32 in dimension order, d*d then add: no FMA
                        // contraction, so the bits equal the plain version's
                        float d = 0.f;
#pragma unroll
                        for (int c = 0; c < CD; ++c) {
                            const float df = __fsub_rn(qx[i][c], kx[c]);
                            const float sq = __fmul_rn(df, df);
                            d = c == 0 ? sq : __fadd_rn(d, sq);
                        }
                        dist[u][i] = d;
                        pass |= __float_as_uint(d) < lim[i];
                    }
                }
                if (pass) {                   // rare: in column order, each pair checked again
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int jj = j + u * SMALL_LISTS, gj = w0 + jj;
#pragma unroll
                        for (int i = 0; i < SMALL_QT; ++i) {
                            if (__float_as_uint(dist[u][i]) < lim[i] && jj < wn && gj != self[i]) {
                                insert(best[i], LR::pack(dist[u][i], LANE32 ? gj >> 3 : gj));
                                lim[i] = min(LR::limit(best[i][K - 2]), bound[i]);
                            }
                        }
                    }
                }
            }
            // The union of the lanes' lists holds, per query row, k-1 entries at
            // or below tau = the least of the lanes' last quantized distances,
            // so no pair above tau can be among the row's k-1 best: every lane
            // rejects quantized distances above tau (d bits >= tau + 2048) from
            // here on, besides its own list's limit.
#pragma unroll
            for (int i = 0; i < SMALL_QT; ++i)
                shared_last[(lane + 32 * i) * SMALL_LISTS + warp] = LR::limit(best[i][K - 2]);
            __syncthreads();
#pragma unroll
            for (int i = 0; i < SMALL_QT; ++i) {
                unsigned tau = 0xffffffffu;
#pragma unroll
                for (int l = 0; l < SMALL_LISTS; ++l)
                    tau = min(tau, shared_last[(lane + 32 * i) * SMALL_LISTS + l]);
                if (tau != 0xffffffffu) bound[i] = min(bound[i], tau + (IDX_MASK + 1));
                lim[i] = min(lim[i], bound[i]);
            }
            __syncthreads();              // shared_last is read before it is rewritten
        }
        __syncthreads();              // the window's stage is consumed
    }

    using RT = typename R::T;
    RT* cand = reinterpret_cast<RT*>(work);       // [SMALL_QB][SMALL_LISTS][K - 1]
#pragma unroll
    for (int i = 0; i < SMALL_QT; ++i)
#pragma unroll
        for (int j = 0; j < K - 1; ++j)
            cand[((lane + 32 * i) * SMALL_LISTS + warp) * (K - 1) + j] =
                LR::global(best[i][j], warp);
    __syncthreads();
    merge_candidates<K, R>(cand, SMALL_LISTS, SMALL_QB, N, n0, sidx, k);
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
inline size_t wide_select_bytes(int C, int splits, size_t key_bytes, int K) {
    using Tile = WideTile<QB>;
    constexpr int KT = Tile::WK * Tile::NT * 8;
    const size_t rs = padded_depth(C) + ROW_PAD;
    const size_t staged = static_cast<size_t>(splits) * QB * rs * 2 + QB * 4
                          + 2 * (KT * rs * 2 + KT * 4);
    const size_t cand = static_cast<size_t>(QB) * 4 * Tile::WK * (slot_capacity(K) - 1)
                        * key_bytes;
    return staged > cand ? staged : cand;
}

// Fills sidx[QB][K] for queries n0 .. n0 + QB - 1 of one cloud of N points
// (`rows`, split into SPLITS chunks); a query row past N repeats row
// N - 1. R ranks the distance q_norm + k_norm - 2 * cross, clamped at 0 if
// CLAMP. `work` holds wide_select_bytes<QB>(C, SPLITS, sizeof(R::T), K);
// k is the launch's.
template <int K, typename R, int SPLITS, int QB, bool CLAMP>
__device__ void select_wide(int N, const SplitRows rows, int n0, unsigned char* work,
                            int* sidx, int k) {
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
    merge_candidates<K, R>(cand, LISTS, QB, N, n0, sidx, k);
}

// The fused layer's and knn_gather's wide selection: 2 chunks, the
// quantized ranking of Rank<TILED>, distances clamped at 0.
template <int K, bool TILED, int QB>
__device__ void select_wide_c(int N, const SplitRows rows, int n0, unsigned char* work,
                              int* sidx, int k) {
    select_wide<K, Rank<TILED>, 2, QB, true>(N, rows, n0, work, sidx, k);
}

// The key window of the small-C selection: SMALL_STAGE_BYTES of keys,
// fewer when `tile_n` > 0 asks for them (rounded up to a multiple of 16,
// which keeps every window's start a multiple of 16), at most N.
inline int small_c_window(int N, int C, int tile_n) {
    int w = SMALL_STAGE_BYTES / (small_key_floats(small_c_dims(C)) * 4);
    if (tile_n > 0 && tile_n < w) w = round_up(tile_n, 2 * SMALL_LISTS);
    return w < N ? w : N;
}

// Shared-memory bytes of select_small_c: two key windows, or the candidate
// lists of the final merge (which reuse the same bytes), whichever is larger.
inline size_t small_select_bytes(int window, int C, bool tiled, int K) {
    const size_t staged = 2 * static_cast<size_t>(small_window_stride(window))
                          * small_key_floats(small_c_dims(C)) * 4
                          + SMALL_QB * SMALL_LISTS * 4;              // shared_last
    const size_t cand = static_cast<size_t>(SMALL_QB) * SMALL_LISTS * (slot_capacity(K) - 1)
                        * (tiled ? sizeof(long long) : sizeof(int));
    return staged > cand ? staged : cand;
}

// Shared-memory bytes the selection of (N, C) at k needs beyond its
// header: small C select_small_c's; wide C select_wide_c's, with WIDE_QB
// query rows when tiled and TM otherwise.
inline size_t select_bytes(int C, bool tiled, int window, int k) {
    const int K = instance_k(k);
    if (C <= SMALL_C_MAX) return small_select_bytes(window, C, tiled, K);
    return tiled ? wide_select_bytes<WIDE_QB>(C, 2, sizeof(long long), K)
                 : wide_select_bytes<TM>(C, 2, sizeof(int), K);
}

}  // namespace knn_select
