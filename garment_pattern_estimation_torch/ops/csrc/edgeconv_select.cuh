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
// k. The kernels are instantiated at K = k for k <= EXACT_K = 8, once at
// K = MAX_K = 16 for every k in 9..16, and once per capacity bucket
// K = 32, 64, 128 (LARGE_K_MAX) for k in 17..32, 33..64, 65..128: such an
// instance keeps each query's ranked list of its best pairs and fills
// slots 1..k-1 from its head (the order by key and column is total, so the
// head is the k-1 best); slots k..K-1 repeat the query. The selected ids
// of a query row take slot_capacity(K) ints of shared memory, 8 for K <= 8
// as before the K = 16 instance existed, and the candidate lists of the
// merge are sized alike, so the K <= 8 instances keep their shared-memory
// layout. The instances above MAX_K select differently (see "k above
// MAX_K" below); those up to MAX_K are as they were.
//   select_small_c  C <= 16, SMALL_QB = 128 query rows: exact f32
//                   distances summed per dimension in dimension order
//                   without FMA; keys staged through shared memory in
//                   windows of `window` columns (see below);
//   select_wide     16 < C <= 256, QB query rows (16, or WIDE_QB = 64 for
//                   the kernels that stream a whole 10^4-point cloud):
//                   q_norm + k_norm - 2 * cross on bf16 tensor cores;
//                   select_wide_general the same for any C, staged
//                   WIDE_C_MAX features at a time (kernels of their own, so
//                   the C <= 256 instances are as they were);
//   select_stream   select_wide's arithmetic for the streaming kernels at
//                   K <= MAX_K on Hopper: 128 query rows a block, keys in a
//                   TMA ring, products on wgmma (see below);
//   select_all_kernel  k > LARGE_K_MAX (the fused layer and knn_gather):
//                   every key of a few query rows, see below.
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
// What bounds select_wide on an H100 SXM: the same products and f32 adds
// as select_stream's (below), run on mma.sync from ldmatrix fragments
// (384 bytes of shared memory per MMA at QB = 64), with two barriers a
// key unit and each block's pass over its cloud's chunks in L2 (129 GB a
// batch at the served stress layer). The kernels that stream a whole
// cloud per block take select_stream at K <= MAX_K where its shared
// memory fits; select_wide's QB = WIDE_QB instances serve the rest
// (C > 224 for 2 chunks, D > 160 for 3, K > MAX_K).
//
// k above MAX_K. A list of K - 1 keys a thread would not fit in
// registers, so each query row's list belongs to one warp: sorted across
// the warp, lane l holding positions l, l + 32, ... (K / 32 keys a lane),
// keys always 64-bit (Rank<true>, or RankExact for the wide-D kNN; both
// rank like the 32-bit keys). 32 candidates at a time, one per lane, meet
// the list's (k-1)-th key with one compare and a ballot; each survivor is
// inserted with one ballot per register (its position) and two shuffles
// per register (the shift), then the bound is read again, so the few
// survivors left behind are dropped at once. The order of arrival does not
// matter: the list always holds the best keys offered so far.
//   select_small_c_large  LARGE_QB = 32 query rows per block, LARGE_QW = 4
//                   per warp in registers; keys staged in windows of
//                   LARGE_WINDOW_BYTES, lane j taking column j of each
//                   32, the distances computed as select_small_c computes
//                   them (so the ids equal the plain version's);
//   select_wide     the same MMA tiles on 64 query rows (K = 32) or 32
//                   (K = 64, 128: the lists take QB K 8 bytes), each tile's
//                   distances written to shared memory and scanned by the
//                   warps, QB / 8 query rows each, their lists in shared
//                   memory between tiles.
// Left: the insert path costs about K (1 + ln(N / K)) inserts per query
// row, each a few dozen instructions for the whole warp; no batch merge.
//
// The plain PyTorch versions with the same ranking are ops/edgeconv.py:
// edgeconv_select and ops/knn.py: knn_reference; their sums run in
// cuBLAS's order, so ids may differ from them at near ties only.
#pragma once

#include <cuda.h>
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
constexpr int LARGE_K_MAX = 128;  // the largest capacity instance: k <= 128
constexpr int SMALL_LISTS = THREADS / 32;          // key lanes (warps) of the small-C selection
constexpr int LARGE_QW = 4;       // query rows per warp of select_small_c_large
constexpr int LARGE_QB = SMALL_LISTS * LARGE_QW;   // query rows per block of it (32)
constexpr int LARGE_WINDOW_BYTES = 32768;          // its staged key window
constexpr int LARGE_WIDE_QB = 32; // query rows per block of the wide selection at K = 64, 128
constexpr size_t MAX_BLOCK_SMEM = 232448;          // the most shared memory a block may take

// The instance that serves k, and the ids a query row keeps in shared
// memory for instance K (the header and the candidate lists are sized by it).
__host__ __device__ constexpr int instance_k(int k) {
    return k <= EXACT_K ? k : k <= MAX_K ? MAX_K : k <= 32 ? 32 : k <= 64 ? 64 : LARGE_K_MAX;
}
__host__ __device__ constexpr int slot_capacity(int K) {
    return K <= EXACT_K ? EXACT_K : K <= MAX_K ? MAX_K : K;
}
// Query rows per block of instance K: select_small_c's (small C),
// select_wide's streaming (`stream`) or single-tile ones (wide C); above
// MAX_K, the large-k selections'.
__host__ __device__ constexpr int select_rows(bool small_c, bool stream, int K) {
    return K > MAX_K ? (small_c ? LARGE_QB : K <= 32 ? WIDE_QB : LARGE_WIDE_QB)
                     : small_c ? SMALL_QB : (stream ? WIDE_QB : TM);
}
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
    using H = int;                // a key's top 32 bits, which order keys as T does
    static constexpr T MAX = 0x7fffffffffffffffLL;
    __device__ static __forceinline__ H rank_bits(float dist) {
        return __float_as_int(dist) & ~IDX_MASK;
    }
    __device__ static __forceinline__ H high(T v) { return static_cast<H>(v >> 32); }
    // rank_bits(dist) <= h as one compare of dist's bits (h has its low 11
    // bits clear, or is high(MAX))
    __device__ static __forceinline__ H bits_bound(H h) {
        return h == 0x7fffffff ? h : h | IDX_MASK;
    }
    __device__ static __forceinline__ bool at_or_below(float dist, H bound) {
        return __float_as_int(dist) <= bound;
    }
    __device__ static __forceinline__ T pack(float dist, int col) {
        return (static_cast<long long>(rank_bits(dist)) << 32) | col;
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
    using H = unsigned;
    static constexpr T MAX = ~0ULL;
    __device__ static __forceinline__ H rank_bits(float dist) {
        unsigned bits = __float_as_uint(dist);
        if (bits == 0x80000000u) bits = 0u;                       // -0 ranks as +0
        // negative: flip every bit; non-negative: set the sign bit
        return bits ^ ((bits & 0x80000000u) ? 0xffffffffu : 0x80000000u);
    }
    __device__ static __forceinline__ H high(T v) { return static_cast<H>(v >> 32); }
    __device__ static __forceinline__ H bits_bound(H h) { return h; }
    __device__ static __forceinline__ bool at_or_below(float dist, H bound) {
        return rank_bits(dist) <= bound;
    }
    __device__ static __forceinline__ T pack(float dist, int col) {
        return (static_cast<T>(rank_bits(dist)) << 32) | static_cast<unsigned>(col);
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

// The 64-bit key a large-k list ranks by: Rank<true> for the quantized
// rankings (the same order as Rank<false>), RankExact as it is.
template <typename R> struct LargeRank { using type = R; };
template <> struct LargeRank<Rank<false>> { using type = Rank<true>; };

// The entry at warp-uniform position pos of a warp's list, on every lane.
template <typename T, int L>
__device__ __forceinline__ T warp_list_at(const T (&list)[L], int pos) {
    T v = list[0];
#pragma unroll
    for (int i = 1; i < L; ++i)
        if (pos / 32 == i) v = list[i];
    return __shfl_sync(0xffffffffu, v, pos % 32);
}

// Inserts v (the same on every lane) into the warp's ascending list (lane
// l holds positions l + 32 i); the last entry falls off.
template <typename T, int L>
__device__ __forceinline__ void warp_list_insert(T (&list)[L], T v, int lane) {
    int pos = 0;
#pragma unroll
    for (int i = 0; i < L; ++i) pos += __popc(__ballot_sync(0xffffffffu, list[i] < v));
    T up[L], last[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
        up[i] = __shfl_up_sync(0xffffffffu, list[i], 1);       // position - 1, lane > 0
        last[i] = __shfl_sync(0xffffffffu, list[i], 31);       // position 32 i + 31
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int p = lane + 32 * i;
        const T prev = lane > 0 ? up[i] : (i > 0 ? last[i - 1] : v);
        if (p > pos) list[i] = prev;
        else if (p == pos) list[i] = v;
    }
}

// One candidate per lane (MAX: none) offered to a warp's list whose
// (k-1)-th key is `bound`: the candidates below it are inserted in lane
// order, each against the bound as it stands, and `bound` is kept current.
template <typename T, int L>
__device__ __forceinline__ void warp_list_offer(T (&list)[L], T& bound, T v, int lane, int k) {
    unsigned pass = __ballot_sync(0xffffffffu, v < bound);
    while (pass) {
        const int src = __ffs(pass) - 1;
        warp_list_insert(list, __shfl_sync(0xffffffffu, v, src), lane);
        bound = warp_list_at(list, k - 2);
        pass &= __ballot_sync(0xffffffffu, v < bound) & ~((2u << src) - 1u);
    }
}

// A warp writes a query row's slots from its list: slot 0 `self`, slots
// 1..k-1 the list's head (`self` where the list ran short), slots past k
// `self`.
template <typename R, int K, int L>
__device__ __forceinline__ void warp_list_write(const typename R::T (&list)[L], int* row,
                                                int self, int k, int lane) {
    if (lane == 0) row[0] = self;
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int s = lane + 32 * i + 1;
        if (s < K) row[s] = s < k && list[i] != R::MAX ? R::column(list[i]) : self;
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
// THREADS threads take part, t = 0 .. THREADS - 1 (threadIdx.x by default).
template <int K, typename R>
__device__ void merge_candidates(const typename R::T* cand, int lists, int QB, int N,
                                 int n0, int* sidx, int k, int t = threadIdx.x) {
    using T = typename R::T;
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

// select_small_c for K > MAX_K: fills sidx[LARGE_QB][K] for queries
// n0 .. n0 + LARGE_QB - 1 (a row past N repeats row N - 1); `work` holds
// LARGE_WINDOW_BYTES. Warp w owns query rows w LARGE_QW .. + LARGE_QW - 1,
// each with its warp list; every window of keys is staged in shared memory
// and scanned 32 columns at a time.
template <int K, int CD>
__device__ void select_small_c_large(int N, int C, const float* xb, int n0,
                                     unsigned char* work, int* sidx, int k) {
    using R = Rank<true>;
    using T = R::T;
    constexpr int L = K / 32;
    constexpr int KF = small_key_floats(CD);
    constexpr int WINDOW = LARGE_WINDOW_BYTES / (KF * 4);
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    float* keys = reinterpret_cast<float*>(work);                  // [WINDOW][KF]
    float qx[LARGE_QW][CD];
    int self[LARGE_QW];
    T list[LARGE_QW][L], bound[LARGE_QW];
#pragma unroll
    for (int i = 0; i < LARGE_QW; ++i) {
        self[i] = n0 + warp * LARGE_QW + i;
        const int nq = min(self[i], N - 1);
#pragma unroll
        for (int c = 0; c < CD; ++c) qx[i][c] = c < C ? xb[nq * C + c] : 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j) list[i][j] = R::MAX;
        bound[i] = R::MAX;
    }
    for (int w0 = 0; w0 < N; w0 += WINDOW) {
        const int wn = min(WINDOW, N - w0);
        __syncthreads();                          // the last window is consumed
        for (int e = t; e < wn * KF; e += THREADS) {
            const int j = e / KF, c = e - j * KF;
            keys[e] = c < C ? xb[static_cast<size_t>(w0 + j) * C + c] : 0.f;
        }
        __syncthreads();
        for (int j0 = 0; j0 < wn; j0 += 32) {
            const int j = j0 + lane;
            float kx[KF];
#pragma unroll
            for (int v = 0; v < KF / 4; ++v) {
                const float4 f = j < wn ? reinterpret_cast<const float4*>(keys + j * KF)[v]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
                kx[4 * v] = f.x; kx[4 * v + 1] = f.y; kx[4 * v + 2] = f.z; kx[4 * v + 3] = f.w;
            }
#pragma unroll
            for (int i = 0; i < LARGE_QW; ++i) {
                // exact f32 in dimension order, d*d then add: no FMA
                // contraction, so the bits equal the plain version's
                float d = 0.f;
#pragma unroll
                for (int c = 0; c < CD; ++c) {
                    const float df = __fsub_rn(qx[i][c], kx[c]);
                    const float sq = __fmul_rn(df, df);
                    d = c == 0 ? sq : __fadd_rn(d, sq);
                }
                const int gj = w0 + j;
                const T v = j < wn && gj != self[i] ? R::pack(d, gj) : R::MAX;
                warp_list_offer(list[i], bound[i], v, lane, k);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < LARGE_QW; ++i)
        warp_list_write<R, K>(list[i], sidx + (warp * LARGE_QW + i) * K, min(self[i], N - 1),
                              k, lane);
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

// split_rows_kernel for C > WIDE_C_MAX: the row in passes of WIDE_C_MAX
// columns, each lane's squares summed across them in one f64 accumulator.
template <int SPLITS>
__global__ void __launch_bounds__(256)
split_rows_wide_kernel(const float* x, size_t P, int C, int Dp, uint16_t* split, float* norm) {
    const size_t p = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (p >= P) return;
    const float* row = x + p * C;
    double s = 0.0;
    for (int c0 = 0; c0 < Dp; c0 += WIDE_C_MAX) {
#pragma unroll
        for (int i = 0; i < WIDE_C_MAX / 32; ++i) {
            const int c = c0 + lane + 32 * i;
            const float v = c < C ? row[c] : 0.f;
            if (c < Dp) {
                float r = v;
#pragma unroll
                for (int t = 0; t < SPLITS; ++t) {
                    const float chunk = trunc_bf16(r);
                    split[(t * P + p) * Dp + c] = static_cast<uint16_t>(__float_as_uint(chunk) >> 16);
                    r = r - chunk;
                }
            }
            const double vd = v;
            s = __fma_rn(vd, vd, s);
        }
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
    if (C > WIDE_C_MAX)
        split_rows_wide_kernel<SPLITS><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
            x, P, C, padded_depth(C), split, norm);
    else
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
template <> struct WideTile<LARGE_WIDE_QB> { static constexpr int WQ = 2, WK = 4, NT = 2; };

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
// (which reuse the same bytes), whichever is larger. Above MAX_K: the
// staged bytes, then a tile's distances (f32) and the rows' lists (64-bit).
// The depth select_wide stages at once: the padded depth, at most
// WIDE_C_MAX (wider rows are staged in chunks of WIDE_C_MAX).
__host__ __device__ inline int staged_depth(int C) {
    return padded_depth(C) < WIDE_C_MAX ? padded_depth(C) : WIDE_C_MAX;
}

template <int QB>
inline size_t wide_select_bytes(int C, int splits, size_t key_bytes, int K) {
    using Tile = WideTile<QB>;
    constexpr int KT = Tile::WK * Tile::NT * 8;
    const size_t rs = staged_depth(C) + ROW_PAD;
    const size_t staged = static_cast<size_t>(splits) * QB * rs * 2 + QB * 4
                          + 2 * (KT * rs * 2 + KT * 4);
    if (K > MAX_K) return staged + static_cast<size_t>(QB) * KT * 4 + static_cast<size_t>(QB) * K * 8;
    const size_t cand = static_cast<size_t>(QB) * 4 * Tile::WK * (slot_capacity(K) - 1)
                        * key_bytes;
    return staged > cand ? staged : cand;
}

// wide_select_bytes at instance K's query rows (select_rows)
inline size_t wide_bytes(int C, int splits, size_t key_bytes, int K, bool stream) {
    switch (select_rows(false, stream, K)) {
        case TM: return wide_select_bytes<TM>(C, splits, key_bytes, K);
        case LARGE_WIDE_QB: return wide_select_bytes<LARGE_WIDE_QB>(C, splits, key_bytes, K);
        default: return wide_select_bytes<WIDE_QB>(C, splits, key_bytes, K);
    }
}

// Fills sidx[QB][K] for queries n0 .. n0 + QB - 1 of one cloud of N points
// (`rows`, split into SPLITS chunks); a query row past N repeats row
// N - 1. R ranks the distance q_norm + k_norm - 2 * cross, clamped at 0 if
// CLAMP. `work` holds wide_select_bytes<QB>(C, SPLITS, sizeof(R::T), K);
// k is the launch's. Above MAX_K (LARGE) the tiles' pairs go to warp lists
// instead of per-thread lists.
template <int K, typename R, int SPLITS, int QB, bool CLAMP>
__device__ void select_wide(int N, const SplitRows rows, int n0, unsigned char* work,
                            int* sidx, int k) {
    using T = typename R::T;
    using Tile = WideTile<QB>;
    constexpr bool LARGE = K > MAX_K;
    using LR = typename LargeRank<R>::type;
    using LT = typename LR::T;
    constexpr int LL = K / 32;                    // LARGE: list keys per lane
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
    // LARGE: a tile's distances [QB][KT] and each query row's list [QB][K]
    float* tile = reinterpret_cast<float*>(stages + 2 * stage_bytes);
    LT* lists = reinterpret_cast<LT*>(tile + QB * KT);
    if constexpr (LARGE)
        for (int e = t; e < QB * K; e += THREADS) lists[e] = LR::MAX;

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

    T best[2][LARGE ? 1 : K - 1];     // rows wq * 16 + lane / 4 (+ 8), ascending
    if constexpr (!LARGE) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < K - 1; ++i) best[h][i] = R::MAX;
    }
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
                    if constexpr (LARGE) {
                        tile[(row0 + 8 * h) * KT + col] = dd;
                    } else if (gj < N && gj != n0 + row0 + 8 * h) {
                        const T v = R::pack(dd, gj);
                        if (v < best[h][K - 2]) insert(best[h], v);
                    }
                }
            }
            if constexpr (LARGE) {        // each warp scans its rows of the tile
                __syncthreads();
                for (int i = 0; i < QB / 8; ++i) {
                    const int q = warp * (QB / 8) + i;
                    LT list[LL];
#pragma unroll
                    for (int l = 0; l < LL; ++l) list[l] = lists[q * K + lane + 32 * l];
                    LT bound = warp_list_at(list, k - 2);
#pragma unroll
                    for (int s = 0; s < KT; s += 32) {
                        const int gj = jt + s + lane;
                        const LT v = gj < N && gj != n0 + q ? LR::pack(tile[q * KT + s + lane], gj)
                                                            : LR::MAX;
                        warp_list_offer(list, bound, v, lane, k);
                    }
#pragma unroll
                    for (int l = 0; l < LL; ++l) lists[q * K + lane + 32 * l] = list[l];
                }
            }
        }
        __syncthreads();              // the unit's stage is consumed
    }

    if constexpr (LARGE) {            // the warps' lists into the slots
        for (int i = 0; i < QB / 8; ++i) {
            const int q = warp * (QB / 8) + i;
            LT list[LL];
#pragma unroll
            for (int l = 0; l < LL; ++l) list[l] = lists[q * K + lane + 32 * l];
            warp_list_write<LR, K>(list, sidx + q * K, min(n0 + q, N - 1), k, lane);
        }
    } else {
        // merge: every thread's two lists through shared memory, then 16
        // lanes per query row
        T* cand = reinterpret_cast<T*>(work);     // [QB][LISTS][K - 1]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < K - 1; ++i)
                cand[((row0 + 8 * h) * LISTS + wk * 4 + lane % 4) * (K - 1) + i] = best[h][i];
        __syncthreads();
        merge_candidates<K, R>(cand, LISTS, QB, N, n0, sidx, k);
    }
}

// select_wide for any depth, and for the large-k selection (ALL). The rows
// are staged staged_depth(C) <= WIDE_C_MAX features at a time: unit u of a
// key tile is (depth chunk d, key chunk kc), d ascending and kc descending
// within it, and the products of a chunk are summed in select_wide's order
// into the same f32 accumulators, so at one chunk (C <= WIDE_C_MAX) a pair's
// value is select_wide's. The queries' chunks of depth chunk d are staged
// with the first unit of d (once for the whole cloud when there is one
// chunk); the unit before such a restage does not overlap the next unit's
// loads. ALL: no lists; the quantized distance bits of every column (~0u
// for the query itself) of query rows 0..kept-1 go to keys[row * kstride +
// column] (the large-k selection ranks them); other rows of the MMA tile are
// computed and dropped. `work` holds wide_select_bytes<QB>(C, SPLITS,
// sizeof(R::T), K) bytes (wide_all_bytes(C) for ALL).
template <int K, typename R, int SPLITS, int QB, bool CLAMP, bool ALL = false>
__device__ void select_wide_general(int N, const SplitRows rows, int n0, unsigned char* work,
                                    int* sidx, int k, unsigned* keys = nullptr, int kept = 0,
                                    int kstride = 0) {
    using T = typename R::T;
    using Tile = WideTile<QB>;
    constexpr bool LARGE = !ALL && K > MAX_K;
    constexpr bool LISTS = !ALL && !LARGE;
    using LR = typename LargeRank<R>::type;
    using LT = typename LR::T;
    constexpr int LL = LARGE ? K / 32 : 1;        // LARGE: list keys per lane
    constexpr int NT = Tile::NT;
    constexpr int KT = Tile::WK * NT * 8;
    constexpr int NLISTS = 4 * Tile::WK;          // candidate lists per query row
    const int Dp = rows.Dp, DS = Dp < WIDE_C_MAX ? Dp : WIDE_C_MAX, RS = DS + ROW_PAD;
    const int NDC = (Dp + DS - 1) / DS;           // depth chunks
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int wq = warp % Tile::WQ, wk = warp / Tile::WQ;
    uint16_t* q_split = reinterpret_cast<uint16_t*>(work);            // [SPLITS][QB][RS]
    float* q_norm = reinterpret_cast<float*>(q_split + SPLITS * QB * RS);   // [QB]
    unsigned char* stages = reinterpret_cast<unsigned char*>(q_norm + QB);
    const int stage_bytes = KT * RS * 2 + KT * 4;  // [KT][RS] bf16, then [KT] norms
    float* tile = reinterpret_cast<float*>(stages + 2 * stage_bytes);   // LARGE: [QB][KT]
    LT* lists = reinterpret_cast<LT*>(tile + QB * KT);                  // LARGE: [QB][K]
    if constexpr (LARGE)
        for (int e = t; e < QB * K; e += THREADS) lists[e] = LR::MAX;

    // the queries' chunks of depth chunk d
    auto issue_queries = [&](int d) {
        const int d0 = d * DS, pieces = min(DS, Dp - d0) / 8;
        for (int e = t; e < SPLITS * QB * pieces; e += THREADS) {
            const int s = e / (QB * pieces), r = e - s * QB * pieces;
            const int qq = r / pieces, pc = r - qq * pieces;
            const size_t n = min(n0 + qq, N - 1);
            cp_async16(q_split + (s * QB + qq) * RS + pc * 8,
                       rows.split + s * rows.chunk_stride + n * Dp + d0 + pc * 8);
        }
    };
    const int per_tile = SPLITS * NDC;
    // unit u: key tile u / per_tile, depth chunk d, key chunk kc
    auto issue = [&](int u) {
        const int r = u % per_tile, d = r / SPLITS;
        const int jt = (u / per_tile) * KT, kc = SPLITS - 1 - (r - d * SPLITS);
        const int d0 = d * DS, pieces = min(DS, Dp - d0) / 8;
        unsigned char* st = stages + (u & 1) * stage_bytes;
        uint16_t* kx = reinterpret_cast<uint16_t*>(st);
        float* k_norm = reinterpret_cast<float*>(st + KT * RS * 2);
        const uint16_t* src = rows.split + kc * rows.chunk_stride;
        for (int e = t; e < KT * pieces; e += THREADS) {
            const int jj = e / pieces, pc = e - jj * pieces;
            const size_t j = min(jt + jj, N - 1);
            cp_async16(kx + jj * RS + pc * 8, src + j * Dp + d0 + pc * 8);
        }
        for (int e = t; e < KT; e += THREADS) cp_async4(k_norm + e, rows.norm + min(jt + e, N - 1));
        cp_async_commit();
    };

    T best[2][LISTS ? K - 1 : 1];     // rows wq * 16 + lane / 4 (+ 8), ascending
    if constexpr (LISTS) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < K - 1; ++i) best[h][i] = R::MAX;
    }
    float acc[NT][4];
    float qn[2] = {0.f, 0.f};
    const int row0 = wq * 16 + lane / 4;
    const int a_off = (wq * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS + (lane / 16) * 8;
    const int b_off = (wk * NT * 8 + lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;

    const int units = (N + KT - 1) / KT * per_tile;
    issue_queries(0);
    for (int e = t; e < QB; e += THREADS) cp_async4(q_norm + e, rows.norm + min(n0 + e, N - 1));
    issue(0);                         // one group with the queries
    for (int u = 0; u < units; ++u) {
        // the next unit starts a new depth chunk of a multi-chunk row: its
        // queries are staged after this unit, its keys with them
        const bool restage = NDC > 1 && (u + 1) % SPLITS == 0;
        if (u + 1 < units && !restage) {
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
        const int r = u % per_tile, d = r / SPLITS;
        const int kc = SPLITS - 1 - (r - d * SPLITS);
        const int depth = min(DS, Dp - d * DS);
        if (kc == SPLITS - 1 && d == 0) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        }
        const unsigned char* st = stages + (u & 1) * stage_bytes;
        const uint16_t* kx = reinterpret_cast<const uint16_t*>(st) + b_off;
        for (int qc = SPLITS - 1 - kc; qc >= 0; --qc) {
            const uint16_t* qa = q_split + qc * QB * RS + a_off;
#pragma unroll 2
            for (int ks = 0; ks < depth; ks += DEPTH_STEP) {
                unsigned a[4];
                ldmatrix_x4(a, qa + ks);
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    unsigned b[4];
                    ldmatrix_x4(b, kx + np * 16 * RS + ks);
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
        if (kc == 0 && d == NDC - 1) {        // the tile's cross terms are complete
            const int jt = (u / per_tile) * KT;
            const float* k_norm = reinterpret_cast<const float*>(st + KT * RS * 2);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e / 2, row = row0 + 8 * h;
                    const int col = wk * NT * 8 + nt * 8 + 2 * (lane % 4) + e % 2;
                    const int gj = jt + col;
                    float dd = (qn[h] + k_norm[col]) - 2.f * acc[nt][e];
                    if (CLAMP) dd = fmaxf(dd, 0.f);
                    if constexpr (ALL) {
                        if (row < kept && gj < N)
                            keys[row * kstride + gj] = gj == n0 + row
                                ? ~0u : (__float_as_uint(dd) & ~static_cast<unsigned>(IDX_MASK));
                    } else if constexpr (LARGE) {
                        tile[row * KT + col] = dd;
                    } else if (gj < N && gj != n0 + row) {
                        const T v = R::pack(dd, gj);
                        if (v < best[h][K - 2]) insert(best[h], v);
                    }
                }
            }
            if constexpr (LARGE) {        // each warp scans its rows of the tile
                __syncthreads();
                for (int i = 0; i < QB / 8; ++i) {
                    const int q = warp * (QB / 8) + i;
                    LT list[LL];
#pragma unroll
                    for (int l = 0; l < LL; ++l) list[l] = lists[q * K + lane + 32 * l];
                    LT bound = warp_list_at(list, k - 2);
#pragma unroll
                    for (int s = 0; s < KT; s += 32) {
                        const int gj = jt + s + lane;
                        const LT v = gj < N && gj != n0 + q ? LR::pack(tile[q * KT + s + lane], gj)
                                                            : LR::MAX;
                        warp_list_offer(list, bound, v, lane, k);
                    }
#pragma unroll
                    for (int l = 0; l < LL; ++l) lists[q * K + lane + 32 * l] = list[l];
                }
            }
        }
        __syncthreads();              // the unit's stage is consumed
        if (u + 1 < units && restage) {
            issue_queries((u + 1) % per_tile / SPLITS);
            issue(u + 1);
        }
    }

    if constexpr (LARGE) {            // the warps' lists into the slots
        for (int i = 0; i < QB / 8; ++i) {
            const int q = warp * (QB / 8) + i;
            LT list[LL];
#pragma unroll
            for (int l = 0; l < LL; ++l) list[l] = lists[q * K + lane + 32 * l];
            warp_list_write<LR, K>(list, sidx + q * K, min(n0 + q, N - 1), k, lane);
        }
    } else if constexpr (LISTS) {
        T* cand = reinterpret_cast<T*>(work);     // [QB][NLISTS][K - 1]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < K - 1; ++i)
                cand[((row0 + 8 * h) * NLISTS + wk * 4 + lane % 4) * (K - 1) + i] = best[h][i];
        __syncthreads();
        merge_candidates<K, R>(cand, NLISTS, QB, N, n0, sidx, k);
    }
}

// ---- the streaming wide selection on Hopper: a TMA-fed key ring, wgmma ----
//
// select_stream is select_wide's arithmetic for the kernels that stream a
// whole cloud per block (the tiled fused layer's wide C, the wide-D kNN) at
// K <= MAX_K: the same split products, each 16-deep step summed from zero
// (wgmma m64n64k16 with scale-d = 0, bitwise mma.sync m16n8k16's sum, as
// a card check of 6.3e7 sums showed, millions of them inexact) and added
// to the pair's running sum with __fadd_rn in select_wide's order (key
// chunk descending, query chunk SPLITS-1-kc down to 0, depth ascending),
// the same epilogue and the same merge, so its ids are select_wide's.
// A block of STREAM_THREADS takes STREAM_QB = 128 query rows of one cloud:
//   warpgroup 0, the producer (its registers given up with setmaxnreg):
//            one thread loads the block's query chunks once and then, unit
//            by unit (one key chunk of a STREAM_KT-key tile), keeps a ring
//            of STREAM_STAGES units in flight with TMA (cp.async.bulk.tensor)
//            over split_rows_kernel's rows, each unit behind a full and an
//            empty mbarrier; its warp copies the norms beside them (the
//            tile's last unit brings the tile's: a norm's address has no
//            16-byte alignment, which a TMA box's start needs);
//   warpgroups 1-2, the consumers, 64 query rows each: per unit and query
//            chunk, wgmma m64n64k16 on the queries' chunk (A) and the key
//            chunk (B), both in shared memory as 32-column panels with the
//            64-byte swizzle TMA writes, in rounds of 4 steps (2 at K = 16,
//            whose lists take the registers) started at once, each into its
//            own accumulator and added as it lands (stream_round); a tile's
//            first step goes straight into the running sum (0 + s and s give
//            the same distance). Each thread holds 2 query rows x 16 keys of
//            the tile and, per row, its sorted list of the k-1 best keys; a
//            tile's 32 distances are checked against the lists' last keys by
//            their ranking bits with one branch for all (exact: keys order by
//            those bits first), and only a pair at or below is ranked in
//            full. At the end the 4 lists of a row merge (merge_candidates).
// Depths that are odd multiples of 16 run one more 16-deep step on the
// zeros TMA fills past the row (adding +0 changes no sum).
//
// What bounds select_stream on an H100 SXM, at the served stress layer (B =
// 128 clouds of N = 10^4 points, C = 150, 2 chunks, Dp = 160): per ordered
// pair 3 products x 10 steps, so B N^2 = 1.28e10 pairs take 1.25e13
// operations on the tensor cores (12.6 ms at 989 TFLOP/s) and 3.8e11 f32
// adds on the CUDA cores (11.5 ms at one warp instruction per clock per
// sub-partition, 1.98 GHz), besides about 4 instructions of epilogue per
// pair. A block streams its cloud's two chunks once for 128 query rows:
// 6.4 MB from L2 per block, 65 GB a batch (select_wide's 64-row blocks:
// 129 GB). Measured there (k = 5): 48.2 ms; a build without the adds 18.3
// ms, one without the products 27.3 ms: the wgmma and the adds of the
// other warpgroup did not overlap on the card, and neither 4 steps in
// flight nor the warpgroups taking turns changed that. Left: the adds,
// which the arithmetic fixes at one per 16-deep step of every pair; each
// unordered pair computed in both directions.

constexpr int STREAM_QB = 128;            // query rows per block
constexpr int STREAM_KT = 64;             // keys per tile: the wgmma's N
constexpr int STREAM_THREADS = 384;       // the producer warpgroup, then two consumer warpgroups
constexpr int STREAM_STAGES = 4;          // key units in flight
constexpr int STREAM_PANEL = 32;          // bf16 columns per panel: one swizzled 64-byte row
constexpr int STREAM_BOX = 64 * STREAM_PANEL * 2;   // bytes of a TMA box: 64 rows of a panel
constexpr int STREAM_LISTS = 4;           // candidate lists per query row (lanes l % 4)

__host__ __device__ inline int stream_panels(int C) {
    return (padded_depth(C) + STREAM_PANEL - 1) / STREAM_PANEL;
}

// select_stream's shared memory, in bytes from a 1024-aligned base: the
// queries' panels [SPLITS][panels][2 boxes], then the key ring
// [STAGES][panels][1 box] (both reused by the merge's candidate lists and
// slots), the ring's norms, the queries' norms, the barriers; `bytes` adds
// the 1024 that aligning the base may take.
struct StreamLayout {
    int ring, k_norm, q_norm, bars, bytes;
};

__host__ __device__ inline StreamLayout stream_layout(int C, int splits, int K) {
    const int panels = stream_panels(C);
    const int tiles = (2 * splits + STREAM_STAGES) * panels * STREAM_BOX;
    const int merge = STREAM_QB * STREAM_LISTS * (slot_capacity(K) - 1) * 8
                      + header_bytes(STREAM_QB, K);
    StreamLayout L;
    L.ring = 2 * splits * panels * STREAM_BOX;
    L.k_norm = round_up(tiles > merge ? tiles : merge, 1024);
    L.q_norm = L.k_norm + STREAM_STAGES * STREAM_KT * 4;
    L.bars = L.q_norm + STREAM_QB * 4;
    L.bytes = L.bars + (2 * STREAM_STAGES + 1) * 8 + 1024;
    return L;
}

// The kernels' arguments besides the TMA map of the split rows: ids
// (B, N, k) i32 out.
struct StreamArgs {
    int* ids;
    const float* norm;            // the split rows' norms (B N)
    int N, C, k;
    size_t P;                     // B N: rows of one chunk of the split rows
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// spins until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                    "r"(smem_u32(bar)) : "memory");
}

// wgmma's descriptor of a K-major operand in 64-byte-swizzled panels: rows
// of 64 bytes, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
    const uint64_t addr = smem_u32(p);
    return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32)
           | (2ull << 62);
}

#define STREAM_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d = A (64 x 16) . B (16 x 64), summed from zero (scale-d = 0), started and
// committed as one group; d belongs to it until a wgmma_wait releases it
__device__ __forceinline__ void wgmma_from_zero(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : STREAM_ACC8(0), STREAM_ACC8(8), STREAM_ACC8(16), STREAM_ACC8(24)
                 : "l"(a), "l"(b), "r"(0));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

#undef STREAM_ACC8

// waits until at most PENDING wgmma groups are in flight; d (the group
// before them) may then be read
template <int PENDING>
__device__ __forceinline__ void wgmma_wait(float (&d)[32]) {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void add_step(float (&run)[32], const float (&step)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) run[i] = __fadd_rn(run[i], step[i]);
}

// One round of a consumer warpgroup: M (2 or 4) consecutive 16-deep steps
// from descriptors qd, kd (step i: panel i / 2, 32 bytes in for odd i),
// all started, then each added to run in order as it lands, so the adds of
// one run while the next are on the tensor cores; no group stays in flight
// past the round (ptxas then keeps the steps asynchronous). FIRST: the
// first step lands in run itself (the tile's first: 0 + s and s give the
// same distance).
template <int M, bool FIRST, int A>
__device__ __forceinline__ void stream_round(float (&run)[32], float (&acc)[A][32], uint64_t qd,
                                             uint64_t kd) {
    static_assert((M == 2 || M == 4) && A >= M, "a round is 2 or 4 steps, each in its accumulator");
    constexpr uint64_t BOX16 = STREAM_BOX >> 4;
    // step i lands in acc[i - FIRST], or in run (i = 0, FIRST)
    if constexpr (FIRST) wgmma_from_zero(run, qd, kd);
    else wgmma_from_zero(acc[0], qd, kd);
    wgmma_from_zero(acc[1 - FIRST], qd + 2, kd + 2);
    if constexpr (M == 4) {
        wgmma_from_zero(acc[2 - FIRST], qd + 2 * BOX16, kd + BOX16);
        wgmma_from_zero(acc[3 - FIRST], qd + 2 * BOX16 + 2, kd + BOX16 + 2);
    }
    if constexpr (FIRST) {
        wgmma_wait<M - 1>(run);
    } else {
        wgmma_wait<M - 1>(acc[0]);
        add_step(run, acc[0]);
    }
    wgmma_wait<M - 2>(acc[1 - FIRST]);
    add_step(run, acc[1 - FIRST]);
    if constexpr (M == 4) {
        wgmma_wait<1>(acc[2 - FIRST]);
        add_step(run, acc[2 - FIRST]);
        wgmma_wait<0>(acc[3 - FIRST]);
        add_step(run, acc[3 - FIRST]);
    }
}

// the consumers' barrier (named barrier 1; the producer warpgroup has left)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(STREAM_THREADS - 128) : "memory");
}

// Block (b, n0 = blockIdx.x STREAM_QB) of cloud b: the ids of query rows
// n0 .. n0 + STREAM_QB - 1 (those below N) into a.ids; `rows` is
// stream_map's TMA map over split_rows_kernel's output (SPLITS chunks);
// `smem` holds stream_layout(C, SPLITS, K).bytes. R ranks the distance
// q_norm + k_norm - 2 cross (clamped at 0 if CLAMP). Returns, on the first
// consumer thread, the clock64() cycles the block took.
template <int K, typename R, int SPLITS, bool CLAMP>
__device__ long long select_stream(const CUtensorMap* rows, const StreamArgs& a, int b, int n0,
                                   unsigned char* smem) {
    using T = typename R::T;
    using H = typename R::H;
    static_assert(sizeof(T) == 8, "select_stream's merge takes 64-bit keys");
    const long long start = clock64();
    const int N = a.N, panels = stream_panels(a.C);
    const StreamLayout L = stream_layout(a.C, SPLITS, K);
    unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
    unsigned char* ring = base + L.ring;
    float* k_norm = reinterpret_cast<float*>(base + L.k_norm);          // [STAGES][KT]
    float* q_norm = reinterpret_cast<float*>(base + L.q_norm);          // [QB]
    uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);         // [STAGES]
    uint64_t* empty = full + STREAM_STAGES;                               // [STAGES]
    uint64_t* q_bar = empty + STREAM_STAGES;
    const int t = threadIdx.x, lane = t % 32;
    const int unit_bytes = panels * STREAM_BOX;
    const int tiles = (N + STREAM_KT - 1) / STREAM_KT, units = tiles * SPLITS;
    const int first = b * N;      // the cloud's first row in a chunk

    if (t == 0) {
        for (int s = 0; s < STREAM_STAGES; ++s) {
            mbar_init(full + s, 32);                            // the producer warp's lanes
            mbar_init(empty + s, (STREAM_THREADS - 128) / 32);   // a consumer warp each
        }
        mbar_init(q_bar, 32);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (t < 128) {                // the producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (t >= 32) return 0;
        // every lane arrives after its own norm stores; lane 0 also starts
        // the TMA loads and sets the bytes they bring
        const float* norm = a.norm + first;
        for (int q = lane; q < STREAM_QB; q += 32) q_norm[q] = norm[min(n0 + q, N - 1)];
        if (lane == 0) {
            mbar_expect_tx(q_bar, SPLITS * panels * 2 * STREAM_BOX);
            for (int s = 0; s < SPLITS; ++s)
                for (int p = 0; p < panels; ++p)
                    for (int h = 0; h < 2; ++h)
                        tma_load_2d(base + ((s * panels + p) * 2 + h) * STREAM_BOX, rows,
                                    p * STREAM_PANEL,
                                    static_cast<int>(s * a.P) + first + n0 + 64 * h, q_bar);
        } else {
            mbar_arrive(q_bar);
        }
        // unit u: key chunk SPLITS - 1 - u % SPLITS of tile u / SPLITS
        for (int u = 0; u < units; ++u) {
            const int s = u % STREAM_STAGES;
            if (u >= STREAM_STAGES) mbar_wait(empty + s, (u / STREAM_STAGES - 1) & 1);
            const int tile = u / SPLITS, kc = SPLITS - 1 - (u - tile * SPLITS);
            if (kc == 0)
                for (int j = lane; j < STREAM_KT; j += 32)
                    k_norm[s * STREAM_KT + j] = norm[min(tile * STREAM_KT + j, N - 1)];
            if (lane == 0) {
                const int row = static_cast<int>(kc * a.P) + first + tile * STREAM_KT;
                mbar_expect_tx(full + s, unit_bytes);
                for (int p = 0; p < panels; ++p)
                    tma_load_2d(ring + (s * panels + p) * STREAM_BOX, rows, p * STREAM_PANEL,
                                row, full + s);
            } else {
                mbar_arrive(full + s);
            }
        }
        return 0;
    }

    // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // the warpgroup as a warp-uniform value (a shuffle from lane 0), so the
    // descriptors live in uniform registers
    const int ct = t - 128, cw = __shfl_sync(0xffffffffu, ct / 128, 0);
    const int row0 = cw * 64 + ((ct / 32) % 4) * 16 + lane / 4;      // and row0 + 8
    constexpr uint64_t BOX16 = STREAM_BOX >> 4;                       // a box, in descriptor units
    // descriptors of step 0 of query chunk qc and of the key unit in stage
    // s; step j adds j / 2 panels and (j % 2) 32 bytes (2 descriptor units)
    const uint64_t q_desc = desc_sw64(base + cw * STREAM_BOX);
    const uint64_t k_desc = desc_sw64(ring);
    auto q_chunk = [&](int qc) { return q_desc + static_cast<uint64_t>(qc * panels * 2) * BOX16; };
    auto k_unit = [&](int s) { return k_desc + static_cast<uint64_t>(s * panels) * BOX16; };

    T best[2][K - 1];             // rows row0, row0 + 8: ascending
    H lim[2];                     // R::at_or_below's bound: each list's last key
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < K - 1; ++i) best[h][i] = R::MAX;
        lim[h] = R::bits_bound(R::high(R::MAX));
    }
    // ROUND steps in flight a round: 4 where the lists leave the registers
    // for 4 accumulators beside the running sum, else 2
    constexpr int ROUND = K <= EXACT_K ? 4 : 2;
    float acc[ROUND][32], run[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        run[i] = 0.f;
#pragma unroll
        for (int r = 0; r < ROUND; ++r) acc[r][i] = 0.f;
    }

    mbar_wait(q_bar, 0);
    const float qn[2] = {q_norm[row0], q_norm[row0 + 8]};
    const int steps = 2 * panels;
    int u = 0;                    // the unit in hand
    for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
        for (int ui = 0; ui < SPLITS; ++ui, ++u) {
            const int s = u % STREAM_STAGES;
            mbar_wait(full + s, (u / STREAM_STAGES) & 1);
            for (int qc = ui; qc >= 0; --qc) {
                uint64_t qd = q_chunk(qc), kd = k_unit(s);
                int j = 0;
                if (ui == 0) {    // the tile's first steps, the first into the running sum
                    if (steps >= ROUND) {
                        stream_round<ROUND, true>(run, acc, qd, kd);
                        j = ROUND, qd += ROUND * BOX16, kd += ROUND / 2 * BOX16;
                    } else {
                        stream_round<2, true>(run, acc, qd, kd);
                        j = 2, qd += 2 * BOX16, kd += BOX16;
                    }
                }
#pragma unroll 1
                for (; j + ROUND <= steps; j += ROUND, qd += ROUND * BOX16, kd += ROUND / 2 * BOX16)
                    stream_round<ROUND, false>(run, acc, qd, kd);
                if (ROUND > 2 && j < steps)       // the segment's last two steps
                    stream_round<2, false>(run, acc, qd, kd);
            }
            if (ui + 1 < SPLITS) {                    // the unit is consumed
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s);
            }
        }
        // the tile's cross terms are complete: its distances (into run),
        // each checked against its row's list by its ranking bits; the few
        // that pass are ranked again in full and inserted
        const int s = (u - 1) % STREAM_STAGES;
        const float2* kn = reinterpret_cast<const float2*>(k_norm + s * STREAM_KT);
        bool pass = false;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
            const int h = (i / 2) % 2;
            const float2 kk = kn[(i / 4) * 4 + lane % 4];       // columns col, col + 1
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                // 2 * cross is exact, so a contraction into one FMA rounds alike
                float dd = (qn[h] + (e ? kk.y : kk.x)) - 2.f * run[i + e];
                if (CLAMP) dd = fmaxf(dd, 0.f);
                run[i + e] = dd;
                pass |= R::at_or_below(dd, lim[h]);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (pass) {                                   // rare once the lists fill
            const int jt = tile * STREAM_KT;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int h = (i / 2) % 2;
                const int gj = jt + (i / 4) * 8 + 2 * (lane % 4) + i % 2;
                if (R::at_or_below(run[i], lim[h]) && gj < N && gj != n0 + row0 + 8 * h) {
                    const T v = R::pack(run[i], gj);
                    if (v < best[h][K - 2]) {
                        insert(best[h], v);
                        lim[h] = R::bits_bound(R::high(best[h][K - 2]));
                    }
                }
            }
        }
    }

    // every thread's two lists through shared memory (over the tiles), then
    // 16 lanes per query row; the slots to device memory
    consumers_sync();
    T* cand = reinterpret_cast<T*>(base);             // [QB][LISTS][K - 1]
    int* sidx = reinterpret_cast<int*>(cand + STREAM_QB * STREAM_LISTS * (slot_capacity(K) - 1));
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
            cand[((row0 + 8 * h) * STREAM_LISTS + lane % 4) * (K - 1) + i] = best[h][i];
    consumers_sync();
    merge_candidates<K, R>(cand, STREAM_LISTS, STREAM_QB, N, n0, sidx, a.k, ct);
    consumers_sync();
    const int k = filled_slots<K>(a.k);
    for (int e = ct; e < STREAM_QB * k; e += STREAM_THREADS - 128) {
        const int q = e / k, sl = e - q * k, n = n0 + q;
        if (n < N) a.ids[(static_cast<size_t>(b) * N + n) * k + sl] = sidx[q * K + sl];
    }
    return clock64() - start;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda); null where it is missing
typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
    static TensorMapEncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                        cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
    }
    return encode;
}

// Whether select_stream takes a layer of P = B N points of C dimensions
// split into `splits` chunks at k: 1 < k <= MAX_K, C <= WIDE_C_MAX, its
// shared memory fits a block, every chunk row's coordinate fits TMA's int32
// (P = 0: not checked) and cuTensorMapEncodeTiled is there.
inline bool stream_fits(size_t P, int C, int splits, int k) {
    return k > 1 && k <= MAX_K && C > SMALL_C_MAX && C <= WIDE_C_MAX
           && static_cast<size_t>(stream_layout(C, splits, instance_k(k)).bytes) <= MAX_BLOCK_SMEM
           && static_cast<size_t>(splits) * P + STREAM_QB <= 0x7fffffffu
           && tensor_map_encoder() != nullptr;
}

// select_stream's TMA map over the rows of split_rows_kernel's output in
// `scratch` for P points of C dimensions in `splits` chunks: bf16 [splits
// P][Dp], boxes of 64 rows x one 32-column panel, 64-byte swizzle; columns
// past Dp read as zeros.
inline cudaError_t stream_map(const void* scratch, size_t P, int C, int splits,
                              CUtensorMap* rows) {
    const TensorMapEncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const int Dp = padded_depth(C);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(splits) * P};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Dp) * 2};
    const cuuint32_t box[2] = {STREAM_PANEL, 64}, unit[2] = {1, 1};
    if (encode(rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(scratch), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
            != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

// Launches `kernel` (a select_stream wrapper) over (ceil(N / STREAM_QB), B)
// blocks on `scratch`'s split rows; a.norm is set here.
template <typename Kernel>
inline cudaError_t launch_stream(Kernel kernel, const void* scratch, StreamArgs a, int B,
                                 int splits, int K, cudaStream_t stream) {
    CUtensorMap rows;
    cudaError_t err = stream_map(scratch, a.P, a.C, splits, &rows);
    if (err != cudaSuccess) return err;
    a.norm = reinterpret_cast<const float*>(static_cast<const unsigned char*>(scratch)
                                            + static_cast<size_t>(splits) * a.P
                                              * padded_depth(a.C) * 2);
    const int smem = stream_layout(a.C, splits, K).bytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + STREAM_QB - 1) / STREAM_QB, B);
    kernel<<<grid, STREAM_THREADS, smem, stream>>>(rows, a);
    return cudaGetLastError();
}

// The fused layer's and knn_gather's wide selection: 2 chunks, the
// quantized ranking of Rank<TILED>, distances clamped at 0. GENERAL takes
// select_wide_general (any depth); otherwise C <= WIDE_C_MAX.
template <int K, bool TILED, int QB, bool GENERAL = false>
__device__ void select_wide_c(int N, const SplitRows rows, int n0, unsigned char* work,
                              int* sidx, int k) {
    if constexpr (GENERAL)
        select_wide_general<K, Rank<TILED>, 2, QB, true>(N, rows, n0, work, sidx, k);
    else
        select_wide<K, Rank<TILED>, 2, QB, true>(N, rows, n0, work, sidx, k);
}

// ---- k above LARGE_K_MAX: every key of a few query rows ----
//
// select_all_kernel serves 128 < k <= N (the fused layer and knn_gather;
// the standalone kNN stops at 128, as the JAX package's knn_pallas does).
// A block takes `rows` query rows of one cloud and writes, per row, the
// quantized distance bits of all N columns to shared memory (~0u for the
// query itself, so it is never chosen: k - 1 <= N - 1 others exist). The
// distances are those of the k <= 128 paths: small C exact f32 per
// dimension in dimension order (select_small_c's arithmetic), wide C the
// 2-term split products on the tensor cores (select_wide_general, ALL), so
// the ids equal theirs. Then one warp per row (rank_row): a radix select on
// the 21 distance bits, most significant first (21 counting passes over
// the row), finds the (k-1)-th smallest distance T and how many of the
// keys equal to T are taken (the lowest columns); the chosen columns, in
// column order, are gathered 32 at a time, and each one's slot is its rank
// in (distance, column) order, counted over the whole row. Slot 0 is the
// query, slots 1..k-1 ascend as _extract_topk's do, ties to the lower
// column. The ids go to device memory (B, N, k) int32: the fused layer's
// edge MLP and knn_gather's row gather read them in a second launch.
// Left: the ranking counts over the whole row for every 32 chosen columns
// (ceil((k-1) / 32) N compares a row); the wide rows of an MMA tile past
// `rows` are computed and dropped (at N > 2048 a block keeps 1-5 of its 16).

constexpr int ALL_BUF = 64;       // per warp: chosen columns waiting for their slots
constexpr int ALL_MAX_ROWS = 16;

__host__ __device__ inline int all_kstride(int N) { return (N + 3) / 4 * 4; }

// Shared bytes of select_wide_general's staging in ALL mode (TM rows).
__host__ __device__ inline size_t wide_all_bytes(int C) {
    using Tile = WideTile<TM>;
    constexpr int KT = Tile::WK * Tile::NT * 8;
    const size_t rs = staged_depth(C) + ROW_PAD;
    return 2 * TM * rs * 2 + TM * 4 + 2 * (KT * rs * 2 + KT * 4);
}

// Bytes before the rows' keys: the wide staging, or the small-C query rows.
__host__ __device__ inline size_t all_head_bytes(int C, bool small_c, int rows) {
    return small_c ? static_cast<size_t>(rows) * SMALL_C_MAX * 4 : wide_all_bytes(C);
}

inline size_t all_bytes(int N, int C, bool small_c, int rows) {
    return all_head_bytes(C, small_c, rows) + static_cast<size_t>(rows) * all_kstride(N) * 4
           + (THREADS / 32) * ALL_BUF * 4;
}

// Query rows per block of select_all_kernel for (N, C): the most that fit,
// at most ALL_MAX_ROWS (and the MMA tile's TM for wide C); 0 if none does.
inline int all_rows(int N, int C, bool small_c) {
    int rows = small_c ? ALL_MAX_ROWS : TM;
    while (rows > 0 && all_bytes(N, C, small_c, rows) > MAX_BLOCK_SMEM) --rows;
    return rows;
}

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(0xffffffffu, v); }

// One warp: slots 0..k-1 of query row `self` into out[0..k-1] from its keys
// (kstride entries, ~0u past N); buf holds ALL_BUF ints of this warp.
__device__ void rank_row(const unsigned* keys, int kstride, int k, int* out, int self,
                         int* buf) {
    const int lane = threadIdx.x % 32;
    const uint4* k4 = reinterpret_cast<const uint4*>(keys);
    const int n4 = kstride / 4;
    unsigned prefix = 0u;
    int need = k - 1;
    for (int bit = 31; bit >= 11; --bit) {
        const unsigned hi = bit == 31 ? 0u : ~0u << (bit + 1);
        int c = 0;
        for (int j = lane; j < n4; j += 32) {
            const uint4 v = k4[j];
            c += ((v.x & hi) == prefix && !((v.x >> bit) & 1u))
                 + ((v.y & hi) == prefix && !((v.y >> bit) & 1u))
                 + ((v.z & hi) == prefix && !((v.z >> bit) & 1u))
                 + ((v.w & hi) == prefix && !((v.w >> bit) & 1u));
        }
        c = warp_sum(c);
        if (c < need) {
            prefix |= 1u << bit;
            need -= c;
        }
    }
    // T = prefix; the first `need` keys equal to T in column order are taken
    int cut = 0, seen = 0;
    for (int j0 = 0; j0 < kstride; j0 += 32) {
        const int j = j0 + lane;
        const unsigned m = __ballot_sync(0xffffffffu, j < kstride && keys[j] == prefix);
        const int c = __popc(m);
        if (seen + c >= need) {
            unsigned mm = m;
            for (int i = 1; i < need - seen; ++i) mm &= mm - 1u;
            cut = j0 + __ffs(mm) - 1;
            break;
        }
        seen += c;
    }
    // a chosen column's slot: 1 + its rank in (distance, column) order
    auto place = [&](int j) {
        const unsigned vj = j >= 0 ? keys[j] : 0u;
        int rank = 0;
        for (int i4 = 0; i4 < n4; ++i4) {
            const uint4 v = k4[i4];
            const int i = 4 * i4;
            rank += (v.x < vj || (v.x == vj && i < j)) + (v.y < vj || (v.y == vj && i + 1 < j))
                    + (v.z < vj || (v.z == vj && i + 2 < j))
                    + (v.w < vj || (v.w == vj && i + 3 < j));
        }
        if (j >= 0) out[1 + rank] = j;
    };
    if (lane == 0) out[0] = self;
    int fill = 0;
    for (int j0 = 0; j0 < kstride; j0 += 32) {
        const int j = j0 + lane;
        const unsigned v = j < kstride ? keys[j] : ~0u;
        const bool chosen = v < prefix || (v == prefix && j <= cut);
        const unsigned m = __ballot_sync(0xffffffffu, chosen);
        if (chosen) buf[fill + __popc(m & ((1u << lane) - 1u))] = j;
        fill += __popc(m);
        __syncwarp();
        if (fill >= 32) {
            place(buf[lane]);
            const int left = fill - 32;
            const int moved = lane < left ? buf[32 + lane] : 0;
            __syncwarp();
            if (lane < left) buf[lane] = moved;
            __syncwarp();
            fill = left;
        }
    }
    if (fill > 0) place(lane < fill ? buf[lane] : -1);
}

struct AllParams {
    const float* x;               // (B, N, C) f32
    const void* split;            // wide C: split_rows_kernel's output (2 chunks)
    int* idx;                     // (B, N, k) i32
    int N, C, k, rows;
    size_t P;                     // B N
};

// One block per (batch element, `rows` query rows): the keys, then the
// rows' slots; all_bytes(N, C, SMALL_C, rows) bytes of shared memory.
template <bool SMALL_C>
__global__ void __launch_bounds__(THREADS)
select_all_kernel(const AllParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.y, n0 = blockIdx.x * p.rows, t = threadIdx.x, warp = t / 32;
    const int N = p.N, C = p.C, kstride = all_kstride(N);
    unsigned char* head = smem;
    unsigned* keys = reinterpret_cast<unsigned*>(head + all_head_bytes(C, SMALL_C, p.rows));
    int* bufs = reinterpret_cast<int*>(keys + static_cast<size_t>(p.rows) * kstride);
    const float* xb = p.x + static_cast<size_t>(b) * N * C;
    if constexpr (SMALL_C) {
        float* q = reinterpret_cast<float*>(head);                 // [rows][C]
        for (int e = t; e < p.rows * C; e += THREADS) {
            const int r = e / C;
            q[e] = xb[min(n0 + r, N - 1) * C + e - r * C];
        }
        __syncthreads();
        for (int e = t; e < p.rows * kstride; e += THREADS) {
            const int r = e / kstride, j = e - r * kstride, n = n0 + r;
            unsigned v = ~0u;
            if (j < N && n < N && j != n) {
                // exact f32 in dimension order, d*d then add: no FMA
                // contraction, select_small_c's bits
                float d = 0.f;
                for (int c = 0; c < C; ++c) {
                    const float df = __fsub_rn(q[r * C + c], xb[static_cast<size_t>(j) * C + c]);
                    const float sq = __fmul_rn(df, df);
                    d = c == 0 ? sq : __fadd_rn(d, sq);
                }
                v = __float_as_uint(d) & ~static_cast<unsigned>(IDX_MASK);
            }
            keys[e] = v;
        }
    } else {
        for (int e = t; e < p.rows * kstride; e += THREADS) keys[e] = ~0u;
        // the staging's first barrier orders these stores before any key's
        select_wide_general<1, Rank<true>, 2, TM, true, true>(
            N, cloud_rows(p.split, p.P, C, 2, b, N), n0, head, nullptr, p.k, keys, p.rows,
            kstride);
    }
    __syncthreads();
    for (int r = warp; r < p.rows; r += THREADS / 32) {
        const int n = n0 + r;
        if (n >= N) break;
        rank_row(keys + static_cast<size_t>(r) * kstride, kstride, p.k,
                 p.idx + (static_cast<size_t>(b) * N + n) * p.k, n, bufs + warp * ALL_BUF);
    }
}

// Launches select_all_kernel for x (B, N, C), 128 < k <= N, into idx
// (B, N, k) i32; wide C reads the split rows in `split` (launch_split<2>
// first). Returns cudaErrorInvalidValue where no row fits shared memory.
// (a template, so that a source which never calls it builds no select_all_kernel)
template <typename = void>
inline cudaError_t launch_select_all(const float* x, const void* split, int* idx, int B,
                                     int N, int C, int k, cudaStream_t stream) {
    const bool small_c = C <= SMALL_C_MAX;
    const int rows = all_rows(N, C, small_c);
    if (rows < 1) return cudaErrorInvalidValue;
    AllParams p{};
    p.x = x; p.split = split; p.idx = idx;
    p.N = N; p.C = C; p.k = k; p.rows = rows;
    p.P = static_cast<size_t>(B) * N;
    const size_t smem = all_bytes(N, C, small_c, rows);
    const dim3 grid((N + rows - 1) / rows, B);
    cudaError_t err;
    if (small_c) {
        err = cudaFuncSetAttribute(select_all_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        select_all_kernel<true><<<grid, THREADS, smem, stream>>>(p);
    } else {
        err = cudaFuncSetAttribute(select_all_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        select_all_kernel<false><<<grid, THREADS, smem, stream>>>(p);
    }
    return cudaGetLastError();
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
// header: small C select_small_c's (select_small_c_large's key window
// above MAX_K); wide C select_wide_c's, with WIDE_QB query rows when tiled
// and TM otherwise (select_rows above MAX_K).
inline size_t select_bytes(int C, bool tiled, int window, int k) {
    const int K = instance_k(k);
    if (C <= SMALL_C_MAX) return K > MAX_K ? LARGE_WINDOW_BYTES
                                           : small_select_bytes(window, C, tiled, K);
    return wide_bytes(C, 2, tiled ? sizeof(long long) : sizeof(int), K, tiled);
}

}  // namespace knn_select
