// Fused dynamic EdgeConv for Hopper (sm_90a): kNN selection + neighbour
// gather + folded-BN edge MLP + max over the k neighbours, in one kernel.
//
// Replaces the TPU kernels of garment_pattern_estimation_tpu/ops/edgeconv.py,
// by template flags:
//   SMALL_C, !TILED   _fused_kernel, small C (C <= 16, N <= 2048): exact
//                     f32 distances summed per dimension, exact gathered rows;
//   !SMALL_C, !TILED  _fused_kernel, wide C (16 < C <= 256, N <= 2048):
//                     distances q_norm + k_norm - 2 * cross, cross from the
//                     three bf16 truncation-split products hi.hi + hi.lo +
//                     lo.hi; gathered rows hi + lo (f32 mode) or hi (bf16);
//   SMALL_C, TILED    _fused_kernel_direct_tiled (2048 < N <= 16384): as
//                     small C, keys staged in column windows;
//   !SMALL_C, TILED   _fused_kernel_stream (2048 < N <= 16384): as wide C.
// The plain PyTorch version with the same numerics is
// ops/edgeconv.py: fused_edgeconv_reference.
//
// Selection (edgeconv_select.cuh, shared with knn_gather.cu and knn.cu):
// self column excluded and put into slot 0, the k-1 smallest (quantized
// distance, column) pairs fill slots 1..k-1, ties to the lower column;
// packed into one int32 up to 2048 columns, into one int64 (global column)
// in the tiled variants. The TPU's tiled kernels merge per-tile candidates
// on (quantized distance, global id) and the stream kernel carries each
// candidate's gathered row through the merges because its VMEM cannot hold
// the keys; here the keys stay in device memory (L2 at these sizes), so
// phase 2 gathers the k-1 winners by id, as in the single-tile kernels.
// MLP: activations truncated to bf16 (bit mask, not rounding), weights
// bf16 (rounded by the caller), f32 accumulation, ReLU; the last layer's
// folded BatchNorm affine __fadd_rn(__fmul_rn(h, a), d), then the max over
// the k slots. Slot 0's edge row is built from the query's own f32 row.
//
// What bounds it on an H100 SXM. At the attention model's conv1 (B=64,
// N=2000, C=150, edge MLP 300-200-200-150, k=5) the work is about 2.3e11
// FLOP of split-product distances (3 products x 2 x B N^2 C) and 1.7e11
// FLOP of edge MLP (2 x B N k x 130k MACs), all on bf16-exact operands,
// against about 154 MB of compulsory traffic (x read once, the output
// written once, weights): 0.40 ms at the 989 TFLOP/s bf16 tensor-core rate
// against 0.05 ms at 3.35 TB/s, so it is bound by operations. The
// (B, N, k, C) gathered tensor (384 MB at that shape) and the (B, N, N)
// distances never reach device memory. At the stress shape (B=128,
// N=10000) the distances grow as B N^2 (conv1: 1.15e13 FLOP, 11.6 ms at
// the bf16 rate; conv0: 1.15e11 f32 FLOP, 1.7 ms at 67 TFLOP/s) and the
// MLP as B N: still bound by operations.
//
// Design. One block of 256 threads per (batch element, query rows), the
// query blocks of one cloud adjacent in the grid, so the cloud's keys stay
// in L2 while its blocks run:
//   phase 1  small C: select_small_c, 128 query rows per block, 4 per
//            thread against one key lane per warp, 2048-column key windows
//            double-buffered with cp.async, one 32-bit compare rejecting
//            almost every pair before an insert into 32-bit lists. Wide C:
//            select_wide_c, the
//            split products on bf16 tensor cores (mma.sync) from rows split
//            once per point by split_rows_kernel (launched first, into the
//            caller's scratch); 16 query rows per block up to 2048 points.
//            The tiled variant streams a whole cloud per block: at k <= 16
//            it is a launch of its own, fused_edgeconv_stream_kernel
//            (select_stream: 128 query rows a block, the keys in a TMA ring,
//            the products on wgmma, the same arithmetic), whose ids
//            (B, N, k) fused_edgeconv_mlp_kernel's edge MLP then takes, in
//            the K <= 8 instance's group of k slots, so both launches'
//            outputs equal the one-launch kernel's bit for bit; where
//            select_stream's shared memory does not fit (C > 224), or above
//            k = 16, 64 query rows per block of select_wide in the fused
//            kernel;
//   phase 2  the edge MLP on bf16 tensor cores, SLICE = 16 query rows at a
//            time. The slice's 16 k edge rows sit slot-major in shared
//            memory (row = slot * 16 + query, bf16, rows padded by 16 bytes
//            so ldmatrix reads them without bank conflicts), so slot s is
//            one 16-row MMA tile. Layer widths are padded to the MMA tile
//            (depth to 16, 6 -> 16, 300 -> 304, 200 -> 208, 150 -> 160)
//            with zero weights. Each warp takes items of up to 2 output
//            n-tiles (8 columns each) of all k row tiles, dealt to the 8
//            warps in turn: per 16-deep step it reads its B fragments once
//            (8 bytes a lane a tile, from the weights the wrapper packs in
//            fragment order, streamed through a 4-deep per-warp cp.async
//            ring so the L2 latency hides behind the MMAs) and one
//            ldmatrix.x4 A fragment per slot, and issues up to 2 k mma.sync
//            m16n8k16 bf16 x bf16 -> f32. A hidden layer's epilogue adds
//            the bias, takes the ReLU, truncates to bf16 (bit mask) and
//            writes the next layer's input; the last layer's
//            applies the affine and takes the max over the slots as an
//            elementwise max of the k row tiles' accumulators, in
//            registers. Each output element is its own row's dot product,
//            so a row's result does not depend on the other rows of its
//            tile: the tiled and single-tile variants stay bitwise equal.
//            The tensor core's sum order differs from cuBLAS's, so outputs
//            differ from the plain version's by f32 rounding (and the rare
//            bf16 truncation it flips).
// k. Instances K = 1..8 select and run the MLP on exactly k slots. The
// K = 16 instance (edgeconv_select.cuh) serves k = 9..16: slots past k
// repeat the query, whose edge row is built exactly as slot 0's (the
// query's own f32 row), so its outputs equal slot 0's bit for bit and the
// max is unchanged; the edge MLP runs the 16 slots in two groups of 8, the
// K = 8 instance's tile of shared memory and accumulators, and the second
// group's max takes the first's from the output it wrote. Left: the
// repeated slots cost 16 / k of the MLP work. The capacity instances K =
// 32, 64, 128 serve k = 17..128 (select_small_c_large, 32 query rows a
// block, or select_wide's warp lists, edgeconv_select.cuh) and run only the
// groups of 8 that hold a slot below k: 3 groups at k = 20, 16 at 128.
// Registers are held to 128 a thread (two blocks per SM), so one block's
// selection (CUDA cores) overlaps another's edge MLP (tensor cores); the
// 2-tile items keep the MLP's accumulators within that. Building with
// -DPHASE_CLOCKS adds per-phase cycle counters (phase_clocks.py).
// Left on the table: each block reads the weights once per 16-query slice
// (from L2 where L1 misses), the edge MLP runs on mma.sync (a fraction of
// the wgmma rate), warps idle in a layer's last round of items (26
// n-tiles: 13 items over 8 warps), and the selection computes each
// unordered pair in both directions. At the served stress layer (128,
// 10^4, 150) -> 150, k = 5, on an H100 SXM at 700 W the tiled layer's two
// launches take about 48 ms (select_stream, bound by its f32 adds and
// wgmma, which did not overlap: edgeconv_select.cuh) and 18 ms (the edge
// MLP); the one-launch kernel took 93 ms, 81% of its block cycles in the
// selection.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_FUSED_N = 1 << 14;  // the TPU package's fused bound
constexpr int MAX_WIDTH = 2048;   // widest edge-MLP layer, and the widest edge input 2C
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = 16;         // query rows per edge-MLP pass: one MMA row tile per slot
constexpr int WARP_TILES = 2;     // most 8-column n-tiles a warp takes at once
constexpr int B_STAGES = 4;       // depth of each warp's ring of B fragments
constexpr int RING_BYTES = WARPS * B_STAGES * WARP_TILES * 32 * 8;
constexpr int BUILD_LOADS = 8;    // x elements each thread loads at once for the edge rows

struct Params {
    const float* x;               // (B, N, C) f32
    float* out;                   // (B, N, dims[n_layers]) f32
    int* idx_out;                 // (B, N, k) i32 or null; the MLP launch's ids
    int B, N, C, k, n_chunks, n_layers;
    int window;                   // small-C key window (columns)
    // the layer table in device memory (fused_edgeconv_forward): layer l's
    // bf16 B fragments w[l], f32 bias[l] and widths dims[l] -> dims[l + 1]
    const uint2* const* w;
    const float* const* bias;     // each zero-padded to its width rounded up to 16
    const long long* dims;        // dims[0] = 2C
    const float* a;               // f32: final affine scale, padded as a bias
    const float* d;               // f32: final affine shift
    int in_stride;                // bf16 per row of the edge-input buffer
    int hid_stride;               // bf16 per row of the hidden-activation buffer
    const void* split;            // wide C: split_rows_kernel's output for the B N points
    size_t P;                     // B N
};

#ifdef PHASE_CLOCKS
__device__ unsigned long long g_phase[8];
#define PHASE_MARK(slot, since) do { __syncthreads(); if (threadIdx.x == 0) { \
    const long long now = clock64(); atomicAdd(&g_phase[slot], static_cast<unsigned long long>(now - since)); since = now; } } while (0)
#else
#define PHASE_MARK(slot, since) do { } while (0)
#endif

// Blocks per SM the registers are held to: two (128 registers a thread),
// so one block's selection overlaps another's edge MLP, except for the
// 16-dimension small-C selection, which would spill at 128.
template <bool SMALL_C, int CD> __host__ __device__ constexpr int min_blocks() {
    return SMALL_C && CD == SMALL_C_MAX ? 1 : 2;
}

// query rows per block
template <bool SMALL_C, bool TILED, int K> __host__ __device__ constexpr int block_rows() {
    return select_rows(SMALL_C, TILED, K);
}

__device__ __forceinline__ uint32_t trunc_bf16_bits(float v) {
    return __float_as_uint(v) >> 16;
}

// d += a (16 x 16, row) . b (16 x 8, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Layer l of the edge MLP on one slice: `in` holds SLICE * G rows of
// in_s bf16 (slot-major, G slots); a hidden layer writes relu(h + bias)
// truncated to bf16 into `out_buf` (rows of p.hid_stride, zero in the
// padded columns), the last layer the max over the slots of the affine into
// p.out for the queries n0 .. n0 + 15 of batch element b; with `merge`, the
// max also takes the value p.out holds (this thread wrote it for an earlier
// group of slots). Warp w takes the n-tiles
// w * tw .. w * tw + tw - 1, tw = ceil(NT / WARPS) <= WARP_TILES; its B
// fragments stream through its own B_STAGES-deep ring in shared memory
// (`ring`), each lane copying (cp.async) and reading back only its own
// 8 bytes a tile, so no barrier is needed.
template <int G>
__device__ __forceinline__ void mlp_layer(const Params& p, int l, const uint16_t* in, int in_s,
                                          uint16_t* out_buf, uint2* ring, int n0, int b,
                                          bool merge) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int dout = static_cast<int>(p.dims[l + 1]);
    const int KS = padded_depth(static_cast<int>(p.dims[l])) / DEPTH_STEP;
    const int NT = padded_depth(dout) / 8;
    // items of tw n-tiles, dealt to the warps in turn
    const int tw = min(WARP_TILES, (NT + WARPS - 1) / WARPS);
    const bool last = l + 1 == p.n_layers;
    ring += warp * B_STAGES * WARP_TILES * 32 + lane;
    const float* bias = p.bias[l];
    for (int nt0 = warp * tw; nt0 < NT; nt0 += WARPS * tw) {
        const int mine = min(tw, NT - nt0);       // this item's n-tiles
        const uint2* W = p.w[l] + static_cast<size_t>(nt0) * 32 + lane;
        auto issue = [&](int ks) {
            if (ks < KS) {
#pragma unroll
                for (int j = 0; j < WARP_TILES; ++j)
                    if (j < mine)
                        cp_async8(ring + ((ks % B_STAGES) * WARP_TILES + j) * 32,
                                  W + (static_cast<size_t>(ks) * NT + j) * 32);
            }
            cp_async_commit();
        };
#pragma unroll
        for (int s = 0; s < B_STAGES - 1; ++s) issue(s);

        float acc[G][WARP_TILES][4];
#pragma unroll
        for (int s = 0; s < G; ++s)
#pragma unroll
            for (int j = 0; j < WARP_TILES; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;

        // ldmatrix rows of slot 0's tile: rows lane % 16, depth (lane / 16) * 8
        const uint16_t* a_base = in + (lane % 16) * in_s + (lane / 16) * 8;
        for (int ks = 0; ks < KS; ++ks) {
            cp_async_wait<B_STAGES - 2>();        // step ks's fragments have landed
            uint2 bf[WARP_TILES];
#pragma unroll
            for (int j = 0; j < WARP_TILES; ++j)
                bf[j] = j < mine ? ring[((ks % B_STAGES) * WARP_TILES + j) * 32] : make_uint2(0u, 0u);
            issue(ks + B_STAGES - 1);             // into the stage read one step ago
#pragma unroll
            for (int s = 0; s < G; ++s) {
                unsigned a[4];
                ldmatrix_x4(a, a_base + s * SLICE * in_s + ks * DEPTH_STEP);
#pragma unroll
                for (int j = 0; j < WARP_TILES; ++j)
                    if (j < mine) mma_bf16(acc[s][j], a, bf[j].x, bf[j].y);
            }
        }

#pragma unroll
        for (int j = 0; j < WARP_TILES; ++j) {
            if (j >= mine) continue;
            const int col = (nt0 + j) * 8 + 2 * (lane % 4);  // and col + 1
            const float b0 = bias[col], b1 = bias[col + 1];
            if (!last) {
#pragma unroll
                for (int s = 0; s < G; ++s) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = s * SLICE + lane / 4 + 8 * h;
                        const uint32_t lo = trunc_bf16_bits(fmaxf(acc[s][j][2 * h] + b0, 0.f));
                        const uint32_t hi = trunc_bf16_bits(fmaxf(acc[s][j][2 * h + 1] + b1, 0.f));
                        *reinterpret_cast<uint32_t*>(out_buf + row * p.hid_stride + col) =
                            lo | (hi << 16);
                    }
                }
                continue;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = col + e % 2;
                const float bv = e % 2 ? b1 : b0, av = p.a[c], dv = p.d[c];
                float m = 0.f;
#pragma unroll
                for (int s = 0; s < G; ++s) {
                    const float h = fmaxf(acc[s][j][e] + bv, 0.f);
                    const float o = __fadd_rn(__fmul_rn(h, av), dv);
                    m = s == 0 ? o : fmaxf(m, o);
                }
                const int n = n0 + lane / 4 + 8 * (e / 2);
                if (n < p.N && c < dout) {
                    float* o = p.out + (static_cast<size_t>(b) * p.N + n) * dout + c;
                    *o = merge ? fmaxf(*o, m) : m;
                }
            }
        }
    }
}

// Phase 2 for the block's QB query rows, SLICE at a time and G slots at a
// time (all K for K <= 8): builds the edge rows [x_i ; x_j - x_i] (bf16,
// zero to the padded depth) of the slice's G slots in `work`, then runs the
// layers. Slot 0, and the slots past k of the K = 16 instance (which hold
// the query), take the query's own f32 row. K = 0: the ids are the
// selection launch's, (B, N, k) in device memory at sidx_block (row stride
// k, rows past N read as row N - 1), for any k, in ceil(k / G) groups.
template <int K, int QB, bool SMALL_C, int G = (K <= EXACT_K ? K : EXACT_K)>
__device__ void edge_mlp(const Params& p, const float* xb, const int* sidx_block,
                         int n0_block, unsigned char* work) {
    constexpr bool RUNTIME = K == 0;
    constexpr int R = SLICE * G;              // edge rows: row = slot * SLICE + query
    const int filled = RUNTIME ? p.k : filled_slots<K>(p.k);
    // the slots the groups cover: all K up to MAX_K, those below k above it
    const int slots = RUNTIME || K > MAX_K ? round_up(filled, G) : K;
    const int t = threadIdx.x, b = blockIdx.y;
    const int N = p.N, C = p.C, D0 = padded_depth(2 * C);
    uint16_t* buf_in = reinterpret_cast<uint16_t*>(work);
    uint16_t* buf_h = buf_in + R * max(p.in_stride, p.hid_stride);
    uint2* ring = reinterpret_cast<uint2*>(buf_h + R * p.hid_stride);
#ifdef PHASE_CLOCKS
    long long since = clock64();
#endif
    for (int slice = 0; slice < QB / SLICE; ++slice) {
        const int n0 = n0_block + slice * SLICE;
        if (n0 >= N) break;
        const int* sidx = sidx_block + slice * SLICE * K;
        const int last_q = min(SLICE, N - n0) - 1;    // RUNTIME: the slice's last row
        for (int g0 = 0; g0 < slots; g0 += G) {
            // every (row, c < C) element: BUILD_LOADS per thread at a time, all
            // loads issued before any store, so their L2 latencies overlap
            const int total = R * C;
            for (int e0 = 0; e0 < total; e0 += THREADS * BUILD_LOADS) {
                float qv[BUILD_LOADS], xv[BUILD_LOADS];
#pragma unroll
                for (int i = 0; i < BUILD_LOADS; ++i) {
                    const int e = e0 + i * THREADS + t;
                    if (e < total) {
                        const int r = e / C, c = e - r * C;
                        const int s = r / SLICE, qq = r % SLICE;
                        if constexpr (RUNTIME) {
                            const int* ids = sidx + min(qq, last_q) * p.k;
                            const int qid = __ldg(ids), slot = g0 + s;
                            qv[i] = __ldg(xb + static_cast<size_t>(qid) * C + c);
                            xv[i] = __ldg(xb + static_cast<size_t>(slot < filled ? __ldg(ids + slot)
                                                                                  : qid) * C + c);
                        } else {
                            qv[i] = __ldg(xb + static_cast<size_t>(sidx[qq * K]) * C + c);
                            xv[i] = __ldg(xb + static_cast<size_t>(sidx[qq * K + g0 + s]) * C + c);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < BUILD_LOADS; ++i) {
                    const int e = e0 + i * THREADS + t;
                    if (e < total) {
                        const int r = e / C, c = e - r * C;
                        const int slot = g0 + r / SLICE;
                        float nv = qv[i];         // slot 0: the query's own f32 row
                        if (slot > 0 && ((!RUNTIME && K <= EXACT_K) || slot < filled)) {
                            if (SMALL_C) {
                                nv = xv[i];
                            } else {
                                const float hi = trunc_bf16(xv[i]);
                                nv = p.n_chunks == 2 ? hi + trunc_bf16(xv[i] - hi) : hi;
                            }
                        }
                        buf_in[r * p.in_stride + c] = static_cast<uint16_t>(trunc_bf16_bits(qv[i]));
                        buf_in[r * p.in_stride + C + c] =
                            static_cast<uint16_t>(trunc_bf16_bits(nv - qv[i]));
                    }
                }
            }
            const int pad = D0 - 2 * C;               // zero depth past 2C
            for (int e = t; e < R * pad; e += THREADS) {
                const int r = e / pad;
                buf_in[r * p.in_stride + 2 * C + (e - r * pad)] = 0;
            }
            __syncthreads();
            PHASE_MARK(1, since);
            for (int l = 0; l < p.n_layers; ++l) {
                const uint16_t* in = l == 0 ? buf_in : (l % 2 ? buf_h : buf_in);
                mlp_layer<G>(p, l, in, l == 0 ? p.in_stride : p.hid_stride,
                             l % 2 ? buf_in : buf_h, ring, n0, b, g0 > 0);
                __syncthreads();
                PHASE_MARK(2 + l, since);
            }
        }
    }
}

// MLP = false: the selection alone (ids into p.idx_out): the first launch
// of a small-C layer the one-launch instances do not take (see
// fused_edgeconv_mlp_kernel), and for measuring the two phases apart.
template <int K, bool SMALL_C, bool TILED, int CD, bool MLP>
__global__ void __launch_bounds__(THREADS, min_blocks<SMALL_C, CD>())
fused_edgeconv_kernel(const Params p) {
    constexpr int QB = block_rows<SMALL_C, TILED, K>();
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx_block = reinterpret_cast<int*>(smem);                 // [QB][K]
    unsigned char* work = smem + header_bytes(QB, K);
    const int b = blockIdx.y, n0_block = blockIdx.x * QB, t = threadIdx.x;
    const int N = p.N, C = p.C;
    const float* xb = p.x + static_cast<size_t>(b) * N * C;
#ifdef PHASE_CLOCKS
    long long since = clock64();
#endif

    if constexpr (K == 1) {
        for (int e = t; e < QB; e += THREADS) sidx_block[e] = min(n0_block + e, N - 1);
    } else if constexpr (SMALL_C && K > MAX_K) {
        select_small_c_large<K, CD>(N, C, xb, n0_block, work, sidx_block, p.k);
    } else if constexpr (SMALL_C) {
        select_small_c<K, TILED, CD>(N, C, xb, n0_block, work, sidx_block, p.window, p.k);
    } else {
        select_wide_c<K, TILED, QB>(N, cloud_rows(p.split, p.P, C, 2, b, N), n0_block,
                                    work, sidx_block, p.k);
    }
    __syncthreads();

    if (p.idx_out != nullptr) {
        const int k = filled_slots<K>(p.k);
        for (int e = t; e < QB * k; e += THREADS) {
            const int q = e / k, s = e - q * k, n = n0_block + q;
            if (n < N) p.idx_out[(static_cast<size_t>(b) * N + n) * k + s] = sidx_block[q * K + s];
        }
    }
#ifdef PHASE_CLOCKS
    PHASE_MARK(0, since);
#endif
    if constexpr (MLP) edge_mlp<K, QB, SMALL_C>(p, xb, sidx_block, n0_block, work);
}

template <int K, bool SMALL_C, bool TILED, int CD, bool MLP>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
    auto kernel = fused_edgeconv_kernel<K, SMALL_C, TILED, CD, MLP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = block_rows<SMALL_C, TILED, K>();
    const dim3 grid((p.N + QB - 1) / QB, p.B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// The wide-C selection alone at any depth (select_wide_general): the first
// launch of a wide-C layer the one-launch instances do not take; ids into
// p.idx_out, the split rows in p.split.
template <int K, bool TILED>
__global__ void __launch_bounds__(THREADS, 2)
fused_edgeconv_select_kernel(const Params p) {
    constexpr int QB = block_rows<false, TILED, K>();
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx_block = reinterpret_cast<int*>(smem);                 // [QB][K]
    const int b = blockIdx.y, n0_block = blockIdx.x * QB, t = threadIdx.x, N = p.N;
    select_wide_c<K, TILED, QB, true>(N, cloud_rows(p.split, p.P, p.C, 2, b, N), n0_block,
                                      smem + header_bytes(QB, K), sidx_block, p.k);
    __syncthreads();
    const int k = filled_slots<K>(p.k);
    for (int e = t; e < QB * k; e += THREADS) {
        const int q = e / k, s = e - q * k, n = n0_block + q;
        if (n < N) p.idx_out[(static_cast<size_t>(b) * N + n) * k + s] = sidx_block[q * K + s];
    }
}

template <int K, bool TILED>
cudaError_t launch_select(const Params& p, size_t smem, cudaStream_t stream) {
    auto kernel = fused_edgeconv_select_kernel<K, TILED>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = block_rows<false, TILED, K>();
    const dim3 grid((p.N + QB - 1) / QB, p.B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// The tiled wide-C selection on Hopper (select_stream, edgeconv_select.cuh):
// the first launch of a column-tiled wide-C layer at k <= MAX_K, ids into
// a.ids; fused_edgeconv_mlp_kernel runs the edge MLP over them.
template <int K>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
fused_edgeconv_stream_kernel(const __grid_constant__ CUtensorMap rows, const StreamArgs a) {
    extern __shared__ unsigned char smem[];
    const long long cycles = select_stream<K, Rank<true>, 2, true>(
        &rows, a, blockIdx.y, blockIdx.x * STREAM_QB, smem);
#ifdef PHASE_CLOCKS
    if (threadIdx.x == 128) atomicAdd(&g_phase[0], static_cast<unsigned long long>(cycles));
#else
    (void)cycles;
#endif
}

// fused_edgeconv_stream_kernel at k (stream_fits(P, C, 2, k)), on the split
// rows in p.split
cudaError_t launch_stream_k(int k, const Params& p, cudaStream_t stream) {
    const StreamArgs a{p.idx_out, nullptr, p.N, p.C, p.k, p.P};
    switch (k) {
        case 2: return launch_stream(fused_edgeconv_stream_kernel<2>, p.split, a, p.B, 2, 2, stream);
        case 3: return launch_stream(fused_edgeconv_stream_kernel<3>, p.split, a, p.B, 2, 3, stream);
        case 4: return launch_stream(fused_edgeconv_stream_kernel<4>, p.split, a, p.B, 2, 4, stream);
        case 5: return launch_stream(fused_edgeconv_stream_kernel<5>, p.split, a, p.B, 2, 5, stream);
        case 6: return launch_stream(fused_edgeconv_stream_kernel<6>, p.split, a, p.B, 2, 6, stream);
        case 7: return launch_stream(fused_edgeconv_stream_kernel<7>, p.split, a, p.B, 2, 7, stream);
        case 8: return launch_stream(fused_edgeconv_stream_kernel<8>, p.split, a, p.B, 2, 8, stream);
        default:
            return launch_stream(fused_edgeconv_stream_kernel<MAX_K>, p.split, a, p.B, 2, MAX_K,
                                 stream);
    }
}

// CD: select_small_c's dimensions (small C), 0 for wide C. Above MAX_K one
// instance per capacity serves both tilings: its keys are 64-bit and its
// query rows do not depend on N.
template <bool SMALL_C, bool TILED, int CD, bool MLP = true>
cudaError_t launch_k(int k, const Params& p, size_t smem, cudaStream_t stream) {
    switch (k) {
        case 1: return launch<1, SMALL_C, TILED, SMALL_C ? 3 : 0, MLP>(p, smem, stream);
        case 2: return launch<2, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 3: return launch<3, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 4: return launch<4, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 5: return launch<5, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 6: return launch<6, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 7: return launch<7, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 8: return launch<8, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
            return launch<MAX_K, SMALL_C, TILED, CD, MLP>(p, smem, stream);
        default: break;
    }
    switch (instance_k(k)) {
        case 32: return launch<32, SMALL_C, false, CD, MLP>(p, smem, stream);
        case 64: return launch<64, SMALL_C, false, CD, MLP>(p, smem, stream);
        case LARGE_K_MAX: return launch<LARGE_K_MAX, SMALL_C, false, CD, MLP>(p, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The selection alone for the two-launch path at k <= LARGE_K_MAX: the K = 16
// instance serves every k <= 16 (it fills the first k slots), the capacity
// instances the rest; small C takes select_small_c(_large)
// (fused_edgeconv_kernel, MLP = false), wide C select_wide_general
// (fused_edgeconv_select_kernel), which takes any depth.
template <bool SMALL_C, bool TILED, int CD>
cudaError_t launch_select_k(int k, const Params& p, size_t smem, cudaStream_t stream) {
    if (k == 1) return launch<1, SMALL_C, TILED, SMALL_C ? 3 : 0, false>(p, smem, stream);
    const int K = instance_k(k < MAX_K ? MAX_K : k);
    if constexpr (!SMALL_C) {
        switch (K) {
            case MAX_K: return launch_select<MAX_K, TILED>(p, smem, stream);
            case 32: return launch_select<32, false>(p, smem, stream);
            case 64: return launch_select<64, false>(p, smem, stream);
            default: return launch_select<LARGE_K_MAX, false>(p, smem, stream);
        }
    } else {
        switch (K) {
            case MAX_K: return launch<MAX_K, SMALL_C, TILED, CD, false>(p, smem, stream);
            case 32: return launch<32, SMALL_C, false, CD, false>(p, smem, stream);
            case 64: return launch<64, SMALL_C, false, CD, false>(p, smem, stream);
            default: return launch<LARGE_K_MAX, SMALL_C, false, CD, false>(p, smem, stream);
        }
    }
}

// The second launch of a layer that one launch does not take: the edge MLP
// and max over the selection launch's ids (p.idx_out, (B, N, k)), one
// SLICE of query rows per block, G slots per group (the widest layers leave
// room for fewer: 8 up to 256 columns, then 4, 2, 1).
template <int G, bool SMALL_C>
__global__ void __launch_bounds__(THREADS, 2)
fused_edgeconv_mlp_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.y, n0 = blockIdx.x * SLICE;
    const float* xb = p.x + static_cast<size_t>(b) * p.N * p.C;
    edge_mlp<0, SLICE, SMALL_C, G>(p, xb, p.idx_out + (static_cast<size_t>(b) * p.N + n0) * p.k,
                                   n0, smem);
}

template <int G, bool SMALL_C>
cudaError_t launch_mlp(const Params& p, size_t smem, cudaStream_t stream) {
    auto kernel = fused_edgeconv_mlp_kernel<G, SMALL_C>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + SLICE - 1) / SLICE, p.B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool SMALL_C>
cudaError_t launch_mlp_g(int group, const Params& p, size_t smem, cudaStream_t stream) {
    if constexpr (!SMALL_C) {     // after select_stream: the group of the fused K <= 8 instance
        switch (group) {
            case 7: return launch_mlp<7, SMALL_C>(p, smem, stream);
            case 6: return launch_mlp<6, SMALL_C>(p, smem, stream);
            case 5: return launch_mlp<5, SMALL_C>(p, smem, stream);
            case 3: return launch_mlp<3, SMALL_C>(p, smem, stream);
            default: break;
        }
    }
    switch (group) {
        case 8: return launch_mlp<8, SMALL_C>(p, smem, stream);
        case 4: return launch_mlp<4, SMALL_C>(p, smem, stream);
        case 2: return launch_mlp<2, SMALL_C>(p, smem, stream);
        default: return launch_mlp<1, SMALL_C>(p, smem, stream);
    }
}

bool valid_input(int B, int N, int C, int k, size_t scratch_bytes) {
    return B >= 1 && B <= 65535 && N >= 1 && N <= MAX_FUSED_N && C >= 1 && k >= 1 && k <= N
           && scratch_bytes >= (C <= SMALL_C_MAX ? 0 : split_bytes(static_cast<size_t>(B) * N, C, 2));
}

// How a layer launches: one fused launch, or (split) a selection launch and
// an MLP launch of `group` slots per group; 0 launches where no plan fits.
struct Plan {
    int launches = 0;
    int group = 0;                // the MLP's slots per group
    bool tiled = false;
    bool stream = false;          // the selection launch is select_stream's
    int window = 0;               // small-C key window
    int in_stride = 0, hid_stride = 0;
    size_t smem = 0;              // the fused launch's, or the selection launch's
    size_t mlp_smem = 0;          // the MLP launch's
};

Plan make_plan(int N, int C, int k, int n_layers, const int* dim, int tile_n) {
    Plan plan;
    if (n_layers < 1 || dim[0] != 2 * C || 2 * C > MAX_WIDTH) return plan;
    int hidden = DEPTH_STEP;
    for (int l = 1; l <= n_layers; ++l) {
        if (dim[l] < 1 || dim[l] > MAX_WIDTH) return plan;
        if (l < n_layers && dim[l] > hidden) hidden = dim[l];
    }
    plan.in_stride = padded_depth(2 * C) + ROW_PAD;
    plan.hid_stride = padded_depth(hidden) + ROW_PAD;
    const size_t in_rows = plan.in_stride > plan.hid_stride ? plan.in_stride : plan.hid_stride;
    auto mlp_bytes = [&](int group) {
        return static_cast<size_t>(SLICE) * group * (in_rows + plan.hid_stride) * 2 + RING_BYTES;
    };
    const bool small_c = C <= SMALL_C_MAX;
    plan.tiled = N > MAX_N || tile_n > 0;
    plan.window = small_c ? small_c_window(N, C, tile_n) : 0;
    // the tiled wide-C layer at k <= MAX_K where select_stream fits: its
    // launch, then the edge MLP over its ids in the fused K <= 8 instance's
    // group (G = k) where that fits
    plan.stream = !small_c && plan.tiled && stream_fits(0, C, 2, k);
    const int exact = k <= EXACT_K ? k : EXACT_K;     // edge_mlp's slots per group
    if (plan.stream && mlp_bytes(exact) <= MAX_BLOCK_SMEM) plan.group = exact;
    if (!plan.stream && k <= LARGE_K_MAX && C <= WIDE_C_MAX) {
        const size_t sel = select_bytes(C, plan.tiled, plan.window, k);
        const size_t mlp = mlp_bytes(exact);
        plan.smem = header_bytes(select_rows(small_c, plan.tiled, instance_k(k)), instance_k(k))
                    + (sel > mlp ? sel : mlp);
        if (plan.smem <= MAX_BLOCK_SMEM) {
            plan.launches = 1;
            return plan;
        }
    }
    for (int group = EXACT_K; plan.group == 0 && group >= 1; group /= 2) {
        if (mlp_bytes(group) <= MAX_BLOCK_SMEM) plan.group = group;
    }
    if (plan.group == 0) return plan;
    plan.mlp_smem = mlp_bytes(plan.group);
    if (plan.stream) {
        plan.smem = stream_layout(C, 2, instance_k(k)).bytes;
    } else if (k > LARGE_K_MAX) {
        if (all_rows(N, C, small_c) < 1) return plan;
    } else {
        const int K = k == 1 ? 1 : instance_k(k < MAX_K ? MAX_K : k);
        const bool tiled = plan.tiled && K <= MAX_K;
        plan.smem = header_bytes(select_rows(small_c, tiled, K), K)
                    + select_bytes(C, tiled, plan.window, K);
        if (plan.smem > MAX_BLOCK_SMEM) return plan;
    }
    plan.launches = 2;
    return plan;
}

}  // namespace

// Bytes of the scratch fused_edgeconv_forward needs for (B, N, C): the
// split rows of the wide-C selection, none for small C.
extern "C" size_t fused_edgeconv_scratch_bytes(int B, int N, int C) {
    return C <= SMALL_C_MAX ? 0 : split_bytes(static_cast<size_t>(B) * N, C, 2);
}

// Kernel launches fused_edgeconv_forward makes for a layer of (N, C, k) and
// edge-MLP widths dims[0..n_layers] (dims[0] = 2C), split rows aside: 1 (the
// fused kernel), 2 (a selection launch, then the edge MLP over its ids in
// idx_out, which the caller must then pass: k > 128, C > 256, or layers too
// wide for the fused kernel's shared memory), or 0 where it takes no such
// layer (a width past 2048, k > N).
extern "C" int fused_edgeconv_launches(int N, int C, int k, int n_layers, const void* dims,
                                       int tile_n) {
    if (N < 1 || N > MAX_FUSED_N || C < 1 || k < 1 || k > N || tile_n < 0 || tile_n > MAX_N)
        return 0;
    return make_plan(N, C, k, n_layers, static_cast<const int*>(dims), tile_n).launches;
}

// Launches the fused EdgeConv on `stream`; `scratch` holds
// fused_edgeconv_scratch_bytes(B, N, C) bytes. `dims` (host) holds the
// widths dims[0..n_layers]; `table` (device memory) the layer table: n_layers
// pointers to each layer's weights, n_layers to its biases, then the
// n_layers + 1 widths, all 64-bit. Layer l's weights are its (dims[l],
// dims[l+1]) matrix rounded to bf16 and zero-padded to (Din, Dout) =
// (dims[l], dims[l+1]) rounded up to multiples of 16, in mma.sync
// B-fragment order: for 16-deep step ks < Din / 16, n-tile nt < Dout / 8
// (columns 8 nt .. 8 nt + 7) and lane L, 4 bf16 [r][e] (r, e in {0, 1}) =
// W[16 ks + 8 r + 2 (L % 4) + e][8 nt + L / 4], at ((ks * Dout / 8 + nt) *
// 32 + L) * 4. Biases and the final affine are f32, zero-padded to the
// layer's Dout. The tiled variants run when N > 2048 or when tile_n > 0
// (which also caps the small-C key window at tile_n columns, at most
// 2048); tile_n = 0 chooses by N. Where fused_edgeconv_launches is 2,
// idx_out (B, N, k) receives the ids and must not be null. Returns the CUDA
// error code (0 = ok); an argument the kernels do not take returns
// cudaErrorInvalidValue.
extern "C" int fused_edgeconv_forward(
        const void* x, void* out, void* idx_out, void* scratch, size_t scratch_bytes,
        int B, int N, int C, int k, int n_chunks, int n_layers, int tile_n,
        const void* dims, const void* table, const void* a, const void* d, void* stream) {
    const int* dim = static_cast<const int*>(dims);
    if (!valid_input(B, N, C, k, scratch_bytes) || tile_n < 0 || tile_n > MAX_N
            || (n_chunks != 1 && n_chunks != 2))
        return static_cast<int>(cudaErrorInvalidValue);
    const Plan plan = make_plan(N, C, k, n_layers, dim, tile_n);
    if (plan.launches == 0 || (plan.launches == 2 && idx_out == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.out = static_cast<float*>(out);
    p.idx_out = static_cast<int*>(idx_out);
    p.B = B; p.N = N; p.C = C; p.k = k; p.n_chunks = n_chunks; p.n_layers = n_layers;
    const long long* tab = static_cast<const long long*>(table);
    p.w = reinterpret_cast<const uint2* const*>(tab);
    p.bias = reinterpret_cast<const float* const*>(tab + n_layers);
    p.dims = tab + 2 * n_layers;
    p.a = static_cast<const float*>(a);
    p.d = static_cast<const float*>(d);
    p.in_stride = plan.in_stride;
    p.hid_stride = plan.hid_stride;
    p.split = scratch;
    p.P = static_cast<size_t>(B) * N;
    p.window = plan.window;

    const bool small_c = C <= SMALL_C_MAX;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!small_c && k > 1) {
        const cudaError_t err = launch_split<2>(p.x, p.P, C, scratch, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaError_t err;
    const bool tiled = plan.tiled;
    if (plan.launches == 1) {
        if (!small_c) {
            err = tiled ? launch_k<false, true, 0>(k, p, plan.smem, s)
                        : launch_k<false, false, 0>(k, p, plan.smem, s);
        } else if (small_c_dims(C) == 3) {
            err = tiled ? launch_k<true, true, 3>(k, p, plan.smem, s)
                        : launch_k<true, false, 3>(k, p, plan.smem, s);
        } else {
            err = tiled ? launch_k<true, true, SMALL_C_MAX>(k, p, plan.smem, s)
                        : launch_k<true, false, SMALL_C_MAX>(k, p, plan.smem, s);
        }
        return static_cast<int>(err);
    }
    if (plan.stream) {
        if (!stream_fits(p.P, C, 2, k)) return static_cast<int>(cudaErrorInvalidValue);
        err = launch_stream_k(k, p, s);
    } else if (k > LARGE_K_MAX) {
        err = launch_select_all(p.x, scratch, p.idx_out, B, N, C, k, s);
    } else if (!small_c) {
        err = tiled ? launch_select_k<false, true, 0>(k, p, plan.smem, s)
                    : launch_select_k<false, false, 0>(k, p, plan.smem, s);
    } else if (small_c_dims(C) == 3) {
        err = tiled ? launch_select_k<true, true, 3>(k, p, plan.smem, s)
                    : launch_select_k<true, false, 3>(k, p, plan.smem, s);
    } else {
        err = tiled ? launch_select_k<true, true, SMALL_C_MAX>(k, p, plan.smem, s)
                    : launch_select_k<true, false, SMALL_C_MAX>(k, p, plan.smem, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    err = small_c ? launch_mlp_g<true>(plan.group, p, plan.mlp_smem, s)
                  : launch_mlp_g<false>(plan.group, p, plan.mlp_smem, s);
    return static_cast<int>(err);
}

// The tiled wide-C variant's selection alone (phase 1 of the column-tiled
// fused layer, C > 16): ids (B, N, k) i32 into idx_out; for measuring the
// selection and the edge MLP apart. Returns the CUDA error code.
extern "C" int fused_edgeconv_select(const void* x, void* idx_out, void* scratch,
                                     size_t scratch_bytes, int B, int N, int C, int k,
                                     void* stream) {
    if (!valid_input(B, N, C, k, scratch_bytes) || C <= SMALL_C_MAX || C > WIDE_C_MAX
            || k > LARGE_K_MAX || idx_out == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.idx_out = static_cast<int*>(idx_out);
    p.B = B; p.N = N; p.C = C; p.k = k;
    p.split = scratch;
    p.P = static_cast<size_t>(B) * N;
    const size_t smem = header_bytes(select_rows(false, true, instance_k(k)), instance_k(k))
                        + select_bytes(C, true, 0, k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (k > 1) {
        const cudaError_t err = launch_split<2>(p.x, p.P, C, scratch, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (stream_fits(p.P, C, 2, k)) return static_cast<int>(launch_stream_k(k, p, s));
    return static_cast<int>(launch_k<false, true, 0, false>(k, p, smem, s));
}

#ifdef PHASE_CLOCKS
// Sums of each phase's cycles over blocks (thread 0's clock): selection,
// edge rows, layers 0..; read and cleared.
extern "C" int fused_edgeconv_phase_clocks(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
    if (err != cudaSuccess) return static_cast<int>(err);
    unsigned long long zero[8] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase)));
}
#endif
