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
//            caller's scratch); 16 query rows per block up to 2048 points,
//            64 in the tiled variant, which streams a whole cloud per block;
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
// (from L2 where L1 misses), wgmma and TMA are not used (mma.sync issues
// at a fraction of the wgmma rate), warps idle in a layer's last round of
// items (26 n-tiles: 13 items over 8 warps), and the selection computes
// each unordered pair in both directions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_LAYERS = 4;
constexpr int MAX_FUSED_N = 1 << 14;  // the TPU package's fused bound
constexpr int MAX_WIDTH = 256;    // widest edge-MLP layer
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = 16;         // query rows per edge-MLP pass: one MMA row tile per slot
constexpr int WARP_TILES = 2;     // most 8-column n-tiles a warp takes at once
constexpr int B_STAGES = 4;       // depth of each warp's ring of B fragments
constexpr int RING_BYTES = WARPS * B_STAGES * WARP_TILES * 32 * 8;
constexpr int BUILD_LOADS = 8;    // x elements each thread loads at once for the edge rows

struct Params {
    const float* x;               // (B, N, C) f32
    float* out;                   // (B, N, dims[n_layers]) f32
    int* idx_out;                 // (B, N, k) i32 or null
    int B, N, C, k, n_chunks, n_layers;
    int window;                   // small-C key window (columns)
    int dims[MAX_LAYERS + 1];     // dims[0] = 2C
    const uint2* w[MAX_LAYERS];   // bf16 B fragments, see fused_edgeconv_forward
    const float* bias[MAX_LAYERS];  // f32 (256,)
    const float* a;               // f32 (256,): final affine scale
    const float* d;               // f32 (256,): final affine shift
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
    const int dout = p.dims[l + 1];
    const int KS = padded_depth(p.dims[l]) / DEPTH_STEP;
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
// the query), take the query's own f32 row.
template <int K, int QB, bool SMALL_C>
__device__ void edge_mlp(const Params& p, const float* xb, const int* sidx_block,
                         int n0_block, unsigned char* work) {
    constexpr int G = K <= EXACT_K ? K : EXACT_K;    // slots per group
    constexpr int R = SLICE * G;              // edge rows: row = slot * SLICE + query
    const int filled = filled_slots<K>(p.k);
    // the slots the groups cover: all K up to MAX_K, those below k above it
    const int slots = K > MAX_K ? round_up(filled, G) : K;
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
                        qv[i] = __ldg(xb + static_cast<size_t>(sidx[qq * K]) * C + c);
                        xv[i] = __ldg(xb + static_cast<size_t>(sidx[qq * K + g0 + s]) * C + c);
                    }
                }
#pragma unroll
                for (int i = 0; i < BUILD_LOADS; ++i) {
                    const int e = e0 + i * THREADS + t;
                    if (e < total) {
                        const int r = e / C, c = e - r * C;
                        const int slot = g0 + r / SLICE;
                        float nv = qv[i];         // slot 0: the query's own f32 row
                        if (slot > 0 && (K <= EXACT_K || slot < filled)) {
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
                             l % 2 ? buf_in : buf_h, ring, n0, b, K > G && g0 > 0);
                __syncthreads();
                PHASE_MARK(2 + l, since);
            }
        }
    }
}

// MLP = false: the selection alone (ids into p.idx_out), for measuring the
// two phases apart.
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

bool valid_input(int B, int N, int C, int k, size_t scratch_bytes) {
    return B >= 1 && N >= 1 && N <= MAX_FUSED_N && C >= 1 && C <= WIDE_C_MAX && k >= 1
           && k <= LARGE_K_MAX && k <= N
           && scratch_bytes >= (C <= SMALL_C_MAX ? 0 : split_bytes(static_cast<size_t>(B) * N, C, 2));
}

}  // namespace

// Bytes of the scratch fused_edgeconv_forward needs for (B, N, C): the
// split rows of the wide-C selection, none for small C.
extern "C" size_t fused_edgeconv_scratch_bytes(int B, int N, int C) {
    return C <= SMALL_C_MAX ? 0 : split_bytes(static_cast<size_t>(B) * N, C, 2);
}

// Launches the fused EdgeConv on `stream`; `scratch` holds
// fused_edgeconv_scratch_bytes(B, N, C) bytes. weights[l] holds layer l's
// (dims[l], dims[l+1]) matrix rounded to bf16 and zero-padded to
// (Din, Dout) = (dims[l], dims[l+1]) rounded up to multiples of 16, in
// mma.sync B-fragment order: for 16-deep step ks < Din / 16, n-tile
// nt < Dout / 8 (columns 8 nt .. 8 nt + 7) and lane L, 4 bf16 [r][e]
// (r, e in {0, 1}) = W[16 ks + 8 r + 2 (L % 4) + e][8 nt + L / 4], at
// ((ks * Dout / 8 + nt) * 32 + L) * 4. Biases and the final affine are
// f32 (256,), zero beyond the layer's width. The tiled variants run when
// N > 2048 or when tile_n > 0 (which also caps the small-C key window at
// tile_n columns, at most 2048); tile_n = 0 chooses by N. Returns the CUDA
// error code (0 = ok); an argument the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int fused_edgeconv_forward(
        const void* x, void* out, void* idx_out, void* scratch, size_t scratch_bytes,
        int B, int N, int C, int k, int n_chunks, int n_layers, int tile_n,
        const void* dims, const void* weights, const void* biases,
        const void* a, const void* d, void* stream) {
    const int* dim = static_cast<const int*>(dims);
    if (!valid_input(B, N, C, k, scratch_bytes) || n_layers < 1 || n_layers > MAX_LAYERS
            || tile_n < 0 || tile_n > MAX_N || (n_chunks != 1 && n_chunks != 2)
            || dim[0] != 2 * C)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.out = static_cast<float*>(out);
    p.idx_out = static_cast<int*>(idx_out);
    p.B = B; p.N = N; p.C = C; p.k = k; p.n_chunks = n_chunks; p.n_layers = n_layers;
    int hidden = DEPTH_STEP;
    for (int l = 0; l <= n_layers; ++l) {
        p.dims[l] = dim[l];
        if (dim[l] < 1 || (l > 0 && dim[l] > MAX_WIDTH))
            return static_cast<int>(cudaErrorInvalidValue);
        if (l > 0 && l < n_layers && dim[l] > hidden) hidden = dim[l];
    }
    for (int l = 0; l < n_layers; ++l) {
        p.w[l] = static_cast<const uint2* const*>(weights)[l];
        p.bias[l] = static_cast<const float* const*>(biases)[l];
    }
    p.a = static_cast<const float*>(a);
    p.d = static_cast<const float*>(d);
    p.in_stride = padded_depth(2 * C) + ROW_PAD;
    p.hid_stride = padded_depth(hidden) + ROW_PAD;
    p.split = scratch;
    p.P = static_cast<size_t>(B) * N;

    const bool small_c = C <= SMALL_C_MAX;
    const bool tiled = N > MAX_N || tile_n > 0;
    p.window = small_c ? small_c_window(N, C, tile_n) : 0;
    const size_t sel_bytes = select_bytes(C, tiled, p.window, k);
    const int in_rows = p.in_stride > p.hid_stride ? p.in_stride : p.hid_stride;
    const int group = k <= EXACT_K ? k : EXACT_K;    // edge_mlp's slots per group
    const size_t mlp_bytes = static_cast<size_t>(SLICE) * group * (in_rows + p.hid_stride) * 2
                             + RING_BYTES;
    const size_t header = header_bytes(select_rows(small_c, tiled, instance_k(k)),
                                       instance_k(k));
    const size_t smem = header + (sel_bytes > mlp_bytes ? sel_bytes : mlp_bytes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!small_c && k > 1) {
        const cudaError_t err = launch_split<2>(p.x, p.P, C, scratch, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaError_t err;
    if (!small_c) {
        err = tiled ? launch_k<false, true, 0>(k, p, smem, s)
                    : launch_k<false, false, 0>(k, p, smem, s);
    } else if (small_c_dims(C) == 3) {
        err = tiled ? launch_k<true, true, 3>(k, p, smem, s)
                    : launch_k<true, false, 3>(k, p, smem, s);
    } else {
        err = tiled ? launch_k<true, true, SMALL_C_MAX>(k, p, smem, s)
                    : launch_k<true, false, SMALL_C_MAX>(k, p, smem, s);
    }
    return static_cast<int>(err);
}

// The tiled wide-C variant's selection alone (phase 1 of the column-tiled
// fused layer, C > 16): ids (B, N, k) i32 into idx_out; for measuring the
// selection and the edge MLP apart. Returns the CUDA error code.
extern "C" int fused_edgeconv_select(const void* x, void* idx_out, void* scratch,
                                     size_t scratch_bytes, int B, int N, int C, int k,
                                     void* stream) {
    if (!valid_input(B, N, C, k, scratch_bytes) || C <= SMALL_C_MAX || idx_out == nullptr)
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
