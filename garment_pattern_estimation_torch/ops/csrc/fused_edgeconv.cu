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
// folded BatchNorm affine h * a + d, then the max over the k slots.
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
//   phase 1  small C: keys pass through shared memory in windows of up to
//            2048 columns, each query's 16 threads keep their best k-1 in
//            registers and merge them with half-warp shuffles (16 query
//            rows per block). Wide C: select_wide_c, the split products on
//            bf16 tensor cores (mma.sync) from rows split once per point by
//            split_rows_kernel (launched first, into the caller's scratch),
//            key units double-buffered with cp.async and an early reject
//            before each insert; 16 query rows per block up to 2048 points,
//            64 in the tiled variant, which streams a whole cloud per block;
//   phase 2  16 query rows at a time (four slices of the tiled wide-C
//            block): the 16 k edge rows go through the layers with their
//            bf16 activations in shared memory (ping-pong buffers) and the
//            weights read from global memory (L1/L2); each thread owns
//            4 queries x k slots x 4 columns, so the max over the slots
//            stays in registers.
// What bounds it now: with the selection on tensor cores (stress conv1:
// about 40 ms of the tiled wide-C kernel), phase 2's edge MLP on the CUDA
// cores in f32 is most of every variant's time. Left on the table: the
// edge MLP on bf16 tensor cores (rows 4-7 share phase 2), the weights
// staged in shared memory, layers narrower than 256 leaving threads idle,
// the small-C key windows not prefetched, and each unordered pair's
// distance computed in both directions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edgeconv_select.cuh"

namespace {

using namespace knn_select;

constexpr int MAX_LAYERS = 4;
constexpr int MAX_FUSED_N = 1 << 14;  // the TPU package's fused bound
constexpr int MAX_WIDTH = 256;    // 64 column groups x 4 columns
constexpr int COL_GROUPS = 64;
constexpr int ROW_GROUPS = THREADS / COL_GROUPS;   // 4 row groups of 4 queries

struct Params {
    const float* x;               // (B, N, C) f32
    float* out;                   // (B, N, dims[n_layers]) f32
    int* idx_out;                 // (B, N, k) i32 or null
    int B, N, C, n_chunks, n_layers;
    int window;                   // small-C key window (columns)
    int dims[MAX_LAYERS + 1];     // dims[0] = 2C
    const uint16_t* w[MAX_LAYERS];  // bf16 (dims[l], 256), column c at [c % 64][c / 64]
    const float* bias[MAX_LAYERS];  // f32 (256,)
    const float* a;               // f32 (256,): final affine scale
    const float* d;               // f32 (256,): final affine shift
    int act_stride;               // bf16 elements per activation row (16 k + 4)
    int act_rows;                 // rows of each activation buffer: max layer width
    const void* split;            // wide C: split_rows_kernel's output for the B N points
    size_t P;                     // B N
};

__device__ __forceinline__ uint16_t trunc_bf16_bits(float v) {
    return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
}

template <int K, bool SMALL_C, bool TILED>
__global__ void __launch_bounds__(THREADS)
fused_edgeconv_kernel(const Params p) {
    // query rows per block: WIDE_QB for the tiled wide-C variant, which
    // streams a whole cloud's keys per block, else TM
    constexpr int QB = (!SMALL_C && TILED) ? WIDE_QB : TM;
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx_block = reinterpret_cast<int*>(smem);                 // [QB][K]
    unsigned char* work = smem + QB * MAX_K * 4;
    const int b = blockIdx.y, n0_block = blockIdx.x * QB, t = threadIdx.x;
    const int N = p.N, C = p.C;
    const float* xb = p.x + static_cast<size_t>(b) * N * C;

    if constexpr (K == 1) {
        if (t < QB) sidx_block[t] = min(n0_block + t, N - 1);
    } else if constexpr (SMALL_C) {
        select_small_c<K, TILED>(N, C, xb, n0_block, reinterpret_cast<float*>(work),
                                 sidx_block, p.window);
    } else {
        select_wide_c<K, TILED, QB>(N, cloud_rows(p.split, p.P, C, 2, b, N), n0_block,
                                    work, sidx_block);
    }
    __syncthreads();

    if (p.idx_out != nullptr) {
        for (int e = t; e < QB * K; e += THREADS) {
            const int n = n0_block + e / K;
            if (n < N) p.idx_out[(static_cast<size_t>(b) * N + n) * K + e % K] = sidx_block[e];
        }
    }

    // ---- phase 2: edge MLP on [x_i ; x_j - x_i] + max over the k slots, TM
    // query rows (one slice of the block) at a time ----
    constexpr int R = TM * K;                 // edge rows: row = query * K + slot
    constexpr int RT = R / ROW_GROUPS;        // rows per thread: 4 queries x K
    const int S = p.act_stride;
    for (int slice = 0; slice < QB / TM; ++slice) {
        const int n0 = n0_block + slice * TM;
        if (n0 >= N) break;
        const int* sidx = sidx_block + slice * TM * K;
        uint16_t* act_in = reinterpret_cast<uint16_t*>(work);          // [width][S]
        uint16_t* act_out = act_in + p.act_rows * S;

        for (int e = t; e < R * C; e += THREADS) {
            const int r = e / C, c = e - r * C;
            const int qq = r / K, s = r - qq * K;
            const float qv = xb[sidx[qq * K] * C + c];
            float nv = qv;                        // slot 0: the query's own f32 row
            if (s > 0) {
                const float v = xb[sidx[qq * K + s] * C + c];
                if (SMALL_C) {
                    nv = v;
                } else {
                    const float hi = trunc_bf16(v);
                    nv = p.n_chunks == 2 ? hi + trunc_bf16(v - hi) : hi;
                }
            }
            act_in[c * S + r] = trunc_bf16_bits(qv);
            act_in[(C + c) * S + r] = trunc_bf16_bits(nv - qv);
        }
        __syncthreads();

        const int cg = t % COL_GROUPS, rg = t / COL_GROUPS;
        for (int l = 0; l < p.n_layers; ++l) {
            const int din = p.dims[l], dout = p.dims[l + 1];
            const uint16_t* W = p.w[l];
            float acc[RT][4];
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
                for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;

            for (int i = 0; i < din; ++i) {
                const uint2 wv = *reinterpret_cast<const uint2*>(W + i * MAX_WIDTH + cg * 4);
                const float w[4] = {bf16_bits_to_float(wv.x & 0xFFFFu), bf16_bits_to_float(wv.x >> 16),
                                    bf16_bits_to_float(wv.y & 0xFFFFu), bf16_bits_to_float(wv.y >> 16)};
                const uint2* arow = reinterpret_cast<const uint2*>(act_in + i * S + rg * RT);
#pragma unroll
                for (int rr = 0; rr < RT / 4; ++rr) {
                    const uint2 av = arow[rr];
                    const float a4[4] = {bf16_bits_to_float(av.x & 0xFFFFu), bf16_bits_to_float(av.x >> 16),
                                         bf16_bits_to_float(av.y & 0xFFFFu), bf16_bits_to_float(av.y >> 16)};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            acc[rr * 4 + e][u] = fmaf(a4[e], w[u], acc[rr * 4 + e][u]);
                }
            }

            const bool last = l + 1 == p.n_layers;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int col = cg + COL_GROUPS * u;
                if (col >= dout) continue;
                const float bias = p.bias[l][col];
                if (!last) {
#pragma unroll
                    for (int r = 0; r < RT; ++r)
                        act_out[col * S + rg * RT + r] = trunc_bf16_bits(fmaxf(acc[r][u] + bias, 0.f));
                    continue;
                }
                const float av = p.a[col], dv = p.d[col];
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                    float m = 0.f;
#pragma unroll
                    for (int s = 0; s < K; ++s) {
                        const float h = fmaxf(acc[qq * K + s][u] + bias, 0.f);
                        const float o = __fadd_rn(__fmul_rn(h, av), dv);
                        m = s == 0 ? o : fmaxf(m, o);
                    }
                    const int n = n0 + rg * 4 + qq;
                    if (n < N) p.out[(static_cast<size_t>(b) * N + n) * dout + col] = m;
                }
            }
            __syncthreads();
            uint16_t* tmp = act_in;
            act_in = act_out;
            act_out = tmp;
        }
    }
}

template <int K, bool SMALL_C, bool TILED>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
    auto kernel = fused_edgeconv_kernel<K, SMALL_C, TILED>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    constexpr int QB = (!SMALL_C && TILED) ? WIDE_QB : TM;
    const dim3 grid((p.N + QB - 1) / QB, p.B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool SMALL_C, bool TILED>
cudaError_t launch_k(int k, const Params& p, size_t smem, cudaStream_t stream) {
    switch (k) {
        case 1: return launch<1, SMALL_C, TILED>(p, smem, stream);
        case 2: return launch<2, SMALL_C, TILED>(p, smem, stream);
        case 3: return launch<3, SMALL_C, TILED>(p, smem, stream);
        case 4: return launch<4, SMALL_C, TILED>(p, smem, stream);
        case 5: return launch<5, SMALL_C, TILED>(p, smem, stream);
        case 6: return launch<6, SMALL_C, TILED>(p, smem, stream);
        case 7: return launch<7, SMALL_C, TILED>(p, smem, stream);
        case 8: return launch<8, SMALL_C, TILED>(p, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Bytes of the scratch fused_edgeconv_forward needs for (B, N, C): the
// split rows of the wide-C selection, none for small C.
extern "C" size_t fused_edgeconv_scratch_bytes(int B, int N, int C) {
    return C <= SMALL_C_MAX ? 0 : split_bytes(static_cast<size_t>(B) * N, C, 2);
}

// Launches the fused EdgeConv on `stream`; `scratch` holds
// fused_edgeconv_scratch_bytes(B, N, C) bytes. Weights are bf16 (dims[l], 256)
// with column c stored at [c % 64][c / 64], zero beyond dims[l+1]; biases
// and the final affine are f32 (256,). The tiled variants run when
// N > 2048 or when tile_n > 0 (which also sets the small-C key window, at
// most 2048 columns); tile_n = 0 chooses by N. Returns the CUDA error code
// (0 = ok); an argument the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int fused_edgeconv_forward(
        const void* x, void* out, void* idx_out, void* scratch, size_t scratch_bytes,
        int B, int N, int C, int k, int n_chunks, int n_layers, int tile_n,
        const void* dims, const void* weights, const void* biases,
        const void* a, const void* d, void* stream) {
    const int* dim = static_cast<const int*>(dims);
    if (B < 1 || N < 1 || N > MAX_FUSED_N || C < 1 || C > WIDE_C_MAX || k < 1
            || k > MAX_K || k > N || n_layers < 1 || n_layers > MAX_LAYERS
            || tile_n < 0 || tile_n > MAX_N
            || (n_chunks != 1 && n_chunks != 2) || dim[0] != 2 * C
            || scratch_bytes < fused_edgeconv_scratch_bytes(B, N, C))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.x = static_cast<const float*>(x);
    p.out = static_cast<float*>(out);
    p.idx_out = static_cast<int*>(idx_out);
    p.B = B; p.N = N; p.C = C; p.n_chunks = n_chunks; p.n_layers = n_layers;
    int width = 0;
    for (int l = 0; l <= n_layers; ++l) {
        p.dims[l] = dim[l];
        if (dim[l] < 1 || (l > 0 && dim[l] > MAX_WIDTH))
            return static_cast<int>(cudaErrorInvalidValue);
        width = dim[l] > width ? dim[l] : width;
    }
    for (int l = 0; l < n_layers; ++l) {
        p.w[l] = static_cast<const uint16_t* const*>(weights)[l];
        p.bias[l] = static_cast<const float* const*>(biases)[l];
    }
    p.a = static_cast<const float*>(a);
    p.d = static_cast<const float*>(d);
    p.act_stride = TM * k + 4;
    p.act_rows = width;
    p.split = scratch;
    p.P = static_cast<size_t>(B) * N;

    const bool small_c = C <= SMALL_C_MAX;
    const bool tiled = N > MAX_N || tile_n > 0;
    p.window = small_c_window(N, C, tiled, tile_n);
    const size_t sel_bytes = select_bytes(N, C, tiled, p.window);
    const size_t mlp_bytes = 2 * static_cast<size_t>(width) * p.act_stride * 2;
    const size_t header = (!small_c && tiled ? WIDE_QB : TM) * MAX_K * 4;
    const size_t smem = header + (sel_bytes > mlp_bytes ? sel_bytes : mlp_bytes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!small_c && k > 1) {
        const cudaError_t err = launch_split<2>(p.x, p.P, C, scratch, s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const cudaError_t err =
        small_c ? (tiled ? launch_k<true, true>(k, p, smem, s) : launch_k<true, false>(k, p, smem, s))
                : (tiled ? launch_k<false, true>(k, p, smem, s) : launch_k<false, false>(k, p, smem, s));
    return static_cast<int>(err);
}
