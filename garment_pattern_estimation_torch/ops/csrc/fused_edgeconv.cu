// Fused dynamic EdgeConv for Hopper (sm_90a): kNN selection + neighbour
// gather + folded-BN edge MLP + max over the k neighbours, in one kernel.
//
// Replaces the TPU kernel garment_pattern_estimation_tpu/ops/edgeconv.py:
// _fused_kernel (single tile, N <= 2048) in both of its variants:
//   SMALL_C = true   C <= 16 (the raw-xyz layer): exact f32 distances summed
//                    per dimension, exact gathered rows;
//   SMALL_C = false  16 < C <= 256: distances q_norm + k_norm - 2 * cross,
//                    cross from the three bf16 truncation-split products
//                    hi.hi + hi.lo + lo.hi; gathered rows hi + lo (f32 mode)
//                    or hi (bf16 mode).
// The plain PyTorch version with the same numerics is
// ops/edgeconv.py: fused_edgeconv_reference.
//
// Selection: packed int32 values (distance bits with the low 11 bits
// replaced by the column), self column excluded and put into slot 0, the
// k-1 smallest packed values fill slots 1..k-1 (ties to the lower column).
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
// distances never reach device memory.
//
// The design is the simple one. One block of 256 threads per (batch
// element, 16 query rows):
//   phase 1  keys pass through shared memory (all of them for small C,
//            128-key tiles for wide C); each query's 16 threads keep
//            their best k-1 packed values in registers and merge them
//            with half-warp shuffles;
//   phase 2  the 16 k edge rows go through the layers with their bf16
//            activations in shared memory (ping-pong buffers) and the
//            weights read from global memory (L1/L2); each thread owns
//            4 queries x k slots x 4 columns, so the max over the slots
//            stays in registers.
// Left on the table: every product runs on the CUDA cores in f32 instead
// of bf16 wgmma / mma.sync (the split products are exact bf16 products by
// construction), the weights are not staged in shared memory, layers
// narrower than 256 leave threads idle, and key tiles are not prefetched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int MAX_LAYERS = 4;
constexpr int MAX_WIDTH = 256;    // 64 column groups x 4 columns
constexpr int COL_GROUPS = 64;
constexpr int ROW_GROUPS = THREADS / COL_GROUPS;   // 4 row groups of 4 queries
constexpr int MAX_K = 8;
constexpr int HEADER_BYTES = TM * MAX_K * 4;       // the selected neighbour ids

struct Params {
    const float* x;               // (B, N, C) f32
    float* out;                   // (B, N, dims[n_layers]) f32
    int* idx_out;                 // (B, N, k) i32 or null
    int B, N, C, n_chunks, n_layers;
    int dims[MAX_LAYERS + 1];     // dims[0] = 2C
    const uint16_t* w[MAX_LAYERS];  // bf16 (dims[l], 256), column c at [c % 64][c / 64]
    const float* bias[MAX_LAYERS];  // f32 (256,)
    const float* a;               // f32 (256,): final affine scale
    const float* d;               // f32 (256,): final affine shift
    int act_stride;               // bf16 elements per activation row (16 k + 4)
    int act_rows;                 // rows of each activation buffer: max layer width
};

__device__ __forceinline__ float trunc_bf16(float v) {
    return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

__device__ __forceinline__ uint16_t trunc_bf16_bits(float v) {
    return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
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

template <int K>
__device__ void select_small_c(const Params& p, const float* xb, int n0,
                               float* keys, int* sidx) {
    const int N = p.N, C = p.C, t = threadIdx.x;
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

template <int K>
__device__ void select_wide_c(const Params& p, const float* xb, int n0,
                              float* work, int* sidx) {
    const int N = p.N, C = p.C, t = threadIdx.x;
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

template <int K, bool SMALL_C>
__global__ void __launch_bounds__(THREADS)
fused_edgeconv_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* sidx = reinterpret_cast<int*>(smem);                       // [TM][K]
    unsigned char* work = smem + HEADER_BYTES;
    const int b = blockIdx.y, n0 = blockIdx.x * TM, t = threadIdx.x;
    const int N = p.N, C = p.C;
    const float* xb = p.x + static_cast<size_t>(b) * N * C;

    if constexpr (K == 1) {
        if (t < TM) sidx[t] = min(n0 + t, N - 1);
    } else if constexpr (SMALL_C) {
        select_small_c<K>(p, xb, n0, reinterpret_cast<float*>(work), sidx);
    } else {
        select_wide_c<K>(p, xb, n0, reinterpret_cast<float*>(work), sidx);
    }
    __syncthreads();

    if (p.idx_out != nullptr && t < TM * K) {
        const int n = n0 + t / K;
        if (n < N) p.idx_out[(static_cast<size_t>(b) * N + n) * K + t % K] = sidx[t];
    }

    // ---- phase 2: edge MLP on [x_i ; x_j - x_i] + max over the k slots ----
    constexpr int R = TM * K;                 // edge rows: row = query * K + slot
    constexpr int RT = R / ROW_GROUPS;        // rows per thread: 4 queries x K
    const int S = p.act_stride;
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

size_t align16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

template <int K, bool SMALL_C>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
    auto kernel = fused_edgeconv_kernel<K, SMALL_C>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + TM - 1) / TM, p.B);
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool SMALL_C>
cudaError_t launch_k(int k, const Params& p, size_t smem, cudaStream_t stream) {
    switch (k) {
        case 1: return launch<1, SMALL_C>(p, smem, stream);
        case 2: return launch<2, SMALL_C>(p, smem, stream);
        case 3: return launch<3, SMALL_C>(p, smem, stream);
        case 4: return launch<4, SMALL_C>(p, smem, stream);
        case 5: return launch<5, SMALL_C>(p, smem, stream);
        case 6: return launch<6, SMALL_C>(p, smem, stream);
        case 7: return launch<7, SMALL_C>(p, smem, stream);
        case 8: return launch<8, SMALL_C>(p, smem, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Launches the fused EdgeConv on `stream`. Weights are bf16 (dims[l], 256)
// with column c stored at [c % 64][c / 64], zero beyond dims[l+1]; biases
// and the final affine are f32 (256,). Returns the CUDA error code (0 = ok);
// an argument the kernel does not take returns cudaErrorInvalidValue.
extern "C" int fused_edgeconv_forward(
        const void* x, void* out, void* idx_out,
        int B, int N, int C, int k, int n_chunks, int n_layers,
        const void* dims, const void* weights, const void* biases,
        const void* a, const void* d, void* stream) {
    const int* dim = static_cast<const int*>(dims);
    if (B < 1 || N < 1 || N > MAX_N || C < 1 || C > WIDE_C_MAX || k < 1 || k > MAX_K
            || k > N || n_layers < 1 || n_layers > MAX_LAYERS
            || (n_chunks != 1 && n_chunks != 2) || dim[0] != 2 * C)
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

    const bool small_c = C <= SMALL_C_MAX;
    size_t select_bytes = 0;
    if (small_c) {
        select_bytes = static_cast<size_t>(C) * N * 4;
    } else {
        select_bytes = align16(static_cast<size_t>(C) * KT_STRIDE * 4)
                       + 2 * static_cast<size_t>(C) * TM * 4 + TM * 4 + TM * KT * 4;
    }
    const size_t mlp_bytes = 2 * static_cast<size_t>(width) * p.act_stride * 2;
    const size_t smem = HEADER_BYTES + (select_bytes > mlp_bytes ? select_bytes : mlp_bytes);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = small_c ? launch_k<true>(k, p, smem, s)
                                    : launch_k<false>(k, p, smem, s);
    return static_cast<int>(err);
}
