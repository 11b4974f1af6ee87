// K9 and K10b: the device tail's strain stats and coordinate-median polish
// for Hopper (sm_90a).
//
// K9 replaces the JAX package's _tail_stats (pantax_tpu/ops/profile_tail.py
// :167), a jitted program of segment sums that XLA compiles.  From the
// fused pipeline's node abundance na, trio abundance ta and covered bases
// bc it computes, in one launch:
//   per hap g:     c1 (its nonzero trios), freq_mean (the zscore(3)-filtered
//                  mean of its nonzero trios: mean, then the deviations,
//                  then the kept set) and path_cov (bc summed over its
//                  path, an integer sum, then float32);
//   per species s: the nonzero count and sum of the min_depth-clamped na,
//                  sp_max (the largest na) and sp_valid (na > 0).
// The plain torch version (pantax_tpu_torch/ops/profile_tail.py,
// tail_stats_plain) runs ~40 launches of index_put_ sums.
//
// What bounds it: bytes.  Each input is read once (na over the species'
// node spans, ta, the owner order, the path nodes and their bc), a few MB
// at the smoke DB, and the arithmetic is a few instructions an element.  What keeps it
// from the bound is that a hap's three passes over its trios depend on
// each other (the mean before the deviations, sigma before the kept set).
//
// Design.  Trio owners are not sorted (they vary per trio within a
// species), so the tables give a stable owner-sorted trio order and per-hap
// offsets (TailTables.trio_order, hap_trio_off, built once on the host);
// a hap's path is a slice of path_node (hap_path_off) and a species' nodes
// a span (sp_node_span: sp_off, sp_off + sp_nvert).  One CTA a hap walks its
// trios three times (the second and third from L2) and its path once; one
// CTA a species walks its node slice.  Every float sum is taken in double
// over a fixed assignment of elements to threads and reduced in a fixed
// tree, then rounded to float32: no float atomics, so two launches give the
// same bits (float atomics in a run-dependent order printed other strain
// tables from one coverage).  Counts, path_cov, sp_max and sp_valid are
// exact.  The float32 steps between the sums (mu, sigma, 3 sigma, the
// strict < of the kept test, the final divisions) are the plain version's,
// rounded the same way.
//
// K10b replaces the JAX package's _polish_batch (pantax_tpu/ops/
// profile_tail.py:391), a jitted lax.scan of 8 sweeps of p columns, each a
// sort of the batch's negated residuals.  For each of S instances of a
// bucket (A 0/1 [n, p], b [n], the ADMM's clipped x [p], ub [p]):
//   r = A x - b                       (the columns added left to right)
//   8 sweeps, for each column j:
//     cnt = #{i: A_ij > 0};  k = max((cnt - 1) // 2, 0)
//     t* = the k-th smallest of -r_i over the rows with A_ij > 0
//     t = clip(t*, -x_j, ub_j - x_j), 0 where cnt = 0
//     x_j += t;  r += A_:j t          (every row, A_ij = 0 rows too)
// The plain version (polish_batch_plain) sorts every row of the batch for
// each column: 32 torch.sorts and ~400 small launches a bucket at p 4.
//
// What bounds it: the row visits, 8 p n S of them, a few instructions
// each (chip_smoke.polish_bound), against A read once.  The sweeps are a
// chain: every column's t waits for the whole column's selection.
//
// Design.  The k-th order statistic is a selection, not a sort: an exact
// radix select on order-preserving keys (a float's bits with the sign bit
// flipped where it is positive and all bits flipped where it is negative;
// -0.0 lands just below +0.0), four passes of 8 bits.  A pass counts the
// live rows whose key matches the digits chosen so far into a 256-bin
// shared-memory histogram (lanes with one digit add once, by
// __match_any_sync); the bin that holds k gives the next digit.  Integer
// counts make every choice deterministic.  An instance's rows are cut among
// a thread block cluster of 1-8 CTAs of 1024 threads (polish_plan in
// ops/tail_kernels.py); after each pass every CTA adds the cluster's
// histograms through distributed shared memory, in rank order, so every
// CTA picks the same digit and holds the same x (histograms double-buffered:
// one cluster barrier a pass).  Each CTA keeps its rows' r in shared memory
// where they fit (else in a global scratch), and a column's live rows as
// ballot bits.  Each thread updates only its own rows, so r needs no
// barrier.  All float steps are the plain version's, rounded alone
// (__fadd_rn and friends: no contraction into FMAs), so x comes out bit for
// bit, up to the sign of a zero (the card's sort and the radix keys may
// order -0.0 and +0.0 otherwise).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kStatsThreads = 512;
constexpr int kPolishThreads = 1024;
constexpr int kBins = 256;          // a radix pass's digits (8 bits)
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90

// ---------------------------------------------------------------------------
// K9, the tail stats
// ---------------------------------------------------------------------------
struct StatsArgs {
    const float* na;           // [N] node abundance
    const float* ta;           // [U] trio abundance
    const int* bc;             // [N] covered bases
    const int* trio_order;     // trios sorted by owner (stable), pads out
    const int* hap_trio_off;   // [G + 1] a hap's slice of trio_order
    const int* path_node;      // [Pn] global node ids grouped by hap
    const int* hap_path_off;   // [G + 1] a hap's slice of path_node
    const int* sp_node_span;   // [2S] a species' node slice: starts, ends
    float min_depth;
    int G, S;
    float* out;  // [3G + 4S]: c1, freq_mean, path_cov [G]; sp_nz_cnt,
                 // sp_nz_sum, sp_max, sp_valid [S]
};

struct Add {
    template <typename T>
    __device__ T operator()(T a, T b) const { return a + b; }
};

struct Max {
    __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// The block's reduction of v in a fixed order (each warp's tree, then the
// warps' in a tree of warp 0): the same bits every launch.  ``scratch``
// holds 32 values; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T id, T* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
    __syncthreads();  // the scratch's previous readers are done
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < warps ? scratch[lane] : id;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v = op(v, __shfl_down_sync(0xffffffffu, v, o));
        if (lane == 0) scratch[0] = v;
    }
    __syncthreads();
    return scratch[0];
}

__global__ void __launch_bounds__(kStatsThreads) tail_stats_kernel(StatsArgs a) {
    __shared__ double dbuf[32];
    __shared__ long long lbuf[32];
    __shared__ int ibuf[32];
    __shared__ float fbuf[32];
    const int tid = threadIdx.x, step = blockDim.x;
    const int G = a.G, S = a.S;
    if (static_cast<int>(blockIdx.x) < G) {
        const int g = blockIdx.x;
        const int lo = a.hap_trio_off[g], hi = a.hap_trio_off[g + 1];
        int c = 0;
        double s1 = 0.0;
        for (int i = lo + tid; i < hi; i += step) {
            const float t = a.ta[a.trio_order[i]];
            if (t > 0.f) {
                ++c;
                s1 += static_cast<double>(t);
            }
        }
        c = block_reduce(c, Add(), 0, ibuf);
        s1 = block_reduce(s1, Add(), 0.0, dbuf);
        const float c1 = __int2float_rn(c);
        const float cm = fmaxf(c1, 1.f);
        const float mu = __fdiv_rn(__double2float_rn(s1), cm);
        double s2 = 0.0;
        for (int i = lo + tid; i < hi; i += step) {
            const float t = a.ta[a.trio_order[i]];
            if (t > 0.f) {
                const float d = __fsub_rn(t, mu);
                s2 += static_cast<double>(__fmul_rn(d, d));
            }
        }
        s2 = block_reduce(s2, Add(), 0.0, dbuf);
        const float sigma = __fsqrt_rn(__fdiv_rn(__double2float_rn(s2), cm));
        const float lim = __fmul_rn(3.f, sigma);
        int kc = 0;
        double ks = 0.0;
        for (int i = lo + tid; i < hi; i += step) {
            const float t = a.ta[a.trio_order[i]];
            if (t > 0.f && fabsf(__fsub_rn(t, mu)) < lim) {
                ++kc;
                ks += static_cast<double>(t);
            }
        }
        kc = block_reduce(kc, Add(), 0, ibuf);
        ks = block_reduce(ks, Add(), 0.0, dbuf);
        long long pc = 0;
        const int plo = a.hap_path_off[g], phi = a.hap_path_off[g + 1];
        for (int i = plo + tid; i < phi; i += step) pc += a.bc[a.path_node[i]];
        pc = block_reduce(pc, Add(), 0LL, lbuf);
        if (tid == 0) {
            const float kcf = __int2float_rn(kc);
            a.out[g] = c1;
            a.out[G + g] = (sigma > 0.f && kcf > 0.f)
                               ? __fdiv_rn(__double2float_rn(ks), fmaxf(kcf, 1.f))
                               : 0.f;
            a.out[2 * G + g] = __ll2float_rn(pc);
        }
        return;
    }
    const int s = blockIdx.x - G;
    const int lo = a.sp_node_span[s], hi = a.sp_node_span[S + s];
    int nz = 0, valid = 0;
    double sum = 0.0;
    float mx = neg_inf();
    for (int i = lo + tid; i < hi; i += step) {
        const float v = a.na[i];
        const float opt = v > a.min_depth ? v : 0.f;
        if (opt > 0.f) {
            ++nz;
            sum += static_cast<double>(opt);
        }
        if (v > 0.f) ++valid;
        mx = fmaxf(mx, v);
    }
    nz = block_reduce(nz, Add(), 0, ibuf);
    valid = block_reduce(valid, Add(), 0, ibuf);
    sum = block_reduce(sum, Add(), 0.0, dbuf);
    mx = block_reduce(mx, Max(), neg_inf(), fbuf);
    if (tid == 0) {
        float* o = a.out + 3 * G;
        o[s] = __int2float_rn(nz);
        o[S + s] = __double2float_rn(sum);
        o[2 * S + s] = mx;
        o[3 * S + s] = __int2float_rn(valid);
    }
}

// ---------------------------------------------------------------------------
// K10b, the coordinate-median polish
// ---------------------------------------------------------------------------
struct PolishArgs {
    const float* A;     // [S, n, p]
    const float* b;     // [S, n]
    const float* x0;    // [S, p]
    const float* ub;    // [S, p]
    float* r_global;    // [S, n] where the rows are not on chip, else null
    float* x;           // [S, p] out
    int n, p, sweeps;
    int rows;           // rows a CTA (n / cluster)
    int on_chip;        // r in shared memory
};

// order-preserving keys: key(u) < key(v) iff u < v (for non-NaN floats;
// -0.0 just below +0.0)
__device__ __forceinline__ unsigned order_key(float v) {
    const unsigned u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a CTA's dynamic shared memory in bytes (ops/tail_kernels.py's
// polish_smem_bytes): two histograms; the live bits of a column; x, ub;
// the bins' warp totals and the selection; the rows' r on chip
__host__ __device__ inline long long polish_smem_bytes(int rows, int p,
                                                       int on_chip) {
    return 4LL * (2 * kBins + rows / 32 + 2LL * p + kBins / 32 + 4) +
           (on_chip ? 4LL * rows : 0);
}

__global__ void __launch_bounds__(kPolishThreads, 1) polish_kernel(PolishArgs a) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned C = cluster.num_blocks();
    const unsigned rank = cluster.block_rank();
    const int s = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = a.n, p = a.p, rows = a.rows;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* hist = reinterpret_cast<unsigned*>(smem);  // [2][kBins]
    unsigned* live = hist + 2 * kBins;                    // [rows / 32]
    float* xs = reinterpret_cast<float*>(live + rows / 32);  // [p]
    float* ubs = xs + p;                                  // [p]
    unsigned* wsum = reinterpret_cast<unsigned*>(ubs + p);  // [kBins / 32]
    unsigned* sel = wsum + kBins / 32;  // digit, k left, cnt, t's bits
    float* rsh = reinterpret_cast<float*>(sel + 4);       // [rows] on chip

    const size_t row0 = static_cast<size_t>(s) * n +
                        static_cast<size_t>(rank) * rows;
    const float* Ab = a.A + row0 * p;
    float* r = a.on_chip ? rsh : a.r_global + row0;
    for (int j = tid; j < p; j += kPolishThreads) {
        xs[j] = a.x0[static_cast<size_t>(s) * p + j];
        ubs[j] = a.ub[static_cast<size_t>(s) * p + j];
    }
    for (int i = tid; i < 2 * kBins; i += kPolishThreads) hist[i] = 0;
    __syncthreads();
    // r = A x - b, the columns added left to right (each product exact:
    // A is 0/1)
    for (int i = tid; i < rows; i += kPolishThreads) {
        const float* ar = Ab + static_cast<size_t>(i) * p;
        float v = __fmul_rn(ar[0], xs[0]);
        for (int j = 1; j < p; ++j) v = __fadd_rn(v, __fmul_rn(ar[j], xs[j]));
        r[i] = __fsub_rn(v, a.b[row0 + i]);
    }

    int buf = 0;
    for (int sweep = 0; sweep < a.sweeps; ++sweep) {
        for (int j = 0; j < p; ++j) {
            unsigned prefix = 0, k = 0, cnt = 0;
            for (int pass = 0; pass < 4; ++pass) {
                const int shift = 24 - 8 * pass;
                unsigned* h = hist + buf * kBins;
                // rows % 1024 == 0: every lane runs every iteration
                for (int i = tid; i < rows; i += kPolishThreads) {
                    bool cand;
                    if (pass == 0) {
                        cand = Ab[static_cast<size_t>(i) * p + j] > 0.f;
                        const unsigned word = __ballot_sync(0xffffffffu, cand);
                        if (lane == 0) live[i >> 5] = word;
                    } else {
                        cand = (live[i >> 5] >> lane) & 1u;
                    }
                    unsigned key = 0;
                    if (cand) {
                        key = order_key(-r[i]);
                        if (pass > 0) cand = (key >> (shift + 8)) == prefix;
                    }
                    const unsigned m = __ballot_sync(0xffffffffu, cand);
                    if (cand) {
                        const unsigned d = (key >> shift) & 0xffu;
                        const unsigned peers = __match_any_sync(m, d);
                        if (lane == __ffs(peers) - 1) atomicAdd(&h[d], static_cast<unsigned>(__popc(peers)));
                    }
                }
                cluster.sync();  // every CTA's counts of this pass are in
                unsigned tot = 0, inc = 0;
                if (tid < kBins) {
                    for (unsigned q = 0; q < C; ++q)
                        tot += cluster.map_shared_rank(h, q)[tid];
                    // every CTA read the other buffer (the last pass's)
                    // before this pass's cluster barrier
                    hist[(buf ^ 1) * kBins + tid] = 0;
                    inc = tot;
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
                        if (lane >= o) inc += y;
                    }
                    if (lane == 31) wsum[warp] = inc;
                }
                __syncthreads();
                if (tid < kBins) {
                    unsigned below = 0, all = 0;
#pragma unroll
                    for (int w = 0; w < kBins / 32; ++w) {
                        below += w < warp ? wsum[w] : 0u;
                        all += wsum[w];
                    }
                    const unsigned kk = pass == 0 ? (all ? (all - 1) / 2 : 0) : k;
                    const unsigned lo = below + inc - tot;
                    if (tot && kk >= lo && kk < lo + tot) {
                        sel[0] = tid;
                        sel[1] = kk - lo;
                    }
                    if (pass == 0 && tid == 0) sel[2] = all;
                }
                __syncthreads();
                buf ^= 1;
                if (pass == 0) cnt = sel[2];
                if (cnt == 0) break;  // the same in every CTA
                prefix = (prefix << 8) | sel[0];
                k = sel[1];
            }
            if (tid == 0) {
                float t = 0.f;
                if (cnt) {
                    const float xj = xs[j];
                    t = fminf(fmaxf(key_value(prefix), -xj), __fsub_rn(ubs[j], xj));
                }
                xs[j] = __fadd_rn(xs[j], t);
                sel[3] = __float_as_uint(t);
            }
            __syncthreads();
            const float t = __uint_as_float(sel[3]);
            for (int i = tid; i < rows; i += kPolishThreads)
                r[i] = __fadd_rn(r[i], __fmul_rn(Ab[static_cast<size_t>(i) * p + j], t));
        }
    }
    cluster.sync();  // no CTA leaves while another reads its histograms
    if (rank == 0)
        for (int j = tid; j < p; j += kPolishThreads)
            a.x[static_cast<size_t>(s) * p + j] = xs[j];
}

}  // namespace

// K9: one launch, G + S CTAs.  Returns a cudaError_t (0 on success);
// launches on `stream`, no synchronise.
extern "C" int tail_stats_launch(
    const void* na, const void* ta, const void* bc, const void* trio_order,
    const void* hap_trio_off, const void* path_node, const void* hap_path_off,
    const void* sp_node_span, float min_depth, int G, int S, void* out,
    void* stream) {
    if (G < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
    const StatsArgs a{static_cast<const float*>(na), static_cast<const float*>(ta),
                      static_cast<const int*>(bc), static_cast<const int*>(trio_order),
                      static_cast<const int*>(hap_trio_off),
                      static_cast<const int*>(path_node),
                      static_cast<const int*>(hap_path_off),
                      static_cast<const int*>(sp_node_span), min_depth, G, S,
                      static_cast<float*>(out)};
    tail_stats_kernel<<<G + S, kStatsThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// K10b: S clusters of `cluster` CTAs of 1024 threads, n / cluster rows a
// CTA (ops/tail_kernels.py's polish_plan, checked here again).  `r` is a
// float [S, n] scratch where `on_chip` is 0.  Returns a cudaError_t.
extern "C" int polish_launch(const void* A, const void* b, const void* x0,
                             const void* ub, int S, int n, int p, int sweeps,
                             int cluster, int on_chip, void* r, void* x,
                             void* stream) {
    const int C = cluster;
    if (S < 1 || p < 1 || sweeps < 0 || C < 1 || C > kMaxCluster ||
        kMaxCluster % C || n < 1 || n % (C * kPolishThreads) ||
        (!on_chip && r == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int rows = n / C;
    const long long smem = polish_smem_bytes(rows, p, on_chip);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const PolishArgs a{static_cast<const float*>(A), static_cast<const float*>(b),
                       static_cast<const float*>(x0), static_cast<const float*>(ub),
                       static_cast<float*>(r), static_cast<float*>(x),
                       n, p, sweeps, rows, on_chip};
    cudaError_t e = cudaFuncSetAttribute(
        polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(S) * C);
    cfg.blockDim = dim3(kPolishThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, polish_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    e = cudaLaunchKernelEx(&cfg, polish_kernel, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
