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
// node spans, ta, the owner order, the path nodes and their bc), ~11 MB at
// the smoke DB, and the arithmetic is a few instructions an element.  What
// keeps it from the bound is latency: a hap's three passes over its trios
// depend on each other (the mean before the deviations, sigma before the
// kept set), each trio is a chain of two loads (its index, then ta), and
// forty haps and species are too few CTAs for 132 SMs.
//
// Design.  Trio owners are not sorted (they vary per trio within a
// species), so the tables give a stable owner-sorted trio order and per-hap
// offsets (TailTables.trio_order, hap_trio_off, built once on the host);
// a hap's path is a slice of path_node (hap_path_off) and a species' nodes
// a span (sp_node_span: sp_off, sp_off + sp_nvert).  A thread block cluster
// of C CTAs (ops/tail_kernels.py's stats_plan: the smallest C whose (G + S)
// C CTAs fill the SMs, more where a hap's trios would not fit on chip) takes
// a hap or a species, each CTA a fixed share of its elements.  A hap's
// threads gather their trio values once into registers (R a thread; the
// rest are gathered again from L2 in each pass) and issue their path
// gathers with them, so the path's latency hides under the trio passes.
// The three passes end in three exchanges, each CTA's partial sums stored
// into every CTA of the cluster (the last into rank 0) with st.async onto
// an mbarrier a round; every CTA adds the ranks' partials in rank order, so
// every CTA derives the same mu and sigma with no broadcast.  A species'
// span is read as float4s, its unaligned head and tail apart.  Every float
// sum is taken in double over a fixed assignment of elements to threads
// (a function of C, which is one of the shapes), reduced in a fixed tree
// and then in rank order, then rounded to float32: no float atomics, so
// two launches give the same bits (float atomics in a run-dependent order
// printed other strain tables from one coverage).  Counts, path_cov,
// sp_max and sp_valid are exact.  The float32 steps between the sums (mu,
// sigma, 3 sigma, the strict < of the kept test, the final divisions) are
// the plain version's, rounded the same way.
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
//     x_j += t;  r += A_:j t
// The plain version (polish_batch_plain) sorts every row of the batch for
// each column: 32 torch.sorts and ~400 small launches a bucket at p 4.
//
// What bounds it: the row visits, 8 p n S of them, a few instructions
// each (chip_smoke.polish_bound), against A read once.  What keeps it from
// the bound is the chain: every column's t waits for a selection over the
// whole column, whose rows a cluster of CTAs shares, so every column step
// exchanges data across the cluster twice.  A cluster barrier
// (cluster.sync()) compiles to a GPU-scope memory fence and an L1
// invalidate besides the barrier, so the exchanges do without one: a CTA
// stores into the others' shared memory with st.async, each store counted
// on the receiving CTA's mbarrier, and each CTA waits for the bytes it
// expects.
//
// Design.  A is read once a launch.  A thread holds its rows' r and live
// columns (one bit a column) in registers where a CTA has 4096 or 8192
// rows and p <= 32 (the device tail's buckets); else r and the live bits
// (a word a column per 32 rows) sit in shared memory, or in the global
// scratch where they do not fit.  The cluster adds up each column's live
// count once, so k is fixed for the launch and a column with no live row
// costs nothing (t = 0).  A is taken to be 0/1, as the device tail builds
// it: an instance whose A holds another value gets NaN in all of its x.
// The k-th order statistic is a selection, not a sort: an exact radix
// select on order-preserving keys (a float's bits with the sign bit
// flipped where it is positive and all bits flipped where it is negative;
// -0.0 lands just below +0.0), by digits of 11, 11 and 10 bits:
//   1. each CTA counts its live rows' first digit into a shared histogram
//      of 2048 bins and stores its sums by 32 bins into its slot in every
//      CTA; one warp adds the slots, finds the group that holds k, reads
//      that group's 32 bins from every CTA through distributed shared
//      memory and finds the bin (integer counts: every CTA the same bin);
//   2. where the cluster's rows in that bin fit the candidate buffer
//      (``cap`` keys), each CTA stores its rows' keys of that bin into
//      every CTA's buffer at its offset (the lower ranks' counts of the
//      bin; a warp takes its places once a row); then each CTA finishes
//      alone: rounds of the next digits over the candidates until at most
//      256 are left, which are ranked at once (4 threads a candidate
//      count the smaller and the not larger ones);
//   3. where they do not fit, the next digit is counted over all rows
//      again (a round over the cluster a digit) until the bin fits or
//      every bit is known.
// Every CTA holds the same candidates and k, so every CTA picks the same
// value and holds the same x with no broadcast; every thread takes t from
// the same x_j, and the live rows of column j get r += t in the next
// column's count.  A sweep in which every column's t is 0 (as a value)
// leaves x and r as they were, but for the sign of a zero, so every later
// sweep would repeat it: the instance stops after that sweep, each CTA
// deciding alone on the same t.  A cluster of one CTA (up to 8192 rows)
// exchanges through its own shared memory and __syncthreads.  All float
// steps are the plain version's, rounded alone (__fadd_rn and friends: no
// contraction into FMAs), so x comes out bit for bit, up to the sign of a
// zero (the card's sort and the radix keys may order -0.0 and +0.0
// otherwise, and a row with A = 0 keeps r where the plain version adds
// 0 t).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kStatsThreads = 512;
constexpr int kPolishThreads = 1024;
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90

// ---------------------------------------------------------------------------
// The cluster's exchanges (K9 and K10b)
// ---------------------------------------------------------------------------
// a word of CTA `rank`'s shared memory at the address of `p` in this CTA
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
    unsigned d;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(d)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
    return d;
}

__device__ __forceinline__ unsigned ld_cluster(unsigned addr) {
    unsigned v;
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

// The cluster's exchanges: st_async stores a word into CTA `rank`'s copy
// of `dst` and counts its 4 bytes on that CTA's barrier `bar`; a CTA waits
// on its own barrier for the bytes it expects (no cluster barrier)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(bar)))
                 : "memory");
}

// the barrier's next phase: this thread's arrival, `bytes` to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(bar))),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra.uni WAIT;\n"
        "}\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(bar))),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void st_async(const unsigned* dst, uint64_t* bar,
                                         unsigned rank, unsigned v) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];" ::"r"(cluster_addr(dst, rank)),
        "r"(v), "r"(cluster_addr(bar, rank))
        : "memory");
}

// The cluster barrier in two halves: each CTA arrives once its exchanges'
// barriers are set (relaxed: fence.mbarrier_init orders the setting) and
// waits before its first store into another CTA.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;" ::: "memory");
}

// ---------------------------------------------------------------------------
// K9, the tail stats
// ---------------------------------------------------------------------------
// The design's levers, each taken out by scripts/time_extend.py --kernel k9
// --ablate: a cluster of CTAs a hap and a species (else one CTA, 16 trio
// values a thread in registers), a hap's trio values kept in registers
// through its three passes (else gathered again from L2 in each), the
// path's gathers issued before the trio passes (else after the third).
constexpr bool kStatsCluster = true;
constexpr bool kKeepTrios = true;
constexpr bool kPathEarly = true;
constexpr int kStatsRegsMax = 16;   // trio values a thread in registers at most
constexpr int kSpanLoads = 4;       // float4s of a species a thread loads at once
constexpr int kStatsSMs = 132;      // the H100's SMs: the grid fills them
// the words a CTA sends in each exchange: a hap's (c, s1) and (s2) to every
// CTA of its cluster, its (kc, ks, pc) and a species' (nz, valid, sum, max)
// to rank 0
constexpr int kRound1 = 3, kRound2 = 2, kRound3 = 5;

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
    int cluster;               // CTAs a hap and a species
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

// a warp's v in a fixed tree: lane l adds lane l + o for o = 16, 8, 4, 2,
// 1 (lane 0 holds the result)
template <typename V, typename Op>
__device__ __forceinline__ V warp_tree(V v, Op op) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// a warp's values of scratch (lanes past `warps`: id) in the fixed tree,
// in every lane
template <typename V, typename Op>
__device__ __forceinline__ V warps_tree(const V* scratch, int warps, Op op, V id) {
    const int lane = threadIdx.x & 31;
    V v = warp_tree(lane < warps ? scratch[lane] : id, op);
    return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ unsigned lo_word(double v) {
    return static_cast<unsigned>(__double2loint(v));
}

__device__ __forceinline__ unsigned hi_word(double v) {
    return static_cast<unsigned>(__double2hiint(v));
}

__device__ __forceinline__ double as_double(const unsigned* w) {
    return __hiloint2double(static_cast<int>(w[1]), static_cast<int>(w[0]));
}

// Warp 0 stores this CTA's N words `v` into its slot (`rank`) of `slots`
// in CTAs 0 .. to - 1 of the cluster, lane q into CTA q, each counted on
// that CTA's barrier `bar`; a CTA alone (C 1) into its own.
template <int N>
__device__ __forceinline__ void push(unsigned* slots, uint64_t* bar, int C,
                                     unsigned rank, int to, const unsigned (&v)[N]) {
    const int lane = threadIdx.x & 31;
    unsigned* dst = slots + rank * N;
    if (C == 1) {
        if (lane == 0) {
#pragma unroll
            for (int w = 0; w < N; ++w) dst[w] = v[w];
        }
    } else if (lane < to) {
#pragma unroll
        for (int w = 0; w < N; ++w) st_async(dst + w, bar, lane, v[w]);
    }
}

// R: a thread's trio values held in registers (slots), P: its path nodes
// gathered at once; 512 threads, clusters of a.cluster CTAs.  Element j of
// a hap's trios (of its path, of a species' float4s) belongs to rank (j /
// 512) % C, thread j % 512, slot j / (512 C): each thread adds its slots in
// order, a CTA its threads in a fixed tree, every CTA the ranks in order.
template <int R, int P>
__global__ void __launch_bounds__(kStatsThreads, 2) tail_stats_kernel(StatsArgs a) {
    constexpr int T = kStatsThreads, W = T / 32;
    __shared__ uint64_t bars[3];
    __shared__ unsigned slots[3][kMaxCluster * kRound3];
    __shared__ int iscr[2][W];
    __shared__ double dscr[3][W];
    __shared__ long long lscr[W];
    __shared__ float fscr[W];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int C = a.cluster, TC = T * C;
    const unsigned rank = C > 1 ? cg::this_cluster().block_rank() : 0u;
    const int item = blockIdx.x / C, G = a.G, S = a.S;
    const bool is_hap = item < G;
    if (C > 1) {
        if (tid == 0) {
            for (int i = 0; i < 3; ++i) mbar_init(bars + i);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
            if (is_hap) {
                mbar_expect(bars, C * kRound1 * 4);
                mbar_expect(bars + 1, C * kRound2 * 4);
            }
            if (rank == 0) mbar_expect(bars + 2, C * kRound3 * 4);
        }
        cluster_arrive();
    }
    // the exchange of rounds 1 and 2: every CTA holds every rank's words
    auto receive = [&](int r) {
        if (C > 1) mbar_wait(bars + r, 0);
        else __syncthreads();
    };
    const int base = static_cast<int>(rank) * T + tid;  // slot 0's element

    if (is_hap) {
        const int g = item;
        const int lo = a.hap_trio_off[g], n = a.hap_trio_off[g + 1] - lo;
        const int plo = a.hap_path_off[g], pn = a.hap_path_off[g + 1] - plo;
        const int* order = a.trio_order + lo;
        const int* path = a.path_node + plo;
        int pidx[P], pv[P], tidx[R];
        float tv[R];
        auto path_nodes = [&] {
#pragma unroll
            for (int k = 0; k < P; ++k) {
                const int j = base + k * TC;
                pidx[k] = j < pn ? path[j] : -1;
            }
        };
        auto path_gather = [&] {
#pragma unroll
            for (int k = 0; k < P; ++k) pv[k] = pidx[k] >= 0 ? a.bc[pidx[k]] : 0;
        };
        // the loads in flight at once: the path's nodes and the trios'
        // indices, then the trios' gathers (pass 1 waits on them), then
        // the path's; the path's bc is added after the third pass
        if (kPathEarly) path_nodes();
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int j = base + k * TC;
            tidx[k] = j < n ? order[j] : -1;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) tv[k] = tidx[k] >= 0 ? a.ta[tidx[k]] : 0.f;
        if (kPathEarly) path_gather();
        // slot k's trio value in passes 2 and 3
        auto value = [&](int k) -> float {
            if constexpr (kKeepTrios) {
                return tv[k];
            } else {
                const int j = base + k * TC;
                return j < n ? a.ta[order[j]] : 0.f;
            }
        };
        // the slots past the registers, from L2 in every pass, 4 at once
        auto spilled = [&](auto&& f) {
            for (int j0 = base + R * TC; j0 < n; j0 += 4 * TC) {
                int ix[4];
                float t[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int j = j0 + u * TC;
                    ix[u] = j < n ? order[j] : -1;
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) t[u] = ix[u] >= 0 ? a.ta[ix[u]] : 0.f;
#pragma unroll
                for (int u = 0; u < 4; ++u) f(t[u]);
            }
        };

        // pass 1: the nonzero trios' count and sum
        int c = 0;
        double s1 = 0.0;
        auto first = [&](float t) {
            if (t > 0.f) {
                ++c;
                s1 += static_cast<double>(t);
            }
        };
#pragma unroll
        for (int k = 0; k < R; ++k) first(tv[k]);
        spilled(first);
        if (C > 1) cluster_wait();  // every CTA's barriers are set
        c = warp_tree(c, Add());
        s1 = warp_tree(s1, Add());
        if (lane == 0) {
            iscr[0][warp] = c;
            dscr[0][warp] = s1;
        }
        __syncthreads();
        if (warp == 0) {
            const int cc = warps_tree(iscr[0], W, Add(), 0);
            const double ss = warps_tree(dscr[0], W, Add(), 0.0);
            const unsigned v[kRound1] = {static_cast<unsigned>(cc), lo_word(ss),
                                         hi_word(ss)};
            push(slots[0], bars, C, rank, C, v);
        }
        receive(0);
        int ct = 0;
        double s1t = 0.0;
        for (int q = 0; q < C; ++q) {
            ct += static_cast<int>(slots[0][q * kRound1]);
            s1t += as_double(slots[0] + q * kRound1 + 1);
        }
        const float c1 = __int2float_rn(ct);
        const float cm = fmaxf(c1, 1.f);
        const float mu = __fdiv_rn(__double2float_rn(s1t), cm);

        // pass 2: the squared deviations
        double s2 = 0.0;
        auto second = [&](float t) {
            if (t > 0.f) {
                const float d = __fsub_rn(t, mu);
                s2 += static_cast<double>(__fmul_rn(d, d));
            }
        };
#pragma unroll
        for (int k = 0; k < R; ++k) second(value(k));
        spilled(second);
        s2 = warp_tree(s2, Add());
        if (lane == 0) dscr[1][warp] = s2;
        __syncthreads();
        if (warp == 0) {
            const double ss = warps_tree(dscr[1], W, Add(), 0.0);
            const unsigned v[kRound2] = {lo_word(ss), hi_word(ss)};
            push(slots[1], bars + 1, C, rank, C, v);
        }
        receive(1);
        double s2t = 0.0;
        for (int q = 0; q < C; ++q) s2t += as_double(slots[1] + q * kRound2);
        const float sigma = __fsqrt_rn(__fdiv_rn(__double2float_rn(s2t), cm));
        const float lim = __fmul_rn(3.f, sigma);

        // pass 3: the kept set (|t - mu| < 3 sigma, strictly), then the path
        int kc = 0;
        double ks = 0.0;
        auto third = [&](float t) {
            if (t > 0.f && fabsf(__fsub_rn(t, mu)) < lim) {
                ++kc;
                ks += static_cast<double>(t);
            }
        };
#pragma unroll
        for (int k = 0; k < R; ++k) third(value(k));
        spilled(third);
        if (!kPathEarly) {
            path_nodes();
            path_gather();
        }
        long long pc = 0;
#pragma unroll
        for (int k = 0; k < P; ++k) pc += pv[k];
        for (int j0 = base + P * TC; j0 < pn; j0 += 4 * TC) {
            int ix[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = j0 + u * TC;
                ix[u] = j < pn ? path[j] : -1;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) pc += ix[u] >= 0 ? a.bc[ix[u]] : 0;
        }
        kc = warp_tree(kc, Add());
        ks = warp_tree(ks, Add());
        pc = warp_tree(pc, Add());
        if (lane == 0) {
            iscr[1][warp] = kc;
            dscr[2][warp] = ks;
            lscr[warp] = pc;
        }
        __syncthreads();
        if (warp == 0) {
            const int kk = warps_tree(iscr[1], W, Add(), 0);
            const double ss = warps_tree(dscr[2], W, Add(), 0.0);
            const long long pp = warps_tree(lscr, W, Add(), 0LL);
            const unsigned v[kRound3] = {
                static_cast<unsigned>(kk), lo_word(ss), hi_word(ss),
                static_cast<unsigned>(pp),
                static_cast<unsigned>(static_cast<unsigned long long>(pp) >> 32)};
            push(slots[2], bars + 2, C, rank, 1, v);
        }
        if (rank != 0 || tid != 0) return;  // rank 0's thread 0 writes
        if (C > 1) mbar_wait(bars + 2, 0);
        int kct = 0;
        double kst = 0.0;
        long long pct = 0;
        for (int q = 0; q < C; ++q) {
            const unsigned* w = slots[2] + q * kRound3;
            kct += static_cast<int>(w[0]);
            kst += as_double(w + 1);
            pct += static_cast<long long>((static_cast<unsigned long long>(w[4]) << 32) | w[3]);
        }
        const float kcf = __int2float_rn(kct);
        a.out[g] = c1;
        a.out[G + g] = (sigma > 0.f && kcf > 0.f)
                           ? __fdiv_rn(__double2float_rn(kst), fmaxf(kcf, 1.f))
                           : 0.f;
        a.out[2 * G + g] = __ll2float_rn(pct);
        return;
    }

    // a species: its node span cut at 16-byte boundaries, the head (up to
    // 3 nodes) to rank 0's threads 0-3, the tail (up to 3) to its threads
    // 4-7, the float4s between them to every rank's threads
    const int s = item - G;
    const int lo = a.sp_node_span[s], hi = a.sp_node_span[S + s];
    const float md = a.min_depth;
    int nz = 0, valid = 0;
    double sum = 0.0;
    float mx = neg_inf();
    auto take = [&](float v) {
        const float opt = v > md ? v : 0.f;
        if (opt > 0.f) {
            ++nz;
            sum += static_cast<double>(opt);
        }
        if (v > 0.f) ++valid;
        mx = fmaxf(mx, v);
    };
    const unsigned mis = static_cast<unsigned>(
        reinterpret_cast<uintptr_t>(a.na + lo) >> 2);  // the 4-byte word
    const int head = min(hi - lo, static_cast<int>((0u - mis) & 3u));
    const int a0 = lo + head, nq = (hi - a0) >> 2, a1 = a0 + 4 * nq;
    if (rank == 0 && tid < 4 && tid < head) take(a.na[lo + tid]);
    if (rank == 0 && tid >= 4 && tid < 8 && a1 + tid - 4 < hi) take(a.na[a1 + tid - 4]);
    const float4* body = reinterpret_cast<const float4*>(a.na + a0);
    for (int q0 = base; q0 < nq; q0 += kSpanLoads * TC) {
        float4 v[kSpanLoads];
#pragma unroll
        for (int u = 0; u < kSpanLoads; ++u)
            if (q0 + u * TC < nq) v[u] = body[q0 + u * TC];
#pragma unroll
        for (int u = 0; u < kSpanLoads; ++u)
            if (q0 + u * TC < nq) {
                take(v[u].x);
                take(v[u].y);
                take(v[u].z);
                take(v[u].w);
            }
    }
    if (C > 1) cluster_wait();  // every CTA's barriers are set
    nz = warp_tree(nz, Add());
    valid = warp_tree(valid, Add());
    sum = warp_tree(sum, Add());
    mx = warp_tree(mx, Max());
    if (lane == 0) {
        iscr[0][warp] = nz;
        iscr[1][warp] = valid;
        dscr[0][warp] = sum;
        fscr[warp] = mx;
    }
    __syncthreads();
    if (warp == 0) {
        const int zz = warps_tree(iscr[0], W, Add(), 0);
        const int vv = warps_tree(iscr[1], W, Add(), 0);
        const double ss = warps_tree(dscr[0], W, Add(), 0.0);
        const float mm = warps_tree(fscr, W, Max(), neg_inf());
        const unsigned v[kRound3] = {static_cast<unsigned>(zz),
                                     static_cast<unsigned>(vv), lo_word(ss),
                                     hi_word(ss), __float_as_uint(mm)};
        push(slots[2], bars + 2, C, rank, 1, v);
    }
    if (rank != 0 || tid != 0) return;  // rank 0's thread 0 writes
    if (C > 1) mbar_wait(bars + 2, 0);
    int zt = 0, vt = 0;
    double st = 0.0;
    float mt = neg_inf();
    for (int q = 0; q < C; ++q) {
        const unsigned* w = slots[2] + q * kRound3;
        zt += static_cast<int>(w[0]);
        vt += static_cast<int>(w[1]);
        st += as_double(w + 2);
        mt = fmaxf(mt, __uint_as_float(w[4]));
    }
    float* o = a.out + 3 * G;
    o[s] = __int2float_rn(zt);
    o[S + s] = __double2float_rn(st);
    o[2 * S + s] = mt;
    o[3 * S + s] = __int2float_rn(vt);
}

// ---------------------------------------------------------------------------
// K10b, the coordinate-median polish
// ---------------------------------------------------------------------------
constexpr int kDigitBins = 2048;    // a digit's bins (11 bits; the last 10)
constexpr int kGroups = kDigitBins / 32;  // the merge's groups of 32 bins
constexpr int kGroupsLane = kGroups / 32;  // a lane's groups in the merge
constexpr int kChunk = 8;           // rows a thread takes at once from memory
constexpr int kRegRows = 8;         // rows a thread holds in registers at most
constexpr int kMaxCap = 16384;      // candidate keys a CTA holds at most
constexpr int kMinCap = 4096;       // r on chip only where this many still fit
constexpr int kRankLoads = 4;       // a rank loop's loads in flight
constexpr int kRankSelect = 256;    // candidates ranked at once, 4 threads
                                    // a candidate

struct PolishArgs {
    const float* A;     // [S, n, p]
    const float* b;     // [S, n]
    const float* x0;    // [S, p]
    const float* ub;    // [S, p]
    float* scratch;     // r [S, n] where not on chip, then the bits where
                        // not on chip; else null
    float* x;           // [S, p] out
    int n, p, sweeps;
    int rows;           // rows a CTA (n / cluster)
    int cap;            // candidate keys a CTA
    int on_chip;        // r in shared memory (or registers)
    int bits_on_chip;   // the live bits in shared memory (or registers)
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

// the bits above `shift` (none at 32): a key has the bits `prefix` above
// `shift` where (key & high_mask(shift)) == prefix << shift
__device__ __forceinline__ unsigned high_mask(int shift) {
    return shift >= 32 ? 0u : ~0u << shift;
}

// rows a thread holds in registers (0: r and the live bits in memory):
// every row of a CTA of 4096 or 8192 rows, a column a bit (p <= 32)
__host__ __device__ inline int polish_reg_rows(int rows, int p) {
    return p <= 32 && (rows == 4 * kPolishThreads || rows == kRegRows * kPolishThreads)
               ? rows / kPolishThreads
               : 0;
}

// the exchanges' barriers: the group sums' (a histogram's each) and the
// candidates'
constexpr int kBarriers = 3;
constexpr int kBarrierWords = 8;    // the barriers' words, 16-byte aligned

// A CTA's shared memory (ops/tail_kernels.py's polish_plan): its words
// past the live bits, r and the candidates (the exchanges' barriers; the
// histogram twice; the cluster's sums by 32 bins twice, a slot a rank,
// and this CTA's for its own rounds; the selection's words; the warps'
// counts; the last kRankSelect candidates; the live counts and k of each
// column, each with a flag; x and ub), then the plan for n rows of p
// columns in clusters of C CTAs.
__host__ inline long long polish_fixed_words(int p) {
    return 2LL * kDigitBins + (2LL * kMaxCluster + 1) * kGroups + 8 + 32 +
           kRankSelect + 4LL * p + 2 + kBarrierWords;
}

struct PolishLayout {
    int rows, reg_rows, cap, bits_on_chip;
    long long smem;
};

__host__ inline bool polish_layout(int n, int p, int C, int on_chip,
                                   PolishLayout* L) {
    const int rows = n / C;
    const long long room = kMaxSmem / 4, fixed = polish_fixed_words(p);
    L->rows = rows;
    L->reg_rows = polish_reg_rows(rows, p);
    const long long bits = L->reg_rows ? 0 : static_cast<long long>(p) * (rows / 32);
    L->bits_on_chip = fixed + bits + kMinCap <= room;
    if (on_chip && !L->bits_on_chip) return false;
    const long long used = fixed + (L->bits_on_chip ? bits : 0) +
                           (on_chip && !L->reg_rows ? rows : 0);
    long long cap = room - used;
    if (cap > kMaxCap) cap = kMaxCap;
    if (cap > n) cap = n;
    if (cap < 0) return false;
    L->cap = static_cast<int>(cap);
    L->smem = 4 * (used + cap);
    return true;
}

// A warp's offset among the CTA's warps: each warp's count n_warp (the
// same in its lanes) into wcnt, a barrier, the counts of the warps before
// it.  The caller syncs before wcnt is used again.
__device__ __forceinline__ unsigned warp_offset(unsigned n_warp,
                                                unsigned* wcnt) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) wcnt[warp] = n_warp;
    __syncthreads();
    const unsigned w = lane < static_cast<int>(blockDim.x >> 5) ? wcnt[lane] : 0u;
    unsigned inc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
    }
    return __shfl_sync(0xffffffffu, inc - w, warp);
}

// kCluster: clusters of 2-8 CTAs an instance (else one CTA); RR: rows a
// thread holds in registers (0: in memory); 1024 threads
template <bool kCluster, int RR>
__global__ void __launch_bounds__(kPolishThreads, 1) polish_kernel(PolishArgs a) {
    constexpr int T = kPolishThreads, B = kDigitBins / T;  // bins a thread sums
    constexpr int R = kCluster ? kMaxCluster : 1;          // ranks at most
    constexpr int kStep = RR ? RR : kChunk;  // rows a walk takes at once
    const unsigned C = kCluster ? cg::this_cluster().num_blocks() : 1u;
    const unsigned rank = kCluster ? cg::this_cluster().block_rank() : 0u;
    auto cluster_sync = [] {
        if constexpr (kCluster) cg::this_cluster().sync(); else __syncthreads();
    };
    const int s = blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = a.n, p = a.p, rows = a.rows, W = rows / 32;
    const int per = RR ? RR : rows / T;  // rows a thread
    extern __shared__ __align__(16) unsigned smem[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kBarriers]
    unsigned* hist = smem + kBarrierWords;    // [2][kDigitBins]
    unsigned* slots = hist + 2 * kDigitBins;  // [2][kMaxCluster][kGroups]
    unsigned* own = slots + 2 * kMaxCluster * kGroups;  // [kGroups]
    unsigned* sel = own + kGroups;  // bin, k in it, its count, push
                                    // offset, the selected key, the
                                    // push's count
    unsigned* wcnt = sel + 8;                 // [32] a warp's count
    unsigned* last = wcnt + 32;               // [kRankSelect]
    unsigned* cnt = last + kRankSelect;       // [p + 1] live counts, flag
    unsigned* kth = cnt + p + 1;  // [p + 1] k (~0u: no live row), flags
    float* xs = reinterpret_cast<float*>(kth + p + 1);    // [p]
    float* ubs = xs + p;                                  // [p]
    unsigned* cand = reinterpret_cast<unsigned*>(ubs + p);  // [cap]
    unsigned* tail = cand + a.cap;  // the live bits, then r, where on chip

    const size_t row0 = static_cast<size_t>(s) * n +
                        static_cast<size_t>(rank) * rows;
    const size_t S = gridDim.x / C;
    unsigned* live =
        a.bits_on_chip ? tail
                       : reinterpret_cast<unsigned*>(a.scratch + S * n) +
                             static_cast<size_t>(blockIdx.x) * p * W;
    float* r = a.on_chip ? reinterpret_cast<float*>(tail + static_cast<size_t>(p) * W)
                         : a.scratch + row0;
    // the rows in registers: r, and the live columns as bits
    float rr[RR ? RR : 1];
    unsigned msk[RR ? RR : 1];
    (void)rr;
    (void)msk;
    auto is_live = [&](int m, int j) -> bool {
        if constexpr (RR > 0) return (msk[m] >> j) & 1u;
        else return (live[j * W + ((tid + m * T) >> 5)] >> lane) & 1u;
    };
    auto r_of = [&](int m) -> float {
        if constexpr (RR > 0) return rr[m];
        else return r[tid + m * T];
    };

    for (int j = tid; j < p; j += T) {
        xs[j] = a.x0[static_cast<size_t>(s) * p + j];
        ubs[j] = a.ub[static_cast<size_t>(s) * p + j];
    }
    for (int i = tid; i < 2 * kDigitBins; i += T) hist[i] = 0;
    for (int j = tid; j <= p; j += T) cnt[j] = 0;
    if (kCluster && tid == 0) {
        for (int i = 0; i < kBarriers; ++i) mbar_init(bars + i);
        // seen by the cluster at its first barrier
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    // A read once: its live bits, r = A x - b (the columns added left to
    // right; each product exact: A is 0/1), the live counts (lane j of a
    // warp counts column j where the rows are in registers) and whether A
    // holds a value other than 0 and 1.  rows % T == 0: every lane runs
    // every iteration.
    const float* Ab = a.A + row0 * p;
    bool bad = false;
    unsigned mine = 0;  // column `lane`'s live rows of this warp
    for (int m = 0; m < per; ++m) {
        const int i = tid + m * T;
        const float* ar = Ab + static_cast<size_t>(i) * p;
        float v = 0.f;
        unsigned bits = 0;
        for (int j = 0; j < p; ++j) {
            const float aij = ar[j];
            bad |= aij != 0.f && aij != 1.f;
            const unsigned word = __ballot_sync(0xffffffffu, aij > 0.f);
            if constexpr (RR > 0) {
                bits |= static_cast<unsigned>(aij > 0.f) << j;
                mine += lane == j ? __popc(word) : 0u;
            } else if (lane == 0) {
                live[j * W + (i >> 5)] = word;
            }
            const float prod = __fmul_rn(aij, xs[j]);
            v = j ? __fadd_rn(v, prod) : prod;
        }
        v = __fsub_rn(v, a.b[row0 + i]);
        if constexpr (RR > 0) {
#pragma unroll
            for (int u = 0; u < RR; ++u)
                if (u == m) {
                    rr[u] = v;
                    msk[u] = bits;
                }
        } else {
            r[i] = v;
        }
    }
    if constexpr (RR > 0) {
        if (lane < p && mine) atomicAdd(cnt + lane, mine);
    }
    bad = __syncthreads_or(bad);
    if constexpr (RR == 0) {
        for (int j = warp; j < p; j += T / 32) {
            unsigned c = 0;
            for (int w = lane; w < W; w += 32) c += __popc(live[j * W + w]);
            c = __reduce_add_sync(0xffffffffu, c);
            if (lane == 0) cnt[j] = c;
        }
    }
    if (tid == 0) cnt[p] = bad;
    cluster_sync();  // every CTA's counts are in
    for (int j = tid; j <= p; j += T) {
        unsigned tot = 0;
        for (unsigned q = 0; q < C; ++q)
            tot += kCluster ? ld_cluster(cluster_addr(cnt + j, q)) : cnt[j];
        kth[j] = j == p ? tot : (tot ? (tot - 1) / 2 : ~0u);
    }
    __syncthreads();
    const int sweeps = kth[p] ? 0 : a.sweeps;

    int buf = 0;
    int pend = -1;  // thread 0's x_j still to be written, and its value
    float pend_x = 0.f;
    unsigned phase = 0;  // the barriers' phases, a bit each
    int pend_col = -1;  // the column whose t r still lacks (-1: none), and t
    float pend_t = 0.f;
    for (int sweep = 0; sweep < sweeps; ++sweep) {
        bool moved = false;
        for (int j = 0; j < p; ++j) {
            if (kth[j] == ~0u) continue;  // no live row: t = 0
            // the kth[j]-th smallest key of -r over the live rows: `key`
            // in every thread at the end
            unsigned prefix = 0, k = kth[j], c = 0, ctot = 0, key = 0;
            int shift = 32;  // the bits below it are still unknown
            bool local = false;
            while (true) {
                const int lo = shift > 11 ? shift - 11 : 0;
                const unsigned mask = (1u << (shift - lo)) - 1u;
                const unsigned high = high_mask(shift), bits = prefix << (shift & 31);
                unsigned* h = hist + buf * kDigitBins;
                // 1. count the next digit of the matching keys: over this
                // CTA's live rows (a cluster round; the first also adds the
                // last column's t to its live rows) or over the candidates
                if (!local && RR > 0) {
#pragma unroll
                    for (int u = 0; u < kStep; ++u) {
                        if (pend_col >= 0 && is_live(u, pend_col))
                            rr[u] = __fadd_rn(rr[u], pend_t);
                        const unsigned kk = order_key(-rr[u]);
                        if (is_live(u, j) && (kk & high) == bits)
                            atomicAdd(h + ((kk >> lo) & mask), 1u);
                    }
                } else if (!local) {
                    // the chunk's loads first: the adds may alias them
                    for (int m0 = 0; m0 < per; m0 += kStep) {
                        unsigned kk[kStep];
                        bool in[kStep];
#pragma unroll
                        for (int u = 0; u < kStep; ++u) {
                            const int m = m0 + u;
                            if (pend_col >= 0 && m < per && is_live(m, pend_col)) {
                                float* rm = r + tid + m * T;
                                *rm = __fadd_rn(*rm, pend_t);
                            }
                            in[u] = m < per && is_live(m, j);
                            kk[u] = in[u] ? order_key(-r_of(m)) : 0u;
                            in[u] = in[u] && (kk[u] & high) == bits;
                        }
#pragma unroll
                        for (int u = 0; u < kStep; ++u)
                            if (in[u]) atomicAdd(h + ((kk[u] >> lo) & mask), 1u);
                    }
                } else {
                    for (unsigned i0 = tid; i0 < ctot; i0 += kChunk * T) {
                        unsigned kk[kChunk];
#pragma unroll
                        for (int u = 0; u < kChunk; ++u) {
                            const unsigned i = i0 + u * T;
                            kk[u] = i < ctot ? cand[i] : 0u;
                        }
#pragma unroll
                        for (int u = 0; u < kChunk; ++u)
                            if (i0 + u * T < ctot && (kk[u] & high) == bits)
                                atomicAdd(h + ((kk[u] >> lo) & mask), 1u);
                    }
                }
                pend_col = -1;  // r is up to date
                __syncthreads();  // every warp's counts are in
                if (tid == 0 && pend >= 0) {  // every thread read x_pend
                    xs[pend] = pend_x;
                    pend = -1;
                }
                // 2. the sums by 32 bins: to every CTA's slot of this rank
                // (a cluster round) or to this CTA's own
                {
                    unsigned sum = 0;
#pragma unroll
                    for (int i = 0; i < B; ++i) sum += h[tid * B + i];
#pragma unroll
                    for (int o = 1; o < 32 / B; o <<= 1)
                        sum += __shfl_xor_sync(0xffffffffu, sum, o);
                    if ((lane & (32 / B - 1)) == 0) {
                        const int g = tid * B / 32;
                        if (local) {
                            own[g] = sum;
                        } else {
                            unsigned* slot = slots + (buf * kMaxCluster + rank) * kGroups + g;
                            if constexpr (kCluster) {
                                for (unsigned q = 0; q < C; ++q)
                                    st_async(slot, bars + buf, q, sum);
                            } else {
                                *slot = sum;
                            }
                        }
                    }
                }
                if (kCluster && !local) {
                    // every rank's sums in this CTA's slots
                    if (tid == 0) mbar_expect(bars + buf, C * kGroups * 4);
                    mbar_wait(bars + buf, (phase >> buf) & 1u);
                    phase ^= 1u << buf;
                } else {
                    __syncthreads();
                }
                // every CTA read the other histogram (the last round's)
                // before its sums of this round came
#pragma unroll
                for (int i = 0; i < B; ++i) hist[(buf ^ 1) * kDigitBins + tid * B + i] = 0;
                // 3. one warp finds the bin that holds k: the group sums
                // first (a lane kGroupsLane groups, over the ranks' slots),
                // then the group's bins (a lane a bin, read from every rank)
                if (warp == 0) {
                    const int ranks = local ? 1 : static_cast<int>(C);
                    unsigned gs[kGroupsLane] = {};
#pragma unroll
                    for (int q = 0; q < R; ++q) {
                        if (q < ranks) {
                            const unsigned* v =
                                (local ? own : slots + (buf * kMaxCluster + q) * kGroups) +
                                kGroupsLane * lane;
                            static_assert(kGroupsLane == 2, "a lane's groups as one uint2");
                            const uint2 w = *reinterpret_cast<const uint2*>(v);
                            gs[0] += w.x;
                            gs[1] += w.y;
                        }
                    }
                    unsigned mine = 0;
#pragma unroll
                    for (int i = 0; i < kGroupsLane; ++i) mine += gs[i];
                    unsigned inc = mine;
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
                        if (lane >= o) inc += y;
                    }
                    const unsigned below = inc - mine;
                    const int at = __ffs(__ballot_sync(
                        0xffffffffu, k >= below && k < inc)) - 1;
                    // the group in lane `at` and k's rank in it
                    unsigned gl = 0, kl = k - below;
                    bool done = false;
#pragma unroll
                    for (int i = 0; i < kGroupsLane; ++i) {
                        if (!done && kl < gs[i]) {
                            gl = kGroupsLane * lane + i;
                            done = true;
                        } else if (!done) {
                            kl -= gs[i];
                        }
                    }
                    const unsigned g = __shfl_sync(0xffffffffu, gl, at);
                    const unsigned kg = __shfl_sync(0xffffffffu, kl, at);
                    unsigned by_rank[R], tot = 0, off = 0;
                    const unsigned* hb = h + g * 32 + lane;
                    // every rank's load issued before any is used
#pragma unroll
                    for (int q = 0; q < R; ++q)
                        by_rank[q] = q >= ranks ? 0u
                                     : local || !kCluster ? *hb
                                                          : ld_cluster(cluster_addr(hb, q));
#pragma unroll
                    for (int q = 0; q < R; ++q) {
                        tot += by_rank[q];
                        off += q < static_cast<int>(rank) ? by_rank[q] : 0u;
                    }
                    unsigned binc = tot;
#pragma unroll
                    for (int o = 1; o < 32; o <<= 1) {
                        const unsigned y = __shfl_up_sync(0xffffffffu, binc, o);
                        if (lane >= o) binc += y;
                    }
                    if (kg >= binc - tot && kg < binc) {
                        sel[0] = g * 32 + lane;
                        sel[1] = kg - (binc - tot);
                        sel[2] = tot;
                        sel[3] = off;
                        sel[5] = 0;
                    }
                }
                __syncthreads();
                buf ^= 1;
                prefix = (prefix << (shift - lo)) | sel[0];
                k = sel[1];
                c = sel[2];
                shift = lo;
                if (lo == 0) {  // every bit known
                    key = prefix;
                    break;
                }
                if (!local && c <= static_cast<unsigned>(a.cap)) {
                    // the bin's keys into every CTA's candidates, at this
                    // CTA's offset; a warp takes its places for a row
                    // that has any
                    const unsigned off = sel[3];
                    for (int m0 = 0; m0 < per; m0 += kStep)
#pragma unroll
                        for (int u = 0; u < kStep; ++u) {
                            const int m = m0 + u;
                            unsigned kk = 0;
                            bool in = m < per && is_live(m, j);
                            if (in) {
                                kk = order_key(-r_of(m));
                                in = (kk >> shift) == prefix;
                            }
                            const unsigned bal = __ballot_sync(0xffffffffu, in);
                            if (bal == 0) continue;
                            unsigned pos = 0;
                            if (lane == 0)
                                pos = atomicAdd(sel + 5, static_cast<unsigned>(__popc(bal)));
                            pos = __shfl_sync(0xffffffffu, pos, 0) + off;
                            if (in) {
                                unsigned* dst = cand + pos + __popc(bal & ((1u << lane) - 1u));
                                if constexpr (kCluster) {
                                    for (unsigned q = 0; q < C; ++q)
                                        st_async(dst, bars + 2, q, kk);
                                } else {
                                    *dst = kk;
                                }
                            }
                        }
                    if constexpr (kCluster) {
                        // every CTA's candidates in this CTA's buffer
                        if (tid == 0) mbar_expect(bars + 2, c * 4);
                        mbar_wait(bars + 2, (phase >> 2) & 1u);
                        phase ^= 4u;
                    } else {
                        __syncthreads();
                    }
                    local = true;
                    ctot = c;
                }
                if (local && c <= kRankSelect) {
                    // the last candidates (gathered first where a round
                    // over the candidates left them among others) ranked
                    // at once, 4 threads a candidate
                    const unsigned* from = cand;
                    if (ctot > c) {
                        unsigned n_warp = 0;
                        for (unsigned i0 = 0; i0 < ctot; i0 += T) {
                            const unsigned i = i0 + tid;
                            n_warp += __popc(__ballot_sync(
                                0xffffffffu, i < ctot && (cand[i] >> shift) == prefix));
                        }
                        unsigned at = warp_offset(n_warp, wcnt);
                        for (unsigned i0 = 0; i0 < ctot; i0 += T) {
                            const unsigned i = i0 + tid;
                            const unsigned v = i < ctot ? cand[i] : 0u;
                            const bool in = i < ctot && (v >> shift) == prefix;
                            const unsigned bal = __ballot_sync(0xffffffffu, in);
                            if (in) last[at + __popc(bal & ((1u << lane) - 1u))] = v;
                            at += __popc(bal);
                        }
                        __syncthreads();
                        from = last;
                    }
                    const int i = tid >> 2, n = static_cast<int>(c);
                    const unsigned v = i < n ? from[i] : ~0u;
                    unsigned less = 0, le = 0;
                    int q = tid & 3;
                    for (; q + 4 * (kRankLoads - 1) < n; q += 4 * kRankLoads) {
                        unsigned o[kRankLoads];  // loads in flight at once
#pragma unroll
                        for (int u = 0; u < kRankLoads; ++u) o[u] = from[q + 4 * u];
#pragma unroll
                        for (int u = 0; u < kRankLoads; ++u) {
                            less += o[u] < v;
                            le += o[u] <= v;
                        }
                    }
                    for (; q < n; q += 4) {
                        const unsigned o = from[q];
                        less += o < v;
                        le += o <= v;
                    }
#pragma unroll
                    for (int o = 1; o < 4; o <<= 1) {
                        less += __shfl_xor_sync(0xffffffffu, less, o);
                        le += __shfl_xor_sync(0xffffffffu, le, o);
                    }
                    if ((tid & 3) == 0 && i < n && less <= k && k < le)
                        sel[4] = v;  // ties write the same value
                    __syncthreads();
                    key = sel[4];
                    break;
                }
            }
            // every thread takes t from the same x_j and key; thread 0
            // writes x_j after the next barrier, when all have read it
            const float xj = xs[j];
            const float t = fminf(fmaxf(key_value(key), -xj),
                                  __fsub_rn(ubs[j], xj));
            if (tid == 0) {
                pend = j;
                pend_x = __fadd_rn(xj, t);
            }
            if (t != 0.f) {  // r += t on column j's live rows, in the next walk
                moved = true;
                pend_col = j;
                pend_t = t;
            }
        }
        if (!moved) break;  // every later sweep would repeat this one
    }
    if (tid == 0 && pend >= 0) xs[pend] = pend_x;
    cluster_sync();  // no CTA leaves while another reads its shared memory
    if (rank == 0)
        for (int j = tid; j < p; j += T)
            a.x[static_cast<size_t>(s) * p + j] =
                kth[p] ? __uint_as_float(0x7fc00000u) : xs[j];
}

}  // namespace

// K9: one launch of G + S clusters of `cluster` CTAs (1, 2, 4 or 8) of
// 512 threads, a cluster a hap, then a cluster a species, `regs` trio
// values a thread in registers (4, 8 or 16): ops/tail_kernels.py's
// stats_plan, checked here again.  Returns a cudaError_t (0 on success);
// launches on `stream`, no synchronise.
extern "C" int tail_stats_plan_launch(
    const void* na, const void* ta, const void* bc, const void* trio_order,
    const void* hap_trio_off, const void* path_node, const void* hap_path_off,
    const void* sp_node_span, float min_depth, int G, int S, int cluster,
    int regs, void* out, void* stream) {
    const int C = kStatsCluster ? cluster : 1;
    const int R = kStatsCluster ? regs : kStatsRegsMax;
    if (G < 1 || S < 1 || C < 1 || C > kMaxCluster || kMaxCluster % C ||
        (R != 4 && R != 8 && R != kStatsRegsMax) ||
        static_cast<long long>(G + S) * C > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    const StatsArgs a{static_cast<const float*>(na), static_cast<const float*>(ta),
                      static_cast<const int*>(bc), static_cast<const int*>(trio_order),
                      static_cast<const int*>(hap_trio_off),
                      static_cast<const int*>(path_node),
                      static_cast<const int*>(hap_path_off),
                      static_cast<const int*>(sp_node_span), min_depth, G, S, C,
                      static_cast<float*>(out)};
    void (*kernel)(StatsArgs) = R == 4   ? tail_stats_kernel<4, 8>
                                : R == 8 ? tail_stats_kernel<8, 16>
                                         : tail_stats_kernel<kStatsRegsMax, 16>;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(G + S) * C);
    cfg.blockDim = dim3(kStatsThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaError_t e;
    if (C > 1) {
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// K9 at the plan of G and S alone (the smallest cluster whose CTAs fill the
// card's SMs, 16 trio values a thread): the entry of earlier sources, whose
// signature it keeps.
extern "C" int tail_stats_launch(
    const void* na, const void* ta, const void* bc, const void* trio_order,
    const void* hap_trio_off, const void* path_node, const void* hap_path_off,
    const void* sp_node_span, float min_depth, int G, int S, void* out,
    void* stream) {
    int C = 1;
    while (C < kMaxCluster && static_cast<long long>(G + S) * C < kStatsSMs) C *= 2;
    return tail_stats_plan_launch(na, ta, bc, trio_order, hap_trio_off, path_node,
                                  hap_path_off, sp_node_span, min_depth, G, S, C,
                                  kStatsRegsMax, out, stream);
}

// K10b: S clusters of `cluster` CTAs of 1024 threads an instance, n /
// cluster rows a CTA (ops/tail_kernels.py's polish_plan, checked here
// again: the candidates and the shared memory follow from n, p, the
// cluster and on_chip).  `r` is a float scratch where `on_chip` is 0: r [S, n], then,
// where the live bits do not fit shared memory, S * cluster * p * (n /
// cluster / 32) words of them.  Returns a cudaError_t.
extern "C" int polish_launch(const void* A, const void* b, const void* x0,
                             const void* ub, int S, int n, int p, int sweeps,
                             int cluster, int on_chip, void* r, void* x,
                             void* stream) {
    const int C = cluster;
    PolishLayout L;
    if (S < 1 || p < 1 || sweeps < 0 || C < 1 || C > kMaxCluster ||
        kMaxCluster % C || n < 1 || n % (C * kPolishThreads) ||
        (!on_chip && r == nullptr) || !polish_layout(n, p, C, on_chip, &L) ||
        L.smem > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    const PolishArgs a{static_cast<const float*>(A), static_cast<const float*>(b),
                       static_cast<const float*>(x0), static_cast<const float*>(ub),
                       static_cast<float*>(r), static_cast<float*>(x),
                       n, p, sweeps, L.rows, L.cap, on_chip, L.bits_on_chip};
    void (*kernel)(PolishArgs) =
        C > 1 ? (L.reg_rows == kRegRows ? polish_kernel<true, kRegRows>
                 : L.reg_rows ? polish_kernel<true, 4> : polish_kernel<true, 0>)
              : (L.reg_rows == kRegRows ? polish_kernel<false, kRegRows>
                 : L.reg_rows ? polish_kernel<false, 4> : polish_kernel<false, 0>);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(S) * C);
    cfg.blockDim = dim3(kPolishThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(L.smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    if (C > 1) {
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}
