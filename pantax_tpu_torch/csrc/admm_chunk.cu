// K8: the strain solve's batched ADMM chunk for Hopper (sm_90a).
//
// Replaces the JAX package's _admm_chunk_batch (pantax_tpu/profile/pao.py
// :133), a jitted vmap of _admm_chunk_impl (:111) over a lax.scan of
// _admm_scan's step (:60-80), which XLA compiles into one device program
// a chunk.  For each of S instances of min (1/n)||Ax - b||_1, 0 <= x <= ub
// (A float32 [n, p], n the padded row count; ub 0 pins a path), `iters`
// steps of the two-block ADMM with over-relaxation (alpha 1.6):
//   rhs = A^T (b + z - uz) + (w - uw);  x = L^-T L^-1 rhs  (L L^T = A^T A + I)
//   Ax_r = alpha Ax + (1 - alpha)(z + b);  x_r = alpha x + (1 - alpha) w
//   z = soft(Ax_r - b + uz, 1 / (n rho));  w = min(max(x_r + uw, 0), ub)
//   uz += Ax_r - b - z;  uw += x_r - w
// then the state and res = max(max|Ax - b - z|, max|x - w|, max|w - w_in|),
// Ax the last step's (A times the final x).  The plain torch version
// (pantax_tpu_torch/profile/pao.py, _admm_chunk_batch_plain) runs the same
// steps as ~30 small torch operations a step: two gemv passes over A in
// device memory and ~9,000 launches a chunk of 250 steps.
//
// What bounds it.  A step is a few dozen instructions a row (p for A^T v,
// p for Ax, ~14 for the elementwise updates at p 4) and a chain of
// latencies: the rows' partial sums of A^T v must meet before the p x p
// solve, and the solve's x must reach every row before the next step.  The
// bytes are small: A, b and the state are read once and the state written
// once.  So the least time is the rows' instructions over the card's issue
// rate (chip_smoke.admm_bound); what keeps the kernel from it is the chain
// of barriers and the serial solve, 250 times a chunk.
//
// The design: one launch runs every step of the chunk for every instance.
// One thread block cluster of kCluster CTAs holds one instance; the
// instance's n rows are cut into kCluster slices, one a CTA, and a CTA's
// threads take rows tid, tid + T, ... (R rows a thread).  On chip (R <= 8,
// and the slice's A and b fit in shared memory) each thread keeps its
// rows' z and uz in registers and A and b sit in shared memory for all
// steps; otherwise (streamed) A and b are read from global memory and z,
// uz read and written there every step (the instance's rows stay in L2).
// A^T v is a reduction in a fixed order: each thread sums its rows, 4
// columns at a time; warp shuffles (an xor butterfly); the warps' sums of
// the 4 columns in shared memory, added by one warp per column before the
// next 4 columns start (so shared memory does not grow with p times the
// warps); then each CTA reads all kCluster CTA sums through distributed
// shared memory in rank order 0..7.
// So every CTA gets the same rhs bits, solves the p x p system itself (one
// warp: column-oriented forward and backward substitution, L in shared
// memory up to p 128, else read from global memory), and holds the same x:
// no broadcast.  The CTA sums are double-buffered, so one cluster barrier
// a step is enough; one more before exit keeps a CTA's shared memory alive
// while rank 0 reads the residual maxima.  No float atomics: two launches
// on the same inputs give the same bits.  Buckets of p 4 (every tail's in
// the smoke DBs) take instantiations with p known to the compiler: 40-64
// registers and no spills, where the code for any p spills at 64
// registers a thread (1024 threads) and took 1.78x as long at
// (10, 65536, 4) (PERF.md, section 6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // CTAs a cluster (portable)
constexpr int kMaxThreads = 1024;
constexpr int kLShared = 128;      // p up to which L sits in shared memory
constexpr float kAlpha = 1.6f;     // over-relaxation, as the plain version
constexpr float kBeta = static_cast<float>(1.0 - 1.6);  // 1 - alpha
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

struct Args {
    const float* A;    // [S, n, p]
    const float* b;    // [S, n]
    const float* ub;   // [S, p]
    const float* z0;   // [S, n]
    const float* w0;   // [S, p]
    const float* uz0;  // [S, n]
    const float* uw0;  // [S, p]
    const float* L;    // [S, p, p] at strides Lb, Li, Lj (elements)
    long long Lb, Li, Lj;
    float* x;          // [S, p] outputs, fresh
    float* z;          // [S, n]
    float* w;          // [S, p]
    float* uz;         // [S, n]
    float* uw;         // [S, p]
    float* res;        // [S]
    int n, p, iters, rpt;
    float thresh;      // 1 / (n rho)
};

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;  // a NaN wins, as torch's max
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o; o >>= 1)
        v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 x) {
    return a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
}

// shared memory, in floats: on chip the slice's A [rows, p] and b [rows];
// x, w, uw, ub, w_entry, rhs, y [p] each; the CTA sums [2][p]; the warps'
// sums of 4 columns [2][4][W]; the residual maxima [33]; L [p, p] up to
// kLShared (ops/admm.py's smem_bytes, which the launch plan fits)
inline long long smem_floats(int threads, int rpt, int p, bool on_chip) {
    const long long rows = static_cast<long long>(threads) * rpt;
    return (on_chip ? rows * (p + 1) : 0) + 9LL * p + 8LL * (threads / 32) +
           33 + (p <= kLShared ? static_cast<long long>(p) * p : 0);
}

// R > 0: on chip, R rows a thread with z and uz in registers; R == 0:
// streamed, a.rpt rows a thread with z and uz in the outputs.  PC > 0:
// p == PC, known to the compiler (the tails' buckets are p 4); PC == 0:
// any p, a multiple of 4
template <int R, int PC>
__global__ void __launch_bounds__(kMaxThreads, 1) admm_chunk_kernel(Args a) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const int s = blockIdx.x / kCluster;
    const int T = blockDim.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    const int P = PC > 0 ? PC : a.p;
    const int rpt = R > 0 ? R : a.rpt;
    const int rows = rpt * T;
    const size_t row0 = static_cast<size_t>(s) * a.n +
                        static_cast<size_t>(rank) * rows;

    extern __shared__ float4 smem4[];
    float* A_s = reinterpret_cast<float*>(smem4);
    float* b_s = A_s + (R > 0 ? static_cast<size_t>(rows) * P : 0);
    float* x_s = b_s + (R > 0 ? rows : 0);
    float* w_s = x_s + P;
    float* uw_s = w_s + P;
    float* ub_s = uw_s + P;
    float* we_s = ub_s + P;
    float* r_s = we_s + P;
    float* y_s = r_s + P;
    float* cpart = y_s + P;         // [2][P]
    float* wpart = cpart + 2 * P;   // [2][4][W]
    float* red = wpart + 8 * W;     // [32] the warps' maxima, [32] the CTA's
    float* L_s = red + 33;

    const float* Ag = a.A + row0 * P;
    const float* bg = a.b + row0;
    float* zo = a.z + row0;
    float* uzo = a.uz + row0;
    const float* Lg = a.L + static_cast<long long>(s) * a.Lb;
    const bool l_shared = P <= kLShared;

    for (int j = tid; j < P; j += T) {
        const size_t k = static_cast<size_t>(s) * P + j;
        w_s[j] = a.w0[k];
        we_s[j] = a.w0[k];
        uw_s[j] = a.uw0[k];
        ub_s[j] = a.ub[k];
    }
    if (l_shared)
        for (int k = tid; k < P * P; k += T)
            L_s[k] = Lg[(k / P) * a.Li + (k % P) * a.Lj];
    float z[R > 0 ? R : 1], uz[R > 0 ? R : 1];
    if constexpr (R > 0) {
        const float4* src = reinterpret_cast<const float4*>(Ag);
        float4* dst = reinterpret_cast<float4*>(A_s);
        for (int k = tid; k < rows * P / 4; k += T) dst[k] = __ldg(src + k);
        for (int k = tid; k < rows; k += T) b_s[k] = __ldg(bg + k);
#pragma unroll
        for (int m = 0; m < R; ++m) {
            z[m] = a.z0[row0 + m * T + tid];
            uz[m] = a.uz0[row0 + m * T + tid];
        }
    } else {
        for (int m = 0; m < rpt; ++m) {
            zo[m * T + tid] = a.z0[row0 + m * T + tid];
            uzo[m * T + tid] = a.uz0[row0 + m * T + tid];
        }
    }
    __syncthreads();

    // L(i, j), from shared or global memory
    auto Lij = [&](int i, int j) -> float {
        return l_shared ? L_s[i * P + j] : __ldg(Lg + i * a.Li + j * a.Lj);
    };
    // row `local` of this CTA's slice: its A (first 4 columns from jb), b
    auto a_row = [&](int local, int jb) -> float4 {
        if constexpr (R > 0)
            return *reinterpret_cast<const float4*>(
                A_s + static_cast<size_t>(local) * P + jb);
        else
            return __ldg(reinterpret_cast<const float4*>(
                Ag + static_cast<size_t>(local) * P + jb));
    };
    auto b_row = [&](int local) -> float {
        if constexpr (R > 0) return b_s[local];
        else return __ldg(bg + local);
    };
    // the CTA's sums of 4 columns from jb into cdst: the warp's sums into
    // wpart (two buffers, taken in turn: a block's writes follow the
    // barrier that ends the reads of the block two before), then one warp
    // a column adds the warps' sums in a fixed order
    auto put_block = [&](int jb, float4 acc, float* cdst) {
        acc.x = warp_sum(acc.x);
        acc.y = warp_sum(acc.y);
        acc.z = warp_sum(acc.z);
        acc.w = warp_sum(acc.w);
        float* wp = wpart + ((jb >> 2) & 1) * 4 * W;
        if (lane == 0) {
            wp[0 * W + warp] = acc.x;
            wp[1 * W + warp] = acc.y;
            wp[2 * W + warp] = acc.z;
            wp[3 * W + warp] = acc.w;
        }
        __syncthreads();
        for (int c = warp; c < 4; c += W) {
            const float v = warp_sum(lane < W ? wp[c * W + lane] : 0.f);
            if (lane == 0) cdst[jb + c] = v;
        }
    };

    float rz = 0.f;  // this thread's max |Ax - b - z| after the last step
    // k == -1: the prologue (the partial sums of the entry state)
    for (int k = -1; k < a.iters; ++k) {
        const bool update = k >= 0, last = k == a.iters - 1;
        if (update) {
            cluster.sync();  // every CTA's sums of step k are in cpart[k & 1]
            if (warp == 0) {
                float* cbuf = cpart + (k & 1) * P;
                for (int j = lane; j < P; j += 32) {
                    float acc = 0.f;
#pragma unroll
                    for (int r = 0; r < kCluster; ++r)
                        acc += cluster.map_shared_rank(cbuf, r)[j];
                    r_s[j] = acc + (w_s[j] - uw_s[j]);
                }
                __syncwarp();
                for (int i = 0; i < P; ++i) {  // L y = rhs
                    const float yi = r_s[i] / Lij(i, i);
                    if (lane == 0) y_s[i] = yi;
                    for (int j = i + 1 + lane; j < P; j += 32)
                        r_s[j] -= Lij(j, i) * yi;
                    __syncwarp();
                }
                for (int i = P - 1; i >= 0; --i) {  // L^T x = y
                    const float xi = y_s[i] / Lij(i, i);
                    if (lane == 0) x_s[i] = xi;
                    for (int j = lane; j < i; j += 32)
                        y_s[j] -= Lij(i, j) * xi;
                    __syncwarp();
                }
                for (int j = lane; j < P; j += 32) {
                    const float xj = x_s[j], wj = w_s[j], uwj = uw_s[j];
                    const float xr = kAlpha * xj + kBeta * wj;
                    const float wn = fminf(fmaxf(xr + uwj, 0.f), ub_s[j]);
                    uw_s[j] = (uwj + xr) - wn;
                    w_s[j] = wn;
                }
            }
            __syncthreads();  // x of step k in x_s
        }
        // the rows: step k's update, then the partial sums of step k + 1
        const float4 x4 = *reinterpret_cast<const float4*>(x_s);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int m = 0; m < rpt; ++m) {
            const int local = m * T + tid;
            const float4 a4 = a_row(local, 0);
            const float bb = b_row(local);
            float zz, uu;
            if constexpr (R > 0) {
                zz = z[m];
                uu = uz[m];
            } else {
                zz = zo[local];
                uu = uzo[local];
            }
            if (update) {
                float ax = dot4(a4, x4);
                for (int jb = 4; jb < P; jb += 4)
                    ax += dot4(a_row(local, jb),
                               *reinterpret_cast<const float4*>(x_s + jb));
                const float axr = kAlpha * ax + kBeta * (zz + bb);
                const float zn = (axr - bb) + uu;
                const float zs = copysignf(fmaxf(fabsf(zn) - a.thresh, 0.f),
                                           zn);
                uu = ((uu + axr) - bb) - zs;
                zz = zs;
                if (last) rz = nan_max(rz, fabsf((ax - bb) - zz));
                if constexpr (R > 0) {
                    z[m] = zz;
                    uz[m] = uu;
                } else {
                    zo[local] = zz;
                    uzo[local] = uu;
                }
            }
            if (!last) {
                const float v = (bb + zz) - uu;
                acc.x += a4.x * v;
                acc.y += a4.y * v;
                acc.z += a4.z * v;
                acc.w += a4.w * v;
            }
        }
        if (last) break;
        float* cdst = cpart + ((k + 1) & 1) * P;
        put_block(0, acc, cdst);
        for (int jb = 4; jb < P; jb += 4) {  // wide rows, 4 columns a pass
            float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int m = 0; m < rpt; ++m) {
                const int local = m * T + tid;
                float v;
                if constexpr (R > 0) v = (b_s[local] + z[m]) - uz[m];
                else v = (b_row(local) + zo[local]) - uzo[local];
                const float4 a4 = a_row(local, jb);
                c.x += a4.x * v;
                c.y += a4.y * v;
                c.z += a4.z * v;
                c.w += a4.w * v;
            }
            put_block(jb, c, cdst);
        }
    }

    if constexpr (R > 0) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
            zo[m * T + tid] = z[m];
            uzo[m * T + tid] = uz[m];
        }
    }
    rz = warp_max(rz);
    if (lane == 0) red[warp] = rz;
    __syncthreads();
    if (tid == 0) {
        float m = red[0];
        for (int i = 1; i < W; ++i) m = nan_max(m, red[i]);
        red[32] = m;
    }
    cluster.sync();  // every CTA's maximum in red[32]
    if (rank == 0) {
        if (warp == 0) {
            float m = 0.f;
            for (int j = lane; j < P; j += 32) {
                m = nan_max(m, fabsf(x_s[j] - w_s[j]));
                m = nan_max(m, fabsf(w_s[j] - we_s[j]));
            }
            if (lane < kCluster)
                m = nan_max(m, cluster.map_shared_rank(red + 32, lane)[0]);
            m = warp_max(m);
            if (lane == 0) a.res[s] = m;
        }
        for (int j = tid; j < P; j += T) {
            const size_t k = static_cast<size_t>(s) * P + j;
            a.x[k] = x_s[j];
            a.w[k] = w_s[j];
            a.uw[k] = uw_s[j];
        }
    }
    cluster.sync();  // no CTA leaves while rank 0 reads its shared memory
}

template <int R, int PC>
cudaError_t launch(const Args& a, int S, int threads, int smem,
                   cudaStream_t stream) {
    auto kernel = admm_chunk_kernel<R, PC>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(S) * kCluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

template <int PC>
cudaError_t dispatch(const Args& a, int S, int threads, int rpt, int on_chip,
                     int smem, cudaStream_t st) {
    if (!on_chip) return launch<0, PC>(a, S, threads, smem, st);
    if (rpt == 1) return launch<1, PC>(a, S, threads, smem, st);
    if (rpt == 2) return launch<2, PC>(a, S, threads, smem, st);
    if (rpt == 4) return launch<4, PC>(a, S, threads, smem, st);
    if (rpt == 8) return launch<8, PC>(a, S, threads, smem, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// The launch plan (threads, rows a thread, on chip or streamed) comes from
// ops/admm.py's launch_plan; it is checked here again, with its shared
// memory.  Returns a cudaError_t (0 on success); launches on `stream`, no
// synchronise.
extern "C" int admm_chunk_launch(
    const void* A, const void* b, const void* ub, const void* z0,
    const void* w0, const void* uz0, const void* uw0, const void* L,
    long long Lb, long long Li, long long Lj, int S, int n, int p, int iters,
    float thresh, int threads, int rpt, int on_chip, void* x, void* z,
    void* w, void* uz, void* uw, void* res, void* stream) {
    const long long smem = 4 * smem_floats(threads, rpt, p, on_chip);
    if (S < 1 || p < 4 || p % 4 || iters < 1 || threads < 32 ||
        threads > kMaxThreads || threads % 32 || rpt < 1 ||
        static_cast<long long>(kCluster) * threads * rpt != n ||
        smem > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const float*>(A), static_cast<const float*>(b),
                 static_cast<const float*>(ub), static_cast<const float*>(z0),
                 static_cast<const float*>(w0), static_cast<const float*>(uz0),
                 static_cast<const float*>(uw0), static_cast<const float*>(L),
                 Lb, Li, Lj,
                 static_cast<float*>(x), static_cast<float*>(z),
                 static_cast<float*>(w), static_cast<float*>(uz),
                 static_cast<float*>(uw), static_cast<float*>(res),
                 n, p, iters, rpt, thresh};
    const auto st = static_cast<cudaStream_t>(stream);
    const int sm = static_cast<int>(smem);
    return static_cast<int>(
        p == 4 ? dispatch<4>(a, S, threads, rpt, on_chip, sm, st)
               : dispatch<0>(a, S, threads, rpt, on_chip, sm, st));
}
