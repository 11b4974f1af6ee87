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
// One launch runs every step of the chunk for every instance: one thread
// block cluster an instance, its rows cut among the cluster's CTAs and a
// CTA's threads (rows tid, tid + T, ...: R a thread).  A^T v is summed in
// a fixed order (a thread's rows, the lanes, the warps, the CTAs in rank
// order), so every CTA holds the same rhs bits and solves the same system
// itself: no broadcast, no float atomics, and two launches on the same
// inputs give the same bits.  Two plans (ops/admm.py's launch_plan):
//
// The bits plan (admm_chunk_bits_kernel), for A the callers know to be
// 0/1 (every A the port's solvers build), p_pad up to 64 and the solvers'
// buckets of 4096-65536 rows.  Each row's 0/1 entries are packed into bits
// once.  At p 4 a thread's rows sit in registers for all the steps (their
// bits in one 32-bit word for 8 rows, b, and c = beta (z + b) + (uz - b),
// which turns a row's step into ~10 instructions); wider, they sit in
// shared memory and run in a loop (the column sums take the registers).
// A set bit adds x_j or adds v into column j, the arithmetic of a
// multiply-add by 1; Ax reads a table of x's sums over each 4 columns' 16
// subsets.  The cluster is sized to the bucket by a measured table (1-8
// CTAs, at most 8 rows a thread).  A step's chain: the rows; a warp
// reduction that leaves lane l with column l's sum; one CTA barrier; one
// warp a column adds the warps' sums and pushes the CTA's sum into slot
// `rank` of every CTA of the cluster with st.async, whose bytes land on
// that CTA's barrier (mbarrier, double-buffered): no cluster barrier a
// step, each CTA waits only for its slots to fill.  Then, at p 4, every
// warp adds the slots in rank order from its own shared memory, solves the
// 4 x 4 system in registers and builds its own table; wider, warp 0 does
// with lane j holding row j (a column-oriented substitution, y_i and x_i
// passed by shuffle, L in shared memory by columns and by rows) and
// publishes x and the CTA's table behind a CTA barrier.
//
// The float plan (admm_chunk_kernel), for any other A or bucket: a cluster
// of 8 CTAs; on chip (R <= 8, and the slice's A and b fit in shared
// memory) each thread keeps its rows' z and uz in registers and A and b
// sit in shared memory for all steps; otherwise (streamed) A and b are
// read from global memory and z, uz read and written there every step.
// The warps' sums of 4 columns go through shared memory, added by one warp
// per column; each CTA reads all 8 CTA sums through distributed shared
// memory in rank order after the cluster barrier and one warp solves
// (L in shared memory up to p 128, else read from global memory).  Buckets
// of p 4 take instantiations with p known to the compiler: the code for
// any p spills at 64 registers a thread (1024 threads).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The bits plan: A known to be 0/1, p_pad up to 64 (PC = 4, 8, 16, 32 or
// 64, the columns past p_pad zero with L_jj 1), 1-8 CTAs an instance

constexpr int kBitsCluster = 8;   // the largest cluster: slots a buffer
constexpr int kSumStride = 33;    // the warps' column sums, [PC][33]

// a thread's rows (their bits, b and c): in registers at p 4, in shared
// memory at the wider widths (whose column sums take the registers)
__host__ __device__ constexpr bool rows_in_registers(int pc) {
    return pc == 4;
}

// shared memory, in floats: the slots' two barriers [4]; the CTA sums'
// slots [2][8][PC]; L (p 4: [4][4] with 1 / L_jj on the diagonal; wider:
// by columns and by rows, [2][PC][PC]); the tables of x's subset sums (p 4:
// each warp's [W][16]; wider: the CTA's [PC / 4][16]); x (wider), 1 / L_jj,
// ub, w at entry [PC] each; the rows' b, c, v [3][rows] and bits
// [words][threads] where not in registers; the warps' column sums
// [PC][33]; the residual maxima [33] (ops/admm.py's bits_smem_bytes)
inline long long bits_smem_floats(int threads, int rpt, int pc) {
    const long long W = threads / 32;
    const long long rows = static_cast<long long>(threads) * rpt;
    const long long words = threads * ((rpt * pc + 31) / 32);
    return 4 + 2LL * kBitsCluster * pc + (pc > 4 ? 2LL * pc * pc : 16) +
           (pc == 4 ? W * 16 : 4LL * pc) + 4LL * pc +
           (rows_in_registers(pc) ? 0 : 3 * rows + words) + kSumStride * pc +
           33;
}

// V values a lane summed over the warp's lanes in a fixed order: each
// round halves the values a lane holds (the lane whose bit O is set keeps
// the odd ones and takes its partner's), then plain rounds.  Lane l ends
// with the sum of value l % V in v[0] (V <= 32, a power of 2)
template <int V, int O = 1>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
    if constexpr (O < 32) {
        if constexpr (V > 1) {
            const bool hi = lane & O;
#pragma unroll
            for (int i = 0; i < V / 2; ++i) {
                const float keep = hi ? v[2 * i + 1] : v[2 * i];
                const float send = hi ? v[2 * i] : v[2 * i + 1];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
            }
            reduce_scatter<V / 2, O * 2>(v, lane);
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
            reduce_scatter<1, O * 2>(v, lane);
        }
    }
}

// The CTA sums' exchange: a CTA's barrier counts the bytes that land in a
// buffer of its slots; st_async stores a float into CTA `rank`'s copy of a
// slot and counts it on that CTA's barrier (no cluster barrier a step)
__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
    return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
                 : "memory");
}

// the barrier's next phase: one arrival, `bytes` to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra.uni WAIT;\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void st_async(float* dst, uint64_t* bar,
                                         unsigned rank, float v) {
    unsigned d, b;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(d)
                 : "r"(smem_u32(dst)), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(b)
                 : "r"(smem_u32(bar)), "r"(rank));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];" ::"r"(d),
        "r"(__float_as_uint(v)), "r"(b)
        : "memory");
}

template <int R, int PC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    admm_chunk_bits_kernel(Args a, int C) {
    constexpr bool kRegs = rows_in_registers(PC);
    constexpr int NW = (R * PC + 31) / 32;  // words of a thread's bits
    constexpr int G = PC / 4;               // 4-column groups (tables)
    constexpr int CB = PC < 8 ? PC : 8;     // columns summed a pass
    // the columns a lane holds: all four at p 4 (every warp solves);
    // wider, column lane + 32 u of warp 0 (warp 0 solves)
    constexpr int NC = PC == 4 ? 4 : (PC > 32 ? PC / 32 : 1);
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const int s = blockIdx.x / C;
    const int T = blockDim.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
    const int p = a.p;
    const float t = a.thresh;
    // this CTA's rows (row `local` of the slice at offset local)
    const size_t row0 = static_cast<size_t>(s) * a.n +
                        static_cast<size_t>(rank) * (R * T);
    const float* A0 = a.A + row0 * p;

    extern __shared__ float4 smem4[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [2] the slots'
    float* slot = reinterpret_cast<float*>(smem4) + 4;    // [2][8][PC]
    float* Ls = slot + 2 * kBitsCluster * PC;
    float* tab = Ls + (PC > 4 ? 2 * PC * PC : 16);   // [W][16] or [G][16]
    float* x_s = tab + (PC == 4 ? W * 16 : 4 * PC);  // [PC] (wider)
    float* dinv = x_s + PC;
    float* ub_s = dinv + PC;
    float* we_s = ub_s + PC;
    float* b_s = we_s + PC;                          // [3][R * T]
    float* c_s = b_s + R * T;
    float* v_s = c_s + R * T;
    uint32_t* bw_s = reinterpret_cast<uint32_t*>(v_s + R * T);  // [NW][T]
    float* wsum = b_s + (kRegs ? 0 : 3 * R * T + NW * T);  // [PC][33]
    float* red = wsum + kSumStride * PC;  // [32] the warps' maxima, [32] CTA

    // each buffer of slots takes C ranks' PC sums a step
    const unsigned slot_bytes = C * PC * sizeof(float);
    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        mbar_expect(bar, slot_bytes);      // step 0
        mbar_expect(bar + 1, slot_bytes);  // step 1
    }
    cluster.sync();  // every CTA's barriers set before any CTA pushes

    const float* Lg = a.L + static_cast<long long>(s) * a.Lb;
    auto Lij = [&](int i, int j) -> float {
        return __ldg(Lg + i * a.Li + j * a.Lj);
    };
    for (int j = tid; j < PC; j += T) {
        const bool in = j < p;
        const size_t k = static_cast<size_t>(s) * p + j;
        dinv[j] = in ? 1.f / Lij(j, j) : 1.f;
        ub_s[j] = in ? a.ub[k] : 0.f;
        we_s[j] = in ? a.w0[k] : 0.f;
    }
    if constexpr (PC == 4) {
        for (int k = tid; k < 16; k += T) {
            const int i = k >> 2, j = k & 3;
            Ls[k] = i == j ? 1.f / Lij(i, i) : (j < i ? Lij(i, j) : 0.f);
        }
    } else {
        for (int k = tid; k < PC * PC; k += T) {
            const int i = k / PC, j = k % PC;
            const bool in = i < p && j < p;
            Ls[k] = in && j > i ? Lij(j, i) : 0.f;            // column i
            Ls[PC * PC + k] = in && j < i ? Lij(i, j) : 0.f;  // row i
        }
    }

    // A row carries b and c = beta (z + b) + (uz - b): a step is
    //   zn = alpha Ax + c  (= Ax_r - b + uz),  uz = clamp(zn, -t, t),
    //   z = zn - uz  (the soft threshold),  v = (b + z) - uz,
    //   c = beta (b + z) + (uz - b)
    // (the plain version's arithmetic, its sums reassociated)
    uint32_t bw[kRegs ? NW : 1];  // row m's column j at bit m * PC + j
    float rb[kRegs ? R : 1], rc[kRegs ? R : 1];
    auto word = [&](int i) -> uint32_t {
        if constexpr (kRegs) return bw[i];
        else return bw_s[i * T + tid];
    };
    auto row_b = [&](int m) -> float {
        if constexpr (kRegs) return rb[m];
        else return b_s[m * T + tid];
    };
    auto row_c = [&](int m) -> float {
        if constexpr (kRegs) return rc[m];
        else return c_s[m * T + tid];
    };
    auto set_c = [&](int m, float c) {
        if constexpr (kRegs) rc[m] = c;
        else c_s[m * T + tid] = c;
    };
    auto bit = [&](int m, int j) -> bool {
        const int at = m * PC + j;
        return (word(at / 32) >> (at % 32)) & 1u;
    };
    auto nibble = [&](int m, int q) -> int {
        const int at = m * PC + 4 * q;
        return (word(at / 32) >> (at % 32)) & 15;
    };
    // a pass's warp sums of CB columns from j0: lane l < CB holds j0 + l
    auto put_warp_sums = [&](float* acc, int j0) {
        reduce_scatter<CB>(acc, lane);
        if (lane < CB) wsum[(j0 + lane) * kSumStride + warp] = acc[0];
    };
    // wider: A^T v from v_s, CB columns a pass
    auto wide_sums = [&]() {
#pragma unroll
        for (int j0 = 0; j0 < PC; j0 += CB) {
            float acc[CB];
#pragma unroll
            for (int j = 0; j < CB; ++j) acc[j] = 0.f;
#pragma unroll 1
            for (int m = 0; m < R; ++m) {
                const float v = v_s[m * T + tid];
#pragma unroll
                for (int j = 0; j < CB; ++j)
                    if (bit(m, j0 + j)) acc[j] += v;
            }
            put_warp_sums(acc, j0);
        }
    };
    // one warp a column: the warps' sums in order, pushed into slot
    // `rank` of every CTA of the cluster (buffer `parity`)
    auto push_sums = [&](int parity) {
        __syncthreads();
        float* sl = slot + parity * kBitsCluster * PC;
        for (int c = warp; c < PC; c += W) {
            const float t = warp_sum(lane < W ? wsum[c * kSumStride + lane]
                                              : 0.f);
            if (lane < C)  // slot `rank` of every CTA in the cluster
                st_async(sl + rank * PC + c, bar + parity, lane, t);
        }
    };

    // p 4's rows are unrolled (registers); the wider widths' rows, in
    // shared memory, run in a loop
    {  // the rows' bits, b and c; the sums of the entry state
#pragma unroll
        for (int i = 0; i < NW; ++i) {
            if constexpr (kRegs) bw[i] = 0u;
            else bw_s[i * T + tid] = 0u;
        }
#pragma unroll(kRegs ? R : 1)
        for (int m = 0; m < R; ++m) {
            const int local = m * T + tid;
            const float4* arow =
                reinterpret_cast<const float4*>(A0 + local * p);
#pragma unroll
            for (int h = 0; h < (PC + 31) / 32; ++h) {  // 32 columns a word
                uint32_t bits = 0u;
#pragma unroll
                for (int q = 0; q < (PC < 32 ? G : 8); ++q) {
                    const int col = 32 * h + 4 * q;
                    if (col < p) {
                        const float4 e = __ldg(arow + col / 4);
                        bits |= (static_cast<uint32_t>(e.x != 0.f) |
                                 static_cast<uint32_t>(e.y != 0.f) << 1 |
                                 static_cast<uint32_t>(e.z != 0.f) << 2 |
                                 static_cast<uint32_t>(e.w != 0.f) << 3)
                                << (4 * q);
                    }
                }
                const int at = m * PC + 32 * h;
                if constexpr (kRegs) bw[at / 32] |= bits << (at % 32);
                else bw_s[(at / 32) * T + tid] |= bits << (at % 32);
            }
            const float bb = __ldg(a.b + row0 + local);
            const float sum = bb + a.z0[row0 + local];
            const float uu = a.uz0[row0 + local];
            if constexpr (kRegs) rb[m] = bb;
            else b_s[local] = bb;
            set_c(m, fmaf(kBeta, sum, uu - bb));
            if constexpr (PC > 4) v_s[local] = sum - uu;
        }
        if constexpr (PC == 4) {  // v = (b + z) - uz again, as a step sums
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll(kRegs ? R : 1)
            for (int m = 0; m < R; ++m) {
                const int local = m * T + tid;
                const float v = (row_b(m) + a.z0[row0 + local]) -
                                a.uz0[row0 + local];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (bit(m, j)) acc[j] += v;
            }
            put_warp_sums(acc, 0);
        } else {
            wide_sums();
        }
        push_sums(0);
    }
    // x, w, uw of the lane's columns (lanes past PC mirror column l % PC)
    float xs[NC], ws[NC], uws[NC];
#pragma unroll
    for (int u = 0; u < NC; ++u) {
        const int c = PC == 4 ? u : (lane + 32 * u) & (PC - 1);
        const size_t k = static_cast<size_t>(s) * p + c;
        xs[u] = 0.f;
        ws[u] = c < p ? a.w0[k] : 0.f;
        uws[u] = c < p ? a.uw0[k] : 0.f;
    }
    float* tw = PC == 4 ? tab + warp * 16 : tab;  // the x table this warp reads
    float rmax = 0.f;  // this thread's max |Ax - b - z| after the last step
    // the rows' step; the last writes z and uz and takes rmax instead
    auto rows = [&](auto last_tag) {
        constexpr bool kLast = decltype(last_tag)::value;
        float acc[CB];
#pragma unroll
        for (int j = 0; j < CB; ++j) acc[j] = 0.f;
#pragma unroll(kRegs ? R : 1)
        for (int m = 0; m < R; ++m) {
            const int local = m * T + tid;
            const float bb = row_b(m);
            float ax = tw[nibble(m, 0)];
#pragma unroll
            for (int q = 1; q < G; ++q) ax += tw[16 * q + nibble(m, q)];
            const float zn = fmaf(kAlpha, ax, row_c(m));
            const float uu = fminf(fmaxf(zn, -t), t);
            const float zz = zn - uu;
            if constexpr (kLast) {
                a.z[row0 + local] = zz;
                a.uz[row0 + local] = uu;
                rmax = nan_max(rmax, fabsf((ax - bb) - zz));
            } else {
                const float sum = bb + zz;
                const float v = sum - uu;
                set_c(m, fmaf(kBeta, sum, uu - bb));
                if constexpr (PC == 4) {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (bit(m, j)) acc[j] += v;
                } else {
                    v_s[local] = v;
                }
            }
        }
        if constexpr (!kLast) {
            if constexpr (PC == 4) put_warp_sums(acc, 0);
            else wide_sums();
        }
    };

    for (int k = 0; k < a.iters; ++k) {
        // every CTA's sums of step k in this CTA's slots (k & 1); then the
        // buffer's barrier waits for step k + 2's
        mbar_wait(bar + (k & 1), (k >> 1) & 1);
        if (tid == 0) mbar_expect(bar + (k & 1), slot_bytes);
        const float* sl = slot + (k & 1) * kBitsCluster * PC;
        // the CTA sums of rank r, as this CTA reads them
        auto slot_of = [&](int r) -> const float* { return sl + r * PC; };
        if constexpr (PC == 4) {
            // every warp: the slots in rank order, L y = rhs, L^T x = y
            // column by column (Ls[4 i + j] = L(i, j) below the
            // diagonal, 1 / L(i, i) on it)
            float4 q = *reinterpret_cast<const float4*>(slot_of(0));
            for (int r = 1; r < C; ++r) {
                const float4 o = *reinterpret_cast<const float4*>(slot_of(r));
                q.x += o.x;
                q.y += o.y;
                q.z += o.z;
                q.w += o.w;
            }
            float y0 = q.x + (ws[0] - uws[0]);
            float y1 = q.y + (ws[1] - uws[1]);
            float y2 = q.z + (ws[2] - uws[2]);
            float y3 = q.w + (ws[3] - uws[3]);
            y0 *= Ls[0];
            y1 -= Ls[4] * y0;
            y2 -= Ls[8] * y0;
            y3 -= Ls[12] * y0;
            y1 *= Ls[5];
            y2 -= Ls[9] * y1;
            y3 -= Ls[13] * y1;
            y2 *= Ls[10];
            y3 -= Ls[14] * y2;
            y3 *= Ls[15];
            xs[3] = y3 * Ls[15];
            y0 -= Ls[12] * xs[3];
            y1 -= Ls[13] * xs[3];
            y2 -= Ls[14] * xs[3];
            xs[2] = y2 * Ls[10];
            y0 -= Ls[8] * xs[2];
            y1 -= Ls[9] * xs[2];
            xs[1] = y1 * Ls[5];
            y0 -= Ls[4] * xs[1];
            xs[0] = y0 * Ls[0];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float xr = kAlpha * xs[u] + kBeta * ws[u];
                const float wn = fminf(fmaxf(xr + uws[u], 0.f), ub_s[u]);
                uws[u] = (uws[u] + xr) - wn;
                ws[u] = wn;
            }
            // this warp's table: entry n, the sum of x over the set bits
            // of n in column order
            if (lane < 16) {
                float e = 0.f;
                if (lane & 1) e += xs[0];
                if (lane & 2) e += xs[1];
                if (lane & 4) e += xs[2];
                if (lane & 8) e += xs[3];
                tw[lane] = e;
            }
            __syncwarp();
        } else {
            if (warp == 0) {
                // lane l: column l + 32 u; y_i and x_i from column i's lane
                float r[NC];
#pragma unroll
                for (int u = 0; u < NC; ++u) {
                    const int c = (lane + 32 * u) & (PC - 1);
                    float e = slot_of(0)[c];
                    for (int o = 1; o < C; ++o) e += slot_of(o)[c];
                    r[u] = e + (ws[u] - uws[u]);
                }
                // r[i / 32] (a select: the loops below are not unrolled)
                auto r_of = [&](int i) -> float {
                    if constexpr (NC == 1) return r[0];
                    else return i < 32 ? r[0] : r[1];
                };
#pragma unroll 4
                for (int i = 0; i < PC; ++i) {  // L y = rhs
                    const float yi =
                        __shfl_sync(0xffffffffu, r_of(i), i & 31) * dinv[i];
#pragma unroll
                    for (int u = 0; u < NC; ++u)
                        r[u] -= Ls[i * PC + ((lane + 32 * u) & (PC - 1))] * yi;
                }
#pragma unroll
                for (int u = 0; u < NC; ++u)
                    r[u] *= dinv[(lane + 32 * u) & (PC - 1)];
#pragma unroll 4
                for (int i = PC - 1; i >= 0; --i) {  // L^T x = y
                    const float xi =
                        __shfl_sync(0xffffffffu, r_of(i), i & 31) * dinv[i];
#pragma unroll
                    for (int u = 0; u < NC; ++u)
                        r[u] -= Ls[PC * PC + i * PC +
                                   ((lane + 32 * u) & (PC - 1))] * xi;
                }
#pragma unroll
                for (int u = 0; u < NC; ++u) {
                    const int c = (lane + 32 * u) & (PC - 1);
                    xs[u] = r[u] * dinv[c];
                    const float xr = kAlpha * xs[u] + kBeta * ws[u];
                    const float wn = fminf(fmaxf(xr + uws[u], 0.f), ub_s[c]);
                    uws[u] = (uws[u] + xr) - wn;
                    ws[u] = wn;
                    if (lane + 32 * u < PC) x_s[c] = xs[u];
                }
                __syncwarp();
                // the CTA's tables: entry 16 g + n, the sum of x over the
                // set bits of n in columns 4 g .. 4 g + 3, in column order
#pragma unroll 1
                for (int e0 = 0; e0 < 4 * PC; e0 += 32) {
                    const int e = e0 + lane;
                    const float4 xq =
                        *reinterpret_cast<const float4*>(x_s + 4 * (e >> 4));
                    float v = 0.f;
                    if (e & 1) v += xq.x;
                    if (e & 2) v += xq.y;
                    if (e & 4) v += xq.z;
                    if (e & 8) v += xq.w;
                    tab[e] = v;
                }
            }
            __syncthreads();  // x of step k in x_s, its tables in tab
        }
        if (k + 1 < a.iters) {
            rows(std::false_type{});
            push_sums((k + 1) & 1);
        } else {
            rows(std::true_type{});
        }
    }

    rmax = warp_max(rmax);
    if (lane == 0) red[warp] = rmax;
    __syncthreads();
    if (tid == 0) {
        float m = red[0];
        for (int i = 1; i < W; ++i) m = nan_max(m, red[i]);
        red[32] = m;
    }
    if (C == 1) __syncthreads();
    else cluster.sync();  // every CTA's maximum in red[32]
    if (rank == 0 && warp == 0) {
        // the last x: at p 4 entry 2^j of warp 0's table (x_j alone),
        // wider in x_s
        auto x_of = [&](int u) -> float {
            if constexpr (PC == 4) return tab[1 << u];
            else return x_s[(lane + 32 * u) & (PC - 1)];
        };
        float m = 0.f;
#pragma unroll
        for (int u = 0; u < NC; ++u) {
            const int c = PC == 4 ? u : lane + 32 * u;
            if (c < p) {
                m = nan_max(m, fabsf(x_of(u) - ws[u]));
                m = nan_max(m, fabsf(ws[u] - we_s[c]));
            }
        }
        if (lane < C)
            m = nan_max(m, cluster.map_shared_rank(red + 32, lane)[0]);
        m = warp_max(m);
        if (lane == 0) a.res[s] = m;
#pragma unroll
        for (int u = 0; u < NC; ++u) {
            const int c = PC == 4 ? u : lane + 32 * u;
            if (c < p && (PC > 4 || lane == 0)) {
                const size_t k = static_cast<size_t>(s) * p + c;
                a.x[k] = x_of(u);
                a.w[k] = ws[u];
                a.uw[k] = uws[u];
            }
        }
    }
    if (C > 1) cluster.sync();  // no CTA leaves while rank 0 reads it
}

template <int R, int PC>
cudaError_t launch_bits(const Args& a, int S, int C, int threads, int smem,
                        cudaStream_t stream) {
    auto kernel = admm_chunk_bits_kernel<R, PC>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(S) * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    e = cudaLaunchKernelEx(&cfg, kernel, a, C);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

// p 4 takes 1-8 rows a thread; the wider widths 4 or 8 (the clusters the
// plan gives them)
template <int PC>
cudaError_t dispatch_bits(const Args& a, int S, int C, int threads, int rpt,
                          int smem, cudaStream_t st) {
    if constexpr (PC == 4) {
        if (rpt == 1) return launch_bits<1, PC>(a, S, C, threads, smem, st);
        if (rpt == 2) return launch_bits<2, PC>(a, S, C, threads, smem, st);
    }
    if (rpt == 4) return launch_bits<4, PC>(a, S, C, threads, smem, st);
    if (rpt == 8) return launch_bits<8, PC>(a, S, C, threads, smem, st);
    return cudaErrorInvalidValue;
}

// the bits plan's compile-time width for p (0: past it)
inline int bits_width(int p) {
    for (int pc = 4; pc <= 64; pc *= 2)
        if (p <= pc) return pc;
    return 0;
}

}  // namespace

// The launch plan comes from ops/admm.py's launch_plan: `cluster` CTAs an
// instance of `threads` threads, `rpt` rows a thread; `bits` the bits plan
// (A is 0/1), else the float plan (a cluster of 8; `on_chip` or streamed).
// It is checked here again, with its shared memory.  Returns a cudaError_t
// (0 on success); launches on `stream`, no synchronise.
extern "C" int admm_chunk_plan_launch(
    const void* A, const void* b, const void* ub, const void* z0,
    const void* w0, const void* uz0, const void* uw0, const void* L,
    long long Lb, long long Li, long long Lj, int S, int n, int p, int iters,
    float thresh, int cluster, int threads, int rpt, int on_chip, int bits,
    void* x, void* z, void* w, void* uz, void* uw, void* res, void* stream) {
    const int C = cluster, T = threads, R = rpt;
    const int pc = bits ? bits_width(p) : p;
    const long long smem =
        4 * (bits ? bits_smem_floats(T, R, pc) : smem_floats(T, R, p, on_chip));
    if (S < 1 || p < 4 || p % 4 || iters < 1 || T < 32 || T > kMaxThreads ||
        T % 32 || R < 1 || static_cast<long long>(C) * T * R != n ||
        smem > kMaxSmem || (bits ? pc == 0 || C < 1 || C > kBitsCluster ||
                                       kBitsCluster % C
                                 : C != kCluster))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const float*>(A), static_cast<const float*>(b),
                 static_cast<const float*>(ub), static_cast<const float*>(z0),
                 static_cast<const float*>(w0), static_cast<const float*>(uz0),
                 static_cast<const float*>(uw0), static_cast<const float*>(L),
                 Lb, Li, Lj,
                 static_cast<float*>(x), static_cast<float*>(z),
                 static_cast<float*>(w), static_cast<float*>(uz),
                 static_cast<float*>(uw), static_cast<float*>(res),
                 n, p, iters, R, thresh};
    const auto st = static_cast<cudaStream_t>(stream);
    const int sm = static_cast<int>(smem);
    if (bits) {
        switch (pc) {
            case 4: return static_cast<int>(dispatch_bits<4>(a, S, C, T, R, sm, st));
            case 8: return static_cast<int>(dispatch_bits<8>(a, S, C, T, R, sm, st));
            case 16: return static_cast<int>(dispatch_bits<16>(a, S, C, T, R, sm, st));
            case 32: return static_cast<int>(dispatch_bits<32>(a, S, C, T, R, sm, st));
            default: return static_cast<int>(dispatch_bits<64>(a, S, C, T, R, sm, st));
        }
    }
    return static_cast<int>(
        p == 4 ? dispatch<4>(a, S, T, R, on_chip, sm, st)
               : dispatch<0>(a, S, T, R, on_chip, sm, st));
}
