// The fused step's classify + scatter for Hopper (sm_90a): K6 and K11.
//
// Replaces the JAX package's classify + scatter, which XLA compiles inside
// its jitted fused steps (pantax_tpu/ops/fused.py):
// - K6, _classify_scatter_ranges (:236) with locate_segment (:81), also the
//   body of _interval_range_step_impl (:620): per read, the haplotype of
//   ts (searchsorted over hap_offsets) gives ridx; two in-bucket
//   bisections give the first and last segments i0, i1; the first and last
//   segments' bases and per-base diff intervals are added directly, the
//   middle segments and the trio windows as segment-space depth diffs
//   (seg_node_depth +1 at i0 + 1, -1 at i1; seg_trio_depth +1 at i0, -1 at
//   i1 - 1) and the two end windows' trio corrections (-rs at
//   trio_seg[i0], -(nlen1 - rem) at trio_seg[i1 - 2]);
// - K11, _classify_scatter (:170) with the fused branch of
//   _coverage_scatter (pantax_tpu/ops/coverage_device.py:110): per read,
//   ridx; i0; n_more, the segment starts tstart[i0 + 1 .. i0 + L_cap] at or
//   before max(te - 1, ts) (INT32_MAX past M); overflow (aligned and
//   n_more >= L_cap) and span = n_more + 1; the row of the span's nodes
//   with the reference's allocation (the first node nodes_len - rs, the
//   last max(target - seen_before, 0), a single node the target, a single
//   node with a negative target dropped), each node's per-base diff
//   interval (a single node's only where 0 < target and rs + target <=
//   its length), its bases only at its first position in the row where
//   the DB has revisiting haplotypes (has_dups), and each 3-window j (j + 2
//   < span) at trio_seg[i0 + j] >= 0 adding the sum of its positions'
//   first-occurrence allocations.
// Accumulators: bases int64 [N_pad + 1], diff int32 [TB_pad + 1], trio
// int64 [U_pad + 1] and, for K6, seg_node_depth and seg_trio_depth int32
// [M + 1].  The plain torch versions (ops/scatter.py) add dropped entries
// into each array's last (sink) slot; the kernels add nothing for them, and
// skip adds that cancel (a +1 and a -1 at one index) or add 0.  The sums are
// integers, added with integer atomics (64-bit as two's complement
// unsigned long long), so they do not depend on the order of the adds and
// equal the plain version's bit for bit, the sinks aside (the diff array's
// last slot, which the plain version's dropped pairs net to 0, included).
//
// What bounds it: bytes.  Per read it reads ts, te and aligned (9 bytes)
// and writes ridx (and overflow); a live read gathers from tables that do
// not fit the 50 MB L2 at the smoke DB's size (the diff array alone is
// ~120 MB) and adds into them at random: each gather a 32-byte sector read,
// each atomic a sector read and written.  K6 does at most 10 gathers and 12
// atomics a read, K11 about 3 + 2 span gathers and 3 span + span - 2
// atomics.  Nothing else is worth the bandwidth: a read's work is a few
// dozen integer instructions.
//
// Design: one thread per read, 256 a block, and only the live rows (and,
// for K11, the aligned ones, whose overflow needs i0 and n_more) read
// anything past the per-read columns; the bisections stop once their
// bracket closes (the plain version's steps after that change nothing).
// K11 holds a row's nodes and allocations in local arrays of the smallest
// of 4, 8, 16, 32 or 64 entries that holds L_cap (a template per width),
// dedups by a direct scan of the earlier positions (what both the plain
// version's mask form and its sort form give), and reads the start scan
// only as far as the first start past the read.  No warp aggregation of
// atomics and no shared-memory staging: a first, simple kernel.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLCap = 64;

struct Tables {
    const int* hap_offsets;  // [H1]
    int H1;
    const int* hap_range;    // [H]
    int H;
    const int* pos_lo;       // [n_pos], the segment buckets' bounds
    int n_pos;
    int win_shift;
    int steps;
    const int* tstart;       // [M]
    const int* tnode;        // [M], 1-based node ids
    int M;
    const int* nodes_len;    // [N_pad]
    const int* base_offset;  // [N_pad + 1]
    const int* trio_seg;     // [M]
};

__device__ __forceinline__ void add64(long long* acc, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(acc),
              static_cast<unsigned long long>(v));
}

// searchsorted(hap_offsets, x, side='right') - 1, clamped to [0, H - 1]
__device__ __forceinline__ int haplotype(const Tables& t, int x) {
    int lo = 0, hi = t.H1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(t.hap_offsets + mid) <= x) lo = mid + 1;
        else hi = mid;
    }
    return min(max(lo - 1, 0), t.H - 1);
}

// locate_segment: searchsorted(tstart, x, side='right') - 1 by the
// bisection inside x's bucket, clamped to [0, M - 1].  Text positions lie
// in [0, text_len), so the bucket is in range; it is clamped all the same.
__device__ __forceinline__ int locate(const Tables& t, int x) {
    const int b = min(max(x >> t.win_shift, 0), t.n_pos - 2);
    int lo = __ldg(t.pos_lo + b), hi = __ldg(t.pos_lo + b + 1);
    for (int s = 0; s < t.steps && lo < hi; ++s) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(t.tstart + min(max(mid, 0), t.M - 1)) <= x) lo = mid + 1;
        else hi = mid;
    }
    return min(max(lo - 1, 0), t.M - 1);
}

__global__ void __launch_bounds__(kThreads) classify_scatter_ranges_kernel(
    const int* __restrict__ ts_, const int* __restrict__ te_,
    const unsigned char* __restrict__ aligned, int B, Tables t,
    long long* acc_b, int* acc_d, long long* acc_t, int* acc_sn, int* acc_st,
    int* __restrict__ ridx_out) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= B) return;
    const int ts = ts_[r], te = te_[r];
    const int ridx = aligned[r] ? __ldg(t.hap_range + haplotype(t, ts)) : -1;
    ridx_out[r] = ridx;
    if (ridx < 0 || te <= ts) return;  // not live

    const int i0 = locate(t, ts);
    const int i1 = locate(t, te - 1);
    const int n0 = __ldg(t.tnode + i0) - 1;
    const int rs = ts - __ldg(t.tstart + i0);
    const int bo0 = __ldg(t.base_offset + n0);
    if (i1 == i0) {  // one segment: its bases and interval, nothing more
        const int tgt = te - ts;
        add64(acc_b + n0, tgt);
        atomicAdd(acc_d + bo0 + rs, 1);
        atomicAdd(acc_d + bo0 + rs + tgt, -1);
        return;
    }
    const int n1 = __ldg(t.tnode + i1) - 1;
    const int nlen0 = __ldg(t.nodes_len + n0);
    const int nlen1 = __ldg(t.nodes_len + n1);
    const int rem = te - __ldg(t.tstart + i1);
    const int bo1 = __ldg(t.base_offset + n1);
    if (nlen0 != rs) {
        add64(acc_b + n0, nlen0 - rs);
        atomicAdd(acc_d + bo0 + rs, 1);
        atomicAdd(acc_d + bo0 + nlen0, -1);
    }
    if (rem != 0) {
        add64(acc_b + n1, rem);
        atomicAdd(acc_d + bo1, 1);
        atomicAdd(acc_d + bo1 + rem, -1);
    }
    if (i1 - i0 < 2) return;  // two segments: no middle, no trio window
    atomicAdd(acc_sn + i0 + 1, 1);
    atomicAdd(acc_sn + i1, -1);
    atomicAdd(acc_st + i0, 1);
    atomicAdd(acc_st + i1 - 1, -1);
    const int m0 = __ldg(t.trio_seg + i0);
    if (m0 >= 0 && rs != 0) add64(acc_t + m0, -rs);
    const int m1 = __ldg(t.trio_seg + i1 - 2);
    if (m1 >= 0 && nlen1 != rem) add64(acc_t + m1, rem - nlen1);
}

template <int LMAX>
__global__ void __launch_bounds__(kThreads) classify_scatter_kernel(
    const int* __restrict__ ts_, const int* __restrict__ te_,
    const unsigned char* __restrict__ aligned, int B, Tables t, int L_cap,
    int has_dups, long long* acc_b, int* acc_d, long long* acc_t,
    int* __restrict__ ridx_out, unsigned char* __restrict__ overflow_out) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= B) return;
    if (!aligned[r]) {
        ridx_out[r] = -1;
        overflow_out[r] = 0;
        return;
    }
    const int ts = ts_[r], te = te_[r];
    const int ridx = __ldg(t.hap_range + haplotype(t, ts));
    const int i0 = locate(t, ts);
    const int te1 = max(te - 1, ts);
    int n_more = 0;  // tstart ascends: count up to the first start past te1
    while (n_more < L_cap) {
        const int nxt = i0 + n_more + 1;
        if ((nxt < t.M ? __ldg(t.tstart + nxt) : INT_MAX) > te1) break;
        ++n_more;
    }
    const bool overflow = n_more >= L_cap;
    ridx_out[r] = ridx;
    overflow_out[r] = overflow;
    if (overflow || ridx < 0) return;

    const int span = n_more + 1;
    const bool single = span == 1;
    const int rs = ts - __ldg(t.tstart + i0);
    const int target = te - ts;  // read_end - read_start
    if (single && target < 0) return;  // the row is dropped
    int node[LMAX];
    int alloc[LMAX];
    long long seen = 0;  // the allocations before j, the last's excepted
    for (int j = 0; j < span; ++j) {
        const int n = __ldg(t.tnode + min(i0 + j, t.M - 1)) - 1;
        const int nl = __ldg(t.nodes_len + n);
        const int a_nolast = j == 0 ? nl - rs : nl;
        const int a = single ? target
                      : j == span - 1
                          ? static_cast<int>(max(target - seen, 0LL))
                          : a_nolast;
        seen += a_nolast;
        node[j] = n;
        alloc[j] = a;
        // the node's per-base interval [lo, hi) of the diff array
        const int start = j == 0 ? rs : 0;
        const int lo = min(max(start, 0), nl);
        const int hi = static_cast<int>(min(
            max(static_cast<long long>(start) + a, static_cast<long long>(lo)),
            static_cast<long long>(nl)));
        const bool in_bounds = target > 0 && rs + target <= nl;
        if ((!single || in_bounds) && lo != hi) {
            const int bo = __ldg(t.base_offset + n);
            atomicAdd(acc_d + bo + lo, 1);
            atomicAdd(acc_d + bo + hi, -1);
        }
    }
    // bases at each node's first position in the row; alloc[j] becomes the
    // first occurrence's allocation, which the trio windows sum
    for (int j = 0; j < span; ++j) {
        int first = j;
        if (has_dups) {
            for (int k = 0; k < j; ++k) {
                if (node[k] == node[j]) {
                    first = k;
                    break;
                }
            }
        }
        if (first == j) {
            if (alloc[j] != 0) add64(acc_b + node[j], alloc[j]);
        } else {
            alloc[j] = alloc[first];
        }
    }
    for (int j = 0; j + 2 < span; ++j) {
        const int m = __ldg(t.trio_seg + min(i0 + j, t.M - 1));
        const long long v = static_cast<long long>(alloc[j]) + alloc[j + 1]
                            + alloc[j + 2];
        if (m >= 0 && v != 0) add64(acc_t + m, v);
    }
}

bool tables_ok(const Tables& t) {
    return t.H1 >= 1 && t.H >= 1 && t.n_pos >= 2 && t.M >= 1 &&
           t.steps >= 0 && t.win_shift >= 0 && t.win_shift < 32;
}

template <int LMAX>
void launch_windowed(dim3 grid, cudaStream_t s, const int* ts, const int* te,
                     const unsigned char* al, int B, const Tables& t,
                     int L_cap, int has_dups, long long* acc_b, int* acc_d,
                     long long* acc_t, int* ridx, unsigned char* overflow) {
    classify_scatter_kernel<LMAX><<<grid, kThreads, 0, s>>>(
        ts, te, al, B, t, L_cap, has_dups, acc_b, acc_d, acc_t, ridx,
        overflow);
}

}  // namespace

extern "C" int classify_scatter_ranges_launch(
    const void* ts, const void* te, const void* aligned, int B,
    const void* hap_offsets, int H1, const void* hap_range, int H,
    const void* pos_lo, int n_pos, int win_shift, int steps,
    const void* tstart, const void* tnode, int M, const void* nodes_len,
    const void* base_offset, const void* trio_seg, void* acc_bases,
    void* acc_diff, void* acc_trio, void* acc_sn, void* acc_st, void* ridx,
    void* stream) {
    const Tables t{static_cast<const int*>(hap_offsets), H1,
                   static_cast<const int*>(hap_range), H,
                   static_cast<const int*>(pos_lo), n_pos, win_shift, steps,
                   static_cast<const int*>(tstart),
                   static_cast<const int*>(tnode), M,
                   static_cast<const int*>(nodes_len),
                   static_cast<const int*>(base_offset),
                   static_cast<const int*>(trio_seg)};
    if (B <= 0) return 0;
    if (!tables_ok(t)) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((B + kThreads - 1) / kThreads);
    classify_scatter_ranges_kernel<<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ts), static_cast<const int*>(te),
        static_cast<const unsigned char*>(aligned), B, t,
        static_cast<long long*>(acc_bases), static_cast<int*>(acc_diff),
        static_cast<long long*>(acc_trio), static_cast<int*>(acc_sn),
        static_cast<int*>(acc_st), static_cast<int*>(ridx));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int classify_scatter_launch(
    const void* ts, const void* te, const void* aligned, int B,
    const void* hap_offsets, int H1, const void* hap_range, int H,
    const void* pos_lo, int n_pos, int win_shift, int steps,
    const void* tstart, const void* tnode, int M, const void* nodes_len,
    const void* base_offset, const void* trio_seg, int L_cap, int has_dups,
    void* acc_bases, void* acc_diff, void* acc_trio, void* ridx,
    void* overflow, void* stream) {
    const Tables t{static_cast<const int*>(hap_offsets), H1,
                   static_cast<const int*>(hap_range), H,
                   static_cast<const int*>(pos_lo), n_pos, win_shift, steps,
                   static_cast<const int*>(tstart),
                   static_cast<const int*>(tnode), M,
                   static_cast<const int*>(nodes_len),
                   static_cast<const int*>(base_offset),
                   static_cast<const int*>(trio_seg)};
    if (B <= 0) return 0;
    if (!tables_ok(t) || L_cap < 1 || L_cap > kMaxLCap)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((B + kThreads - 1) / kThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* p_ts = static_cast<const int*>(ts);
    const auto* p_te = static_cast<const int*>(te);
    const auto* p_al = static_cast<const unsigned char*>(aligned);
    auto* p_b = static_cast<long long*>(acc_bases);
    auto* p_d = static_cast<int*>(acc_diff);
    auto* p_t = static_cast<long long*>(acc_trio);
    auto* p_r = static_cast<int*>(ridx);
    auto* p_o = static_cast<unsigned char*>(overflow);
    if (L_cap <= 4)
        launch_windowed<4>(grid, s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                           p_b, p_d, p_t, p_r, p_o);
    else if (L_cap <= 8)
        launch_windowed<8>(grid, s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                           p_b, p_d, p_t, p_r, p_o);
    else if (L_cap <= 16)
        launch_windowed<16>(grid, s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                            p_b, p_d, p_t, p_r, p_o);
    else if (L_cap <= 32)
        launch_windowed<32>(grid, s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                            p_b, p_d, p_t, p_r, p_o);
    else
        launch_windowed<64>(grid, s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                            p_b, p_d, p_t, p_r, p_o);
    return static_cast<int>(cudaGetLastError());
}
