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
// What bounds it.  Per read K6 reads ts, te and aligned (9 bytes) and
// writes ridx (and K11 overflow); a live read gathers from the segment and
// node tables and adds into the accumulators at scattered addresses: each
// gather a 32-byte sector read, each atomic a sector read and written.  K6
// does about 5 gathers (each end's bucket bounds, starts and record) and at
// most 12 atomics a read, K11 about 3 + 2 span gathers and 3 span + span -
// 2 atomics.  At the smoke DB's size (30 Mb of text, 854k segments) the
// tables the rows share fit the 50 MB L2; only the diff array (~120 MB) is
// past it.  A read's arithmetic is a few dozen integer instructions.  The
// least the work needs (chip_smoke.py's scatter_work) is each sector once
// a launch, none for adds that cancel (a node's -1 at its end and the next
// node's +1 at one diff word), over the HBM rate.  What keeps the kernels
// from it: a read's loads form a chain, each address read from the load
// before, and few reads are in flight (65536 reads one thread each fill a
// quarter of the card's warp slots); with enough in flight, the launch's
// requests (K6, below).
//
// K6 (redesigned for Hopper): two lanes a read, lane 0 its first segment
// and lane 1 its last, so 65536 reads run 131,072 threads at 32 registers.
// A lane's chain is four rounds of loads: its end's bucket bounds; the
// starts of the bucket's segments, all at once (a bucket of more than
// kScan - 1 segments, or one that the plain version's bisection would not
// close, takes that bisection); the segment's 32-byte record; then the
// atomics.  The record (ops/scatter.py's scatter_records, built with the
// tables) holds what the read needs of its segment and the segment's
// node: tstart, tnode, trio_seg, the trio_seg two segments before (the
// last end's correction), ridx, nodes_len and base_offset, so no load
// waits on the node and no haplotype search runs: ridx is the species
// range of the haplotype that holds every position the segment answers
// for (where a haplotype offset cuts the segment, the record says so and
// its reads take the search).  Both ends are found before the read is
// known to be live.  The lanes swap i0, i1 and ridx by shuffle on the
// pair's mask, and every exit is the pair's.  Lane 0 adds the first
// segment's bases and diff pair, the depth +1s at i0 + 1 and i0 and the
// trio correction at trio_seg[i0]; lane 1 the last segment's, the -1s at
// i1 and i1 - 1 and the correction at trio_seg[i1 - 2].  Measured by
// ablation (scripts/time_extend.py --kernel k6 at 65536 reads, 131072
// mates and 16384 interval rows; PERF.md), each lever taken out costs:
// the packed records 31 / 19 / 36% (every field its own load), the
// node's fields in the record 12 / 5 / 12%, the pair 6 / 4 / 13%, the
// ends found before the haplotype search and the live test 5 / 2 / 16%,
// the bucket's starts at once 3 / 1 / 2%.  Dropped: the bucket's whole
// heads read at once (48 registers, 0.5-3.5% slower) and the bucket
// bounds in one 8-byte load where aligned (0.1-0.9% slower).  Time per
// read is the same at 65536 and 131072 reads: the launch is held by its
// requests (12 atomics and ~5 gathers a read), not by one read's chain.
//
// K11 (redesigned for Hopper): a tile of G lanes a read, the smallest of 4,
// 8, 16 and 32 that holds L_cap (33-64: 32 lanes of two positions each; a
// template per width), so 65536 reads at L_cap 4 run 262,144 threads.
// Every exit is the whole tile's, and every shuffle takes the tile's mask
// and width, so none waits on a lane that has left.  Each lane runs the
// haplotype and segment bisections (the tile's lanes load one address);
// lane l tests start i0 + 1 + l and the ballot's leading run is n_more, one
// round of loads (at 33-64 a second only when the first 32 hold); lane j
// gathers position j's node, then its length and offset, and the trio
// match of the window it starts, so a row takes three rounds of loads
// whatever its span, coalesced along the segment tables.  The row stays in
// registers (ptxas: no stack frame at any width, where a thread a read kept
// it in local arrays of 8 bytes a slot): the allocation before the last
// sums by a butterfly of shuffles, each position's first occurrence (the
// dedup both the plain version's mask and sort forms give) by span
// shuffles of the row's nodes, and each 3-window takes its two
// neighbours' allocations by shuffle.  Measured by ablation (scripts/
// time_extend.py --kernel k11; PERF.md): the ballot scan is kept (without
// it 2-12% slower at L_cap 8-64, 0.6% at 4, 2% faster at 3); dropped were
// the bisections as G-ary searches on the tile (2-9% slower at L_cap 3-16,
// within 1% at 32 and 64) and __match_any_sync for the dedup (0.4-3%
// slower at L_cap 3-32, 0.8% faster at 64).  No warp aggregation of
// atomics, no shared memory and no TMA: the work is gathers and atomics at
// scattered addresses.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLCap = 64;
// K6's lanes a read (lane 0 the read's first segment, lane 1 its last) and
// the ends each lane locates
constexpr int kLanes = 2;
constexpr int kEnds = 2 / kLanes;
// K6 reads a bucket of up to kScan - 1 segments with the record before it
// in one round
constexpr int kScan = 8;
// a segment record's ridx where a haplotype offset cuts the segment's
// positions: its reads take the haplotype search
constexpr int kSearchHap = INT_MIN;

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
    // K6's [M] records of 32 bytes, two int4 a segment: its head (tstart,
    // tnode, trio_seg, the trio_seg of the segment two before it) and its
    // tail (ridx, nodes_len and base_offset of its node, 0)
    const int4* seg_rec;
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

// x's bucket [lo, hi) of pos_lo (text positions lie in [0, text_len), so
// the bucket is in range; it is clamped all the same)
__device__ __forceinline__ int bucket(const Tables& t, int x) {
    return min(max(x >> t.win_shift, 0), t.n_pos - 2);
}

// locate_segment: searchsorted(tstart, x, side='right') - 1 by the
// bisection inside x's bucket [lo, hi), clamped to [0, M - 1]
__device__ __forceinline__ int bisect(const Tables& t, int x, int lo, int hi) {
    for (int s = 0; s < t.steps && lo < hi; ++s) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(t.tstart + min(max(mid, 0), t.M - 1)) <= x) lo = mid + 1;
        else hi = mid;
    }
    return min(max(lo - 1, 0), t.M - 1);
}

__device__ __forceinline__ int locate(const Tables& t, int x) {
    const int b = bucket(t, x);
    return bisect(t, x, __ldg(t.pos_lo + b), __ldg(t.pos_lo + b + 1));
}

// segment i's record: its head, its start alone, and its tail (the head
// and the tail share a 32-byte sector, so the tail's load after the
// head's finds it in L1; ``head`` is for a tail read from the node)
__device__ __forceinline__ int4 seg_head(const Tables& t, int i) {
    return __ldg(t.seg_rec + 2 * i);
}

__device__ __forceinline__ int seg_start(const Tables& t, int i) {
    return __ldg(&t.seg_rec[2 * i].x);
}

__device__ __forceinline__ int4 seg_tail(const Tables& t, int i,
                                         const int4& head) {
    return __ldg(t.seg_rec + 2 * i + 1);
}

// The segment (locate_segment's answer) of each of a lane's ends x[k], its
// head and its tail.  A bucket [lo, hi) of n = hi - lo segments answers lo
// - 1 + the count of its starts at or before x (tstart ascends), clamped
// to [0, M - 1]; up to kScan - 1 segments, and no more than the plain
// version's bisection closes in pos_steps steps, the starts lo .. hi - 1
// are read at once and counted.  Larger buckets take the bisection.
__device__ __forceinline__ void locate_ends(const Tables& t,
                                            const int (&x)[kEnds],
                                            int (&seg)[kEnds],
                                            int4 (&rec)[kEnds],
                                            int4 (&tail)[kEnds]) {
    int lo[kEnds], hi[kEnds];
#pragma unroll
    for (int k = 0; k < kEnds; ++k) {
        const int b = bucket(t, x[k]);
        lo[k] = __ldg(t.pos_lo + b);
        hi[k] = __ldg(t.pos_lo + b + 1);
    }
    const int fits = min(kScan, 1 << min(t.steps, 30)) - 1;
#pragma unroll
    for (int k = 0; k < kEnds; ++k) {
        const int n = hi[k] - lo[k];
        if (n >= 0 && n <= fits) {
            int st[kScan];
#pragma unroll
            for (int j = 1; j < kScan; ++j)
                if (j <= n) st[j] = seg_start(t, min(lo[k] - 1 + j, t.M - 1));
            int cnt = 0;
#pragma unroll
            for (int j = 1; j < kScan; ++j)
                if (j <= n && st[j] <= x[k]) cnt = j;
            seg[k] = min(max(lo[k] - 1 + cnt, 0), t.M - 1);
        } else {
            seg[k] = bisect(t, x[k], lo[k], hi[k]);
        }
        rec[k] = seg_head(t, seg[k]);
        tail[k] = seg_tail(t, seg[k], rec[k]);
    }
}

// The read's lanes as a warp mask, and end e's v (a lane holds the v[k] of
// its ends lane * kEnds + k): a shuffle on the pair, or a register where
// one lane holds both ends
__device__ __forceinline__ unsigned read_mask() {
    return kLanes == 1 ? 1u << (threadIdx.x & 31)
                       : 3u << (threadIdx.x & 30);
}

__device__ __forceinline__ int at_end(const int (&v)[kEnds], int e) {
    if constexpr (kLanes == 1) return v[e];
    else return __shfl_sync(read_mask(), v[0], e, kLanes);
}

__global__ void __launch_bounds__(kThreads) classify_scatter_ranges_kernel(
    const int* __restrict__ ts_, const int* __restrict__ te_,
    const unsigned char* __restrict__ aligned, int B, Tables t,
    long long* acc_b, int* acc_d, long long* acc_t, int* acc_sn, int* acc_st,
    int* __restrict__ ridx_out) {
    const long long g =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (g >= static_cast<long long>(B) * kLanes) return;  // whole pairs
    const int r = static_cast<int>(g / kLanes);
    const int lane = static_cast<int>(threadIdx.x) & (kLanes - 1);
    if (!aligned[r]) {
        if (lane == 0) ridx_out[r] = -1;
        return;
    }
    const int ts = ts_[r], te = te_[r];
    // this lane's ends, 0 at ts and 1 at max(te - 1, ts), located before
    // the read is known to be live
    int x[kEnds], seg[kEnds], w[kEnds];
    int4 rec[kEnds], tail[kEnds];
#pragma unroll
    for (int k = 0; k < kEnds; ++k)
        x[k] = lane * kEnds + k == 0 ? ts : max(te - 1, ts);
    locate_ends(t, x, seg, rec, tail);
#pragma unroll
    for (int k = 0; k < kEnds; ++k) w[k] = tail[k].x;
    int ridx = at_end(w, 0);  // the first segment's haplotype's range
    if (ridx == kSearchHap) ridx = __ldg(t.hap_range + haplotype(t, ts));
    if (lane == 0) ridx_out[r] = ridx;
    if (ridx < 0 || te <= ts) return;  // not live: the pair leaves
    const int i0 = at_end(seg, 0), i1 = at_end(seg, 1);
    const bool single = i1 == i0, three = i1 - i0 >= 2;
#pragma unroll
    for (int k = 0; k < kEnds; ++k) {
        const int e = lane * kEnds + k;
        if (e == 1 && single) continue;  // end 0 takes a one-segment read
        const int n = rec[k].y - 1;
        const int nlen = tail[k].y, bo = tail[k].z;
        // the read's part [a, z) of the node; the trio window whose
        // correction this end makes (i0's, or the one i1 - 2 starts)
        const int a = e == 0 ? ts - rec[k].x : 0;
        const int z = e == 1 ? te - rec[k].x : single ? a + (te - ts) : nlen;
        const int m = !three ? -1 : e == 0 ? rec[k].z : rec[k].w;
        if (a != z) {
            add64(acc_b + n, z - a);
            atomicAdd(acc_d + bo + a, 1);
            atomicAdd(acc_d + bo + z, -1);
        }
        if (three) {  // the middle segments and the windows, by depth
            const int sign = e == 0 ? 1 : -1;
            atomicAdd(acc_sn + (e == 0 ? i0 + 1 : i1), sign);
            atomicAdd(acc_st + (e == 0 ? i0 : i1 - 1), sign);
            const int cut = e == 0 ? a : nlen - z;  // the node's bases
            if (m >= 0 && cut != 0) add64(acc_t + m, -cut);  // off the read
        }
    }
}

// ---------------------------------------------------------------------------
// K11: a tile of G lanes a read
// ---------------------------------------------------------------------------
// The tile's first lane in its warp, and the tile's lanes as a warp mask.
template <int G>
__device__ __forceinline__ int tile_base() {
    return static_cast<int>(threadIdx.x) & 31 & ~(G - 1);
}

template <int G>
__device__ __forceinline__ unsigned tile_mask() {
    return G == 32 ? 0xffffffffu : ((1u << G) - 1) << tile_base<G>();
}

// The tile's predicate bits, its lane 0 lowest.
template <int G>
__device__ __forceinline__ unsigned tile_ballot(unsigned tmask, bool p) {
    return (__ballot_sync(tmask, p) & tmask) >> tile_base<G>();
}

// n_more: how many of the starts tstart[i0 + 1 .. i0 + L_cap] (INT_MAX past
// M) lie at or before te1, counted up to the first that does not (tstart
// ascends).  Lane l tests start l + 1, and at S = 2 start l + G + 1 once
// the first G all hold; the count is the ballot's leading run of ones.
template <int G, int S>
__device__ __forceinline__ int start_scan(const Tables& t, int i0, int te1,
                                          int L_cap, int lane,
                                          unsigned tmask) {
    int n_more = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int k = lane + s * G;
        const int nxt = i0 + 1 + k;
        const bool le = k < L_cap &&
                        (nxt < t.M ? __ldg(t.tstart + nxt) : INT_MAX) <= te1;
        const int run = __clz(__brev(~tile_ballot<G>(tmask, le)));
        n_more += run;
        if (run < G) break;
    }
    return n_more;
}

// K11 at a window of up to G * S segments: a tile of G lanes a read,
// position j of the row on lane j % G (S = 2: two positions a lane).
// Every exit is the whole tile's, so its shuffles never wait on a lane
// that has left.
template <int G, int S>
__global__ void __launch_bounds__(kThreads) classify_scatter_kernel(
    const int* __restrict__ ts_, const int* __restrict__ te_,
    const unsigned char* __restrict__ aligned, int B, Tables t, int L_cap,
    int has_dups, long long* acc_b, int* acc_d, long long* acc_t,
    int* __restrict__ ridx_out, unsigned char* __restrict__ overflow_out) {
    const long long tile =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
    if (tile >= B) return;
    const int r = static_cast<int>(tile);
    const int lane = static_cast<int>(threadIdx.x) & (G - 1);
    const unsigned tmask = tile_mask<G>();
    if (!aligned[r]) {
        if (lane == 0) {
            ridx_out[r] = -1;
            overflow_out[r] = 0;
        }
        return;
    }
    const int ts = ts_[r], te = te_[r];
    const int ridx = __ldg(t.hap_range + haplotype(t, ts));
    const int i0 = locate(t, ts);
    const int te1 = max(te - 1, ts);
    const int n_more = start_scan<G, S>(t, i0, te1, L_cap, lane, tmask);
    const bool overflow = n_more >= L_cap;
    if (lane == 0) {
        ridx_out[r] = ridx;
        overflow_out[r] = overflow;
    }
    if (overflow || ridx < 0) return;

    const int span = n_more + 1;
    const bool single = span == 1;
    const int rs = ts - __ldg(t.tstart + i0);
    const int target = te - ts;  // read_end - read_start
    if (single && target < 0) return;  // the row is dropped

    // the row in registers: each position's node, its length and offset,
    // and the trio match of the 3-window it starts, gathered by all the
    // tile's lanes at once
    int node[S], nl[S], bo[S], trio[S], alloc[S], first[S], pv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + s * G;
        const int seg = min(i0 + j, t.M - 1);
        node[s] = j < span ? __ldg(t.tnode + seg) - 1 : -1;
        trio[s] = j + 2 < span ? __ldg(t.trio_seg + seg) : -1;
    }
    long long seen = 0;  // the allocations before the last, summed below
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + s * G;
        nl[s] = j < span ? __ldg(t.nodes_len + node[s]) : 0;
        bo[s] = j < span ? __ldg(t.base_offset + node[s]) : 0;
        if (j < span - 1) seen += j == 0 ? nl[s] - rs : nl[s];
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        seen += __shfl_xor_sync(tmask, seen, off, G);
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + s * G;
        const int a_nolast = j == 0 ? nl[s] - rs : nl[s];
        alloc[s] = j >= span ? 0
                   : single  ? target
                   : j == span - 1
                       ? static_cast<int>(max(target - seen, 0LL))
                       : a_nolast;
        // the node's per-base interval [lo, hi) of the diff array
        const int start = j == 0 ? rs : 0;
        const int lo = min(max(start, 0), nl[s]);
        const int hi = static_cast<int>(min(
            max(static_cast<long long>(start) + alloc[s],
                static_cast<long long>(lo)),
            static_cast<long long>(nl[s])));
        const bool in_bounds = target > 0 && rs + target <= nl[s];
        if (j < span && (!single || in_bounds) && lo != hi) {
            atomicAdd(acc_d + bo[s] + lo, 1);
            atomicAdd(acc_d + bo[s] + hi, -1);
        }
        first[s] = j;
    }
    // first[s]: the row position of the node's first occurrence, the
    // lowest of the row's positions that hold it (scanned from the last
    // position down, so the lowest match is written last)
    if (has_dups) {
#pragma unroll
        for (int h = S - 1; h >= 0; --h) {
            for (int q = min(G, span - h * G) - 1; q >= 0; --q) {
                const int v = __shfl_sync(tmask, node[h], q, G);
#pragma unroll
                for (int s = h; s < S; ++s)
                    if (v == node[s]) first[s] = h * G + q;
            }
        }
    }
    // bases at each node's first position; pv is the first occurrence's
    // allocation, which the trio windows sum
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + s * G;
        if (j < span && first[s] == j && alloc[s] != 0)
            add64(acc_b + node[s], alloc[s]);
        pv[s] = alloc[s];
        if (has_dups) {
            const int src = first[s] & (G - 1);
            pv[s] = __shfl_sync(tmask, alloc[0], src, G);
            if (S == 2) {
                const int hi_half = __shfl_sync(tmask, alloc[S - 1], src, G);
                if (first[s] >= G) pv[s] = hi_half;
            }
        }
    }
    if (span < 3) return;  // no 3-window
    // position j's window sums pv at j, j + 1 and j + 2, the last two from
    // the lanes after it (at S = 2, across the halves: lane l's position
    // l + d is lane (l + d) % G's, in the next half past G)
    long long v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = pv[s];
#pragma unroll
    for (int d = 1; d <= 2; ++d) {
        const int src = (lane + d) & (G - 1);
        const int x0 = __shfl_sync(tmask, pv[0], src, G);
        const int x1 = S == 2 ? __shfl_sync(tmask, pv[S - 1], src, G) : 0;
        v[0] += lane + d < G ? x0 : x1;
        if (S == 2) v[S - 1] += x1;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int j = lane + s * G;
        if (j + 2 < span && trio[s] >= 0 && v[s] != 0)
            add64(acc_t + trio[s], v[s]);
    }
}

bool tables_ok(const Tables& t) {
    return t.H1 >= 1 && t.H >= 1 && t.n_pos >= 2 && t.M >= 1 &&
           t.steps >= 0 && t.win_shift >= 0 && t.win_shift < 32;
}

template <int G, int S>
void launch_windowed(cudaStream_t s, const int* ts, const int* te,
                     const unsigned char* al, int B, const Tables& t,
                     int L_cap, int has_dups, long long* acc_b, int* acc_d,
                     long long* acc_t, int* ridx, unsigned char* overflow) {
    const long long threads = static_cast<long long>(B) * G;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) /
                                          kThreads));
    classify_scatter_kernel<G, S><<<grid, kThreads, 0, s>>>(
        ts, te, al, B, t, L_cap, has_dups, acc_b, acc_d, acc_t, ridx,
        overflow);
}

}  // namespace

extern "C" int classify_scatter_ranges_records_launch(
    const void* ts, const void* te, const void* aligned, int B,
    const void* hap_offsets, int H1, const void* hap_range, int H,
    const void* pos_lo, int n_pos, int win_shift, int steps,
    const void* tstart, const void* tnode, int M, const void* nodes_len,
    const void* base_offset, const void* trio_seg, const void* seg_rec,
    void* acc_bases, void* acc_diff, void* acc_trio, void* acc_sn,
    void* acc_st, void* ridx, void* stream) {
    const Tables t{static_cast<const int*>(hap_offsets), H1,
                   static_cast<const int*>(hap_range), H,
                   static_cast<const int*>(pos_lo), n_pos, win_shift, steps,
                   static_cast<const int*>(tstart),
                   static_cast<const int*>(tnode), M,
                   static_cast<const int*>(nodes_len),
                   static_cast<const int*>(base_offset),
                   static_cast<const int*>(trio_seg),
                   static_cast<const int4*>(seg_rec)};
    if (B <= 0) return 0;
    if (!tables_ok(t)) return static_cast<int>(cudaErrorInvalidValue);
    const long long threads = static_cast<long long>(B) * kLanes;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) /
                                          kThreads));
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
                   static_cast<const int*>(trio_seg), nullptr};
    if (B <= 0) return 0;
    if (!tables_ok(t) || L_cap < 1 || L_cap > kMaxLCap)
        return static_cast<int>(cudaErrorInvalidValue);
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
        launch_windowed<4, 1>(s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                              p_b, p_d, p_t, p_r, p_o);
    else if (L_cap <= 8)
        launch_windowed<8, 1>(s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                              p_b, p_d, p_t, p_r, p_o);
    else if (L_cap <= 16)
        launch_windowed<16, 1>(s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                               p_b, p_d, p_t, p_r, p_o);
    else if (L_cap <= 32)
        launch_windowed<32, 1>(s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                               p_b, p_d, p_t, p_r, p_o);
    else
        launch_windowed<32, 2>(s, p_ts, p_te, p_al, B, t, L_cap, has_dups,
                               p_b, p_d, p_t, p_r, p_o);
    return static_cast<int>(cudaGetLastError());
}
