// The query's prologue and epilogue for Hopper (sm_90a): K4 and K5.
//
// Replaces the XLA device code around the seed stage (K3) and the banded
// DP (K1, K2) in the JAX package's jitted query functions
// (pantax_tpu/align/aligner.py), which XLA fuses there and the port ran
// as some 60-70 plain torch ops a batch:
// - K4a, query_prologue_kernel: _unpack_reads_j (:149; the plain-array
//   branch _unpack_codes_j :83).  int8 codes [B, L] and read_len -> [R,
//   Lw]: column c of row r is codes[r, c] where c < min(L, read_len[r]),
//   else 4, Lw a multiple of 4.  Given a second matrix (the paired query's
//   mate 2) its rows follow mate 1's in the same buffer, both padded with
//   4 to Lw, and read_len of both is written beside them (the
//   concatenation of _query_batch_paired :712-718);
// - K4b, query_rows_kernel: _rev_codes_j (:203) and the strand select of
//   _all_candidates (:557-559) and _extend_batch (:630-632), with the
//   window start clip (:561, :634) and the repeated read_len (:560).  For
//   candidate n = r * K + k its read row: codes_fwd[r] where strand[n] !=
//   1, else the left-aligned reverse complement of its first read_len
//   columns (3 - code where code < 4, else 4), columns past Lc (the codes'
//   width) 4; w0[n] = clip(diag[n] - pad, 0, w_hi) in int32, and len_rep[n]
//   = read_len[r].  The complement is taken as the row is written, so no
//   [R, Lc] reverse matrix is made;
// - K5, query_pick_kernel: the tail of _all_candidates (:567-577: the
//   votes mask, ts / te, the node projection searchsorted(tstart, ts,
//   right) - 1 clipped into [0, M - 1], node and offset), _query_batch's
//   epilogue (:593-610: the first argmax, the location-deduped second
//   best, the score threshold and mapq) and _pack_result_rows (:649);
// - K5p, query_pick_paired_kernel: _query_batch_paired's pair scoring and
//   pick (:720-777): the K x K pairs' scores with the fragment bonus, the
//   first argmax over the pairs flattened row-major, the joint second
//   best, pair mapq, the rescue, each mate's own mapq.
// Each writes the per-read columns in the reference's dtypes (int32 ts,
// te, score, matches, mapq; int8 strand; bool aligned) or its packed
// int32 rows ([4, B], or [8, B] for pairs), bit for bit those of the
// plain torch versions (ops/query.py).  int32 sums and differences wrap
// as torch's do (taken in unsigned arithmetic).  The two thresholds are
// float32 products truncated toward zero, as XLA and torch compute them:
// __fmul_rn and __float2int_rz, never contracted (no fast math).
//
// What bounds them: bytes.  K4a reads each code byte once and writes each
// row byte once; K4b reads codes_fwd, strand and diag once and writes the
// B x K candidate rows; K5 reads K1's four outputs, w0, the votes and
// strands and read_len, and writes 7 columns or 4 rows a read.  K5's
// projection is K binary searches a read over tstart (~19 dependent
// loads from L2 at the smoke DB's 470,000 segments), which latency, not
// bytes, may hold.  A simple design first: one thread a 4-byte word (K4a),
// a 16-byte chunk of a candidate row (K4b, one 16-byte store where the
// row width allows) and a read or a mate pair (K5, K5p, templated on K so
// the candidates stay in registers).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -1000000;      // ops/extend.py NEG
constexpr int kHalfNeg = -500000;   // NEG // 2
constexpr int kThreads = 256;
constexpr int kMaxK = 8;            // K3's top_k limit (ops/seed.py)

__device__ __forceinline__ int wrap_add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) -
                            static_cast<unsigned>(b));
}

// int32(float32(f) * float32(n)), truncated toward zero
__device__ __forceinline__ int frac_of(float f, int n) {
    return __float2int_rz(__fmul_rn(f, __int2float_rn(n)));
}

// 60 without a second, else clip(int32(float32(scale) * (best - second)),
// 0, 60)
__device__ __forceinline__ int gap_mapq(int best, int second, float scale) {
    if (second <= kHalfNeg) return 60;
    const int q = __float2int_rz(
        __fmul_rn(scale, __int2float_rn(wrap_sub(best, second))));
    return min(max(q, 0), 60);
}

// searchsorted(tstart, x, right=True) - 1, clipped into [0, M - 1]
__device__ __forceinline__ int segment_of(const int* __restrict__ tstart,
                                          int M, int x) {
    int lo = 0, hi = M;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(tstart + mid) <= x) lo = mid + 1;
        else hi = mid;
    }
    return min(max(lo - 1, 0), M - 1);
}

__device__ __forceinline__ int packed_hi(int score, int matches) {
    const int s = min(max(score, -32768), 32767);
    return static_cast<int>((static_cast<unsigned>(s) << 16) |
                            (static_cast<unsigned>(matches) & 0xFFFFu));
}

__device__ __forceinline__ int packed_flags(int mapq, int strand,
                                            bool aligned) {
    return static_cast<int>((static_cast<unsigned>(mapq) << 2) |
                            (static_cast<unsigned>(strand) << 1) |
                            (aligned ? 1u : 0u));
}

// one read's pick, written as columns (at row col of each) and / or packed
// rows (at column pk of a [4, stride] block)
struct Out {
    int* ts;
    int* te;
    int* score;
    int* matches;
    int* mapq;
    int8_t* strand;
    bool* aligned;
    int* packed;
};

__device__ __forceinline__ void write_pick(const Out& o, long long col,
                                           long long pk, int stride, int ts,
                                           int te, int score, int matches,
                                           int mapq, int strand,
                                           bool aligned) {
    if (o.ts) {
        o.ts[col] = ts;
        o.te[col] = te;
        o.score[col] = score;
        o.matches[col] = matches;
        o.mapq[col] = mapq;
        o.strand[col] = static_cast<int8_t>(strand);
        o.aligned[col] = aligned;
    }
    if (o.packed) {
        o.packed[pk] = ts;
        o.packed[stride + pk] = te;
        o.packed[2LL * stride + pk] = packed_hi(score, matches);
        o.packed[3LL * stride + pk] = packed_flags(mapq, strand, aligned);
    }
}

__global__ void query_prologue_kernel(
    const int8_t* __restrict__ c1, int B1, int L1,
    const int* __restrict__ n1, const int8_t* __restrict__ c2, int L2,
    const int* __restrict__ n2, int R, int Lw, int8_t* __restrict__ out,
    int* __restrict__ lens_out) {
    const int words = Lw >> 2;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (t >= static_cast<long long>(R) * words) return;
    const int r = static_cast<int>(t / words);
    const int w = static_cast<int>(t - static_cast<long long>(r) * words);
    const int8_t* src;
    int L, len;
    if (r < B1) {
        src = c1 + static_cast<long long>(r) * L1;
        L = L1;
        len = n1[r];
    } else {
        src = c2 + static_cast<long long>(r - B1) * L2;
        L = L2;
        len = n2[r - B1];
    }
    const int lim = min(L, len);
    const int c0 = w * 4;
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        const unsigned v = c < lim ? static_cast<uint8_t>(src[c]) : 4u;
        word |= v << (8 * j);
    }
    reinterpret_cast<unsigned*>(out + static_cast<long long>(r) * Lw)[w] =
        word;
    if (lens_out != nullptr && w == 0) lens_out[r] = len;
}

template <typename StrandT>
__global__ void query_rows_kernel(
    const int8_t* __restrict__ fwd, int R, int Lc,
    const int* __restrict__ len, const StrandT* __restrict__ strand, int K,
    const int* __restrict__ diag, int pad, int w_hi, int Lp,
    int8_t* __restrict__ rows, int* __restrict__ len_rep,
    int* __restrict__ w0) {
    const int chunks = (Lp + 15) >> 4;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    const long long N = static_cast<long long>(R) * K;
    if (t >= N * chunks) return;
    const long long n = t / chunks;
    const int ch = static_cast<int>(t - n * chunks);
    const int r = static_cast<int>(n / K);
    const bool rev = static_cast<int>(strand[n]) == 1;
    const int l = len[r];
    const int8_t* src = fwd + static_cast<long long>(r) * Lc;
    unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int c = ch * 16 + j;
        int8_t v = 4;
        if (c < Lc) {
            if (!rev) {
                v = src[c];
            } else if (c < l) {
                long long s = static_cast<long long>(l) - 1 - c;
                s = s < 0 ? 0 : (s > Lc - 1 ? Lc - 1 : s);
                const int8_t x = src[s];
                v = x < 4 ? static_cast<int8_t>(3 - x) : int8_t{4};
            }
        }
        word[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(v))
                        << (8 * (j & 3));
    }
    int8_t* dst = rows + n * Lp + ch * 16;
    if ((Lp & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(word[0], word[1], word[2], word[3]);
    } else {
        const int m = min(16, Lp - ch * 16);
        for (int j = 0; j < m; ++j)
            dst[j] = static_cast<int8_t>((word[j >> 2] >> (8 * (j & 3))) &
                                         0xFFu);
    }
    if (ch == 0) {
        if (len_rep != nullptr) len_rep[n] = l;
        if (w0 != nullptr)
            w0[n] = min(max(wrap_sub(diag[n], pad), 0), w_hi);
    }
}

// candidate k of read row: its masked score, ts, te and graph location
template <int K>
struct Cands {
    int score[K], ts[K], node[K], off[K];
};

template <int K>
__device__ __forceinline__ void load_cands(
    Cands<K>& c, long long row, const int* __restrict__ score,
    const int* __restrict__ soff, const int* __restrict__ w0,
    const int* __restrict__ votes, const int* __restrict__ tstart,
    const int* __restrict__ tnode, int M) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const long long f = row * K + k;
        c.score[k] = votes[f] > 0 ? score[f] : kNeg;
        c.ts[k] = wrap_add(w0[f], soff[f]);
        const int i0 = segment_of(tstart, M, c.ts[k]);
        c.node[k] = __ldg(tnode + i0);
        c.off[k] = wrap_sub(c.ts[k], __ldg(tstart + i0));
    }
}

template <int K>
__global__ void query_pick_kernel(
    const int* __restrict__ score, const int* __restrict__ soff,
    const int* __restrict__ eoff, const int* __restrict__ matches,
    const int* __restrict__ w0, const int* __restrict__ votes,
    const int8_t* __restrict__ strand, const int* __restrict__ tstart,
    const int* __restrict__ tnode, int M, const int* __restrict__ read_len,
    int B, float mapq_scale, float min_frac, Out o) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    Cands<K> c;
    load_cands<K>(c, i, score, soff, w0, votes, tstart, tnode, M);
    int best = 0;
#pragma unroll
    for (int k = 1; k < K; ++k)
        if (c.score[k] > c.score[best]) best = k;  // first index on ties
    int s1 = 0, bn = 0, bo = 0, bts = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
        if (k == best) {
            s1 = c.score[k];
            bn = c.node[k];
            bo = c.off[k];
            bts = c.ts[k];
        }
    int s2 = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int v = (c.node[k] == bn && c.off[k] == bo) ? kNeg : c.score[k];
        s2 = k == 0 ? v : max(s2, v);
    }
    const long long fb = static_cast<long long>(i) * K + best;
    const bool aligned = s1 >= frac_of(min_frac, read_len[i]);
    const int mapq = aligned ? gap_mapq(s1, s2, mapq_scale) : 0;
    write_pick(o, i, i, B, bts, wrap_add(w0[fb], eoff[fb]), s1,
               matches[fb], mapq, strand[fb], aligned);
}

template <int K>
__global__ void query_pick_paired_kernel(
    const int* __restrict__ score, const int* __restrict__ soff,
    const int* __restrict__ eoff, const int* __restrict__ matches,
    const int* __restrict__ w0, const int* __restrict__ votes,
    const int8_t* __restrict__ strand, const int* __restrict__ tstart,
    const int* __restrict__ tnode, int M, const int* __restrict__ read_len,
    int B, float mapq_scale, float min_frac, float rescue_frac,
    int frag_max, int pair_bonus, Out o) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    Cands<K> a, b;
    load_cands<K>(a, i, score, soff, w0, votes, tstart, tnode, M);
    load_cands<K>(b, static_cast<long long>(B) + i, score, soff, w0, votes,
                  tstart, tnode, M);
    int sa[K], sb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        sa[k] = strand[static_cast<long long>(i) * K + k];
        sb[k] = strand[(static_cast<long long>(B) + i) * K + k];
    }
    // ok and the pair score of pair (p, q), p of mate 1, q of mate 2
    auto ok = [&](int p, int q) {
        const int d = wrap_sub(a.ts[p], b.ts[q]);
        const int ad = d < 0 ? wrap_sub(0, d) : d;  // abs(INT_MIN) wraps
        return sa[p] != sb[q] && ad <= frag_max && a.score[p] > kHalfNeg &&
               b.score[q] > kHalfNeg;
    };
    auto pair = [&](int p, int q) {
        return wrap_add(wrap_add(a.score[p], b.score[q]),
                        ok(p, q) ? pair_bonus : 0);
    };
    int best = 0, p_best = pair(0, 0);
    bool ok_best = ok(0, 0);
#pragma unroll
    for (int j = 1; j < K * K; ++j) {
        const int v = pair(j / K, j % K);
        if (v > p_best) {  // first index on ties
            p_best = v;
            best = j;
            ok_best = ok(j / K, j % K);
        }
    }
    const int bi = best / K, bj = best % K;
    int s1b = 0, n1b = 0, o1b = 0, s2b = 0, n2b = 0, o2b = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k == bi) {
            s1b = a.score[k];
            n1b = a.node[k];
            o1b = a.off[k];
        }
        if (k == bj) {
            s2b = b.score[k];
            n2b = b.node[k];
            o2b = b.off[k];
        }
    }
    bool same1[K], same2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        same1[k] = a.node[k] == n1b && a.off[k] == o1b;
        same2[k] = b.node[k] == n2b && b.off[k] == o2b;
    }
    int p_second = 0;
#pragma unroll
    for (int j = 0; j < K * K; ++j) {
        const int p = j / K, q = j % K;
        const int v = (same1[p] && same2[q]) ? kNeg : pair(p, q);
        p_second = j == 0 ? v : max(p_second, v);
    }
    const int pair_mapq = gap_mapq(p_best, p_second, mapq_scale);
    int own1 = 0, own2 = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int v1 = same1[k] ? kNeg : a.score[k];
        const int v2 = same2[k] ? kNeg : b.score[k];
        own1 = k == 0 ? v1 : max(own1, v1);
        own2 = k == 0 ? v2 : max(own2, v2);
    }
    const int len1 = read_len[i];
    const int len2 = read_len[B + i];
    const bool al1 = s1b >= frac_of(min_frac, len1);
    const bool al2 = s2b >= frac_of(min_frac, len2);
    const bool aligned1 =
        al1 || (ok_best && al2 && s1b >= frac_of(rescue_frac, len1));
    const bool aligned2 =
        al2 || (ok_best && al1 && s2b >= frac_of(rescue_frac, len2));
    const int mapq1 = ok_best ? pair_mapq : gap_mapq(s1b, own1, mapq_scale);
    const int mapq2 = ok_best ? pair_mapq : gap_mapq(s2b, own2, mapq_scale);
    const long long f1 = static_cast<long long>(i) * K + bi;
    const long long f2 = (static_cast<long long>(B) + i) * K + bj;
    // mate 2: columns at row B + i, packed rows 4-7 (column 4 B + i)
    write_pick(o, i, i, B, wrap_add(w0[f1], soff[f1]),
               wrap_add(w0[f1], eoff[f1]), s1b, matches[f1],
               aligned1 ? mapq1 : 0, strand[f1], aligned1);
    write_pick(o, static_cast<long long>(B) + i, 4LL * B + i, B,
               wrap_add(w0[f2], soff[f2]), wrap_add(w0[f2], eoff[f2]), s2b,
               matches[f2], aligned2 ? mapq2 : 0, strand[f2], aligned2);
}

Out make_out(void* ts, void* te, void* score, void* matches, void* mapq,
             void* strand, void* aligned, void* packed) {
    Out o;
    o.ts = static_cast<int*>(ts);
    o.te = static_cast<int*>(te);
    o.score = static_cast<int*>(score);
    o.matches = static_cast<int*>(matches);
    o.mapq = static_cast<int*>(mapq);
    o.strand = static_cast<int8_t*>(strand);
    o.aligned = static_cast<bool*>(aligned);
    o.packed = static_cast<int*>(packed);
    return o;
}

bool columns_whole(const Out& o) {
    const bool any = o.ts || o.te || o.score || o.matches || o.mapq ||
                     o.strand || o.aligned;
    const bool all = o.ts && o.te && o.score && o.matches && o.mapq &&
                     o.strand && o.aligned;
    return any == all && (all || o.packed);
}

unsigned blocks_of(long long work) {
    return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

}  // namespace

// K4a: codes1 [B1, L1] (and codes2 [B2, L2], or null) -> out [B1 + B2, Lw]
// int8, lens_out [B1 + B2] int32 (or null).  Lw a multiple of 4, at least
// both widths rounded up to 4; out 4-byte aligned.
extern "C" int query_prologue_launch(
    const void* codes1, int B1, int L1, const void* len1, const void* codes2,
    int B2, int L2, const void* len2, int Lw, void* out, void* lens_out,
    void* stream) {
    if (B1 < 0 || B2 < 0 || L1 < 0 || L2 < 0 || Lw < 0 || (Lw & 3) ||
        (codes2 == nullptr && B2 != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    const int R = B1 + B2;
    const long long work = static_cast<long long>(R) * (Lw >> 2);
    if (work == 0) return 0;
    query_prologue_kernel<<<blocks_of(work), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes1), B1, L1,
        static_cast<const int*>(len1), static_cast<const int8_t*>(codes2), L2,
        static_cast<const int*>(len2), R, Lw, static_cast<int8_t*>(out),
        static_cast<int*>(lens_out));
    return static_cast<int>(cudaGetLastError());
}

// K4b: codes_fwd [R, Lc] int8, read_len [R], strand [R * K] (int8, or
// int32 where strand_bytes is 4), diag [R * K] int32 -> rows [R * K, Lp]
// int8 (Lp >= Lc; 16-byte aligned where Lp is a multiple of 16), len_rep
// and w0 [R * K] int32 (either may be null).
extern "C" int query_rows_launch(
    const void* fwd, int R, int Lc, const void* read_len, const void* strand,
    int strand_bytes, int K, const void* diag, int pad, int w_hi, int Lp,
    void* rows, void* len_rep, void* w0, void* stream) {
    if (R < 0 || Lc < 1 || K < 1 || Lp < Lc ||
        (strand_bytes != 1 && strand_bytes != 4) ||
        (w0 != nullptr && diag == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long work = static_cast<long long>(R) * K * ((Lp + 15) / 16);
    if (work == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (strand_bytes == 1)
        query_rows_kernel<int8_t><<<blocks_of(work), kThreads, 0, s>>>(
            static_cast<const int8_t*>(fwd), R, Lc,
            static_cast<const int*>(read_len),
            static_cast<const int8_t*>(strand), K,
            static_cast<const int*>(diag), pad, w_hi, Lp,
            static_cast<int8_t*>(rows), static_cast<int*>(len_rep),
            static_cast<int*>(w0));
    else
        query_rows_kernel<int><<<blocks_of(work), kThreads, 0, s>>>(
            static_cast<const int8_t*>(fwd), R, Lc,
            static_cast<const int*>(read_len),
            static_cast<const int*>(strand), K,
            static_cast<const int*>(diag), pad, w_hi, Lp,
            static_cast<int8_t*>(rows), static_cast<int*>(len_rep),
            static_cast<int*>(w0));
    return static_cast<int>(cudaGetLastError());
}

#define PANTAX_QUERY_K_SWITCH(K, LAUNCH) \
    switch (K) {                         \
        case 1: LAUNCH(1); break;        \
        case 2: LAUNCH(2); break;        \
        case 3: LAUNCH(3); break;        \
        case 4: LAUNCH(4); break;        \
        case 5: LAUNCH(5); break;        \
        case 6: LAUNCH(6); break;        \
        case 7: LAUNCH(7); break;        \
        case 8: LAUNCH(8); break;        \
        default: break;                  \
    }

// K5: K1's score, start_off, end_off, matches and w0 [B * K], cand_votes
// [B, K] int32 and strand [B, K] int8, tstart and tnode [M] int32,
// read_len [B] -> the 7 columns [B] (all null, or none) and / or packed
// [4, B] int32.
extern "C" int query_pick_launch(
    const void* score, const void* start_off, const void* end_off,
    const void* matches, const void* w0, const void* votes,
    const void* strand, const void* tstart, const void* tnode, int M,
    const void* read_len, int B, int K, float mapq_scale, float min_frac,
    void* o_ts, void* o_te, void* o_score, void* o_matches, void* o_mapq,
    void* o_strand, void* o_aligned, void* o_packed, void* stream) {
    const Out o = make_out(o_ts, o_te, o_score, o_matches, o_mapq, o_strand,
                           o_aligned, o_packed);
    if (B < 0 || K < 1 || K > kMaxK || M < 1 || !columns_whole(o))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PANTAX_LAUNCH_K5(KK)                                                \
    query_pick_kernel<KK><<<blocks_of(B), kThreads, 0, s>>>(                 \
        static_cast<const int*>(score), static_cast<const int*>(start_off), \
        static_cast<const int*>(end_off), static_cast<const int*>(matches), \
        static_cast<const int*>(w0), static_cast<const int*>(votes),        \
        static_cast<const int8_t*>(strand),                                  \
        static_cast<const int*>(tstart), static_cast<const int*>(tnode), M, \
        static_cast<const int*>(read_len), B, mapq_scale, min_frac, o)
    PANTAX_QUERY_K_SWITCH(K, PANTAX_LAUNCH_K5)
#undef PANTAX_LAUNCH_K5
    return static_cast<int>(cudaGetLastError());
}

// K5p: the candidates of 2B reads (mate 1's B rows, then mate 2's) as K5
// takes them, read_len [2B] -> the 7 columns [2B] (mate 1's B, then mate
// 2's; all null, or none) and / or packed [8, B] int32 (mate 1's four
// rows, then mate 2's).
extern "C" int query_pick_paired_launch(
    const void* score, const void* start_off, const void* end_off,
    const void* matches, const void* w0, const void* votes,
    const void* strand, const void* tstart, const void* tnode, int M,
    const void* read_len, int B, int K, float mapq_scale, float min_frac,
    float rescue_frac, int frag_max, int pair_bonus, void* o_ts, void* o_te,
    void* o_score, void* o_matches, void* o_mapq, void* o_strand,
    void* o_aligned, void* o_packed, void* stream) {
    const Out o = make_out(o_ts, o_te, o_score, o_matches, o_mapq, o_strand,
                           o_aligned, o_packed);
    if (B < 0 || K < 1 || K > kMaxK || M < 1 || !columns_whole(o))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PANTAX_LAUNCH_K5P(KK)                                               \
    query_pick_paired_kernel<KK><<<blocks_of(B), kThreads, 0, s>>>(          \
        static_cast<const int*>(score), static_cast<const int*>(start_off), \
        static_cast<const int*>(end_off), static_cast<const int*>(matches), \
        static_cast<const int*>(w0), static_cast<const int*>(votes),        \
        static_cast<const int8_t*>(strand),                                  \
        static_cast<const int*>(tstart), static_cast<const int*>(tnode), M, \
        static_cast<const int*>(read_len), B, mapq_scale, min_frac,         \
        rescue_frac, frag_max, pair_bonus, o)
    PANTAX_QUERY_K_SWITCH(K, PANTAX_LAUNCH_K5P)
#undef PANTAX_LAUNCH_K5P
    return static_cast<int>(cudaGetLastError());
}
