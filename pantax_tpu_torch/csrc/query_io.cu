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
// projection is a chain of dependent loads a candidate, which latency,
// not bytes, holds.  K4a: one thread a 4-byte word.
//
// K4b (redesigned for Hopper): one thread a 16-byte chunk of a candidate
// row, its indices 32-bit from a 3-D block (a chunk, the read's candidate,
// a read), so no thread divides and neighbouring threads write
// neighbouring bytes.  The codes are K4a's rows, a multiple of 4 wide: the
// forward strand's chunk is one 16-byte load (where the row width is a
// multiple of 16) or four 4-byte loads; the reverse strand's chunk, source
// bytes [l - 16 - c0, l - 1 - c0] for output columns [c0, c0 + 16), comes
// from the five aligned words that hold them, each output word one byte
// permute of two of them, complemented four bytes at a time and masked to
// 4 at and past read_len.  A read_len past the codes' width (never on the
// aligner's paths) takes the byte loop.  One 16-byte store where the row
// width is a multiple of 16 (K1's rows), else 4-byte stores.
//
// K5 and K5p (redesigned for Hopper): one thread a read or a mate pair,
// templated on K so the candidates stay in registers, every field of a
// read's K candidates loaded at once, the best's columns taken from
// registers (int2 loads of a read's two candidates timed no faster: the
// chain below, not the loads' count, holds a thread).  The projection
// searches only ts's bucket of pos_lo (ops/query.py's segment_lookup: at
// the smoke DB's 850,989 segments and 30 M bases, 2^22 buckets of 8
// positions, ~16 MB), so a candidate's chain is its bucket's bounds, ~1
// bisection step and its segment's node and start, not ~20 steps over
// every start.
#include <climits>
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

// K4b's and K5's levers, each on (scripts/time_extend.py --kernel k4b or
// k5 --ablate takes one out): PANTAX_K4B_GRID_INDEX, K4b's 32-bit indices
// from a 3-D block (0: a flat grid, the candidate and the read divided out
// of a 64-bit index; a macro, so that a build compiles only the grid it
// launches); kWordLoads, the forward strand's chunk in 16- or 4-byte
// loads (off: 16 byte loads); kRegisterReverse, the reverse strand's
// chunk from five aligned words by byte permutes (off: a byte at a time,
// walking the source back); kBucketSearch, the projection's bisection
// inside ts's bucket of pos_lo (off: over all M starts)
#define PANTAX_K4B_GRID_INDEX 1
constexpr bool kWordLoads = true;
constexpr bool kRegisterReverse = true;
constexpr bool kBucketSearch = true;

constexpr unsigned kN4 = 0x04040404u;  // four N codes
constexpr int kMaxChunks = 64;         // K4b: a block's chunks of a row

struct RowsArgs {
    const int8_t* fwd;   // [R, Lc], Lc a multiple of 4, 4-byte aligned
    const int* len;      // [R]
    const void* strand;  // [R K], int8 or int32
    const int* diag;     // [R K], or null without w0
    int8_t* rows;        // [R K, Lp], Lp a multiple of 4
    int* len_rep;        // [R K], or null
    int* w0;             // [R K], or null
    int R, Lc, K, pad, w_hi, Lp;
    bool src16;          // fwd's rows start on 16-byte boundaries
};

// per byte, as an int8 code x: 3 - x (wrapping) where x < 4, else 4
__device__ __forceinline__ unsigned complement4(unsigned x) {
    const unsigned lt = __vcmplts4(x, kN4);
    return (__vsub4(0x03030303u, x) & lt) | (kN4 & ~lt);
}

// x with its bytes from the v-th on set to 4 (v < 0: all, v >= 4: none)
__device__ __forceinline__ unsigned keep_bytes(unsigned x, int v) {
    const unsigned m = v >= 4 ? 0xFFFFFFFFu
                              : v <= 0 ? 0u : (1u << (8 * v)) - 1u;
    return (x & m) | (kN4 & ~m);
}

// columns [c0, c0 + 16) copied from a row of Lc columns, 4 past Lc
__device__ __forceinline__ uint4 forward_chunk(const int8_t* src, int Lc,
                                               int c0, bool src16) {
    if (c0 >= Lc) return make_uint4(kN4, kN4, kN4, kN4);
    if (src16)  // Lc a multiple of 16: the chunk lies in the row
        return __ldg(reinterpret_cast<const uint4*>(src + c0));
    const unsigned* w = reinterpret_cast<const unsigned*>(src + c0);
    const int words = (Lc - c0) >> 2;  // the row's words from c0
    return make_uint4(__ldg(w), words > 1 ? __ldg(w + 1) : kN4,
                      words > 2 ? __ldg(w + 2) : kN4,
                      words > 3 ? __ldg(w + 3) : kN4);
}

// columns [c0, c0 + 16) of the reverse complement of a row's first l
// columns (l <= the row's width), 4 at and past l: column c is the
// complement of src[l - 1 - c].  With hi = l - 1 - c0, the source bytes
// hi - 15 .. hi lie in the five aligned words up to hi's (those before
// the row are never kept); output word q is bytes hi - 4q .. hi - 4q - 3,
// one byte permute of words 3 - q and 4 - q of the five.
__device__ __forceinline__ uint4 reverse_chunk(const int8_t* src, int l,
                                               int c0) {
    const int hi = l - 1 - c0;
    if (hi < 0) return make_uint4(kN4, kN4, kN4, kN4);
    const unsigned* row = reinterpret_cast<const unsigned*>(src);
    const int top = hi >> 2;
    const unsigned w4 = __ldg(row + top);
    const unsigned w3 = top >= 1 ? __ldg(row + top - 1) : kN4;
    const unsigned w2 = top >= 2 ? __ldg(row + top - 2) : kN4;
    const unsigned w1 = top >= 3 ? __ldg(row + top - 3) : kN4;
    const unsigned w0 = top >= 4 ? __ldg(row + top - 4) : kN4;
    // in the pair (lower word, upper word) hi's byte is s + 3, s = e + 1
    const unsigned s = static_cast<unsigned>(hi & 3) + 1u;
    const unsigned sel = (s + 3u) | ((s + 2u) << 4) | ((s + 1u) << 8) |
                         (s << 12);
    const int v = l - c0;  // the chunk's columns before l
    return make_uint4(
        keep_bytes(complement4(__byte_perm(w3, w4, sel)), v),
        keep_bytes(complement4(__byte_perm(w2, w3, sel)), v - 4),
        keep_bytes(complement4(__byte_perm(w1, w2, sel)), v - 8),
        keep_bytes(complement4(__byte_perm(w0, w1, sel)), v - 12));
}

// columns [c0, c0 + 16) a byte at a time: the row's (rev false) or the
// reverse complement of its first l columns, src[l - 1 - c] clipped into
// the row (rev true; l may pass Lc); 4 past Lc
__device__ __forceinline__ uint4 byte_chunk(const int8_t* src, int Lc, int l,
                                            int c0, bool rev) {
    unsigned w[4] = {0u, 0u, 0u, 0u};  // constant indices after the unroll
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int c = c0 + j;
        int v = 4;
        if (c < Lc) {
            if (!rev) {
                v = src[c];
            } else if (c < l) {
                const int x = src[min(static_cast<long long>(l) - 1 - c,
                                      static_cast<long long>(Lc) - 1)];
                v = x < 4 ? static_cast<int8_t>(3 - x) : 4;
            }
        }
        w[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(v))
                     << (8 * (j & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// chunk ch of candidate n's row (read r), and its len_rep and w0
template <typename StrandT>
__device__ __forceinline__ void write_row_chunk(const RowsArgs& a, int n,
                                                int r, int ch) {
    const int l = __ldg(a.len + r);
    const bool rev =
        static_cast<int>(__ldg(static_cast<const StrandT*>(a.strand) + n)) ==
        1;
    const int8_t* src = a.fwd + static_cast<size_t>(r) * a.Lc;
    const int c0 = ch * 16;
    uint4 v;
    if (!rev) {
        if constexpr (kWordLoads)
            v = forward_chunk(src, a.Lc, c0, a.src16);
        else
            v = byte_chunk(src, a.Lc, l, c0, false);
    } else if (kRegisterReverse && l <= a.Lc) {
        v = reverse_chunk(src, l, c0);
    } else {
        v = byte_chunk(src, a.Lc, l, c0, true);
    }
    int8_t* dst = a.rows + static_cast<size_t>(n) * a.Lp + c0;
    if ((a.Lp & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = v;
    } else {  // 4-byte stores up to the row's end
        unsigned* d = reinterpret_cast<unsigned*>(dst);
        const int m = a.Lp - c0;
        d[0] = v.x;
        if (m > 4) d[1] = v.y;
        if (m > 8) d[2] = v.z;
        if (m > 12) d[3] = v.w;
    }
    if (ch == 0) {
        if (a.len_rep != nullptr) a.len_rep[n] = l;
        if (a.w0 != nullptr)
            a.w0[n] = min(max(wrap_sub(__ldg(a.diag + n), a.pad), 0), a.w_hi);
    }
}

// threadIdx.x a chunk (blockIdx.y its group of blockDim.x), threadIdx.y
// the read's candidate (blockDim.y == K), threadIdx.z a read
template <typename StrandT>
__global__ void query_rows_kernel(RowsArgs a) {
    const int ch = blockIdx.y * blockDim.x + threadIdx.x;
    const int r = blockIdx.x * blockDim.z + threadIdx.z;
    if (r >= a.R || ch >= (a.Lp + 15) >> 4) return;
    write_row_chunk<StrandT>(a, r * a.K + static_cast<int>(threadIdx.y), r,
                             ch);
}

#if !PANTAX_K4B_GRID_INDEX
// a flat grid of R K x chunks threads
template <typename StrandT>
__global__ void query_rows_flat_kernel(RowsArgs a) {
    const int chunks = (a.Lp + 15) >> 4;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (t >= static_cast<long long>(a.R) * a.K * chunks) return;
    const long long n = t / chunks;
    write_row_chunk<StrandT>(a, static_cast<int>(n),
                             static_cast<int>(n / a.K),
                             static_cast<int>(t - n * chunks));
}
#endif

// what the picks read of the candidates ([R K] each; votes [R, K])
struct PickIn {
    const int* score;
    const int* soff;
    const int* eoff;
    const int* matches;
    const int* w0;
    const int* votes;
    const int8_t* strand;
    const int* read_len;
};

// the segments and the bucket table of their starts: pos_lo[b] the starts
// at or before b << shift, b in [0, nb]; every start in [0, nb << shift)
struct Segments {
    const int* tstart;
    const int* tnode;
    const int* pos_lo;
    int M, nb, shift;
};

// searchsorted(tstart, x, right=True) - 1, clipped into [0, M - 1]: an x
// before 0 or past the last bucket is before or past every start; else the
// bisection inside x's bucket
__device__ __forceinline__ int segment_of(const Segments& s, int x) {
    int lo = 0, hi = s.M;
    if constexpr (kBucketSearch) {
        if (x < 0) return 0;
        const int b = x >> s.shift;
        if (b >= s.nb) return s.M - 1;
        lo = min(__ldg(s.pos_lo + b), s.M);
        hi = min(__ldg(s.pos_lo + b + 1), s.M);
    }
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(s.tstart + mid) <= x) lo = mid + 1;
        else hi = mid;
    }
    return min(max(lo - 1, 0), s.M - 1);
}

// the K values of row ``row`` of a [R, K] array
template <int K, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         size_t row, int (&v)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __ldg(p + row * K + k);
}

// a read's K candidates: the masked score, ts, te, matches, strand and
// graph location of each
template <int K>
struct Cands {
    int score[K], ts[K], te[K], matches[K], strand[K], node[K], off[K];
};

template <int K>
__device__ __forceinline__ void load_cands(Cands<K>& c, size_t row,
                                           const PickIn& in,
                                           const Segments& s) {
    int votes[K], w0[K], soff[K], eoff[K];
    load_row<K>(in.score, row, c.score);
    load_row<K>(in.votes, row, votes);
    load_row<K>(in.w0, row, w0);
    load_row<K>(in.soff, row, soff);
    load_row<K>(in.eoff, row, eoff);
    load_row<K>(in.matches, row, c.matches);
    load_row<K>(in.strand, row, c.strand);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c.score[k] = votes[k] > 0 ? c.score[k] : kNeg;
        c.ts[k] = wrap_add(w0[k], soff[k]);
        c.te[k] = wrap_add(w0[k], eoff[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i0 = segment_of(s, c.ts[k]);
        c.node[k] = __ldg(s.tnode + i0);
        c.off[k] = wrap_sub(c.ts[k], __ldg(s.tstart + i0));
    }
}

// one candidate's fields
struct Picked {
    int score, ts, te, matches, strand, node, off;
};

// candidate k of c, k known only at run time: selected over the unrolled
// K, so no register array is indexed at run time
template <int K>
__device__ __forceinline__ Picked take(const Cands<K>& c, int k) {
    Picked p{c.score[0],  c.ts[0],   c.te[0], c.matches[0],
             c.strand[0], c.node[0], c.off[0]};
#pragma unroll
    for (int j = 1; j < K; ++j)
        if (j == k)
            p = Picked{c.score[j],  c.ts[j],   c.te[j], c.matches[j],
                       c.strand[j], c.node[j], c.off[j]};
    return p;
}

template <int K>
__global__ void query_pick_kernel(PickIn in, Segments s, int B,
                                  float mapq_scale, float min_frac, Out o) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const int len = __ldg(in.read_len + i);
    Cands<K> c;
    load_cands<K>(c, i, in, s);
    int best = 0, s1 = c.score[0];
#pragma unroll
    for (int k = 1; k < K; ++k)
        if (c.score[k] > s1) {  // first index on ties
            s1 = c.score[k];
            best = k;
        }
    const Picked b = take(c, best);
    int s2 = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int v = (c.node[k] == b.node && c.off[k] == b.off) ? kNeg
                                                                : c.score[k];
        s2 = k == 0 ? v : max(s2, v);
    }
    const bool aligned = s1 >= frac_of(min_frac, len);
    const int mapq = aligned ? gap_mapq(s1, s2, mapq_scale) : 0;
    write_pick(o, i, i, B, b.ts, b.te, s1, b.matches, mapq, b.strand,
               aligned);
}

template <int K>
__global__ void query_pick_paired_kernel(PickIn in, Segments s, int B,
                                         float mapq_scale, float min_frac,
                                         float rescue_frac, int frag_max,
                                         int pair_bonus, Out o) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    const int len1 = __ldg(in.read_len + i);
    const int len2 = __ldg(in.read_len + B + i);
    Cands<K> a, b;
    load_cands<K>(a, i, in, s);
    load_cands<K>(b, static_cast<size_t>(B) + i, in, s);
    // ok and the pair score of pair (p, q), p of mate 1, q of mate 2
    auto ok = [&](int p, int q) {
        const int d = wrap_sub(a.ts[p], b.ts[q]);
        const int ad = d < 0 ? wrap_sub(0, d) : d;  // abs(INT_MIN) wraps
        return a.strand[p] != b.strand[q] && ad <= frag_max &&
               a.score[p] > kHalfNeg && b.score[q] > kHalfNeg;
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
    const Picked m1 = take(a, best / K), m2 = take(b, best % K);
    bool same1[K], same2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        same1[k] = a.node[k] == m1.node && a.off[k] == m1.off;
        same2[k] = b.node[k] == m2.node && b.off[k] == m2.off;
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
    const bool al1 = m1.score >= frac_of(min_frac, len1);
    const bool al2 = m2.score >= frac_of(min_frac, len2);
    const bool aligned1 =
        al1 || (ok_best && al2 && m1.score >= frac_of(rescue_frac, len1));
    const bool aligned2 =
        al2 || (ok_best && al1 && m2.score >= frac_of(rescue_frac, len2));
    const int mapq1 =
        ok_best ? pair_mapq : gap_mapq(m1.score, own1, mapq_scale);
    const int mapq2 =
        ok_best ? pair_mapq : gap_mapq(m2.score, own2, mapq_scale);
    // mate 2: columns at row B + i, packed rows 4-7 (column 4 B + i)
    write_pick(o, i, i, B, m1.ts, m1.te, m1.score, m1.matches,
               aligned1 ? mapq1 : 0, m1.strand, aligned1);
    write_pick(o, static_cast<long long>(B) + i, 4LL * B + i, B, m2.ts,
               m2.te, m2.score, m2.matches, aligned2 ? mapq2 : 0, m2.strand,
               aligned2);
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

bool aligned_to(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

// the picks' checks: the reads, K, the segments and their bucket table
// (n_pos = nb + 1 bounds, nb a power of two), the outputs
bool pick_ok(int B, int K, int M, int n_pos, int win_shift, const Out& o) {
    return B >= 0 && K >= 1 && K <= kMaxK && M >= 1 && n_pos >= 2 &&
           ((n_pos - 1) & (n_pos - 2)) == 0 && win_shift >= 0 &&
           win_shift < 31 && columns_whole(o) &&
           2LL * B * K <= INT_MAX;
}

PickIn pick_in(const void* score, const void* start_off, const void* end_off,
               const void* matches, const void* w0, const void* votes,
               const void* strand, const void* read_len) {
    return PickIn{static_cast<const int*>(score),
                  static_cast<const int*>(start_off),
                  static_cast<const int*>(end_off),
                  static_cast<const int*>(matches),
                  static_cast<const int*>(w0), static_cast<const int*>(votes),
                  static_cast<const int8_t*>(strand),
                  static_cast<const int*>(read_len)};
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

// K4b: codes_fwd [R, Lc] int8 (Lc a multiple of 4, 4-byte aligned),
// read_len [R], strand [R * K] (int8, or int32 where strand_bytes is 4),
// diag [R * K] int32 -> rows [R * K, Lp] int8 (Lp >= Lc a multiple of 4;
// 16-byte aligned where Lp is a multiple of 16, else 4-byte), len_rep and
// w0 [R * K] int32 (either may be null).
extern "C" int query_rows_launch(
    const void* fwd, int R, int Lc, const void* read_len, const void* strand,
    int strand_bytes, int K, const void* diag, int pad, int w_hi, int Lp,
    void* rows, void* len_rep, void* w0, void* stream) {
    const int chunks = (Lp + 15) / 16;
    const int bx = min(chunks, kMaxChunks);
    if (R < 0 || Lc < 4 || (Lc & 3) || K < 1 || K > kMaxK || Lp < Lc ||
        (Lp & 3) || (strand_bytes != 1 && strand_bytes != 4) ||
        (w0 != nullptr && diag == nullptr) || !aligned_to(fwd, 4) ||
        !aligned_to(rows, (Lp & 15) == 0 ? 16 : 4) ||
        static_cast<long long>(R) * K * chunks > INT_MAX ||
        (chunks + bx - 1) / bx > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (R == 0) return 0;
    const RowsArgs a{static_cast<const int8_t*>(fwd),
                     static_cast<const int*>(read_len), strand,
                     static_cast<const int*>(diag),
                     static_cast<int8_t*>(rows), static_cast<int*>(len_rep),
                     static_cast<int*>(w0), R, Lc, K, pad, w_hi, Lp,
                     (Lc & 15) == 0 && aligned_to(fwd, 16)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#if PANTAX_K4B_GRID_INDEX
    const int bz = max(1, min(64, kThreads / (bx * K)));
    const dim3 block(bx, K, bz);
    const dim3 grid((R + bz - 1) / bz, (chunks + bx - 1) / bx);
    if (strand_bytes == 1)
        query_rows_kernel<int8_t><<<grid, block, 0, s>>>(a);
    else
        query_rows_kernel<int><<<grid, block, 0, s>>>(a);
#else
    const unsigned grid = blocks_of(static_cast<long long>(R) * K * chunks);
    if (strand_bytes == 1)
        query_rows_flat_kernel<int8_t><<<grid, kThreads, 0, s>>>(a);
    else
        query_rows_flat_kernel<int><<<grid, kThreads, 0, s>>>(a);
#endif
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
// [B, K] int32 and strand [B, K] int8, tstart and tnode [M] int32 with
// the bucket table of the starts (ops/query.py's segment_lookup: pos_lo
// [n_pos] int32, win_shift), read_len [B] -> the 7 columns [B] (all null,
// or none) and / or packed [4, B] int32.
extern "C" int query_pick_launch(
    const void* score, const void* start_off, const void* end_off,
    const void* matches, const void* w0, const void* votes,
    const void* strand, const void* tstart, const void* tnode, int M,
    const void* pos_lo, int n_pos, int win_shift, const void* read_len,
    int B, int K, float mapq_scale, float min_frac, void* o_ts, void* o_te,
    void* o_score, void* o_matches, void* o_mapq, void* o_strand,
    void* o_aligned, void* o_packed, void* stream) {
    const Out o = make_out(o_ts, o_te, o_score, o_matches, o_mapq, o_strand,
                           o_aligned, o_packed);
    if (!pick_ok(B, K, M, n_pos, win_shift, o))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const PickIn in = pick_in(score, start_off, end_off, matches, w0, votes,
                              strand, read_len);
    const Segments sg{static_cast<const int*>(tstart),
                      static_cast<const int*>(tnode),
                      static_cast<const int*>(pos_lo), M, n_pos - 1,
                      win_shift};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PANTAX_LAUNCH_K5(KK)                                  \
    query_pick_kernel<KK><<<blocks_of(B), kThreads, 0, s>>>( \
        in, sg, B, mapq_scale, min_frac, o)
    PANTAX_QUERY_K_SWITCH(K, PANTAX_LAUNCH_K5)
#undef PANTAX_LAUNCH_K5
    return static_cast<int>(cudaGetLastError());
}

// K5p: the candidates of 2B reads (mate 1's B rows, then mate 2's) and
// the segments as K5 takes them, read_len [2B] -> the 7 columns [2B]
// (mate 1's B, then mate 2's; all null, or none) and / or packed [8, B]
// int32 (mate 1's four rows, then mate 2's).
extern "C" int query_pick_paired_launch(
    const void* score, const void* start_off, const void* end_off,
    const void* matches, const void* w0, const void* votes,
    const void* strand, const void* tstart, const void* tnode, int M,
    const void* pos_lo, int n_pos, int win_shift, const void* read_len,
    int B, int K, float mapq_scale, float min_frac, float rescue_frac,
    int frag_max, int pair_bonus, void* o_ts, void* o_te, void* o_score,
    void* o_matches, void* o_mapq, void* o_strand, void* o_aligned,
    void* o_packed, void* stream) {
    const Out o = make_out(o_ts, o_te, o_score, o_matches, o_mapq, o_strand,
                           o_aligned, o_packed);
    if (!pick_ok(B, K, M, n_pos, win_shift, o))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const PickIn in = pick_in(score, start_off, end_off, matches, w0, votes,
                              strand, read_len);
    const Segments sg{static_cast<const int*>(tstart),
                      static_cast<const int*>(tnode),
                      static_cast<const int*>(pos_lo), M, n_pos - 1,
                      win_shift};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PANTAX_LAUNCH_K5P(KK)                                        \
    query_pick_paired_kernel<KK><<<blocks_of(B), kThreads, 0, s>>>( \
        in, sg, B, mapq_scale, min_frac, rescue_frac, frag_max,      \
        pair_bonus, o)
    PANTAX_QUERY_K_SWITCH(K, PANTAX_LAUNCH_K5P)
#undef PANTAX_LAUNCH_K5P
    return static_cast<int>(cudaGetLastError());
}
