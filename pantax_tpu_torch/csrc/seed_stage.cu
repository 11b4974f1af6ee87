// The query's seed stage for Hopper (sm_90a): K3.
//
// Replaces the JAX package's seed stage, which XLA fuses into the one
// jitted query function (pantax_tpu/align/aligner.py): _kmer_hashes_j
// (:226), _select_seeds (:246), _lookup_hits (:269), _vote_diagonals (:340)
// and the strand union of _all_candidates (:537-549).  Per read, from the
// unpacked forward codes codes[r, :L] (columns at or past read_len hold 4)
// to the K = top_k extension candidates:
// - the canonical hash of every k-mer position p in [0, L - k + 1),
//   mix32(min(fwd, rc)), fwd = sum c[p+i] B^(k-1-i), rc = sum (3 - c[p+i])
//   B^i in uint32, valid where no code of the k-mer is 4;
// - the first s_max valid positions whose hash has density_bits low zero
//   bits, in position order (unfilled seeds are invalid);
// - each seed's C = hits text positions: the CHD slot table (steps < 0;
//   rows [key, run length, C positions]) or bucketed bisection (steps >= 0;
//   rows [key, first index, run length] over seed_pos);
// - the forward diagonals t - p and reverse ones t - (read_len - k - p) of
//   the S * C hits, BIG = 2^30 where a hit is invalid; on each strand the
//   votes (valid hits within +-band of a valid hit) and top_k rounds of
//   argmax (first index on ties) with kill-within-band over all S * C
//   slots;
// - the union: top_k rounds of argmax over the 2K (forward K, then
//   reverse K) candidates' votes, the chosen one set to -1; strand 1 for a
//   reverse slot.
// Outputs cand_diag, cand_votes int32 [B, K] and strand int8 [B, K], bit
// for bit those of the plain torch version (ops/seed.py).  Hashes wrap mod
// 2^32 as the plain version's masked int64 do, and a difference of two
// diagonals wraps in int32 as torch's does.
//
// What bounds it: per read it reads L code bytes and, for each valid seed,
// a displacement and a CHD row (~11 MB of codes and ~30 MB of gathers at
// B = 65536, L = 160, 16 seeds), and it does ~16 integer instructions per
// k-mer position inside read_len and a difference, a borrow and half a
// carry-add (2.5) for every pair of valid hits on each strand: instruction
// issue bounds it, ahead of the bytes.  One warp per read, 32 registers
// (the SM's 64 warps), at most 48,144 bytes of shared memory a warp (the
// wrapper's widest shape), each step spending its instructions on that
// work:
// - hashes: lane i owns positions [i * seg, (i + 1) * seg), seg =
//   ceil(L / 32): its first window in k steps, then both hashes rolled
//   with five multiply-adds a position (the reverse through the base's
//   inverse mod 2^32).  A sampled position keeps its hash in shared
//   memory and a bit in the lane's mark word;
// - the first s_max sampled positions: an exclusive warp scan of the
//   lanes' mark counts ranks them, and each lane writes its own to the
//   seed list with the hash it kept (none is hashed twice);
// - the lookups: one lane a seed finds its row (CHD slot or bisection
//   run) and how many of its hits are valid; lane i then takes hit slots
//   i, i + 32, ..., and the valid hits are compacted in slot order (ballot
//   and popc) into one array of (forward, reverse) diagonal pairs;
// - the vote: a lane holds its compacted hits' (diagonal - band), and
//   every valid hit is broadcast from shared memory, two a 16-byte load.
//   The band test is the borrow of 2 band - (d - lo), added as a carry
//   (2.5 instructions a pair: ptxas adds two carries in one IADD3.X).
//   Only where a strand's diagonals span 2^31 or more does it add the
//   difference -2^31, which torch's wrapping abs keeps within the band.
//   No invalid slot is compared (its count stays 0);
// - each top_k round is one warp max (redux) over (votes, lowest slot)
//   keys; a round whose best count is 0 returns slot 0's diagonal (BIG if
//   it is invalid), as torch's argmax does; the kill tests every held hit
//   (an invalid slot's count is 0 already); the union is K more such
//   rounds over 2K lanes.
// Nothing of the stage leaves the SM but the three outputs.
// scripts/time_extend.py --kernel k3 times this source against another
// and against itself with one of these levers taken out (K3_ABLATIONS).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kBase = 0x9E3779B1u;     // the k-mer hash base
constexpr uint32_t kChdGold = 0x9E3779B9u;  // the CHD displacement salt
constexpr int kBig = 1 << 30;               // the diagonal of an invalid hit
constexpr int kMaxSlots = 256;              // s_max * hits
constexpr int kMaxTopK = 8;
constexpr int kMaxWarps = 4;                // reads per block
constexpr int kSmemCap = 48 * 1024;         // a block's by default
constexpr unsigned kFull = 0xFFFFFFFFu;

// b * inverse32(b) == 1 mod 2^32 for odd b (Newton: 3, 6, 12, 24, 48 bits)
constexpr uint32_t inverse32(uint32_t b) {
    uint32_t x = b;
    for (int i = 0; i < 4; ++i) x *= 2u - b * x;
    return x;
}
constexpr uint32_t kBaseInv = inverse32(kBase);
static_assert(kBase * kBaseInv == 1u, "the hash base must be odd");

__host__ __device__ inline uint32_t pow32(uint32_t b, int e) {
    uint32_t x = 1;
    for (int i = 0; i < e; ++i) x *= b;
    return x;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// a code as the plain version's int64 (and the reference's uint32) sees it
__device__ __forceinline__ uint32_t code_of(int8_t c) {
    return static_cast<uint32_t>(static_cast<int32_t>(c));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// int32 arithmetic that wraps, as torch's does
__device__ __forceinline__ int wrap_add(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) +
                            static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) -
                            static_cast<uint32_t>(b));
}

// The hashing constants of one launch (the host computes them).
struct HashConsts {
    int seg;             // positions a lane
    uint32_t nbk, nbk1;  // -B^k, -B^(k-1)
    uint32_t crc;        // 3 B^(k-1) - 3 B^-1: the reverse roll's constant
    uint32_t rc3;        // 3 * sum_{i<k} B^i
    uint32_t hits_mul;   // ceil(2^32 / hits): i / hits as a high product;
                         // 0 for hits 1
};

// one warp's shared memory, in bytes from its base
struct Layout {
    int codes, hs, marks, seeds, dp, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int L, int n, int s_max,
                                         int slots) {
    const int words = ((L + 31) / 32 + 31) / 32;  // mark words a lane
    Layout o;
    int off = 0;
    o.codes = off;  off += align16(L + 1);  // + the byte one roll past L reads
    o.hs = off;     off += align16(4 * n);
    o.marks = off;  off += align16(4 * 32 * words);
    o.seeds = off;  off += align16(16 * s_max);
    o.dp = off;     off += align16(8 * slots);
    o.bytes = off;
    return o;
}

// one hit j against a lane's held hit: (d_j - (d_own - band)) as uint32
// <= 2 band is |d_j - d_own| <= band for every wrapped difference but
// -2^31, which torch's abs keeps (abs(INT_MIN) == INT_MIN <= band): u ==
// band + 2^31.  WRAP adds that case; a strand whose diagonals span less
// than 2^31 has no such pair.
template <bool WRAP>
__device__ __forceinline__ bool near(int d, int lo, uint32_t band2,
                                     uint32_t wrapu) {
    const uint32_t u = static_cast<uint32_t>(wrap_sub(d, lo));
    return WRAP ? (u <= band2) | (u == wrapu) : (u <= band2);
}

// cnt += near(d, lo): without WRAP the borrow of 2 band - u is the test,
// added as a carry (with the difference, 2.5 instructions a pair: ptxas
// adds two pairs' carries in one IADD3.X)
template <bool WRAP>
__device__ __forceinline__ void tally(int& cnt, int d, int lo,
                                      uint32_t band2, uint32_t wrapu) {
    if (WRAP) {
        cnt += near<true>(d, lo, band2, wrapu);
    } else {
        const uint32_t u = static_cast<uint32_t>(wrap_sub(d, lo));
        asm("{\n\t.reg .u32 t;\n\tsub.cc.u32 t, %1, %2;\n\t"
            "addc.u32 %0, %0, 0;\n\t}"
            : "+r"(cnt) : "r"(band2), "r"(u));
    }
}

// every compacted hit (two a 16-byte broadcast) against the lane's held
// hits, on both strands
template <int NW, bool WRAP>
__device__ __forceinline__ void count_votes(const int2* dp, int V,
                                            uint32_t band2, uint32_t wrapu,
                                            const int (&lo_f)[NW],
                                            const int (&lo_r)[NW],
                                            int (&cf)[NW], int (&cr)[NW]) {
    const int4* dp4 = reinterpret_cast<const int4*>(dp);
    int j = 0;
#pragma unroll 2
    for (; j + 2 <= V; j += 2) {
        const int4 d = dp4[j >> 1];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            tally<WRAP>(cf[w], d.x, lo_f[w], band2, wrapu);
            tally<WRAP>(cr[w], d.y, lo_r[w], band2, wrapu);
            tally<WRAP>(cf[w], d.z, lo_f[w], band2, wrapu);
            tally<WRAP>(cr[w], d.w, lo_r[w], band2, wrapu);
        }
    }
    if (j < V) {
        const int2 d = dp[j];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            tally<WRAP>(cf[w], d.x, lo_f[w], band2, wrapu);
            tally<WRAP>(cr[w], d.y, lo_r[w], band2, wrapu);
        }
    }
}

// one top_k round on one strand: the best (votes, lowest slot) over the
// warp, its diagonal, and the kill within the band.  Returns (diagonal,
// votes).  ``col`` is the strand's column of the compacted pairs.
template <int NW>
__device__ __forceinline__ int2 top_round(int (&cnt)[NW], const int (&lo)[NW],
                                          const int* col, int V, bool slot0,
                                          int lane, uint32_t band2,
                                          uint32_t wrapu, bool wrap) {
    uint32_t key = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        const int c = lane + 32 * w;
        if (c < V)
            key = max(key, (static_cast<uint32_t>(cnt[w]) << 8) |
                               (255u - static_cast<uint32_t>(c)));
    }
    key = __reduce_max_sync(kFull, key);
    const int bv = static_cast<int>(key >> 8);
    const int bi = 255 - static_cast<int>(key & 255u);
    // every count 0: torch's argmax takes slot 0, BIG where it is invalid
    const int bd = bv > 0 ? col[2 * bi] : (slot0 ? col[0] : kBig);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        if (wrap ? near<true>(bd, lo[w], band2, wrapu)
                 : near<false>(bd, lo[w], band2, wrapu))
            cnt[w] = 0;
    }
    return make_int2(bd, bv);
}

// the votes, each strand's top_k rounds and the union for a read of V
// compacted valid hits (V <= 32 * NW); lanes < top_k write the outputs
template <int NW>
__device__ __forceinline__ void vote_and_union(
    const int2* dp, int V, bool slot0, int band, int top_k, int lane,
    int32_t* __restrict__ cand_diag, int32_t* __restrict__ cand_votes,
    int8_t* __restrict__ strand_out, size_t o) {
    int lo_f[NW], lo_r[NW], cf[NW], cr[NW];
    int mnf = INT_MAX, mxf = INT_MIN, mnr = INT_MAX, mxr = INT_MIN;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
        const int c = lane + 32 * w;
        cf[w] = 0;
        cr[w] = 0;
        lo_f[w] = 0;
        lo_r[w] = 0;
        if (c < V) {
            const int2 d = dp[c];
            lo_f[w] = wrap_sub(d.x, band);
            lo_r[w] = wrap_sub(d.y, band);
            mnf = min(mnf, d.x);
            mxf = max(mxf, d.x);
            mnr = min(mnr, d.y);
            mxr = max(mxr, d.y);
        }
    }
    mnf = __reduce_min_sync(kFull, mnf);
    mxf = __reduce_max_sync(kFull, mxf);
    mnr = __reduce_min_sync(kFull, mnr);
    mxr = __reduce_max_sync(kFull, mxr);
    // a strand whose diagonals span 2^31 or more can hold a pair whose
    // int32 difference wraps to -2^31 (V == 0 gives a span of 1)
    const bool wrap =
        static_cast<uint32_t>(wrap_sub(mxf, mnf)) >= 0x80000000u ||
        static_cast<uint32_t>(wrap_sub(mxr, mnr)) >= 0x80000000u;
    const uint32_t band2 = 2u * static_cast<uint32_t>(band);
    const uint32_t wrapu = static_cast<uint32_t>(band) + 0x80000000u;
    if (wrap) {
        count_votes<NW, true>(dp, V, band2, wrapu, lo_f, lo_r, cf, cr);
    } else {
        count_votes<NW, false>(dp, V, band2, wrapu, lo_f, lo_r, cf, cr);
    }

    // each strand's rounds; lane s * top_k + t keeps round t of strand s
    const int* col = reinterpret_cast<const int*>(dp);
    int my_d = 0, my_v = 0;
    for (int t = 0; t < top_k; ++t) {
        const int2 f = top_round<NW>(cf, lo_f, col, V, slot0, lane, band2,
                                     wrapu, wrap);
        const int2 r = top_round<NW>(cr, lo_r, col + 1, V, slot0, lane,
                                     band2, wrapu, wrap);
        if (lane == t) {
            my_d = f.x;
            my_v = f.y;
        } else if (lane == top_k + t) {
            my_d = r.x;
            my_v = r.y;
        }
    }

    // the union: top_k rounds of (votes, lowest candidate) over 2K lanes
    bool live = lane < 2 * top_k;
    int od = 0, ov = 0, os = 0;
    for (int t = 0; t < top_k; ++t) {
        uint32_t key = live ? (static_cast<uint32_t>(my_v + 1) << 4) |
                                  (15u - static_cast<uint32_t>(lane))
                            : 0u;
        key = __reduce_max_sync(kFull, key);
        const int j = 15 - static_cast<int>(key & 15u);
        const int d = __shfl_sync(kFull, my_d, j);
        if (lane == j) live = false;
        if (lane == t) {
            od = d;
            ov = static_cast<int>(key >> 4) - 1;
            os = j >= top_k;
        }
    }
    if (lane < top_k) {
        cand_diag[o + lane] = od;
        cand_votes[o + lane] = ov;
        strand_out[o + lane] = static_cast<int8_t>(os);
    }
}

// NQ: hit slots a lane takes (s_max * hits <= 32 * NQ).  At NQ <= 2 ptxas
// keeps it at 32 registers unforced: 16 blocks of kMaxWarps, the SM's 64
// warps
template <int NQ>
__global__ void __launch_bounds__(kMaxWarps * 32)
seed_stage_kernel(const int8_t* __restrict__ codes, int B, int L,
                  const int32_t* __restrict__ read_len,
                  const int32_t* __restrict__ run_table, int D, int row_w,
                  const int32_t* __restrict__ seed_pos, int S_len,
                  const int32_t* __restrict__ bucket_lo, int k,
                  int density_bits, int bucket_bits, int steps, int s_max,
                  int hits, int top_k, int band, HashConsts hc,
                  int32_t* __restrict__ cand_diag,
                  int32_t* __restrict__ cand_votes,
                  int8_t* __restrict__ strand_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= B) return;  // the whole warp
    const int n = L - k + 1;
    const int slots = s_max * hits;
    const Layout lay = layout(L, n, s_max, slots);
    unsigned char* base = smem + static_cast<size_t>(warp) * lay.bytes;
    int8_t* cs = reinterpret_cast<int8_t*>(base + lay.codes);
    uint32_t* hs = reinterpret_cast<uint32_t*>(base + lay.hs);
    uint32_t* marks = reinterpret_cast<uint32_t*>(base + lay.marks);
    int4* seeds = reinterpret_cast<int4*>(base + lay.seeds);
    int2* dp = reinterpret_cast<int2*>(base + lay.dp);
    const int rl = read_len[row];

    // 1. the read's codes (4 bytes a load where rows are 4-byte aligned)
    const int8_t* src = codes + static_cast<size_t>(row) * L;
    if (((reinterpret_cast<uintptr_t>(codes) | static_cast<uintptr_t>(L)) &
         3u) == 0) {
        const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
        uint32_t* c4 = reinterpret_cast<uint32_t*>(cs);
        for (int i = lane; i < (L >> 2); i += 32) c4[i] = s4[i];
    } else {
        for (int i = lane; i < L; i += 32) cs[i] = src[i];
    }
    __syncwarp();

    // 2. hashes.  Lane i owns positions [i * seg, (i + 1) * seg): its
    // first window in k steps (rc as 3 sum B^t - sum c B^t), then rolls
    const int seg = hc.seg;
    const int p0 = lane * seg;
    uint32_t hf = 0, hr = 0;
    int last4 = p0 - 1;
    if (p0 < n) {
        uint32_t pk = 1;
        for (int t = 0; t < k; ++t) {
            const int8_t b = cs[p0 + t];
            const uint32_t c = code_of(b);
            hf = hf * kBase + c;
            hr += c * pk;
            pk *= kBase;
            if (b == 4) last4 = p0 + t;
        }
    }
    hr = hc.rc3 - hr;

    // roll over the lane's positions; a sampled one keeps its hash and a
    // bit in the lane's mark word (word w at marks[w * 32 + lane])
    const uint32_t dmask = (1u << density_bits) - 1u;
    const int cnt = min(p0 + seg, n) - p0;
    int total = 0;
    int p = p0;
    for (int w = 0; w * 32 < cnt; ++w) {
        const int jend = min(cnt - w * 32, 32);
        uint32_t m = 0, bit = 1;
        for (int j = 0; j < jend; ++j, ++p, bit <<= 1) {
            const uint32_t h = mix32(hf < hr ? hf : hr);
            if (last4 < p && (h & dmask) == 0u) {
                hs[p] = h;
                m |= bit;
            }
            // to p + 1 (the last roll reads cs[L] at most: in the layout):
            // hf B + in - out B^k, hr B^-1 + out B^-1 - in B^(k-1) + crc
            const int8_t ob = cs[p], ib = cs[p + k];
            const uint32_t out = code_of(ob), in = code_of(ib);
            hf = hf * kBase + in + out * hc.nbk;
            hr = hr * kBaseInv + hc.crc + out * kBaseInv + in * hc.nbk1;
            if (ib == 4) last4 = p + k;
        }
        marks[w * 32 + lane] = m;
        total += __popc(m);
    }

    // 3. the first s_max sampled positions: ranks by an exclusive scan of
    // the lanes' counts; each lane writes its own (position, hash)
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
    }
    const int count = min(__shfl_sync(kFull, incl, 31), s_max);
    int rank = incl - total;
    for (int w = 0; rank < s_max && w * 32 < cnt; ++w) {
        uint32_t m = marks[w * 32 + lane];
        while (m && rank < s_max) {
            const int ps = p0 + w * 32 + __ffs(m) - 1;
            m &= m - 1u;
            seeds[rank] = make_int4(ps, static_cast<int>(hs[ps]), 0, 0);
            ++rank;
        }
    }
    __syncwarp();

    // 4a. one lane a seed: its row and how many of its C hits are valid
    for (int r = lane; r < count; r += 32) {
        int4 sd = seeds[r];
        const uint32_t h = static_cast<uint32_t>(sd.y);
        const uint32_t b = bucket_bits ? h >> (32 - bucket_bits) : 0u;
        if (steps < 0) {
            const uint32_t disp = static_cast<uint32_t>(bucket_lo[b]);
            sd.z = static_cast<int>(mix32(h ^ (disp * kChdGold)) &
                                    static_cast<uint32_t>(D - 1));
            const int32_t* rw = run_table + static_cast<size_t>(sd.z) * row_w;
            sd.w = static_cast<uint32_t>(rw[0]) == h ? rw[1] : 0;
        } else {
            const int lo = bucket_lo[b], hi = bucket_lo[b + 1];
            int lo_s = lo, hi_s = hi;
            for (int t = 0; t < steps; ++t) {
                const int mid = wrap_add(lo_s, hi_s) >> 1;
                const uint32_t km = static_cast<uint32_t>(run_table[
                    static_cast<size_t>(clampi(mid, 0, D - 1)) * row_w]);
                if (km < h && lo_s < hi_s) {
                    lo_s = wrap_add(mid, 1);
                } else {
                    hi_s = max(mid, lo_s);
                }
            }
            const int32_t* rw = run_table +
                static_cast<size_t>(clampi(lo_s, 0, D - 1)) * row_w;
            sd.z = rw[1];
            sd.w = static_cast<uint32_t>(rw[0]) == h && lo_s < hi ? rw[2] : 0;
        }
        seeds[r] = sd;
    }
    __syncwarp();

    // 4b. slot i = seed * hits + hit, lane's slots lane + 32 q; the valid
    // hits' (forward, reverse) diagonals compacted in slot order
    const uint32_t lt = (1u << lane) - 1u;
    int V = 0;
    bool slot0 = false;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int i = q * 32 + lane;
        const int r = hc.hits_mul ? static_cast<int>(__umulhi(
            static_cast<uint32_t>(i), hc.hits_mul)) : i;
        const int c = i - r * hits;
        bool ok = false;
        int df = 0, dr = 0;
        if (i < slots && r < count) {
            const int4 sd = seeds[r];
            ok = c < sd.w;
            if (ok) {
                const int pos = steps < 0
                    ? run_table[static_cast<size_t>(sd.z) * row_w + 2 + c]
                    : seed_pos[clampi(wrap_add(sd.z, c), 0, S_len - 1)];
                df = wrap_sub(pos, sd.x);
                dr = wrap_sub(pos, wrap_sub(wrap_sub(rl, k), sd.x));
            }
        }
        const uint32_t vm = __ballot_sync(kFull, ok);
        if (q == 0) slot0 = vm & 1u;
        if (ok) dp[V + __popc(vm & lt)] = make_int2(df, dr);
        V += __popc(vm);
    }
    __syncwarp();

    // 5. the votes, top_k rounds and union, with a lane's hits in NW words
    const size_t o = static_cast<size_t>(row) * top_k;
    if (V <= 32) {
        vote_and_union<1>(dp, V, slot0, band, top_k, lane, cand_diag,
                          cand_votes, strand_out, o);
    } else if (NQ >= 2 && V <= 64) {
        vote_and_union<(NQ >= 2 ? 2 : 1)>(dp, V, slot0, band, top_k, lane,
                                          cand_diag, cand_votes, strand_out,
                                          o);
    } else if (NQ >= 4 && V <= 128) {
        vote_and_union<(NQ >= 4 ? 4 : 1)>(dp, V, slot0, band, top_k, lane,
                                          cand_diag, cand_votes, strand_out,
                                          o);
    } else {
        vote_and_union<NQ>(dp, V, slot0, band, top_k, lane, cand_diag,
                           cand_votes, strand_out, o);
    }
}


}  // namespace

// K3: the seed stage of B reads (codes int8 [B, L]) against the seed
// tables.  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int seed_stage_launch(
    const void* codes, int B, int L, const void* read_len,
    const void* run_table, int D, int row_w, const void* seed_pos, int S_len,
    const void* bucket_lo, int k, int density_bits, int bucket_bits,
    int steps, int s_max, int hits, int top_k, int band, void* cand_diag,
    void* cand_votes, void* strand, void* stream) {
    // the wrapper (ops/seed.py) holds bucket_lo's length to bucket_bits
    if (B <= 0) return 0;
    const int n = L - k + 1;
    const int slots = s_max * hits;
    if (k < 1 || n < 1 || s_max < 1 || hits < 1 || slots > kMaxSlots ||
        top_k < 1 || top_k > kMaxTopK || band < 0 || density_bits < 0 ||
        density_bits > 31 || bucket_bits < 0 || bucket_bits > 32 || D < 1 ||
        (steps < 0 && row_w != 2 + hits) || (steps >= 0 && row_w < 3))
        return static_cast<int>(cudaErrorInvalidValue);
    // the wrapper's widest (L 8192, k 1, s_max * hits 256 with hits 1)
    // needs 48,144 bytes a warp: one warp a block fits the default
    const Layout lay = layout(L, n, s_max, slots);
    if (lay.bytes > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
    int warps = kMaxWarps;
    while (warps > 1 && warps * lay.bytes > kSmemCap) --warps;
    const dim3 grid((B + warps - 1) / warps);
    const int smem = warps * lay.bytes;

    HashConsts hc;
    hc.seg = (L + 31) / 32;
    hc.nbk = 0u - pow32(kBase, k);
    hc.nbk1 = 0u - pow32(kBase, k - 1);
    hc.crc = 3u * pow32(kBase, k - 1) - 3u * kBaseInv;
    uint32_t sum = 0;
    for (int i = 0; i < k; ++i) sum += pow32(kBase, i);
    hc.rc3 = 3u * sum;
    // exact for i * hits < 2^32 (i < 256, hits <= 256); hits 1 is i itself
    hc.hits_mul = hits == 1 ? 0u
        : static_cast<uint32_t>(((1ull << 32) + hits - 1) / hits);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nq = (slots + 31) / 32;
#define PANTAX_LAUNCH_K3(NQ)                                                  \
    do {                                                                      \
        seed_stage_kernel<NQ><<<grid, warps * 32, smem, s>>>(                 \
            static_cast<const int8_t*>(codes), B, L,                          \
            static_cast<const int32_t*>(read_len),                            \
            static_cast<const int32_t*>(run_table), D, row_w,                 \
            static_cast<const int32_t*>(seed_pos), S_len,                     \
            static_cast<const int32_t*>(bucket_lo), k, density_bits,          \
            bucket_bits, steps, s_max, hits, top_k, band, hc,                 \
            static_cast<int32_t*>(cand_diag),                                 \
            static_cast<int32_t*>(cand_votes), static_cast<int8_t*>(strand)); \
    } while (0)
    if (nq <= 1) {
        PANTAX_LAUNCH_K3(1);
    } else if (nq <= 2) {
        PANTAX_LAUNCH_K3(2);
    } else if (nq <= 4) {
        PANTAX_LAUNCH_K3(4);
    } else {
        PANTAX_LAUNCH_K3(8);
    }
#undef PANTAX_LAUNCH_K3
    return static_cast<int>(cudaGetLastError());
}
