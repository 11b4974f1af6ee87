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
// a displacement and a 24-byte CHD row (~11 MB of codes and ~30 MB of
// gathers at B = 65536, L = 160, 16 seeds), and it does ~15 integer
// instructions per k-mer position and a compare-add for every pair of
// valid hits on each strand (~2 x 48^2 a read): instruction issue bounds
// it, ahead of the bytes.  The design is the simple one, one warp per read:
// - the read's codes in shared memory; each lane rolls the forward and
//   reverse hashes over its own run of ceil(n / 32) positions (the reverse
//   hash through the base's inverse mod 2^32) with the last N code's
//   position for validity, and marks the sampled positions in shared
//   memory; a ballot and popc over the marks in position order ranks them,
//   and the first s_max recompute their hash from scratch;
// - the S * C lookups, lane i taking hit slots i, i + 32, ...: four lanes
//   repeat one seed's lookup (their loads coalesce) and keep their own
//   hit; the diagonals go to shared memory and the validity to a ballot
//   mask, so the vote loops over valid hits only;
// - each lane counts its own slots' neighbours; a shuffle argmax (value,
//   then lowest index) takes each top_k round; lane 0 runs the union.
// The plain version's [B, S*C, S*C] pairwise tensor and its cumsum and
// scatters over [B, n] are gone; nothing of the stage leaves the SM but
// the three outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kBase = 0x9E3779B1u;     // the k-mer hash base
constexpr uint32_t kChdGold = 0x9E3779B9u;  // the CHD displacement salt
constexpr int kBig = 1 << 30;               // the diagonal of an invalid hit
constexpr int kMaxSlots = 256;              // s_max * hits
constexpr int kMaxTopK = 8;
constexpr int kMaxWarps = 4;                // reads per block
constexpr int kSmemCap = 48 * 1024;         // dynamic shared memory a block
constexpr unsigned kFull = 0xFFFFFFFFu;

// b * inverse32(b) == 1 mod 2^32 for odd b (Newton: 3, 6, 12, 24, 48 bits)
constexpr uint32_t inverse32(uint32_t b) {
    uint32_t x = b;
    for (int i = 0; i < 4; ++i) x *= 2u - b * x;
    return x;
}
constexpr uint32_t kBaseInv = inverse32(kBase);
static_assert(kBase * kBaseInv == 1u, "the hash base must be odd");

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

// torch's (a - b).abs() <= band in int32, wraps included
__device__ __forceinline__ bool within_band(int a, int b, int band) {
    const uint32_t x = static_cast<uint32_t>(a) - static_cast<uint32_t>(b);
    const uint32_t ax = static_cast<int32_t>(x) < 0 ? 0u - x : x;
    return static_cast<int32_t>(ax) <= band;
}

// the forward and reverse hashes of the k-mer at p, from scratch, and the
// position of its last N code (p - 1 when it has none)
__device__ __forceinline__ void hash_at(const int8_t* cs, int p, int k,
                                        uint32_t& hf, uint32_t& hr,
                                        int& last4) {
    hf = 0;
    hr = 0;
    last4 = p - 1;
    uint32_t pw = 1;
    for (int i = 0; i < k; ++i) {
        const int8_t b = cs[p + i];
        const uint32_t c = code_of(b);
        hf = hf * kBase + c;
        hr += (3u - c) * pw;
        pw *= kBase;
        if (b == 4) last4 = p + i;
    }
}

// one warp's shared memory, in bytes from its base
struct Layout {
    int codes, samp, sel_pos, sel_hash, d_fwd, d_rev, cand, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int L, int n, int s_max,
                                         int slots) {
    Layout o;
    int off = 0;
    o.codes = off;    off += align16(L);
    o.samp = off;     off += align16(n);
    o.sel_pos = off;  off += align16(4 * s_max);
    o.sel_hash = off; off += align16(4 * s_max);
    o.d_fwd = off;    off += align16(4 * slots);
    o.d_rev = off;    off += align16(4 * slots);
    o.cand = off;     off += align16(4 * 4 * kMaxTopK);
    o.bytes = off;
    return o;
}

// NQ: hit slots a lane holds (s_max * hits <= 32 * NQ)
template <int NQ>
__global__ void __launch_bounds__(kMaxWarps * 32)
seed_stage_kernel(const int8_t* __restrict__ codes, int B, int L,
                  const int32_t* __restrict__ read_len,
                  const int32_t* __restrict__ run_table, int D, int row_w,
                  const int32_t* __restrict__ seed_pos, int S_len,
                  const int32_t* __restrict__ bucket_lo, int k,
                  int density_bits, int bucket_bits, int steps, int s_max,
                  int hits, int top_k, int band,
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
    uint8_t* samp = base + lay.samp;
    int32_t* sel_pos = reinterpret_cast<int32_t*>(base + lay.sel_pos);
    uint32_t* sel_hash = reinterpret_cast<uint32_t*>(base + lay.sel_hash);
    int32_t* d_strand[2] = {reinterpret_cast<int32_t*>(base + lay.d_fwd),
                            reinterpret_cast<int32_t*>(base + lay.d_rev)};
    int32_t* cand = reinterpret_cast<int32_t*>(base + lay.cand);

    // 1. the read's codes
    const int8_t* src = codes + static_cast<size_t>(row) * L;
    for (int i = lane; i < L; i += 32) cs[i] = src[i];
    __syncwarp();

    // 2. the sampled positions: lane owns [p, p_end) and rolls its hashes
    const uint32_t dmask = (1u << density_bits) - 1u;
    uint32_t bk1 = 1;  // B^(k-1)
    for (int i = 1; i < k; ++i) bk1 *= kBase;
    const int seg = (n + 31) >> 5;
    int p = lane * seg;
    const int p_end = min(p + seg, n);
    if (p < p_end) {
        uint32_t hf, hr;
        int last4;
        hash_at(cs, p, k, hf, hr, last4);
        for (;;) {
            const uint32_t h = mix32(hf < hr ? hf : hr);
            samp[p] = last4 < p && (h & dmask) == 0u;
            if (++p >= p_end) break;
            const uint32_t out = code_of(cs[p - 1]);
            const int8_t in_b = cs[p + k - 1];
            const uint32_t in = code_of(in_b);
            hf = (hf - out * bk1) * kBase + in;
            hr = (hr - (3u - out)) * kBaseInv + (3u - in) * bk1;
            if (in_b == 4) last4 = p + k - 1;
        }
    }
    __syncwarp();

    // 3. the first s_max sampled positions, in position order
    int count = 0;
    for (int b0 = 0; b0 < n && count < s_max; b0 += 32) {
        const int q = b0 + lane;
        const bool s = q < n && samp[q];
        const unsigned bal = __ballot_sync(kFull, s);
        const int rank = count + __popc(bal & ((1u << lane) - 1u));
        if (s && rank < s_max) {
            uint32_t hf, hr;
            int last4;
            hash_at(cs, q, k, hf, hr, last4);
            sel_pos[rank] = q;
            sel_hash[rank] = mix32(hf < hr ? hf : hr);
        }
        count += __popc(bal);
    }
    count = min(count, s_max);
    __syncwarp();

    // 4. the lookups: slot i = seed * hits + hit, lane's slots lane + 32 q
    const int rl = read_len[row];
    unsigned vmask[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const int i = q * 32 + lane;
        bool ok = false;
        if (i < slots) {
            const int r = i / hits;
            const int c = i - r * hits;
            int df = kBig, dr = kBig;
            if (r < count) {
                const uint32_t h = sel_hash[r];
                const int ps = sel_pos[r];
                const uint32_t b = bucket_bits ? h >> (32 - bucket_bits) : 0u;
                int pos;
                if (steps < 0) {
                    const uint32_t disp = static_cast<uint32_t>(bucket_lo[b]);
                    const uint32_t slot = mix32(h ^ (disp * kChdGold)) &
                                          static_cast<uint32_t>(D - 1);
                    const int32_t* rw =
                        run_table + static_cast<size_t>(slot) * row_w;
                    ok = static_cast<uint32_t>(rw[0]) == h && c < rw[1];
                    pos = rw[2 + c];
                } else {
                    const int lo = bucket_lo[b], hi = bucket_lo[b + 1];
                    int lo_s = lo, hi_s = hi;
                    for (int t = 0; t < steps; ++t) {
                        const int mid = (lo_s + hi_s) >> 1;
                        const uint32_t km = static_cast<uint32_t>(run_table[
                            static_cast<size_t>(clampi(mid, 0, D - 1)) * row_w]);
                        if (km < h && lo_s < hi_s) {
                            lo_s = mid + 1;
                        } else {
                            hi_s = max(mid, lo_s);
                        }
                    }
                    const int32_t* rw = run_table +
                        static_cast<size_t>(clampi(lo_s, 0, D - 1)) * row_w;
                    ok = static_cast<uint32_t>(rw[0]) == h && lo_s < hi &&
                         c < rw[2];
                    pos = seed_pos[clampi(rw[1] + c, 0, S_len - 1)];
                }
                if (ok) {
                    const uint32_t up = static_cast<uint32_t>(pos);
                    const uint32_t ups = static_cast<uint32_t>(ps);
                    df = static_cast<int>(up - ups);
                    dr = static_cast<int>(
                        up - (static_cast<uint32_t>(rl) -
                              static_cast<uint32_t>(k) - ups));
                }
            }
            d_strand[0][i] = df;
            d_strand[1][i] = dr;
        }
        vmask[q] = __ballot_sync(kFull, ok);
    }
    __syncwarp();

    // 5. each strand's votes and top_k rounds
    for (int sidx = 0; sidx < 2; ++sidx) {
        const int32_t* d = d_strand[sidx];
        int mine[NQ], cnt[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const int i = q * 32 + lane;
            mine[q] = i < slots ? d[i] : kBig;
            cnt[q] = 0;
        }
#pragma unroll
        for (int w = 0; w < NQ; ++w) {
            unsigned m = vmask[w];  // the same on every lane
            while (m) {
                const int dj = d[w * 32 + __ffs(m) - 1];
                m &= m - 1u;
#pragma unroll
                for (int q = 0; q < NQ; ++q) cnt[q] += within_band(mine[q], dj, band);
            }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            if (!((vmask[q] >> lane) & 1u)) cnt[q] = 0;
        }
        for (int t = 0; t < top_k; ++t) {
            int bv = -1, bi = 0;
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                if (q * 32 + lane < slots && cnt[q] > bv) {
                    bv = cnt[q];
                    bi = q * 32 + lane;
                }
            }
#pragma unroll
            for (int off = 16; off; off >>= 1) {
                const int ov = __shfl_xor_sync(kFull, bv, off);
                const int oi = __shfl_xor_sync(kFull, bi, off);
                if (ov > bv || (ov == bv && oi < bi)) {
                    bv = ov;
                    bi = oi;
                }
            }
            const int bd = d[bi];
            if (lane == 0) {
                cand[sidx * top_k + t] = bd;               // diag_u
                cand[2 * top_k + sidx * top_k + t] = bv;   // vote_u
            }
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                if (within_band(mine[q], bd, band)) cnt[q] = 0;
            }
        }
    }

    // 6. the strand union (ties favour the forward slots)
    if (lane == 0) {
        int32_t* vote_u = cand + 2 * top_k;
        const size_t o = static_cast<size_t>(row) * top_k;
        for (int t = 0; t < top_k; ++t) {
            int b = 0, bv = vote_u[0];
            for (int j = 1; j < 2 * top_k; ++j) {
                if (vote_u[j] > bv) {
                    bv = vote_u[j];
                    b = j;
                }
            }
            cand_diag[o + t] = cand[b];
            cand_votes[o + t] = bv;
            strand_out[o + t] = static_cast<int8_t>(b >= top_k);
            vote_u[b] = -1;
        }
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
    const Layout lay = layout(L, n, s_max, slots);
    if (lay.bytes > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
    int warps = kMaxWarps;
    while (warps > 1 && warps * lay.bytes > kSmemCap) --warps;
    const dim3 grid((B + warps - 1) / warps);
    const int smem = warps * lay.bytes;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nq = (slots + 31) / 32;
#define PANTAX_LAUNCH_K3(NQ)                                                  \
    seed_stage_kernel<NQ><<<grid, warps * 32, smem, s>>>(                     \
        static_cast<const int8_t*>(codes), B, L,                              \
        static_cast<const int32_t*>(read_len),                                \
        static_cast<const int32_t*>(run_table), D, row_w,                     \
        static_cast<const int32_t*>(seed_pos), S_len,                         \
        static_cast<const int32_t*>(bucket_lo), k, density_bits,              \
        bucket_bits, steps, s_max, hits, top_k, band,                         \
        static_cast<int32_t*>(cand_diag), static_cast<int32_t*>(cand_votes),  \
        static_cast<int8_t*>(strand))
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
