// Banded glocal DP extension for Hopper (sm_90a): K1 and K2.
//
// Replaces the two Pallas TPU kernels of pantax_tpu/ops/extend_pallas.py:
// - K1, :171 banded_extend_pallas (body _dp_kernel, :47): window fetch from
//   the index text fused with the DP; the JAX main path computes the same
//   with XLA as aligner._extract_windows + aligner._banded_extend;
// - K2, :316 banded_extend_pallas_dponly (body _dp_only_kernel, :238): the
//   same DP over windows already extracted into [N, W], which is exactly
//   aligner._banded_extend (the long-read rescue pass, _extend_batch).
// Both kernels run one DP, dp_candidate: the fast DP (fast_dp, below) where
// its 16-byte loads are possible, and the per-byte DP banded_dp elsewhere.
// K1 hands it the index text and w0[n]; K2 hands it the windows buffer
// [N, W] as a text of N * W bytes in which row n starts at n * W.
//
// For each candidate n it aligns the whole read reads[n, :read_len[n]]
// against its window (K1: text[w0[n] : w0[n] + Lr + 2*pad]; K2: the row
// windows[n]) with a free start and end in the window, over WB = 2*pad band
// rows.  The DP state is one packed int32 cell per band row,
//     ((score + bias) << sh_score) | (matches << 5) | start_band,
// so a plain integer max compares score, then matches, then start band.
// Outputs (score, start_off, end_off, matches), end_off taken from the
// first band row that reaches the maximum.  (sh_score, bias) come from the
// caller, from the DP's own width, which may be less than the row width Lr.
//
// What bounds the DP: per candidate it reads Lr + WB - 1 window bytes and
// Lr read bytes (about 330 bytes at Lr = 160, pad = 4, ~43 MB at N =
// 131072) and runs Lr * WB band cells of about 5 instructions each (~0.8
// G), so instruction issue bounds it, ahead of its DRAM traffic.  On Hopper
// the integer ALU takes a warp instruction every other clock, as does the
// FMA pipe (IMAD), so the design keeps the ALU's share of each cell small.
// One thread owns one candidate and keeps all DP state in registers.  The
// left-gap prefix max of the TPU kernel (log2(WB) shift steps) is the
// sequential recurrence
//     m[b] = max(v[b], m[b-1] + gap_p),
// which is equal to it in integers (no NEG fill value ever wins).  The TPU
// kernel's 1024-aligned DMA slices, lane rolls and static band shifts exist
// because Mosaic cannot slice rows dynamically; none of them is needed.
//
// The fast DP spends its instructions on the band cells and nothing else:
// - Vector loads.  The read row comes 16 bytes at a time (uint4; rows
//   16-byte aligned and Lr % 16 == 0), the window as 16-byte-aligned
//   chunks of the buffer from (buffer + w) & ~15, shifted into window order
//   in registers (a word select and a funnel shift per word), so any row
//   offset works: K2's rows of W bytes start anywhere in a chunk.  Each
//   chunk's loads are issued one chunk (16 steps) before they are used, so
//   the per-step byte loads of the first design, and their stalls, are
//   gone.
// - N codes remapped once per base, as the bytes are loaded (four a
//   word), into forms that make the match test one byte-table lookup:
//   one PRMT a cell gives 1 where the bases match and 0 elsewhere, N codes
//   on either side included, and an IMAD (on the FMA pipe, beside the ALU
//   that takes the maxes and PRMTs) scales it into the diagonal move.
//   The first design spent three compares a cell and the logic between
//   them on the ALU.
// - The step loop unrolled by 16, the load width: each step takes its
//   read shift and its entering window selector out of registers at an index
//   known at compile time, and the sliding window and the band rotate by
//   renaming registers.  The unrolled body also lets the scheduler start a
//   step's low band rows while the previous step's left-gap chain runs.
//   Step 0 is the first chunk's first step with a gap no up or left move
//   survives (kFar), which reduces it to the first row's initialisation.
//   The ragged last chunk runs the same body and stops after read_len
//   steps, leaving the state as the first design's frozen rows did.
// - The per-byte path, banded_dp, is the first design (a byte load a step
//   from the window and the read, three compares a cell).  It is exact for
//   every input and runs where the fast DP cannot: K1's windows that reach
//   outside the text (w0 near either end, where the plain version clamps
//   positions; the aligner clips w0 so that real windows never do), every
//   K2 row where the read rows cannot be loaded 16 bytes at a time (a
//   width that is no multiple of 16: the rescue pass of a chunk size of
//   that kind), and any candidate with a negative code among the bytes
//   loaded.  A chunk past the end of the buffer is not loaded (the fast
//   DP uses none: it loads the buffer's last whole chunk again), so a K2
//   buffer's last rows stay on the fast DP where the buffer ends on a
//   16-byte boundary, as the rescue pass's windows do; a row whose used
//   bytes share a chunk with bytes outside the buffer (the first row of a
//   view that starts off a 16-byte boundary, the last of one that ends
//   off it) takes the per-byte path.  One thread on the per-byte path
//   holds its warp for a whole per-byte DP: at the rescue shape, the
//   first design's whole kernel time.
//
// What bounds K2 at the rescue pass's shape (N = 16384 chunks, Lr = 512,
// pad 8, W = 528): per row it reads 528 window bytes and 512 read bytes
// (17 MB in all, ~5 us of HBM time), so not bytes: integer issue, as K1,
// whose loop it runs (98.7 SASS instructions a step at pad 8, 80
// registers).  16384 threads are 128 blocks of 128, one block on each of
// 128 SMs: one warp per warp scheduler, half the warps K1 has at the
// seeded pass's 32768 candidates.  On an H100 80GB HBM3 at 700 W
// (PERF.md section 6) it takes 0.0475 ms there, 2.09x the first design
// and 32% of the issue bound; its time is flat from 2048 to 16384 rows
// and 1.63x at 32768, so a lone warp a scheduler leaves latency (the
// left-gap chain) exposed.  Two lanes a
// candidate, each half the band with two shuffles a step, put two warps
// on each scheduler but lost 1.34x: the shuffle sits on the chain and
// each lane repeats the loads, selectors and loop.  What would move it:
// more rows a launch (the caller's batch), or fewer ALU instructions a
// cell, as for K1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShMatch = 5;
constexpr int kNeg = -1000000;
constexpr int kThreads = 128;

// K1's window: the index text from base on, positions clamped into the
// text as the plain version does (the aligner clips w0 so that real
// windows never need it).
struct TextWindow {
    const int8_t* __restrict__ text;
    long long T;
    long long base;
    __device__ __forceinline__ int operator()(int j) const {
        long long p = base + j;
        p = p < 0 ? 0 : (p >= T ? T - 1 : p);
        return static_cast<int>(text[p]);
    }
};

// K2's window: one row of windows[N, W] (the wrapper checks that W covers
// every column the DP reads, Lr + WB - 1).
struct RowWindow {
    const int8_t* __restrict__ row;
    __device__ __forceinline__ int operator()(int j) const {
        return static_cast<int>(row[j]);
    }
};

// The banded DP of one candidate, written to slot n of the four outputs.
template <int WB, class Window>
__device__ __forceinline__ void banded_dp(
        const Window& window, const int8_t* __restrict__ read, int len, int Lr,
        int match, int mismatch, int gap, int sh_score, int bias, int n,
        int32_t* __restrict__ score, int32_t* __restrict__ start_off,
        int32_t* __restrict__ end_off, int32_t* __restrict__ matches) {
    const int d_score = 1 << sh_score;
    const int gap_p = gap * d_score;
    const int mis_d = mismatch * d_score;
    const int ok_d = match * d_score + (1 << kShMatch);

    int win[WB];  // window bases of rows i .. i + WB - 1
#pragma unroll
    for (int b = 0; b < WB; ++b) win[b] = window(b);

    int cell[WB];
    int x = read[0];
#pragma unroll
    for (int b = 0; b < WB; ++b) {
        const bool ok = (win[b] == x) & (x < 4) & (win[b] < 4);
        cell[b] = (bias << sh_score) + b + (ok ? ok_d : mis_d);
    }

    // rows at and past read_len leave the state frozen: stop there
    const int steps = len < Lr ? len : Lr;
    for (int i = 1; i < steps; ++i) {
#pragma unroll
        for (int b = 0; b < WB - 1; ++b) win[b] = win[b + 1];
        win[WB - 1] = window(i + WB - 1);
        x = read[i];
        int v[WB];
#pragma unroll
        for (int b = 0; b < WB; ++b) {
            const bool ok = (win[b] == x) & (x < 4) & (win[b] < 4);
            v[b] = cell[b] + (ok ? ok_d : mis_d);            // diagonal
            if (b + 1 < WB) v[b] = max(v[b], cell[b + 1] + gap_p);  // up
        }
#pragma unroll
        for (int b = 1; b < WB; ++b) v[b] = max(v[b], v[b - 1] + gap_p);  // left
#pragma unroll
        for (int b = 0; b < WB; ++b) cell[b] = v[b];
    }

    int best = kNeg;
    int b_best = 0;
    if (len >= 1) {
        best = cell[0];
#pragma unroll
        for (int b = 1; b < WB; ++b) {
            if (cell[b] > best) {  // strict: the first band row wins ties
                best = cell[b];
                b_best = b;
            }
        }
    }
    // >> on a negative int is arithmetic in nvcc, as in XLA and torch
    score[n] = (best >> sh_score) - bias;
    matches[n] = (best >> kShMatch) & ((1 << (sh_score - kShMatch)) - 1);
    start_off[n] = best & ((1 << kShMatch) - 1);
    end_off[n] = (len - 1) + b_best + 1;
}

// The fast DP.  kChunk bytes per vector load, and DP steps per unrolled
// chunk.
constexpr int kChunk = 16;
// step 0's gap: the packed cells are positive (the bias) and below 2^31,
// so with it no up or left move wins
constexpr int kFar = -(1 << 30);

// The match test is a byte-table lookup.  A window byte w becomes the
// PRMT selector 0x40 | w (0x44 | (w & 3) for an N code), a read byte x the
// shift 8x (32 + 8 (x & 3) for an N code), and per step t = 1 << 8x is the
// table: prmt(t, 0, window byte) is 1 where the window base equals
// x and 0 elsewhere (an N shift leaves t = 0; an N selector reads the zero
// word).  N codes are the non-negative codes >= 4; a negative code (a base
// to the plain version's signed x < 4) fits neither form, so a candidate
// with one anywhere in its bytes runs banded_dp instead.

// The bytes of w that are N codes: the top bit of each byte set where its
// bits 2..6 are not all zero and the byte is not negative.
__device__ __forceinline__ unsigned n_bytes(unsigned w) {
    return ((w & 0x7C7C7C7Cu) + 0x7F7F7F7Fu) & ~w & 0x80808080u;
}

__device__ __forceinline__ uint4 window_selectors(uint4 v) {
    auto f = [](unsigned w) {
        return (w & 0x03030303u) | (n_bytes(w) >> 5) | 0x40404040u;
    };
    return make_uint4(f(v.x), f(v.y), f(v.z), f(v.w));
}

__device__ __forceinline__ uint4 read_shifts(uint4 v) {
    auto f = [](unsigned w) {
        return ((w & 0x03030303u) | (n_bytes(w) >> 5)) << 3;
    };
    return make_uint4(f(v.x), f(v.y), f(v.z), f(v.w));
}

__device__ __forceinline__ unsigned or_words(uint4 v) {
    return v.x | v.y | v.z | v.w;
}

// PRMT as the hardware does it.  __byte_perm masks every nibble of a
// selector held in a register to its low 3 bits first (an ALU instruction
// per window byte); the selectors here never set bit 3 (sign replication).
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned s) {
    unsigned r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
    return r;
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int k) {
    return k < 4 ? v.x : (k < 8 ? v.y : (k < 12 ? v.z : v.w));
}

// Byte k (0..15, known at compile time) of v, zero-extended.
__device__ __forceinline__ unsigned byte_of(const uint4& v, int k) {
    return __byte_perm(word_of(v, k), 0u, 0x4440u | (k & 3));
}

// Window byte k (0..15, known at compile time) of v as a selector whose
// other three nibbles pick byte 4 (the table's zero word).
__device__ __forceinline__ unsigned selector_of(const uint4& v, int k) {
    return __byte_perm(word_of(v, k), 0x44u, 0x0040u | (k & 3));
}

// Bytes [a, a + 16) of the 32 bytes lo:hi, where a = 4 * q + r8 / 8.
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi,
                                         int q, int r8) {
    const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    unsigned s[5];  // words q .. q + 4
#pragma unroll
    for (int j = 0; j < 5; ++j) {
        const unsigned t0 = (q & 1) ? w[j + 1] : w[j];
        const unsigned t1 = (q & 1) ? w[j + 3] : w[j + 2];
        s[j] = (q & 2) ? t1 : t0;
    }
    return make_uint4(__funnelshift_r(s[0], s[1], r8),
                      __funnelshift_r(s[1], s[2], r8),
                      __funnelshift_r(s[2], s[3], r8),
                      __funnelshift_r(s[3], s[4], r8));
}

// DP steps 16c .. 16c + n - 1 (n = 16 unless PARTIAL) of one candidate:
// lo:hi hold its window selectors 16c .. 16c + 31 and rd its read shifts
// 16c .. 16c + 15; win[1 .. WB-1] enter holding window selectors
// 16c .. 16c + WB - 2.  g0 is the gap of step 16c (kFar at step 0).
template <int WB, bool PARTIAL>
__device__ __forceinline__ void dp_chunk(
        const uint4& lo, const uint4& hi, const uint4& rd,
        unsigned (&win)[WB], int (&cell)[WB], int g0, int gap_p,
        int ok_gain, int mis_d, int n) {
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
        if (PARTIAL && s >= n) break;  // rows past read_len: state frozen
#pragma unroll
        for (int b = 0; b < WB - 1; ++b) win[b] = win[b + 1];
        const int p = s + WB - 1;  // the window byte entering the band
        win[WB - 1] =
            p < kChunk ? selector_of(lo, p) : selector_of(hi, p - kChunk);
        const unsigned t = __funnelshift_lc(0u, 1u, byte_of(rd, s));
        const int g = s == 0 ? g0 : gap_p;
        int v[WB];
#pragma unroll
        for (int b = 0; b < WB; ++b) {
            const int e = static_cast<int>(prmt(t, 0u, win[b]));
            v[b] = e * ok_gain + cell[b] + mis_d;                      // diagonal
            if (b + 1 < WB) v[b] = max(v[b], cell[b + 1] + g);         // up
        }
#pragma unroll
        for (int b = 1; b < WB; ++b) v[b] = max(v[b], v[b - 1] + g);  // left
#pragma unroll
        for (int b = 0; b < WB; ++b) cell[b] = v[b];
    }
}

// The DP of one candidate whose window starts at byte a of the 16-byte
// chunk tw[0] and whose read row is rr (steps >= 1); the outputs of
// banded_dp.  It loads the chunks tw[min(k, kin)] for k = 0 .. nc + 1 (nc =
// ceil(steps / 16)): kin is the last chunk that lies in the buffer, at or
// past the last the DP uses.  Returns false, having written nothing, where
// a byte it loaded is a negative code.
template <int WB>
__device__ __forceinline__ bool fast_dp(
        const uint4* __restrict__ tw, int kin, int a,
        const uint4* __restrict__ rr, int len, int steps, int match,
        int mismatch, int gap, int sh_score, int bias, int n,
        int32_t* __restrict__ score, int32_t* __restrict__ start_off,
        int32_t* __restrict__ end_off, int32_t* __restrict__ matches) {
    const int d_score = 1 << sh_score;
    const int gap_p = gap * d_score;
    const int mis_d = mismatch * d_score;
    const int ok_gain = (match - mismatch) * d_score + (1 << kShMatch);
    const int q = a >> 2, r8 = (a & 3) * 8;
    const int nc = (steps + kChunk - 1) / kChunk;
    const int nfull = steps / kChunk;

    // lo:hi are the window's chunks c and c + 1, t2 the buffer chunk c + 2;
    // seen gathers every byte loaded, for the negative-code test
    const uint4 t0 = __ldg(tw), t1_raw = __ldg(tw + min(1, kin)),
                t2_raw = __ldg(tw + min(2, kin));
    const uint4 rd_raw = __ldg(rr);
    unsigned seen = or_words(t0) | or_words(t1_raw) | or_words(t2_raw) |
                    or_words(rd_raw);
    const uint4 t1 = window_selectors(t1_raw);
    uint4 t2 = window_selectors(t2_raw);
    uint4 lo = realign(window_selectors(t0), t1, q, r8);
    uint4 hi = realign(t1, t2, q, r8);
    uint4 rd = read_shifts(rd_raw);

    unsigned win[WB];
    int cell[WB];
    win[0] = 0;
#pragma unroll
    for (int b = 0; b < WB - 1; ++b) win[b + 1] = selector_of(lo, b);
#pragma unroll
    for (int b = 0; b < WB; ++b) cell[b] = (bias << sh_score) + b;

    int g0 = kFar;
    for (int c = 0; c < nfull; ++c) {
        // chunk c + 1's loads, one chunk ahead of their use
        uint4 t_next = make_uint4(0u, 0u, 0u, 0u), rd_next = t_next;
        if (c + 2 <= nc) t_next = __ldg(tw + min(c + 3, kin));
        if (c + 1 < nc) rd_next = __ldg(rr + c + 1);
        dp_chunk<WB, false>(lo, hi, rd, win, cell, g0, gap_p, ok_gain,
                            mis_d, kChunk);
        g0 = gap_p;
        seen |= or_words(t_next) | or_words(rd_next);
        t_next = window_selectors(t_next);
        lo = hi;
        hi = realign(t2, t_next, q, r8);
        t2 = t_next;
        rd = read_shifts(rd_next);
    }
    if (steps > nfull * kChunk)
        dp_chunk<WB, true>(lo, hi, rd, win, cell, g0, gap_p, ok_gain, mis_d,
                           steps - nfull * kChunk);
    if (seen & 0x80808080u) return false;

    int best = cell[0];
    int b_best = 0;
#pragma unroll
    for (int b = 1; b < WB; ++b) {
        if (cell[b] > best) {  // strict: the first band row wins ties
            best = cell[b];
            b_best = b;
        }
    }
    score[n] = (best >> sh_score) - bias;
    matches[n] = (best >> kShMatch) & ((1 << (sh_score - kShMatch)) - 1);
    start_off[n] = best & ((1 << kShMatch) - 1);
    end_off[n] = (len - 1) + b_best + 1;
    return true;
}

// The DP of one candidate: its window starts at byte w of the buffer
// text[0, T) (K1: the index text at w0[n]; K2: the windows [N, W] read as
// one text of N * W bytes, row n at n * W) and its read row is read.  The
// fast DP runs where the read row can be loaded 16 bytes at a time
// (vec_reads: rows 16-byte aligned, Lr % 16 == 0), the 16-byte chunks that
// hold the bytes the DP uses lie in the buffer and no byte loaded is a
// negative code; anywhere else banded_dp runs over ``window`` (K1: the
// clamped text; K2: the row), the per-byte path.
template <int WB, class Window>
__device__ __forceinline__ void dp_candidate(
        const int8_t* __restrict__ text, long long T, long long w,
        const Window& window, const int8_t* __restrict__ read, bool vec_reads,
        int len, int Lr, int match, int mismatch, int gap, int sh_score,
        int bias, int n, int32_t* __restrict__ score,
        int32_t* __restrict__ start_off, int32_t* __restrict__ end_off,
        int32_t* __restrict__ matches) {
    const int steps = len < Lr ? len : Lr;
    // the window's first byte sits at byte a of the 16-byte-aligned chunk
    // at buffer position `first`; chunk k of the fast DP (k = 0 .. nc + 1)
    // starts at first + 16 k.  It uses chunks 0 .. (a + steps + WB - 2) / 16
    // and loads the rest, up to 29 bytes past the window's last used byte
    // (in K2 the next row's, whose negative codes send this candidate to
    // the per-byte path too); where such a chunk would pass the buffer's
    // end (a K2 buffer's last rows) it loads chunk kin, the buffer's last
    // whole one, again.
    const int a = static_cast<int>(
        (reinterpret_cast<uintptr_t>(text) + static_cast<uintptr_t>(w)) & 15);
    const long long first = w - a;
    const int nc = (steps + kChunk - 1) / kChunk;
    const long long kin = first >= 0 ? (T - first) / kChunk - 1 : -1;
    if (!(vec_reads && steps >= 1 &&
          (a + steps + WB - 2) / kChunk <= kin &&
          fast_dp<WB>(reinterpret_cast<const uint4*>(text + first),
                      static_cast<int>(kin < nc + 1 ? kin : nc + 1), a,
                      reinterpret_cast<const uint4*>(read), len, steps,
                      match, mismatch, gap, sh_score, bias, n, score,
                      start_off, end_off, matches)))
        banded_dp<WB>(window, read, len, Lr, match, mismatch, gap, sh_score,
                      bias, n, score, start_off, end_off, matches);
}

// K1: one candidate a thread.
template <int WB>
__global__ void __launch_bounds__(kThreads)
banded_extend_kernel(const int8_t* __restrict__ text, long long T,
                     const int32_t* __restrict__ w0,
                     const int8_t* __restrict__ reads,
                     const int32_t* __restrict__ read_len,
                     int N, int Lr, int match, int mismatch, int gap,
                     int sh_score, int bias,
                     int32_t* __restrict__ score,
                     int32_t* __restrict__ start_off,
                     int32_t* __restrict__ end_off,
                     int32_t* __restrict__ matches) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;  // ragged last block
    const long long w = w0[n];
    dp_candidate<WB>(text, T, w, TextWindow{text, T, w},
                     reads + static_cast<long long>(n) * Lr, true,
                     read_len[n], Lr, match, mismatch, gap, sh_score, bias,
                     n, score, start_off, end_off, matches);
}

// K2: one candidate a thread, over the windows buffer as K1 over the text.
template <int WB>
__global__ void __launch_bounds__(kThreads)
banded_extend_windows_kernel(const int8_t* __restrict__ windows, int W,
                             const int8_t* __restrict__ reads,
                             const int32_t* __restrict__ read_len,
                             int N, int Lr, bool vec_reads, int match,
                             int mismatch, int gap, int sh_score, int bias,
                             int32_t* __restrict__ score,
                             int32_t* __restrict__ start_off,
                             int32_t* __restrict__ end_off,
                             int32_t* __restrict__ matches) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;  // ragged last block
    const long long w = static_cast<long long>(n) * W;
    dp_candidate<WB>(windows, static_cast<long long>(N) * W, w,
                     RowWindow{windows + w},
                     reads + static_cast<long long>(n) * Lr, vec_reads,
                     read_len[n], Lr, match, mismatch, gap, sh_score, bias,
                     n, score, start_off, end_off, matches);
}

int blocks_for(int N) { return (N + kThreads - 1) / kThreads; }

}  // namespace

// pad must lie in 1..8 (band rows WB = 2*pad <= 16); PANTAX_PAD_SWITCH
// instantiates one launch per band width.
#define PANTAX_PAD_SWITCH(LAUNCH)                                            \
    switch (pad) {                                                           \
        case 1: LAUNCH(2); break;                                            \
        case 2: LAUNCH(4); break;                                            \
        case 3: LAUNCH(6); break;                                            \
        case 4: LAUNCH(8); break;                                            \
        case 5: LAUNCH(10); break;                                           \
        case 6: LAUNCH(12); break;                                           \
        case 7: LAUNCH(14); break;                                           \
        case 8: LAUNCH(16); break;                                           \
        default: return static_cast<int>(cudaErrorInvalidValue);            \
    }

// K1.  Launches on ``stream`` and returns cudaGetLastError() (0 on success);
// reads must start on a 16-byte boundary and Lr be a multiple of 16.
extern "C" int banded_extend_launch(
    const void* text, long long T, const void* w0, const void* reads,
    const void* read_len, int N, int Lr, int pad, int match, int mismatch,
    int gap, int sh_score, int bias, void* score, void* start_off,
    void* end_off, void* matches, void* stream) {
    if (N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the fast path loads the read rows 16 bytes at a time
    if (Lr % kChunk != 0 || reinterpret_cast<uintptr_t>(reads) % kChunk != 0)
        return static_cast<int>(cudaErrorInvalidValue);
#define PANTAX_LAUNCH_K1(WB)                                                 \
    banded_extend_kernel<WB><<<blocks_for(N), kThreads, 0, s>>>(             \
        static_cast<const int8_t*>(text), T,                                 \
        static_cast<const int32_t*>(w0), static_cast<const int8_t*>(reads),  \
        static_cast<const int32_t*>(read_len), N, Lr, match, mismatch, gap,  \
        sh_score, bias, static_cast<int32_t*>(score),                        \
        static_cast<int32_t*>(start_off), static_cast<int32_t*>(end_off),    \
        static_cast<int32_t*>(matches))
    PANTAX_PAD_SWITCH(PANTAX_LAUNCH_K1)
#undef PANTAX_LAUNCH_K1
    return static_cast<int>(cudaGetLastError());
}

// K2: the DP over windows[N, W] (W >= Lr + 2*pad - 1).  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int banded_extend_windows_launch(
    const void* windows, int W, const void* reads, const void* read_len,
    int N, int Lr, int pad, int match, int mismatch, int gap, int sh_score,
    int bias, void* score, void* start_off, void* end_off, void* matches,
    void* stream) {
    if (N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the fast DP loads the read rows 16 bytes at a time; other rows take
    // the per-byte path (exact, and the first design's speed)
    const bool vec_reads =
        Lr % kChunk == 0 && reinterpret_cast<uintptr_t>(reads) % kChunk == 0;
#define PANTAX_LAUNCH_K2(WB)                                                 \
    banded_extend_windows_kernel<WB><<<blocks_for(N), kThreads, 0, s>>>(     \
        static_cast<const int8_t*>(windows), W,                              \
        static_cast<const int8_t*>(reads),                                   \
        static_cast<const int32_t*>(read_len), N, Lr, vec_reads, match,      \
        mismatch, gap, sh_score, bias, static_cast<int32_t*>(score),         \
        static_cast<int32_t*>(start_off), static_cast<int32_t*>(end_off),    \
        static_cast<int32_t*>(matches))
    PANTAX_PAD_SWITCH(PANTAX_LAUNCH_K2)
#undef PANTAX_LAUNCH_K2
    return static_cast<int>(cudaGetLastError());
}
