// Banded glocal DP extension for Hopper (sm_90a): K1 and K2.
//
// Replaces the two Pallas TPU kernels of pantax_tpu/ops/extend_pallas.py:
// - K1, :171 banded_extend_pallas (body _dp_kernel, :47): window fetch from
//   the index text fused with the DP; the JAX main path computes the same
//   with XLA as aligner._extract_windows + aligner._banded_extend;
// - K2, :316 banded_extend_pallas_dponly (body _dp_only_kernel, :238): the
//   same DP over windows already extracted into [N, W], which is exactly
//   aligner._banded_extend (the long-read rescue pass, _extend_batch).
// Both kernels run one __device__ DP (banded_dp), templated on where the
// window bases come from.
//
// For each candidate n it aligns the whole read reads[n, :read_len[n]]
// against its window (K1: text[w0[n] : w0[n] + Lr + 2*pad]; K2: the row
// windows[n]) with a free start and end in the window, over WB = 2*pad band
// rows.  The DP state is one packed int32 cell per band row,
//     ((score + bias) << sh_score) | (matches << 5) | start_band,
// so a plain integer max compares score, then matches, then start band.
// Outputs (score, start_off, end_off, matches), end_off taken from the
// first band row that reaches the maximum.
//
// What bounds K1: per candidate it reads Lr + WB - 1 text bytes and Lr read
// bytes (about 330 bytes at Lr = 160, pad = 4) and does about Lr * WB * 8
// integer operations (about 10k), so at N = 131072 candidates it moves
// ~43 MB and executes ~1.3 G integer ops: a few tens of microseconds of
// DRAM traffic against a comparable amount of ALU work.  The design keeps
// all DP state out of memory: one thread owns one candidate, holds its WB
// band cells and a WB-base sliding window in registers, and streams the
// read and window bytes through L1 (each thread walks its own rows
// sequentially, so every 128-byte line it touches serves ~128 steps).  The
// TPU kernel's 1024-aligned DMA slices, binary-decomposed lane rolls and
// static band shifts exist because Mosaic cannot slice rows dynamically;
// none of them is needed here.  The left-gap prefix max of the TPU kernel
// (log2(WB) shift steps) is the sequential recurrence
//     m[b] = max(v[b], m[b-1] + gap_p),
// which is equal to it in integers (no NEG fill value ever wins).
//
// What bounds K2 at the rescue pass's shape (N = 16384 chunks, Lr = 512,
// pad 8, W = 528): per row it reads 528 window bytes and 512 read bytes
// (17 MB in all, ~5 us of HBM time), so not bytes.  Each of its 511 steps
// is 157 SASS instructions at pad 8 (cuobjdump of the loop), nearly all
// on the integer pipe.  16384 threads are 128 blocks of 128, one block on
// each of 128 SMs: one warp per warp scheduler.  Timed against the number
// of rows on an H100 (PERF.md), K2 is flat up to 16384 rows and then grows
// almost in proportion (1.64x at 32768, 5.59x at 131072), so a lone warp
// per scheduler already gets ~70% of the throughput that eight warps get:
// K2 is mostly bound by integer issue, and the rest is latency each step
// cannot hide (the byte loads are consumed a few instructions after they
// are issued, and the left-gap recurrence is a serial chain).  Rows 528
// bytes apart make the per-step byte loads uncoalesced; L1 absorbs them
// (each thread reuses a 128-byte line for 128 steps).  The design does the
// simple thing: the band and the sliding window live in registers, as in
// K1.  More warps per SM would buy at most ~1.4x; fewer integer
// instructions per cell is where later work should look (e.g. map N codes
// to two distinct sentinels once, as a base enters the window and as the
// read base is loaded, so that one compare per cell replaces three; issue
// each step's loads a step ahead).
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
    const TextWindow window{text, T, static_cast<long long>(w0[n])};
    banded_dp<WB>(window, reads + static_cast<long long>(n) * Lr, read_len[n],
                  Lr, match, mismatch, gap, sh_score, bias, n, score,
                  start_off, end_off, matches);
}

template <int WB>
__global__ void __launch_bounds__(kThreads)
banded_extend_windows_kernel(const int8_t* __restrict__ windows, int W,
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
    const RowWindow window{windows + static_cast<long long>(n) * W};
    banded_dp<WB>(window, reads + static_cast<long long>(n) * Lr, read_len[n],
                  Lr, match, mismatch, gap, sh_score, bias, n, score,
                  start_off, end_off, matches);
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

// K1.  Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int banded_extend_launch(
    const void* text, long long T, const void* w0, const void* reads,
    const void* read_len, int N, int Lr, int pad, int match, int mismatch,
    int gap, int sh_score, int bias, void* score, void* start_off,
    void* end_off, void* matches, void* stream) {
    if (N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
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
#define PANTAX_LAUNCH_K2(WB)                                                 \
    banded_extend_windows_kernel<WB><<<blocks_for(N), kThreads, 0, s>>>(     \
        static_cast<const int8_t*>(windows), W,                              \
        static_cast<const int8_t*>(reads),                                   \
        static_cast<const int32_t*>(read_len), N, Lr, match, mismatch, gap,  \
        sh_score, bias, static_cast<int32_t*>(score),                        \
        static_cast<int32_t*>(start_off), static_cast<int32_t*>(end_off),    \
        static_cast<int32_t*>(matches))
    PANTAX_PAD_SWITCH(PANTAX_LAUNCH_K2)
#undef PANTAX_LAUNCH_K2
    return static_cast<int>(cudaGetLastError());
}
