// Banded glocal DP extension for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pantax_tpu/ops/extend_pallas.py:171
// banded_extend_pallas (body _dp_kernel, :47), which the JAX main path
// computes with XLA as aligner._extract_windows + aligner._banded_extend.
//
// For each candidate n it aligns the whole read reads[n, :read_len[n]]
// against the window text[w0[n] : w0[n] + Lr + 2*pad] with a free start and
// end in the window, over WB = 2*pad band rows.  The DP state is one packed
// int32 cell per band row,
//     ((score + bias) << sh_score) | (matches << 5) | start_band,
// so a plain integer max compares score, then matches, then start band.
// Outputs (score, start_off, end_off, matches), end_off taken from the
// first band row that reaches the maximum.
//
// What bounds it: per candidate the kernel reads Lr + WB - 1 text bytes and
// Lr read bytes (about 330 bytes at Lr = 160, pad = 4) and does about
// Lr * WB * 8 integer operations (about 10k), so at N = 131072 candidates it
// moves ~43 MB and executes ~1.3 G integer ops: a few tens of microseconds
// of DRAM traffic against a comparable amount of ALU work.  The design keeps
// all DP state out of memory: one thread owns one candidate, holds its WB
// band cells and a WB-base sliding text window in registers, and streams the
// read and text bytes through L1 (each thread walks its own rows
// sequentially, so every 128-byte line it touches serves ~128 steps).  The
// TPU kernel's 1024-aligned DMA slices, binary-decomposed lane rolls and
// static band shifts exist because Mosaic cannot slice rows dynamically;
// none of them is needed here.  The left-gap prefix max of the TPU kernel
// (log2(WB) shift steps) is the sequential recurrence
//     m[b] = max(v[b], m[b-1] + gap_p),
// which is equal to it in integers (no NEG fill value ever wins).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShMatch = 5;
constexpr int kNeg = -1000000;
constexpr int kThreads = 128;

__device__ __forceinline__ int load_text(const int8_t* __restrict__ text,
                                         long long T, long long p) {
    // positions are clamped into the text, as the plain version does; the
    // aligner clips w0 so that real windows never need it
    p = p < 0 ? 0 : (p >= T ? T - 1 : p);
    return static_cast<int>(text[p]);
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

    const int len = read_len[n];
    const long long base = w0[n];
    const int8_t* __restrict__ read = reads + static_cast<long long>(n) * Lr;
    const int d_score = 1 << sh_score;
    const int gap_p = gap * d_score;
    const int mis_d = mismatch * d_score;
    const int ok_d = match * d_score + (1 << kShMatch);

    int win[WB];  // text bases of window rows i .. i + WB - 1
#pragma unroll
    for (int b = 0; b < WB; ++b) win[b] = load_text(text, T, base + b);

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
        win[WB - 1] = load_text(text, T, base + i + WB - 1);
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
void launch(const void* text, long long T, const void* w0, const void* reads,
            const void* read_len, int N, int Lr, int match, int mismatch,
            int gap, int sh_score, int bias, void* score, void* start_off,
            void* end_off, void* matches, cudaStream_t stream) {
    const int blocks = (N + kThreads - 1) / kThreads;
    banded_extend_kernel<WB><<<blocks, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(text), T,
        static_cast<const int32_t*>(w0), static_cast<const int8_t*>(reads),
        static_cast<const int32_t*>(read_len), N, Lr, match, mismatch, gap,
        sh_score, bias, static_cast<int32_t*>(score),
        static_cast<int32_t*>(start_off), static_cast<int32_t*>(end_off),
        static_cast<int32_t*>(matches));
}

}  // namespace

// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
// pad must lie in 1..8 (band rows WB = 2*pad <= 16).
extern "C" int banded_extend_launch(
    const void* text, long long T, const void* w0, const void* reads,
    const void* read_len, int N, int Lr, int pad, int match, int mismatch,
    int gap, int sh_score, int bias, void* score, void* start_off,
    void* end_off, void* matches, void* stream) {
    if (N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PANTAX_LAUNCH(WB)                                                    \
    launch<WB>(text, T, w0, reads, read_len, N, Lr, match, mismatch, gap,    \
               sh_score, bias, score, start_off, end_off, matches, s)
    switch (pad) {
        case 1: PANTAX_LAUNCH(2); break;
        case 2: PANTAX_LAUNCH(4); break;
        case 3: PANTAX_LAUNCH(6); break;
        case 4: PANTAX_LAUNCH(8); break;
        case 5: PANTAX_LAUNCH(10); break;
        case 6: PANTAX_LAUNCH(12); break;
        case 7: PANTAX_LAUNCH(14); break;
        case 8: PANTAX_LAUNCH(16); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PANTAX_LAUNCH
    return static_cast<int>(cudaGetLastError());
}
