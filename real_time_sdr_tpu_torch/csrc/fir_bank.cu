// FIR bank: nf same-geometry polyphase FIRs over one tail-prefixed input.
//
// Replaces the TPU kernel `_kernel` of real_time_sdr_tpu/ops/pallas/polyfir.py
// (launched by FramedFIRBank.__call__), the kernel form of ops/fir.make_bank
// behind every FIR site of the receive path after the frontend: the IF band
// triple, the audio resamplers (rails stacked as batch rows), the RDS 247/640
// baseband bank, the RRC, the tier-3 sync complex FIR pairs and the RDS pilot.
//
// What it computes. The TPU kernel builds frames in VMEM and multiplies them
// by a zero-padded polyphase weight matrix (f32 HIGHEST). This kernel computes
// the same outputs straight from the polyphase identity behind that matrix:
//
//     y_f[n] = sum_m h_f[p_n + up*m] * xx[q_n + T-1 - m],   p_n + up*m < K
//     p_n = (n*down) mod up,   q_n = floor(n*down / up),   T = ceil(K / up)
//
// so it does exactly the K/up useful MACs per output that the framed matmul
// pads out to a J-wide row of mostly structural zeros (J = 228 against
// T = 101 at K 101, R 128). Every accumulator sums m ascending with fmaf,
// in both bodies; no TF32, no split precision.
//
// What bounds it on the H100. In f32 every site is far below the card's FMA
// rate in bytes (each input sample feeds K/up * nf MACs; the IF triple at
// 32 ch x 88,200 moves about 45 MB, 0.013 ms at 3.35 TB/s), so the limit is
// instruction issue. The first form of this kernel (one output a thread,
// in both bodies) issued, per tap, one shared load of the input, nf
// read-only-cache tap loads and the address and loop arithmetic of a
// runtime trip count for nf
// FFMAs: at best one FFMA in 2.5 instructions at nf 3, one in 4 at nf 1. At
// the five up = down = 1 sites that came to 3.05 G MACs in 0.737 ms, 8.3
// TFLOP/s, 12 % of the 67 TFLOP/s f32 FMA rate, and slower than the framed
// SGEMM (0.595 ms) in spite of its 2.26x redundant work (NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// Two bodies; the geometry alone picks one (ops/cuda/fir_bank.py
// `kernel_body` names the same rule for the launch counts), the shape the
// general body's tile (lines or direct, counted apart):
//
// - Tiled, up == down == 1 (IF triple, both sync pairs, RDS pilot, RRC).
//   Each thread computes kP consecutive outputs for all nf filters: kP * nf
//   f32 accumulators in registers and a ring of kP input samples that
//   slides by one sample per tap. Per tap a thread issues one shared load
//   (the new sample), one broadcast shared load of the nf taps of that m
//   (float, float2 or float4 by nf; taps laid out [m][f], padded), and
//   kP * nf FFMAs: the compiled main loop is 77 % FFMA at nf 1, 90 % at
//   nf 3, 93 % at nf 4. The tap loop is unrolled by kP with a guarded
//   remainder, so K stays a runtime value and the ring's slots are
//   registers (at step s the sample of output i is in slot (i - s) mod
//   kP). kP is odd: lane t's samples start kP * t floats apart, so one
//   warp's sample load touches 32 banks.
//   The taps stay in m order and the window walks backward (step s reads
//   window element K-1-s): reversing the taps to walk forward would sum m
//   descending, another rounding than the general body's and the plain
//   form's order. A block stages its window (kTiledTile + K - 1 samples)
//   with 16-byte cp.async copies from the 16-byte boundary at or below the
//   row start (rows start at b*L floats, not aligned in general), the
//   ragged ends with scalar loads, and zeroes what lies past the row end.
//   Outputs go back through shared memory so the stores coalesce. What
//   bounds it now is the FFMA pipe: on an NVIDIA H100 80GB HBM3, 700.00 W
//   (SM clock held at 1980 MHz), a register-only loop of this operand
//   pattern (shared tap x per-output sample + accumulator) reaches 53-55
//   TFLOP/s (61.8 with two register operands), and this body sustains
//   28-39 TFLOP/s, the rest going to the per-tap shared loads, the
//   block's prologue and epilogue and the grid's tail. No other tile
//   shape (kP 5-13, 64-256 threads) beat kP 9 x 128 threads by more than
//   7 % at any site; an even kP (8) costs 1.2-2.1x.
//   Why not tensor cores yet: a tensor-core form multiplies a banded
//   Toeplitz tap tile (M outputs x (M+K-1) inputs) by a channels-wide input
//   tile. Only K/(M+K-1) of that work is useful (0.62 at K 101, M 64; 0.75
//   at K 191), and staying near f32 needs a 3xTF32 split, three products
//   each: a ceiling near 495/3 x 0.62-0.75 = 100-124 TFLOP/s of useful
//   work against the FFMA form's 67, and a precision change that must
//   first pass the decode and SNR gates.
//
// - General, any other up/down (the RDS baseband banks 247/640, 247/960,
//   19/96, 95/768, the audio rails of modes 2-3 at 147/800 and 147/1280,
//   the alternative decode's 19/240, the channelizer's 1/decim bank). A
//   first form gave each thread one output: per tap one shared load of
//   the sample and one scattered read-only load of the tap (neighbouring
//   outputs have other phases, so a warp's tap load touched up to 32
//   sectors, and at 247/640 every step a new set of lines of a 100 KB
//   table), 2.2-5.1 TFLOP/s, 7-13 % of the bound. Taps now come
//   phase-major (ptaps[f][p][m] = h_f[p + up*m], zero past K;
//   FIRBank.ptaps, built on the host), one phase's taps contiguous, and
//   the host plan (ops/cuda/fir_bank.py general_plan) picks one of two
//   tiles by shape: LINES where there are many lines, DIRECT where few.
//   Both sum each output in one fmaf chain a filter over m ascending,
//   zero taps included: the outputs are bit for bit those of the first
//   form (for finite inputs; a zero tap's fmaf leaves a finite sum as it
//   was, a final -0 aside).
//   LINES maps lanes to lines and shares taps across them:
//   * A line is a row, or, where rows are few, a stretch of U outputs of a
//     row with U a multiple of the phase period up/gcd(up, down): every
//     line then meets the same phases at the same local outputs, and its
//     input starts U*down/up samples after the previous line's.
//   * A block (nw warps) covers lb lines x gb groups of ko consecutive
//     outputs (ko * nf = 8 accumulator columns, 6 at nf 3); warp w takes
//     group w % gb, each lane rt lines: rt x 8 accumulators.
//   * For each group the block builds a tap stream per column: at step s
//     the tap h_f[p_i + up*(s - off_i)] of the column's output i, zero
//     outside 0 <= s - off_i < T. The group walks the union of its
//     outputs' input windows downward, one sample a step, so every column
//     still sums its own taps with m ascending.
//   * Per four steps a lane issues one 16-byte shared load of each of its
//     lines' samples (lines ws floats apart with ws % 8 == 4, so a quarter
//     warp covers the 32 banks) and one broadcast 16-byte load of each
//     column's next four taps, then rt x 8 x 4 FFMAs; two quads' loads in
//     flight. The walk costs T + (ko-1)*down/up + up to 6 steps a group
//     for T useful ones: 124 for 101 at 247/640, 190 for 101 at 19/240.
//   * Inputs come through registers, every lane's loads of a pass in
//     flight together (the window's first pass before the warp makes its
//     column table, with shuffles in place of a shared table and a
//     barrier); outputs go out through the spent buffer so that each
//     (line, filter) leaves as consecutive outputs.
//   What bounds it on an NVIDIA H100 80GB HBM3, 700.00 W (median clock64
//   cycles a block, utils/fir_bank_phases.py, mode-0 site, 384 rows x
//   7,350 at 247/640, 534 blocks, three an SM): of ~23,100, about 11,800
//   go to making the unit and bringing its window and tap streams in
//   (64.5 KB a block: the windows of neighbouring blocks overlap, 2.3
//   floats staged for each new sample, and a tile's streams are staged
//   again by every line group; a wave's blocks start, and load, together),
//   8,200 to the walk and 3,100 to the way out; 534 blocks on 396 slots
//   take two waves. Few lines leave lanes idle and pay a block's whole
//   latency for little work: 1-2 rows of 247/640 (12-24 lines) ran 4-9 %
//   slower than the first form, the alternative decode's 2 rows of
//   19/240 (d = down/up = 12.6, 190 steps a group) 45 % slower.
//   DIRECT is the first form rebuilt for those shapes: a block is bo
//   (128) consecutive outputs of one row, one a thread, all nf filters.
//   It stages its window with 4-byte cp.async copies (any row start) and,
//   where a block's outputs meet each phase twice or more (up/gcd <=
//   bo/2) and T >= 16, the taps of every phase, rows ts floats apart (ts
//   % 8 == 4: a quarter warp's 16-byte tap loads fall in 8 bank quads);
//   else the taps come through L1 from the phase-major table (each
//   thread's own 4-5 lines, reused for its T steps, not a new line a
//   step). Four steps a 16-byte tap load; no 64-bit division where n *
//   down fits 31 bits. On the same card (utils/fir_digest.py cases):
//   1 and 2 rows of 247/640 0.0092-0.0093 ms through L1 (0.0116-0.0117
//   before; staging a row per output took 0.0197), 2 rows of 19/240 at
//   0.0106 staged (0.0132), and every random geometry of the property
//   test that general_plan gives it no slower than the first form; at
//   384 rows of 247/640 it takes 0.34 ms (the lines tile 0.0286). What
//   bounds it: a block's latency (window and taps in, then a T-step fmaf
//   chain), the grid being a few dozen blocks at 1-2 rows.
//
// Both bodies put their tiles on a flat gridDim.x, so any row count runs.

#include <climits>
#include <cstdint>
#include <numeric>

#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------------ common --

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();  // reported here: the next
                                               // launch must not see it
  return err;
}

// As allow_smem, with the SM's L1/shared split set to the most shared
// memory (the general body fits two blocks an SM only there). `granted`
// holds, per device, the most this kernel was allowed: the attribute calls
// stay off the launch path.
template <typename Kernel>
cudaError_t allow_smem_shared(Kernel kernel, size_t smem, size_t* granted,
                              int n_devices) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < n_devices && smem <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < n_devices) granted[dev] = smem;
  return cudaSuccess;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

// ---------------------------------------------------------------- general --

constexpr int kGenThreads = 128;  // most threads a block: 4 warps
constexpr int kGenCols = 8;       // accumulator columns a line: outputs x nf

// Outputs of one group: kGenCols / nf (nf 3: 2, six columns).
template <int NF> struct GenKO {
  static constexpr int value = NF == 1 ? 8 : NF == 2 ? 4 : 2;
};

// Floats of a window that covers n consecutive outputs' inputs, from the
// 16-byte boundary at or below the first output's window start to the one
// at or above the last output's end: at most ceil((n-1)*down/up) + T + 6,
// rounded up to whole 16-byte chunks.
__host__ __device__ constexpr long long gen_window_bound(long long n, int up,
                                                         int down, int T) {
  return (((n - 1) * down + up - 1) / up + T + 6 + 3) & ~3LL;
}

// Floats of a block's shared buffer: its unit's window and tap streams,
// or the output tile that reuses them, whichever is larger.
__host__ __device__ constexpr size_t gen_buffer_floats(int lb, int gb, int ws,
                                                       int span) {
  return static_cast<size_t>(lb) * ws +
                 static_cast<size_t>(gb) * kGenCols * span >
             static_cast<size_t>(lb) * (gb * kGenCols + 1)
             ? static_cast<size_t>(lb) * ws +
                   static_cast<size_t>(gb) * kGenCols * span
             : static_cast<size_t>(lb) * (gb * kGenCols + 1);
}

// floor(n * down / up) for n >= 0, in 32 bits where the product fits.
__device__ __forceinline__ long long gen_q(int n, int down, int up,
                                           bool narrow) {
  return narrow ? static_cast<long long>(static_cast<unsigned>(n * down) /
                                         static_cast<unsigned>(up))
                : static_cast<long long>(n) * down / up;
}

// The launch's shape, the same for every unit.
struct GenShape {
  int L, up, down, T, n_out, U, V, lines, tiles, ko, gb, ws, span, lb;
  int nw;        // warps a block
  long long vs;  // input samples from one line of a row to the next
  bool narrow;   // U * down fits in 31 bits
};

// A unit: line group lg (lines lg*lb ...) x nb consecutive outputs from n0
// of every line; its window holds samples [j0, j0 + wsz) of each line, j0 a
// 16-byte boundary (in samples of the line).
struct GenUnit {
  int lg, n0, nb, wsz;
  long long j0;
};

__device__ __forceinline__ GenUnit gen_unit(const GenShape& s, int u) {
  GenUnit t;
  t.lg = u / s.tiles;
  t.n0 = (u - t.lg * s.tiles) * s.gb * s.ko;
  t.nb = min(s.gb * s.ko, s.U - t.n0);
  t.j0 = gen_q(t.n0, s.down, s.up, s.narrow) & ~3LL;
  t.wsz = static_cast<int>(
      ((gen_q(t.n0 + t.nb - 1, s.down, s.up, s.narrow) + s.T + 3) & ~3LL) -
      t.j0);
  return t;
}

// Column `lane` of a unit (group lane / kGenCols, column lane % kGenCols),
// made by every warp for itself: its taps' row in the phase-major table
// (-1: none) and the step at which its m = 0, and its group's top sample
// and quad count. A warp reads another column's with __shfl_sync.
struct GenCol {
  int prow, off, jt, nq;
};

template <int NF>
__device__ __forceinline__ GenCol gen_column(const GenShape& s,
                                             const GenUnit& t, int lane) {
  GenCol col = {-1, 0, 0, 0};
  const int g = lane / kGenCols, c = lane - g * kGenCols;
  const int i = c / NF, f = c - i * NF;
  const int t0 = g * s.ko;
  const int cnt = min(s.ko, t.nb - t0);
  if (g >= s.gb || cnt <= 0) return col;
  const long long qf = gen_q(t.n0 + t0, s.down, s.up, s.narrow);
  const long long ql = gen_q(t.n0 + t0 + cnt - 1, s.down, s.up, s.narrow);
  col.jt = static_cast<int>(((ql + s.T + 3) & ~3LL) - 1 - t.j0);
  col.nq = (col.jt + 1 - static_cast<int>((qf & ~3LL) - t.j0)) / 4;
  if (i < cnt) {
    const int n = t.n0 + t0 + i;
    const long long q = gen_q(n, s.down, s.up, s.narrow);
    const int p = static_cast<int>(
        (s.narrow ? static_cast<long long>(n * s.down)
                  : static_cast<long long>(n) * s.down) -
        q * s.up);
    col.prow = (f * s.up + p) * s.T;
    col.off = col.jt - (static_cast<int>(q - t.j0) + s.T - 1);
  }
  return col;
}

// A unit's tap streams and window come into shared memory through
// registers, every lane's loads of a pass in flight together: column c of
// group g at step s holds h_f[p + up*(s - off)] where 0 <= s - off < T,
// else 0 (steps run down the window, so every column sums its taps with m
// ascending); each line's window comes in 8-byte pairs where its start
// allows them, zeros past the row's end. Warp w takes columns w, w + 4,
// ... and lines w, w + 4, ... (with 4 warps), lanes along them.
constexpr int kStageCols = 8;    // columns a lane a pass: all a block has
constexpr int kStageSteps = 4;   // steps a lane a column a pass
constexpr int kStageLines = 16;  // lines a lane a pass
constexpr int kStagePairs = 3;   // 8-byte pairs a lane a line a pass

struct GenStage {
  float col[kStageCols][kStageSteps];
  float2 win[kStageLines][kStagePairs];
};

// Samples 2k and 2k+1 of a line (zeros from nv on); one 8-byte load where
// the line's start allows it.
__device__ __forceinline__ float2 gen_pair(const float* src, int k2, int nv,
                                           bool al8) {
  if (al8 && k2 + 1 < nv)
    return __ldg(reinterpret_cast<const float2*>(src + k2));
  return make_float2(k2 < nv ? __ldg(src + k2) : 0.f,
                     k2 + 1 < nv ? __ldg(src + k2 + 1) : 0.f);
}

__device__ __forceinline__ void gen_load_cols(const GenShape& s,
                                              const GenCol& col,
                                              const float* __restrict__ ptaps,
                                              GenStage& st, int s0, int warp,
                                              int lane) {
#pragma unroll
  for (int u = 0; u < kStageCols; ++u) {
    const int gc = (warp + s.nw * u) & 31;  // < gb * kGenCols <= 32 where used
    const int prow = __shfl_sync(0xffffffffu, col.prow, gc);
    const int off = __shfl_sync(0xffffffffu, col.off, gc);
    const bool used = warp + s.nw * u < s.gb * kGenCols;
#pragma unroll
    for (int q = 0; q < kStageSteps; ++q) {
      const int m = s0 + lane + 32 * q - off;
      st.col[u][q] = used && prow >= 0 && m >= 0 && m < s.T
                         ? __ldg(ptaps + prow + m)
                         : 0.f;
    }
  }
}

__device__ __forceinline__ void gen_store_cols(const GenShape& s,
                                               const GenStage& st,
                                               float* str, int s0, int warp,
                                               int lane) {
#pragma unroll
  for (int u = 0; u < kStageCols; ++u) {
    const int gc = warp + s.nw * u;
    if (gc >= s.gb * kGenCols) break;
#pragma unroll
    for (int q = 0; q < kStageSteps; ++q) {
      const int k = s0 + lane + 32 * q;
      if (k < s.span) str[gc * s.span + k] = st.col[u][q];
    }
  }
}

__device__ __forceinline__ void gen_load_win(const GenShape& s,
                                             const GenUnit& t,
                                             const float* __restrict__ xx,
                                             GenStage& st, int li0, int p0,
                                             int lane) {
#pragma unroll
  for (int u = 0; u < kStageLines; ++u) {
    const int li = li0 + s.nw * u;
    const int line = t.lg * s.lb + li;
    int nv = 0;
    const float* src = xx;
    if (li < s.lb && line < s.lines) {
      const int b = s.V == 1 ? line : line / s.V;
      const long long start = (line - b * s.V) * s.vs + t.j0;
      src = xx + static_cast<long long>(b) * s.L + start;
      nv = static_cast<int>(
          max(0LL, min(static_cast<long long>(t.wsz), s.L - start)));
    }
    const bool al8 = (reinterpret_cast<uintptr_t>(src) & 7u) == 0;
#pragma unroll
    for (int q = 0; q < kStagePairs; ++q)
      st.win[u][q] = gen_pair(src, 2 * (p0 + lane + 32 * q), nv, al8);
  }
}

__device__ __forceinline__ void gen_store_win(const GenShape& s,
                                              const GenUnit& t,
                                              const GenStage& st, float* buf,
                                              int li0, int p0, int lane) {
#pragma unroll
  for (int u = 0; u < kStageLines; ++u) {
    const int li = li0 + s.nw * u;
    if (li >= s.lb) break;
#pragma unroll
    for (int q = 0; q < kStagePairs; ++q) {
      const int k = p0 + lane + 32 * q;
      if (2 * k < t.wsz)
        *reinterpret_cast<float2*>(buf + li * s.ws + 2 * k) = st.win[u][q];
    }
  }
}

// After the first pass of the window is in flight (gen_load_win, before
// the warp makes its columns): the first pass of the streams, both stored,
// then the rest (long windows, many lines, long streams) pass by pass.
__device__ __forceinline__ void gen_stage_rest(
    const GenShape& s, const GenUnit& t, const GenCol& col, float* buf,
    const float* __restrict__ xx, const float* __restrict__ ptaps,
    GenStage& st, int warp, int lane) {
  float* str = buf + s.lb * s.ws;
  constexpr int kColPass = 32 * kStageSteps, kWinPass = 32 * kStagePairs;
  gen_load_cols(s, col, ptaps, st, 0, warp, lane);
  gen_store_win(s, t, st, buf, warp, 0, lane);
  gen_store_cols(s, st, str, 0, warp, lane);
  for (int s0 = kColPass; s0 < s.span; s0 += kColPass) {
    gen_load_cols(s, col, ptaps, st, s0, warp, lane);
    gen_store_cols(s, st, str, s0, warp, lane);
  }
  for (int li0 = warp; li0 < s.lb; li0 += s.nw * kStageLines)
    for (int p0 = li0 == warp ? kWinPass : 0; p0 < t.wsz / 2;
         p0 += kWinPass) {
      gen_load_win(s, t, xx, st, li0, p0, lane);
      gen_store_win(s, t, st, buf, li0, p0, lane);
    }
}

// One step of the tap walk: column c's tap times the line's sample.
template <int NF, int RT>
__device__ __forceinline__ void gen_step(float (&acc)[RT][kGenCols],
                                         const float (&x)[RT],
                                         const float (&h)[kGenCols]) {
  constexpr int kCols = GenKO<NF>::value * NF;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(h[c], x[r], acc[r][c]);
}

// Four steps of the tap walk from one 16-byte load of each line's samples
// (steps 0-3 read .w, .z, .y, .x: the window walks down) and one of each
// column's taps (.x, .y, .z, .w).
template <int NF, int RT>
__device__ __forceinline__ void gen_quad(float (&acc)[RT][kGenCols],
                                         const float4 (&xv)[RT],
                                         const float4 (&hv)[kGenCols]) {
  constexpr int kCols = GenKO<NF>::value * NF;
  float x[RT], h[kGenCols];
#pragma unroll
  for (int r = 0; r < RT; ++r) x[r] = xv[r].w;
#pragma unroll
  for (int c = 0; c < kCols; ++c) h[c] = hv[c].x;
  gen_step<NF, RT>(acc, x, h);
#pragma unroll
  for (int r = 0; r < RT; ++r) x[r] = xv[r].z;
#pragma unroll
  for (int c = 0; c < kCols; ++c) h[c] = hv[c].y;
  gen_step<NF, RT>(acc, x, h);
#pragma unroll
  for (int r = 0; r < RT; ++r) x[r] = xv[r].y;
#pragma unroll
  for (int c = 0; c < kCols; ++c) h[c] = hv[c].z;
  gen_step<NF, RT>(acc, x, h);
#pragma unroll
  for (int r = 0; r < RT; ++r) x[r] = xv[r].x;
#pragma unroll
  for (int c = 0; c < kCols; ++c) h[c] = hv[c].w;
  gen_step<NF, RT>(acc, x, h);
}

// Quad k's loads: each line's samples k*4 steps down from its top, and
// each column's taps of those steps.
template <int NF, int RT>
__device__ __forceinline__ void gen_load(float4 (&xv)[RT],
                                         float4 (&hv)[kGenCols],
                                         const float* const (&xr)[RT],
                                         const float4* tq, int sq, int k) {
  constexpr int kCols = GenKO<NF>::value * NF;
#pragma unroll
  for (int r = 0; r < RT; ++r)
    xv[r] = *reinterpret_cast<const float4*>(xr[r] - 4 * k);
#pragma unroll
  for (int c = 0; c < kCols; ++c) hv[c] = tq[c * sq + k];
}

// A unit's outputs of this warp's group for its lines li0 + 32 r.
template <int NF, int RT>
__device__ __forceinline__ void gen_compute(const GenShape& s,
                                            const GenCol& col,
                                            const float* buf, int g, int li0,
                                            float (&acc)[RT][kGenCols]) {
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kGenCols; ++c) acc[r][c] = 0.f;
  const int nq = __shfl_sync(0xffffffffu, col.nq, g * kGenCols);
  if (nq == 0) return;
  const int jt = __shfl_sync(0xffffffffu, col.jt, g * kGenCols);
  const float* xr[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) xr[r] = buf + (li0 + 32 * r) * s.ws + jt - 3;
  const float4* tq = reinterpret_cast<const float4*>(
      buf + s.lb * s.ws + g * kGenCols * s.span);
  const int sq = s.span / 4;
  // Four steps a load: each line's samples in one 16-byte load (the
  // lines' rows are ws floats apart, ws % 8 == 4, so a quarter warp's
  // loads cover all 32 banks), each column's taps in one broadcast 16-byte
  // load; two quads in flight, the next one's loads issued before this
  // one's FMAs.
  float4 xa[RT], ha[kGenCols], xb[RT], hb[kGenCols];
  gen_load<NF, RT>(xa, ha, xr, tq, sq, 0);
  int k = 0;
  for (; k + 2 <= nq; k += 2) {
    gen_load<NF, RT>(xb, hb, xr, tq, sq, k + 1);
    gen_quad<NF, RT>(acc, xa, ha);
    gen_load<NF, RT>(xa, ha, xr, tq, sq, min(k + 2, nq - 1));
    gen_quad<NF, RT>(acc, xb, hb);
  }
  if (k < nq) gen_quad<NF, RT>(acc, xa, ha);
}

// Block u is unit u: lb = (nw/gb) * 32 * RT lines (a line: one row, or
// one stretch of U outputs of a row) x gb groups of ko consecutive outputs
// of every line; warp w of the block's nw takes group w % gb and lines
// (w / gb) * 32 * RT + 32 r + lane, r < RT. See the header for the layout.
template <int NF, int RT>
__global__ void __launch_bounds__(kGenThreads)
fir_bank_general(const float* __restrict__ xx,
                 const float* __restrict__ ptaps, float* __restrict__ y,
                 GenShape s) {
  constexpr int kCols = GenKO<NF>::value * NF;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp % s.gb;
  const int li0 = (warp / s.gb) * 32 * RT + lane;
  const GenUnit t = gen_unit(s, blockIdx.x);
  GenStage st;
  gen_load_win(s, t, xx, st, warp, 0, lane);
  const GenCol col = gen_column<NF>(s, t, lane);
  gen_stage_rest(s, t, col, buf, xx, ptaps, st, warp, lane);
  __syncthreads();

  float acc[RT][kGenCols];
  gen_compute<NF, RT>(s, col, buf, g, li0, acc);

  // Out through the spent buffer: row li holds the unit's gb * kGenCols
  // columns of line li, os floats apart, so a warp's lanes (lines) write
  // 32 banks; then each (line, filter) goes out as nb consecutive outputs,
  // lanes along them.
  const int os = s.gb * kGenCols + 1;
  const int ko_log = s.ko == 8 ? 3 : s.ko == 4 ? 2 : s.ko == 2 ? 1 : 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      buf[(li0 + 32 * r) * os + g * kGenCols + c] = acc[r][c];
  __syncthreads();
#pragma unroll 4
  for (int item = warp; item < s.lb * NF; item += s.nw) {
    const int li = item / NF, f = item - li * NF;
    const int line = t.lg * s.lb + li;
    if (line >= s.lines) break;
    const int b = s.V == 1 ? line : line / s.V;
    const long long n =
        static_cast<long long>(line - b * s.V) * s.U + t.n0 + lane;
    if (lane < t.nb && n < s.n_out) {
      const int col = (lane >> ko_log) * kGenCols +
                      (lane & (s.ko - 1)) * NF + f;
      y[(static_cast<long long>(b) * NF + f) * s.n_out + n] =
          buf[li * os + col];
    }
  }
}

// ---------------------------------------------------------- general, direct --

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

// The direct tile's launch shape: a block is bo consecutive outputs of one
// row, one a thread.
struct DirShape {
  int L, up, down, T, n_out, tiles, bo;
  int g;     // gcd(up, down): every phase is a multiple of it
  int rows;  // tap rows a filter in shared memory: up/g (every phase) or bo
             // (one a thread); not read where the taps come through L1
  int ts;    // floats from one staged tap row to the next, ts % 8 == 4
  int ws;    // floats of the window's buffer, a multiple of 4
  bool narrow;  // n * down fits in 31 bits for every output n
};

// Block u covers outputs n0 = (u % tiles) * bo ... of row u / tiles, thread
// t output n0 + t for every filter. The block stages its window (samples
// [q_n0, q_last + T) of the row) and, where STAGED, each filter's taps of
// the phases its outputs meet (all up/g phases where rows == up/g, else
// the phase of each output: bo < up/g, so they differ), rows ts floats
// apart so a quarter warp's 16-byte tap loads fall in 8 different bank
// quads. Each output is one fmaf chain a filter over m ascending: four
// steps a 16-byte tap load (scalar loads through L1 where not STAGED).
template <int NF, bool STAGED>
__global__ void __launch_bounds__(kGenThreads)
fir_bank_direct(const float* __restrict__ xx, const float* __restrict__ ptaps,
                float* __restrict__ y, DirShape s) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  float* tab = win + s.ws;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x / s.tiles;
  const int n0 = (blockIdx.x - b * s.tiles) * s.bo;
  const int cnt = min(s.bo, s.n_out - n0);
  const long long q0 = gen_q(n0, s.down, s.up, s.narrow);
  const int wsz =
      static_cast<int>(gen_q(n0 + cnt - 1, s.down, s.up, s.narrow) - q0) +
      s.T;
  const float* row = xx + static_cast<long long>(b) * s.L + q0;
  for (int j = tid; j < wsz; j += blockDim.x) cp_async4(win + j, row + j);
  const bool every_phase = s.rows * s.g == s.up;
  if (STAGED) {
    for (int rf = warp; rf < s.rows * NF; rf += nwarps) {
      const int f = rf / s.rows, r = rf - f * s.rows;
      int p = r * s.g;
      if (!every_phase) {
        const int n = min(n0 + r, s.n_out - 1);
        p = static_cast<int>(
            (s.narrow ? static_cast<long long>(n * s.down)
                      : static_cast<long long>(n) * s.down) -
            gen_q(n, s.down, s.up, s.narrow) * s.up);
      }
      const float* src = ptaps + static_cast<long long>(f * s.up + p) * s.T;
      float* dst = tab + (f * s.rows + r) * s.ts;
      for (int m = lane; m < s.T; m += 32) cp_async4(dst + m, src + m);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (tid >= cnt) return;

  const int n = n0 + tid;
  const long long q = gen_q(n, s.down, s.up, s.narrow);
  const int p = static_cast<int>(
      (s.narrow ? static_cast<long long>(n * s.down)
                : static_cast<long long>(n) * s.down) -
      q * s.up);
  const float* xs = win + static_cast<int>(q - q0) + s.T - 1;
  const float* h[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f)
    h[f] = STAGED ? tab + (f * s.rows + (every_phase ? p / s.g : tid)) * s.ts
                  : ptaps + static_cast<long long>(f * s.up + p) * s.T;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  int m = 0;
#pragma unroll 2
  for (; m + 4 <= s.T; m += 4) {
    float4 hv[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      hv[f] = STAGED ? *reinterpret_cast<const float4*>(h[f] + m)
                     : make_float4(__ldg(h[f] + m), __ldg(h[f] + m + 1),
                                   __ldg(h[f] + m + 2), __ldg(h[f] + m + 3));
    const float x0 = xs[-m], x1 = xs[-m - 1], x2 = xs[-m - 2],
                x3 = xs[-m - 3];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      acc[f] = fmaf(hv[f].x, x0, acc[f]);
      acc[f] = fmaf(hv[f].y, x1, acc[f]);
      acc[f] = fmaf(hv[f].z, x2, acc[f]);
      acc[f] = fmaf(hv[f].w, x3, acc[f]);
    }
  }
  for (; m < s.T; ++m) {
    const float x = xs[-m];
#pragma unroll
    for (int f = 0; f < NF; ++f)
      acc[f] = fmaf(STAGED ? h[f][m] : __ldg(h[f] + m), x, acc[f]);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    y[(static_cast<long long>(b) * NF + f) * s.n_out + n] = acc[f];
}

// ------------------------------------------------------------------ tiled --

constexpr int kP = 9;                          // outputs per thread, odd
constexpr int kTiledThreads = 128;              // threads per block
constexpr int kTiledTile = kP * kTiledThreads;  // outputs per block: 1152

// The nf taps of one m as one shared load.
template <int NF> struct TapVec { using type = float4; static constexpr int kW = 4; };
template <> struct TapVec<1> { using type = float; static constexpr int kW = 1; };
template <> struct TapVec<2> { using type = float2; static constexpr int kW = 2; };

__device__ __forceinline__ float tap_of(float v, int) { return v; }
__device__ __forceinline__ float tap_of(float2 v, int f) {
  return f == 0 ? v.x : v.y;
}
__device__ __forceinline__ float tap_of(float4 v, int f) {
  return f == 0 ? v.x : f == 1 ? v.y : f == 2 ? v.z : v.w;
}

// Floats of the tap table, rounded up to 16 bytes so the window after it is
// 16-byte aligned for cp.async.
__host__ __device__ constexpr int tiled_tap_floats(int K, int w) {
  return (K * w + 3) & ~3;
}

// Floats of the window: up to 3 floats of alignment slack, then
// kTiledTile + K - 1 samples, rounded up to whole 16-byte chunks.
__host__ __device__ constexpr int tiled_win_floats(int K) {
  return (3 + kTiledTile + K - 1 + 3) & ~3;
}

// One tap step s = m + u (u = s mod kP, a constant once unrolled): the new
// sample xs[-s] enters the ring's slot (-u) mod kP, whose old sample (output
// kP-1's of step s-1) is no longer needed; output i reads slot (i - u) mod kP.
template <int NF, typename Vec>
__device__ __forceinline__ void tiled_step(float (&acc)[kP][NF],
                                           float (&ring)[kP],
                                           const float* xs, const Vec* hs,
                                           int s, int u) {
  ring[(kP - u) % kP] = xs[-s];
  const Vec h = hs[s];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const float x = ring[(i - u + kP) % kP];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = fmaf(tap_of(h, f), x, acc[i][f]);
  }
}

template <int NF>
__global__ void __launch_bounds__(kTiledThreads)
fir_bank_tiled(const float* __restrict__ xx, const float* __restrict__ taps,
               float* __restrict__ y, int L, int K, int n_out, int tiles) {
  using Vec = typename TapVec<NF>::type;
  constexpr int kW = TapVec<NF>::kW;
  extern __shared__ float4 smem4[];
  float* tap_f = reinterpret_cast<float*>(smem4);
  const Vec* tap_s = reinterpret_cast<const Vec*>(smem4);
  float* win = tap_f + tiled_tap_floats(K, kW);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * kTiledTile;
  const int cnt = min(kTiledTile, n_out - n0);
  const int valid = cnt + K - 1;        // window samples inside the row
  const int span = kTiledTile + K - 1;  // window samples the threads read

  // Window element k (row sample n0 + k) lives at win[off + k], where off
  // is the source's distance in floats past a 16-byte boundary.
  const float* src = xx + static_cast<long long>(b) * L + n0;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  const float* base = src - off;        // 16-byte aligned: win[j] = base[j]
  const int c_lo = (off + 3) >> 2;      // whole 16-byte chunks [c_lo, c_hi)
  const int c_hi = (off + valid) >> 2;
  for (int c = c_lo + tid; c < c_hi; c += kTiledThreads)
    cp_async16(win + 4 * c, base + 4 * c);
  asm volatile("cp.async.commit_group;\n" ::);
  const int head_end = min(4 * c_lo, off + valid);
  const int tail_start = max(4 * c_hi, head_end);
  const int n_head = head_end - off;    // <= 3 each
  const int n_tail = off + valid - tail_start;
  if (tid < n_head) {
    win[off + tid] = src[tid];
  } else if (tid < n_head + n_tail) {
    const int j = tail_start + tid - n_head;
    win[j] = base[j];
  }
  for (int j = off + valid + tid; j < off + span; j += kTiledThreads)
    win[j] = 0.f;                       // outputs past n_out read zeros
  for (int j = tid; j < K * kW; j += kTiledThreads) {
    const int m = j / kW, f = j - m * kW;
    tap_f[j] = f < NF ? __ldg(taps + f * K + m) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  float acc[kP][NF];
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[i][f] = 0.f;
  // Output i of this thread, at step m, reads window element
  // tid*kP + i + K-1 - m; xs[-s] is step s's new sample (output 0's).
  const float* xs = win + off + tid * kP + K - 1;
  float ring[kP];
#pragma unroll
  for (int i = 1; i < kP; ++i) ring[i] = xs[i];
  int m = 0;
  for (; m + kP <= K; m += kP) {
#pragma unroll
    for (int u = 0; u < kP; ++u) tiled_step<NF>(acc, ring, xs, tap_s, m + u, u);
  }
#pragma unroll
  for (int u = 0; u < kP - 1; ++u)
    if (m + u < K) tiled_step<NF>(acc, ring, xs, tap_s, m + u, u);

  // Through shared memory (the window is spent) so each row's stores
  // coalesce; lane t writes slots kP*t + i, an odd stride, conflict-free.
  float* out_s = win;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kP; ++i) out_s[tid * kP + i] = acc[i][f];
    __syncthreads();
    float* yr = y + (static_cast<long long>(b) * NF + f) * n_out + n0;
    for (int j = tid; j < cnt; j += kTiledThreads) yr[j] = out_s[j];
  }
}

// ----------------------------------------------------------------- launch --

template <int NF>
cudaError_t launch_tiled(const float* xx, const float* taps, float* y, int B,
                         int L, int K, int n_out, cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(n_out) + kTiledTile - 1) /
                          kTiledTile;
  if (tiles * B > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(tiled_tap_floats(K, TapVec<NF>::kW) +
                          tiled_win_floats(K)) * sizeof(float);
  const cudaError_t err = allow_smem(fir_bank_tiled<NF>, smem);
  if (err != cudaSuccess) return err;
  fir_bank_tiled<NF><<<static_cast<unsigned>(tiles * B), kTiledThreads, smem,
                       stream>>>(xx, taps, y, L, K, n_out,
                                 static_cast<int>(tiles));
  return cudaGetLastError();
}

template <int NF, int RT>
cudaError_t launch_general(const float* xx, const float* ptaps, float* y,
                           int B, int L, int up, int down, int T, int n_out,
                           int U, int ko, int gb, int nw, int ws, int span,
                           cudaStream_t stream) {
  GenShape s;
  s.L = L; s.up = up; s.down = down; s.T = T; s.n_out = n_out; s.U = U;
  s.ko = ko; s.gb = gb; s.ws = ws; s.span = span;
  s.nw = nw;
  s.lb = (nw / gb) * 32 * RT;
  const long long V = (static_cast<long long>(n_out) + U - 1) / U;
  const long long lines = V * B;
  const long long tiles = (U + gb * ko - 1) / (gb * ko);
  const long long units = (lines + s.lb - 1) / s.lb * tiles;
  if (lines > INT_MAX || units > INT_MAX) return cudaErrorInvalidValue;
  s.V = static_cast<int>(V);
  s.lines = static_cast<int>(lines);
  s.tiles = static_cast<int>(tiles);
  s.vs = static_cast<long long>(U) * down / up;
  s.narrow = static_cast<long long>(U) * down + up < (1LL << 31);
  const size_t smem = gen_buffer_floats(s.lb, gb, ws, span) * sizeof(float);
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};  // one table a kernel
  const cudaError_t err =
      allow_smem_shared(fir_bank_general<NF, RT>, smem, granted, kDevices);
  if (err != cudaSuccess) return err;
  fir_bank_general<NF, RT><<<static_cast<unsigned>(units), 32 * nw, smem,
                             stream>>>(xx, ptaps, y, s);
  return cudaGetLastError();
}

template <int NF, bool STAGED>
cudaError_t launch_direct(const float* xx, const float* ptaps, float* y,
                          int B, int L, int up, int down, int T, int n_out,
                          int bo, int rows, int ts, int ws,
                          cudaStream_t stream) {
  DirShape s;
  s.L = L; s.up = up; s.down = down; s.T = T; s.n_out = n_out; s.bo = bo;
  s.g = std::gcd(up, down); s.rows = rows; s.ts = ts; s.ws = ws;
  const long long tiles = (static_cast<long long>(n_out) + bo - 1) / bo;
  if (tiles * B > INT_MAX) return cudaErrorInvalidValue;
  s.tiles = static_cast<int>(tiles);
  s.narrow = static_cast<long long>(n_out) * down + up < (1LL << 31);
  const size_t smem =
      (static_cast<size_t>(ws) +
       (STAGED ? static_cast<size_t>(NF) * rows * ts : 0)) * sizeof(float);
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};  // one table a kernel
  const cudaError_t err = allow_smem_shared(fir_bank_direct<NF, STAGED>,
                                            smem, granted, kDevices);
  if (err != cudaSuccess) return err;
  fir_bank_direct<NF, STAGED><<<static_cast<unsigned>(tiles * B), bo, smem,
                                stream>>>(xx, ptaps, y, s);
  return cudaGetLastError();
}

template <int NF>
cudaError_t launch(const float* xx, const float* ptaps, float* y, int B,
                   int L, int K, int up, int down, int T, int n_out,
                   const int* plan, cudaStream_t stream) {
  if (up == 1 && down == 1)
    return launch_tiled<NF>(xx, ptaps, y, B, L, K, n_out, stream);
  // the plan (ops/cuda/fir_bank.py general_plan) must cover the windows
  // and tap rows or streams the kernel reads
  const long long P = up / std::gcd(up, down);
  if (plan[0] == 1) {  // direct: bo, rows, ts, ws, staged
    const int bo = plan[1], rows = plan[2], ts = plan[3], ws = plan[4];
    const bool staged = plan[5] != 0;
    const bool ok =
        (bo == 32 || bo == 64 || bo == 128) && ws % 4 == 0 &&
        ws >= gen_window_bound(bo, up, down, T) &&
        (!staged || (ts % 8 == 4 && ts >= T &&
                     (rows == P || (rows == bo && bo < P))));
    if (!ok) return cudaErrorInvalidValue;
    if (staged)
      return launch_direct<NF, true>(xx, ptaps, y, B, L, up, down, T, n_out,
                                     bo, rows, ts, ws, stream);
    return launch_direct<NF, false>(xx, ptaps, y, B, L, up, down, T, n_out,
                                    bo, 0, 0, ws, stream);
  }
  // lines: rt, U, ko, gb, nw, ws, span
  const int rt = plan[1], U = plan[2], ko = plan[3], gb = plan[4],
            nw = plan[5], ws = plan[6], span = plan[7];
  const bool ok =
      plan[0] == 0 && (rt == 1 || rt == 2) &&
      (nw == 1 || nw == 2 || nw == 4) && gb >= 1 && nw % gb == 0 &&
      ko >= 1 && ko <= GenKO<NF>::value && U >= 1 &&
      (U >= n_out || U % P == 0) && ws % 8 == 4 && span % 4 == 0 &&
      ws >= gen_window_bound(static_cast<long long>(gb) * ko, up, down, T) &&
      span >= gen_window_bound(ko, up, down, T);
  if (!ok) return cudaErrorInvalidValue;
  if (rt == 1)
    return launch_general<NF, 1>(xx, ptaps, y, B, L, up, down, T, n_out, U,
                                 ko, gb, nw, ws, span, stream);
  return launch_general<NF, 2>(xx, ptaps, y, B, L, up, down, T, n_out, U,
                               ko, gb, nw, ws, span, stream);
}

}  // namespace

// xx: (B, L) f32 rows, L = T-1 + n; ptaps: (nf, up, T) f32, the taps
// phase-major (ptaps[f][p][m] = taps[f][p + up*m], 0 past K; at up = 1 the
// taps as they are); y: (B, nf, n_out) f32; plan: the general body's tile,
// 8 ints (ops/cuda/fir_bank.py GeneralPlan / DirectPlan .as_ints(): 0, rt,
// U, ko, gb, nw, ws, span for the lines tile; 1, bo, rows, ts, ws, staged,
// 0, 0 for the direct one; not read at up = down = 1). Returns a cudaError_t (0 on success); launches on `stream`, no
// sync.
extern "C" int sdr_fir_bank(const float* xx, const float* ptaps, float* y,
                            int B, int L, int nf, int K, int up, int down,
                            int T, int n_out, const int* plan, void* stream) {
  if (B <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1:
      return launch<1>(xx, ptaps, y, B, L, K, up, down, T, n_out, plan, s);
    case 2:
      return launch<2>(xx, ptaps, y, B, L, K, up, down, T, n_out, plan, s);
    case 3:
      return launch<3>(xx, ptaps, y, B, L, K, up, down, T, n_out, plan, s);
    case 4:
      return launch<4>(xx, ptaps, y, B, L, K, up, down, T, n_out, plan, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* sdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
