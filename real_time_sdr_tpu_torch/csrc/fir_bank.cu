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
// instruction issue. The first form of this kernel (now the general body)
// issued, per tap, one shared load of the input, nf read-only-cache tap
// loads and the address and loop arithmetic of a runtime trip count for nf
// FFMAs: at best one FFMA in 2.5 instructions at nf 3, one in 4 at nf 1. At
// the five up = down = 1 sites that came to 3.05 G MACs in 0.737 ms, 8.3
// TFLOP/s, 12 % of the 67 TFLOP/s f32 FMA rate, and slower than the framed
// SGEMM (0.595 ms) in spite of its 2.26x redundant work (NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// Two bodies; the geometry alone picks one (ops/cuda/fir_bank.py
// `kernel_body` names the same rule for the launch counts):
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
// - General, any other up/down (audio rails 1/5, RDS 247/640, the wideband
//   channelizer's 1/decim bank): one block covers kTile consecutive outputs
//   of one row, stages its input window (at most ceil((kTile-1)*down/up) + T
//   samples) in shared memory, and each thread computes one output for all
//   nf filters, reusing each loaded input sample nf times. Its taps come
//   through the read-only cache: the 247/640 bank's 24,947 taps (100 KB) do
//   not belong in shared memory beside the window. It already beats the
//   framed SGEMM where it decimates, since the SGEMM computes every output
//   of the up-rate frame.
//
// Both bodies put (row, tile) on a flat gridDim.x, so any row count runs.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- general --

constexpr int kTile = 256;     // outputs per block
constexpr int kThreads = 256;  // threads per block

template <int NF>
__global__ void __launch_bounds__(kThreads)
fir_bank_general(const float* __restrict__ xx, const float* __restrict__ taps,
                 float* __restrict__ y, int L, int K, int up, int down, int T,
                 int n_out, int tiles) {
  extern __shared__ float win[];
  const int b = blockIdx.x / tiles;
  const long long n0 = static_cast<long long>(blockIdx.x % tiles) * kTile;
  const int cnt = static_cast<int>(
      min(static_cast<long long>(kTile), static_cast<long long>(n_out) - n0));
  const long long q0 = (n0 * down) / up;
  const long long q_last = ((n0 + cnt - 1) * down) / up;
  const int wlen = static_cast<int>(q_last - q0) + T;
  const float* row = xx + static_cast<long long>(b) * L + q0;
  for (int j = threadIdx.x; j < wlen; j += blockDim.x) win[j] = row[j];
  __syncthreads();

  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const long long nd = (n0 + t) * static_cast<long long>(down);
    const int q = static_cast<int>(nd / up - q0);
    const int p = static_cast<int>(nd % up);
    const int m_count = p < K ? (K - 1 - p) / up + 1 : 0;
    float acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = 0.f;
    const float* xw = win + q + T - 1;
    const float* hp = taps + p;
    for (int m = 0; m < m_count; ++m) {
      const float xv = xw[-m];
      const int tap = up * m;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f] = fmaf(__ldg(hp + f * K + tap), xv, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
      y[(static_cast<long long>(b) * NF + f) * n_out + n0 + t] = acc[f];
  }
}

// ------------------------------------------------------------------ tiled --

constexpr int kP = 9;                           // outputs per thread, odd
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
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

template <int NF>
cudaError_t launch(const float* xx, const float* taps, float* y, int B, int L,
                   int K, int up, int down, int T, int n_out,
                   cudaStream_t stream) {
  const bool tiled = up == 1 && down == 1;
  const int tile = tiled ? kTiledTile : kTile;
  const long long tiles = (static_cast<long long>(n_out) + tile - 1) / tile;
  if (tiles * B > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(tiles * B);
  if (tiled) {
    const size_t smem =
        static_cast<size_t>(tiled_tap_floats(K, TapVec<NF>::kW) +
                            tiled_win_floats(K)) * sizeof(float);
    const cudaError_t err = allow_smem(fir_bank_tiled<NF>, smem);
    if (err != cudaSuccess) return err;
    fir_bank_tiled<NF><<<grid, kTiledThreads, smem, stream>>>(
        xx, taps, y, L, K, n_out, static_cast<int>(tiles));
  } else {
    const long long span =
        (static_cast<long long>(kTile - 1) * down + up - 1) / up + T;
    const size_t smem = static_cast<size_t>(span) * sizeof(float);
    const cudaError_t err = allow_smem(fir_bank_general<NF>, smem);
    if (err != cudaSuccess) return err;
    fir_bank_general<NF><<<grid, kThreads, smem, stream>>>(
        xx, taps, y, L, K, up, down, T, n_out, static_cast<int>(tiles));
  }
  return cudaGetLastError();
}

}  // namespace

// xx: (B, L) f32 rows, L = T-1 + n; taps: (nf, K) f32; y: (B, nf, n_out) f32.
// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int sdr_fir_bank(const float* xx, const float* taps, float* y,
                            int B, int L, int nf, int K, int up, int down,
                            int T, int n_out, void* stream) {
  if (B <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 1: return launch<1>(xx, taps, y, B, L, K, up, down, T, n_out, s);
    case 2: return launch<2>(xx, taps, y, B, L, K, up, down, T, n_out, s);
    case 3: return launch<3>(xx, taps, y, B, L, K, up, down, T, n_out, s);
    case 4: return launch<4>(xx, taps, y, B, L, K, up, down, T, n_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* sdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
