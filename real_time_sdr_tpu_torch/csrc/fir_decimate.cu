// Direct-form streaming FIR with decimation: one filter, K multiply-adds
// per output.
//
// Replaces the TPU kernel `_kernel` of
// real_time_sdr_tpu/ops/pallas/fir_kernels.py (launched by
// fir_decimate_planes). Over the tail-prefixed rows xx (C, K-1 + N):
//
//     y[c, n] = sum_{k=0}^{K-1} h[k] * xx[c, n*down + K-1-k],   n < N/down
//
// The TPU kernel split the input into `down` polyphase planes on the host,
// baked each window's halo into the block layout (BlockSpecs cannot
// overlap) and unrolled the K taps over lane-aligned plane slices. None of
// that is needed here: a block reads its overlapping window straight from
// the row, so `down` need not divide K-1.
//
// On the receive path it is the audio resampler of the rate modes that do
// not upsample (K 101 at down 5 and down 9; models/audio.py), both audio
// rails stacked as rows.
//
// What bounds it on the H100. Each output costs K FMAs; the input is read
// from HBM about once (window overlap (K-1)/(tile*down)). At 64 rows x
// 88,200, K 101, down 5 that is 27 MB (0.008 ms at 3.35 TB/s) against 228
// MFLOP (0.0034 ms at 67 TFLOP/s): bytes bound it. The first form of this
// kernel (now the general body) computed one output per thread and made
// two shared-memory loads per FMA, the tap and the sample: its 7.1 M
// warp-wide loads, at one per cycle per SM, are 0.027 of its measured 0.030
// ms (NVIDIA H100 80GB HBM3, 700.00 W). The shared-memory load pipe, not
// HBM, held it at 27 % of its bound.
//
// Two bodies; (K, down) alone picks one (ops/cuda/fir_kernels.py
// `kernel_body` names the same rule for the launch counts):
//
// - Static, at the receiver's two geometries (K 101, down 5 and down 9).
//   Each thread computes kR consecutive outputs of one row. Output i reads,
//   at tap k, window sample i*down + K-1-k: what output i-1 read `down`
//   taps earlier. So the thread keeps `down` rings of kR samples in
//   registers; tap k shifts ring k mod down by one output and loads ONE new
//   sample (output 0's), for kR FMAs. With K and down compile-time
//   constants the tap loop is fully unrolled and the shift is register
//   renaming. The taps sit in shared memory and come as one broadcast
//   16-byte load per four taps. Per output that is (6*down + K) / 7 sample
//   loads and K / 28 tap loads for K FMAs: 0.22 loads per FMA at down 5,
//   0.25 at down 9, against 2. kR is odd, so lane t's samples start
//   kR*down*t floats apart, an odd stride at the odd factors here: one
//   warp's sample load touches 32 banks. The sum keeps k ascending with one
//   fmaf per tap: bit-identical to the general body and to the FIR bank's
//   general body at up = 1 (csrc/fir_bank.cu). A block stages its window
//   ((tile-1)*down + K samples, 18 KB at down 5, 33 KB at down 9, so four or
//   more blocks share an SM and one block's staging overlaps another's
//   FMAs) with 16-byte cp.async copies from the 16-byte boundary at or
//   below the row start (rows start at c*L floats, not aligned in general),
//   the ragged ends with scalar loads, and zeroes what lies past the row
//   end. Outputs go back through shared memory so the stores coalesce.
//   The tile shape hardly matters: kR 7-13 at 64-256 threads gave
//   0.0155-0.0178 ms at down 5 and 0.0230-0.0254 at down 9 (64 rows, 17,640
//   outputs each; same card), kR 7 x 128 threads the least at both. What is
//   left over the 0.008 ms of HBM time is the launch, each block's
//   stage-then-compute prologue and the grid's tail.
//
// - General, every other (K, down): one block covers kTile consecutive
//   outputs of one row, stages the K taps and its window in shared memory,
//   and each thread accumulates one output over k = 0..K-1.
//
// Both bodies put (row, tile) on a flat gridDim.x, so any row count runs.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- general --

constexpr int kTile = 256;     // outputs per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
fir_decimate_general(const float* __restrict__ xx, const float* __restrict__ h,
                     float* __restrict__ y, int L, int K, int down, int n_out,
                     int tiles) {
  extern __shared__ float smem[];
  float* taps = smem;
  float* win = smem + K;
  const int c = blockIdx.x / tiles;
  const long long n0 = static_cast<long long>(blockIdx.x % tiles) * kTile;
  const int cnt = static_cast<int>(
      min(static_cast<long long>(kTile), static_cast<long long>(n_out) - n0));
  const int wlen = (cnt - 1) * down + K;
  const float* row = xx + static_cast<long long>(c) * L + n0 * down;
  for (int k = threadIdx.x; k < K; k += blockDim.x) taps[k] = h[k];
  for (int j = threadIdx.x; j < wlen; j += blockDim.x) win[j] = row[j];
  __syncthreads();

  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const float* xw = win + t * down + K - 1;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(taps[k], xw[-k], acc);
    y[static_cast<long long>(c) * n_out + n0 + t] = acc;
  }
}

// ----------------------------------------------------------------- static --

constexpr int kR = 7;                            // outputs per thread, odd
constexpr int kStaticThreads = 128;              // threads per block
constexpr int kStaticTile = kR * kStaticThreads; // outputs per block: 896

// Floats of the tap table: K rounded up to whole float4s (zero padded), so
// the window after it is 16-byte aligned for cp.async.
__host__ __device__ constexpr int static_tap_floats(int K) {
  return (K + 3) & ~3;
}

// Floats of the window: up to 3 floats of alignment slack, then
// (kStaticTile-1)*down + K samples, rounded up to whole 16-byte chunks.
__host__ __device__ constexpr int static_win_floats(int K, int down) {
  return (3 + (kStaticTile - 1) * down + K + 3) & ~3;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int K, int DOWN>
__global__ void __launch_bounds__(kStaticThreads, 4)
fir_decimate_static(const float* __restrict__ xx, const float* __restrict__ h,
                    float* __restrict__ y, int L, int n_out, int tiles) {
  static_assert(K >= DOWN, "the rings fill over the first DOWN taps");
  extern __shared__ float4 smem4[];
  float* tap_f = reinterpret_cast<float*>(smem4);
  float* win = tap_f + static_tap_floats(K);
  const int tid = threadIdx.x;
  const int c = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * kStaticTile;
  const int cnt = min(kStaticTile, n_out - n0);
  const int valid = (cnt - 1) * DOWN + K;         // window samples in the row
  constexpr int span = (kStaticTile - 1) * DOWN + K;  // samples threads read

  // Window element j (row sample n0*DOWN + j) lives at win[off + j], where
  // off is the source's distance in floats past a 16-byte boundary.
  const float* src = xx + static_cast<long long>(c) * L +
                     static_cast<long long>(n0) * DOWN;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  const float* base = src - off;        // 16-byte aligned: win[j] = base[j]
  const int c_lo = (off + 3) >> 2;      // whole 16-byte chunks [c_lo, c_hi)
  const int c_hi = (off + valid) >> 2;
  for (int q = c_lo + tid; q < c_hi; q += kStaticThreads)
    cp_async16(win + 4 * q, base + 4 * q);
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
  for (int j = off + valid + tid; j < off + span; j += kStaticThreads)
    win[j] = 0.f;                       // outputs past n_out read zeros
  for (int j = tid; j < static_tap_floats(K); j += kStaticThreads)
    tap_f[j] = j < K ? __ldg(h + j) : 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;
  if (tid * kR < cnt) {
    // Output i of this thread, at tap k, reads xs[i*DOWN - k].
    const float* xs = win + off + tid * (kR * DOWN) + K - 1;
    float ring[DOWN][kR];
#pragma unroll
    for (int kq = 0; kq < static_tap_floats(K) / 4; ++kq) {
      const float4 hv = smem4[kq];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * kq + u;
        if (k < K) {
          const int r = k % DOWN;
          if (k < DOWN) {
#pragma unroll
            for (int i = 0; i < kR; ++i) ring[r][i] = xs[i * DOWN - k];
          } else {
#pragma unroll
            for (int i = kR - 1; i > 0; --i) ring[r][i] = ring[r][i - 1];
            ring[r][0] = xs[-k];
          }
          const float hk = lane_of(hv, u);
#pragma unroll
          for (int i = 0; i < kR; ++i) acc[i] = fmaf(hk, ring[r][i], acc[i]);
        }
      }
    }
  }

  // Through shared memory (the window is spent) so the row's stores
  // coalesce; lane t writes slots kR*t + i, an odd stride, conflict-free.
  __syncthreads();
  float* out_s = win;
#pragma unroll
  for (int i = 0; i < kR; ++i) out_s[tid * kR + i] = acc[i];
  __syncthreads();
  float* yr = y + static_cast<long long>(c) * n_out + n0;
  for (int j = tid; j < cnt; j += kStaticThreads) yr[j] = out_s[j];
}

// ----------------------------------------------------------------- launch --

bool is_static(int K, int down) { return K == 101 && (down == 5 || down == 9); }

long long smem_bytes(int K, int down) {
  if (is_static(K, down))
    return static_cast<long long>(static_tap_floats(K) +
                                  static_win_floats(K, down)) * sizeof(float);
  return (2LL * K + static_cast<long long>(kTile - 1) * down) * sizeof(float);
}

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

template <int K, int DOWN>
cudaError_t launch_static(const float* xx, const float* h, float* y, int L,
                          unsigned grid, int n_out, int tiles, size_t smem,
                          cudaStream_t stream) {
  const cudaError_t err = allow_smem(fir_decimate_static<K, DOWN>, smem);
  if (err != cudaSuccess) return err;
  fir_decimate_static<K, DOWN><<<grid, kStaticThreads, smem, stream>>>(
      xx, h, y, L, n_out, tiles);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper checks it against
// the card's 227 KB limit before launching).
extern "C" long long sdr_fir_decimate_smem(int K, int down) {
  return smem_bytes(K, down);
}

// xx: (C, L) f32 rows, L = K-1 + N; h: (K,) f32; y: (C, n_out) f32 with
// n_out = N/down. Returns a cudaError_t (0 on success); launches on
// `stream`, no sync.
extern "C" int sdr_fir_decimate(const float* xx, const float* h, float* y,
                                int C, int L, int K, int down, int n_out,
                                void* stream) {
  if (C <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fixed = is_static(K, down);
  const int tile = fixed ? kStaticTile : kTile;
  const long long tiles = (static_cast<long long>(n_out) + tile - 1) / tile;
  if (tiles * C > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(tiles * C);
  const size_t smem = static_cast<size_t>(smem_bytes(K, down));
  const int nt = static_cast<int>(tiles);
  if (fixed && down == 5)
    return static_cast<int>(
        launch_static<101, 5>(xx, h, y, L, grid, n_out, nt, smem, s));
  if (fixed)
    return static_cast<int>(
        launch_static<101, 9>(xx, h, y, L, grid, n_out, nt, smem, s));
  const cudaError_t err = allow_smem(fir_decimate_general, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fir_decimate_general<<<grid, kThreads, smem, s>>>(xx, h, y, L, K, down,
                                                    n_out, nt);
  return static_cast<int>(cudaGetLastError());
}
