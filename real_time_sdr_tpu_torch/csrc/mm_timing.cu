// Mueller–Muller symbol-timing recovery (the alternative RDS receiver's
// timing loop): one thread walks the stream, symbol by symbol, out of a
// tile of the input that the other threads of its block stage in shared
// memory.
//
// Replaces the `lax.while_loop` of real_time_sdr_tpu/ops/symbol_timing.py:67
// (`mm_timing`, the loop at :104), which the JAX package compiles into one
// loop; it is not a Pallas kernel, and eager PyTorch has no counterpart (a
// loop over symbols is ~40 launches and a host round trip per symbol). Per
// symbol, in the plain version's order (ops/symbol_timing.py
// `mm_timing_plain`), with (i, mu) the integer and fractional position:
//
//     w0   = 1 - mu
//     cur  = z[i]*w0 + z[i+1]*mu                      (re and im)
//     rail = (Re cur > 0, Im cur > 0)
//     err  = Re((cur - out2) conj(rail1)) - Re((rail - rail2) conj(out1))
//     mu   = (mu + sps) + gain*err;  i += floor(mu);  mu -= floor(mu)
//     out[k++] = cur
//
// while i < n-2 and k < n_max; i is clamped to [0, n-2] where the sample
// pair is read (the JAX package's dynamic_slice), and (i, mu) start at
// (floor(mu0), mu0 - floor(mu0)).
//
// What bounds it on the H100. Neither bytes (8 per input sample, 8 per
// symbol) nor arithmetic: each symbol's position depends on the previous
// symbol's error, so the walk is one dependent chain, ~1,190 steps per
// second of radio, and its time is the number of symbols times the latency
// of one step: the chain mu -> w0 -> cur -> rail -> err -> mu -> floor ->
// mu counts 12 dependent f32 operations (MM_CHAIN_OPS in
// ops/cuda/mm_timing.py), and the next sample pair's shared-memory load
// waits on floor(mu)'s integer. The rest of the card idles: one stream is
// one block.
//
// Design. Every f32 operation is separately rounded (__fmul_rn, __fadd_rn,
// __fsub_rn), as the plain version's elementwise operations are: no
// contraction into an FMA may move a floor(mu) decision, so the kernel is
// meant to be bit-identical to the plain version on the card. The walker
// (thread 0) reads sample pairs from a shared tile of kTile + 1 samples
// starting at `base`; warps 1..7 stage the next tile (base + kTile) in the
// other buffer while it walks, so the walker never waits on device memory
// except when it jumps out of the predicted tile (then every thread loads
// the tile it needs). One barrier per tile hands the buffers over. The
// walker stores each symbol to device memory as it goes (one 8-byte store
// per ~16 samples) and writes n_valid at the end; the wrapper zeroes the
// symbol buffer first.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;       // samples per tile (a pair may straddle:
                                  // the tile holds kTile + 1)
constexpr int kThreads = 256;     // warp 0: the walker (lane 0); 1..7 load

__device__ __forceinline__ void load_tile(float2* dst, const float2* z,
                                          int n, int base, int first,
                                          int stride) {
  for (int j = first; j <= kTile; j += stride) {
    const int src = base + j;
    dst[j] = src < n ? z[src] : make_float2(0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
mm_timing_kernel(const float2* __restrict__ z, int n, int n_max,
                 const float* __restrict__ mu0p, float sps, float gain,
                 float2* __restrict__ out, int* __restrict__ n_valid) {
  __shared__ float2 tile[2][kTile + 1];
  // the walker's next pair index, -1 when done; by the parity of the
  // hand-over, so the walker never overwrites a value a thread may still
  // be reading
  __shared__ int s_next[2];
  const int tid = threadIdx.x;
  const int last = n - 2;  // the largest pair index

  // walker state (thread 0 only)
  int i_in = 0, i_out = 0;
  float mu = 0.f;
  float o1r = 0.f, o1i = 0.f, o2r = 0.f, o2i = 0.f;
  float r1r = 0.f, r1i = 0.f, r2r = 0.f, r2i = 0.f;
  if (tid == 0) {
    const float m0 = *mu0p;
    const float f = floorf(m0);
    i_in = static_cast<int>(f);
    mu = __fsub_rn(m0, f);
    s_next[0] = (i_in < last && n_max > 0) ? max(i_in, 0) : -1;
  }
  __syncthreads();
  int base = s_next[0];
  if (base < 0) {
    if (tid == 0) *n_valid = 0;
    return;
  }
  int cur = 0, parity = 0;
  load_tile(tile[cur], z, n, base, tid, kThreads);
  __syncthreads();

  while (true) {
    parity ^= 1;
    if (tid >= 32) {
      // the predicted next tile, into the buffer the walker does not read
      load_tile(tile[cur ^ 1], z, n, base + kTile, tid - 32, kThreads - 32);
    } else if (tid == 0) {
      const float2* t = tile[cur];
      int next = -1;
      while (i_in < last && i_out < n_max) {
        const int i = max(i_in, 0);   // i_in < last: the upper clamp holds
        if (i < base || i >= base + kTile) {
          next = i;
          break;
        }
        const float2 a = t[i - base], b = t[i - base + 1];
        const float w0 = __fsub_rn(1.f, mu);
        const float cr = __fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, mu));
        const float ci = __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, mu));
        const float rcr = cr > 0.f ? 1.f : 0.f;
        const float rci = ci > 0.f ? 1.f : 0.f;
        const float xr = __fadd_rn(__fmul_rn(__fsub_rn(rcr, r2r), o1r),
                                   __fmul_rn(__fsub_rn(rci, r2i), o1i));
        const float yr = __fadd_rn(__fmul_rn(__fsub_rn(cr, o2r), r1r),
                                   __fmul_rn(__fsub_rn(ci, o2i), r1i));
        const float err = __fsub_rn(yr, xr);
        mu = __fadd_rn(__fadd_rn(mu, sps), __fmul_rn(gain, err));
        const float adv = floorf(mu);
        i_in += static_cast<int>(adv);
        mu = __fsub_rn(mu, adv);
        out[i_out++] = make_float2(cr, ci);
        o2r = o1r; o2i = o1i; o1r = cr; o1i = ci;
        r2r = r1r; r2i = r1i; r1r = rcr; r1i = rci;
      }
      s_next[parity] = next;
    }
    __syncthreads();
    const int next = s_next[parity];
    if (next < 0) break;
    if (next >= base + kTile && next < base + 2 * kTile) {
      base += kTile;              // the prefetched tile holds the pair
      cur ^= 1;
    } else {                      // a jump out of the predicted tile
      base = next;
      load_tile(tile[cur], z, n, base, tid, kThreads);
      __syncthreads();
    }
  }
  if (tid == 0) *n_valid = i_out;
}

}  // namespace

// z: (n,) complex64 as float2; out: (n_max,) complex64, zeroed by the
// caller; mu0: a device f32; n_valid: a device int32. Launches one block
// on `stream`, no sync; returns a cudaError_t (0 on success).
extern "C" int sdr_mm_timing(const void* z, int n, int n_max,
                             const float* mu0, float sps, float gain,
                             void* out, int* n_valid, void* stream) {
  if (n < 2 || n_max < 0 || n > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  mm_timing_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(z), n, n_max, mu0, sps, gain,
      static_cast<float2*>(out), n_valid);
  return static_cast<int>(cudaGetLastError());
}
