// Sequential type-2 PLL + NCO (the receiver's tier-1 carrier loop): one
// thread walks one channel row.
//
// Replaces the `lax.scan` of real_time_sdr_tpu/ops/pll.py:111 (`pll_scan`,
// the scan at :129), which the JAX package compiles into one loop; it is not
// a Pallas kernel, and eager PyTorch has no counterpart (a loop over samples
// is ~10 launches per sample). Per sample, in the JAX package's order:
//
//     e      = atan2(x*(-fbq), x*fbi)
//     integ  = integ + ki*e
//     phase  = (phase + kp*e) + integ
//     trig   = (trig + 1) % period,  frac = (fr*trig) % (2*fsr)
//     arg    = (2*pi/fsr)*frac + phase
//     fbi, fbq = cos(arg), sin(arg)
//     nco    = cos(arg*nco_scale + phase_adjust)
//
// out[n] = nco of sample n-1 (out[0] = the carried last_nco); at the end
// the phase wraps once with remainder(phase, 4*pi) (floor semantics).
//
// What bounds it on the H100. Nothing but the recurrence's own latency: a
// sample's detector needs the previous sample's sin/cos, so each row is one
// dependent chain of atan2f -> three adds/multiplies -> sinf/cosf, about
// 800 cycles per sample on an H100 (2.96-2.99 ms per 7,350-sample block at
// 32 rows). Rows are independent, so the time is flat in the number of rows
// until the card's warps fill up; memory traffic (8 bytes per sample) is
// negligible.
//
// Design. One warp per block, one row per thread: rows never talk to each
// other, and a warp of 32 rows keeps the chain's latency the only cost. The
// (C, N) input and output pass through shared memory in chunks of kChunk
// samples per row, so global loads and stores coalesce along each row (a
// thread reading its own row directly would touch a new 128-byte line per
// sample per lane). The carry is read once and written once per launch.
//
// Bit-faithfulness to the plain version (torch elementwise ops on CUDA
// tensors): every product and sum is written __fmul_rn/__fadd_rn, so the
// compiler's default FMA contraction never fuses them (torch runs each as a
// separate kernel, unfused); the math functions are the accurate atan2f,
// sinf and cosf (no intrinsics, no fast math); the constants arrive as f32
// values rounded once on the host; the detector's products are formed
// literally, keeping the signed zeros of x == 0 (atan2f(-0, -0) = -pi).
// The ramp counter advances incrementally in int32 (frac += fr, wrapped at
// 2*fsr), which equals (fr*trig) % (2*fsr) exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;    // rows (threads) per block: one warp
constexpr int kChunk = 64;   // samples per row staged per step

__global__ void __launch_bounds__(kRows)
pll_scan_kernel(const float* __restrict__ x, long long ldx,
                float* __restrict__ out, int C, int N,
                const float* __restrict__ fbi0, const float* __restrict__ fbq0,
                const float* __restrict__ integ0,
                const float* __restrict__ phase0,
                const int* __restrict__ trig0,
                const float* __restrict__ last0,
                float* __restrict__ fbi1, float* __restrict__ fbq1,
                float* __restrict__ integ1, float* __restrict__ phase1,
                int* __restrict__ trig1, float* __restrict__ last1,
                float kp, float ki, int fr, int fsr, float ang_scale,
                float nco_scale, float phase_adjust, float four_pi) {
  __shared__ float buf[kRows][kChunk + 1];  // odd stride: no bank conflicts
  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long row = row0 + t;
  const bool live = row < C;
  const int period = 2 * fsr;

  float fbi = 1.f, fbq = 0.f, integ = 0.f, phase = 0.f, prev = 1.f;
  int trig = 0, frac = 0;
  if (live) {
    fbi = fbi0[row];
    fbq = fbq0[row];
    integ = integ0[row];
    phase = phase0[row];
    trig = trig0[row];
    prev = last0[row];
    frac = static_cast<int>((static_cast<long long>(fr) * trig) % period);
  }

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int cnt = min(kChunk, N - n0);
    // coalesced load: consecutive lanes read consecutive samples of a row
    for (int i = t; i < kRows * kChunk; i += kRows) {
      const int r = i / kChunk, k = i % kChunk;
      if (row0 + r < C && k < cnt) buf[r][k] = x[(row0 + r) * ldx + n0 + k];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < cnt; ++k) {
        const float xk = buf[t][k];
        const float e = atan2f(__fmul_rn(xk, -fbq), __fmul_rn(xk, fbi));
        integ = __fadd_rn(integ, __fmul_rn(ki, e));
        phase = __fadd_rn(__fadd_rn(phase, __fmul_rn(kp, e)), integ);
        if (++trig == period) trig = 0;
        frac += fr;
        if (frac >= period) frac -= period;
        const float arg =
            __fadd_rn(__fmul_rn(ang_scale, static_cast<float>(frac)), phase);
        fbi = cosf(arg);
        fbq = sinf(arg);
        buf[t][k] = prev;  // the consumer sees the NCO one sample late
        prev = cosf(__fadd_rn(__fmul_rn(arg, nco_scale), phase_adjust));
      }
    }
    __syncthreads();
    for (int i = t; i < kRows * kChunk; i += kRows) {
      const int r = i / kChunk, k = i % kChunk;
      if (row0 + r < C && k < cnt)
        out[(row0 + r) * static_cast<long long>(N) + n0 + k] = buf[r][k];
    }
    __syncthreads();
  }

  if (live) {
    // torch.remainder / jnp.mod: fmod, then shift into the divisor's sign
    float ph = fmodf(phase, four_pi);
    if (ph != 0.f && ((ph < 0.f) != (four_pi < 0.f)))
      ph = __fadd_rn(ph, four_pi);
    fbi1[row] = fbi;
    fbq1[row] = fbq;
    integ1[row] = integ;
    phase1[row] = ph;
    trig1[row] = trig;
    last1[row] = prev;
  }
}

}  // namespace

// x: (C, N) f32 rows with row stride ldx (floats); out: (C, N) f32
// contiguous; carry in (*0) and out (*1): (C,) f32, trig (C,) int32.
// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int sdr_pll_scan(const float* x, long long ldx, float* out, int C,
                            int N, const float* fbi0, const float* fbq0,
                            const float* integ0, const float* phase0,
                            const int* trig0, const float* last0, float* fbi1,
                            float* fbq1, float* integ1, float* phase1,
                            int* trig1, float* last1, float kp, float ki,
                            int fr, int fsr, float ang_scale, float nco_scale,
                            float phase_adjust, float four_pi, void* stream) {
  if (C <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((C + kRows - 1) / kRows);
  pll_scan_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ldx, out, C, N, fbi0, fbq0, integ0, phase0, trig0, last0, fbi1, fbq1,
      integ1, phase1, trig1, last1, kp, ki, fr, fsr, ang_scale, nco_scale,
      phase_adjust, four_pi);
  return static_cast<int>(cudaGetLastError());
}
