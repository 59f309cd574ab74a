// Sequential type-2 PLL + NCO (the receiver's tier-1 carrier loop): one
// thread walks one channel row, and everything that is not the recurrence
// is done by other threads.
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
// What bounds it on the H100. Neither bytes (8 per sample) nor arithmetic:
// a sample's detector needs the previous sample's phase, so each row is one
// dependent chain through all N samples, and the time of a call is N times
// the latency of one step of that chain, whatever the number of rows, until
// the card's warp slots fill. The first form of this kernel kept the
// literal chain atan2f -> adds -> sinf, cosf on the recurrence, about 800
// cycles per sample, with the NCO's cosf, the ramp and the loads and stores
// in the same thread and 32 rows in one warp of one block.
//
// Design.
//
// 1. The recurrence without transcendentals. x is real, so the detector
//    atan2(x*(-sin arg), x*cos arg) is the angle -arg for x > 0 and
//    pi - arg for x < 0, taken into [-pi, pi]: it uses only the sign of x.
//    One step of the chain is
//
//        r = (x < 0 ? pi : 0) - arg
//        k = rint(r / (2*pi))            (one FMA against 1.5*2^23, one add)
//        e = (r - k*2pi_hi) - k*2pi_lo   (two FMAs: an exact reduction)
//        e = e <= -pi ? e + 2*pi : e
//        integ = integ + ki*e;  phase = (phase + kp*e) + integ
//        arg = ramp[n] + phase
//
//    eleven dependent f32 operations. ki*e, kp*e and the three sums stay
//    separately rounded (__fmul_rn/__fadd_rn), as the plain version's
//    elementwise ops round them, so the state follows the plain version as
//    closely as the detector allows: the wrapped e is the exact reduction
//    of -arg, where the literal one carries the rounding of sinf, cosf and
//    atan2f (a few 1e-8), so the two carriers agree to 110-140 dB and not
//    bit for bit. cos(arg) and sin(arg) are needed only for the carry,
//    once, after the last sample.
//    A sample that is zero or not finite takes the literal detector
//    (sinf/cosf of the previous arg, the two products formed literally,
//    atan2f), so signed zeros (atan2f(-0, -0) = -pi), +-pi and NaN
//    propagate exactly as in the plain version; so does the first sample
//    of a call, whose feedback is the carried (fbi, fbq) and not an angle.
//    Silence (all x == 0) therefore runs at the literal chain's speed.
// 2. Everything else off the chain. A row has two warps: lane 0 of one
//    walks the chain, the other, its helper, works a chunk ahead of it and
//    a chunk behind it.
//    Ahead: it loads the row's next kChunk samples (coalesced) into shared
//    memory with their detector offsets (x < 0 ? pi : 0), computes the ramp
//    (2*pi/fsr)*frac for them, an int32 counter per lane advanced by 32
//    samples per step and equal to (fr*trig) % (2*fsr) exactly, and marks
//    by one ballot per 32 samples which of them need the literal detector.
//    The chain thread takes a group of 32 without one through an unrolled,
//    branch-free body whose offsets and ramp angles it has read into
//    registers first (16-byte loads), so no shared-memory latency stands
//    on the chain.
//    Behind: it reads the arg values the chain thread left in shared
//    memory, evaluates the NCO cos(arg*nco_scale + phase_adjust) with the
//    accurate cosf and stores it one sample late, coalesced.
//    The buffers are double: one barrier per kChunk samples hands them
//    over, and the helper has always arrived first. It is a named barrier
//    of the row's two warps only, so a row that runs the literal chain
//    (silence) never holds up the other rows of its block.
// 3. Rows spread over the card: kRows rows per block, warps 0..kRows-1 the
//    chains and kRows..2*kRows-1 their helpers, so the chain warps of the
//    blocks resident on an SM fall on all four of its schedulers (with one
//    row per block they fell on two, and 1,000 rows ran 37 % slower than
//    32). 32 rows run on 8 SMs, about 24 rows share an SM before rows
//    queue (the chains of several rows interleave in a scheduler at little
//    cost to each other), and any C up to 2^31-1 runs, in waves.
//
// The constants arrive as f32 values rounded once on the host.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 256;   // samples staged per hand-over
constexpr int kGroups = kChunk / 32;
constexpr int kRows = 4;      // rows per block
constexpr int kThreads = 64 * kRows;  // warps 0..kRows-1: the chains (lane
                                      // 0 of each); the others: helpers

constexpr float kPi = 3.14159274101257324f;        // float32(pi)
constexpr float kTwoPiHi = 6.2831854820251465f;    // float32(2*pi)
constexpr float kTwoPiLo = -1.7484555314695172e-07f;  // 2*pi - kTwoPiHi
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kRound = 12582912.f;  // 1.5 * 2^23: (x + kRound) - kRound
                                      // = rint(x)

// The phase detector for real, finite, non-zero x (see 1. above);
// offset = (x < 0 ? pi : 0).
__device__ __forceinline__ float wrapped_detector(float offset, float arg) {
  const float r = __fsub_rn(offset, arg);
  const float k = __fsub_rn(__fmaf_rn(r, kInvTwoPi, kRound), kRound);
  float e = __fmaf_rn(-k, kTwoPiHi, r);
  e = __fmaf_rn(-k, kTwoPiLo, e);
  return e <= -kPi ? __fadd_rn(e, kTwoPiHi) : e;
}

// The loop filter and the oscillator's angle: e -> (integ, phase, arg).
__device__ __forceinline__ void advance(float e, float ramp, float kp,
                                        float ki, float& integ, float& phase,
                                        float& arg) {
  integ = __fadd_rn(integ, __fmul_rn(ki, e));
  phase = __fadd_rn(__fadd_rn(phase, __fmul_rn(kp, e)), integ);
  arg = __fadd_rn(ramp, phase);
}

// Barrier of one row's chain and helper warps (ids 1..kRows; 0 is the
// block's own).
__device__ __forceinline__ void pair_sync(int row_in_block) {
  asm volatile("bar.sync %0, 64;" ::"r"(row_in_block + 1) : "memory");
}

__global__ void __launch_bounds__(kThreads)
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
  // per row of the block, double-buffered by chunk parity:
  __shared__ float xs_[kRows][2][kChunk];  // samples, a chunk ahead
  __shared__ __align__(16) float os_[kRows][2][kChunk];  // detector offsets
  __shared__ __align__(16) float rs_[kRows][2][kChunk];  // ramp angles
  __shared__ float as_[kRows][2][kChunk];  // arg, for the NCO a chunk behind
  __shared__ unsigned lit_[kRows][2][kGroups];  // bit k: sample 32*g + k is
                                                // literal
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) % kRows;     // row of the block
  const bool helper = threadIdx.x >= 32 * kRows;
  const bool chain = !helper && lane == 0;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + w;
  if (row >= C) return;                         // both warps of the row
  float (*xs)[kChunk] = xs_[w];
  float (*os)[kChunk] = os_[w];
  float (*rs)[kChunk] = rs_[w];
  float (*as)[kChunk] = as_[w];
  unsigned (*lit)[kGroups] = lit_[w];
  const int period = 2 * fsr;
  const int chunks = (N + kChunk - 1) / kChunk;
  const float* xrow = x + row * ldx;
  float* orow = out + row * static_cast<long long>(N);

  float arg = 0.f, integ = 0.f, phase = 0.f;   // the chain thread's state
  int frac = 0, frac_step = 0;                 // the helper lanes' counter
  if (chain) {
    integ = integ0[row];
    phase = phase0[row];
  }
  if (helper) {
    // sample n has counter (trig0 + n + 1) % period; lane l starts at n = l
    const long long t =
        (static_cast<long long>(trig0[row]) + lane + 1) % period;
    frac = static_cast<int>((fr * t) % period);
    frac_step = static_cast<int>((32LL * fr) % period);
    if (lane == 0) orow[0] = last0[row];
  }

  // Step j: the helper stages chunk j and emits chunk j-2 while the chain
  // thread runs chunk j-1; buffers alternate by chunk parity.
  for (int j = 0; j <= chunks + 1; ++j) {
    if (helper) {
      if (j < chunks) {
        const int b = j & 1;
        const int n0 = j * kChunk;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const int n = n0 + 32 * g + lane;
          const float v = n < N ? xrow[n] : 1.f;
          const bool literal =
              n < N && (n == 0 || !(v != 0.f && fabsf(v) < CUDART_INF_F));
          const unsigned bits = __ballot_sync(0xffffffffu, literal);
          xs[b][32 * g + lane] = v;
          os[b][32 * g + lane] = v < 0.f ? kPi : 0.f;
          rs[b][32 * g + lane] =
              __fmul_rn(ang_scale, static_cast<float>(frac));
          if (lane == 0) lit[b][g] = bits;
          frac += frac_step;
          if (frac >= period) frac -= period;
        }
      }
      if (j >= 2) {
        const int b = j & 1;
        const int n0 = (j - 2) * kChunk;
        const int cnt = min(kChunk, N - n0);
        for (int k = lane; k < cnt; k += 32) {
          const float nco = cosf(
              __fadd_rn(__fmul_rn(as[b][k], nco_scale), phase_adjust));
          if (n0 + k + 1 < N) orow[n0 + k + 1] = nco;
        }
      }
    } else if (chain && j >= 1 && j <= chunks) {
      const int b = (j - 1) & 1;
      const int n0 = (j - 1) * kChunk;
      const int cnt = min(kChunk, N - n0);
      for (int g = 0; 32 * g < cnt; ++g) {
        const int k0 = 32 * g;
        const unsigned bits = lit[b][g];
        if (bits == 0u && k0 + 32 <= cnt) {
          float4 o4[8], r4[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            o4[q] = reinterpret_cast<const float4*>(&os[b][k0])[q];
            r4[q] = reinterpret_cast<const float4*>(&rs[b][k0])[q];
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float o[4] = {o4[q].x, o4[q].y, o4[q].z, o4[q].w};
            const float r[4] = {r4[q].x, r4[q].y, r4[q].z, r4[q].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float e = wrapped_detector(o[k], arg);
              advance(e, r[k], kp, ki, integ, phase, arg);
              as[b][k0 + 4 * q + k] = arg;
            }
          }
        } else {
          const int m = min(32, cnt - k0);
          for (int k = 0; k < m; ++k) {
            const float xv = xs[b][k0 + k];
            float e;
            if ((bits >> k) & 1u) {
              float fbi, fbq;
              if (n0 + k0 + k == 0) {
                fbi = fbi0[row];
                fbq = fbq0[row];
              } else {
                fbi = cosf(arg);
                fbq = sinf(arg);
              }
              e = atan2f(__fmul_rn(xv, -fbq), __fmul_rn(xv, fbi));
            } else {
              e = wrapped_detector(os[b][k0 + k], arg);
            }
            advance(e, rs[b][k0 + k], kp, ki, integ, phase, arg);
            as[b][k0 + k] = arg;
          }
        }
      }
    }
    pair_sync(w);
  }

  if (chain) {
    // torch.remainder / jnp.mod: fmod, then shift into the divisor's sign
    float ph = fmodf(phase, four_pi);
    if (ph != 0.f && ((ph < 0.f) != (four_pi < 0.f)))
      ph = __fadd_rn(ph, four_pi);
    fbi1[row] = cosf(arg);
    fbq1[row] = sinf(arg);
    integ1[row] = integ;
    phase1[row] = ph;
    trig1[row] =
        static_cast<int>((static_cast<long long>(trig0[row]) + N) % period);
    last1[row] = cosf(__fadd_rn(__fmul_rn(arg, nco_scale), phase_adjust));
  }
}

}  // namespace

// x: (C, N) f32 rows with row stride ldx (floats); out: (C, N) f32
// contiguous; carry in (*0) and out (*1): (C,) f32, trig (C,) int32;
// N >= 1, 2*fsr < 2^30. Returns a cudaError_t (0 on success); launches on
// `stream`, no sync.
extern "C" int sdr_pll_scan(const float* x, long long ldx, float* out, int C,
                            int N, const float* fbi0, const float* fbq0,
                            const float* integ0, const float* phase0,
                            const int* trig0, const float* last0, float* fbi1,
                            float* fbq1, float* integ1, float* phase1,
                            int* trig1, float* last1, float kp, float ki,
                            int fr, int fsr, float ang_scale, float nco_scale,
                            float phase_adjust, float four_pi, void* stream) {
  if (C <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (fsr <= 0 || fsr >= (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  pll_scan_kernel<<<static_cast<unsigned>((C + kRows - 1) / kRows), kThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(
      x, ldx, out, C, N, fbi0, fbq0, integ0, phase0, trig0, last0, fbi1, fbq1,
      integ1, phase1, trig1, last1, kp, ki, fr, fsr, ang_scale, nco_scale,
      phase_adjust, four_pi);
  return static_cast<int>(cudaGetLastError());
}
