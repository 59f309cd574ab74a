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
// of one step. The chain mu -> w0 -> cur -> rail -> err -> mu -> floor ->
// mu counts 12 dependent f32 operations (MM_CHAIN_OPS in
// ops/cuda/mm_timing.py), 48 cycles at 4 cycles each. The rest of the card
// idles: one stream is one block.
//
// What bound the first form (158-172 cycles per symbol on an H100
// 80GB HBM3 at 700 W): every symbol's sample pair was a shared-memory load
// whose address waited on floor(mu), so the chain ran FRND -> F2I ->
// integer add -> clamp -> tile test and branch -> two LDS.64 (~30 cycles)
// -> the 12 f32 operations, with the loop's tests on the same chain.
//
// Design. Every f32 operation is separately rounded (__fmul_rn,
// __fadd_rn, __fsub_rn), as the plain version's elementwise operations
// are: no contraction into an FMA may move a floor(mu) decision, so the
// kernel is bit-identical to the plain version on the card. The walker
// (thread 0) reads from a shared tile of kTile + 1 samples starting at
// `base`; warps 1..7 stage the next tile (base + kTile) in the other
// buffer while it walks, and one barrier per tile hands the buffers over
// (every thread loads the tile it needs when the walk jumps out of the
// predicted one). Within a tile the walker takes runs of steps:
//
// - The fast step. With lo = floor(sps) - 1, the advance floor(mu) lies in
//   {lo, lo+1, lo+2} as long as |gain*err| < 1 (mu + sps is in [sps,
//   sps+1)). While it computes a symbol, the walker loads the four samples
//   z[i+lo .. i+lo+3] that hold the three candidate pairs of the next
//   symbol: their address waits only on this symbol's i. When mu resolves,
//   two compares of mu against lo+1 and lo+2 pick the pair with selects
//   (inline PTX), and floor(mu) comes from mu + 1.5 * 2^23 rounded down:
//   two additions instead of FRND, the integer advance read from the
//   sum's bits instead of an F2I; mu - floor(mu) is exactly the plain
//   version's.
// - The run. Before a run the walker counts the steps that certainly stay
//   inside the staged tile, below n - 2 and below n_max, taking the
//   largest advance lo+2 per step, so the run's steps test nothing but the
//   window, and that only once per block of kBlock steps: a block that
//   left it is undone (its stores rewritten, or zeroed past the end) and
//   retaken by steps that test it one by one.
// - The general step. A step whose mu leaves [lo, lo+3) (a large gain on
//   noise, a NaN) ends the run after updating i by the integer floor; the
//   next symbol then takes the general step, which reads its pair from the
//   tile at the clamped index, as the first form did. So do the first step
//   from any mu0, a negative i, the last steps before a tile's end, and
//   any sps below 1.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700 W, cycles
// at the 1,980 MHz SM clock): 111-113 cycles per symbol on the alternative
// path's 1,163 symbols, 98-100 on a 30,000-symbol stream, against the
// 48-cycle chain; PERF.md section 6 keeps every run. What still holds it
// back: the next candidates' address waits on floor(mu) through three
// integer operations, and the compiler issues that arithmetic and the four
// loads late in the step, so the selects wait ~25 cycles a step on them;
// ~8 us of each launch is fixed (the launch, mu0, the first tile).
//
// The walker stores each symbol to device memory as it goes (one 8-byte
// store per ~16 samples) and writes n_valid at the end, after zeroing what
// a discarded block stored past it; the wrapper zeroes the symbol buffer
// first.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;       // samples per tile (a pair may straddle:
                                  // the tile holds kTile + 1)
constexpr int kThreads = 256;     // warp 0: the walker (lane 0); 1..7 load
constexpr int kBlock = 8;         // fast steps between two window tests

__device__ __forceinline__ void load_tile(float2* dst, const float2* z,
                                          int n, int base, int first,
                                          int stride) {
  for (int j = first; j <= kTile; j += stride) {
    const int src = base + j;
    dst[j] = src < n ? z[src] : make_float2(0.f, 0.f);
  }
}

// the walker's carried decisions and symbols: out1, out2, rail1, rail2
struct History {
  float o1r = 0.f, o1i = 0.f, o2r = 0.f, o2i = 0.f;
  float r1r = 0.f, r1i = 0.f, r2r = 0.f, r2i = 0.f;
};

// one symbol from its sample pair (a, b) at fraction mu: stores it to *dst,
// shifts the history and returns the unfloored next position mu + sps +
// gain*err, every operation in the plain version's order and rounding
__device__ __forceinline__ float mm_step(float2 a, float2 b, float mu,
                                         float sps, float gain, History& h,
                                         float2* dst) {
  const float w0 = __fsub_rn(1.f, mu);
  const float cr = __fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, mu));
  const float ci = __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, mu));
  const float rcr = cr > 0.f ? 1.f : 0.f;
  const float rci = ci > 0.f ? 1.f : 0.f;
  const float xr = __fadd_rn(__fmul_rn(__fsub_rn(rcr, h.r2r), h.o1r),
                             __fmul_rn(__fsub_rn(rci, h.r2i), h.o1i));
  const float yr = __fadd_rn(__fmul_rn(__fsub_rn(cr, h.o2r), h.r1r),
                             __fmul_rn(__fsub_rn(ci, h.o2i), h.r1i));
  const float err = __fsub_rn(yr, xr);
  *dst = make_float2(cr, ci);
  h.o2r = h.o1r; h.o2i = h.o1i; h.o1r = cr; h.o1i = ci;
  h.r2r = h.r1r; h.r2i = h.r1i; h.r1r = rcr; h.r1i = rci;
  return __fadd_rn(__fadd_rn(mu, sps), __fmul_rn(gain, err));
}

// the window of the fast step: advances lo, lo+1, lo+2 of a symbol
struct Window {
  int lo;
  float lo_f;
};

// the four candidate samples at shared address sa: volatile loads, so that
// the compiler may neither sink them towards their use nor load only the
// candidate a branch would pick
__device__ __forceinline__ void load_candidates(unsigned sa, float2 (&c)[4]) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%8];\n\t"
               "ld.shared.v2.f32 {%2, %3}, [%8+8];\n\t"
               "ld.shared.v2.f32 {%4, %5}, [%8+16];\n\t"
               "ld.shared.v2.f32 {%6, %7}, [%8+24];"
               : "=f"(c[0].x), "=f"(c[0].y), "=f"(c[1].x), "=f"(c[1].y),
                 "=f"(c[2].x), "=f"(c[2].y), "=f"(c[3].x), "=f"(c[3].y)
               : "r"(sa));
}

// the next pair from the candidates c0..c3 (samples i+lo .. i+lo+3):
// (c0, c1) for m < lo+1, (c1, c2) below lo+2, else (c2, c3); selects in
// inline PTX, which the compiler cannot turn into branches
__device__ __forceinline__ void pick_pair(const float2 (&c)[4], float m,
                                          float t1, float t2, float2& a,
                                          float2& b) {
  asm("{\n\t.reg .pred p1, p2;\n\t"
      "setp.ge.f32 p1, %12, %13;\n\t"
      "setp.ge.f32 p2, %12, %14;\n\t"
      "selp.f32 %0, %6, %4, p1;\n\t"
      "selp.f32 %0, %8, %0, p2;\n\t"
      "selp.f32 %1, %7, %5, p1;\n\t"
      "selp.f32 %1, %9, %1, p2;\n\t"
      "selp.f32 %2, %8, %6, p1;\n\t"
      "selp.f32 %2, %10, %2, p2;\n\t"
      "selp.f32 %3, %9, %7, p1;\n\t"
      "selp.f32 %3, %11, %3, p2;\n\t}"
      : "=&f"(a.x), "=&f"(a.y), "=&f"(b.x), "=&f"(b.y)
      : "f"(c[0].x), "f"(c[0].y), "f"(c[1].x), "f"(c[1].y), "f"(c[2].x),
        "f"(c[2].y), "f"(c[3].x), "f"(c[3].y), "f"(m), "f"(t1), "f"(t2));
}

// m + kFloor rounded down, minus kFloor, is floor(m) for |m| < 2^22, in
// two fixed-latency additions (FRND's latency is variable), and the bits
// of the rounded sum hold floor(m) as an integer: no F2I either
constexpr float kFloor = 12582912.f;                  // 1.5 * 2^23

// one fast step from the pair (a, b) at fraction mu (w0 = 1 - mu), the
// candidate samples at shared address sa + 8*(i + lo): loads the next
// symbol's candidates ahead of the chain, computes the symbol, picks the
// next pair by two compares of the unfloored position m and advances i by
// floor(m), at most lo + 2. The symbol and m are the plain version's bit
// for bit: the rail terms (rail - rail2)*out1 and (cur - out2)*rail1 are
// exact products (the rails are 0 or 1), so a fused multiply-add gives
// each sum the plain version's single rounding; only zeros may change
// sign, which m = (mu + sps) + gain*err cannot see. mu = m - floor(m) and
// w0 = (floor(m) + 1) - m are exact differences, computed side by side.
// Returns floor(m) - lo as unsigned: below 3 where the step stayed in the
// window; elsewhere i, mu, w0 and the pair are not the plain version's,
// and the caller takes floor(m) again with floorf (or discards the step).
__device__ __forceinline__ unsigned fast_step(unsigned sa, Window w,
                                              float sps, float gain, int& i,
                                              float& mu, float& w0,
                                              float2& a, float2& b,
                                              History& h, float2* dst,
                                              float& m) {
  float2 c[4];
  load_candidates(sa + 8u * static_cast<unsigned>(i + w.lo), c);
  const float cr = __fadd_rn(__fmul_rn(a.x, w0), __fmul_rn(b.x, mu));
  const float ci = __fadd_rn(__fmul_rn(a.y, w0), __fmul_rn(b.y, mu));
  const float rcr = cr > 0.f ? 1.f : 0.f;
  const float rci = ci > 0.f ? 1.f : 0.f;
  const float xr = __fadd_rn(__fmaf_rn(rcr, h.o1r, -__fmul_rn(h.r2r, h.o1r)),
                             __fmaf_rn(rci, h.o1i, -__fmul_rn(h.r2i, h.o1i)));
  const float yr = __fmaf_rn(__fsub_rn(cr, h.o2r), h.r1r,
                             __fmul_rn(__fsub_rn(ci, h.o2i), h.r1i));
  const float err = __fsub_rn(yr, xr);
  *dst = make_float2(cr, ci);
  h.o2r = h.o1r; h.o2i = h.o1i; h.o1r = cr; h.o1i = ci;
  h.r2r = h.r1r; h.r2i = h.r1i; h.r1r = rcr; h.r1i = rci;
  m = __fadd_rn(__fadd_rn(mu, sps), __fmul_rn(gain, err));
  const float t = __fadd_rd(m, kFloor);
  mu = __fsub_rn(m, __fsub_rn(t, kFloor));
  w0 = __fsub_rn(__fsub_rn(t, kFloor - 1.f), m);
  pick_pair(c, m, w.lo_f + 1.f, w.lo_f + 2.f, a, b);
  const unsigned d = static_cast<unsigned>(__float_as_int(t)) -
                     static_cast<unsigned>(__float_as_int(kFloor)) -
                     static_cast<unsigned>(w.lo);
  i += w.lo + static_cast<int>(min(d, 2u));
  return d;
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

  // walker state (thread 0 only); `written` is the end of what blocks
  // wrote ahead and had to discard, zeroed past n_valid at the end
  int i_in = 0, i_out = 0, written = 0;
  float mu = 0.f;
  History h;
  // the fast step's window: advances lo, lo+1, lo+2 (stride: the largest)
  const float fl = floorf(sps);
  const bool fast = fl >= 1.f && fl < static_cast<float>(kTile);
  const Window win{fast ? static_cast<int>(fl) - 1 : 0,
                   fast ? fl - 1.f : 0.f};
  const int stride = win.lo + 2;
  if (tid == 0) {
    const float m0 = *mu0p;
    const float f = floorf(m0);
    i_in = static_cast<int>(f);
    mu = __fsub_rn(m0, f);
    s_next[0] = (i_in < last && n_max > 0) ? max(i_in, 0) : -1;
  }
  __syncthreads();
  int base = s_next[0];
  int cur = 0, parity = 0;
  if (base >= 0) load_tile(tile[cur], z, n, base, tid, kThreads);
  __syncthreads();

  while (base >= 0) {
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
        float2 a = t[i - base], b = t[i - base + 1];
        // steps of a run: step j starts at most j*stride past i, must stay
        // below last and n_max, and prefetches up to lo + 3 past its start
        int run = 0;
        if (fast && i_in >= 0) {
          const int room = min(last - 1 - i, base + kTile - win.lo - 3 - i);
          if (room >= 0) run = min(n_max - i_out, room / stride + 1);
        }
        if (run == 0) {               // the general step
          const float m = mm_step(a, b, mu, sps, gain, h, out + i_out++);
          const float adv = floorf(m);
          i_in += static_cast<int>(adv);
          mu = __fsub_rn(m, adv);
          continue;
        }
        // the tile's shared address, indexed by the stream position
        const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(t))
                            - 8u * static_cast<unsigned>(base);
        float w0 = __fsub_rn(1.f, mu), m;
        // blocks of kBlock steps without a branch; a block whose advance
        // left the window is undone and taken again by checked steps
        while (run >= kBlock) {
          const int i0 = i_in;
          const float mu0 = mu, w00 = w0;
          const float2 a0 = a, b0 = b;
          const History h0 = h;
          unsigned worst = 0;
#pragma unroll
          for (int u = 0; u < kBlock; ++u)
            worst = max(worst, fast_step(sa, win, sps, gain, i_in, mu, w0, a,
                                         b, h, out + i_out + u, m));
          if (worst > 2) {
            written = max(written, i_out + kBlock);
            i_in = i0;
            mu = mu0;
            w0 = w00;
            a = a0;
            b = b0;
            h = h0;
            break;
          }
          i_out += kBlock;
          run -= kBlock;
        }
        // checked steps: the run's last steps, or a block that left the
        // window, up to the step that leaves it
        for (; run > 0; --run) {
          const int i0 = i_in;
          if (fast_step(sa, win, sps, gain, i_in, mu, w0, a, b, h,
                        out + i_out++, m) > 2) {
            const float adv = floorf(m);    // the general update
            i_in = i0 + static_cast<int>(adv);
            mu = __fsub_rn(m, adv);
            break;
          }
        }
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
  if (tid == 0) {
    for (int k = i_out; k < written; ++k) out[k] = make_float2(0.f, 0.f);
    *n_valid = i_out;
  }
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
