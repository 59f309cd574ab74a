// Fused frontend: raw interleaved u8 IQ -> decimating I/Q LPF -> FM
// discriminator, in one pass that writes only the demod.
//
// Replaces the TPU kernel `_kernel` of
// real_time_sdr_tpu/ops/pallas/frontend_fused.py (launched by
// FusedFrontendFIR._dispatch_rows), the TPU default frontend. Over the
// tail-prefixed byte stream xx (tail = 2K-2 bytes):
//
//     I[m] = sum_k h[k] * (xx[2*m*down + 2K-2 - 2k] - 128) / 128
//     Q[m] = the same at byte index + 1
//     d[m] = (I[m]*(Q[m]-Q[m-1]) - Q[m]*(I[m]-I[m-1])) / (I[m]^2 + Q[m]^2)
//
// with d = 0 where I = Q = 0, and (I[-1], Q[-1]) the carried
// (prev_i, prev_q). The /128 is folded into the taps; (x - 128) is exact in
// f32.
//
// What bounds it on the H100. Each input byte is read once (56.4 MB per
// 32-channel x 12-block mode-0 call, 0.020 ms at 3.35 TB/s) and feeds K/down
// f32 FMAs (1.14 GFLOP, 0.017 ms at 67 TFLOP/s): the two floors are close,
// so the kernel can only near them if almost every instruction it executes
// is an FFMA. The first form of this kernel computed one output per thread
// and, per tap, made two shared loads at a lane stride of `down` floats (a
// gcd(down, 32)-way bank conflict: 2-way at down 10, 4-way at down 4) and
// one tap load for two FFMAs: it was bound by shared-memory loads at 10 %
// (down 10) and 3 % (down 4) of the byte floor.
//
// Design.
//
// 1. Polyphase planes in shared memory. A block stages its byte window with
//    16-byte cp.async copies (from the 16-byte boundary at or below the
//    window's start; the ragged ends by scalar loads), then converts it:
//    pair j of the window goes to plane j % down at index j / down, as one
//    half2 (I - 128, Q - 128): the integers -128..127 are exact in fp16,
//    and a pair of bytes becomes a half2 with one byte-permute (0x64bb is
//    1024 + b) and one packed subtraction, stored with one 4-byte store. A
//    window starts at a multiple of `down` pairs, so one thread converts
//    one group of `down` pairs and every destination is a compile-time
//    multiple of the plane stride from one address: the kernel is
//    specialised on the geometries the receiver's modes use (K 101 at down
//    3, 4, 10); any other takes a scalar conversion loop and the ring body
//    of 2. with runtime K and down.
//    An output is then a sum over the planes of short unit-stride FIRs:
//
//        I[t] = sum_p sum_q g_p[q] * plane_p[t + q],
//        g_p[q] = h[K-1 - q*down - p]   (ceil((K - p) / down) taps)
//
//    with no lane stride of `down` and no bank conflict at any `down`.
// 2. Register tiling, as the FIR bank's up = down = 1 body. Each thread owns
//    kP consecutive outputs, for I and for Q: 2*kP f32 accumulators and,
//    per plane, two rings of kP samples that slide by one sample per tap.
//    Per tap it makes one shared load (the new I and Q samples, one
//    half2), two conversions to f32, one broadcast load of the tap, and
//    2*kP FFMAs. The tap loop is unrolled by kP with a guarded remainder,
//    so K stays a runtime value and the ring's slots are registers. kP is
//    odd: lane t's samples start kP*t words apart, so a warp's sample load
//    touches 32 banks. The sums run plane by plane (another order than the
//    plain version's single dot product), so the kernel is held to its
//    plain version by SNR, not by bits; every product and sum is f32.
//    At the receiver's own geometries (11, 26 or 34 taps per plane: K 101
//    at down 10, 4, 3) the plane's taps sit in registers and the kP + J - 1
//    samples stream through once, fully unrolled: no ring, no remainder,
//    the same sums in the same order.
// 3. Blocks of kThreads threads and kP*kThreads outputs, 4 bytes of plane
//    per pair: at down 10 a block holds 70 KB of shared memory and three
//    are resident per SM (12 warps), so one block's copy and conversion
//    overlap the others' FFMAs. The block shape matters little (32, 64 and
//    128 threads are within 9 % of each other at every mode, 128 the best):
//    the kernel executes about 2.4 instructions per FFMA at down 10 (the
//    conversion, the loads and half-to-float conversions of the tap loop,
//    the discriminator's divisions), and that, not occupancy, is what
//    holds it above its bound.
// 4. The discriminator needs each output's predecessor: a block computes
//    one extra leading output (block 0 of a row takes the carried prev),
//    leaves I and Q in shared memory (over the spent byte window) and
//    differentiates from there, storing coalesced. Blocks need nothing
//    from each other; (row, tile) lie on a flat gridDim.x, so any row count
//    runs.

#include <climits>
#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 9;                       // outputs per thread, odd
constexpr int kThreads = 128;               // threads per block
constexpr int kSpan = kP * kThreads;        // outputs a block computes: 1152
constexpr int kTile = kSpan - 1;            // of which new (one is the
                                            // predecessor of the first)

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout, in bytes from a 16-byte aligned base:
//   [0, region0)      the raw byte window at offset off (< 16), later the
//                     I and Q outputs (kSpan + 1 floats each)
//   [region0, +taps)  g[p][q], down x J floats
//   then              planes 0..down-1, each plane_len half2 (I, Q)
__host__ __device__ constexpr int taps_per_plane(int K, int down) {
  return (K + down - 1) / down;
}
__host__ __device__ constexpr int plane_len(int K, int down) {
  return kSpan + taps_per_plane(K, down);
}
__host__ __device__ constexpr int region0_bytes(int K, int down) {
  // window bytes, up to 15 of alignment slack, and 8 so that the word
  // reads of the last group stay inside
  const int raw =
      round_up(2 * ((kSpan - 1) * down + K) + 2 * down + 15 + 8, 16);
  const int outs = 2 * (kSpan + 1) * 4;
  return round_up(raw > outs ? raw : outs, 16);
}
__host__ __device__ constexpr size_t smem_bytes(int K, int down) {
  return static_cast<size_t>(region0_bytes(K, down)) +
         4u * (static_cast<size_t>(down) * taps_per_plane(K, down) +
               static_cast<size_t>(down) * plane_len(K, down));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Bytes (2*h, 2*h + 1) of word w, an (I, Q) pair, as the half2
// (I - 128, Q - 128): 0x64bb is the fp16 value 1024 + bb.
__device__ __forceinline__ __half2 centered(unsigned w, int h) {
  const unsigned v = __byte_perm(w, 0x64646464u, h ? 0x5342u : 0x5140u);
  return __hsub2(*reinterpret_cast<const __half2*>(&v),
                 __float2half2_rn(1152.f));
}

// Convert group g (pairs g*DOWN .. g*DOWN + DOWN-1 of the window, whose
// byte 0 is at raw) into index g of every plane.
template <int DOWN>
__device__ __forceinline__ void convert_group(const unsigned char* raw, int g,
                                              __half2* planes, int pstride) {
  constexpr int kBytes = 2 * DOWN;
  constexpr int kWords = (kBytes + 3) / 4;
  const unsigned char* src = raw + kBytes * g;
  const unsigned sh =
      static_cast<unsigned>(__cvta_generic_to_shared(src)) & 3u;
  const unsigned* w = reinterpret_cast<const unsigned*>(src - sh);
  const unsigned sel = 0x3210u + 0x1111u * sh;   // bytes sh .. sh+3
  unsigned lo = w[0];
  __half2* dst = planes + g;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const unsigned hi = w[k + 1];
    const unsigned word = __byte_perm(lo, hi, sel);
    lo = hi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * k + h;          // pair of the group
      if (u < DOWN) dst[u * pstride] = centered(word, h);
    }
  }
}

// One tap step s = q (u = s mod kP, a constant once unrolled): the new
// sample x[s + kP-1] enters the rings' slot (u + kP-1) mod kP, whose old
// sample (output 0's of step s-1) is spent; output i reads slot
// (i + u) mod kP.
__device__ __forceinline__ void tap_step(float (&ai)[kP], float (&aq)[kP],
                                         float (&ri)[kP], float (&rq)[kP],
                                         const __half2* x, const float* hp,
                                         int s, int u) {
  const float2 v = __half22float2(x[s + kP - 1]);
  ri[(u + kP - 1) % kP] = v.x;
  rq[(u + kP - 1) % kP] = v.y;
  const float h = hp[s];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    ai[i] = fmaf(h, ri[(i + u) % kP], ai[i]);
    aq[i] = fmaf(h, rq[(i + u) % kP], aq[i]);
  }
}

// One plane with a compile-time tap count JT (its last tap may be a padded
// zero): the taps in registers, each sample loaded once and used by every
// output it reaches; output i sums q ascending, as tap_step does.
template <int JT>
__device__ __forceinline__ void plane_static(float (&ai)[kP], float (&aq)[kP],
                                             const __half2* x,
                                             const float* hp) {
  float g[JT];
#pragma unroll
  for (int q = 0; q < JT; ++q) g[q] = hp[q];
#pragma unroll
  for (int n = 0; n < kP + JT - 1; ++n) {
    const float2 v = __half22float2(x[n]);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int q = n - i;
      if (q >= 0 && q < JT) {
        ai[i] = fmaf(g[q], v.x, ai[i]);
        aq[i] = fmaf(g[q], v.y, aq[i]);
      }
    }
  }
}

// <DOWN, JT> > 0: down == DOWN and ceil(K / down) == JT; the conversion
// and the planes' tap loops are static. <0, 0>: any K and down.
template <int DOWN, int JT>
__global__ void __launch_bounds__(kThreads)
frontend_fused_kernel(const uint8_t* __restrict__ xx,
                      const float* __restrict__ taps,
                      const float* __restrict__ prev_i,
                      const float* __restrict__ prev_q,
                      float* __restrict__ demod, float* __restrict__ last_i,
                      float* __restrict__ last_q, int L, int K, int down_rt,
                      int n_out, int tiles) {
  extern __shared__ float4 smem4[];
  const int down = DOWN > 0 ? DOWN : down_rt;
  // constants in the static kernels: plane addresses become immediates
  const int J = JT > 0 ? JT : taps_per_plane(K, down);
  const int pstride = kSpan + J;            // == plane_len(K, down)
  unsigned char* region0 = reinterpret_cast<unsigned char*>(smem4);
  float* g_s = reinterpret_cast<float*>(region0 + region0_bytes(K, down));
  __half2* planes = reinterpret_cast<__half2*>(g_s + down * J);

  const int tid = threadIdx.x;
  const int c = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * kTile;
  const int cnt = min(kTile, n_out - m0);
  const int m_first = m0 > 0 ? m0 - 1 : 0;   // first output computed here
  const int n_mine = m0 + cnt - m_first;     // <= kSpan
  const int npair = (n_mine - 1) * down + K;
  const int valid = 2 * npair;               // window bytes

  // Window byte k lives at region0[off + k], off = the source's distance
  // past a 16-byte boundary.
  const uint8_t* src = xx + static_cast<long long>(c) * L +
                       2LL * static_cast<long long>(m_first) * down;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const uint8_t* base = src - off;           // region0[j] = base[j]
  const int c_lo = (off + 15) >> 4;          // whole 16-byte chunks
  const int c_hi = (off + valid) >> 4;
  for (int k = c_lo + tid; k < c_hi; k += kThreads)
    cp_async16(region0 + 16 * k, base + 16 * k);
  asm volatile("cp.async.commit_group;\n" ::);
  const int head_end = min(16 * c_lo, off + valid);
  const int tail_start = max(16 * c_hi, head_end);
  const int n_head = head_end - off;         // <= 15 each
  const int n_tail = off + valid - tail_start;
  if (tid < n_head) {
    region0[off + tid] = src[tid];
  } else if (tid < n_head + n_tail) {
    const int j = tail_start + tid - n_head;
    region0[j] = base[j];
  }
  for (int j = tid; j < down * J; j += kThreads) {
    const int p = j / J, q = j - p * J;
    const int k = K - 1 - q * down - p;
    g_s[j] = k >= 0 ? __ldg(taps + k) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const unsigned char* raw = region0 + off;
  if constexpr (DOWN > 0) {
    const int groups = (npair + DOWN - 1) / DOWN;
    for (int g = tid; g < groups; g += kThreads)
      convert_group<DOWN>(raw, g, planes, pstride);
  } else {
    for (int j = tid; j < npair; j += kThreads) {
      const int p = j % down, idx = j / down;
      planes[p * pstride + idx] =
          __floats2half2_rn(static_cast<float>(raw[2 * j]) - 128.f,
                            static_cast<float>(raw[2 * j + 1]) - 128.f);
    }
  }
  __syncthreads();

  float ai[kP], aq[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) ai[i] = aq[i] = 0.f;
  for (int p = 0; p < down; ++p) {
    const __half2* x = planes + p * pstride + tid * kP;
    const float* hp = g_s + p * J;
    if constexpr (JT > 0) {
      // a plane with JT - 1 taps has a zero in the last place, and the
      // sample it meets was converted from the window's bytes: finite
      plane_static<JT>(ai, aq, x, hp);
      continue;
    }
    const int jp = p < K ? (K - 1 - p) / down + 1 : 0;   // taps of plane p
    float ri[kP], rq[kP];
#pragma unroll
    for (int i = 0; i < kP - 1; ++i) {
      const float2 v = __half22float2(x[i]);
      ri[i] = v.x;
      rq[i] = v.y;
    }
    int s = 0;
    for (; s + kP <= jp; s += kP) {
#pragma unroll
      for (int u = 0; u < kP; ++u) tap_step(ai, aq, ri, rq, x, hp, s + u, u);
    }
#pragma unroll
    for (int u = 0; u < kP - 1; ++u)
      if (s + u < jp) tap_step(ai, aq, ri, rq, x, hp, s + u, u);
  }

  // I and Q of output m_first + t at slot t + shift of ib/qb; slot 0 is the
  // predecessor of output m0. The byte window is spent (every thread passed
  // the barrier after the conversion), so the outputs take its place. Lane
  // t writes slots kP*t + i, an odd stride, conflict-free.
  float* ib = reinterpret_cast<float*>(region0);
  float* qb = ib + kSpan + 1;
  const int shift = m_first - m0 + 1;        // 1 in a row's first block
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    ib[tid * kP + i + shift] = ai[i];
    qb[tid * kP + i + shift] = aq[i];
  }
  if (m0 == 0 && tid == 0) {
    ib[0] = prev_i[c];
    qb[0] = prev_q[c];
  }
  __syncthreads();

  float* drow = demod + static_cast<long long>(c) * n_out + m0;
  for (int t = tid; t < cnt; t += kThreads) {
    const float i = ib[t + 1], q = qb[t + 1];
    const float ip = ib[t], qp = qb[t];
    const float num = i * (q - qp) - q * (i - ip);
    const float den = i * i + q * q;
    drow[t] = (i == 0.f && q == 0.f) ? 0.f : num / (den == 0.f ? 1.f : den);
    if (m0 + t == n_out - 1) {
      last_i[c] = i;
      last_q[c] = q;
    }
  }
}

template <int DOWN, int JT>
cudaError_t launch(const uint8_t* xx, const float* taps, const float* prev_i,
                   const float* prev_q, float* demod, float* last_i,
                   float* last_q, int C, int L, int K, int down, int n_out,
                   cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(n_out) + kTile - 1) / kTile;
  if (tiles * C > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, down);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frontend_fused_kernel<DOWN, JT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here: the next launch must not see it
      return err;
    }
  }
  frontend_fused_kernel<DOWN, JT>
      <<<static_cast<unsigned>(tiles * C), kThreads, smem, stream>>>(
          xx, taps, prev_i, prev_q, demod, last_i, last_q, L, K, down, n_out,
          static_cast<int>(tiles));
  return cudaGetLastError();
}

}  // namespace

// xx: (C, L) u8 rows, L = 2K-2 + n2 (even); taps: (K,) f32 = h/128;
// prev_i, prev_q: (C,) f32; demod: (C, n_out) f32; last_i, last_q: (C,) f32.
// Returns a cudaError_t (0 on success); launches on `stream`, no sync.
extern "C" int sdr_frontend_fused(const uint8_t* xx, const float* taps,
                                  const float* prev_i, const float* prev_q,
                                  float* demod, float* last_i, float* last_q,
                                  int C, int L, int K, int down, int n_out,
                                  void* stream) {
  if (C <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || down <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDR_FRONTEND(D, J)                                                 \
  return static_cast<int>(launch<D, J>(xx, taps, prev_i, prev_q, demod,    \
                                       last_i, last_q, C, L, K, down,      \
                                       n_out, s))
  const int J = taps_per_plane(K, down);
  if (down == 10 && J == 11) SDR_FRONTEND(10, 11);   // modes 0 and 2
  if (down == 4 && J == 26) SDR_FRONTEND(4, 26);     // mode 1
  if (down == 3 && J == 34) SDR_FRONTEND(3, 34);     // mode 3
  SDR_FRONTEND(0, 0);
#undef SDR_FRONTEND
}
