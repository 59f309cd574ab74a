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
// f32, so the products match the plain version's term for term.
//
// What bounds it on the H100. It touches every input byte (56.4 MB per
// 32-channel x 12-block call) but does 2K = 202 MACs per output pair, i.e.
// ~10 MACs per byte: in f32 the limit is instruction issue from shared
// memory (two sample loads and one broadcast tap load per MAC pair), well
// before HBM bandwidth.
//
// Design. One block covers kTile consecutive outputs of one channel. It
// loads its byte window once, deinterleaved into I and Q sample arrays in
// shared memory, computes I and Q for its outputs plus ONE extra leading
// output that supplies its own first predecessor (block 0 takes the carried
// prev instead), then runs the discriminator from shared memory. This
// replaces the TPU kernel's host-side boundary dots and lane rolls: blocks
// need nothing from each other, so the grid is (output tiles, channels).
// The kernel is generic in K and down.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;     // demod outputs per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
frontend_fused_kernel(const uint8_t* __restrict__ xx,
                      const float* __restrict__ taps,
                      const float* __restrict__ prev_i,
                      const float* __restrict__ prev_q,
                      float* __restrict__ demod, float* __restrict__ last_i,
                      float* __restrict__ last_q, int L, int K, int down,
                      int n_out) {
  extern __shared__ float smem[];
  const int cap = kTile * down + K;  // I/Q pairs a window can hold
  float* si = smem;
  float* sq = si + cap;
  float* h = sq + cap;
  float* ib = h + K;                 // I at slots 0..kTile (slot 0 = pred.)
  float* qb = ib + kTile + 1;

  const int c = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int cnt = min(kTile, n_out - m0);
  const int m_first = m0 > 0 ? m0 - 1 : 0;  // first output computed here
  const int m_last = m0 + cnt - 1;
  const int npair = (m_last - m_first) * down + K;

  const uchar2* row = reinterpret_cast<const uchar2*>(
      xx + static_cast<long long>(c) * L +
      2LL * static_cast<long long>(m_first) * down);
  for (int j = threadIdx.x; j < npair; j += blockDim.x) {
    const uchar2 v = row[j];
    si[j] = static_cast<float>(v.x) - 128.f;
    sq[j] = static_cast<float>(v.y) - 128.f;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) h[k] = taps[k];
  if (m0 == 0 && threadIdx.x == 0) {
    ib[0] = prev_i[c];
    qb[0] = prev_q[c];
  }
  __syncthreads();

  const int n_mine = m_last - m_first + 1;
  for (int t = threadIdx.x; t < n_mine; t += blockDim.x) {
    const int off = t * down + K - 1;
    float acc_i = 0.f, acc_q = 0.f;
    for (int k = 0; k < K; ++k) {
      acc_i = fmaf(h[k], si[off - k], acc_i);
      acc_q = fmaf(h[k], sq[off - k], acc_q);
    }
    const int slot = m_first + t - m0 + 1;
    ib[slot] = acc_i;
    qb[slot] = acc_q;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const float i = ib[t + 1], q = qb[t + 1];
    const float ip = ib[t], qp = qb[t];
    const float num = i * (q - qp) - q * (i - ip);
    const float den = i * i + q * q;
    const float d =
        (i == 0.f && q == 0.f) ? 0.f : num / (den == 0.f ? 1.f : den);
    demod[static_cast<long long>(c) * n_out + m0 + t] = d;
    if (m0 + t == n_out - 1) {
      last_i[c] = i;
      last_q[c] = q;
    }
  }
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
  const size_t smem =
      (2 * (static_cast<size_t>(kTile) * down + K) + K + 2 * (kTile + 1)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frontend_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_out + kTile - 1) / kTile, C);
  frontend_fused_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xx, taps, prev_i, prev_q, demod, last_i, last_q, L, K, down, n_out);
  return static_cast<int>(cudaGetLastError());
}
