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
// pads out to a J-wide row of mostly structural zeros.
//
// What bounds it on the H100. In f32 every site is far below the card's
// FMA rate in bytes (each input sample feeds K/up * nf MACs), so the limit is
// instruction issue: one shared-memory load of the input and one tap load per
// MAC group. The 247/640 bank's 24,947 taps (100 KB) do not belong in shared
// memory beside the input window, so taps come through the read-only cache;
// at up == 1 every lane of a warp reads the same tap, which the cache
// broadcasts.
//
// Design. One block covers kTile consecutive outputs of one row. It stages
// its input window (at most ceil((kTile-1)*down/up) + T samples) in shared
// memory once, then each thread computes one output for all nf filters,
// reusing each loaded input sample nf times. Rows are independent, so the
// grid is (output tiles, rows): channels, stacked rails and per-block
// batches all become rows. A simple first form; register tiling and tensor
// cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;     // outputs per block
constexpr int kThreads = 256;  // threads per block

template <int NF>
__global__ void __launch_bounds__(kThreads)
fir_bank_kernel(const float* __restrict__ xx, const float* __restrict__ taps,
                float* __restrict__ y, int L, int K, int up, int down, int T,
                int n_out) {
  extern __shared__ float win[];
  const int b = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
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

template <int NF>
cudaError_t launch(const float* xx, const float* taps, float* y, int B, int L,
                   int K, int up, int down, int T, int n_out,
                   cudaStream_t stream) {
  const long long span =
      (static_cast<long long>(kTile - 1) * down + up - 1) / up + T;
  const size_t smem = static_cast<size_t>(span) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_bank_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_out + kTile - 1) / kTile, B);
  fir_bank_kernel<NF><<<grid, kThreads, smem, stream>>>(xx, taps, y, L, K, up,
                                                        down, T, n_out);
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
