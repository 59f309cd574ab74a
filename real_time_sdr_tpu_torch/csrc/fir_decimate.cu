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
// the row.
//
// What bounds it on the H100. Each output costs K FMAs and reads K window
// samples from shared memory; the input is read from HBM about once
// (window overlap (K-1)/(tile*down)). In f32 the limit is the rate of
// shared-memory loads (one broadcast tap load and one strided sample load
// per FMA), not HBM bandwidth.
//
// Design. One block covers kTile consecutive outputs of one row: it stages
// the K taps and its input window ((kTile-1)*down + K samples) in shared
// memory, then each thread accumulates one output over k = 0..K-1 in the TPU
// kernel's order, with a fused multiply-add per tap. Unlike the FIR bank
// (csrc/fir_bank.cu) it has one filter per launch and no polyphase `up`;
// it is the direct K-tap form the FIR bank is measured against. Neighbouring
// threads read samples `down` apart, a 2-way bank conflict at most for the
// even factors of the receiver's sites.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;     // outputs per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
fir_decimate_kernel(const float* __restrict__ xx, const float* __restrict__ h,
                    float* __restrict__ y, int L, int K, int down,
                    int n_out) {
  extern __shared__ float smem[];
  float* taps = smem;
  float* win = smem + K;
  const int c = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
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

}  // namespace

// Shared memory one block needs, in bytes (the wrapper checks it against
// the card's 227 KB limit before launching).
extern "C" int sdr_fir_decimate_smem(int K, int down) {
  return static_cast<int>((2LL * K + static_cast<long long>(kTile - 1) * down) *
                          sizeof(float));
}

// xx: (C, L) f32 rows, L = K-1 + N; h: (K,) f32; y: (C, n_out) f32 with
// n_out = N/down. Returns a cudaError_t (0 on success); launches on
// `stream`, no sync.
extern "C" int sdr_fir_decimate(const float* xx, const float* h, float* y,
                                int C, int L, int K, int down, int n_out,
                                void* stream) {
  if (C <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(sdr_fir_decimate_smem(K, down));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_decimate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here: the next launch must not see it
      return static_cast<int>(err);
    }
  }
  const dim3 grid((n_out + kTile - 1) / kTile, C);
  fir_decimate_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(xx, h, y, L, K,
                                                             down, n_out);
  return static_cast<int>(cudaGetLastError());
}
