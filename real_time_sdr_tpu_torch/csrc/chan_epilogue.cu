// Channelizer epilogue: residual rotation, u8 quantization, station-major
// transpose and I/Q byte interleave of the static-fold channelizer.
//
// Replaces the TPU kernel `_kernel` of
// real_time_sdr_tpu/ops/pallas/chan_epilogue.py (launched by
// fold_epilogue_u8), which finishes models/channelizer.py's static-tone
// folded channelizer. The fold matmul emits y (c, R*2S) f32, frames on rows,
// column r*2S + rail*S + s. Row-major, that is exactly a (c*R, 2S) array with
// one row per output sample m = c_i*R + r, so the frame/r split disappears:
//
//     z_i = vr*pc[s] - vi*ps[s],   z_q = vi*pc[s] + vr*ps[s]
//     out[s, 2m + rail] = clip(round(128 + 127*z), 0, 255)
//
// with vr = y[m, s], vi = y[m, S + s]. Every product and sum is rounded on
// its own (__fmul_rn/__fsub_rn/__fadd_rn, no FMA contraction) and rintf
// rounds half to even, in the order torch eager evaluates the plain version,
// so the kernel is byte-exact against it.
//
// What bounds it on the H100. Pure data movement: at 64 stations and a
// 12-block 19.2 MS/s segment it reads y (451.6 MB) and writes the station
// streams (112.9 MB) with ~10 flops per output pair, so HBM bandwidth is the
// limit (~0.17 ms at 3.35 TB/s). The transpose is the hazard: reading y
// coalesces along stations, writing the output along time.
//
// Design. One block owns kTileM consecutive outputs of kTileS stations (one
// warp lane per station). Its warps read y rows coalesced along stations,
// quantize, and pack the two byte pairs of outputs (2w, 2w+1) of one station
// into one 32-bit word in shared memory (rows padded to an odd word count, so
// neither phase has bank conflicts). Then each warp writes one station's
// 4*kTileM/2 contiguous bytes as 32-bit stores, one 128-byte line per warp
// instruction. Word stores need 4-byte alignment, which holds when n_out is
// even (the caller passes `vec`); otherwise, and in the ragged last tile,
// the bytes are stored one by one. The GPU writes bytes directly, so the TPU
// kernel's int32 word planes and its XLA byte-extraction pass do not exist
// here, and any S and R are accepted (the TPU's S == 64, even-R and 256-frame
// gates were Mosaic limits).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 128;             // outputs per block (even)
constexpr int kTileS = 32;              // stations per block, one lane each
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWords = kTileM / 2;      // 32-bit words per station row
constexpr int kStride = kWords + 1;     // padded row, conflict-free

__device__ __forceinline__ uint32_t quantize(float z) {
  const float u = rintf(__fadd_rn(128.f, __fmul_rn(127.f, z)));
  return static_cast<uint32_t>(fminf(fmaxf(u, 0.f), 255.f));
}

__global__ void __launch_bounds__(kThreads)
chan_epilogue_kernel(const float* __restrict__ y, const float* __restrict__ pc,
                     const float* __restrict__ ps, uint8_t* __restrict__ out,
                     int S, long long n_out, int vec) {
  __shared__ uint32_t tile[kTileS * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * kTileS;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const long long row = 2LL * S;          // floats per output sample
  const int s = s0 + lane;

  if (s < S) {
    const float c = pc[s], sn = ps[s];
    for (int w = warp; w < kWords; w += kWarps) {
      uint32_t word = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + 2 * w + h;
        if (m < n_out) {
          const float vr = y[m * row + s];
          const float vi = y[m * row + S + s];
          const float zi = __fsub_rn(__fmul_rn(vr, c), __fmul_rn(vi, sn));
          const float zq = __fadd_rn(__fmul_rn(vi, c), __fmul_rn(vr, sn));
          word |= (quantize(zi) | (quantize(zq) << 8)) << (16 * h);
        }
      }
      tile[lane * kStride + w] = word;
    }
  }
  __syncthreads();

  const long long n2 = 2 * n_out;         // bytes per station row
  const long long left = n2 - 2 * m0;     // bytes of the row from m0 on
  for (int r = warp; r < kTileS && s0 + r < S; r += kWarps) {
    uint8_t* dst = out + static_cast<long long>(s0 + r) * n2 + 2 * m0;
    for (int w = lane; w < kWords; w += 32) {
      const uint32_t word = tile[r * kStride + w];
      const long long b = 4LL * w;
      if (vec && b + 4 <= left) {
        *reinterpret_cast<uint32_t*>(dst + b) = word;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (b + k < left) dst[b + k] = static_cast<uint8_t>(word >> (8 * k));
      }
    }
  }
}

}  // namespace

// y: (>= n_out, 2S) f32 rows (the fold matmul's (c, R*2S) result);
// pc, ps: (S,) f32; out: (S, 2*n_out) u8. vec != 0 allows 32-bit stores
// (n_out even). Returns a cudaError_t (0 on success); launches on `stream`,
// no sync.
extern "C" int sdr_chan_epilogue(const float* y, const float* pc,
                                 const float* ps, uint8_t* out, int S,
                                 long long n_out, int vec, void* stream) {
  if (S <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((n_out + kTileM - 1) / kTileM),
                  (S + kTileS - 1) / kTileS);
  chan_epilogue_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(y, pc, ps, out,
                                                              S, n_out, vec);
  return static_cast<int>(cudaGetLastError());
}
