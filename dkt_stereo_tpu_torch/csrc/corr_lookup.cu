// Correlation-pyramid lookup (RAFT-Stereo, config "reg" / "reg_cuda").
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/corr_lookup.py
// (corr_lookup_pallas, :290; kernel bodies _fwd_kernel :42 and
// _fwd_kernel_level :94). For every pixel (b, h, w1) and level i it samples
// 2r+1 positions x/2^i + k - r, k = 0..2r, along the volume row
// vol_i[b, h, w1, :] with linear interpolation and zero padding, and writes
// out[b, h, w1, i*(2r+1) + k] in fp32.
//
// What bounds it on the H100: bytes. Each (pixel, level) reads 2r+2
// neighbouring values of one row and writes 2r+1 floats; there are a few
// FLOPs per byte. At the main path's shapes (184 x 320 pixels, 4 levels,
// r = 4) that is ~8.5 MB written and ~5 MB of taps read per launch.
//
// Design: the TPU kernel sweeps whole rows with relu(1 - |j - pos|) weights
// because it has no cheap gather; here the taps are read directly. All taps
// of one (pixel, level) share one fractional weight, so one thread reads the
// 2r+2 consecutive values once and emits 2r+1 outputs. Threads are ordered
// (pixel, level), so neighbouring threads write neighbouring outputs. The
// levels are separate tensors of different widths, passed as four pointers
// and widths: nothing is concatenated per call. Volumes are read as bf16 or
// fp32; interpolation is fp32. The position is clamped before the integer
// conversion, so huge or far out-of-range coordinates give zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 8;
constexpr int kMaxVals = 2 * kMaxRadius + 2;

struct Pyramid {
  const void* vol[kMaxLevels];
  int w2[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void corr_lookup_kernel(Pyramid pyr, int levels, const float* __restrict__ coords,
                                   float* __restrict__ out, long long npix, int radius) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= npix * levels) return;
  const long long pix = t / levels;
  const int lvl = (int)(t - pix * levels);
  const int taps = 2 * radius + 1;
  const int w2 = pyr.w2[lvl];
  const T* row = static_cast<const T*>(pyr.vol[lvl]) + pix * (long long)w2;

  // x / 2^lvl is exact in fp32; the first tap sits r to the left
  float p0 = coords[pix] * (1.0f / (float)(1 << lvl)) - (float)radius;
  // any position left of -(2r+2) or right of w2 reads only zeros: clamp
  // there before converting, so out-of-range floats never reach the int
  p0 = fminf(fmaxf(p0, -(float)(taps + 2)), (float)(w2 + 1));
  const float f0 = floorf(p0);
  const int x0 = (int)f0;
  const float w = p0 - f0;

  float v[kMaxVals];
#pragma unroll
  for (int j = 0; j < kMaxVals; ++j) {
    const int ix = x0 + j;
    v[j] = (j <= taps && ix >= 0 && ix < w2) ? to_f32(row[ix]) : 0.0f;
  }
  float* o = out + pix * (long long)(levels * taps) + lvl * taps;
#pragma unroll
  for (int k = 0; k < kMaxVals - 1; ++k) {
    if (k < taps) o[k] = v[k] * (1.0f - w) + v[k + 1] * w;
  }
}

}  // namespace

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int corr_lookup_launch(const void* vol0, const void* vol1, const void* vol2,
                                  const void* vol3, int w2_0, int w2_1, int w2_2, int w2_3,
                                  int levels, const float* coords, float* out, long long npix,
                                  int radius, int is_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius || npix < 1)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr = {{vol0, vol1, vol2, vol3}, {w2_0, w2_1, w2_2, w2_3}};
  const int threads = 256;
  const long long total = npix * levels;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    corr_lookup_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(pyr, levels, coords, out, npix, radius);
  else
    corr_lookup_kernel<float><<<blocks, threads, 0, s>>>(pyr, levels, coords, out, npix, radius);
  return (int)cudaGetLastError();
}
