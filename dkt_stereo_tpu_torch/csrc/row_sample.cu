// Gaussian row sampling (PCVNet's correlation lookup, every
// corr_implementation on CUDA tensors).
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/row_sample.py
// (row_sample_pallas, :145; kernel body _fwd_kernel :33), which PCVNet calls
// once per pyramid level (nn/pcv.py:100-115). Here one launch covers every
// level: for every pixel (b, h, w1) and sample k it reads the level-0
// position pos[b, h, w1, k], and at level i samples the volume row
// vol_i[b, h, w1, :] at pos / cf^i with linear interpolation and zero
// padding, writing out[b, h, w1, i*K + k] in fp32 (level-major, as the JAX
// concatenation).
//
// What bounds it on the H100: bytes. Each (pixel, k) reads one fp32
// position, two neighbouring values of one row per level and writes one
// float per level; a few FLOPs per byte. At the PCVNet main path's shapes
// (184 x 320 pixels, K = 36, widths 320/80/20, bf16) that is 8.5 MB of
// positions, 25.4 MB of output and at most 49.5 MB of volume a launch.
//
// Design: the TPU kernel sweeps the whole row with relu(1 - |j - pos|)
// weights for every position (W2 multiply-adds where 2 are needed) because
// it has no cheap gather; here the two taps are read directly. One thread
// per (pixel, k): it reads its position once and loops over the levels; the
// K threads of a pixel share that pixel's rows, so their reads meet in L1.
// Neighbouring threads write neighbouring outputs of one level. The levels
// are separate tensors of different widths, passed as four pointers and
// widths: nothing is concatenated per call. The level scale 2^-(i*log2 cf)
// is applied with ldexpf, exactly pos / cf^i. Interpolation is fp32,
// v0*(1-w) + v1*w rounded as the plain version rounds it, so the two agree
// bit for bit on finite positions. The position is clamped
// before the integer conversion, so huge, infinite or NaN positions read
// nothing out of bounds (NaN gives zeros where the plain version gives NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  const void* vol[kMaxLevels];
  int w2[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void row_sample_kernel(Levels lv, int levels, const float* __restrict__ pos,
                                  float* __restrict__ out, long long npix, int K, int log2_cf) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= npix * K) return;
  const long long pix = t / K;
  const int k = (int)(t - pix * K);
  const float p = pos[t];
  float* o = out + pix * (long long)(levels * K) + k;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int w2 = lv.w2[lvl];
    const T* row = static_cast<const T*>(lv.vol[lvl]) + pix * (long long)w2;
    // left of -1 or right of w2 reads only zeros: clamp there (fmaxf turns
    // NaN into -2) so that out-of-range floats never reach the int
    const float x = fminf(fmaxf(ldexpf(p, -lvl * log2_cf), -2.0f), (float)(w2 + 1));
    const float f = floorf(x);
    const int x0 = (int)f;
    const float w = x - f;
    const float v0 = (x0 >= 0 && x0 < w2) ? to_f32(row[x0]) : 0.0f;
    const float v1 = (x0 + 1 >= 0 && x0 + 1 < w2) ? to_f32(row[x0 + 1]) : 0.0f;
    // rounded as the plain version's separate products and sum, not
    // contracted into a fused multiply-add: PCVNet's closed-form mixture
    // updates amplify a last-bit difference here to ~2e-2 px in two
    // iterations
    o[lvl * K] = __fadd_rn(__fmul_rn(v0, 1.0f - w), __fmul_rn(v1, w));
  }
}

}  // namespace

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int row_sample_launch(const void* vol0, const void* vol1, const void* vol2,
                                 const void* vol3, int w2_0, int w2_1, int w2_2, int w2_3,
                                 int levels, const float* pos, float* out, long long npix, int K,
                                 int log2_cf, int is_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || npix < 1 || K < 1 || log2_cf < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {{vol0, vol1, vol2, vol3}, {w2_0, w2_1, w2_2, w2_3}};
  const int threads = 256;
  const long long total = npix * K;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    row_sample_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(lv, levels, pos, out, npix, K, log2_cf);
  else
    row_sample_kernel<float><<<blocks, threads, 0, s>>>(lv, levels, pos, out, npix, K, log2_cf);
  return (int)cudaGetLastError();
}
