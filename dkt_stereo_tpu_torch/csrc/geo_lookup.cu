// Combined geometry-encoding volume lookup (IGEV-Stereo, every
// corr_implementation on CUDA tensors), forward.
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/geo_lookup.py
// (geo_lookup_pallas :302; _geo_fwd_impl :175 launching _fwd_level_kernel
// :82 once per level, :204). For every pixel p = (b, h, w1) and level i it
// samples, with 2r+1 linear taps and zero padding,
//   - each of the C channels of the geo volume geo_i[p, :, c] (D_i slots,
//     channel-minor) at disp/2^i + k - r, and
//   - the init-correlation row corr_i[p, :] (W2_i entries) at
//     (coords - disp)/2^i + k - r,
// and writes out[p, i*(C+1)*(2r+1) + c*(2r+1) + k] in fp32: per level the C
// geo channels C-major with the taps fast, then the 2r+1 corr taps.
//
// What bounds it on the H100: bytes. Per pixel it writes L*(C+1)*(2r+1) fp32
// values (648 B at C=8, r=4, L=2) and reads 2r+2 geo slots of C values and
// 2r+2 corr values per level; there are a few FLOPs per byte. At the main
// path's 184 x 320 pixels that is ~38 MB written and ~22 MB read per launch
// in bf16, so the written output is two thirds of the traffic.
//
// Design: the TPU kernel forms each tap as a one-hot selector matmul over
// whole rows (with a bf16x2 split for fp32 accuracy) because the TPU has no
// cheap gather; here the taps are read directly. One thread owns one
// (pixel, level, part), part = a geo channel c < C or the corr row (c = C),
// so thread t's outputs are out[t*(2r+1) .. t*(2r+1)+2r] and a block's
// outputs are one contiguous span. Each thread writes its 2r+1 values to
// shared memory (an odd stride: no bank conflicts), and the block then
// stores the span with consecutive threads on consecutive floats, so every
// warp store fills whole 128-byte lines. The C threads of a (pixel, level)
// read the same D slots at neighbouring channels (16 B per slot in bf16).
// All taps of one (pixel, level, part) share one fractional weight, so a
// thread reads its 2r+2 consecutive values once and emits 2r+1 outputs.
// The levels are separate tensors of different sizes, passed as pointers
// and sizes and picked with selects (an indexed kernel parameter would be
// copied to local memory): nothing is concatenated per call. Volumes are
// read as bf16 or fp32; interpolation is fp32.
//
// The position is clamped before the integer conversion, so a disparity of
// +-1e9 gives zeros. A NaN position is clamped to the far left
// (fmaxf(NaN, a) = a) and also gives zeros, where the plain version and the
// JAX kernel give NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 8;
constexpr int kMaxVals = 2 * kMaxRadius + 2;

struct Levels {
  const void* geo[kMaxLevels];   // (npix, D_i, C)
  const void* corr[kMaxLevels];  // (npix, W2_i)
  int depth[kMaxLevels];
  int w2[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a[i] for a level index only known at run time, without indexing the
// kernel parameter (which would move it to local memory)
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

template <typename T>
__global__ void geo_lookup_kernel(Levels lv, int levels, int channels,
                                  const float* __restrict__ disp,
                                  const float* __restrict__ coords, float* __restrict__ out,
                                  long long npix, int radius) {
  extern __shared__ float stage[];  // blockDim.x * (2r+1) outputs
  const int parts = channels + 1;
  const int taps = 2 * radius + 1;
  const long long total = npix * levels * parts;
  const long long first = blockIdx.x * (long long)blockDim.x;
  const long long t = first + threadIdx.x;

  if (t < total) {
    const long long pix = t / (levels * parts);
    const int rem = (int)(t - pix * levels * parts);
    const int lvl = rem / parts;
    const int c = rem - lvl * parts;
    // x / 2^lvl is exact in fp32
    const float scale = 1.0f / (float)(1 << lvl);
    const float d = disp[pix];

    const T* src;
    long long stride;
    int n;
    float x;
    if (c < channels) {  // geo channel c, along disparity
      n = pick(lv.depth, lvl);
      src = static_cast<const T*>(pick(lv.geo, lvl)) + pix * (long long)n * channels + c;
      stride = channels;
      x = d * scale;
    } else {  // init correlation, along the right image's width
      n = pick(lv.w2, lvl);
      src = static_cast<const T*>(pick(lv.corr, lvl)) + pix * (long long)n;
      stride = 1;
      x = (coords[pix] - d) * scale;
    }

    // the first tap sits r to the left; any position left of -(2r+2) or
    // right of n reads only zeros: clamp there before converting to int
    float p0 = x - (float)radius;
    p0 = fminf(fmaxf(p0, -(float)(taps + 2)), (float)(n + 1));
    const float f0 = floorf(p0);
    const int x0 = (int)f0;
    const float w = p0 - f0;

    float v[kMaxVals];
#pragma unroll
    for (int j = 0; j < kMaxVals; ++j) {
      const int ix = x0 + j;
      v[j] = (j <= taps && ix >= 0 && ix < n) ? to_f32(src[ix * stride]) : 0.0f;
    }
    float* o = stage + threadIdx.x * taps;
#pragma unroll
    for (int k = 0; k < kMaxVals - 1; ++k) {
      if (k < taps) o[k] = v[k] * (1.0f - w) + v[k + 1] * w;
    }
  }
  __syncthreads();
  // the block's outputs: out[first*taps ..], contiguous, stored coalesced
  const long long mine = total - first < blockDim.x ? total - first : blockDim.x;
  const int count = (int)mine * taps;
  float* dst = out + first * taps;
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = stage[i];
}

}  // namespace

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int geo_lookup_launch(const void* geo0, const void* geo1, const void* geo2,
                                 const void* geo3, const void* corr0, const void* corr1,
                                 const void* corr2, const void* corr3, int d0, int d1, int d2,
                                 int d3, int w2_0, int w2_1, int w2_2, int w2_3, int levels,
                                 int channels, const float* disp, const float* coords,
                                 float* out, long long npix, int radius, int is_bf16,
                                 void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius || npix < 1 ||
      channels < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv = {{geo0, geo1, geo2, geo3},
               {corr0, corr1, corr2, corr3},
               {d0, d1, d2, d3},
               {w2_0, w2_1, w2_2, w2_3}};
  const int threads = 256;
  const size_t smem = threads * (2 * radius + 1) * sizeof(float);  // <= 17 KB
  const long long total = npix * levels * (channels + 1);
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    geo_lookup_kernel<__nv_bfloat16><<<blocks, threads, smem, s>>>(lv, levels, channels, disp,
                                                                   coords, out, npix, radius);
  else
    geo_lookup_kernel<float><<<blocks, threads, smem, s>>>(lv, levels, channels, disp, coords,
                                                           out, npix, radius);
  return (int)cudaGetLastError();
}
