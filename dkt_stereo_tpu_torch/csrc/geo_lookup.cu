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
// The levels are separate tensors of different sizes, passed in a
// parameter block of up to kMaxLevels pointers and sizes that each block
// copies into shared memory (a warp's threads read several levels):
// nothing is concatenated per call. Volumes are read as bf16 or fp32;
// interpolation is fp32. Radii up to kMaxRadius keep the 2r+2 values in
// registers; larger ones (kWide) slide a two-value window along the row, the
// same arithmetic; any radius whose staging fits shared memory. At the
// shipped radius 4 the sliding window took 22-26 % longer on the H100
// (chip_smoke.py phase 10's A/B), so both stay.
//
// The position is clamped before the integer conversion, so a disparity of
// +-1e9 gives zeros. A NaN position is clamped to the far left
// (fmaxf(NaN, a) = a) for its reads, but its weight comes from the
// unclamped position, so its outputs are NaN, as in the plain version and
// the JAX kernel: a NaN disparity makes every output of its pixel NaN, a
// NaN coordinate its corr taps. An infinite position gives NaN too, as in
// the plain version (JAX's relu weights give zeros there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxRadius = 8;  // the register window's radius
constexpr int kMaxVals = 2 * kMaxRadius + 2;
constexpr int kThreads = 256;
constexpr long long kMaxSmem = 232448;  // a block's shared memory on the H100

struct Levels {
  const void* geo[kMaxLevels];   // (npix, D_i, C)
  const void* corr[kMaxLevels];  // (npix, W2_i)
  int depth[kMaxLevels];
  int w2[kMaxLevels];
};

struct Level {
  const void* geo;
  const void* corr;
  int depth, w2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 2^-lvl, exact: x * 2^-lvl equals x / 2^lvl
__device__ __forceinline__ float pow2_neg(int lvl) { return __int_as_float((127 - lvl) << 23); }

// bytes of one block's shared memory: the levels' table, then the outputs
__host__ __device__ inline long long smem_bytes(int levels, int radius) {
  return (long long)levels * sizeof(Level) + (long long)kThreads * (2 * radius + 1) * 4;
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
    geo_lookup_kernel(const __grid_constant__ Levels lv, int levels, int channels,
                      const float* __restrict__ disp, const float* __restrict__ coords,
                      float* __restrict__ out, long long npix, int radius) {
  extern __shared__ __align__(16) unsigned char smem[];
  Level* table = reinterpret_cast<Level*>(smem);
  float* stage = reinterpret_cast<float*>(smem + levels * sizeof(Level));  // kThreads*(2r+1)
  for (int i = threadIdx.x; i < levels; i += kThreads)
    table[i] = Level{lv.geo[i], lv.corr[i], lv.depth[i], lv.w2[i]};
  __syncthreads();
  const int parts = channels + 1;
  const int taps = 2 * radius + 1;
  const long long total = npix * levels * parts;
  const long long first = blockIdx.x * (long long)kThreads;
  const long long t = first + threadIdx.x;

  if (t < total) {
    const long long pix = t / (levels * parts);
    const int rem = (int)(t - pix * levels * parts);
    const int lvl = rem / parts;
    const int c = rem - lvl * parts;
    const Level L = table[lvl];
    // x / 2^lvl is exact in fp32
    const float scale = pow2_neg(lvl);
    const float d = disp[pix];

    const T* src;
    long long stride;
    int n;
    float x;
    if (c < channels) {  // geo channel c, along disparity
      n = L.depth;
      src = static_cast<const T*>(L.geo) + pix * (long long)n * channels + c;
      stride = channels;
      x = d * scale;
    } else {  // init correlation, along the right image's width
      n = L.w2;
      src = static_cast<const T*>(L.corr) + pix * (long long)n;
      stride = 1;
      x = (coords[pix] - d) * scale;
    }

    // the first tap sits r to the left; any position left of -(2r+2) or
    // right of n reads only zeros: clamp there before converting to int
    const float p = x - (float)radius;
    const float p0 = fminf(fmaxf(p, -(float)(taps + 2)), (float)(n + 1));
    const float f0 = floorf(p0);
    const int x0 = (int)f0;
    // the weight from the unclamped position: equal where the clamp does not
    // move it, NaN for a NaN one (and an infinite one, as in the plain
    // version); where the clamp moves it, the window reads only zeros and
    // the taps are +0. (A select on isnan here raised the bf16 kernel's
    // registers from 32 to 40 and ran slower on the H100.)
    const float w = p - f0;

    float* o = stage + threadIdx.x * taps;
    if (!kWide) {
      float v[kMaxVals];
#pragma unroll
      for (int j = 0; j < kMaxVals; ++j) {
        const int ix = x0 + j;
        v[j] = (j <= taps && ix >= 0 && ix < n) ? to_f32(src[ix * stride]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kMaxVals - 1; ++k) {
        if (k < taps) o[k] = v[k] * (1.0f - w) + v[k + 1] * w;
      }
    } else {
      float a = (x0 >= 0 && x0 < n) ? to_f32(src[x0 * stride]) : 0.0f;
      for (int k = 0; k < taps; ++k) {
        const int ix = x0 + k + 1;
        const float b = (ix >= 0 && ix < n) ? to_f32(src[ix * stride]) : 0.0f;
        o[k] = a * (1.0f - w) + b * w;
        a = b;
      }
    }
  }
  __syncthreads();
  // the block's outputs: out[first*taps ..], contiguous, stored coalesced
  const long long mine = total - first < kThreads ? total - first : kThreads;
  const int count = (int)mine * taps;
  float* dst = out + first * taps;
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = stage[i];
}

template <typename T, bool kWide>
int launch(const Levels& lv, int levels, int channels, const float* disp, const float* coords,
           float* out, long long npix, int radius, cudaStream_t s) {
  const long long bytes = smem_bytes(levels, radius);
  auto kernel = geo_lookup_kernel<T, kWide>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = npix * levels * (channels + 1);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, bytes, s>>>(lv, levels, channels, disp, coords, out, npix, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
extern "C" long long geo_lookup_smem_bytes(int levels, int radius) {
  return smem_bytes(levels, radius);
}

// Launch on `stream`: `geo`, `corr`, `depths` and `widths` hold one entry
// per level. Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments it refuses.
extern "C" int geo_lookup_launch(const void* const* geo, const void* const* corr,
                                 const int* depths, const int* widths, int levels, int channels,
                                 const float* disp, const float* coords, float* out,
                                 long long npix, int radius, int is_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || npix < 1 || channels < 1 ||
      smem_bytes(levels, radius) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int i = 0; i < levels; ++i) {
    if (depths[i] < 1 || widths[i] < 1) return (int)cudaErrorInvalidValue;
    lv.geo[i] = geo[i];
    lv.corr[i] = corr[i];
    lv.depth[i] = depths[i];
    lv.w2[i] = widths[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = radius > kMaxRadius;
  if (is_bf16)
    return wide ? launch<__nv_bfloat16, true>(lv, levels, channels, disp, coords, out, npix,
                                              radius, s)
                : launch<__nv_bfloat16, false>(lv, levels, channels, disp, coords, out, npix,
                                               radius, s);
  return wide ? launch<float, true>(lv, levels, channels, disp, coords, out, npix, radius, s)
              : launch<float, false>(lv, levels, channels, disp, coords, out, npix, radius, s);
}
