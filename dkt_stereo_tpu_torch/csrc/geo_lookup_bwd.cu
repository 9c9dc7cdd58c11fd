// Combined geometry-encoding volume lookup (IGEV-Stereo, K4), backward:
// d/dgeo and d/dcorr of every level from the lookup's incoming gradient g.
//
// Replaces the Pallas TPU kernels of dkt_stereo_tpu/ops/pallas/geo_lookup.py
// (_geo_bwd_impl :223): _bwd_geo_kernel (:119, launched at :261) and
// _bwd_corr_kernel (:153, launched at :285), one pallas_call per level each.
// Here each kernel covers every level in one launch (blockIdx.y = level, the
// level's pointer and size picked with selects, as in csrc/geo_lookup.cu).
//
// It is the exact transpose of the port's forward kernel csrc/geo_lookup.cu,
// not of the JAX arithmetic: the forward shares one fractional weight w
// across the 2r+1 taps of a (pixel, level, part) and reads the 2r+2 slots
// x0 .. x0+2r+1, with
//   out[k] = v[x0+k] * (1-w) + v[x0+k+1] * w,   k = 0 .. 2r.
// So slot s = x0 + j (0 <= j <= 2r+1) of that pixel's row receives
//   dv[s] = g[j] * (1-w) [j <= 2r] + g[j-1] * w [j >= 1],
// and every other slot receives 0. first_tap() below computes p0, x0 and w
// with the forward's expressions (an exact copy of geo_lookup.cu:106-112):
// the position is clamped to [-(2r+3), n+1] before the integer conversion,
// so +-1e9 gives zeros, and a NaN position clamps to the far left
// (fmaxf(NaN, a) = a) and gives zeros too, where the plain twin and the JAX
// kernel give NaN.
//
// Outputs, in the pyramid's dtype (bf16 or fp32, the math in fp32, rounded
// once at the store):
//   dgeo_i  (npix, D_i, C), channel-minor: element (p, s, c) reads g[p, i*
//           (C+1)*(2r+1) + c*(2r+1) + j] and j-1 with j = s - x0(disp/2^i);
//   dcorr_i (npix, W2_i): element (p, s) reads g[p, i*(C+1)*(2r+1) +
//           C*(2r+1) + j] and j-1 with j = s - x0((coords - disp)/2^i).
//
// What bounds it on the H100: bytes. Every output element is written once
// (zeros outside the tap window: 132.7 MB of bf16 dgeo and 62.2 MB of dcorr
// at the training shape 8 x 80 x 180, D 48/24 x 8, W2 180/90), and the
// window reads its pixel's g slice (66.4 MB and 8.3 MB of fp32). The design
// is the gather form: one thread produces kRun = 8 consecutive elements of a
// level's flat output and writes them with one 16-byte store (bf16) or two
// (fp32), so a warp stores 512 or 1,024 contiguous bytes; no atomics and no
// memset pass. A thread finds its elements' pixel, slot and channel once and
// steps them along; the g values of a pixel (648 B at C=8, r=4, L=2) are
// read through L1 by the threads that share the pixel. Most elements lie
// outside the window (2r+2 of D_i slots, of W2_i entries) and read nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 8;
constexpr int kRun = 8;  // consecutive outputs per thread
constexpr int kThreads = 256;

struct Grads {
  void* out[kMaxLevels];  // dgeo_i (npix, D_i, C) or dcorr_i (npix, W2_i)
  int n[kMaxLevels];      // D_i or W2_i
};

template <typename A>
__device__ __forceinline__ A pick(const A (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The forward kernel's first tap and shared fractional weight
// (csrc/geo_lookup.cu:106-112, the same expressions).
__device__ __forceinline__ void first_tap(float x, int radius, int n, int& x0, float& w) {
  const int taps = 2 * radius + 1;
  float p0 = x - (float)radius;
  p0 = fminf(fmaxf(p0, -(float)(taps + 2)), (float)(n + 1));
  const float f0 = floorf(p0);
  x0 = (int)f0;
  w = p0 - f0;
}

__device__ __forceinline__ void store_run(float* dst, const float (&v)[kRun], int count) {
  if (count == kRun) {  // 32-byte aligned: the run starts at a multiple of 8
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int i = 0; i < count; ++i) dst[i] = v[i];
  }
}

__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float (&v)[kRun], int count) {
  if (count == kRun) {  // 16-byte aligned
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < kRun / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = packed;
  } else {
    for (int i = 0; i < count; ++i) dst[i] = __float2bfloat16_rn(v[i]);
  }
}

// One thread: elements [e0, e0 + kRun) of level blockIdx.y's flat output.
// kGeo: the geo volume (row of n*C per pixel, positions disp/2^i); else the
// init correlation (row of n per pixel, positions (coords - disp)/2^i).
template <typename T, bool kGeo>
__device__ __forceinline__ void transpose_taps(const Grads& gr, int levels, int channels,
                                               const float* __restrict__ disp,
                                               const float* __restrict__ coords,
                                               const float* __restrict__ g, long long npix,
                                               int radius) {
  const int lvl = blockIdx.y;
  const int taps = 2 * radius + 1;
  const int n = pick(gr.n, lvl);
  const int C = kGeo ? channels : 1;
  const int row = n * C;  // outputs per pixel
  const long long total = npix * row;
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kRun;
  if (e0 >= total) return;

  // x / 2^lvl is exact in fp32
  const float scale = 1.0f / (float)(1 << lvl);
  const long long gstride = (long long)levels * (channels + 1) * taps;
  const int goff = lvl * (channels + 1) * taps + (kGeo ? 0 : channels * taps);

  long long pix = e0 / row;
  const int col = (int)(e0 - pix * row);
  int slot = col / C;
  int c = col - slot * C;
  long long cur = -1;
  int x0 = 0;
  float w = 0.0f;
  const float* gp = g;

  float v[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    float acc = 0.0f;
    if (e0 + i < total) {
      if (pix != cur) {
        cur = pix;
        const float d = disp[pix];
        first_tap(kGeo ? d * scale : (coords[pix] - d) * scale, radius, n, x0, w);
        gp = g + pix * gstride + goff;
      }
      const int j = slot - x0;
      if (j >= 0 && j <= taps) {
        const float* gc = gp + c * taps;
        if (j < taps) acc += gc[j] * (1.0f - w);
        if (j >= 1) acc += gc[j - 1] * w;
      }
      if (++c == C) {
        c = 0;
        if (++slot == n) {
          slot = 0;
          ++pix;
        }
      }
    }
    v[i] = acc;
  }
  const long long left = total - e0;
  store_run(static_cast<T*>(pick(gr.out, lvl)) + e0, v, left < kRun ? (int)left : kRun);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    geo_lookup_bwd_geo_kernel(Grads gr, int levels, int channels, const float* __restrict__ disp,
                              const float* __restrict__ g, long long npix, int radius) {
  transpose_taps<T, true>(gr, levels, channels, disp, nullptr, g, npix, radius);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    geo_lookup_bwd_corr_kernel(Grads gr, int levels, int channels,
                               const float* __restrict__ disp, const float* __restrict__ coords,
                               const float* __restrict__ g, long long npix, int radius) {
  transpose_taps<T, false>(gr, levels, channels, disp, coords, g, npix, radius);
}

int launch(bool geo, void* o0, void* o1, void* o2, void* o3, int n0, int n1, int n2, int n3,
           int levels, int channels, const float* disp, const float* coords, const float* g,
           long long npix, int radius, int is_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius || npix < 1 ||
      channels < 1)
    return (int)cudaErrorInvalidValue;
  Grads gr = {{o0, o1, o2, o3}, {n0, n1, n2, n3}};
  long long most = 0;
  for (int i = 0; i < levels; ++i) {
    // the vector stores need 16-byte aligned level tensors
    if (gr.n[i] < 1 || reinterpret_cast<uintptr_t>(gr.out[i]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const long long runs = (npix * gr.n[i] * (geo ? channels : 1) + kRun - 1) / kRun;
    most = runs > most ? runs : most;
  }
  const dim3 grid((unsigned)((most + kThreads - 1) / kThreads), (unsigned)levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (geo) {
    if (is_bf16)
      geo_lookup_bwd_geo_kernel<__nv_bfloat16>
          <<<grid, kThreads, 0, s>>>(gr, levels, channels, disp, g, npix, radius);
    else
      geo_lookup_bwd_geo_kernel<float>
          <<<grid, kThreads, 0, s>>>(gr, levels, channels, disp, g, npix, radius);
  } else {
    if (is_bf16)
      geo_lookup_bwd_corr_kernel<__nv_bfloat16>
          <<<grid, kThreads, 0, s>>>(gr, levels, channels, disp, coords, g, npix, radius);
    else
      geo_lookup_bwd_corr_kernel<float>
          <<<grid, kThreads, 0, s>>>(gr, levels, channels, disp, coords, g, npix, radius);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch functions take the same arguments: four output level pointers
// (dgeo or dcorr), four sizes (D_i or W2_i), the level count, the geo
// channels C, disp and coords (B*H*W fp32 each; the geo kernel ignores
// coords), g (B*H*W x L*(C+1)*(2r+1) fp32, dense), pixels, radius, bf16
// flag, stream. Each returns cudaGetLastError() after the launch (0 = ok).
extern "C" int geo_lookup_bwd_geo_launch(void* o0, void* o1, void* o2, void* o3, int n0, int n1,
                                         int n2, int n3, int levels, int channels,
                                         const float* disp, const float* coords, const float* g,
                                         long long npix, int radius, int is_bf16, void* stream) {
  return launch(true, o0, o1, o2, o3, n0, n1, n2, n3, levels, channels, disp, coords, g, npix,
                radius, is_bf16, stream);
}

extern "C" int geo_lookup_bwd_corr_launch(void* o0, void* o1, void* o2, void* o3, int n0, int n1,
                                          int n2, int n3, int levels, int channels,
                                          const float* disp, const float* coords, const float* g,
                                          long long npix, int radius, int is_bf16, void* stream) {
  return launch(false, o0, o1, o2, o3, n0, n1, n2, n3, levels, channels, disp, coords, g, npix,
                radius, is_bf16, stream);
}
