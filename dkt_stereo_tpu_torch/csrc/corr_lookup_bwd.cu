// Correlation-pyramid lookup, backward (RAFT-Stereo, config "reg_cuda").
//
// Replaces the Pallas TPU kernel of the lookup's VJP,
// dkt_stereo_tpu/ops/pallas/corr_lookup.py (_lookup_bwd_impl :254, kernel
// body _bwd_kernel :63; large frames _lookup_bwd_chunked :170 with
// _bwd_kernel_level :152). Given g = dL/d(out) of shape (B, H, W1, L*(2r+1))
// fp32, it writes dL/d(vol_i) for every level i, (B, H, W1, W2_i) in the
// pyramid's dtype (bf16 or fp32). The coordinates get no gradient: RAFT
// detaches them every iteration.
//
// What bounds it on the H100: bytes. Every element of every level is written
// once (zeros included: the output is dense), while g and the coordinates are
// read once. At B=8, 80 x 180 pixels, 4 levels, r = 4, bf16, that is 77.6 MB
// written against 17 MB read, with a handful of FLOPs per element.
//
// Design: the TPU kernel sweeps whole rows with relu(1 - |j - pos|) weights
// because it has no cheap scatter. Here each output row dvol_i[b, h, w1, :]
// depends only on pixel (b, h, w1)'s own coordinate and its 2r+1 gradient
// values, so every row has exactly one writer: no atomics and no separate
// zero fill. One warp owns one (pixel, level) row and writes all W2_i
// entries in coalesced passes; entries outside x0 .. x0+2r+1 are 0. The
// position is clamped and split into x0 and one fractional weight w exactly
// as corr_lookup.cu does, so this kernel is the exact transpose of the
// forward kernel: forward out[k] = v[x0+k]*(1-w) + v[x0+k+1]*w gives
// dvol[x0+j] = g[j]*(1-w) + g[j-1]*w, with g[-1] = g[2r+1] = 0, summed in
// fp32 and rounded once to the level's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 8;
constexpr int kWarpsPerBlock = 8;

struct Grads {
  void* dvol[kMaxLevels];
  int w2[kMaxLevels];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void corr_lookup_bwd_kernel(Grads grads, int levels, const float* __restrict__ coords,
                                       const float* __restrict__ g, long long npix, int radius) {
  const int lvl = blockIdx.y;
  const long long pix = blockIdx.x * (long long)kWarpsPerBlock + threadIdx.y;
  if (pix >= npix) return;
  const int taps = 2 * radius + 1;
  const int w2 = grads.w2[lvl];

  // the forward kernel's position arithmetic, unchanged (corr_lookup.cu)
  float p0 = coords[pix] * (1.0f / (float)(1 << lvl)) - (float)radius;
  p0 = fminf(fmaxf(p0, -(float)(taps + 2)), (float)(w2 + 1));
  const float f0 = floorf(p0);
  const int x0 = (int)f0;
  const float w = p0 - f0;

  const float* gp = g + pix * (long long)(levels * taps) + lvl * taps;
  T* row = static_cast<T*>(grads.dvol[lvl]) + pix * (long long)w2;
  for (int ix = threadIdx.x; ix < w2; ix += 32) {
    const int j = ix - x0;
    float v = 0.0f;
    if (j >= 0 && j <= taps) {
      if (j < taps) v = gp[j] * (1.0f - w);
      if (j > 0) v += gp[j - 1] * w;
    }
    store(row + ix, v);
  }
}

}  // namespace

// Launch on `stream`. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int corr_lookup_bwd_launch(void* dvol0, void* dvol1, void* dvol2, void* dvol3, int w2_0,
                                      int w2_1, int w2_2, int w2_3, int levels,
                                      const float* coords, const float* g, long long npix,
                                      int radius, int is_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius || npix < 1)
    return (int)cudaErrorInvalidValue;
  Grads grads = {{dvol0, dvol1, dvol2, dvol3}, {w2_0, w2_1, w2_2, w2_3}};
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((unsigned)((npix + kWarpsPerBlock - 1) / kWarpsPerBlock), (unsigned)levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    corr_lookup_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(grads, levels, coords, g, npix, radius);
  else
    corr_lookup_bwd_kernel<float><<<grid, block, 0, s>>>(grads, levels, coords, g, npix, radius);
  return (int)cudaGetLastError();
}
