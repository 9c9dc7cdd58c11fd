// Correlation lookup without a volume (RAFT-Stereo, config "alt_cuda"),
// forward.
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/corr_alt.py
// (corr_lookup_alt_pallas :162; _alt_fwd_impl :107 launching
// _alt_fwd_kernel :60 once per level, :143). For every pixel p = (b, h, w1)
// and level i, with p0 = x/2^i - r, x0 = floor(p0), w = p0 - x0:
//   c[j] = sum_d f1[p, d] * f2_i[b, h, x0 + j, d]   for j = 0..2r+1
//          (c[j] = 0 outside [0, W2_i)),
//   out[p, i*(2r+1) + k] = ((1 - w) c[k] + w c[k+1]) / sqrt(D)
// in fp32: the lookup of the materialized pyramid f1 . pool_i(f2) / sqrt(D)
// (pooling is linear in f2), with no W1 x W2 volume in device memory. That
// is the reference's alt_cuda_corr memory contract: full-resolution frames
// keep only fmap1 and the pooled right features.
//
// What bounds it on the H100: bytes. A pixel reads its D features once and
// 2r+2 columns of D features per level, and writes L*(2r+1) floats; it does
// 2*D FLOPs per column read (one FMA per feature). At the main path's 1/4
// grid of a 1984 x 2880 frame (496 x 720 pixels, D = 256, widths
// 720/360/180/90, r = 4, bf16) fmap1 is 183 MB, the pooled levels at most
// 343 MB and the output 51 MB: ~0.17 ms at 3.35 TB/s. The products are 7.3
// GFLOP, 0.11 ms even on the fp32 CUDA cores.
//
// Design: the TPU kernel multiplies a whole (W1c, D) x (D, W2) row block on
// the MXU and sweeps the volume block with relu(1 - |j - pos|) tap weights,
// W2 products per pixel where 2r+2 are needed (720 vs 10 at full
// resolution). Here one warp owns one pixel and reads only those 2r+2
// columns. Each lane keeps 8 channels of fmap1 (one 16-byte load in bf16)
// per 256 channels in fp32 registers for all levels; a column is one
// contiguous D-element read for the warp (512 bytes in bf16), since the
// port's pyramid is (B, H, W2, D). The column's partial dots are summed
// with warp shuffles; lane k then holds c[k] and c[k+1] and writes tap k,
// so the warp's 2r+1 outputs of a level are one contiguous store. The warps
// of a block are neighbouring pixels of one row, whose windows overlap: the
// columns are read through the read-only cache and mostly hit there or in
// L2. Products and sums are fp32 whatever the feature dtype (bf16 x bf16 is
// exact in fp32, as on the MXU's bf16 path; fp32 features get full fp32
// FMAs, as Precision.HIGHEST; no TF32).
//
// All taps of a (pixel, level) share one fractional weight, and the
// position is clamped before the integer conversion, as K1 and K4 do: a
// coordinate of +-1e9 gives zeros, and so does a NaN (fmaxf(NaN, a) = a),
// where the plain version and the JAX kernel give NaN. Offsets are 64-bit
// (fmap1 at 496 x 720 x 256 is 91 M elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 8;
constexpr int kMaxCols = 2 * kMaxRadius + 2;
constexpr int kVec = 8;           // channels a lane holds per chunk
constexpr int kChunk = 32 * kVec;  // channels a warp covers per chunk
constexpr int kMaxChunks = 2;     // D <= 512
constexpr int kWarps = 8;         // pixels per block

struct Levels {
  const void* f2[kMaxLevels];  // (B*H, W2_i, D)
  int w2[kMaxLevels];
};

// a[i] for a level index only known at run time, without indexing the
// kernel parameter (which would move it to local memory)
template <typename A>
__device__ __forceinline__ A pick(const A (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// 8 consecutive channels as fp32 through the read-only cache
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
corr_alt_kernel(Levels lv, int levels, const T* __restrict__ f1,
                const float* __restrict__ coords, float* __restrict__ out, long long npix,
                int w1, int dim, int radius, float inv_sqrt_d) {
  const int lane = threadIdx.x & 31;
  const long long pix = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  if (pix >= npix) return;  // the whole warp leaves together
  const int taps = 2 * radius + 1;
  const long long row = pix / w1;  // (b, h)

  // this lane's channels of fmap1, fp32, kept for every level
  float a[kMaxChunks][kVec];
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int c = m * kChunk + lane * kVec;
    if (c < dim) {
      load8(f1 + pix * dim + c, a[m]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[m][e] = 0.0f;
    }
  }

  const float x = coords[pix];
  float* o = out + pix * (long long)(levels * taps);
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int w2 = pick(lv.w2, lvl);
    const T* f2 = static_cast<const T*>(pick(lv.f2, lvl)) + row * w2 * dim;
    // x / 2^lvl is exact in fp32; the first tap sits r to the left. Any
    // position left of -(2r+2) or right of w2 reads only zeros: clamp there
    // before converting, so out-of-range floats never reach the int
    float p0 = x * (1.0f / (float)(1 << lvl)) - (float)radius;
    p0 = fminf(fmaxf(p0, -(float)(taps + 2)), (float)(w2 + 1));
    const float f0 = floorf(p0);
    const int x0 = (int)f0;
    const float w = p0 - f0;

    float lo = 0.0f, hi = 0.0f;  // lane k: c[k] and c[k+1]
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j <= taps) {
        const int ix = x0 + j;
        float s = 0.0f;
        if (ix >= 0 && ix < w2) {  // the same for every lane
          const T* col = f2 + (long long)ix * dim;
#pragma unroll
          for (int m = 0; m < kMaxChunks; ++m) {
            const int c = m * kChunk + lane * kVec;
            if (c < dim) {
              float b[kVec];
              load8(col + c, b);
#pragma unroll
              for (int e = 0; e < kVec; ++e) s = fmaf(a[m][e], b[e], s);
            }
          }
          s = warp_sum(s);
        }
        if (lane == j) lo = s;
        if (lane == j - 1) hi = s;
      }
    }
    if (lane < taps) o[lvl * taps + lane] = ((1.0f - w) * lo + w * hi) * inv_sqrt_d;
  }
}

}  // namespace

// f1: (npix, dim) with npix = B*H*w1; f2_i: (B*H, w2_i, dim); all of one
// dtype (is_bf16), 16-byte aligned, dim a multiple of 8 and at most 512.
// coords: (npix) fp32. out: (npix, levels*(2r+1)) fp32. Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int corr_alt_launch(const void* f2_0, const void* f2_1, const void* f2_2,
                               const void* f2_3, int w2_0, int w2_1, int w2_2, int w2_3,
                               int levels, const void* f1, const float* coords, float* out,
                               long long npix, int w1, int dim, int radius, int is_bf16,
                               void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius || npix < 1 ||
      w1 < 1 || dim < kVec || dim % kVec != 0 || dim > kMaxChunks * kChunk)
    return (int)cudaErrorInvalidValue;
  Levels lv = {{f2_0, f2_1, f2_2, f2_3}, {w2_0, w2_1, w2_2, w2_3}};
  const long long blocks = (npix + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float inv_sqrt_d = 1.0f / sqrtf((float)dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    corr_alt_kernel<__nv_bfloat16><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        lv, levels, static_cast<const __nv_bfloat16*>(f1), coords, out, npix, w1, dim, radius,
        inv_sqrt_d);
  else
    corr_alt_kernel<float><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        lv, levels, static_cast<const float*>(f1), coords, out, npix, w1, dim, radius,
        inv_sqrt_d);
  return (int)cudaGetLastError();
}
