// Gaussian row sampling (PCVNet's correlation lookup, K5), forward: writes
// the motion encoder's folded input directly.
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/row_sample.py
// (row_sample_pallas :145; _row_sample_impl :87 launching _fwd_kernel :33 at
// :94), which PCVNet calls once per pyramid level (nn/pcv.py:100-115). Here
// one launch covers every level: for every pixel (b, h, w) and sample
// k = g*S + s (G Gaussians of S samples) it reads the level-0 position
// pos[b, h, w, k] and at level l samples the volume row vol_l[b, h, w, :] at
// pos / cf^l (linear, zero padding). The value lands at channel l*S + s of
// image b*G + g of the folded (B*G, L*S, H, W) tensor that convc1 reads, in
// the compute dtype (bf16 under mixed precision, else fp32): the plain
// twin's fp32 value, rounded once. The folded tensor is channels-last in
// memory ((B, G, H, W, L, S)), what cuDNN's NHWC convolutions read without a
// layout transform.
//
// What bounds it on the H100: bytes. A pixel reads its K fp32 positions and
// its rows' taps and writes L*K values; a few FLOPs per byte. At the PCV
// training step (8 x 80 x 180 pixels, K = 36, widths 180/45/11, bf16 levels,
// bf16 out) that is 16.6 MB of positions, 24.9 MB written and at most 54.4
// MB of rows (~20 MB of distinct taps; the taps of 36 positions touch nearly
// every 32-byte sector of a 360-byte row): ~0.018 ms at 3.35 TB/s by the
// taps, ~0.029 ms by whole rows.
//
// Design. The first port ran a thread a (pixel, k): a 64-bit division, a
// position load and per level two dependent 2-byte gathers and a 4-byte
// store, 16 bytes of work in flight a thread: latency-bound at 31 % of its
// bound. The TPU kernel sweeps whole rows with relu(1 - |j - pos|) weights
// (W2 multiply-adds where 2 are needed); here the rows are staged and the two
// taps read. A block owns a tile of P consecutive pixels of one image (P a
// power of two, 8..64, from the wrapper's plan), 4 threads a pixel:
//   1. every byte the tile reads is one contiguous span: its positions, and
//      for each level its P rows. Each span is copied by cp.async as the
//      aligned 16-byte chunks that cover it (spans start anywhere), all
//      issued before anything waits, level 0's rows (most of the bytes) in
//      a group of their own;
//   2. a thread keeps one pixel and steps through its samples k, 4 apart
//      (a warp's lanes on neighbouring pixels, so their stores to the
//      staging area are neighbours), and for each level computes the tap
//      pair from shared memory with the plain twin's fp32 operations in its
//      order (__fmul_rn/__fadd_rn, not contracted: PCVNet's closed-form
//      mixture updates amplify a last-bit difference to ~2e-2 px in two
//      iterations), rounds once to the output dtype and writes the folded
//      position in the staging area. The coarse levels go first, while level
//      0's rows are still arriving;
//   3. the tile's output is G contiguous runs of the folded tensor, one a
//      Gaussian, of P*L*S values each. Each run is staged at its
//      destination's alignment mod 16, so the block writes it as aligned
//      16-byte vectors, with element stores only at a run's ragged ends.
// What holds it above its bound: the rows are read whole (the taps of 36
// positions touch nearly every sector of a row anyway), and the tap
// arithmetic is not hidden behind the copies. A persistent, double-buffered
// block, lanes on the samples of one pixel, positions read bank-conflict-free
// and 1-8 warps a block were all slower on the H100.
// No 64-bit division: the pixel's image and column come from the grid; a
// thread steps its samples' Gaussian and index along. Non-finite positions
// give NaN, as the plain twin's floor/subtract does; finite positions are
// clamped to [-2, w2 + 1] before the integer conversion, which moves only
// positions whose taps all lie outside the row, so +-1e9 reads nothing and
// gives zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsPerPixel = 4;  // a block is 4 threads a pixel of its tile
constexpr int kMaxLevels = 32;
constexpr long long kMaxSmem = 232448;  // a block's shared memory on the H100

struct Levels {
  const void* vol[kMaxLevels];
  int w2[kMaxLevels];
};

__host__ __device__ inline long long round16(long long b) { return (b + 15) / 16 * 16; }
// a span copied or staged from anywhere in its first 16-byte chunk
__host__ __device__ inline long long span_bytes(long long b) { return round16(b) + 16; }

// Shared memory of one block: the levels' row offsets, the positions, each
// level's rows, then the output runs. Mirrored by
// ops/cuda/row_sample.py::fwd_smem_bytes.
struct Plan {
  long long slot, pos_off, lvl_off, out_off, bytes;
};

__host__ __device__ inline Plan make_plan(const int* w2, int levels, int K, int G, int ev, int eo,
                                          int pixels) {
  Plan pl;
  const long long LS = (long long)levels * (K / G);
  pl.slot = span_bytes(pixels * LS * eo);  // one run a Gaussian
  pl.pos_off = round16(levels * 4);
  pl.lvl_off = pl.pos_off + span_bytes((long long)pixels * K * 4);
  long long off = pl.lvl_off;
  for (int i = 0; i < levels; ++i) off += span_bytes((long long)pixels * w2[i] * ev);
  pl.out_off = off;
  pl.bytes = off + G * pl.slot;
  return pl;
}

__device__ __forceinline__ float to_f32(const float* p) { return *p; }
__device__ __forceinline__ float to_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread's copies but the most recent has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the aligned 16-byte chunks covering [a, a + nbytes) into dst, by the block
__device__ __forceinline__ void copy_span(unsigned char* dst, uintptr_t a, long long nbytes) {
  const uintptr_t c0 = a & ~static_cast<uintptr_t>(15);
  const int n = (int)((((a + nbytes - 1) & ~static_cast<uintptr_t>(15)) - c0) / 16) + 1;
  for (int q = threadIdx.x; q < n; q += blockDim.x) cp_async16(dst + 16 * q, c0 + 16 * q);
}

// 2^-n, exact: x * 2^-n equals the plain twin's x / cf**l
__device__ __forceinline__ float pow2_neg(int n) { return __int_as_float((127 - n) << 23); }

// element index of run r's (Gaussian r's) first value for the tile at (b, hw0)
__device__ __forceinline__ long long run_start(long long b, int r, int G, int LS, int HW,
                                               int hw0) {
  return ((b * G + r) * HW + hw0) * LS;
}

template <typename TV, typename TO>
__global__ void __launch_bounds__(64 * kThreadsPerPixel)
    row_sample_kernel(const __grid_constant__ Levels lv, int levels,
                      const float* __restrict__ pos, TO* __restrict__ out, int HW, int K, int G,
                      int log2_cf, int log2_pixels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = 1 << log2_pixels;
  const Plan pl = make_plan(lv.w2, levels, K, G, sizeof(TV), sizeof(TO), P);
  const int b = blockIdx.y, hw0 = blockIdx.x * P;
  const int np = min(P, HW - hw0);
  const long long pix0 = (long long)b * HW + hw0;
  const int S = K / G, LS = levels * S;
  int* lbase = reinterpret_cast<int*>(smem);  // smem offset of each level's first row

  // 1. the tile's positions and rows, every copy issued before any wait:
  // the positions and the coarse levels in one group, level 0 in a second
  const uintptr_t pa = reinterpret_cast<uintptr_t>(pos + pix0 * K);
  copy_span(smem + pl.pos_off, pa, (long long)np * K * 4);
  for (int g = 0; g < 2; ++g) {
    long long off = pl.lvl_off;
    for (int l = 0; l < levels; ++l) {
      const int w2 = lv.w2[l];
      if ((l == 0) == (g == 1)) {
        const uintptr_t a =
            reinterpret_cast<uintptr_t>(static_cast<const TV*>(lv.vol[l]) + pix0 * w2);
        copy_span(smem + off, a, (long long)np * w2 * sizeof(TV));
        if (threadIdx.x == 0) lbase[l] = (int)(off + (a & 15));
      }
      off += span_bytes((long long)P * w2 * sizeof(TV));
    }
    cp_async_commit();
  }

  // 2. the taps, as the plain twin computes them, into the folded runs. A
  // thread keeps its pixel and steps through the samples k,
  // kThreadsPerPixel apart, without a division; the coarse levels
  // go while level 0's rows are still arriving
  const float* pos_s = reinterpret_cast<const float*>(smem + pl.pos_off + (pa & 15));
  unsigned char* stage = smem + pl.out_off;
  const int slot = (int)pl.slot;
  const int p = threadIdx.x & (P - 1), kstep = kThreadsPerPixel;
  // run gi's misalignment mod 16, from the low 32 bits of its address:
  // run0 + gi * run_step
  const unsigned run_step = (unsigned)HW * (unsigned)LS * (unsigned)sizeof(TO);
  const unsigned run0 = (unsigned)reinterpret_cast<uintptr_t>(out) +
                        (unsigned)b * (unsigned)G * run_step +
                        (unsigned)hw0 * (unsigned)LS * (unsigned)sizeof(TO);
  const int k0 = threadIdx.x >> log2_pixels, gi0 = k0 / S, s0 = k0 - gi0 * S;
  auto level_taps = [&](int l) {
    const int w2 = lv.w2[l];
    const float sc = pow2_neg(l * log2_cf), hi = (float)(w2 + 1);
    const TV* row = reinterpret_cast<const TV*>(smem + lbase[l]) + p * w2;
    int gi = gi0, s = s0;
    for (int k = k0; k < K; k += kstep) {
      const float x = pos_s[p * K + k];
      float v = __int_as_float(0x7fc00000);  // NaN
      if (isfinite(x)) {
        const float xs = fminf(fmaxf(x * sc, -2.0f), hi);
        const float f = floorf(xs);
        const int i0 = (int)f;
        const float w = __fsub_rn(xs, f);
        const float a = (i0 >= 0 && i0 < w2) ? to_f32(row + i0) : 0.0f;
        const float c = (i0 + 1 >= 0 && i0 + 1 < w2) ? to_f32(row + i0 + 1) : 0.0f;
        v = __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(c, w));
      }
      // the run is staged at its destination's alignment mod 16
      const unsigned mis = (run0 + gi * run_step) & 15u;
      store(reinterpret_cast<TO*>(stage + gi * slot + mis) + p * LS + l * S + s, v);
      for (s += kstep; s >= S;) s -= S, ++gi;
    }
  };
  cp_async_wait_prior();
  __syncthreads();  // a thread reads chunks that other threads copied
  if (p < np)
    for (int l = 1; l < levels; ++l) level_taps(l);
  cp_async_wait_all();
  __syncthreads();
  if (p < np) level_taps(0);
  __syncthreads();

  // 3. each run as aligned 16-byte vectors, element stores at its ends
  const int nch = (int)(pl.slot / 16);
  const long long len = (long long)np * LS * sizeof(TO);
  for (int q = threadIdx.x; q < G * nch; q += blockDim.x) {
    const int r = q / nch, j = q - r * nch;
    const uintptr_t gs = reinterpret_cast<uintptr_t>(out + run_start(b, r, G, LS, HW, hw0));
    const uintptr_t ge = gs + len;
    const uintptr_t c = (gs & ~static_cast<uintptr_t>(15)) + 16 * j;
    if (c >= ge) continue;
    const unsigned char* src = stage + r * pl.slot + 16 * j;
    if (c >= gs && c + 16 <= ge) {
      *reinterpret_cast<uint4*>(c) = *reinterpret_cast<const uint4*>(src);
    } else {
      const uintptr_t hi = c + 16 < ge ? c + 16 : ge;
      for (uintptr_t x = c > gs ? c : gs; x < hi; x += sizeof(TO))
        *reinterpret_cast<TO*>(x) = *reinterpret_cast<const TO*>(src + (x - c));
    }
  }
}

template <typename TV, typename TO>
int launch(const Levels& lv, int levels, const float* pos, void* out, int B, int HW, int K, int G,
           int log2_cf, int pixels, cudaStream_t s) {
  const Plan pl = make_plan(lv.w2, levels, K, G, sizeof(TV), sizeof(TO), pixels);
  auto kernel = row_sample_kernel<TV, TO>;
  if (pl.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int log2_pixels = __builtin_ctz(pixels);
  const dim3 grid((unsigned)((HW + pixels - 1) / pixels), (unsigned)B);
  kernel<<<grid, kThreadsPerPixel * pixels, pl.bytes, s>>>(
      lv, levels, pos, static_cast<TO*>(out), HW, K, G, log2_cf, log2_pixels);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (the wrapper's plan mirrors it).
extern "C" long long row_sample_smem_bytes(const int* widths, int levels, int K, int G,
                                           int vol_bf16, int out_bf16, int pixels) {
  return make_plan(widths, levels, K, G, vol_bf16 ? 2 : 4, out_bf16 ? 2 : 4, pixels).bytes;
}

// Launch on `stream`: `vols` and `widths` hold one pointer and one width per
// level; `pos` is a dense (B, H, W, K) fp32 tensor, HW = H * W; `out` is the
// folded (B*G, L*K/G, H, W) tensor, 16-byte aligned, channels-last in
// memory. Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments it refuses.
extern "C" int row_sample_launch(const void* const* vols, const int* widths, int levels,
                                 const float* pos, void* out, int B, int HW, int K, int G,
                                 int log2_cf, int vol_bf16, int out_bf16, int pixels,
                                 void* stream) {
  if (levels < 1 || levels > kMaxLevels || B < 1 || B > 65535 || HW < 1 || K < 1 || G < 1 ||
      K % G != 0 || log2_cf < 0 || (levels - 1) * log2_cf > 126 || pixels < 8 || pixels > 64 ||
      (pixels & (pixels - 1)) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int i = 0; i < levels; ++i) {
    if (widths[i] < 1 || vols[i] == nullptr) return (int)cudaErrorInvalidValue;
    lv.vol[i] = vols[i];
    lv.w2[i] = widths[i];
  }
  if (row_sample_smem_bytes(widths, levels, K, G, vol_bf16, out_bf16, pixels) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(lv, levels, pos, out, B, HW, K, G, log2_cf,
                                                pixels, s);
  if (vol_bf16)
    return launch<__nv_bfloat16, float>(lv, levels, pos, out, B, HW, K, G, log2_cf, pixels, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(lv, levels, pos, out, B, HW, K, G, log2_cf, pixels, s);
  return launch<float, float>(lv, levels, pos, out, B, HW, K, G, log2_cf, pixels, s);
}
