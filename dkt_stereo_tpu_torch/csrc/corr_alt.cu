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
// What bounds it on the H100: bytes. At the main path's 1/4 grid of a
// 1984 x 2880 frame (496 x 720 pixels, D = 256, widths 720/360/180/90,
// r = 4, bf16) fmap1 is 183 MB, the pooled levels at most 343 MB and the
// output 51 MB: ~0.17 ms at 3.35 TB/s.
//
// Design. Neighbouring pixels read nearly the same columns: read pixel by
// pixel, each column would come from L2 once for every pixel that needs
// it, 7.3 GB a launch at the main path's shape, and the lookup would run at
// L2's rate. So a block owns a run of kP = 96 consecutive pixels of one
// (b, h) row (64 in fp32):
//  - It stages their fmap1 rows (kP x D) in shared memory once, for every
//    level.
//  - For each level it reduces its pixels' windows to a band [lo, hi) of
//    columns, cut to [0, W2_i); pixels whose window lies wholly outside
//    the row (far out of range, NaN) do not widen it. In the port's
//    (B, H, W2_i, D) layout the band is one contiguous span of the level's
//    row. It is walked in pieces of nc columns (48 at D = 256 in bf16; a
//    band wider than a piece, e.g. at random coordinates, takes several),
//    double-buffered across pieces and levels: thread 0 issues piece i+1's
//    copy before the block multiplies piece i.
//  - Tiles are staged by TMA over (D, W, B*H) tensor maps, one box a
//    128-byte slab of channels (4 a tile at D = 256 in bf16), with the
//    128-byte swizzle: ldmatrix's eight rows fall on distinct banks, and
//    TMA's zero fill gives the channels past D. When a row of D elements
//    is not a multiple of 16 bytes (D not a multiple of 8 in bf16, of 4 in
//    fp32) TMA cannot address it, and the block stages the same swizzled
//    layout with plain loads instead.
//  - bf16: the kP x D fmap1 tile times the D x nc piece on the tensor cores
//    (ldmatrix + mma.sync m16n8k16, fp32 accumulation; a band column's D
//    channels are contiguous, the column-major B operand). A warp takes 16
//    pixels and one 16-column group of the piece, so 18 warps share a
//    block; it multiplies only the 8-column halves that some window of its
//    pixels reads (a ballot), and stores each product that falls in its
//    pixel's window to a kP x (2r+2) table c[p][j] in shared memory.
//  - fp32 (the parity runs): only the products a window needs, one warp a
//    (pixel, column), full fp32 FMAs from the staged tiles and a warp sum
//    (the JAX kernel's Precision.HIGHEST; no TF32).
//  - Each level's taps come from c with one fractional weight per (pixel,
//    level) and 1/sqrt(D) of the true D.
// Any depth D in [1, 512] runs, up to kMaxLevels levels and any radius
// whose table fits shared memory (the launcher and the wrapper compute the
// same size). What set the shape, on the H100: a block's pieces run one
// after another, so the time follows the warps an SM holds while two
// blocks fit its shared memory. A warp a row of 16 pixels (4 a block) was
// far slower than three (the column split), and 96 pixels a block faster
// than 64; a third ring buffer or 112-128 pixels a block cost the second
// block an SM, and one bulk copy a column instead of TMA boxes did not pay.
//
// All taps of a (pixel, level) share one fractional weight, and the
// position is clamped before the integer conversion, as K1 and K4 do: a
// coordinate of +-1e9 gives zeros. A NaN coordinate reads through the
// clamped index (fmaxf(NaN, a) = a), but its weight is taken from the
// unclamped position, so its taps are NaN at every level, as in the plain
// version and the JAX kernel (relu(1 - |j - NaN|) is NaN). Offsets are
// 64-bit.

#include <cuda.h>  // CUtensorMap and its enums only: no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxLevels = 8;
constexpr int kSplit = 3;              // warps sharing a piece's columns
constexpr int kBufs = 2;               // piece ring
constexpr int kMaxPiece = 16 * kSplit;  // columns per piece: one 16-column group a warp
constexpr int kPieceBytes = 24576;     // one piece's budget
constexpr int kMaxSmem = 232448;       // an H100 block's shared memory
constexpr int kEncodeError = 100000;

// pixels a block, 16 a row of warps: 96 in bf16; 64 in fp32, whose tiles
// are twice as wide, so that 512 channels fit
__host__ __device__ constexpr int block_pixels(bool bf16) { return bf16 ? 96 : 64; }

template <typename T>
struct Block {
  static constexpr int kP = block_pixels(std::is_same<T, bf16>::value);
  static constexpr int kWarps = kP / 16 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
};

struct Args {
  CUtensorMap map[kMaxLevels + 1];  // fmap1, then each level (TMA staging only)
  const void* f2[kMaxLevels];       // (B*H, w2_i, dim)
  int w2[kMaxLevels];
};

// the shared-memory plan, the same on the host, in the kernel and in the
// wrapper (ops/cuda/corr_alt.py::smem_bytes)
struct Plan {
  int se;     // elements in a 128-byte row of a slab
  int ns;     // slabs: 128-byte column groups of the depth
  int nc;     // columns per piece, a multiple of 16
  int cols;   // 2r + 2
  int head;   // bytes before the 1024-aligned tiles
  int bytes;  // dynamic shared memory of a block
};

__host__ __device__ inline Plan make_plan(int dim, int is_bf16, int radius) {
  Plan pl;
  pl.se = is_bf16 ? 64 : 32;
  pl.ns = (dim + pl.se - 1) / pl.se;
  pl.nc = kPieceBytes / (pl.ns * 128) / 16 * 16;
  if (pl.nc > kMaxPiece) pl.nc = kMaxPiece;
  if (pl.nc < 16) pl.nc = 16;
  pl.cols = 2 * radius + 2;
  // the mbarriers and band bounds (256 bytes), the pixels' coordinates and
  // the c table; 1 KB of alignment slack; the fmap1 tile and the ring
  const int np = block_pixels(is_bf16);
  pl.head = 256 + 4 * np + 4 * np * pl.cols;
  pl.bytes = pl.head + 1024 + (np + kBufs * pl.nc) * pl.ns * 128;
  return pl;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box (one slab: 128 bytes of channels from channel c, `rows` rows
// from x, of row-of-the-batch r) into shared memory, completing on `bar`;
// TMA fills what lies outside the tensor with zeros
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c, int x, int r) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(x), "r"(r)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row major) * b (16x8, column major), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// byte offset of element k of row n in a tile of `rows` rows: slabs of
// `rows` x 128 bytes, the 16-byte chunk c of row n at chunk c ^ (n % 8)
// (TMA's 128-byte swizzle on a 1024-aligned tile)
template <typename T>
__device__ __forceinline__ uint32_t swz(int n, int k, int rows) {
  constexpr int se = 128 / sizeof(T), ce = 16 / sizeof(T);
  return (uint32_t)(((k / se) * rows + n) * 128 + ((((k % se) / ce) ^ (n & 7)) << 4) +
                    (k % ce) * sizeof(T));
}

// the first column x0 of a pixel's window at a level and its fractional
// weight. x / 2^lvl is exact in fp32; any position left of -(2r+2) or right
// of w2 reads only zeros: clamp there before converting, so out-of-range
// floats (and NaN) never reach the int. A NaN position keeps a NaN weight
__device__ __forceinline__ int window(float x, int lvl, int radius, int w2, float& w) {
  const float p = x * __int_as_float((127 - lvl) << 23) - (float)radius;
  const float p0 = fminf(fmaxf(p, -(float)(2 * radius + 3)), (float)(w2 + 1));
  const float f0 = floorf(p0);
  w = isnan(p) ? p : p0 - f0;
  return (int)f0;
}

template <typename T>
__global__ void __launch_bounds__(Block<T>::kThreads)
corr_alt_kernel(const __grid_constant__ Args args, int levels, const T* __restrict__ f1,
                const float* __restrict__ coords, float* __restrict__ out, int w1, int dim,
                int radius, float inv_sqrt_d) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kP = Block<T>::kP;
  constexpr int kWarps = Block<T>::kWarps;
  constexpr int kThreads = Block<T>::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan pl = make_plan(dim, kBf16, radius);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int taps = 2 * radius + 1;
  const int cols = pl.cols;
  const int chunks = (w1 + kP - 1) / kP;
  const long long row = blockIdx.x / chunks;  // (b, h)
  const int p_start = (int)(blockIdx.x - row * chunks) * kP;
  const int np = min(kP, w1 - p_start);
  const long long pix0 = row * w1 + p_start;
  const int out_w = levels * taps;
  const bool tma = ((dim * (int)sizeof(T)) & 15) == 0;
  const int tile_bytes = pl.ns * 128;  // per staged row

  const uint32_t bar = smem_addr(smem);  // fmap1 at bar, ring buffer b at bar + 8 (1 + b)
  int* lo_s = reinterpret_cast<int*>(smem + 64);
  int* hi_s = lo_s + kMaxLevels;
  float* xs = reinterpret_cast<float*>(smem + 256);
  float* cbuf = xs + kP;  // c[p][j], j = 0..2r+1
  const uint32_t f1_s = (smem_addr(smem) + pl.head + 1023u) & ~1023u;
  unsigned char* f1p = smem + (f1_s - smem_addr(smem));
  auto ring = [&](int b) { return f1_s + (kP + b * pl.nc) * tile_bytes; };

  if (tid == 0) {
    for (int b = 0; b <= kBufs; ++b) mbar_init(bar + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kMaxLevels) {
    lo_s[tid] = 0x7fffffff;
    hi_s[tid] = 0;
  }
  if (tid < kP) xs[tid] = tid < np ? coords[pix0 + tid] : __int_as_float(0x7fc00000);
  if (!tma) {
    // plain loads: the channels between D and the slabs' end read as zeros
    const int pad = pl.ns * pl.se - dim;
    for (int i = tid; i < (kP + kBufs * pl.nc) * pad; i += kThreads) {
      const int r = i / pad;
      const int k = dim + i % pad;
      const int tile = r < kP ? 0 : 1 + (r - kP) / pl.nc;
      const int n = r < kP ? r : (r - kP) % pl.nc;
      const int rows = r < kP ? kP : pl.nc;
      const uint32_t at = (tile == 0 ? f1_s : ring(tile - 1)) + swz<T>(n, k, rows);
      *reinterpret_cast<T*>(smem + (at - smem_addr(smem))) = T(0.0f);
    }
    for (int i = tid; i < np * dim; i += kThreads)
      *reinterpret_cast<T*>(f1p + swz<T>(i / dim, i % dim, kP)) = f1[pix0 * dim + i];
  }
  __syncthreads();

  // the fmap1 tile, kept for every level
  if (tma && tid == 0) {
    mbar_expect_tx(bar, (uint32_t)(kP * tile_bytes));
    for (int s = 0; s < pl.ns; ++s)
      load_box(f1_s + s * kP * 128, &args.map[0], bar, s * pl.se, p_start, (int)row);
  }
  // each level's band: the columns some window of this block reads
  if (tid < np) {
    for (int lvl = 0; lvl < levels; ++lvl) {
      const int w2 = args.w2[lvl];
      float w;
      const int x0 = window(xs[tid], lvl, radius, w2, w);
      if (x0 + cols > 0 && x0 < w2) {
        atomicMin(&lo_s[lvl], max(x0, 0));
        atomicMax(&hi_s[lvl], min(x0 + cols, w2));
      }
    }
  }
  __syncthreads();

  int total = 0;  // pieces over all levels
  for (int lvl = 0; lvl < levels; ++lvl)
    if (hi_s[lvl] > lo_s[lvl]) total += (hi_s[lvl] - lo_s[lvl] + pl.nc - 1) / pl.nc;

  // piece i of the walk: level and first column
  auto piece = [&](int i, int& lvl, int& c0) {
    for (lvl = 0; lvl < levels; ++lvl) {
      const int n = hi_s[lvl] > lo_s[lvl] ? (hi_s[lvl] - lo_s[lvl] + pl.nc - 1) / pl.nc : 0;
      if (i < n) break;
      i -= n;
    }
    c0 = lo_s[lvl] + i * pl.nc;
  };
  // thread 0: start the copy of piece i into ring buffer i % kBufs
  auto issue = [&](int i) {
    int lvl, c0;
    piece(i, lvl, c0);
    const uint32_t b = bar + 8 * (1 + i % kBufs);
    const uint32_t dst = ring(i % kBufs);
    // the buffer's last reads (generic proxy) come before the async writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(b, (uint32_t)(pl.nc * tile_bytes));
    for (int s = 0; s < pl.ns; ++s)
      load_box(dst + s * pl.nc * 128, &args.map[1 + lvl], b, s * pl.se, c0, (int)row);
  };
  if (tma && tid == 0)
    for (int i = 0; i < kBufs - 1 && i < total; ++i) issue(i);
  if (tma) mbar_wait(bar, 0);  // the fmap1 tile (never left in flight at exit)

  const int g = lane >> 2;  // accumulator rows g, g + 8
  const int q = lane & 3;   // and columns 2q, 2q + 1
  const int m0 = 16 * (warp % (kP / 16));  // the warp's pixels
  const int cs = warp / (kP / 16);         // and its share of a piece's columns
  int i = 0;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int w2 = args.w2[lvl];
    const int lo = lo_s[lvl], hi = hi_s[lvl];
    __syncthreads();  // the last level's taps have read the table
    for (int k = tid; k < kP * cols; k += kThreads) cbuf[k] = 0.0f;
    __syncthreads();
    float wdummy;
    // this thread's two accumulator pixels' windows, and lane l's pixel
    // m0 + l % 16's for the warp's vote on which columns to multiply
    const int xa = window(xs[m0 + g], lvl, radius, w2, wdummy);
    const int xb = window(xs[m0 + g + 8], lvl, radius, w2, wdummy);
    const int xv = window(xs[m0 + (lane & 15)], lvl, radius, w2, wdummy);
    for (int c0 = lo; c0 < hi; c0 += pl.nc, ++i) {
      const int n = min(pl.nc, hi - c0);
      const uint32_t bs = ring(i % kBufs);
      if (tma) {
        if (tid == 0 && i + kBufs - 1 < total) issue(i + kBufs - 1);
        mbar_wait(bar + 8 * (1 + i % kBufs), (i / kBufs) & 1);
      } else {
        const T* src = static_cast<const T*>(args.f2[lvl]) + (row * w2 + c0) * dim;
        unsigned char* bp = smem + (bs - smem_addr(smem));
        for (int k = tid; k < n * dim; k += kThreads)
          *reinterpret_cast<T*>(bp + swz<T>(k / dim, k % dim, pl.nc)) = src[k];
        __syncthreads();
      }
      if constexpr (kBf16) {
        // the warp's 16-column group cs of the piece, and the 8-column
        // halves of it that some window of its pixels reads; the others are
        // not multiplied
        const int lo_g = c0 + 16 * cs;
        int need = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lo_c = lo_g + 8 * h;
          const bool hit = lo_c < c0 + n && xv < lo_c + 8 && xv + cols > lo_c;
          need |= (__ballot_sync(0xffffffffu, hit) != 0u) << h;
        }
        if (need != 0) {
          float acc[2][4] = {};
          // A: lane l gives row m0 + (l & 7) + 8 ((l >> 3) & 1), chunk l >> 4;
          // B: row (column of the piece) 16 cs + (l & 7) + 8 (l >> 4), chunk
          // (l >> 3) & 1
          const int am = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int bn = 16 * cs + (lane & 7) + ((lane >> 4) << 3);
          for (int kk = 0; kk < pl.ns * 64; kk += 16) {
            const int slab = kk >> 6;
            const int c16 = (kk & 63) >> 3;
            uint32_t a[4], b[4];
            ldsm_x4(a, f1_s + (slab * kP + am) * 128 + (((c16 + (lane >> 4)) ^ (am & 7)) << 4));
            ldsm_x4(b, bs + (slab * pl.nc + bn) * 128 +
                           (((c16 + ((lane >> 3) & 1)) ^ (bn & 7)) << 4));
            if (need & 1) mma_bf16(acc[0], a, b[0], b[1]);
            if (need & 2) mma_bf16(acc[1], a, b[2], b[3]);
          }
          // keep the products that fall in their pixel's window
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = lo_g + 8 * h + 2 * q + (e & 1);
              const int x0 = e < 2 ? xa : xb;
              const int p = m0 + g + (e < 2 ? 0 : 8);
              const int j = col - x0;
              if (col < c0 + n && j >= 0 && j < cols && p < np) cbuf[p * cols + j] = acc[h][e];
            }
          }
        }
      } else {
        // fp32: one warp a (pixel, column) the windows need from this piece
        const unsigned char* bp = smem + (bs - smem_addr(smem));
        for (int pj = warp; pj < np * cols; pj += kWarps) {
          const int p = pj / cols;
          const int j = pj - p * cols;
          float w;
          const int col = window(xs[p], lvl, radius, w2, w) + j;
          if (col < c0 || col >= c0 + n) continue;  // the same for every lane
          float s = 0.0f;
          for (int k = lane; k < dim; k += 32)
            s = fmaf(*reinterpret_cast<const float*>(f1p + swz<T>(p, k, kP)),
                     *reinterpret_cast<const float*>(bp + swz<T>(col - c0, k, pl.nc)), s);
          s = warp_sum(s);
          if (lane == 0) cbuf[p * cols + j] = s;
        }
      }
      __syncthreads();  // the ring buffer is free; the table is complete
    }
    // this level's taps, one fractional weight a pixel
    for (int k = tid; k < np * taps; k += kThreads) {
      const int p = k / taps;
      const int t = k - p * taps;
      float w;
      window(xs[p], lvl, radius, w2, w);
      const float* c = cbuf + p * cols + t;
      out[(pix0 + p) * out_w + lvl * taps + t] = ((1.0f - w) * c[0] + w * c[1]) * inv_sqrt_d;
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// driver entry point (the libraries link no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// a (rows, width, dim) tensor as a 3-d map (dim, width, rows) read in boxes
// of one 128-byte slab x box_w x 1, with the 128-byte swizzle
int encode_rows(CUtensorMap* map, const void* p, int is_bf16, long long rows, int width, int dim,
                int box_w) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int size = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)dim, (cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)dim * size, (cuuint64_t)dim * size * width};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / size), (cuuint32_t)box_w, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

}  // namespace

// Dynamic shared memory of a block for this depth, dtype and radius; the
// wrapper refuses what does not fit (kMaxSmem).
extern "C" int corr_alt_smem_bytes(int dim, int is_bf16, int radius) {
  return make_plan(dim, is_bf16, radius).bytes;
}

// f1: (rows * w1, dim) with rows = B*H; f2[i]: (rows, w2[i], dim) for i <
// levels; all of one dtype (is_bf16), 16-byte aligned, 1 <= dim <= 512.
// coords: (rows * w1) fp32. out: (rows * w1, levels*(2r+1)) fp32. Launches
// on `stream` and returns 0, a CUDA error code, or kEncodeError + the
// CUresult of a failed tensor-map encode.
extern "C" int corr_alt_launch(const void* const* f2, const int* w2, int levels, const void* f1,
                               const float* coords, float* out, long long rows, int w1, int dim,
                               int radius, int is_bf16, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || rows < 1 || w1 < 1 || dim < 1 ||
      dim > 512 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(dim, is_bf16, radius);
  if (pl.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  static Args args;  // host staging of the kernel's parameters
  const bool tma = ((dim * (is_bf16 ? 2 : 4)) & 15) == 0;
  for (int i = 0; i < levels; ++i) {
    if (w2[i] < 1) return (int)cudaErrorInvalidValue;
    args.f2[i] = f2[i];
    args.w2[i] = w2[i];
    if (tma) {
      const int e = encode_rows(&args.map[1 + i], f2[i], is_bf16, rows, w2[i], dim, pl.nc);
      if (e != 0) return e;
    }
  }
  if (tma) {
    const int e = encode_rows(&args.map[0], f1, is_bf16, rows, w1, dim, block_pixels(is_bf16));
    if (e != 0) return e;
  }
  const int np = block_pixels(is_bf16);
  const long long blocks = rows * ((w1 + np - 1) / np);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float inv_sqrt_d = 1.0f / sqrtf((float)dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        corr_alt_kernel<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    corr_alt_kernel<bf16><<<(unsigned)blocks, Block<bf16>::kThreads, pl.bytes, s>>>(
        args, levels, static_cast<const bf16*>(f1), coords, out, w1, dim, radius, inv_sqrt_d);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        corr_alt_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    corr_alt_kernel<float><<<(unsigned)blocks, Block<float>::kThreads, pl.bytes, s>>>(
        args, levels, static_cast<const float*>(f1), coords, out, w1, dim, radius, inv_sqrt_d);
  }
  return (int)cudaGetLastError();
}
