// One fused full-resolution encoder stage (fnet stem-norm + layer1 chain).
//
// Replaces the Pallas TPU kernel dkt_stereo_tpu/ops/pallas/encoder_conv.py
// (encoder_stage, :274; kernel body _stage_kernel, :178). On logical NHWC
// tensors with C = 64 it computes
//
//   h = relu(a1 * u + b1)                         (relu optional)
//   h = relu(h + relu(a2 * v + b2))               (only with the v stream)
//   y = conv3x3(h, w), zero SAME padding, no bias
//
// with per-(sample, channel) affines a*, b* in fp32, h rounded to the
// activation dtype before the conv (the TPU kernel's VMEM buffer), fp32
// accumulation, y stored in the activation dtype, and per-(sample, channel)
// fp32 sums of y and y^2 taken from the fp32 accumulator, not from the
// rounded y. Optionally h itself is written out (the block's residual tap).
//
// The file also serves the VJP (encoder_conv.py::encoder_stage_ad, :476;
// its backward _stage_ad_bwd, :394-470, calls encoder_stage again): the
// adjoint SAME conv of the output cotangent g_y is this kernel with the
// identity affine, no ReLU, no v and flipped, IO-transposed taps, as in JAX.
// The adjoint passes null statistics pointers, and the kernel then skips the
// statistics (the STATS template argument, false in that instantiation).
//
// What bounds it on the H100: at (2, 736, 1280, 64) bf16 one stage moves
// 0.48 GB (u in, y out; 0.96 GB with v and h) and does 139 GFLOP of
// multiply-adds: ~0.14 ms of memory traffic, ~0.14 ms of tensor-core time.
//
// Design. The TPU kernel packs column pairs into 128 lanes (w2d) and carries
// a row halo across its sequential grid; neither is needed here: each block
// owns an output tile of one sample and all 64 output channels, loads its
// halo'd input tile into shared memory once, applying the affine/ReLU
// prologue and the image-border zeros on the way in, and needs nothing from
// any other block. Statistics are reduced over the block (warp shuffles or
// per-lane sums, then shared-memory atomics) and added, one value per
// channel, to zero-initialised (B, 64) buffers with global fp32 atomics:
// blocks run in no order, so no sum is carried from one block to the next.
//
//  - bf16 (the inference path): the conv is an implicit GEMM on the tensor
//    cores (ldmatrix + mma.sync m16n8k16, bf16 -> fp32). Blocks are
//    persistent: two per SM, each loads the 3x3x64x64 weights into shared
//    memory once and then walks over 8 x 16 output tiles. Per tile its
//    4 warps each own two output rows (16 pixels each) x 64 channels in 16
//    accumulator fragments; for each of the 9 taps and 4 chunks of 16 input
//    channels a warp loads 4 weight fragments and reuses each for both rows.
//    The prologue issues all of a thread's 16-byte loads of the halo'd tile
//    before it transforms any. Pixels and weight rows are 144 bytes apart in
//    shared memory, so the 8 rows of every ldmatrix phase fall on distinct
//    banks; 109 KB of shared memory per block. The epilogue takes the
//    statistics from the fp32 fragments (warp shuffles over the pixels),
//    stages y as bf16 in the freed input tile and writes it as coalesced
//    16-byte vectors.
//  - fp32 (parity runs): the same function on the fp32 CUDA cores. An
//    8 x 32 tile streams the input through shared memory in chunks of 8
//    channels; each thread accumulates 8 pixels x 8 channels in registers,
//    reusing every input value for the 3 horizontal taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int C = 64;  // channels in and out

// ---------------------------------------------------------------- fp32 path
constexpr int TH = 8;       // output rows per block, one warp each
constexpr int TW = 32;      // output columns per block
constexpr int CK = 8;       // input channels per shared-memory chunk
constexpr int NT = 256;     // threads per block
constexpr int IH = TH + 2;  // input tile rows with halo
constexpr int IW = TW + 2;  // input tile columns with halo

template <bool STATS>
__global__ void __launch_bounds__(NT)
encoder_stage_f32_kernel(const float* __restrict__ u, const float* __restrict__ a1,
                         const float* __restrict__ b1, const float* __restrict__ v,
                         const float* __restrict__ a2, const float* __restrict__ b2,
                         const float* __restrict__ w, float* __restrict__ y,
                         float* __restrict__ ssum, float* __restrict__ sssq,
                         float* __restrict__ hout, int H, int W, int relu_u) {
  __shared__ float in_s[CK][IH][IW];
  __shared__ __align__(16) float w_s[9][CK][C];
  __shared__ float red_sum[C];
  __shared__ float red_ssq[C];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  // thread -> (output row r, 8 columns from c0, channels 4cg..4cg+3 and
  // 32+4cg..32+4cg+3); the split channel groups keep the float4 weight reads
  // of 8 neighbouring lanes on 32 distinct banks
  const int cg = tid & 7;
  const int r = tid >> 5;
  const int c0 = ((tid >> 3) & 3) * 8;

  if (tid < C) {
    red_sum[tid] = 0.0f;
    red_ssq[tid] = 0.0f;
  }

  const size_t base = (size_t)b * H * W * C;
  const int bc = b * C;

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.0f;

  for (int cc = 0; cc < C; cc += CK) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < CK * IH * IW; i += NT) {
      const int ci = i % CK;
      const int p = i / CK;
      const int col = p % IW;
      const int row = p / IW;
      const int gy = ty0 + row - 1;
      const int gx = tx0 + col - 1;
      float h = 0.0f;  // outside the image: SAME padding zeros
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int c = cc + ci;
        const size_t off = base + ((size_t)gy * W + gx) * C + c;
        h = u[off] * a1[bc + c] + b1[bc + c];
        if (relu_u) h = fmaxf(h, 0.0f);
        if (v != nullptr) h = fmaxf(h + fmaxf(v[off] * a2[bc + c] + b2[bc + c], 0.0f), 0.0f);
        // each image pixel is the interior of exactly one block
        if (hout != nullptr && row >= 1 && row <= TH && col >= 1 && col <= TW) hout[off] = h;
      }
      in_s[ci][row][col] = h;
    }
    for (int i = tid; i < 9 * CK * C; i += NT) {
      const int co = i % C;
      const int rest = i / C;
      const int ci = rest % CK;
      const int tap = rest / CK;
      w_s[tap][ci][co] = w[((size_t)tap * C + cc + ci) * C + co];
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) xin[j] = in_s[ci][r + dy][c0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][ci][4 * cg]);
          const float4 wb = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx][ci][32 + 4 * cg]);
          const float wk[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(xin[j + dx], wk[k], acc[j][k]);
        }
      }
    }
  }

  float ps[8], pq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ps[k] = 0.0f;
    pq[k] = 0.0f;
  }
  const int gy = ty0 + r;
  if (gy < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gx = tx0 + c0 + j;
      if (gx < W) {
        float* yp = y + base + ((size_t)gy * W + gx) * C;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int co = (k < 4) ? 4 * cg + k : 32 + 4 * cg + (k - 4);
          const float a = acc[j][k];
          yp[co] = a;
          ps[k] += a;
          pq[k] += a * a;
        }
      }
    }
  }
  if constexpr (STATS) {
    // lanes 8q + cg share their channels: fold the four of them
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ps[k] += __shfl_xor_sync(0xffffffffu, ps[k], 8);
      ps[k] += __shfl_xor_sync(0xffffffffu, ps[k], 16);
      pq[k] += __shfl_xor_sync(0xffffffffu, pq[k], 8);
      pq[k] += __shfl_xor_sync(0xffffffffu, pq[k], 16);
    }
    if ((tid & 31) < 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int co = (k < 4) ? 4 * cg + k : 32 + 4 * cg + (k - 4);
        atomicAdd(&red_sum[co], ps[k]);
        atomicAdd(&red_ssq[co], pq[k]);
      }
    }
    __syncthreads();
    if (tid < C) {
      atomicAdd(&ssum[bc + tid], red_sum[tid]);
      atomicAdd(&sssq[bc + tid], red_ssq[tid]);
    }
  }
}

// ---------------------------------------------------------------- bf16 path
constexpr int TC_TH = 8;             // output rows per tile
constexpr int TC_TW = 16;            // output columns per tile: one fragment's rows
constexpr int TC_WARPS = TC_TH / 2;  // two output rows per warp
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int TC_IH = TC_TH + 2;
constexpr int TC_IW = TC_TW + 2;
constexpr int PS = 72;  // bf16 per pixel and per weight row in shared memory (144 B)
constexpr int TC_IN_ELEMS = TC_IH * TC_IW * PS;
constexpr int TC_W_ELEMS = 9 * C * PS;
constexpr int TC_SMEM = (TC_IN_ELEMS + TC_W_ELEMS) * 2;
constexpr int TC_VECS = TC_IH * TC_IW * (C / 8);            // 16-byte vectors per input tile
constexpr int TC_LOADS = (TC_VECS + TC_NT - 1) / TC_NT;     // of them per thread
static_assert(TC_WARPS * 2 * TC_TW * PS <= TC_IN_ELEMS, "epilogue staging must fit the input tile");

union Pack8 {  // eight bf16 channels, one 16-byte load or store
  uint4 q;
  __nv_bfloat162 h2[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

template <bool HAS_V, bool STATS>
__global__ void __launch_bounds__(TC_NT, 2)
encoder_stage_bf16_kernel(const bf16* __restrict__ u, const float* __restrict__ a1,
                          const float* __restrict__ b1, const bf16* __restrict__ v,
                          const float* __restrict__ a2, const float* __restrict__ b2,
                          const bf16* __restrict__ w, bf16* __restrict__ y,
                          float* __restrict__ ssum, float* __restrict__ sssq,
                          bf16* __restrict__ hout, int B, int H, int W, int relu_u) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* in_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = in_s + TC_IN_ELEMS;
  __shared__ float aff[4][C];  // a1, b1, a2, b2 of the current sample
  __shared__ float red_sum[C];
  __shared__ float red_ssq[C];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles_x = (W + TC_TW - 1) / TC_TW;
  const int tiles = tiles_x * ((H + TC_TH - 1) / TC_TH);  // per sample
  // ldmatrix rows: pixels of an A fragment, input channels of a B fragment
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_col = (lane >> 4) * 8;
  const int g = lane >> 2;  // accumulator fragment: pixels g, g + 8
  const int cq = lane & 3;  // and channels 2cq, 2cq + 1 of each 8
  const uint32_t in_base = smem_addr(in_s);
  const uint32_t w_base = smem_addr(w_s);

  // weights (tap, ci) -> 9*64 rows of 64 co, once for all of this block's tiles
  for (int i = tid; i < 9 * C * (C / 8); i += TC_NT) {
    const int row = i >> 3;
    const int c8 = (i & 7) * 8;
    *reinterpret_cast<uint4*>(w_s + row * PS + c8) =
        *reinterpret_cast<const uint4*>(w + (size_t)row * C + c8);
  }

  int cur_b = -1;
  for (int t = blockIdx.x; t < B * tiles; t += gridDim.x) {
    const int b = t / tiles;
    const int ty0 = ((t - b * tiles) / tiles_x) * TC_TH;
    const int tx0 = ((t - b * tiles) % tiles_x) * TC_TW;
    const size_t base = (size_t)b * H * W * C;
    if (b != cur_b) {  // tiles go in sample order: flush the last sample's statistics
      if (tid < C) {
        if (STATS && cur_b >= 0) {
          atomicAdd(&ssum[cur_b * C + tid], red_sum[tid]);
          atomicAdd(&sssq[cur_b * C + tid], red_ssq[tid]);
        }
        red_sum[tid] = 0.0f;
        red_ssq[tid] = 0.0f;
        aff[0][tid] = a1[b * C + tid];
        aff[1][tid] = b1[b * C + tid];
        if constexpr (HAS_V) {
          aff[2][tid] = a2[b * C + tid];
          aff[3][tid] = b2[b * C + tid];
        }
      }
      __syncthreads();
      cur_b = b;
    }

    // halo'd input tile through the prologue: all loads first, then transform
    Pack8 uq[TC_LOADS], vq[HAS_V ? TC_LOADS : 1];
#pragma unroll
    for (int k = 0; k < TC_LOADS; ++k) {
      const int i = tid + k * TC_NT;
      const int p = i >> 3;
      const int gy = ty0 + p / TC_IW - 1;
      const int gx = tx0 + p % TC_IW - 1;
      uq[k].q = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (HAS_V) vq[k].q = make_uint4(0u, 0u, 0u, 0u);
      if (i < TC_VECS && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t off = base + ((size_t)gy * W + gx) * C + (i & 7) * 8;
        uq[k].q = *reinterpret_cast<const uint4*>(u + off);
        if constexpr (HAS_V) vq[k].q = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int k = 0; k < TC_LOADS; ++k) {
      const int i = tid + k * TC_NT;
      if (i < TC_VECS) {
        const int p = i >> 3;
        const int c8 = (i & 7) * 8;
        const int row = p / TC_IW;
        const int col = p % TC_IW;
        const int gy = ty0 + row - 1;
        const int gx = tx0 + col - 1;
        Pack8 hq;
        hq.q = make_uint4(0u, 0u, 0u, 0u);  // outside the image: SAME padding zeros
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c8 + 2 * j;
            const float2 uf = __bfloat1622float2(uq[k].h2[j]);
            float h0 = uf.x * aff[0][c] + aff[1][c];
            float h1 = uf.y * aff[0][c + 1] + aff[1][c + 1];
            if (relu_u) {
              h0 = fmaxf(h0, 0.0f);
              h1 = fmaxf(h1, 0.0f);
            }
            if constexpr (HAS_V) {
              const float2 vf = __bfloat1622float2(vq[k].h2[j]);
              h0 = fmaxf(h0 + fmaxf(vf.x * aff[2][c] + aff[3][c], 0.0f), 0.0f);
              h1 = fmaxf(h1 + fmaxf(vf.y * aff[2][c + 1] + aff[3][c + 1], 0.0f), 0.0f);
            }
            hq.h2[j] = __floats2bfloat162_rn(h0, h1);
          }
          // each image pixel is the interior of exactly one tile
          if (hout != nullptr && row >= 1 && row <= TC_TH && col >= 1 && col <= TC_TW)
            *reinterpret_cast<uint4*>(hout + base + ((size_t)gy * W + gx) * C + c8) = hq.q;
        }
        *reinterpret_cast<uint4*>(in_s + p * PS + c8) = hq.q;
      }
    }
    __syncthreads();

    // implicit GEMM: out[row][px][co] += in[row+dy][px+dx][ci] * w[dy][dx][ci][co]
    float acc[2][8][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][nb][e] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t bf[4][4];  // bf[j]: channels 16j..16j+7 (regs 0, 1) and 16j+8.. (regs 2, 3)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldsm_x4_trans(bf[j], w_base + 2 * ((tap * C + kc * 16 + lm_row) * PS + j * 16 + lm_col));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t af[4];
          const int row = 2 * warp + rr + dy;
          ldsm_x4(af, in_base + 2 * ((row * TC_IW + lm_row + dx) * PS + kc * 16 + lm_col));
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
            mma_bf16(acc[rr][nb], af, bf[nb >> 1][(nb & 1) * 2], bf[nb >> 1][(nb & 1) * 2 + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the input tile: stage y there

    // epilogue: statistics from the fp32 fragments, y through shared memory
    bf16* st = in_s + warp * (2 * TC_TW) * PS;
    float s[8][2], q[8][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = q[nb][0] = q[nb][1] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const bool row_ok = ty0 + 2 * warp + rr < H;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = g + 8 * half;
        const bool ok = row_ok && tx0 + px < W;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float y0 = acc[rr][nb][2 * half];
          const float y1 = acc[rr][nb][2 * half + 1];
          *reinterpret_cast<__nv_bfloat162*>(st + (rr * TC_TW + px) * PS + nb * 8 + 2 * cq) =
              __floats2bfloat162_rn(y0, y1);
          if (STATS && ok) {
            s[nb][0] += y0;
            s[nb][1] += y1;
            q[nb][0] += y0 * y0;
            q[nb][1] += y1 * y1;
          }
        }
      }
    }
    if constexpr (STATS) {
      // lanes with the same cq hold the same channels: fold the eight pixels g
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s[nb][e] += __shfl_xor_sync(0xffffffffu, s[nb][e], m);
            q[nb][e] += __shfl_xor_sync(0xffffffffu, q[nb][e], m);
          }
      if (lane < 4) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            atomicAdd(&red_sum[nb * 8 + 2 * lane + e], s[nb][e]);
            atomicAdd(&red_ssq[nb * 8 + 2 * lane + e], q[nb][e]);
          }
      }
    }
    __syncwarp();
    // 32 pixels x 8 vectors of 16 bytes, eight lanes per pixel
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = lane + 32 * k;
      const int p = idx >> 3;
      const int c8 = (idx & 7) * 8;
      const int gy = ty0 + 2 * warp + p / TC_TW;
      const int gx = tx0 + p % TC_TW;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(y + base + ((size_t)gy * W + gx) * C + c8) =
            *reinterpret_cast<const uint4*>(st + p * PS + c8);
    }
    __syncthreads();  // the staging area is the next tile's input tile
  }
  if (STATS && cur_b >= 0 && tid < C) {
    atomicAdd(&ssum[cur_b * C + tid], red_sum[tid]);
    atomicAdd(&sssq[cur_b * C + tid], red_ssq[tid]);
  }
}

template <bool HAS_V, bool STATS>
int launch_bf16(const bf16* u, const float* a1, const float* b1, const bf16* v, const float* a2,
                const float* b2, const bf16* w, bf16* y, float* ssum, float* sssq, bf16* h, int B,
                int H, int W, int relu_u, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      encoder_stage_bf16_kernel<HAS_V, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, encoder_stage_bf16_kernel<HAS_V, STATS>, TC_NT, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)B * ((H + TC_TH - 1) / TC_TH) * ((W + TC_TW - 1) / TC_TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  encoder_stage_bf16_kernel<HAS_V, STATS><<<grid, TC_NT, TC_SMEM, s>>>(
      u, a1, b1, v, a2, b2, w, y, ssum, sssq, h, B, H, W, relu_u);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v, y, h: (B, H, W, 64) contiguous, fp32 or bf16 (is_bf16); v and h may
// be null. a*, b*: (B, 64) fp32. w: (3, 3, 64, 64) HWIO in the activation
// dtype. ssum, sssq: (B, 64) fp32, zeroed by the caller, or both null to
// skip the statistics (the VJP's adjoint conv). Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
extern "C" int encoder_stage_launch(const void* u, const float* a1, const float* b1,
                                    const void* v, const float* a2, const float* b2,
                                    const void* w, void* y, float* ssum, float* sssq, void* h,
                                    int B, int H, int W, int channels, int relu_u, int is_bf16,
                                    void* stream) {
  const bool stats = ssum != nullptr;
  if (channels != C || B < 1 || B > 65535 || H < 1 || W < 1 || stats != (sssq != nullptr) ||
      (!stats && v != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bf16* ub = static_cast<const bf16*>(u);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* yb = static_cast<bf16*>(y);
    bf16* hb = static_cast<bf16*>(h);
    if (v != nullptr)
      return launch_bf16<true, true>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B, H, W,
                                     relu_u, s);
    return stats ? launch_bf16<false, true>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B, H,
                                            W, relu_u, s)
                 : launch_bf16<false, false>(ub, a1, b1, vb, a2, b2, wb, yb, ssum, sssq, hb, B,
                                             H, W, relu_u, s);
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  if (stats)
    encoder_stage_f32_kernel<true><<<grid, NT, 0, s>>>(uf, a1, b1, vf, a2, b2, wf,
                                                       static_cast<float*>(y), ssum, sssq,
                                                       static_cast<float*>(h), H, W, relu_u);
  else
    encoder_stage_f32_kernel<false><<<grid, NT, 0, s>>>(uf, a1, b1, vf, a2, b2, wf,
                                                        static_cast<float*>(y), ssum, sssq,
                                                        static_cast<float*>(h), H, W, relu_u);
  return (int)cudaGetLastError();
}
