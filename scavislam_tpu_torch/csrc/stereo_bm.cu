// Block-matching stereo disparity for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scavislam_tpu/ops/stereo_pallas.py::_bm_kernel
// through both of its callers: block_matching_disparity_pallas (one image)
// and block_matching_disparity_pallas_batched (B streams in one launch).
// Same function, bit for bit the plain PyTorch version in
// scavislam_tpu_torch/ops/stereo_bm.py (bm_plain), not the same design.
//
//   * Inputs: the Sobel-x prefiltered left/right images (clipped to +-0.5,
//     applied outside the kernel), f32 (B, H, W), row-major, contiguous;
//     the single-image entry is B = 1 of the same grid.
//   * Output: f32 (B, H, W) disparity, -1 where invalid.
//   * Scratch, allocated by the caller: int32 (B, H, W) best disparity and
//     uint64 (B, H, W) right-view keys, filled with ~0 ("no candidate").
//
// What bounds it on the H100: compute. The algorithm needs each of the
// H*W*D cost entries once, at ~25 operations each (|L - R|, 10 horizontal
// adds, 10 vertical adds, ~3 compares for the left view, runner-up and
// right view): 315 M operations for a 512x384 frame at D = 64, 4.7 us at
// the card's 67 TFLOP/s fp32, against 0.7 us to move its 2.4 MB.
//
// Two kernels per call:
//
// Kernel A, bm_cost_kernel, grid (W / kTileW, (H - 2R) / kTileRows, B).
// A block owns a tile of kTileRows x kTileW output pixels and stages the
// tile's kTileRows + 2R input rows of L (with an R-column halo) and of R
// (with a further D - 1 columns to the left) in shared memory once. It then
// walks d = 0..D-1:
//   1. horizontal: each of 104 threads owns 8 consecutive columns of one
//      of the 26 halo rows; it keeps its 18 L values in registers for the
//      whole walk and its 18 R values as a register window that slides by
//      one column per d (one shared load per d). It forms the 18 diffs
//      |L - R| (BIG where the column is < d or outside the image) and the
//      8 horizontal sums h, each with its own 10 adds in the plain
//      version's order u, u-1, u+1, ..., u-5, u+5, into a shared plane;
//   2. vertical: each of 128 threads owns one column and 4 output rows;
//      it reads 14 h values and forms 4 costs, each ((h_top + ...) +
//      h_bottom) top-down as the plain version sums (no sliding-window
//      subtract: that changes the bits). h is double-buffered, so one
//      barrier per d separates the two phases;
//   3. left view, online in d for each of the thread's 4 pixels: the
//      strict-< argmin (ties keep the smallest d), the costs at best-1
//      and best+1 for the parabola, and the runner-up excluding
//      |d - best| <= 1 (when d becomes the best, the runner-up restarts
//      from the prefix minimum up to d - 2, and later d >= best + 2 join
//      it). No cost volume is kept;
//   4. right view: cost(v, u, d) is the candidate d of right pixel
//      u - d. Each cost is read once more here, not recomputed: a
//      strict-< update of a (kTileRows, kTileW + D - 1) shared (cost, d)
//      table, conflict-free because u -> u - d is one-to-one at one d.
// After the walk the block sums the texture |L| box the same way, writes
// each pixel's subpixel disparity (-1 if it fails a test) and best d, and
// merges its right-view table into the global keys with one 64-bit
// atomicMin per (row, right pixel) that has a candidate below BIG: key =
// (float bits of cost << 32) | d. Costs are >= 0, so their bits order as
// unsigned integers and the minimum key is the plain version's strict-<
// argmin over all tiles (ties to the smallest d); the minimum does not
// depend on the order of the atomics, so the result is deterministic.
//
// Kernel B, bm_lr_kernel, one thread per pixel: the left-right check
// |best - bestR((u - best) mod W)| <= 1, where bestR is the key's d (0 if
// no candidate below BIG), and -1 on the first and last R rows.
//
// Against a block per image row that sums all 121 taps of every window
// from scratch, once per view: each h is computed once per block and
// reused by 11 output rows (the halo costs (16 + 10) / 16 = 1.6x); each
// cost is computed once and serves both views; a diff is one subtract
// whose abs folds into the add, with the BIG select only in tiles that
// touch an edge at that d (a block-uniform branch); the state a pixel
// carries through the walk is 8 registers, not D accumulators.
// Expected per block at D = 64: ~100-128 registers per thread (capped at
// 128 by __launch_bounds__(128, 4), so 4 blocks = 16 warps per SM) and
// 35 KB of shared memory (50 KB at D = 128): 4-6 blocks per SM. The
// build passes --fmad=false, so the parabola arithmetic rounds as in the
// plain version.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1.0e9f;
constexpr int kR = 5;                          // 11x11 window, as the TPU kernel
constexpr int kTileRows = 16;                  // output rows per block
constexpr int kTileW = 32;                     // output columns per block
constexpr int kHRows = kTileRows + 2 * kR;     // 26 h rows per block
constexpr int kSeg = 8;                        // h columns per horizontal thread
constexpr int kSegW = kSeg + 2 * kR;           // 18 diffs per horizontal thread
constexpr int kHItems = kHRows * (kTileW / kSeg);  // 104 horizontal threads
constexpr int kRowsV = 4;                      // output rows per vertical thread
constexpr int kThreads = kTileW * (kTileRows / kRowsV);  // 128
constexpr int kHStride = kTileW + 4;           // padded: conflict-free float4 stores
constexpr int kLW = kTileW + 2 * kR;           // staged L columns
static_assert(kHItems <= kThreads, "horizontal items exceed the block");
static_assert(kTileW == 32, "one warp spans the tile's columns");

template <int D>
struct Layout {
  static constexpr int kRW = kLW + D - 1;      // staged R columns
  static constexpr int kKW = kTileW + D - 1;   // right-view columns
  static constexpr int kH = 0;                 // 2 x kHRows x kHStride floats
  static constexpr int kL = kH + 2 * kHRows * kHStride;
  static constexpr int kRs = kL + kHRows * kLW;
  static constexpr int kRC = kRs + kHRows * kRW;
  static constexpr int kRD = kRC + kTileRows * kKW;
  static constexpr int kWords = kRD + kTileRows * kKW;
  static constexpr size_t kBytes = static_cast<size_t>(kWords) * 4;
};

// Eight horizontal sums from 18 consecutive diffs |l - r| of one row. With
// kChecked a diff whose column index j is outside [lo, hi) reads BIG.
template <bool kChecked>
__device__ __forceinline__ void box_h(const float (&l)[kSegW],
                                      const float (&r)[kSegW], int lo, int hi,
                                      float (&h)[kSeg]) {
  float x[kSegW];
#pragma unroll
  for (int j = 0; j < kSegW; ++j) {
    const float a = fabsf(l[j] - r[j]);
    x[j] = (!kChecked || (j >= lo && j < hi)) ? a : kBig;
  }
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    float s = x[i + kR];
#pragma unroll
    for (int k = 1; k <= kR; ++k) {
      s += x[i + kR - k];
      s += x[i + kR + k];
    }
    h[i] = s;
  }
}

// Four vertical sums (top row first) from 14 rows of one h column. The
// plain version starts from 0; 0 + h == h since h >= +0.
__device__ __forceinline__ void box_v(const float* __restrict__ hcol,
                                      float (&c)[kRowsV]) {
  float hv[kRowsV + 2 * kR];
#pragma unroll
  for (int k = 0; k < kRowsV + 2 * kR; ++k) hv[k] = hcol[k * kHStride];
#pragma unroll
  for (int i = 0; i < kRowsV; ++i) {
    float s = hv[i];
#pragma unroll
    for (int k = 1; k <= 2 * kR; ++k) s += hv[i + k];
    c[i] = s;
  }
}

// The left view of one pixel, online in d (ascending).
struct Pixel {
  int best;     // strict-< argmin so far (0 while no cost < BIG)
  float cmin;   // its cost (BIG while none)
  float cm;     // cost at best - 1 (BIG at best = 0)
  float cp;     // cost at best + 1 (BIG until seen)
  float c2;     // min over seen d with |d - best| > 1
  float prev;   // cost at d - 1
  float pm1;    // min over d' <= d - 1
  float pm2;    // min over d' <= d - 2

  __device__ __forceinline__ void init() {
    best = 0;
    cmin = cm = cp = c2 = prev = pm1 = pm2 = kBig;
  }

  __device__ __forceinline__ void update(int d, float c) {
    if (c < cmin) {
      cm = prev;
      cp = kBig;
      c2 = pm2;
      best = d;
      cmin = c;
    } else if (d == best + 1) {
      cp = c;
    } else if (d > best + 1) {
      c2 = fminf(c2, c);
    }
    pm2 = pm1;
    pm1 = fminf(pm1, c);
    prev = c;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 4)
bm_cost_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
               float* __restrict__ disp, int* __restrict__ best_out,
               unsigned long long* __restrict__ rkey, int H, int W,
               float uniq, float tex_thr) {
  using Ly = Layout<D>;
  const int c0 = blockIdx.x * kTileW;
  const int v0 = kR + blockIdx.y * kTileRows;  // first output row
  const size_t plane = static_cast<size_t>(blockIdx.z) * H * W;
  lf += plane;
  rf += plane;
  disp += plane;
  best_out += plane;
  rkey += plane;

  extern __shared__ __align__(16) float smem[];
  float* sH = smem + Ly::kH;
  float* sL = smem + Ly::kL;
  float* sR = smem + Ly::kRs;
  float* sRC = smem + Ly::kRC;
  int* sRD = reinterpret_cast<int*>(smem + Ly::kRD);
  const int tid = threadIdx.x;

  // ---- stage rows v0 - R .. v0 + T + R - 1 (0 outside the image)
  for (int i = tid; i < kHRows * kLW; i += kThreads) {
    const int y = v0 - kR + i / kLW;
    const int x = c0 - kR + i % kLW;
    sL[i] = (y < H && x >= 0 && x < W) ? lf[static_cast<size_t>(y) * W + x]
                                       : 0.0f;
  }
  for (int i = tid; i < kHRows * Ly::kRW; i += kThreads) {
    const int y = v0 - kR + i / Ly::kRW;
    const int x = c0 - kR - (D - 1) + i % Ly::kRW;
    sR[i] = (y < H && x >= 0 && x < W) ? rf[static_cast<size_t>(y) * W + x]
                                       : 0.0f;
  }
  for (int i = tid; i < kTileRows * Ly::kKW; i += kThreads) {
    sRC[i] = kBig;
    sRD[i] = 0;
  }
  __syncthreads();

  // horizontal role: halo row hr, columns hc .. hc + 7 of the tile
  const bool h_item = tid < kHItems;
  const int hr = h_item ? tid / (kTileW / kSeg) : 0;
  const int hc = (tid % (kTileW / kSeg)) * kSeg;
  const int xbase = c0 + hc - kR;  // image column of diff j = 0
  float l[kSegW], r[kSegW];
#pragma unroll
  for (int j = 0; j < kSegW; ++j) {
    l[j] = sL[hr * kLW + hc + j];
    r[j] = sR[hr * Ly::kRW + hc + j + D - 1];
  }
  // vertical role: column u, output rows g * 4 .. g * 4 + 3
  const int u = tid % kTileW;
  const int g = tid / kTileW;
  Pixel px[kRowsV];
#pragma unroll
  for (int i = 0; i < kRowsV; ++i) px[i].init();
  // a tile needs no BIG select at d when its halo lies inside the image
  // and its leftmost halo column is >= d
  const bool right_in = c0 + kTileW + kR <= W;

#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    float* hbuf = sH + (d & 1) * kHRows * kHStride;
    if (h_item) {
      if (d > 0) {
#pragma unroll
        for (int j = kSegW - 1; j > 0; --j) r[j] = r[j - 1];
        r[0] = sR[hr * Ly::kRW + hc + D - 1 - d];
      }
      float h[kSeg];
      if (right_in && c0 - kR - d >= 0) {  // block-uniform
        box_h<false>(l, r, 0, kSegW, h);
      } else {
        box_h<true>(l, r, d - xbase, W - xbase, h);
      }
      float4* dst = reinterpret_cast<float4*>(hbuf + hr * kHStride + hc);
      dst[0] = make_float4(h[0], h[1], h[2], h[3]);
      dst[1] = make_float4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();
    float c[kRowsV];
    box_v(hbuf + g * kRowsV * kHStride + u, c);
#pragma unroll
    for (int i = 0; i < kRowsV; ++i) {
      px[i].update(d, c[i]);
      const int k = (g * kRowsV + i) * Ly::kKW + u - d + D - 1;
      if (c[i] < sRC[k]) {
        sRC[k] = c[i];
        sRD[k] = d;
      }
    }
  }
  __syncthreads();

  // ---- texture: the same separable box over |L|, BIG outside the image
  if (h_item) {
    float zero[kSegW], h[kSeg];
#pragma unroll
    for (int j = 0; j < kSegW; ++j) zero[j] = 0.0f;
    box_h<true>(l, zero, -xbase, W - xbase, h);
    float4* dst = reinterpret_cast<float4*>(sH + hr * kHStride + hc);
    dst[0] = make_float4(h[0], h[1], h[2], h[3]);
    dst[1] = make_float4(h[4], h[5], h[6], h[7]);
  }
  __syncthreads();
  float tex[kRowsV];
  box_v(sH + g * kRowsV * kHStride + u, tex);

  const float full = static_cast<float>((2 * kR + 1) * (2 * kR + 1));
  const int x = c0 + u;
#pragma unroll
  for (int i = 0; i < kRowsV; ++i) {
    const int v = v0 + g * kRowsV + i;
    if (v >= H - kR || x >= W) continue;
    const Pixel& p = px[i];
    const float denom = p.cm + p.cp - 2.0f * p.cmin;
    const bool interior =
        p.best > 0 && p.best < D - 1 && p.cm < kBig && p.cp < kBig;
    float delta = (interior && denom > 1e-9f)
                      ? 0.5f * (p.cm - p.cp) / fmaxf(denom, 1e-9f)
                      : 0.0f;
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    const bool ok = p.cmin < 1e4f && p.cmin * uniq <= p.c2 &&
                    tex[i] / full > tex_thr && p.best > 0;
    const size_t o = static_cast<size_t>(v) * W + x;
    disp[o] = ok ? static_cast<float>(p.best) + delta : -1.0f;
    best_out[o] = p.best;
  }

  // ---- right view: merge this tile's candidates into the global keys
  for (int i = tid; i < kTileRows * Ly::kKW; i += kThreads) {
    const int v = v0 + i / Ly::kKW;
    const int ur = c0 - (D - 1) + i % Ly::kKW;
    const float cr = sRC[i];
    if (v < H - kR && ur >= 0 && ur < W && cr < kBig) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(cr)) << 32) |
          static_cast<unsigned int>(sRD[i]);
      atomicMin(rkey + static_cast<size_t>(v) * W + ur, key);
    }
  }
}

__global__ void bm_lr_kernel(float* __restrict__ disp,
                             const int* __restrict__ best,
                             const unsigned long long* __restrict__ rkey,
                             int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const size_t plane = static_cast<size_t>(blockIdx.y) * H * W;
  const int v = i / W;
  const int u = i - v * W;
  if (v < kR || v >= H - kR) {
    disp[plane + i] = -1.0f;
    return;
  }
  if (disp[plane + i] < 0.0f) return;  // failed a left-view test
  const int b = best[plane + i];
  int ur = (u - b) % W;
  if (ur < 0) ur += W;
  const unsigned long long key = rkey[plane + static_cast<size_t>(v) * W + ur];
  const int br = key == ~0ull ? 0 : static_cast<int>(key & 0xffffffffull);
  if (abs(b - br) > 1) disp[plane + i] = -1.0f;
}

template <int D>
cudaError_t launch(const float* lf, const float* rf, float* disp, int* best,
                   unsigned long long* rkey, int B, int H, int W,
                   float uniq, float tex_thr, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (H > 2 * kR) {
    const size_t smem = Layout<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(
        bm_cost_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((W + kTileW - 1) / kTileW,
                    (H - 2 * kR + kTileRows - 1) / kTileRows, B);
    bm_cost_kernel<D><<<grid, kThreads, smem, stream>>>(
        lf, rf, disp, best, rkey, H, W, uniq, tex_thr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int threads = 256;
  const dim3 grid_lr((H * W + threads - 1) / threads, B);
  bm_lr_kernel<<<grid_lr, threads, 0, stream>>>(disp, best, rkey, H, W);
  return cudaGetLastError();
}

}  // namespace

// One disparity count per build (-DSTEREO_BM_D=<D>): the walk over d and
// the shared-memory layout are specialised for it.
#ifndef STEREO_BM_D
#error "compile with -DSTEREO_BM_D=<number of disparities>"
#endif

extern "C" int stereo_bm_num_disp() { return STEREO_BM_D; }
extern "C" int stereo_bm_radius() { return kR; }
extern "C" int stereo_bm_tile_rows() { return kTileRows; }
extern "C" int stereo_bm_tile_cols() { return kTileW; }
extern "C" int stereo_bm_smem_bytes() {
  return static_cast<int>(Layout<STEREO_BM_D>::kBytes);
}

// B streams of (H, W) planes, stacked contiguously (one image is B = 1):
// two kernels on `stream`; rkey must hold ~0 on entry.
extern "C" int stereo_bm_launch_batched(const float* lf, const float* rf,
                                        float* disp, int* best, void* rkey,
                                        int B, int H, int W, int D, int R,
                                        float uniq, float tex_thr,
                                        void* stream) {
  if (D != STEREO_BM_D || R != kR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<STEREO_BM_D>(
      lf, rf, disp, best, static_cast<unsigned long long*>(rkey), B, H, W,
      uniq, tex_thr, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* stereo_bm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
