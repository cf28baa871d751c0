// Block-matching stereo disparity for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scavislam_tpu/ops/stereo_pallas.py::_bm_kernel
// through both of its callers: block_matching_disparity_pallas (one image)
// and block_matching_disparity_pallas_batched (B streams in one launch over
// a (B, H/rows) grid). Same semantics, not the same design: the TPU kernel
// keeps a 32-row slab's (D, rows, W) cost volume in VMEM and box-filters
// with lane rolls and a banded matmul; here one thread block owns one image
// row of one stream.
//
//   * Inputs: the Sobel-x prefiltered left/right images (clipped to +-0.5,
//     applied outside the kernel), f32 (B, H, W), row-major, contiguous;
//     the single-image entry is B = 1.
//   * Output: f32 (B, H, W) disparity, -1 where invalid.
//   * Grid (H, B): blockIdx.x is the row, blockIdx.y the stream, whose three
//     planes start b * H * W floats in. A stream's rows run the same code
//     on the same bytes whatever B is, so the batched result is bit for bit
//     the single-image result of each stream.
//
// Per row v in [R, H-R) a block stages the (2R+1) window rows of both
// images in shared memory. Each thread walks columns u and computes
//   - the left-view cost of every disparity d: the (2R+1)^2 box sum of
//     |L(x, y) - R(x - d, y)|, where a column x < d or outside the image
//     contributes BIG = 1e9 (the TPU kernel's border semantics). The sum
//     runs row by row from the top; within a row the taps go u, u-1, u+1,
//     u-2, u+2, ... — exactly the plain version's order, so the two agree
//     bit for bit (the build passes --fmad=false for the same reason);
//   - argmin (strict <: ties keep the smallest d), the runner-up excluding
//     |d - best| <= 1, the parabola neighbours, the texture sum of |L|;
//   - the right-view winner of column u: argmin over d of cost(u + d, d)
//     (BIG past the right edge), recomputed with the same arithmetic.
// Winners are exchanged through shared memory and the block applies the
// left-right check |best(u) - bestR(u - best(u))| <= 1 in place. Rows
// outside [R, H-R) are written -1 (the TPU kernel's border-row rule).
//
// What bounds it on the H100: compute, not bytes. A 512x384 frame at D=64
// moves ~2.4 MB through device memory but does 2 x 64 x 121 abs-diff-adds
// per pixel (~3 G operations), all fed from shared memory. The window rows
// are read once per block from device memory; the per-d costs live in
// registers (D accumulators per thread). Reusing horizontal partial sums
// across neighbouring columns (a sliding window) or across disparities
// would cut the work ~10x, but changes the summation order; that is later
// work, as are TMA staging and multi-row blocks.
//
// Shared memory per block: (2 * (2R+1) + 3) * W * 4 bytes — 51,200 bytes at
// W = 512, R = 5; the wrapper refuses widths past the 227 KB a block can
// hold (W > 2324 at R = 5).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1.0e9f;
constexpr int kThreads = 128;

// Cost of column c at disparity d: (2R+1)^2 box sum with BIG borders.
__device__ __forceinline__ float tap(const float* __restrict__ l,
                                     const float* __restrict__ r,
                                     int x, int d, int W) {
  return (x >= d && x >= 0 && x < W) ? fabsf(l[x] - r[x - d]) : kBig;
}

__device__ __forceinline__ float window_cost(const float* __restrict__ sl,
                                             const float* __restrict__ sr,
                                             int c, int d, int W, int R) {
  float acc = 0.0f;
  for (int rr = 0; rr <= 2 * R; ++rr) {
    const float* l = sl + rr * W;
    const float* r = sr + rr * W;
    float h = tap(l, r, c, d, W);
    for (int k = 1; k <= R; ++k) {
      h += tap(l, r, c - k, d, W);
      h += tap(l, r, c + k, d, W);
    }
    acc += h;
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bm_row_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
              float* __restrict__ disp, int H, int W, int R, float uniq,
              float tex_thr) {
  const int v = blockIdx.x;
  const size_t plane = static_cast<size_t>(blockIdx.y) * H * W;
  lf += plane;
  rf += plane;
  disp += plane;
  if (v < R || v >= H - R) {
    for (int u = threadIdx.x; u < W; u += blockDim.x) disp[v * W + u] = -1.0f;
    return;
  }
  extern __shared__ float smem[];
  const int win = 2 * R + 1;
  float* sl = smem;                             // win * W
  float* sr = sl + win * W;                     // win * W
  float* s_disp = sr + win * W;                 // W: subpixel disparity or -1
  int* s_best = reinterpret_cast<int*>(s_disp + W);   // W
  int* s_bestr = s_best + W;                          // W

  const float* lsrc = lf + (v - R) * W;
  const float* rsrc = rf + (v - R) * W;
  for (int i = threadIdx.x; i < win * W; i += blockDim.x) {
    sl[i] = lsrc[i];
    sr[i] = rsrc[i];
  }
  __syncthreads();

  const float full = static_cast<float>(win * win);
  for (int u = threadIdx.x; u < W; u += blockDim.x) {
    // ---- left view: D costs in registers, row-major accumulation order
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    float tex = 0.0f;
    for (int rr = 0; rr < win; ++rr) {
      const float* l = sl + rr * W;
      const float* r = sr + rr * W;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float h = tap(l, r, u, d, W);
        for (int k = 1; k <= R; ++k) {
          h += tap(l, r, u - k, d, W);
          h += tap(l, r, u + k, d, W);
        }
        acc[d] += h;
      }
      float t = fabsf(l[u]);
      for (int k = 1; k <= R; ++k) {
        t += (u - k >= 0) ? fabsf(l[u - k]) : kBig;
        t += (u + k < W) ? fabsf(l[u + k]) : kBig;
      }
      tex += t;
    }
    float cmin = kBig;
    int best = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (acc[d] < cmin) {
        cmin = acc[d];
        best = d;
      }
    }
    float c2 = kBig, c_m = kBig, c_p = kBig;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float c = acc[d];
      if (abs(best - d) > 1 && c < c2) c2 = c;
      if (d == best - 1) c_m = c;
      if (d == best + 1) c_p = c;
    }
    const float denom = c_m + c_p - 2.0f * cmin;
    const bool interior =
        best > 0 && best < D - 1 && c_m < kBig && c_p < kBig;
    float delta = (interior && denom > 1e-9f)
                      ? 0.5f * (c_m - c_p) / fmaxf(denom, 1e-9f)
                      : 0.0f;
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    const bool ok = cmin < 1e4f && cmin * uniq <= c2 &&
                    tex / full > tex_thr && best > 0;
    s_disp[u] = ok ? static_cast<float>(best) + delta : -1.0f;
    s_best[u] = best;

    // ---- right view: winner over d of cost(u + d, d), BIG past the edge
    float bestr_c = kBig;
    int bestr = 0;
    for (int d = 0; d < D; ++d) {
      const float cl = (u < W - d) ? window_cost(sl, sr, u + d, d, W, R) : kBig;
      if (cl < bestr_c) {
        bestr_c = cl;
        bestr = d;
      }
    }
    s_bestr[u] = bestr;
  }
  __syncthreads();

  // ---- left-right check: |best(u) - bestR((u - best(u)) mod W)| <= 1
  for (int u = threadIdx.x; u < W; u += blockDim.x) {
    const int best = s_best[u];
    int ur = u - best;
    if (ur < 0) ur += W;
    const bool lr_ok = abs(best - s_bestr[ur]) <= 1;
    disp[v * W + u] = lr_ok ? s_disp[u] : -1.0f;
  }
}

template <int D>
cudaError_t launch(const float* lf, const float* rf, float* disp, int B, int H,
                   int W, int R, float uniq, float tex_thr,
                   cudaStream_t stream) {
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;  // gridDim.y limit
  const size_t smem = static_cast<size_t>(2 * (2 * R + 1) + 3) * W * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bm_row_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  bm_row_kernel<D><<<grid, kThreads, smem, stream>>>(lf, rf, disp, H, W, R,
                                                     uniq, tex_thr);
  return cudaGetLastError();
}

}  // namespace

// One disparity count per build (-DSTEREO_BM_D=<D>): the per-d costs are
// unrolled into registers, and instantiating every supported D in one file
// took ~60 s of nvcc; one D takes a few seconds.
#ifndef STEREO_BM_D
#error "compile with -DSTEREO_BM_D=<number of disparities>"
#endif

extern "C" int stereo_bm_num_disp() { return STEREO_BM_D; }

extern "C" int stereo_bm_launch(const float* lf, const float* rf, float* disp,
                                int H, int W, int D, int R, float uniq,
                                float tex_thr, void* stream) {
  if (D != STEREO_BM_D) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<STEREO_BM_D>(
      lf, rf, disp, 1, H, W, R, uniq, tex_thr,
      static_cast<cudaStream_t>(stream)));
}

// B streams of (H, W) planes, stacked contiguously, in one launch.
extern "C" int stereo_bm_launch_batched(const float* lf, const float* rf,
                                        float* disp, int B, int H, int W,
                                        int D, int R, float uniq,
                                        float tex_thr, void* stream) {
  if (D != STEREO_BM_D) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<STEREO_BM_D>(
      lf, rf, disp, B, H, W, R, uniq, tex_thr,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* stereo_bm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
