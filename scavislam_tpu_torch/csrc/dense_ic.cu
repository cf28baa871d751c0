// One inverse-compositional evaluation of the dense photometric tracker
// for Hopper (sm_90a): (H, b, chi2) = (J^T J, J^T r, r^T r) of a candidate
// pose over a reference cloud, for L lanes (streams) in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this evaluation to XLA
// (scavislam_tpu/models/dense_tracker.py::_ic_pass). The port ran it as 87
// PyTorch operations and two cuBLAS products, once before each pyramid
// level's LM and once in each of its 30 trips: 93 times a frame step, over
// every point of the cloud. Same function as the plain PyTorch version in
// scavislam_tpu_torch/ops/dense_ic.py (ic_pass_plain), with its per-point
// float32 arithmetic in the same order and the sums taken in float64.
//
//   * Inputs, per lane, each lane's block contiguous and lanes at any
//     stride (0: one block shared by every lane): the image f32 (h, w);
//     the candidate pose R f32 (3, 3) and t f32 (3), read on the device
//     (no host read, so the call captures into a CUDA graph); the cloud
//     xyz f32 (n, 3), its intensities f32 (n), template Jacobian f32
//     (n, 6) and valid flags bool (n).
//   * Outputs, per lane: H f32 (6, 6) with both triangles, b f32 (6),
//     chi2 f32 ().
//   * Scratch, allocated by the caller: f64 (L, nblk, 28) partial sums.
//
// Per point, as the plain version: p = R x + t (each row x R0, then y R1
// and z R2 by fused multiply-add, as cuBLAS sums a depth-3 product, then
// + t); u = p0 / p2 * f + px, v likewise; in frame if u in [2, w - 2),
// v in [2, h - 2), p2 > 1e-6 and valid; there the bilinear sample at
// (u, v) (base floor(u), floor(v); the lerps' order of the plain version),
// the residual i_ref - i_cur clamped to +-0.1, and the Jacobian row; a
// point out of frame adds nothing. Every float32 step is an explicit
// round-to-nearest intrinsic, so no contraction changes a residual.
//
// What bounds it on the H100: latency, not bytes. One call reads 41 B a
// point (xyz, J, i_ref, valid) plus 4 image taps from L2: ~2 MB at 49,152
// points, 0.6 us at 3.35 TB/s; the arithmetic, ~30 float32 operations and
// 28 float64 fused multiply-adds a point, ~1.4 M double operations, ~40 us
// of one SM and ~0.3 us of the card's 132. So the design keeps every
// point's work in one pass with no intermediate in device memory:
//
// Kernel A, dense_ic_partial_kernel, grid (nblk, L), 256 threads: each
// thread walks points i, i + nblk * 256, ... of its lane and keeps the 21
// upper-triangle entries of J^T J, the 6 of J^T r and r^T r in float64
// registers; the block sums them by warp shuffles (a fixed tree) and then
// across its 8 warps in order through shared memory, and writes its 28
// partials. nblk (the wrapper's blocks_per_lane, one point a thread up to
// 256 blocks) depends on n alone, so a lane sums in one order whatever L:
// 192 blocks at 49,152 points (L = 1), 8 x 48 at 12,288, 8 x 12 at 3,072.
//
// Kernel B, dense_ic_final_kernel, grid (L), one warp per sum: each lane
// of the warp adds every 32nd partial in order, a shuffle tree adds the
// 32, and the result is rounded to float32.
//
// No atomics: every sum runs in an order fixed by the launch shape, so two
// replays of one graph give bit-equal outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;  // 21 of J^T J, 6 of J^T r, r^T r
constexpr int kBorder = 2;
constexpr float kResClamp = 0.1f;
constexpr float kMinDepth = 1e-6f;

struct Params {
  const float* img;
  const float* R;
  const float* t;
  const float* xyz;
  const float* i_ref;
  const float* J;
  const unsigned char* valid;
  long long img_ls, R_ls, t_ls, xyz_ls, i_ref_ls, J_ls, valid_ls;
  double* partial;
  int n, h, w, nblk;
  float focal, px, py;
};

__device__ __forceinline__ float row(const float* R, const float* t, int r,
                                     float x, float y, float z) {
  float acc = __fmul_rn(x, R[3 * r]);
  acc = __fmaf_rn(y, R[3 * r + 1], acc);
  acc = __fmaf_rn(z, R[3 * r + 2], acc);
  return __fadd_rn(acc, t[r]);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__global__ void __launch_bounds__(kThreads)
dense_ic_partial_kernel(const Params p) {
  const int lane = blockIdx.y;
  const float* img = p.img + lane * p.img_ls;
  const float* xyz = p.xyz + lane * p.xyz_ls;
  const float* i_ref = p.i_ref + lane * p.i_ref_ls;
  const float* J = p.J + lane * p.J_ls;
  const unsigned char* valid = p.valid + lane * p.valid_ls;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(p.R + lane * p.R_ls + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = __ldg(p.t + lane * p.t_ls + k);
  const float umax = static_cast<float>(p.w - kBorder);
  const float vmax = static_cast<float>(p.h - kBorder);

  double acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n;
       i += p.nblk * kThreads) {
    if (!valid[i]) continue;
    const float x = __ldg(xyz + 3 * i);
    const float y = __ldg(xyz + 3 * i + 1);
    const float z = __ldg(xyz + 3 * i + 2);
    const float cx = row(R, t, 0, x, y, z);
    const float cy = row(R, t, 1, x, y, z);
    const float cz = row(R, t, 2, x, y, z);
    const float u = __fadd_rn(__fmul_rn(__fdiv_rn(cx, cz), p.focal), p.px);
    const float v = __fadd_rn(__fmul_rn(__fdiv_rn(cy, cz), p.focal), p.py);
    if (!(u >= kBorder && u < umax && v >= kBorder && v < vmax &&
          cz > kMinDepth)) {
      continue;
    }
    // in frame: floor(u) lies in [2, w - 3], so the plain version's clamp
    // of the base to [0, w - 2] changes nothing
    const int u0 = static_cast<int>(floorf(u));
    const int v0 = static_cast<int>(floorf(v));
    const float fu = __fsub_rn(u, static_cast<float>(u0));
    const float fv = __fsub_rn(v, static_cast<float>(v0));
    const float* tap = img + static_cast<long long>(v0) * p.w + u0;
    const float top = lerp(__ldg(tap), __ldg(tap + 1), fu);
    const float bot = lerp(__ldg(tap + p.w), __ldg(tap + p.w + 1), fu);
    float r = __fsub_rn(__ldg(i_ref + i), lerp(top, bot, fv));
    // torch.clamp: NaN stays NaN
    r = r < -kResClamp ? -kResClamp : (r > kResClamp ? kResClamp : r);
    double j[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) j[a] = static_cast<double>(__ldg(J + 6 * i + a));
    const double rd = static_cast<double>(r);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b, ++k) acc[k] = __fma_rn(j[a], j[b], acc[k]);
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] = __fma_rn(j[a], rd, acc[21 + a]);
    acc[27] = __fma_rn(rd, rd, acc[27]);
  }

  __shared__ double warp_sums[kWarps][kAcc];
  const int wid = threadIdx.x / 32;
  const int lid = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    double s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lid == 0) warp_sums[wid][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    double s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    p.partial[(static_cast<long long>(lane) * p.nblk + blockIdx.x) * kAcc +
              threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(32 * kAcc)
dense_ic_final_kernel(const double* __restrict__ partial, int nblk,
                      float* __restrict__ H, float* __restrict__ b,
                      float* __restrict__ chi2) {
  const int lane = blockIdx.x;
  const int k = threadIdx.x / 32;
  const int lid = threadIdx.x % 32;
  const double* src = partial + static_cast<long long>(lane) * nblk * kAcc;
  double s = 0.0;
  for (int j = lid; j < nblk; j += 32) s += src[j * kAcc + k];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lid != 0) return;
  const float f = static_cast<float>(s);
  if (k < 21) {
    // k-th entry of the upper triangle, row by row
    int a = 0, first = 0;
    while (k >= first + 6 - a) {
      first += 6 - a;
      ++a;
    }
    const int c = a + (k - first);
    H[lane * 36 + a * 6 + c] = f;
    H[lane * 36 + c * 6 + a] = f;
  } else if (k < 27) {
    b[lane * 6 + (k - 21)] = f;
  } else {
    chi2[lane] = f;
  }
}

}  // namespace

extern "C" int dense_ic_accumulators() { return kAcc; }
extern "C" int dense_ic_threads() { return kThreads; }

// L lanes of one evaluation each: two kernels on `stream`. Lane strides
// are in elements.
extern "C" int dense_ic_launch(
    const float* img, long long img_ls, const float* R, long long R_ls,
    const float* t, long long t_ls, const float* xyz, long long xyz_ls,
    const float* i_ref, long long i_ref_ls, const float* J, long long J_ls,
    const unsigned char* valid, long long valid_ls, int L, int n, int h,
    int w, float focal, float px, float py, int nblk, double* partial,
    float* H, float* b, float* chi2, void* stream) {
  if (L < 1 || L > 65535 || n < 0 || h < 1 || w < 1 || nblk < 1 ||
      nblk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{img,    R,    t,    xyz,    i_ref,    J,    valid,
                 img_ls, R_ls, t_ls, xyz_ls, i_ref_ls, J_ls, valid_ls,
                 partial, n, h, w, nblk, focal, px, py};
  dense_ic_partial_kernel<<<dim3(nblk, L), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_ic_final_kernel<<<L, 32 * kAcc, 0, s>>>(partial, nblk, H, b, chi2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dense_ic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
