// Fused homography warp + front-to-back over-composite of an MPI, with each
// plane's sample coordinates computed in the kernel from 3x3 matrices.
//
// Replaces the TPU kernel warp_composite_chw (mine_tpu/ops/pallas/warp.py:689,
// body _warp_composite_kernel :624) and the coordinate prep that feeds it
// (mine_tpu/ops/mpi_render.py _fused_forward: the sample coordinates, the
// target-frame xyz, the inter-plane distances and the payload's re-layout).
// For output pixel (px, py) of pose n, plane s, in order:
//   [hx, hy, hz] = H_src_tgt[n, s] [px, py, 1], |hz| < 1e-8 pushed to +-1e-8,
//   (x, y) = (hx / hz, hy / hz), the sample point in the source;
//   xyz_s = M[n, s] [clamp(x), clamp(y), 1] + t[n], the target-frame point;
//   dist_s = |xyz_{s+1} - xyz_s|, and the background's 1e3 for the last plane;
// then rgb + sigma sampled with the warp's border-clamped bilinear tap,
// sigma zeroed where z_s < 0, and
//   tau = exp(-sigma * dist), w = T * (1 - tau),
//   acc_rgb += w * rgb, acc_z += w * z, acc_w += w,
//   acc_valid += (x, y) inside (-1, W) x (-1, H),  T <- T * (tau + 1e-6).
// Output (N, 7, H, W): 3 rgb sums, z sum, weight sum, valid count, T.
// The coordinate arithmetic is written with round-to-nearest intrinsics in
// the torch prep's order of operations (ops/geometry.py apply_3x3,
// ops/homography.py, ops/mpi_render.py), so no multiply-add is contracted
// and the coordinates equal the dense path's bit for bit.
//
// Bound: memory. The payload is read in place from the network's
// channel-last mpi_rgb (N, S, H, W, 3) and mpi_sigma (N, S, H, W, 1): 16 bytes
// a plane pixel, about once each for the smooth homographies of an MPI; the
// output, 28 bytes a pixel, is written once; the matrices are 80 bytes a
// plane. At S=32, 384x512 that is 106 MB, 32 us at 3.35 TB/s.
//
// Design: kLanes = 2 lanes per output pixel, each sweeping a contiguous
// segment of the planes (16 of 32) with its seven accumulators in registers;
// the segments then combine with the associative over-operator through
// __shfl_down_sync (rgb, z, w: a + T_a * b; valid: a + b; T: T_a * T_b).
// A segment's last distance needs the xyz of the first plane past it, so
// each lane computes one plane's geometry ahead, and issues the next plane's
// corner loads before it composites the current one. A block's 64 pixels
// belong to one pose, whose planes' matrices it stages in shared memory, 20
// floats a plane, read as float4. On an H100 two lanes beat one by a little
// and four or eight by a lot (mine_tpu_torch/kernel_variants.py times them):
// every extra segment recomputes a plane's geometry and spreads a warp's
// gathers over more planes, hence more cache lines per load.
#include "warp_common.cuh"

namespace {

constexpr int kLanes = 2;  // lanes per output pixel
constexpr int kThreads = 128;
constexpr int kPixels = kThreads / kLanes;  // output pixels per block
constexpr int kMapFloats = 20;              // H_src_tgt (9), M (9), 2 pad
constexpr float kBgDist = 1.0e3f;           // distance behind the last plane

// a*x + b*y + c rounded op by op: torch's apply_3x3 row
__device__ __forceinline__ float row_rn(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

struct Plane {
  float x, y;    // the unclamped sample point in the source
  float xyz[3];  // the target-frame point at the clamped sample
  mine::BilinearTap tap;
};

// one plane's geometry at target pixel (px, py); map holds H_src_tgt row-major,
// then M row-major, then padding
__device__ __forceinline__ Plane plane_at(const float* map, const float t[3], float px,
                                          float py, int h, int w) {
  const float4* m4 = reinterpret_cast<const float4*>(map);
  const float4 a = m4[0], b = m4[1], c = m4[2], d = m4[3], e = m4[4];
  const float hx = row_rn(a.x, a.y, a.z, px, py);
  const float hy = row_rn(a.w, b.x, b.y, px, py);
  float hz = row_rn(b.z, b.w, c.x, px, py);
  // a plane edge-on to the target camera: pushed far out of bounds, where
  // the clamp and the validity mask handle it
  if (fabsf(hz) < 1.0e-8f) hz = hz < 0.0f ? -1.0e-8f : 1.0e-8f;
  Plane p;
  p.x = __fdiv_rn(hx, hz);
  p.y = __fdiv_rn(hy, hz);
  p.tap = mine::prep_coords(p.x, p.y, h, w);
  const float qx = fminf(fmaxf(p.x, 0.0f), (float)(w - 1));
  const float qy = fminf(fmaxf(p.y, 0.0f), (float)(h - 1));
  p.xyz[0] = __fadd_rn(row_rn(c.y, c.z, c.w, qx, qy), t[0]);
  p.xyz[1] = __fadd_rn(row_rn(d.x, d.y, d.z, qx, qy), t[1]);
  p.xyz[2] = __fadd_rn(row_rn(d.w, e.x, e.y, qx, qy), t[2]);
  return p;
}

// the four corners' r, g, b, sigma; a masked corner reads 0. Offsets within
// one (h, w) plane are 32-bit (the wrapper refuses planes of 2^31 pixels),
// which keeps two planes' taps in fewer registers.
__device__ __forceinline__ void load_corners(const float* __restrict__ rgb,
                                             const float* __restrict__ sigma,
                                             const mine::BilinearTap& t, int w, float v[4][4]) {
  const int o00 = t.y0 * w + t.x0;
  const int off[4] = {o00, o00 + 1, o00 + w, o00 + w + 1};
  const bool ok[4] = {t.v00, t.v01, t.v10, t.v11};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[k][ch] = ok[k] ? __ldg(rgb + 3 * off[k] + ch) : 0.0f;
    v[k][3] = ok[k] ? __ldg(sigma + off[k]) : 0.0f;
  }
}

// mine::sample's blend order: top row, bottom row, then the vertical mix
__device__ __forceinline__ float blend(const float v[4][4], int ch, const mine::BilinearTap& t) {
  const float top = v[0][ch] * (1.0f - t.wx) + v[1][ch] * t.wx;
  const float bot = v[2][ch] * (1.0f - t.wx) + v[3][ch] * t.wx;
  return top * (1.0f - t.wy) + bot * t.wy;
}

__global__ void __launch_bounds__(kThreads)
    warp_composite_kernel(const float* __restrict__ mpi_rgb, const float* __restrict__ mpi_sigma,
                          const float* __restrict__ h_src_tgt, const float* __restrict__ xyz_m,
                          const float* __restrict__ xyz_t, float* __restrict__ out, int s,
                          int h, int w) {
  extern __shared__ float4 smem[];
  float* maps = reinterpret_cast<float*>(smem);
  const int64_t n = blockIdx.y;
  const int64_t hw = (int64_t)h * w;
  for (int k = threadIdx.x; k < s * kMapFloats; k += kThreads) {
    const int sp = k / kMapFloats, e = k - sp * kMapFloats;
    const int64_t q = (n * s + sp) * 9;
    maps[k] = e < 9 ? __ldg(h_src_tgt + q + e) : e < 18 ? __ldg(xyz_m + q + e - 9) : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int64_t p = (int64_t)blockIdx.x * kPixels + threadIdx.x / kLanes;
  const bool active = p < hw;
  const float t[3] = {__ldg(xyz_t + 3 * n), __ldg(xyz_t + 3 * n + 1), __ldg(xyz_t + 3 * n + 2)};
  const float px = (float)(p % w), py = (float)(p / w);
  // this lane's planes [s0, s1), as even as S allows; an empty segment is
  // the over-operator's identity
  const int s0 = active ? lane * s / kLanes : 0;
  const int s1 = active ? (lane + 1) * s / kLanes : 0;

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float z_sum = 0.0f, w_sum = 0.0f, valid_sum = 0.0f, trans = 1.0f;
  if (s0 < s1) {
    const float* rgb_n = mpi_rgb + n * s * hw * 3;
    const float* sigma_n = mpi_sigma + n * s * hw;
    Plane cur = plane_at(maps + s0 * kMapFloats, t, px, py, h, w);
    float v[4][4];
    load_corners(rgb_n + s0 * hw * 3, sigma_n + s0 * hw, cur.tap, w, v);
    for (int sp = s0; sp < s1; ++sp) {
      const bool has_next = sp + 1 < s;
      Plane nxt = cur;
      float nv[4][4] = {};
      if (has_next) nxt = plane_at(maps + (sp + 1) * kMapFloats, t, px, py, h, w);
      if (sp + 1 < s1) {
        load_corners(rgb_n + (sp + 1) * hw * 3, sigma_n + (sp + 1) * hw, nxt.tap, w, nv);
      }
      float dist = kBgDist;
      if (has_next) {
        const float dx = __fsub_rn(nxt.xyz[0], cur.xyz[0]);
        const float dy = __fsub_rn(nxt.xyz[1], cur.xyz[1]);
        const float dz = __fsub_rn(nxt.xyz[2], cur.xyz[2]);
        dist = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz)));
      }
      const float zz = cur.xyz[2];
      // planes behind the target camera contribute nothing
      const float sigma = zz >= 0.0f ? blend(v, 3, cur.tap) : 0.0f;
      const bool valid = cur.x > -1.0f && cur.x < (float)w && cur.y > -1.0f && cur.y < (float)h;
      const float tau = expf(-sigma * dist);
      const float wgt = trans * (1.0f - tau);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rgb[ch] += wgt * blend(v, ch, cur.tap);
      z_sum += wgt * zz;
      w_sum += wgt;
      valid_sum += valid ? 1.0f : 0.0f;
      // the 1e-6 keeps the transmittance off exactly zero, as the dense cumprod
      trans = trans * (tau + 1.0e-6f);
      cur = nxt;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) v[k][ch] = nv[k][ch];
    }
  }

  // combine the segments front to back: this lane's is in front of the one
  // `off` lanes up (every lane shuffles; only lane 0's result is kept)
#pragma unroll
  for (int off = 1; off < kLanes; off *= 2) {
    float back[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) back[ch] = __shfl_down_sync(0xffffffffu, rgb[ch], off, kLanes);
    const float back_z = __shfl_down_sync(0xffffffffu, z_sum, off, kLanes);
    const float back_w = __shfl_down_sync(0xffffffffu, w_sum, off, kLanes);
    const float back_valid = __shfl_down_sync(0xffffffffu, valid_sum, off, kLanes);
    const float back_trans = __shfl_down_sync(0xffffffffu, trans, off, kLanes);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] += trans * back[ch];
    z_sum += trans * back_z;
    w_sum += trans * back_w;
    valid_sum += back_valid;
    trans *= back_trans;
  }

  if (lane == 0 && active) {
    float* o = out + n * 7 * hw + p;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch * hw] = rgb[ch];
    o[3 * hw] = z_sum;
    o[4 * hw] = w_sum;
    o[5 * hw] = valid_sum;
    o[6 * hw] = trans;
  }
}

}  // namespace

// mpi_rgb (n, s, h, w, 3) and mpi_sigma (n, s, h, w, 1), contiguous; h_src_tgt
// and xyz_m (n, s, 3, 3); xyz_t (n, 3); out (n, 7, h, w). The wrapper checks
// shapes and layouts before it calls.
extern "C" int mine_warp_composite_f32(const void* mpi_rgb, const void* mpi_sigma,
                                       const void* h_src_tgt, const void* xyz_m,
                                       const void* xyz_t, void* out, int n, int s, int h,
                                       int w, void* stream) {
  const int smem = s * kMapFloats * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t hw = (int64_t)h * w;
  const dim3 grid((unsigned int)((hw + kPixels - 1) / kPixels), n);
  warp_composite_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)mpi_rgb, (const float*)mpi_sigma, (const float*)h_src_tgt,
      (const float*)xyz_m, (const float*)xyz_t, (float*)out, s, h, w);
  return (int)cudaGetLastError();
}
