// Projection, SH colours and the table pack, backward (K5), hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fused the VJP of this
// per-gaussian work (see project_pack_fwd.cu). The port ran autograd
// through torch ops: ~620 kernel launches a train step. This kernel
// transcribes ops/project_pack.py::project_pack_bwd_plain, the chain rule
// in closed form with autograd's conventions at ties (a clamp passes the
// gradient at its bounds, `where` and det_safe branch as taken, the colour
// clamp passes where x >= 0).
//
// Computes, from dtable [C*N, 16] (columns 0-9: the compositor's gradient
// of mx, my, 0.5 a, b, 0.5 c, opacity, r, g, b, depth), the gradients of
// the means, quaternions, post-activation scales and opacities, of the SH
// coefficients or the colours, and, when asked
// (pose optimisation), of the viewmats. The means2d tap's gradient is
// dtable[:, 0:2] itself and needs no kernel.
//
// Bound on this card: bytes. Per slot it reads the gaussian (44 B), the
// active SH coefficients (12-192 B) and a 48-byte dtable row a camera, and
// writes the gradients of the mean, quaternion, scales and opacity (44 B)
// and of all 48 SH coefficients (192 B): at 1M slots and one camera,
// 0.34-0.52 GB, 0.10-0.16 ms at 3.35 TB/s. The work is ~700 FP32 operations
// a slot and camera, 0.01 ms at 67 TFLOP/s.
// Design: one thread per gaussian, 128 to a block, looping over the cameras
// in shared memory. It recomputes the forward's intermediates in registers
// (built with -fmad=false, as K4, so they are K4's) and sums each gradient
// over the cameras in registers, so it needs no atomics and its results do
// not depend on scheduling. The SH coefficients' gradients, 48 floats a
// gaussian, collect in the thread's own row of shared memory, camera by
// camera, and leave at the end as coalesced stores of the warp's
// contiguous rows: written straight from each thread, 48 strided stores
// beside the loads of the coefficients held the first version at 12% of
// its bound. Reads go through the read-only path (__ldg). The viewmats'
// gradient, when asked for, is a sum over all gaussians: a block
// reduction, then one atomic add per block, camera and entry; a branch
// uniform over the launch, so without it the kernel pays nothing for it.
#include "project_pack_common.cuh"

namespace {

using namespace pp;

struct BwdArgs {
  const float* means;
  const float* quats;
  const float* scales;
  const float* opacities;
  const float* colors;
  const float* sh_mask;
  const float* viewmats;
  const float* Ks;
  const float* dtable;
  float* dmeans;
  float* dquats;
  float* dscales;
  float* dopacities;
  float* dcolors;
  float* dviewmats;
  int n, c, width, height, antialiased, bases, coefs, color_stride;
  float near, eps2d;
};

// The gradient of (tx, ty, tz) from the Jacobian's gradient dJ and the
// projected mean's (gx, gy): project_pack.py::_camera_backward.
template <int CAM>
__device__ __forceinline__ void camera_backward(const float* cam, float tx, float ty, float tz,
                                                int width, int height, float near, float gx,
                                                float gy, const float* dJ, float& dtx, float& dty,
                                                float& dtz) {
  const float fx = cam[12], fy = cam[13];
  if (CAM == PINHOLE) {
    const bool in_front = tz > near;
    const float inv_z = 1.f / (in_front ? tz : 1.f);
    const float lim_x = 1.3f * ((1.f / fx) * (0.5f * (float)width));
    const float lim_y = 1.3f * ((1.f / fy) * (0.5f * (float)height));
    const float u = tx * inv_z, v = ty * inv_z;
    const float txz = clamp2(u, -lim_x, lim_x), tyz = clamp2(v, -lim_y, lim_y);
    const float du = (u >= -lim_x && u <= lim_x) ? dJ[2] * (-fx) * inv_z : 0.f;
    const float dv = (v >= -lim_y && v <= lim_y) ? dJ[5] * (-fy) * inv_z : 0.f;
    const float d_inv = dJ[0] * fx + dJ[2] * (-fx * txz) + dJ[4] * fy + dJ[5] * (-fy * tyz) +
                        gx * fx * tx + gy * fy * ty + du * tx + dv * ty;
    dtx = gx * fx * inv_z + du * inv_z;
    dty = gy * fy * inv_z + dv * inv_z;
    dtz = in_front ? -d_inv * inv_z * inv_z : 0.f;
  } else if (CAM == ORTHO) {
    dtx = gx * fx;
    dty = gy * fy;
    dtz = 0.f;
  } else {
    const float r2 = tx * tx + ty * ty;
    const float r = sqrtf(clamp_min(r2, 1e-12f));
    const float theta = atan2f(r, tz);
    const float s = theta / r;
    const float l2 = r2 + tz * tz;
    const float den = l2 * r;
    const float dth_dz = -r / l2;
    const float px = tz * tx / den - s * tx / r, py = tz * ty / den - s * ty / r;
    const float ds_dx = px / r, ds_dy = py / r, ds_dz = dth_dz / r;
    float g_s = gx * fx * tx + gy * fy * ty + dJ[0] * fx + dJ[4] * fy;
    dtx = gx * fx * s + fx * (dJ[0] * ds_dx + dJ[1] * ds_dy + dJ[2] * ds_dz);
    dty = gy * fy * s + fy * (dJ[3] * ds_dx + dJ[4] * ds_dy + dJ[5] * ds_dz);
    const float g_dsdx = dJ[0] * fx * tx + dJ[3] * fy * ty;
    const float g_dsdy = dJ[1] * fx * tx + dJ[4] * fy * ty;
    const float g_dsdz = dJ[2] * fx * tx + dJ[5] * fy * ty;
    const float g_px = g_dsdx / r, g_py = g_dsdy / r, g_thz = g_dsdz / r;
    float g_r = -(g_dsdx * ds_dx + g_dsdy * ds_dy + g_dsdz * ds_dz) / r;
    const float gp = g_px * tx + g_py * ty;
    g_s -= gp / r;
    dtx -= g_px * s / r;
    dty -= g_py * s / r;
    g_r += gp * s / (r * r);
    g_r -= g_thz / l2;
    float g_l2 = g_thz * r / (l2 * l2);
    dtz = gp / den;
    dtx += g_px * tz / den;
    dty += g_py * tz / den;
    const float g_den = -gp * tz / (den * den);
    g_l2 += g_den * r;
    g_r += g_den * l2;
    float g_r2 = g_l2;
    dtz += 2.f * tz * g_l2;
    const float g_th = g_s / r;
    g_r -= g_s * theta / (r * r);
    const float rec = 1.f / (r * r + tz * tz);
    g_r += g_th * tz * rec;
    dtz -= g_th * r * rec;
    if (r2 >= 1e-12f) g_r2 += g_r / (2.f * r);
    dtx += 2.f * tx * g_r2;
    dty += 2.f * ty * g_r2;
  }
}

constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;

// Floats a thread stages of its SH gradients: 3 per coefficient, odd so
// that the lanes' rows fall in distinct banks.
__host__ __device__ __forceinline__ int stage_stride(int coefs) { return (3 * coefs) | 1; }

// Sum of v over the block into red[BWD_WARPS * 12 ...]; all threads call it.
__device__ __forceinline__ void block_sum12(float* v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < 12; ++e)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[e] += __shfl_down_sync(0xffffffffu, v[e], off);
  if (lane == 0)
#pragma unroll
    for (int e = 0; e < 12; ++e) red[warp * 12 + e] = v[e];
  __syncthreads();
  if (threadIdx.x < 12) {
    float acc = 0.f;
    for (int w = 0; w < BWD_WARPS; ++w) acc += red[w * 12 + threadIdx.x];
    red[BWD_WARPS * 12 + threadIdx.x] = acc;
  }
  __syncthreads();
}

template <int CAM>
__global__ void __launch_bounds__(BWD_THREADS)
project_pack_bwd_kernel(const BwdArgs p) {
  const bool pose = p.dviewmats != nullptr;
  extern __shared__ float smem[];
  const int coefs = p.coefs;
  const int stride = stage_stride(coefs);
  float* cams = smem;
  float* mask = cams + CAM_FLOATS * p.c;  // [MAX_BASES]
  float* red = mask + MAX_BASES;          // pose: [BWD_WARPS + 1][12]
  float* stage = red + (pose ? (BWD_WARPS + 1) * 12 : 0);  // SH: [BWD_THREADS][stride]
  load_cameras(p.viewmats, p.Ks, p.c, cams);
  if (threadIdx.x < MAX_BASES)
    mask[threadIdx.x] = threadIdx.x >= p.bases ? 0.f
                        : p.sh_mask == nullptr ? 1.f : __ldg(p.sh_mask + threadIdx.x);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n0 < p.n;
  if (!pose && !active && coefs == 0) return;
  const int n = active ? n0 : 0;
  float* mine = stage + threadIdx.x * stride;

  const float m[3] = {__ldg(p.means + 3 * n), __ldg(p.means + 3 * n + 1), __ldg(p.means + 3 * n + 2)};
  float q4[4], s3[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) q4[k] = __ldg(p.quats + 4 * n + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) s3[k] = __ldg(p.scales + 3 * n + k);
  const float o = __ldg(p.opacities + n);
  float S[6];
  {
    const Cov3 g = covariance3(q4, s3);
#pragma unroll
    for (int e = 0; e < 6; ++e) S[e] = g.S[e];
  }

  float dm[3] = {0.f, 0.f, 0.f};
  float G3[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // d Sigma3, full symmetric, packed
  float dop = 0.f;
  float dcol[3] = {0.f, 0.f, 0.f};

  for (int c = 0; c < p.c; ++c) {
    const float* cam = cams + c * CAM_FLOATS;
    const size_t row = (size_t)c * p.n + n;
    const float4* grow = reinterpret_cast<const float4*>(p.dtable + row * PACK_COLS);
    const float4 r0 = __ldg(grow), r1 = __ldg(grow + 1), r2 = __ldg(grow + 2);
    const float g_mx = r0.x, g_my = r0.y, g_ca = 0.5f * r0.z, g_cb = r0.w, g_cc = 0.5f * r1.x;
    const float g_op = r1.y, g_rgb[3] = {r1.z, r1.w, r2.x}, g_tz = r2.y;

    // The forward, again.
    float tx, ty, tz;
    to_camera(cam, m[0], m[1], m[2], tx, ty, tz);
    float Jm[6], m2x, m2y, cc[6], v00, v01, v11;
    jacobian<CAM>(cam, tx, ty, tz, p.width, p.height, p.near, Jm, m2x, m2y);
    camera_cov(cam, S, cc);
    cov2d<CAM>(Jm, cc, v00, v01, v11);
    const float a = v00 + p.eps2d, cv = v11 + p.eps2d, b = v01;
    const float det = a * cv - b * b;
    const float det_safe = det > 0.f ? det : 1.f;
    const float inv_det = 1.f / det_safe;

    // conic = (c, -b, a) / det_safe, opacity = o * compensation.
    const float d_inv = g_ca * cv - g_cb * b + g_cc * a;
    const float da = g_cc * inv_det, dc = g_ca * inv_det, db = -g_cb * inv_det;
    float d_safe = -d_inv * inv_det * inv_det;
    float d_raw = 0.f;
    if (p.antialiased) {
      const float ratio = (v00 * v11 - v01 * v01) / det_safe;
      const float comp = sqrtf(clamp_min(ratio, 0.f));
      const float d_ratio = ratio >= 0.f ? g_op * o / (2.f * comp) : 0.f;
      d_raw = d_ratio / det_safe;
      d_safe -= d_ratio * ratio / det_safe;
      dop += g_op * comp;
    } else {
      dop += g_op;
    }
    const float d_det = det > 0.f ? d_safe : 0.f;
    const float dv00 = da + d_det * cv + d_raw * v11;
    const float dv11 = dc + d_det * a + d_raw * v00;
    const float dv01 = db - 2.f * b * d_det - 2.f * v01 * d_raw;

    // V = J Sigma_c J^T: the Jacobian's gradient and Sigma_c's (D, full
    // symmetric, packed).
    float sj0[3], sj1[3], dJ[6], D[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sj0[i] = cc[sym(i, 0)] * Jm[0] + cc[sym(i, 1)] * Jm[1] + cc[sym(i, 2)] * Jm[2];
      sj1[i] = cc[sym(i, 0)] * Jm[3] + cc[sym(i, 1)] * Jm[4] + cc[sym(i, 2)] * Jm[5];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dJ[k] = 2.f * dv00 * sj0[k] + dv01 * sj1[k];
      dJ[3 + k] = dv01 * sj0[k] + 2.f * dv11 * sj1[k];
    }
    {
      const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const int i = I[e], j = J[e];
        D[e] = dv00 * Jm[i] * Jm[j] + 0.5f * dv01 * (Jm[i] * Jm[3 + j] + Jm[j] * Jm[3 + i]) +
               dv11 * Jm[3 + i] * Jm[3 + j];
      }
    }
    float dt[3];
    camera_backward<CAM>(cam, tx, ty, tz, p.width, p.height, p.near, g_mx, g_my, dJ, dt[0],
                         dt[1], dt[2]);
    dt[2] += g_tz;

    // Sigma_c = W Sigma3 W^T: G3 += W^T D W; t = W m + t0: dm += W^T dt.
    float DW[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        DW[i][j] = D[sym(i, 0)] * cam[j] + D[sym(i, 1)] * cam[3 + j] + D[sym(i, 2)] * cam[6 + j];
    {
      const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const int i = I[e], j = J[e];
        G3[e] += cam[i] * DW[0][j] + cam[3 + i] * DW[1][j] + cam[6 + i] * DW[2][j];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) dm[k] += cam[k] * dt[0] + cam[3 + k] * dt[1] + cam[6 + k] * dt[2];

    float dw[12];  // pose: this gaussian's d viewmats[c, :3, :4], row-major
    if (pose) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          dw[i * 4 + j] = 2.f * (DW[i][0] * S[sym(0, j)] + DW[i][1] * S[sym(1, j)] +
                                 DW[i][2] * S[sym(2, j)]) + dt[i] * m[j];
        dw[i * 4 + 3] = dt[i];
      }
    }

    if (coefs > 0) {
      float d[3], len, lc;
      view_dir(cam, m[0], m[1], m[2], d, len, lc);
      const float x = d[0] / lc, y = d[1] / lc, z = d[2] / lc;
      float raw[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < MAX_BASES; ++k) {
        if (k >= p.bases) break;
        const float mk = mask[k];
        if (mk == 0.f) continue;
        const float bk = sh_basis(k, x, y, z) * mk;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          raw[ch] = fmaf(bk, __ldg(p.colors + ((size_t)n * coefs + k) * 3 + ch), raw[ch]);
      }
      float g_raw[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) g_raw[ch] = raw[ch] + 0.5f >= 0.f ? g_rgb[ch] : 0.f;
      float du[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < MAX_BASES; ++k) {
        if (k >= coefs) break;
        const float mk = k < MAX_BASES ? mask[k] : 0.f;
        if (mk == 0.f) {
          if (c == 0)
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) mine[3 * k + ch] = 0.f;
          continue;
        }
        const float bk = sh_basis(k, x, y, z) * mk;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          mine[3 * k + ch] = (c == 0 ? 0.f : mine[3 * k + ch]) + bk * g_raw[ch];
        if (k == 0) continue;
        const float* ck = p.colors + ((size_t)n * coefs + k) * 3;
        float dbk = 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) dbk = fmaf(__ldg(ck + ch), g_raw[ch], dbk);
        dbk *= mk;
        float gx, gy, gz;
        sh_basis_grad(k, x, y, z, gx, gy, gz);
        du[0] += dbk * gx;
        du[1] += dbk * gy;
        du[2] += dbk * gz;
      }
      if (p.bases > 1) {
        // unit = d / max(|d|, 1e-12): the clamp passes where |d| >= 1e-12,
        // the norm's gradient is 0 at |d| = 0.
        const float d_lc = -(du[0] * d[0] + du[1] * d[1] + du[2] * d[2]) / (lc * lc);
        const float d_len = (len >= 1e-12f && len > 0.f) ? d_lc / len : 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float dd = du[i] / lc + d_len * d[i];
          dm[i] += dd;
          if (pose) {
            // dirs = m + R^T t: d R[j][i] += dd t_j, d t_j += dd R[j][i].
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              dw[j * 4 + i] += dd * cam[9 + j];
              dw[j * 4 + 3] += dd * cam[j * 3 + i];
            }
          }
        }
      }
    } else if (p.color_stride == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) dcol[ch] += g_rgb[ch];
    } else if (active) {
      float* out = p.dcolors + (size_t)c * p.color_stride + 3 * (size_t)n;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out[ch] = g_rgb[ch];
    }

    if (pose) {
      if (!active)
#pragma unroll
        for (int e = 0; e < 12; ++e) dw[e] = 0.f;
      block_sum12(dw, red);
      if (threadIdx.x < 12) {
        const int i = threadIdx.x / 4, j = threadIdx.x % 4;
        atomicAdd(p.dviewmats + c * 16 + i * 4 + j, red[BWD_WARPS * 12 + threadIdx.x]);
      }
      __syncthreads();
    }
  }

  if (coefs > 0) {
    // The warp's SH gradients leave coalesced: its gaussians' rows are
    // contiguous in the coefficients' gradient.
    __syncwarp();
    const int base = blockIdx.x * blockDim.x + warp * 32;
    const int count = min(32, p.n - base);
    const float* ws = stage + warp * 32 * stride;
    const int per = 3 * coefs;
    for (int i = lane; i < count * per; i += 32) {
      const int nl = i / per;
      p.dcolors[(size_t)base * per + i] = ws[nl * stride + (i - nl * per)];
    }
  }
  if (!active) return;

  // Sigma3 = R diag(s^2) R^T: dR = 2 G3 R diag(s^2), d s_k = 2 s_k (R^T G3 R)_kk.
  const Cov3 g = covariance3(q4, s3);
  float G3R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      G3R[i][k] = G3[sym(i, 0)] * g.r[0][k] + G3[sym(i, 1)] * g.r[1][k] + G3[sym(i, 2)] * g.r[2][k];
  float dr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) dr[i][k] = 2.f * G3R[i][k] * g.s2[k];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p.dscales[3 * n + k] =
        2.f * s3[k] * (g.r[0][k] * G3R[0][k] + g.r[1][k] * G3R[1][k] + g.r[2][k] * G3R[2][k]);
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  float dq[4];
  dq[0] = 2.f * (x * (dr[2][1] - dr[1][2]) + y * (dr[0][2] - dr[2][0]) + z * (dr[1][0] - dr[0][1]));
  dq[1] = 2.f * (y * (dr[0][1] + dr[1][0]) + z * (dr[0][2] + dr[2][0]) +
                 w * (dr[2][1] - dr[1][2]) - 2.f * x * (dr[1][1] + dr[2][2]));
  dq[2] = 2.f * (x * (dr[0][1] + dr[1][0]) + w * (dr[0][2] - dr[2][0]) +
                 z * (dr[1][2] + dr[2][1]) - 2.f * y * (dr[0][0] + dr[2][2]));
  dq[3] = 2.f * (w * (dr[1][0] - dr[0][1]) + x * (dr[0][2] + dr[2][0]) +
                 y * (dr[1][2] + dr[2][1]) - 2.f * z * (dr[0][0] + dr[1][1]));
  // q / sqrt(max(|q|^2, 1e-24)): the clamp passes where |q|^2 >= 1e-24.
  const float dot = g.qsq >= 1e-24f ? dq[0] * w + dq[1] * x + dq[2] * y + dq[3] * z : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.dquats[4 * n + k] = (dq[k] - dot * g.q[k]) / g.nrm;
#pragma unroll
  for (int k = 0; k < 3; ++k) p.dmeans[3 * n + k] = dm[k];
  p.dopacities[n] = dop;
  if (coefs == 0 && p.color_stride == 0)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) p.dcolors[3 * n + ch] = dcol[ch];
}


}  // namespace

extern "C" int project_pack_bwd(const void* means, const void* quats, const void* scales,
                                const void* opacities, const void* colors, const void* sh_mask,
                                const void* viewmats, const void* Ks, const void* dtable,
                                void* dmeans, void* dquats, void* dscales, void* dopacities,
                                void* dcolors, void* dviewmats, int n, int c, int width,
                                int height, int camera, int antialiased, int bases, int coefs,
                                int color_stride, float near, float eps2d, void* stream) {
  const bool pose = dviewmats != nullptr;
  if (bases == 0) coefs = 0;
  const size_t smem =
      sizeof(float) * (CAM_FLOATS * c + MAX_BASES + (pose ? (BWD_WARPS + 1) * 12 : 0) +
                       (coefs > 0 ? BWD_THREADS * stage_stride(coefs) : 0));
  if (smem > MAX_SMEM || bases > MAX_BASES || coefs > MAX_BASES || (bases > 0 && coefs < bases) ||
      camera < 0 || camera > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && c > 0) {
    const BwdArgs p{static_cast<const float*>(means), static_cast<const float*>(quats),
                    static_cast<const float*>(scales), static_cast<const float*>(opacities),
                    static_cast<const float*>(colors), static_cast<const float*>(sh_mask),
                    static_cast<const float*>(viewmats),
                    static_cast<const float*>(Ks), static_cast<const float*>(dtable),
                    static_cast<float*>(dmeans), static_cast<float*>(dquats),
                    static_cast<float*>(dscales), static_cast<float*>(dopacities),
                    static_cast<float*>(dcolors), static_cast<float*>(dviewmats), n, c, width,
                    height, antialiased, bases, coefs, color_stride, near, eps2d};
    const int blocks = (n + BWD_THREADS - 1) / BWD_THREADS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (camera == PINHOLE) project_pack_bwd_kernel<PINHOLE><<<blocks, BWD_THREADS, smem, s>>>(p);
    else if (camera == ORTHO) project_pack_bwd_kernel<ORTHO><<<blocks, BWD_THREADS, smem, s>>>(p);
    else project_pack_bwd_kernel<FISHEYE><<<blocks, BWD_THREADS, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
