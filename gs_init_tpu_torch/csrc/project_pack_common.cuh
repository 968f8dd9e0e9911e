// Shared pieces of the projection-and-pack kernels (project_pack_fwd.cu,
// project_pack_bwd.cu): the cameras in shared memory, a gaussian's 3D
// covariance, a camera's Jacobian and projected mean, the 2D covariance and
// the SH bases, written to match gs_init_tpu_torch/ops/projection.py,
// ops/sh.py and ops/project_pack.py::pack_table operation for operation. Where
// torch's ops round each product and each sum on its own (K4 builds with
// -fmad=false), so do these, in the same order: the radii and extents that
// the binning reads then come out as the plain path's.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pp {

constexpr int THREADS = 256;
constexpr int PACK_COLS = 16;
constexpr int MAX_BASES = 16;
// A camera in shared memory: R row-major (9), t (3), fx, fy, cx, cy.
constexpr int CAM_FLOATS = 16;
constexpr int PINHOLE = 0, ORTHO = 1, FISHEYE = 2;
// Shared memory a launch may take without opting in: 768 cameras.
constexpr int MAX_SMEM = 48 * 1024;

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
// sh.py's _C2 and _C3 (scalars: device code may not index a constexpr array).
constexpr float C20 = 1.0925484305920792f, C21 = -1.0925484305920792f,
                C22 = 0.31539156525252005f, C23 = -1.0925484305920792f,
                C24 = 0.5462742152960396f;
constexpr float C30 = -0.5900435899266435f, C31 = 2.890611442640554f,
                C32 = -0.4570457994644658f, C33 = 0.3731763325901154f,
                C34 = -0.4570457994644658f, C35 = 1.445305721320277f,
                C36 = -0.5900435899266435f;

// torch.clamp's semantics: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The C cameras of a launch, from viewmats [C, 4, 4] and Ks [C, 3, 3].
__device__ __forceinline__ void load_cameras(const float* __restrict__ viewmats,
                                             const float* __restrict__ Ks, int C,
                                             float* cams) {
  for (int i = threadIdx.x; i < C * CAM_FLOATS; i += blockDim.x) {
    const int c = i / CAM_FLOATS, k = i % CAM_FLOATS;
    const float* v = viewmats + c * 16;
    const float* K = Ks + c * 9;
    float x;
    if (k < 9) x = v[(k / 3) * 4 + k % 3];
    else if (k < 12) x = v[(k - 9) * 4 + 3];
    else x = K[k == 12 ? 0 : k == 13 ? 4 : k == 14 ? 2 : 5];
    cams[i] = x;
  }
}

// Sigma3 = R diag(s^2) R^T, packed (00, 01, 02, 11, 12, 22), and what the
// backward needs of its making: projection.py::_rot_components and
// covariance_3d_packed.
struct Cov3 {
  float qsq, nrm;       // sum of squares; sqrt(max(qsq, 1e-24))
  float q[4];           // normalised w, x, y, z
  float r[3][3];
  float s2[3];
  float S[6];
};

__device__ __forceinline__ int sym(int i, int j) {
  // index of (min, max) in (00, 01, 02, 11, 12, 22)
  const int a = i < j ? i : j, b = i < j ? j : i;
  return a == 0 ? b : (a == 1 ? 2 + b : 5);
}

__device__ __forceinline__ Cov3 covariance3(const float* q4, const float* s) {
  Cov3 g;
  // torch.sum over a last dim of 4 on the card: two lanes take the even
  // and the odd terms, then meet (equal on every one of 10^6 rows).
  g.qsq = (q4[0] * q4[0] + q4[2] * q4[2]) + (q4[1] * q4[1] + q4[3] * q4[3]);
  g.nrm = sqrtf(clamp_min(g.qsq, 1e-24f));
  for (int k = 0; k < 4; ++k) g.q[k] = q4[k] / g.nrm;
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  g.r[0][0] = 1.f - 2.f * (y * y + z * z);
  g.r[0][1] = 2.f * (x * y - w * z);
  g.r[0][2] = 2.f * (x * z + w * y);
  g.r[1][0] = 2.f * (x * y + w * z);
  g.r[1][1] = 1.f - 2.f * (x * x + z * z);
  g.r[1][2] = 2.f * (y * z - w * x);
  g.r[2][0] = 2.f * (x * z - w * y);
  g.r[2][1] = 2.f * (y * z + w * x);
  g.r[2][2] = 1.f - 2.f * (x * x + y * y);
  for (int k = 0; k < 3; ++k) g.s2[k] = s[k] * s[k];
  const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int i = I[e], j = J[e];
    float acc = g.r[i][0] * g.r[j][0] * g.s2[0];
    acc = acc + g.r[i][1] * g.r[j][1] * g.s2[1];
    g.S[e] = acc + g.r[i][2] * g.r[j][2] * g.s2[2];
  }
  return g;
}

// World point -> camera point t = R m + t0, summed as project_gaussians does.
__device__ __forceinline__ void to_camera(const float* cam, float mx, float my, float mz,
                                          float& tx, float& ty, float& tz) {
  tx = cam[0] * mx + cam[1] * my + cam[2] * mz + cam[9];
  ty = cam[3] * mx + cam[4] * my + cam[5] * mz + cam[10];
  tz = cam[6] * mx + cam[7] * my + cam[8] * mz + cam[11];
}

// Sigma_c = W Sigma3 W^T, packed as Sigma3.
__device__ __forceinline__ void camera_cov(const float* cam, const float* S, float* cc) {
  float ws[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ws[a][k] = cam[a * 3 + 0] * S[sym(0, k)] + cam[a * 3 + 1] * S[sym(1, k)] +
                 cam[a * 3 + 2] * S[sym(2, k)];
  const int I[6] = {0, 0, 0, 1, 1, 2}, J[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int a = I[e], b = J[e];
    cc[e] = ws[a][0] * cam[b * 3 + 0] + ws[a][1] * cam[b * 3 + 1] + ws[a][2] * cam[b * 3 + 2];
  }
}

// The camera model's Jacobian J (row-major 2x3) and projected mean.
// Pinhole: a gaussian on or behind the near plane runs at depth 1 (it is
// culled), and the lateral ratio is clamped at 1.3 tan(fov / 2).
template <int CAM>
__device__ __forceinline__ void jacobian(const float* cam, float tx, float ty, float tz,
                                         int width, int height, float near, float* Jm,
                                         float& m2x, float& m2y) {
  const float fx = cam[12], fy = cam[13], cx = cam[14], cy = cam[15];
  if (CAM == PINHOLE) {
    const float inv_z = 1.f / (tz > near ? tz : 1.f);
    // 0.5 * width / fx is torch's reciprocal(fx) * (0.5 * width).
    const float lim_x = 1.3f * ((1.f / fx) * (0.5f * (float)width));
    const float lim_y = 1.3f * ((1.f / fy) * (0.5f * (float)height));
    const float txz = clamp2(tx * inv_z, -lim_x, lim_x);
    const float tyz = clamp2(ty * inv_z, -lim_y, lim_y);
    Jm[0] = fx * inv_z; Jm[1] = 0.f; Jm[2] = -fx * txz * inv_z;
    Jm[3] = 0.f; Jm[4] = fy * inv_z; Jm[5] = -fy * tyz * inv_z;
    m2x = fx * tx * inv_z + cx;
    m2y = fy * ty * inv_z + cy;
  } else if (CAM == ORTHO) {
    Jm[0] = fx; Jm[1] = 0.f; Jm[2] = 0.f;
    Jm[3] = 0.f; Jm[4] = fy; Jm[5] = 0.f;
    m2x = fx * tx + cx;
    m2y = fy * ty + cy;
  } else {
    const float r2 = tx * tx + ty * ty;
    const float r = sqrtf(clamp_min(r2, 1e-12f));
    const float theta = atan2f(r, tz);
    const float s = theta / r;
    m2x = fx * tx * s + cx;
    m2y = fy * ty * s + cy;
    const float l2 = r2 + tz * tz;
    const float dth_dx = tz * tx / (l2 * r);
    const float dth_dy = tz * ty / (l2 * r);
    const float dth_dz = -r / l2;
    const float ds_dx = (dth_dx - s * tx / r) / r;
    const float ds_dy = (dth_dy - s * ty / r) / r;
    const float ds_dz = dth_dz / r;
    Jm[0] = fx * (s + tx * ds_dx); Jm[1] = fx * tx * ds_dy; Jm[2] = fx * tx * ds_dz;
    Jm[3] = fy * ty * ds_dx; Jm[4] = fy * (s + ty * ds_dy); Jm[5] = fy * ty * ds_dz;
  }
}

// V = J Sigma_c J^T as projection.py sums it (jc = J Sigma_c, then v =
// jc J^T); for pinhole and ortho the products with J's structural zeros
// are left out, which changes no finite sum.
template <int CAM>
__device__ __forceinline__ void cov2d(const float* Jm, const float* cc, float& v00, float& v01,
                                      float& v11) {
  if (CAM == FISHEYE) {
    float jc[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        jc[a][k] = Jm[a * 3 + 0] * cc[sym(0, k)] + Jm[a * 3 + 1] * cc[sym(1, k)] +
                   Jm[a * 3 + 2] * cc[sym(2, k)];
    v00 = jc[0][0] * Jm[0] + jc[0][1] * Jm[1] + jc[0][2] * Jm[2];
    v01 = jc[0][0] * Jm[3] + jc[0][1] * Jm[4] + jc[0][2] * Jm[5];
    v11 = jc[1][0] * Jm[3] + jc[1][1] * Jm[4] + jc[1][2] * Jm[5];
  } else if (CAM == PINHOLE) {
    const float jc00 = Jm[0] * cc[0] + Jm[2] * cc[2];
    const float jc01 = Jm[0] * cc[1] + Jm[2] * cc[4];
    const float jc02 = Jm[0] * cc[2] + Jm[2] * cc[5];
    const float jc11 = Jm[4] * cc[3] + Jm[5] * cc[4];
    const float jc12 = Jm[4] * cc[4] + Jm[5] * cc[5];
    v00 = jc00 * Jm[0] + jc02 * Jm[2];
    v01 = jc01 * Jm[4] + jc02 * Jm[5];
    v11 = jc11 * Jm[4] + jc12 * Jm[5];
  } else {
    v00 = Jm[0] * cc[0] * Jm[0];
    v01 = Jm[0] * cc[1] * Jm[4];
    v11 = Jm[4] * cc[3] * Jm[4];
  }
}

// SH basis k at the unit direction (x, y, z) (sh.py::eval_sh_bases), and
// its partial derivatives.
__device__ __forceinline__ float sh_basis(int k, float x, float y, float z) {
  const float xx = x * x, yy = y * y, zz = z * z;
  switch (k) {
    case 0: return C0;
    case 1: return -C1 * y;
    case 2: return C1 * z;
    case 3: return -C1 * x;
    case 4: return C20 * (x * y);
    case 5: return C21 * (y * z);
    case 6: return C22 * (2.f * zz - xx - yy);
    case 7: return C23 * (x * z);
    case 8: return C24 * (xx - yy);
    case 9: return C30 * y * (3.f * xx - yy);
    case 10: return C31 * (x * y) * z;
    case 11: return C32 * y * (4.f * zz - xx - yy);
    case 12: return C33 * z * (2.f * zz - 3.f * xx - 3.f * yy);
    case 13: return C34 * x * (4.f * zz - xx - yy);
    case 14: return C35 * z * (xx - yy);
    default: return C36 * x * (xx - 3.f * yy);
  }
}

__device__ __forceinline__ void sh_basis_grad(int k, float x, float y, float z, float& gx,
                                              float& gy, float& gz) {
  const float xx = x * x, yy = y * y, zz = z * z;
  gx = gy = gz = 0.f;
  switch (k) {
    case 1: gy = -C1; break;
    case 2: gz = C1; break;
    case 3: gx = -C1; break;
    case 4: gx = C20 * y; gy = C20 * x; break;
    case 5: gy = C21 * z; gz = C21 * y; break;
    case 6: gx = -2.f * C22 * x; gy = -2.f * C22 * y; gz = 4.f * C22 * z; break;
    case 7: gx = C23 * z; gz = C23 * x; break;
    case 8: gx = 2.f * C24 * x; gy = -2.f * C24 * y; break;
    case 9: gx = 6.f * C30 * x * y; gy = 3.f * C30 * (xx - yy); break;
    case 10: gx = C31 * y * z; gy = C31 * x * z; gz = C31 * x * y; break;
    case 11:
      gx = -2.f * C32 * x * y; gy = C32 * (4.f * zz - xx - 3.f * yy); gz = 8.f * C32 * y * z;
      break;
    case 12:
      gx = -6.f * C33 * x * z; gy = -6.f * C33 * y * z; gz = 3.f * C33 * (2.f * zz - xx - yy);
      break;
    case 13:
      gx = C34 * (4.f * zz - 3.f * xx - yy); gy = -2.f * C34 * x * y; gz = 8.f * C34 * x * z;
      break;
    case 14: gx = 2.f * C35 * x * z; gy = -2.f * C35 * y * z; gz = C35 * (xx - yy); break;
    case 15: gx = 3.f * C36 * (xx - yy); gy = -6.f * C36 * x * y; break;
    default: break;
  }
}

// The unit direction from the camera centre -R^T t to the mean, and the
// unclamped length (sh.py::sh_to_color normalises with a 1e-12 floor).
__device__ __forceinline__ void view_dir(const float* cam, float mx, float my, float mz,
                                         float* d, float& len, float& lc) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = (i == 0 ? mx : i == 1 ? my : mz) +
           (cam[i] * cam[9] + cam[3 + i] * cam[10] + cam[6 + i] * cam[11]);
  len = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  lc = clamp_min(len, 1e-12f);
}

}  // namespace pp

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
