// Projection, SH colours and the table pack, forward (K4), hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fused this per-gaussian work into
// the step's program (gs_init_tpu/ops/render.py::rasterize through
// projection.project_gaussians, sh.sh_to_color and tiles.pack_table). The
// port ran it as torch ops: ~440 kernel launches a render, each a pass over
// the gaussians. This kernel computes the same in one pass.
//
// Computes, for each gaussian n and camera c (ops/project_pack.py):
// - the camera point, the camera model's Jacobian (pinhole, ortho, fisheye:
//   the template argument) and projected mean, the 2D covariance with
//   eps2d, the conic from det_safe and, antialiased, the compensation;
// - the SH colour max(sum_k basis_k mask_k coef_k + 0.5, 0) along the
//   direction from the camera centre -R^T t, or the given colours;
// - the table row [c*N + n] of pack_table: mx, my, 0.5 a, b, 0.5 c (the
//   conic, diagonal pre-halved), opacity, r, g, b, depth, six zeros;
// - radii [c, n] and extents [c, n, 2]: the compositor's support, 0 where
//   culled (near and far planes, det <= 0, radius_clip, off screen, opacity
//   under 1/255, a dead slot).
// The library builds with -fmad=false and rounds as the plain ops do, in
// their order (project_pack_common.cuh), so binning sees the plain path's
// radii and extents.
//
// Bound on this card: bytes. Per slot it reads the mean, quaternion,
// scales, opacity and alive flag (45 B) and the SH coefficients the degree
// schedule leaves active (12 B at degree 0, 192 B at degree 3), and writes
// a 64-byte row, a radius and two extents (76 B) a camera: at 1M slots and
// one camera, 0.13-0.27 GB, 0.04-0.08 ms at 3.35 TB/s. The work is ~400
// FP32 operations a slot and camera, 0.006 ms at 67 TFLOP/s.
// Design: one thread per gaussian, looping over the cameras, which sit in
// shared memory (16 floats each). The gaussian's 3D covariance is computed
// once; every intermediate stays in registers; a coefficient whose mask
// entry is 0 is not read. The row goes out as four 16-byte stores.
#include "project_pack_common.cuh"

namespace {

using namespace pp;

struct FwdArgs {
  const float* means;
  const float* quats;
  const float* scales;
  const float* opacities;
  const float* colors;   // SH [N, coefs, 3] or colours [N, 3] / [C, N, 3]
  const float* sh_mask;  // [bases] or null
  const bool* alive;     // [N] or null
  const float* viewmats;
  const float* Ks;
  float* table;
  int* radii;
  int* extents;
  int n, c, width, height, antialiased, bases, coefs, color_stride;
  float near, far, eps2d, radius_clip;
};

template <int CAM>
__global__ void __launch_bounds__(THREADS)
project_pack_fwd_kernel(const FwdArgs p) {
  extern __shared__ float cams[];
  load_cameras(p.viewmats, p.Ks, p.c, cams);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.n) return;

  const float mx = p.means[3 * n], my = p.means[3 * n + 1], mz = p.means[3 * n + 2];
  float q4[4], s3[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) q4[k] = p.quats[4 * n + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) s3[k] = p.scales[3 * n + k];
  const float o = p.opacities[n];
  const bool alive = p.alive == nullptr || p.alive[n];
  const Cov3 g = covariance3(q4, s3);

  for (int c = 0; c < p.c; ++c) {
    const float* cam = cams + c * CAM_FLOATS;
    float tx, ty, tz;
    to_camera(cam, mx, my, mz, tx, ty, tz);
    float Jm[6], m2x, m2y, cc[6], v00, v01, v11;
    jacobian<CAM>(cam, tx, ty, tz, p.width, p.height, p.near, Jm, m2x, m2y);
    camera_cov(cam, g.S, cc);
    cov2d<CAM>(Jm, cc, v00, v01, v11);
    const float a = v00 + p.eps2d, cv = v11 + p.eps2d, b = v01;
    const float det = a * cv - b * b;
    const float det_safe = det > 0.f ? det : 1.f;
    float comp = 1.f;
    if (p.antialiased) comp = sqrtf(clamp_min((v00 * v11 - v01 * v01) / det_safe, 0.f));
    const float opac = o * comp;
    const float inv_det = 1.f / det_safe;

    // The compositor's support (projection.py, under no_grad).
    const float mid = 0.5f * (a + cv);
    const float lam1 = mid + sqrtf(clamp_min(mid * mid - det, 0.01f));
    const float nsig = clamp_max(
        sqrtf(2.f * logf(clamp_min(opac * 255.f, (float)(1.0 + 1e-6)))), 3.f);
    const float radius_f = ceilf(nsig * sqrtf(lam1));
    const float ext_x = ceilf(nsig * sqrtf(clamp_min(a, 0.f)));
    const float ext_y = ceilf(nsig * sqrtf(clamp_min(cv, 0.f)));
    const bool valid = tz > p.near && tz < p.far && det > 0.f && radius_f > p.radius_clip &&
                       m2x + ext_x > 0.f && m2x - ext_x < (float)p.width &&
                       m2y + ext_y > 0.f && m2y - ext_y < (float)p.height &&
                       opac > (float)(1.0 / 255.0) && alive;

    float rgb[3];
    if (p.bases > 0) {
      float d[3], len, lc;
      view_dir(cam, mx, my, mz, d, len, lc);
      const float x = d[0] / lc, y = d[1] / lc, z = d[2] / lc;
      rgb[0] = rgb[1] = rgb[2] = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_BASES; ++k) {
        if (k >= p.bases) break;
        const float m = p.sh_mask == nullptr ? 1.f : p.sh_mask[k];
        if (m == 0.f) continue;
        const float bk = sh_basis(k, x, y, z) * m;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          rgb[ch] = fmaf(bk, __ldg(p.colors + ((size_t)n * p.coefs + k) * 3 + ch), rgb[ch]);
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rgb[ch] = clamp_min(rgb[ch] + 0.5f, 0.f);
    } else {
      const float* col = p.colors + (size_t)c * p.color_stride + 3 * (size_t)n;
      rgb[0] = col[0]; rgb[1] = col[1]; rgb[2] = col[2];
    }

    const size_t row = (size_t)c * p.n + n;
    float4* out = reinterpret_cast<float4*>(p.table + row * PACK_COLS);
    out[0] = make_float4(m2x, m2y, cv * inv_det * 0.5f, -b * inv_det);
    out[1] = make_float4(a * inv_det * 0.5f, opac, rgb[0], rgb[1]);
    out[2] = make_float4(rgb[2], tz, 0.f, 0.f);
    out[3] = make_float4(0.f, 0.f, 0.f, 0.f);
    p.radii[row] = valid ? (int)radius_f : 0;
    reinterpret_cast<int2*>(p.extents)[row] =
        make_int2(valid ? (int)ext_x : 0, valid ? (int)ext_y : 0);
  }
}

}  // namespace

extern "C" int project_pack_fwd(const void* means, const void* quats, const void* scales,
                                const void* opacities, const void* colors, const void* sh_mask,
                                const void* alive, const void* viewmats, const void* Ks,
                                void* table, void* radii, void* extents, int n, int c, int width,
                                int height, int camera, int antialiased, int bases, int coefs,
                                int color_stride, float near, float far, float eps2d,
                                float radius_clip, void* stream) {
  const size_t smem = sizeof(float) * CAM_FLOATS * c;
  if (smem > MAX_SMEM || bases > MAX_BASES || (bases > 0 && coefs < bases) || camera < 0 ||
      camera > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && c > 0) {
    const FwdArgs p{static_cast<const float*>(means), static_cast<const float*>(quats),
                    static_cast<const float*>(scales), static_cast<const float*>(opacities),
                    static_cast<const float*>(colors), static_cast<const float*>(sh_mask),
                    static_cast<const bool*>(alive),
                    static_cast<const float*>(viewmats), static_cast<const float*>(Ks),
                    static_cast<float*>(table), static_cast<int*>(radii),
                    static_cast<int*>(extents), n, c, width, height, antialiased, bases, coefs,
                    color_stride, near, far, eps2d, radius_clip};
    const int blocks = (n + THREADS - 1) / THREADS;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (camera == PINHOLE) project_pack_fwd_kernel<PINHOLE><<<blocks, THREADS, smem, s>>>(p);
    else if (camera == ORTHO) project_pack_fwd_kernel<ORTHO><<<blocks, THREADS, smem, s>>>(p);
    else project_pack_fwd_kernel<FISHEYE><<<blocks, THREADS, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
