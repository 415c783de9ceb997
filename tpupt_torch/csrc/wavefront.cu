// The wavefront iteration of render/integrator.py (StreamStages.step) as two kernels around
// the hit kernels: regeneration (regen_kernel), then K1 (and K2, K3 or K4 where the scene has
// triangles), then shading (shade_kernel).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the jitted iteration (the reference's
// _chunk_film, tpupt/render/integrator.py:306-322) into a few fusions by itself. The port's
// plain route (_stream_step: generate_rays, bounce_step, ops/bsdf.py, ops/lights.py,
// ops/texture.py, ops/envmap.py, the hit reconstruction of ops/intersect.py) launches about
// 3,400 small PyTorch kernels an iteration, each a few microseconds whatever its lanes, which
// set the iteration's time. Here each lane's iteration is two threads' work.
//
// Contract. The same state, at the same addresses, after an iteration as the plain route's,
// bit for bit: every operation of the plain route is done here in the same order, in float32,
// with the device functions PyTorch's CUDA kernels call (sqrtf, cosf, sinf, acosf, atan2f,
// log2f, powf, floorf; IEEE division), built with --fmad=false so that no multiply and add
// fuse, as no single PyTorch kernel of the route fuses them. Where PyTorch rewrites an
// operation, so does this file:
//   x / c, c a Python number   ->  x * (1.0f / c)   (PyTorch's CUDA division by a host scalar)
//   c / x                      ->  (1.0f / x) * c   (Tensor.__rtruediv__ is reciprocal() * c)
//   torch.maximum / minimum / clamp propagate NaN (tmax, tmin below); torch.sign gives 0 on
//   NaN and zeros; a float-to-int32 cast truncates (cvt.rzi), as PyTorch's does.
// Python constants are doubles rounded to float32 once (F()), as PyTorch rounds a scalar.
// Lanes whose results the plain route masks away (dead lanes, lanes that missed) skip the
// work whose results are dropped; every value that reaches the state is computed as there.
//
// Regeneration (regen_kernel, one thread a lane). _stream_step's head: lanes without a path
// and with samples left take the next sample (generate_rays: pcg4d draws, the blur disk, the
// lens disk), their throughput, radiance and bounce reset; the live lanes after it are
// counted into `rays` (a block's count by __syncthreads_count, then one 64-bit atomicAdd a
// block: integers, so the sum does not depend on the order).
//   Bound: bytes. Every lane reads 9 B (alive, sample, sample0); a regenerated one reads 12 B
//   more (pix, row, col) and writes 65 B (o, d, time, throughput, radiance, bounce,
//   cur_sample, sample, alive): at most 31 MB, 9 us at 3.35e12 B/s, at 360,000 lanes. Design:
//   coalesced 4-byte accesses of the structure-of-arrays state; the [B,3] fields are read as
//   three floats at a 12-byte stride, which a warp's loads share cache lines for.
//
// Shading (shade_kernel, one thread a lane). Everything bounce_step and _stream_step do after
// the hit kernels: closest_hit's selection and _make_hit (sphere with motion blur, quad,
// triangle from the kernels' attributes or gathered from the tables on the sweep routes),
// normal maps, the environment on a miss, make_shade (solid, checker and image textures,
// textured roughness), emission, the three uniform4 draws, russian roulette, bsdf_sample /
// bsdf_pdf / bsdf_eval of the five families, light sampling and the mean light pdf (the HDR
// sky, importance-sampled from its alias table, is one more member), the one-sample MIS
// mixture, the unguarded eval / pdf, the offset next origin, the max_depth exit and the film
// flush. It writes o, d, throughput, radiance, film, bounce and alive in
// place.
//   Bound: bytes, then arithmetic. Every lane reads and writes 41 B (alive, bounce,
//   throughput, radiance, film); a live one reads 48 B more (o, d, time, pix, cur_sample,
//   K1's t, kind, idx) and writes 24 B more (o, d): 55 MB, 16.5 us at 3.35e12 B/s, at 360,000
//   live lanes; and ~3.4k float operations a lane (the Principled eval the most), ~1.2 GFLOP,
//   tens of us at half the float32 peak, which --fmad=false leaves. Design: one thread a
//   lane, no shared memory; the scene's tables (materials, textures, lights: a few KB) are
//   read through the read-only cache (__ldg);
//   families diverge within a warp (sorting lanes by material is later work); the state's
//   accesses are coalesced as in regeneration; __launch_bounds__(256).

#include <cuda_runtime.h>
#include <cstdint>

namespace wf {

#define F(x) ((float)(x))

constexpr int THREADS = 256;
constexpr float BIG = F(3.0e38);  // core/linalg.py BIG
// la.f32(math.pi), and math.pi as a scalar; 2 * PI_F is also math.pi * 2 and la.f32(2 pi) rounded
constexpr float PI_F = F(3.141592653589793);
constexpr float TWO_PI_F = 2.0f * PI_F;
constexpr float INV_PI = 1.0f / PI_F;  // x / PI
constexpr float INV_TWO_PI = 1.0f / TWO_PI_F;  // x / (2.0 * PI)
constexpr float EPS = F(1e-3);  // integrator.py EPS
constexpr int MIN_BOUNCES = 5;

enum { MAT_DIFFUSE = 0, MAT_METAL = 1, MAT_GLASS = 2, MAT_PRINCIPLED = 3, MAT_LIGHT = 4 };
enum { TEX_SOLID = 0, TEX_CHECKER = 1, TEX_IMAGE = 2 };
enum { GEOM_SPHERE = 0, GEOM_QUAD = 1, GEOM_TRI = 2 };
enum { P_METALLIC = 0, P_ROUGHNESS = 1, P_SUBSURFACE = 2, P_SPECULAR = 3, P_SPECULAR_TINT = 4, P_IOR = 5,
       P_SPEC_TRANS = 6, P_SHEEN = 7, P_SHEEN_TINT = 8, P_CLEARCOAT = 9, P_CLEARCOAT_GLOSS = 10, N_PARAMS = 11 };
enum { ENV_COLOR = 0, ENV_MAP = 1, ENV_TEXTURE = 2, ENV_HDR = 3 };  // sample_environment's routes
enum { TRI_NONE = 0, TRI_AUX = 1, TRI_GATHER = 2 };  // no real triangle; kernels' attributes; the sweeps

// ---- arguments (ops/wavefront_kernel.py mirrors these layouts with ctypes.Structure) ----

struct RegenArgs {
  const int32_t *pix, *row, *col, *sample0;
  float *o, *d, *time, *T, *L;
  int32_t *bounce, *sample, *cur_sample;
  uint8_t* alive;
  // the camera (render/camera.py CameraData, the stage runner's static copy)
  const float *center, *pixel00, *pixel_du, *pixel_dv, *right, *up, *defocus_radius, *blur_strength;
  const int64_t* seed;
  unsigned long long* rays;
  int32_t n, k, spp_limit;
};

struct ShadeArgs {
  // state
  const int32_t* pix;
  const int32_t* cur_sample;
  const float* time;
  float *o, *d, *T, *L, *film;
  int32_t* bounce;
  uint8_t* alive;
  // hit kernels' outputs: K1's, then the triangle route's (t, idx; the kernels' attributes)
  const float* t_sq;
  const int32_t *kind_sq, *idx_sq;
  const float* t_tri;
  const int32_t* i_tri;
  const float *aux_ns, *aux_u, *aux_v;
  const int32_t* aux_mat;
  // scene (scene/data.py SceneData)
  const float *sph_c1, *sph_c2, *sph_r;
  const int32_t* sph_mat;
  const float *quad_q, *quad_u, *quad_v, *quad_w, *quad_n, *quad_d;
  const int32_t* quad_mat;
  const float *tri_v0, *tri_e1, *tri_e2, *tri_n0, *tri_n1, *tri_n2, *tri_uv0, *tri_uv1, *tri_uv2;
  const uint8_t* tri_has_uv;
  const int32_t* tri_mat;
  const int32_t *light_kind, *light_idx;
  const float* light_geom;
  const int32_t *mat_type, *mat_tex, *mat_rough_tex, *mat_normal_tex;
  const float* mat_params;
  const int32_t* tex_type;
  const float *tex_rgb, *tex_inv_scale;
  const int32_t *tex_child, *tex_img;
  const float* atlas;
  const float* env_color;
  const int32_t* env_tex;
  const float *env_img, *env_sam;  // the HDR map's texels; its (prob, alias, pdf) rows
  const int64_t* seed;
  int32_t n, max_depth, has_lights, n_lights, atlas_rows, tri_route;
  int32_t env_route, env_map_off, env_map_w, env_map_h, env_w, env_h, n_lights_real;
  float p_light, p_bsdf;
};

// ---- float32 arithmetic as PyTorch's kernels do it ----

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 mk(float x, float y, float z) { return f3{x, y, z}; }
__device__ __forceinline__ f3 ld3(const float* p, int i) { return f3{p[3 * i], p[3 * i + 1], p[3 * i + 2]}; }
__device__ __forceinline__
f3 ldg3(const float* p, int i) { return f3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)}; }
__device__ __forceinline__ void st3(float* p, int i, f3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__
f3 cross3(f3 a, f3 b) { return f3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x}; }
__device__ __forceinline__ f3 add3(f3 a, f3 b) { return f3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 scale3(f3 a, float s) { return f3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ f3 neg3(f3 a) { return f3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ f3 sel3(bool m, f3 a, f3 b) { return m ? a : b; }

__device__ __forceinline__
float tmax(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }  // torch.maximum
__device__ __forceinline__
float tmin(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }  // torch.minimum
__device__ __forceinline__
float clip(float x, float lo, float hi) { return tmin(tmax(x, lo), hi); }  // la.clip
__device__ __forceinline__ float tsign(float x) { return (float)((0.0f < x) - (x < 0.0f)); }  // torch.sign
__device__ __forceinline__ int to_i32(float x) { return (int)x; }  // .to(torch.int32)
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__
int wrap_add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }  // int32 arithmetic wraps
__device__ __forceinline__ int wrap_mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }

// la.normalize3(a, eps): n2 floored at max(eps, 1e-24) when eps, inv = 1 / sqrt(n2)
__device__ __forceinline__ f3 normalize3(f3 a) { return scale3(a, 1.0f / sqrtf(dot3(a, a))); }
__device__ __forceinline__
f3 normalize3_eps(f3 a) { return scale3(a, 1.0f / sqrtf(tmax(dot3(a, a), F(1e-24)))); }
// la.normalize(a, eps=1e-30), a ray's direction: a / sqrt(max(|a|^2, 1e-30))
__device__ __forceinline__ f3 normalize_dir(f3 a) {
  float n = sqrtf(tmax(dot3(a, a), F(1e-30)));
  return f3{a.x / n, a.y / n, a.z / n};
}

// la.to_local3 / to_world3: the quaternion that turns n onto +z
struct Quat {
  float x, y, w;
};

__device__ __forceinline__ Quat quat_to_z(f3 n) {
  float x = n.y, y = -n.x, w = n.z + 1.0f;
  float norm = sqrtf(tmax(x * x + y * y + w * w, F(1e-24)));
  bool degenerate = n.z < F(-0.99999);
  float safe = tmax(norm, F(1e-20));
  return Quat{degenerate ? 1.0f : x / safe, degenerate ? 0.0f : y / safe, degenerate ? 0.0f : w / safe};
}

__device__ __forceinline__ f3 quat_rotate(float qx, float qy, float qw, f3 v) {
  f3 q = mk(qx, qy, 0.0f);
  f3 t = add3(cross3(q, v), scale3(v, qw));
  return add3(v, scale3(cross3(q, t), 2.0f));
}

__device__ __forceinline__ f3 to_local(f3 n, f3 v) {
  Quat q = quat_to_z(n);
  return quat_rotate(q.x, q.y, q.w, v);
}

__device__ __forceinline__ f3 to_world(f3 n, f3 v) {
  Quat q = quat_to_z(n);
  return quat_rotate(-q.x, -q.y, q.w, v);
}

__device__ __forceinline__ f3 reflect3(f3 i, f3 n) {
  float k = 2.0f * dot3(i, n);
  return f3{i.x - k * n.x, i.y - k * n.y, i.z - k * n.z};
}

__device__ __forceinline__ f3 refract3(f3 i, f3 n, float eta) {
  float ni = dot3(n, i);
  float k = 1.0f - eta * eta * (1.0f - ni * ni);
  float coef = eta * ni + sqrtf(tmax(k, F(1e-20)));
  bool ok = k >= 0.0f;
  return f3{ok ? eta * i.x - coef * n.x : 0.0f, ok ? eta * i.y - coef * n.y : 0.0f,
            ok ? eta * i.z - coef * n.z : 0.0f};
}

// ---- core/rng.py: pcg4d over uint32 ----

__device__ __forceinline__
void uniform4(uint32_t seed, uint32_t pixel, uint32_t sample, uint32_t ctr, float u[4]) {
  uint32_t a = pixel * 1664525u + 1013904223u, b = sample * 1664525u + 1013904223u;
  uint32_t c = ctr * 1664525u + 1013904223u, d = seed * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  const float unit = 1.0f / 16777216.0f;
  u[0] = (float)(a >> 8) * unit;
  u[1] = (float)(b >> 8) * unit;
  u[2] = (float)(c >> 8) * unit;
  u[3] = (float)(d >> 8) * unit;
}

__device__ __forceinline__ int bounce_ctr(int bounce) { return 8 + bounce * 4; }  // rng.bounce_ctr
enum { SLOT_CTRL = 0, SLOT_BSDF = 1, SLOT_LIGHT = 2 };

// ---- regeneration: _stream_step's head and render/camera.py generate_rays ----

__device__ __forceinline__ void unit_disk(float u_radius, float u_angle, float& x, float& y) {
  float radius = sqrtf(u_radius);
  float angle = u_angle * TWO_PI_F;
  x = radius * cosf(angle);
  y = radius * sinf(angle);
}

__device__ __forceinline__ bool regen_lane(const RegenArgs& a, int i) {
  bool alive = a.alive[i] != 0;
  int sample = a.sample[i], s0 = a.sample0[i];
  bool need = !alive && sample < a.k && wrap_add(s0, sample) < a.spp_limit;
  if (need) {
    int new_sample = wrap_add(s0, sample);
    uint32_t seed = (uint32_t)(*a.seed), pix = (uint32_t)a.pix[i], smp = (uint32_t)new_sample;
    float c[4], t[4];
    uniform4(seed, pix, smp, 0u, c);  // CTR_CAMERA
    uniform4(seed, pix, smp, 1u, t);  // CTR_TIME
    float bx, by, px, py;
    unit_disk(c[0], c[1], bx, by);
    float blur = *a.blur_strength;
    bx = bx * blur;
    by = by * blur;
    float rows = (float)a.row[i], cols = (float)a.col[i];
    float rb = rows + bx, cb = cols + by;
    f3 p00 = ld3(a.pixel00, 0), dv = ld3(a.pixel_dv, 0), du = ld3(a.pixel_du, 0);
    f3 loc = f3{p00.x + dv.x * rb + du.x * cb, p00.y + dv.y * rb + du.y * cb, p00.z + dv.z * rb + du.z * cb};
    unit_disk(c[2], c[3], px, py);
    float rad = *a.defocus_radius;
    f3 ctr = ld3(a.center, 0), rt = ld3(a.right, 0), up = ld3(a.up, 0);
    f3 rr = scale3(rt, rad), ur = scale3(up, rad);
    f3 org = f3{ctr.x + rr.x * px + ur.x * py, ctr.y + rr.y * px + ur.y * py, ctr.z + rr.z * px + ur.z * py};
    st3(a.o, i, org);
    st3(a.d, i, normalize_dir(f3{loc.x - org.x, loc.y - org.y, loc.z - org.z}));
    a.time[i] = t[0];
    st3(a.T, i, mk(1.0f, 1.0f, 1.0f));
    st3(a.L, i, mk(0.0f, 0.0f, 0.0f));
    a.bounce[i] = 0;
    a.cur_sample[i] = new_sample;
    a.sample[i] = sample + 1;
    a.alive[i] = 1;
  }
  return alive || need;
}

// ---- ops/texture.py ----

__device__ __forceinline__ f3 image_lookup(const ShadeArgs& s, int offset, int w, int h, float u, float v) {
  float uu = clip(u, 0.0f, 1.0f);
  float vv = 1.0f - clip(v, 0.0f, 1.0f);
  int i = imin(to_i32(floorf(uu * (float)w)), w - 1);
  int j = imin(to_i32(floorf(vv * (float)h)), h - 1);
  int idx = imin(imax(wrap_add(wrap_add(offset, wrap_mul(j, w)), i), 0), s.atlas_rows - 1);
  return ldg3(s.atlas, idx);
}

__device__ __forceinline__ f3 eval_texture(const ShadeArgs& s, int tid, float u, float v, f3 p) {
  tid = imax(tid, 0);
  int rid = tid;
  if (__ldg(s.tex_type + tid) == TEX_CHECKER) {
    float inv = __ldg(s.tex_inv_scale + tid);
    int cell = wrap_add(wrap_add(to_i32(floorf(p.x * inv)), to_i32(floorf(p.y * inv))), to_i32(floorf(p.z * inv)));
    int child = cell % 2 == 0 ? __ldg(s.tex_child + 2 * tid) : __ldg(s.tex_child + 2 * tid + 1);
    rid = imax(child, 0);
  }
  if (__ldg(s.tex_type + rid) == TEX_IMAGE)
    return image_lookup(s, __ldg(s.tex_img + 3 * rid), __ldg(s.tex_img + 3 * rid + 1),
                        __ldg(s.tex_img + 3 * rid + 2), u, v);
  return ldg3(s.tex_rgb, rid);
}

// ---- ops/envmap.py ----

// _texel_from_dir: the HDR map's texel under a direction
__device__ __forceinline__ int env_texel(const ShadeArgs& s, f3 d) {
  float theta = acosf(clip(d.y, -1.0f, 1.0f));
  float phi = atan2f(d.z, d.x);
  float u = (phi + PI_F) * INV_TWO_PI;
  float vv = theta * INV_PI;
  int i = imin(imax(to_i32(floorf(u * (float)s.env_w)), 0), s.env_w - 1);
  int j = imin(imax(to_i32(floorf(vv * (float)s.env_h)), 0), s.env_h - 1);
  return wrap_add(wrap_mul(j, s.env_w), i);
}

// sample_env_light: an alias draw over the HDR map's texels, the texel's centre
__device__ __forceinline__ f3 sample_env_light(const ShadeArgs& s, float u1, float u2) {
  int n = s.env_w * s.env_h;
  int slot = imin(to_i32(u1 * (float)n), n - 1);
  float prob = __ldg(s.env_sam + 3 * slot);
  int alias = to_i32(__ldg(s.env_sam + 3 * slot + 1));
  int texel = u2 < prob ? slot : alias;
  int j = texel / s.env_w, i = texel - j * s.env_w;
  float theta = ((float)j + 0.5f) * (1.0f / (float)s.env_h) * PI_F;
  float phi = ((float)i + 0.5f) * (1.0f / (float)s.env_w) * TWO_PI_F - PI_F;
  float st = sinf(theta);
  return mk(st * cosf(phi), cosf(theta), st * sinf(phi));
}

// sample_environment: constant, the HDR map, an LDR map, a generic texture
__device__ __forceinline__ f3 environment(const ShadeArgs& s, f3 d) {
  if (s.env_route == ENV_COLOR) return ldg3(s.env_color, 0);
  if (s.env_route == ENV_HDR) return ldg3(s.env_img, env_texel(s, d));
  float theta = acosf(clip(d.y, -1.0f, 1.0f));
  float phi = atan2f(d.z, d.x);
  float u = (phi + PI_F) * INV_TWO_PI;
  float v = 1.0f - theta * INV_PI;
  if (s.env_route == ENV_MAP) {
    int w = s.env_map_w, h = s.env_map_h;
    float uu = clip(u, 0.0f, 1.0f);
    float vv = 1.0f - clip(v, 0.0f, 1.0f);
    int i = imin(to_i32(floorf(uu * (float)w)), w - 1);
    int j = imin(to_i32(floorf(vv * (float)h)), h - 1);
    return ldg3(s.atlas, wrap_add(wrap_add(s.env_map_off, wrap_mul(j, w)), i));
  }
  return eval_texture(s, __ldg(s.env_tex), u, v, d);
}

// ---- ops/sampling.py ----

__device__ __forceinline__ f3 cosine_sample_hemisphere(float u1, float u2) {
  float phi = TWO_PI_F * u1;
  float r2s = sqrtf(u2);
  return f3{r2s * cosf(phi), r2s * sinf(phi), sqrtf(1.0f - u2)};
}

__device__ __forceinline__ float ggx_D(f3 h, float roughness) {
  float cos_theta = tmax(h.z, F(0.001));
  float alpha2 = tmax(roughness * roughness, F(0.001));
  float denom = (alpha2 - 1.0f) * cos_theta * cos_theta + 1.0f;
  return alpha2 / (denom * PI_F * denom);
}

__device__ __forceinline__ float ggx_G1(f3 w, float roughness) {
  float alpha2 = tmax(roughness * roughness, F(0.001));
  float cos_theta = fabsf(w.z);
  return 2.0f * cos_theta / (cos_theta + sqrtf(cos_theta * cos_theta * (1.0f - alpha2) + alpha2));
}

__device__ __forceinline__
float ggx_G(f3 v, f3 l, float roughness) { return ggx_G1(v, roughness) * ggx_G1(l, roughness); }

__device__ __forceinline__ f3 flip_to_upper(f3 h) { return h.z < 0.0f ? neg3(h) : h; }

__device__ __forceinline__ f3 ggx_sample_microfacet_normal(f3 v, float roughness, float e1, float e2) {
  float a2 = roughness * roughness;
  f3 vs = normalize3(mk(v.x * a2, v.y * a2, v.z));
  f3 t1g = normalize3_eps(mk(vs.y, -vs.x, 0.0f));
  bool lo_z = vs.z < F(0.9999);
  f3 t1 = mk(lo_z ? t1g.x : 1.0f, lo_z ? t1g.y : 0.0f, 0.0f);
  f3 t2 = cross3(t1, vs);
  float a = 1.0f / (vs.z + 1.0f);
  float r = sqrtf(e1);
  bool lo = e2 < a;
  float phi = lo ? e2 / a * PI_F : (e2 - a) / (1.0f - a) * PI_F + PI_F;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi) * (lo ? 1.0f : vs.z);
  float pz = sqrtf(tmax(1.0f - p1 * p1 - p2 * p2, 0.0f));
  f3 n = f3{p1 * t1.x + p2 * t2.x + pz * vs.x, p1 * t1.y + p2 * t2.y + pz * vs.y, p1 * t1.z + p2 * t2.z + pz * vs.z};
  return flip_to_upper(normalize3_eps(mk(a2 * n.x, a2 * n.y, tmax(n.z, 0.0f))));
}

__device__ __forceinline__ float gtr1_D(float abs_cos_theta, float alpha_g) {
  float alpha2 = alpha_g * alpha_g;
  float t = (alpha2 - 1.0f) * abs_cos_theta * abs_cos_theta + 1.0f;
  return (alpha2 - 1.0f) / (t * PI_F * log2f(alpha2));
}

__device__ __forceinline__ f3 gtr1_sample_microfacet_normal(float alpha, float e1, float e2) {
  float alpha2 = alpha * alpha;
  float cos_theta = (1.0f - powf(alpha2, 1.0f - e1)) / (1.0f - alpha2);
  float sin_theta = sqrtf(tmax(1.0f - cos_theta * cos_theta, 0.0f));
  float phi = TWO_PI_F * e2;
  return flip_to_upper(mk(sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta));
}

__device__ __forceinline__ float fresnel_dielectric(f3 w, f3 h, float eta_i, float eta_o) {
  float c = fabsf(dot3(w, h));
  float ratio = eta_o / eta_i;
  float g_squared = ratio * ratio - 1.0f + c * c;
  float g = sqrtf(tmax(g_squared, F(1e-20)));
  float gmc = g - c, gpc = g + c;
  float den = c * gmc + 1.0f;
  den = fabsf(den) > F(1e-12) ? den : F(1e-12);
  float x = (c * gpc - 1.0f) / den;
  float f = 0.5f * (gmc * gmc) / tmax(gpc * gpc, F(1e-18)) * (x * x + 1.0f);
  return g_squared < 0.0f ? 1.0f : f;
}

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ f3 fresnel_schlick(f3 r0, float angle) {
  float w = pow5(1.0f - angle);
  return f3{r0.x + (1.0f - r0.x) * w, r0.y + (1.0f - r0.y) * w, r0.z + (1.0f - r0.z) * w};
}

__device__ __forceinline__ float schlick_weight(float x) { return pow5(clip(1.0f - x, 0.0f, 1.0f)); }

__device__ __forceinline__ float lerp(float a, float b, float t) { return a + (b - a) * t; }

// ---- ops/bsdf.py ----

struct Shade {
  int mtype;
  f3 base;
  float roughness;
  const float* params;  // the material's row of mat_params
  f3 ng, ns;
  bool front;
};

__device__ __forceinline__ float par(const Shade& sh, int k) { return __ldg(sh.params + k); }

__device__ __forceinline__ void etas(const Shade& sh, float ior, float& eta_i, float& eta_o) {
  ior = tmax(ior, F(0.01));
  eta_i = sh.front ? 1.0f : ior;
  eta_o = sh.front ? ior : 1.0f;
}

__device__ __forceinline__ f3 half_vector(f3 v, f3 l, float eta_i, float eta_o, bool reflect) {
  if (reflect) return scale3(normalize3_eps(add3(v, l)), tsign(v.z));
  return neg3(normalize3_eps(mk(l.x * eta_o + v.x * eta_i, l.y * eta_o + v.y * eta_i, l.z * eta_o + v.z * eta_i)));
}

__device__ __forceinline__ float vndf_pdf_h(f3 v, f3 h, float roughness) {
  return ggx_G1(v, roughness) * fabsf(dot3(v, h)) * ggx_D(h, roughness) / tmax(fabsf(v.z), F(1e-12));
}

// refl / refract choice of glass.rs:75-90 and principled.rs's glass lobe, in the local frame
__device__ __forceinline__ f3 dielectric_dir(f3 v, f3 h, float eta_i, float eta_o, float fresnel_u) {
  float f = fresnel_dielectric(v, h, eta_i, eta_o);
  f3 refl = reflect3(neg3(v), h);
  f3 refr = refract3(neg3(v), h, eta_i / eta_o);
  bool tir = dot3(refr, refr) == 0.0f;
  f3 trans = sel3(tir, refl, refr);
  return sel3(fresnel_u < f, refl, trans);
}

struct Lobes {
  float w_d, w_s, w_g, w_c, p_d, p_s, p_g, p_c;
};

__device__ __forceinline__ Lobes principled_lobes(const Shade& sh) {
  float metallic = par(sh, P_METALLIC), spec_trans = par(sh, P_SPEC_TRANS), clearcoat = par(sh, P_CLEARCOAT);
  Lobes o;
  o.w_d = (1.0f - metallic) * (1.0f - spec_trans);
  o.w_s = 1.0f - spec_trans * (1.0f - metallic);
  o.w_g = spec_trans * (1.0f - metallic);
  o.w_c = 0.25f * clearcoat;
  float inv_total = 1.0f / (o.w_d + o.w_s + o.w_g + o.w_c);
  o.p_d = o.w_d * inv_total;
  o.p_s = o.w_s * inv_total;
  o.p_g = o.w_g * inv_total;
  o.p_c = o.w_c * inv_total;
  return o;
}

__device__ __forceinline__ float principled_alpha_g(const Shade& sh) {
  float cg = par(sh, P_CLEARCOAT_GLOSS);
  return (1.0f - cg) * F(0.1) + cg * F(0.001);
}

// bsdf_sample: (direction, valid); DiffuseLight: the default (0, 0, 1), invalid
__device__ __forceinline__
bool bsdf_sample(const Shade& sh, f3 vw, float lobe_u, float e1, float e2, float fresnel_u, f3& dir) {
  switch (sh.mtype) {
    case MAT_DIFFUSE:
      dir = to_world(sh.ns, cosine_sample_hemisphere(e1, e2));
      return true;
    case MAT_METAL: {
      f3 v = to_local(sh.ns, vw);
      f3 h = ggx_sample_microfacet_normal(v, sh.roughness, e1, e2);
      dir = to_world(sh.ns, reflect3(neg3(v), h));
      return dot3(dir, sh.ns) > 0.0f;
    }
    case MAT_GLASS: {
      float eta_i, eta_o;
      f3 v = to_local(sh.ns, vw);
      f3 h = ggx_sample_microfacet_normal(v, sh.roughness, e1, e2);
      etas(sh, par(sh, P_IOR), eta_i, eta_o);
      dir = to_world(sh.ns, dielectric_dir(v, h, eta_i, eta_o, fresnel_u));
      return true;
    }
    case MAT_PRINCIPLED: {
      Lobes lb = principled_lobes(sh);
      f3 n = sh.ng;
      f3 v = to_local(n, vw);
      bool use_d = lobe_u < lb.p_d;
      bool use_s = !use_d && lobe_u < lb.p_d + lb.p_s;
      bool use_g = !use_d && !use_s && lobe_u < lb.p_d + lb.p_s + lb.p_g;
      if (use_d) {
        dir = to_world(n, cosine_sample_hemisphere(e1, e2));
        return true;
      }
      if (use_g) {
        float eta_i, eta_o;
        f3 h = ggx_sample_microfacet_normal(v, par(sh, P_ROUGHNESS), e1, e2);
        etas(sh, par(sh, P_IOR), eta_i, eta_o);
        dir = to_world(n, dielectric_dir(v, h, eta_i, eta_o, fresnel_u));
        return true;
      }
      f3 h = use_s ? ggx_sample_microfacet_normal(v, par(sh, P_ROUGHNESS), e1, e2)
                   : gtr1_sample_microfacet_normal(0.25f, e1, e2);
      dir = to_world(n, reflect3(neg3(v), h));
      return dot3(dir, n) > 0.0f;
    }
    default:
      dir = mk(0.0f, 0.0f, 1.0f);
      return false;
  }
}

__device__ __forceinline__ void metal_pdf_eval(const Shade& sh, f3 vw, f3 lw, float& pdf, f3& ev) {
  f3 v = to_local(sh.ns, vw), l = to_local(sh.ns, lw);
  f3 h = normalize3_eps(add3(v, l));
  float l_dot_h = dot3(l, h);
  float jac = 1.0f / tmax(fabsf(l_dot_h) * 4.0f, F(1e-15));
  pdf = vndf_pdf_h(v, h, sh.roughness) * jac;
  float d = ggx_D(h, sh.roughness), g = ggx_G(v, l, sh.roughness);
  f3 f = fresnel_schlick(sh.base, l_dot_h);
  float lz = fabsf(l.z), vz = fabsf(v.z);
  float k = lz * (g * d / tmax(lz * 4.0f * vz, F(1e-15)));
  ev = scale3(f, k);
}

__device__ __forceinline__ void glass_pdf_eval(const Shade& sh, f3 vw, f3 lw, float& pdf, f3& ev) {
  float eta_i, eta_o, rough = sh.roughness;
  f3 v = to_local(sh.ns, vw), l = to_local(sh.ns, lw);
  bool reflect = l.z * v.z > 0.0f;
  etas(sh, par(sh, P_IOR), eta_i, eta_o);
  f3 h = half_vector(v, l, eta_i, eta_o, reflect);
  float f = fresnel_dielectric(v, h, eta_i, eta_o);
  float v_dot_h = dot3(v, h), l_dot_h = dot3(l, h);
  float rd = eta_i * v_dot_h + eta_o * l_dot_h;
  float refr_denom = rd * rd;
  float pdf_h = vndf_pdf_h(v, h, rough);
  float jac_refl = f / tmax(fabsf(l_dot_h) * 4.0f, F(1e-15));
  float jac_refr = (1.0f - f) * (eta_o * eta_o * fabsf(l_dot_h)) / tmax(refr_denom, F(1e-15));
  pdf = pdf_h * (reflect ? jac_refl : jac_refr);
  float d = ggx_D(h, rough), g = ggx_G(v, l, rough);
  float lz = fabsf(l.z), vz = fabsf(v.z);
  float fac_refl = f * g * d / tmax(lz * 4.0f * vz, F(1e-15));
  float term1 = fabsf(l_dot_h * v_dot_h / tmax(fabsf(l.z * v.z), F(1e-15)));
  float term2 = eta_o * eta_o / tmax(refr_denom, F(1e-15));
  float fac_refr = term1 * term2 * (1.0f - f) * g * d;
  float e = (reflect ? fac_refl : fac_refr) * lz;
  ev = mk(e, e, e);
}

__device__ __forceinline__ void principled_pdf_eval(const Shade& sh, f3 vw, f3 lw, float& pdf, f3& ev) {
  Lobes lb = principled_lobes(sh);
  f3 n = sh.ng;
  f3 base = sh.base;
  float roughness = par(sh, P_ROUGHNESS), eta_i, eta_o;
  f3 v = to_local(n, vw), l = to_local(n, lw);
  bool reflect = l.z * v.z > 0.0f;
  etas(sh, par(sh, P_IOR), eta_i, eta_o);
  f3 h = half_vector(v, l, eta_i, eta_o, reflect);
  float l_dot_h = dot3(l, h), v_dot_h = dot3(v, h);
  float lz = l.z, vz = v.z;
  float alpha_g = principled_alpha_g(sh);

  // _principled_pdf
  float jac_refl = 1.0f / tmax(fabsf(l_dot_h) * 4.0f, F(1e-15));
  float pdf_diffuse = fabsf(l.z) * INV_PI;
  float vndf = vndf_pdf_h(v, h, roughness);
  float pdf_spec = vndf * jac_refl;
  float diel_f = fresnel_dielectric(v, h, eta_i, eta_o);
  float rd = eta_i * v_dot_h + eta_o * l_dot_h;
  float refr_denom = rd * rd;
  float jac_glass = reflect ? diel_f * jac_refl
                            : (1.0f - diel_f) * (eta_o * eta_o * fabsf(l_dot_h)) / tmax(refr_denom, F(1e-15));
  float pdf_glass = vndf * jac_glass;
  float d_cc = gtr1_D(fabsf(l_dot_h), alpha_g);
  float pdf_cc_h = ggx_G1(v, 0.25f) * fabsf(v_dot_h) * d_cc / tmax(fabsf(v.z), F(1e-12));
  float pdf_cc = pdf_cc_h * jac_refl;
  float p = 0.0f;
  p = p + (lb.p_d > 0.0f && reflect ? lb.p_d * pdf_diffuse : 0.0f);
  p = p + (lb.p_s > 0.0f && reflect ? lb.p_s * pdf_spec : 0.0f);
  p = p + (lb.p_g > 0.0f ? lb.p_g * pdf_glass : 0.0f);
  p = p + (lb.p_c > 0.0f && reflect ? lb.p_c * pdf_cc : 0.0f);
  pdf = p;

  // _principled_eval: diffuse, retro-reflection, subsurface, sheen
  float rr = roughness * 2.0f * l_dot_h * l_dot_h;
  float fl = schlick_weight(lz), fv = schlick_weight(vz);
  float f_retro = rr * (fl + fv + fl * fv * (rr - 1.0f));
  float f_d = (1.0f - fl * 0.5f) * (1.0f - fv * 0.5f);
  float fss90 = rr * 0.5f;
  float f_ss = lerp(1.0f, fss90, fl) * lerp(1.0f, fss90, fv);
  float svz = lz + vz;
  svz = fabsf(svz) > F(1e-12) ? svz : (svz < 0.0f ? -F(1e-12) : F(1e-12));
  float ss = (f_ss * (1.0f / svz - 0.5f) + 0.5f) * 1.25f;
  float k_diff = lerp(f_d + f_retro, ss, par(sh, P_SUBSURFACE)) * INV_PI;
  float lum = base.x * F(0.2126) + base.y * F(0.7152) + base.z * F(0.0722);
  bool pos = lum > 0.0f;
  float inv = 1.0f / (pos ? lum : 1.0f);
  f3 c_tint = mk(pos ? base.x * inv : 1.0f, pos ? base.y * inv : 1.0f, pos ? base.z * inv : 1.0f);
  float sheen_tint = par(sh, P_SHEEN_TINT);
  float sheen_w = par(sh, P_SHEEN) * schlick_weight(fabsf(l_dot_h));
  f3 diffuse = mk(base.x * k_diff + sheen_w * lerp(1.0f, c_tint.x, sheen_tint),
                  base.y * k_diff + sheen_w * lerp(1.0f, c_tint.y, sheen_tint),
                  base.z * k_diff + sheen_w * lerp(1.0f, c_tint.z, sheen_tint));

  // specular, with the metallic-lerped fresnel
  float metallic = par(sh, P_METALLIC), spec_tint = par(sh, P_SPECULAR_TINT);
  float eta = eta_i / eta_o;
  float x = (eta - 1.0f) / (eta + 1.0f);
  float spec_amt = par(sh, P_SPECULAR) * (x * x);
  f3 c0 = mk(lerp(spec_amt * lerp(1.0f, c_tint.x, spec_tint), base.x, metallic),
             lerp(spec_amt * lerp(1.0f, c_tint.y, spec_tint), base.y, metallic),
             lerp(spec_amt * lerp(1.0f, c_tint.z, spec_tint), base.z, metallic));
  f3 metal_f = fresnel_schlick(c0, l_dot_h);
  f3 fres = mk(lerp(diel_f, metal_f.x, metallic), lerp(diel_f, metal_f.y, metallic), lerp(diel_f, metal_f.z, metallic));
  float d_ggx = ggx_D(h, roughness), g_ggx = ggx_G(v, l, roughness);
  float denom4 = tmax(fabsf(lz) * 4.0f * fabsf(vz), F(1e-15));
  float k_spec = g_ggx * d_ggx / denom4;
  f3 spec = scale3(fres, k_spec);

  // glass, achromatic
  float fac_refl = diel_f * g_ggx * d_ggx / denom4;
  float pvz = lz * vz;
  pvz = fabsf(pvz) > F(1e-12) ? pvz : (pvz < 0.0f ? -F(1e-12) : F(1e-12));
  float term1 = fabsf(l_dot_h * v_dot_h / pvz);
  float term2 = eta_o * eta_o / tmax(refr_denom, F(1e-15));
  float fac_refr = term1 * term2 * (1.0f - diel_f) * g_ggx * d_ggx;
  float glass_k = reflect ? fac_refl : fac_refr;

  // clearcoat, with the reference's extra |l.z|
  float g_cc = ggx_G(v, l, 0.25f);
  const float x15 = 0.5f / 2.5f;  // sampling.py R0_15: r0_from_eta(1.5) in float32 steps
  const float r0 = x15 * x15;
  f3 f_cc = fresnel_schlick(mk(r0, r0, r0), l_dot_h);
  float k_cc = fabsf(lz) * d_cc * g_cc / denom4;
  f3 cc = scale3(f_cc, k_cc);

  bool m_d = lb.p_d > 0.0f && reflect, m_s = lb.p_s > 0.0f && reflect;
  bool m_g = lb.p_g > 0.0f, m_c = lb.p_c > 0.0f && reflect;
  float alz = fabsf(lz);
  float acc[3];
  const float dif[3] = {diffuse.x, diffuse.y, diffuse.z}, spc[3] = {spec.x, spec.y, spec.z};
  const float ccc[3] = {cc.x, cc.y, cc.z};
  for (int j = 0; j < 3; ++j) {
    float a = m_d ? lb.w_d * dif[j] : 0.0f;
    a = a + (m_s ? lb.w_s * spc[j] : 0.0f);
    a = a + (m_g ? lb.w_g * glass_k : 0.0f);
    a = a + (m_c ? lb.w_c * ccc[j] : 0.0f);
    acc[j] = a * alz;
  }
  ev = mk(acc[0], acc[1], acc[2]);
}

// bsdf_pdf and bsdf_eval of one direction; DiffuseLight: pdf 1, eval (1, 1, 1)
__device__ __forceinline__ void bsdf_pdf_eval(const Shade& sh, f3 vw, f3 lw, float& pdf, f3& ev) {
  switch (sh.mtype) {
    case MAT_DIFFUSE: {
      float lz = fabsf(dot3(sh.ns, lw)) * INV_PI;
      pdf = lz;
      ev = scale3(sh.base, lz);
      return;
    }
    case MAT_METAL:
      metal_pdf_eval(sh, vw, lw, pdf, ev);
      return;
    case MAT_GLASS:
      glass_pdf_eval(sh, vw, lw, pdf, ev);
      return;
    case MAT_PRINCIPLED:
      principled_pdf_eval(sh, vw, lw, pdf, ev);
      return;
    default:
      pdf = 1.0f;
      ev = mk(1.0f, 1.0f, 1.0f);
  }
}

// ---- ops/lights.py ----

// _sample_geom_lights: a direction toward geometry light li
__device__ __forceinline__
f3 sample_geom_light(const ShadeArgs& s, f3 o, float time, int li, float u1, float u2) {
  const float* row = s.light_geom + 10 * imin(li, s.n_lights - 1);
  f3 a = mk(__ldg(row), __ldg(row + 1), __ldg(row + 2)), b = mk(__ldg(row + 3), __ldg(row + 4), __ldg(row + 5));
  f3 c = mk(__ldg(row + 6), __ldg(row + 7), __ldg(row + 8));
  f3 p;
  if (to_i32(__ldg(row + 9)) == GEOM_SPHERE) {
    float theta = TWO_PI_F * u1;
    float phi = acosf(clip(2.0f * u2 - 1.0f, -1.0f, 1.0f));
    float sp = sinf(phi), r = c.x;
    p = mk(a.x + (b.x - a.x) * time + sp * cosf(theta) * r, a.y + (b.y - a.y) * time + sp * sinf(theta) * r,
           a.z + (b.z - a.z) * time + cosf(phi) * r);
  } else {
    p = mk(a.x + b.x * u1 + c.x * u2, a.y + b.y * u1 + c.y * u2, a.z + b.z * u1 + c.z * u2);
  }
  return normalize3_eps(mk(p.x - o.x, p.y - o.y, p.z - o.z));
}

// sample_lights: a member picked uniformly; with the HDR map the environment is one more
__device__ __forceinline__
f3 sample_light(const ShadeArgs& s, f3 o, float time, float u_pick, float u1, float u2, bool& is_env) {
  is_env = false;
  if (s.env_route != ENV_HDR) {
    int n = s.n_lights;
    return sample_geom_light(s, o, time, imin(to_i32(u_pick * (float)n), n - 1), u1, u2);
  }
  int m = s.n_lights_real + 1;
  int pick = imin(to_i32(u_pick * (float)m), m - 1);
  is_env = pick == s.n_lights_real;
  return is_env ? sample_env_light(s, u1, u2) : sample_geom_light(s, o, time, pick, u1, u2);
}

__device__ __forceinline__ float sphere_light_pdf(const ShadeArgs& s, int gi, f3 o, f3 d, float time) {
  f3 c1 = ldg3(s.sph_c1, gi), c2 = ldg3(s.sph_c2, gi);
  float r = __ldg(s.sph_r + gi);
  f3 c = mk(c1.x + (c2.x - c1.x) * time, c1.y + (c2.y - c1.y) * time, c1.z + (c2.z - c1.z) * time);
  f3 l = mk(c.x - o.x, c.y - o.y, c.z - o.z);
  float sd = l.x * d.x + l.y * d.y + l.z * d.z;
  float l2 = l.x * l.x + l.y * l.y + l.z * l.z;
  float r2 = r * r;
  float d2 = l2 - sd * sd;
  float q = sqrtf(tmax(r2 - d2, 0.0f));
  float t = l2 > r2 ? sd - q : sd + q;
  bool hit = !((sd < 0.0f && l2 > r2) || d2 > r2) && t > 0.0f;
  float solid_angle = TWO_PI_F * sqrtf(tmax(1.0f - r2 / tmax(l2, F(1e-20)), 0.0f));
  return hit ? 1.0f / tmax(solid_angle, F(1e-20)) : 0.0f;
}

__device__ __forceinline__ float quad_light_pdf(const ShadeArgs& s, int gi, f3 o, f3 d) {
  f3 q = ldg3(s.quad_q, gi), u = ldg3(s.quad_u, gi), v = ldg3(s.quad_v, gi), w = ldg3(s.quad_w, gi);
  f3 nrm = ldg3(s.quad_n, gi);
  float dd = __ldg(s.quad_d + gi);
  float nd = nrm.x * d.x + nrm.y * d.y + nrm.z * d.z;
  float no = nrm.x * o.x + nrm.y * o.y + nrm.z * o.z;
  float t = (dd - no) / (fabsf(nd) < F(1e-8) ? 1.0f : nd);
  float px = o.x + t * d.x - q.x, py = o.y + t * d.y - q.y, pz = o.z + t * d.z - q.z;
  float alpha = w.x * (py * v.z - pz * v.y) + w.y * (pz * v.x - px * v.z) + w.z * (px * v.y - py * v.x);
  float beta = w.x * (u.y * pz - u.z * py) + w.y * (u.z * px - u.x * pz) + w.z * (u.x * py - u.y * px);
  bool hit = fabsf(nd) >= F(1e-8) && t > 0.0f && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
  f3 ucv = cross3(u, v);
  float area = sqrtf(dot3(ucv, ucv));
  float cos_theta = fabsf(nd);
  float pdf = t * t / tmax(cos_theta * area, F(1e-20));
  return hit ? pdf : 0.0f;
}

__device__ __forceinline__ float tri_light_pdf(const ShadeArgs& s, int gi, f3 o, f3 d) {
  f3 v0 = ldg3(s.tri_v0, gi), e1 = ldg3(s.tri_e1, gi), e2 = ldg3(s.tri_e2, gi);
  f3 n0 = ldg3(s.tri_n0, gi), n1 = ldg3(s.tri_n1, gi), n2 = ldg3(s.tri_n2, gi);
  f3 h = cross3(d, e2);
  float a = dot3(e1, h);
  float f = 1.0f / (fabsf(a) < F(1e-8) ? 1.0f : a);
  f3 sv = mk(o.x - v0.x, o.y - v0.y, o.z - v0.z);
  float u = f * dot3(sv, h);
  f3 q = cross3(sv, e1);
  float v = f * dot3(d, q);
  float t = f * dot3(e2, q);
  bool hit = fabsf(a) >= F(1e-8) && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
  float w = 1.0f - u - v;
  f3 nrm = normalize3_eps(mk(n0.x * w + n1.x * u + n2.x * v, n0.y * w + n1.y * u + n2.y * v,
                             n0.z * w + n1.z * u + n2.z * v));
  f3 e1xe2 = cross3(e1, e2);
  float area = 0.5f * sqrtf(dot3(e1xe2, e1xe2));
  float cos_theta = fabsf(dot3(d, nrm));
  float pdf = t * t / tmax(cos_theta * area, F(1e-20));
  return hit ? pdf : 0.0f;
}

// pdf_lights: the members' mean pdf, the HDR map's (pdf_env_light) first where it is one
__device__ __forceinline__ float pdf_lights(const ShadeArgs& s, f3 o, f3 d, float time) {
  bool hdr = s.env_route == ENV_HDR;
  int n = hdr ? s.n_lights_real : s.n_lights;
  float total = 0.0f;
  for (int k = 0; k < n; ++k) {
    int kind = __ldg(s.light_kind + k), gi = __ldg(s.light_idx + k);
    float p = kind == GEOM_SPHERE ? sphere_light_pdf(s, gi, o, d, time)
              : kind == GEOM_QUAD ? quad_light_pdf(s, gi, o, d)
                                  : tri_light_pdf(s, gi, o, d);
    total = total + p;
  }
  if (!hdr) return total * (1.0f / (float)n);
  float env = __ldg(s.env_sam + 3 * env_texel(s, d) + 2);
  return (n ? env + total : env) * (1.0f / (float)(n + 1));
}

// ---- shading: ops/intersect.py's selection and _make_hit, then bounce_step's estimator ----

struct Hit {
  bool valid, front;
  f3 point, ng, ns;
  float u, v;
  int mat_id;
};

__device__ __forceinline__ Hit make_hit(const ShadeArgs& s, int i, f3 o, f3 d, float time) {
  // closest_hit's selection over K1's and the triangle route's winners
  float t_sq = s.t_sq[i];
  int kind_sq = s.kind_sq[i], idx_sq = s.idx_sq[i];
  bool is_sph = kind_sq == GEOM_SPHERE;
  float t_s = is_sph ? t_sq : BIG, t_q = is_sph ? BIG : t_sq;
  int i_s = is_sph ? idx_sq : 0, i_q = is_sph ? 0 : idx_sq;
  float t_t = BIG;
  int i_t = 0;
  if (s.tri_route != TRI_NONE) {
    t_t = s.t_tri[i];
    i_t = s.i_tri[i];
  }
  float t_best = tmin(tmin(t_s, t_q), t_t);
  int kind = t_s == t_best ? GEOM_SPHERE : (t_q == t_best ? GEOM_QUAD : GEOM_TRI);
  Hit hit;
  hit.valid = t_best < BIG;
  if (!hit.valid) return hit;  // a miss: the caller reads the environment alone
  float t = t_best;
  f3 p = mk(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
  hit.point = p;

  f3 nr;
  float uu, vv;
  if (kind == GEOM_SPHERE) {  // sphere.rs:52-56, 88-90
    f3 c1 = ldg3(s.sph_c1, i_s), c2 = ldg3(s.sph_c2, i_s);
    f3 c = mk(c1.x + (c2.x - c1.x) * time, c1.y + (c2.y - c1.y) * time, c1.z + (c2.z - c1.z) * time);
    f3 n = mk(p.x - c.x, p.y - c.y, p.z - c.z);
    n = normalize3_eps(n);
    float theta = acosf(clip(-n.y, -1.0f, 1.0f));
    float phi = atan2f(-n.z, n.x) + PI_F;
    uu = phi * INV_TWO_PI;
    vv = theta * INV_PI;
    nr = n;
    hit.mat_id = __ldg(s.sph_mat + i_s);
  } else if (kind == GEOM_QUAD) {  // quad.rs:53-69
    f3 q = ldg3(s.quad_q, i_q), u = ldg3(s.quad_u, i_q), v = ldg3(s.quad_v, i_q), w = ldg3(s.quad_w, i_q);
    f3 pr = mk(p.x - q.x, p.y - q.y, p.z - q.z);
    uu = w.x * (pr.y * v.z - pr.z * v.y) + w.y * (pr.z * v.x - pr.x * v.z) + w.z * (pr.x * v.y - pr.y * v.x);
    vv = w.x * (u.y * pr.z - u.z * pr.y) + w.y * (u.z * pr.x - u.x * pr.z) + w.z * (u.x * pr.y - u.y * pr.x);
    nr = ldg3(s.quad_n, i_q);
    hit.mat_id = __ldg(s.quad_mat + i_q);
  } else if (s.tri_route == TRI_AUX) {  // the triangle kernels' interpolated attributes
    f3 n = ld3(s.aux_ns, i);
    nr = normalize3_eps(n);
    uu = s.aux_u[i];
    vv = s.aux_v[i];
    hit.mat_id = s.aux_mat[i];
  } else {  // mesh.rs:84-101, gathered from the tables (the sweep routes)
    int ti = i_t;
    f3 v0 = ldg3(s.tri_v0, ti), e1 = ldg3(s.tri_e1, ti), e2 = ldg3(s.tri_e2, ti);
    float hx = d.y * e2.z - d.z * e2.y, hy = d.z * e2.x - d.x * e2.z, hz = d.x * e2.y - d.y * e2.x;
    float a = e1.x * hx + e1.y * hy + e1.z * hz;
    float f = 1.0f / (fabsf(a) < F(1e-12) ? 1.0f : a);
    float sx = o.x - v0.x, sy = o.y - v0.y, sz = o.z - v0.z;
    float bu = f * (sx * hx + sy * hy + sz * hz);
    float qx = sy * e1.z - sz * e1.y, qy = sz * e1.x - sx * e1.z, qz = sx * e1.y - sy * e1.x;
    float bv = f * (d.x * qx + d.y * qy + d.z * qz);
    float bw = 1.0f - bu - bv;
    f3 n0 = ldg3(s.tri_n0, ti), n1 = ldg3(s.tri_n1, ti), n2 = ldg3(s.tri_n2, ti);
    f3 n = mk(n0.x * bw + n1.x * bu + n2.x * bv, n0.y * bw + n1.y * bu + n2.y * bv, n0.z * bw + n1.z * bu + n2.z * bv);
    nr = normalize3_eps(n);
    if (__ldg(s.tri_has_uv + ti)) {
      const float *a0 = s.tri_uv0 + 2 * ti, *a1 = s.tri_uv1 + 2 * ti, *a2 = s.tri_uv2 + 2 * ti;
      uu = __ldg(a0) * bw + __ldg(a1) * bu + __ldg(a2) * bv;
      vv = __ldg(a0 + 1) * bw + __ldg(a1 + 1) * bu + __ldg(a2 + 1) * bv;
    } else {
      uu = bu;
      vv = bv;
    }
    hit.mat_id = __ldg(s.tri_mat + ti);
  }
  hit.u = uu;
  hit.v = vv;

  // HitInfo::new's epilogue: front-face flip, normal mapping (hit_info.rs:25-43, 58-67)
  hit.front = d.x * nr.x + d.y * nr.y + d.z * nr.z < 0.0f;
  float invn = 1.0f / sqrtf(tmax(dot3(nr, nr), F(1e-24)));
  f3 ng = scale3(nr, hit.front ? invn : -invn);
  hit.ng = ng;
  hit.ns = ng;
  int ntex = __ldg(s.mat_normal_tex + hit.mat_id);
  if (ntex >= 0) {
    f3 m = eval_texture(s, ntex, uu, vv, p);
    m = mk(2.0f * m.x - 1.0f, 2.0f * m.y - 1.0f, 2.0f * m.z - 1.0f);
    bool use_y = fabsf(ng.x) > F(0.9);
    float axx = use_y ? 0.0f : 1.0f, axy = use_y ? 1.0f : 0.0f;
    f3 tg = mk(ng.y * 0.0f - ng.z * axy, ng.z * axx - ng.x * 0.0f, ng.x * axy - ng.y * axx);
    tg = normalize3_eps(tg);
    f3 bt = mk(ng.y * tg.z - ng.z * tg.y, ng.z * tg.x - ng.x * tg.z, ng.x * tg.y - ng.y * tg.x);
    f3 ns = mk(m.x * tg.x + m.y * bt.x + m.z * ng.x, m.x * tg.y + m.y * bt.y + m.z * ng.y,
               m.x * tg.z + m.y * bt.z + m.z * ng.z);
    hit.ns = normalize3_eps(ns);
  }
  return hit;
}

__device__ __forceinline__ void shade_lane(const ShadeArgs& s, int i) {
  bool alive0 = s.alive[i] != 0;  // after regeneration
  int bounce = s.bounce[i];
  f3 T = ld3(s.T, i), L = ld3(s.L, i);
  bool alive = false;  // bounce_step's alive
  f3 o_next = mk(0.0f, 0.0f, 0.0f), d_next = o_next;
  if (!alive0) {
    L = add3(add3(L, mk(0.0f, 0.0f, 0.0f)), mk(0.0f, 0.0f, 0.0f));  // its two masked additions
  } else {
    f3 o = ld3(s.o, i), d = ld3(s.d, i);
    float time = s.time[i];
    Hit hit = make_hit(s, i, o, d, time);
    // miss -> environment (camera.rs:180-183)
    if (!hit.valid) {
      f3 env = environment(s, d);
      L = add3(L, mk(T.x * env.x, T.y * env.y, T.z * env.z));
      L = add3(L, mk(0.0f, 0.0f, 0.0f));
    } else {
      L = add3(L, mk(0.0f, 0.0f, 0.0f));
      // make_shade and the emission (camera.rs:186-187)
      Shade sh;
      int mat = hit.mat_id;
      sh.mtype = __ldg(s.mat_type + mat);
      sh.params = s.mat_params + N_PARAMS * mat;
      sh.base = eval_texture(s, __ldg(s.mat_tex + mat), hit.u, hit.v, hit.point);
      sh.roughness = 0.0f;
      if (sh.mtype == MAT_METAL || sh.mtype == MAT_GLASS)
        sh.roughness = eval_texture(s, __ldg(s.mat_rough_tex + mat), hit.u, hit.v, hit.point).x;
      sh.ng = hit.ng;
      sh.ns = hit.ns;
      sh.front = hit.front;
      f3 em = sh.mtype == MAT_LIGHT ? sh.base : mk(0.0f, 0.0f, 0.0f);
      L = add3(L, mk(T.x * em.x, T.y * em.y, T.z * em.z));

      // per-bounce uniforms
      uint32_t seed = (uint32_t)(*s.seed), pix = (uint32_t)s.pix[i], smp = (uint32_t)s.cur_sample[i];
      uint32_t ctrl = (uint32_t)bounce_ctr(bounce);
      float c[4], b[4];
      uniform4(seed, pix, smp, ctrl + SLOT_CTRL, c);  // rr_u, mis_r, light_pick, lobe_u
      uniform4(seed, pix, smp, ctrl + SLOT_BSDF, b);  // e1, e2, fresnel_u

      // russian roulette after MIN_BOUNCES (camera.rs:190-196)
      float p = clip(T.x * F(0.2126) + T.y * F(0.7152) + T.z * F(0.0722), F(0.01), 1.0f);
      alive = true;
      if (bounce > MIN_BOUNCES) {
        alive = !(c[0] > p);
        if (alive) T = mk(T.x / p, T.y / p, T.z / p);
      }
      if (alive) {
        // one-sample MIS between light and BSDF sampling (camera.rs:198-216)
        f3 view = neg3(d), new_dir;
        bool ok = bsdf_sample(sh, view, c[3], b[0], b[1], b[2], new_dir);
        if (s.has_lights) {
          float l[4];
          uniform4(seed, pix, smp, ctrl + SLOT_LIGHT, l);
          bool l_is_env;
          f3 l_dir = sample_light(s, hit.point, time, c[2], l[0], l[1], l_is_env);
          // the environment member aimed below an opaque lane's shading horizon fails
          bool opaque = sh.mtype == MAT_DIFFUSE || sh.mtype == MAT_METAL;
          bool l_ok = !(l_is_env && opaque && dot3(l_dir, hit.ns) <= 0.0f);
          if (c[1] < s.p_light) {
            new_dir = l_dir;
            ok = l_ok;
          }
        }
        alive = ok;
        if (alive) {
          float pdf_b;
          f3 brdf;
          bsdf_pdf_eval(sh, view, new_dir, pdf_b, brdf);
          float pdf = pdf_b * s.p_bsdf;
          if (s.has_lights) pdf = pdf + pdf_lights(s, hit.point, new_dir, time) * s.p_light;
          T = mk(T.x * (brdf.x / pdf), T.y * (brdf.y / pdf), T.z * (brdf.z / pdf));  // unguarded (camera.rs:216)
          // offset next origin along the geometric normal (camera.rs:217-222)
          float eps = tsign(dot3(new_dir, hit.ng)) * EPS;
          o_next = mk(hit.point.x + eps * hit.ng.x, hit.point.y + eps * hit.ng.y, hit.point.z + eps * hit.ng.z);
          d_next = normalize_dir(new_dir);
        }
      }
    }
  }
  // _stream_step's tail: the max_depth exit, the film flush of finished paths
  bounce = bounce + 1;
  bool alive_h = alive && bounce < s.max_depth;
  bool died = alive0 && !alive_h;
  f3 film = ld3(s.film, i);
  film = add3(film, died ? L : mk(0.0f, 0.0f, 0.0f));
  if (alive_h) {
    st3(s.o, i, o_next);
    st3(s.d, i, d_next);
  }
  st3(s.T, i, T);
  st3(s.L, i, L);
  st3(s.film, i, film);
  s.bounce[i] = bounce;
  s.alive[i] = alive_h ? 1 : 0;
}

#undef F

}  // namespace wf

namespace {

__global__ void __launch_bounds__(wf::THREADS) regen_kernel(wf::RegenArgs a) {
  int i = blockIdx.x * wf::THREADS + threadIdx.x;
  bool live = i < a.n && wf::regen_lane(a, i);
  int count = __syncthreads_count(live);
  if (threadIdx.x == 0 && count) atomicAdd(a.rays, (unsigned long long)count);
}

__global__ void __launch_bounds__(wf::THREADS) shade_kernel(wf::ShadeArgs a) {
  int i = blockIdx.x * wf::THREADS + threadIdx.x;
  if (i < a.n) wf::shade_lane(a, i);
}

}  // namespace

extern "C" {

int tpupt_wavefront_regen(const wf::RegenArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  int blocks = (args->n + wf::THREADS - 1) / wf::THREADS;
  regen_kernel<<<blocks, wf::THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

int tpupt_wavefront_shade(const wf::ShadeArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  int blocks = (args->n + wf::THREADS - 1) / wf::THREADS;
  shade_kernel<<<blocks, wf::THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // extern "C"
