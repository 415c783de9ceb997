"""The wavefront iteration's two kernels, ``csrc/wavefront.cu``: regeneration and shading.

``integrator.StreamStages.step`` runs them on the card around the hit kernels
(``intersect.hit_kernels``): ``regenerate`` is ``_stream_step``'s head, ``shade`` everything
after the hits, and between them the state is updated in place. Their plain version is
``integrator._stream_step`` itself, which the stage runner keeps on the CPU, and against
which the card tests hold the kernels bit for bit. The wrappers take CUDA tensors only and
raise on anything else; there is no fallback. ``launches`` counts kernel launches, and a
call under CUDA graph capture counts in ``captured`` (render/graph.py turns the captured
calls into launches as the graph runs them), as K1-K4 do.
"""

from __future__ import annotations

import ctypes

import torch

launches = {"regen": 0, "shade": 0}  # kernel launches since the last reset
captured = {"regen": 0, "shade": 0}  # calls recorded into a CUDA graph under capture

P, I32, F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float

# the state's fields, with their dtypes, in the kernels' argument order (csrc/wavefront.cu)
_REGEN_STATE = (("pix", torch.int32), ("row", torch.int32), ("col", torch.int32), ("sample0", torch.int32),
                ("o", torch.float32), ("d", torch.float32), ("time", torch.float32),
                ("throughput", torch.float32), ("radiance", torch.float32), ("bounce", torch.int32),
                ("sample", torch.int32), ("cur_sample", torch.int32), ("alive", torch.bool))
_CAMERA = ("center", "pixel00", "pixel_du", "pixel_dv", "right", "up", "defocus_radius", "blur_strength")
_SHADE_STATE = (("pix", torch.int32), ("cur_sample", torch.int32), ("time", torch.float32), ("o", torch.float32),
                ("d", torch.float32), ("throughput", torch.float32), ("radiance", torch.float32),
                ("film", torch.float32), ("bounce", torch.int32), ("alive", torch.bool))
_HITS = ("t_sq", "kind_sq", "idx_sq", "t_tri", "i_tri", "aux_ns", "aux_u", "aux_v", "aux_mat")
_SCENE_INT = {"sph_mat", "quad_mat", "tri_mat", "light_kind", "light_idx", "mat_type", "mat_tex", "mat_rough_tex",
              "mat_normal_tex", "tex_type", "tex_child", "tex_img", "env_tex"}
_SCENE = tuple((name, torch.int32 if name in _SCENE_INT else torch.bool if name == "tri_has_uv" else torch.float32)
               for name in (
    "sph_c1", "sph_c2", "sph_r", "sph_mat", "quad_q", "quad_u", "quad_v", "quad_w", "quad_n", "quad_d", "quad_mat",
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2", "tri_uv0", "tri_uv1", "tri_uv2", "tri_has_uv",
    "tri_mat", "light_kind", "light_idx", "light_geom", "mat_type", "mat_tex", "mat_rough_tex", "mat_normal_tex",
    "mat_params", "tex_type", "tex_rgb", "tex_inv_scale", "tex_child", "tex_img", "atlas", "env_color", "env_tex",
    "env_img", "env_sam"))

TRI_NONE, TRI_AUX, TRI_GATHER = 0, 1, 2  # the triangle route's outputs: none, the kernels' attributes, t and idx
ENV_COLOR, ENV_MAP, ENV_TEXTURE, ENV_HDR = 0, 1, 2, 3  # sample_environment's routes


class _RegenArgs(ctypes.Structure):
    _fields_ = ([(name, P) for name, _ in _REGEN_STATE] + [(name, P) for name in _CAMERA]
                + [("seed", P), ("rays", P), ("n", I32), ("k", I32), ("spp_limit", I32)])


class _ShadeArgs(ctypes.Structure):
    _fields_ = ([(name, P) for name, _ in _SHADE_STATE] + [(name, P) for name in _HITS]
                + [(name, P) for name, _ in _SCENE] + [("seed", P)]
                + [(name, I32) for name in ("n", "max_depth", "has_lights", "n_lights", "atlas_rows", "tri_route",
                                            "env_route", "env_map_off", "env_map_w", "env_map_h", "env_w", "env_h",
                                            "n_lights_real")]
                + [("p_light", F32), ("p_bsdf", F32)])


_entry: dict = {}


def _fn(name):
    if name not in _entry:
        from .. import build

        fn = getattr(build.load("wavefront"), f"tpupt_wavefront_{name}")
        fn.argtypes = [P, P]
        fn.restype = ctypes.c_int
        _entry[name] = fn
    return _entry[name]


def _ptr(what, x, dtype, device):
    if not torch.is_tensor(x) or x.device != device:
        raise ValueError(f"wavefront kernels: {what} must be a tensor on {device}")
    if x.dtype != dtype:
        raise TypeError(f"wavefront kernels: {what} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"wavefront kernels: {what} must be contiguous")
    return x.data_ptr()


def _launch(name, args, device):
    if device.type != "cuda":
        raise ValueError(f"wavefront kernels: unsupported device {device} (the CPU runs integrator._stream_step)")
    if args.n == 0:
        return  # nothing to launch, nothing counted
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(name)(ctypes.byref(args), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"wavefront kernel {name}: CUDA launch failed with error {err}")
    (captured if capturing else launches)[name] += 1


def regenerate(s, cam, seed, k, spp_limit, rays):
    """_stream_step's head on the card, in place on the state `s` (a stage's dict of tensors):
    each lane without a path and with samples left (sample < k, sample0 + sample < spp_limit)
    starts its next sample (generate_rays from `cam`, a CameraData on the card, and `seed`, a
    0-d int64 tensor); the lanes alive after it are added to `rays` ([1] int64)."""
    dev = s["alive"].device
    n = s["alive"].shape[0]
    args = _RegenArgs(*(_ptr(key, s[key], dt, dev) for key, dt in _REGEN_STATE),
                      *(_ptr(f"cam.{f}", getattr(cam, f), torch.float32, dev) for f in _CAMERA),
                      _ptr("seed", seed, torch.int64, dev), _ptr("rays", rays, torch.int64, dev), n, k, spp_limit)
    _launch("regen", args, dev)


def _env_route(sd) -> int:
    """sample_environment's route: the HDR map (a light member too), a constant, an LDR map at
    atlas coordinates the host knows, or a texture."""
    if sd.env_is_hdr:
        return ENV_HDR
    if not sd.env_is_map:
        return ENV_COLOR
    return ENV_MAP if sd.env_map_w > 0 else ENV_TEXTURE


def shade(s, sd, hits, seed, max_depth, has_lights, p_light, p_bsdf):
    """Everything _stream_step does after the hit kernels, on the card, in place on the state
    `s`: o, d, throughput, radiance, film, bounce and alive.

    hits is ``intersect.hit_kernels``' (t_sq, kind_sq, idx_sq, tri): K1's outputs and the
    triangle route's, tri None where the scene has no real triangle, else (t, idx, aux) with
    aux the triangle kernels' attributes (None on the sweep routes)."""
    dev = s["alive"].device
    n = s["alive"].shape[0]
    t_sq, kind_sq, idx_sq, tri = hits
    out = [_ptr("t_sq", t_sq, torch.float32, dev), _ptr("kind_sq", kind_sq, torch.int32, dev),
           _ptr("idx_sq", idx_sq, torch.int32, dev)]
    if tri is None:
        route = TRI_NONE
        out += [None] * 6
    else:
        t_t, i_t, aux = tri
        out += [_ptr("t_tri", t_t, torch.float32, dev), _ptr("i_tri", i_t, torch.int32, dev)]
        if aux is None:
            route = TRI_GATHER
            out += [None] * 4
        else:
            route = TRI_AUX
            out += [_ptr(f"aux.{key}", aux[key], dt, dev)
                    for key, dt in (("ns_raw", torch.float32), ("u", torch.float32), ("v", torch.float32),
                                    ("mat", torch.int32))]
    out += [_ptr(f"sd.{key}", getattr(sd, key), dt, dev) for key, dt in _SCENE]
    ints = (n, max_depth, int(bool(has_lights)), sd.n_lights, sd.atlas.shape[0], route, _env_route(sd),
            sd.env_map_off, sd.env_map_w, sd.env_map_h, *sd.env_wh_host, sd.n_lights_real)
    args = _ShadeArgs(*(_ptr(key, s[key], dt, dev) for key, dt in _SHADE_STATE), *out,
                      _ptr("seed", seed, torch.int64, dev), *ints, p_light, p_bsdf)
    _launch("shade", args, dev)
