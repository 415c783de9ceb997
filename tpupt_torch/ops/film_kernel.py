"""The render's film on its device: ``csrc/film.cu``'s two kernels and their plain versions.

- ``add(film, out, ids, n_valid)``: a launch's film ``out`` [pb, 3] added into the float64
  film [npix, 3] at the pixel ids of its first n_valid lanes, one add a pixel, in the order of
  the launches: numpy's ``film[ids] += out.astype(np.float64)``, bit for bit;
- ``resolve(film, spp)``: the film over spp once, as (uint8 image, mean radiance), by
  ``render/film.py``'s ``tonemap_quantize`` rule, in IEEE double: numpy's bits.

Each launches its kernel for CUDA tensors and runs its ``*_plain`` version for CPU tensors,
with no fallback from one to the other. ``launches`` counts the kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.dtypes import REAL
from ..render.film import tonemap_quantize

launches = {"add": 0, "resolve": 0}  # kernel launches since the last reset (plain calls not counted)

_lib = None


def lib() -> ctypes.CDLL:
    """The built library, its functions' signatures declared."""
    global _lib
    if _lib is None:
        from .. import build

        lib_ = build.load("film")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args in (("tpupt_film_add", [P, P, P, I, P]), ("tpupt_film_resolve", [P, L, I, P, P, P])):
            fn = getattr(lib_, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib_.tpupt_film_error_string.argtypes = [I]
        lib_.tpupt_film_error_string.restype = ctypes.c_char_p
        _lib = lib_
    return _lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"film kernel {what}: CUDA launch failed with error {err} "
                           f"({lib().tpupt_film_error_string(err).decode()})")


def _need(what, x, dtype, device):
    if not torch.is_tensor(x) or x.device != device:
        raise ValueError(f"film kernels: {what} must be a tensor on {device}")
    if x.dtype != dtype:
        raise TypeError(f"film kernels: {what} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"film kernels: {what} must be contiguous")


def add_plain(film, out, ids, n_valid):
    """add's plain version: the gather, the add and the scatter of numpy's
    ``film[ids] += out.astype(np.float64)`` over the first n_valid lanes."""
    idx = ids[:n_valid].long()
    film[idx] += out[:n_valid].to(film.dtype)


def resolve_plain(film, spp):
    """resolve's plain version, for a film on the CPU -> (image [npix, 3] uint8, mean [npix, 3]
    REAL): x = film / spp, its image by ``tonemap_quantize`` (numpy's sqrt is correctly
    rounded, as the kernel's is) and x rounded to REAL."""
    x = film / spp
    return torch.from_numpy(tonemap_quantize(x.numpy())), x.to(REAL)


def add(film, out, ids, n_valid):
    """film [npix, 3] float64 += out [pb, 3] at ids [pb] int32, lanes < n_valid, in place."""
    dev = film.device
    if dev.type != "cuda":
        return add_plain(film, out, ids, n_valid)
    _need("film", film, torch.float64, dev)
    _need("out", out, torch.float32, dev)
    _need("ids", ids, torch.int32, dev)
    if not 0 <= n_valid <= min(ids.shape[0], out.shape[0]):
        raise ValueError(f"film kernels: n_valid {n_valid} outside the launch's {ids.shape[0]} lanes")
    with torch.cuda.device(dev):
        err = lib().tpupt_film_add(out.data_ptr(), ids.data_ptr(), film.data_ptr(), n_valid,
                                   torch.cuda.current_stream().cuda_stream)
    _check(err, "add")
    launches["add"] += 1


def resolve(film, spp):
    """The film over spp -> (image uint8, mean float32), each of film's shape, on its device."""
    dev = film.device
    if dev.type != "cuda":
        return resolve_plain(film, spp)
    _need("film", film, torch.float64, dev)
    img = torch.empty(film.shape, dtype=torch.uint8, device=dev)
    mean = torch.empty(film.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib().tpupt_film_resolve(film.data_ptr(), film.numel(), spp, mean.data_ptr(), img.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
    _check(err, "resolve")
    launches["resolve"] += 1
    return img, mean
