"""Numpy -> SceneData bridge.

Builds the port's SceneData from a compiled scene given as numpy arrays and static
facts — the port's own compiler output, or the reference package's SceneData
fields converted with ``np.asarray``. Feeding both packages one compiled scene
separates "the renderers agree" from "the compilers agree". The reference's
packed cluster blocks (``tri_pk``, ``tri_pk2``) are relaid into the port's
``tri_geo``/``tri_attr`` when those are absent.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import NP_REAL
from . import data as D

_FLOAT_DTYPES = (np.float16, np.float32, np.float64)


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype in _FLOAT_DTYPES:
        a = a.astype(NP_REAL)
    elif a.dtype != np.bool_:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a writable copy, 0-d kept


def scene_data_from_numpy(fields: dict, static: dict, device=None) -> D.SceneData:
    """fields: numpy arrays by SceneData field name; static: the static facts by
    name (extra names are ignored in both). Float arrays become REAL tensors."""
    dev = resolve_device(device)
    if "tri_geo" not in fields and "tri_pk" in fields:
        from ..ops.tri_kernel import from_reference_packing

        geo, attr = from_reference_packing(fields["tri_pk"], fields["tri_pk2"])
        fields = dict(fields, tri_geo=geo, tri_attr=attr)
    missing = [n for n in D.tensor_fields() if n not in fields]
    if missing:
        raise KeyError(f"scene fields missing: {missing}")
    tensors = {n: _to_tensor(fields[n], dev) for n in D.tensor_fields()}
    facts = {n: static[n] for n in D.STATIC_FIELDS + D.PORT_STATIC_FIELDS if n in static}
    if "mat_types" in facts:
        facts["mat_types"] = tuple(int(t) for t in facts["mat_types"])
    return D.SceneData(**tensors, **facts)


def params_from_numpy(params: dict, device=None) -> dict:
    """Differentiable parameters as numpy arrays by field name (the reference's
    ``init_params`` pytree through ``np.asarray``) -> float32 tensors on `device`."""
    dev = resolve_device(device)
    return {n: torch.from_numpy(np.array(v, dtype=np.float32, order="C")).to(dev)
            for n, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """Parameters or gradients by field name -> float32 numpy arrays."""
    return {n: v.detach().cpu().numpy() for n, v in params.items()}
