"""The reference's scene tables: tags, parameter layout, and the table holder.

The tags and the layout of the material parameter rows are those of the Rust
reference renderer's scenes as the port lays them out, so that the frozen shading
code (bsdf.py, lights.py, texture.py) reads them unchanged. ``SceneTables`` holds
every table as a tensor on one device, plus the static facts the shading code
branches on; ``scene.py`` fills it from a configuration file.
"""

from __future__ import annotations

import numpy as np
import torch

REAL = torch.float32
NP_REAL = np.float32

# material type tags
MAT_DIFFUSE = 0
MAT_METAL = 1
MAT_GLASS = 2
MAT_PRINCIPLED = 3
MAT_LIGHT = 4

# texture type tags
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

# geometry kind tags (light table, hit kinds)
GEOM_SPHERE = 0
GEOM_QUAD = 1
GEOM_TRI = 2

# principled parameter vector layout (mat_params columns)
P_METALLIC = 0
P_ROUGHNESS = 1
P_SUBSURFACE = 2
P_SPECULAR = 3
P_SPECULAR_TINT = 4
P_IOR = 5
P_SPEC_TRANS = 6
P_SHEEN = 7
P_SHEEN_TINT = 8
P_CLEARCOAT = 9
P_CLEARCOAT_GLOSS = 10
N_PARAMS = 11


class SceneTables:
    """Tensors (keyword arguments that are numpy arrays go to `device`) and static facts."""

    def __init__(self, device, **fields):
        for key, val in fields.items():
            if isinstance(val, np.ndarray):
                val = torch.as_tensor(val, device=device)
            setattr(self, key, val)
        self.device = torch.device(device)

    @property
    def n_lights(self) -> int:
        return int(self.light_kind.shape[0])
