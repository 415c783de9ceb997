from .data import SceneData, CameraData  # noqa: F401
from . import builder  # noqa: F401
