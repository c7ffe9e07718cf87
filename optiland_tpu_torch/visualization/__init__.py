from optiland_tpu_torch.visualization.viewer import (
    THEMES,
    LensInfoViewer,
    OpticViewer,
    SurfaceSagViewer,
)
from optiland_tpu_torch.visualization.viewer3d import OpticViewer3D

__all__ = ["OpticViewer", "LensInfoViewer", "OpticViewer3D",
           "SurfaceSagViewer", "THEMES"]
