"""The analyses (port of `optiland_tpu/analysis/`): spot diagrams, ray fans,
distortion, field curvature, encircled energy, the vs-field and
through-focus sweeps, pupil aberration, Y-Ybar, irradiance, radiant
intensity, the Jones pupil and image simulation. Each class builds on the
CUDA card unless given `device="cpu"`."""

from optiland_tpu_torch.analysis.spot import SpotDiagram
from optiland_tpu_torch.analysis.fans import BestFitRayFan, RayFan
from optiland_tpu_torch.analysis.distortion import Distortion, GridDistortion
from optiland_tpu_torch.analysis.field_curvature import FieldCurvature
from optiland_tpu_torch.analysis.rms_vs_field import (
    RmsSpotSizeVsField,
    RmsWavefrontErrorVsField,
)
from optiland_tpu_torch.analysis.encircled_energy import EncircledEnergy
from optiland_tpu_torch.analysis.y_ybar import YYbar
from optiland_tpu_torch.analysis.through_focus import (
    ThroughFocusMTF,
    ThroughFocusSpotDiagram,
)
from optiland_tpu_torch.analysis.pupil_aberration import (
    AngleVsHeight,
    FieldIncidentAngleVsHeight,
    PupilAberration,
    PupilIncidentAngleVsHeight,
)
from optiland_tpu_torch.analysis.irradiance import IncoherentIrradiance
from optiland_tpu_torch.analysis.intensity import RadiantIntensity
from optiland_tpu_torch.analysis.jones_pupil import JonesPupil
from optiland_tpu_torch.analysis.mtf_vs_field import MTFvsField
from optiland_tpu_torch.analysis.image_simulation import (
    DistortionWarper,
    ImageSimulationEngine,
    PSFBasisGenerator,
    SpatiallyVariableSimulator,
)

__all__ = [
    "ImageSimulationEngine",
    "PSFBasisGenerator",
    "SpatiallyVariableSimulator",
    "DistortionWarper",
    "SpotDiagram",
    "BestFitRayFan",
    "RayFan",
    "Distortion",
    "GridDistortion",
    "FieldCurvature",
    "RmsSpotSizeVsField",
    "RmsWavefrontErrorVsField",
    "EncircledEnergy",
    "YYbar",
    "ThroughFocusSpotDiagram",
    "ThroughFocusMTF",
    "PupilAberration",
    "AngleVsHeight",
    "FieldIncidentAngleVsHeight",
    "PupilIncidentAngleVsHeight",
    "IncoherentIrradiance",
    "RadiantIntensity",
    "JonesPupil",
    "MTFvsField",
]
