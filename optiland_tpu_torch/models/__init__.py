"""Sample lens systems (port of `optiland_tpu/models`): the objectives
and the 26 lenses of the zoo."""

from optiland_tpu_torch.models.objectives import (
    CookeTriplet,
    DoubleGauss,
    ReverseTelephoto,
)
from optiland_tpu_torch.models.zoo import (
    AsphericSinglet,
    CementedAchromat,
    Edmund_49_847,
    EyepieceErfle,
    HeliarLens,
    HubbleTelescope,
    InfraredTriplet,
    InfraredTripletF4,
    LensWithFieldCorrector,
    Microscope20x,
    NavarroWideAngleEye,
    Objective60x,
    ObjectiveUS008879901,
    PetzvalLens,
    ProjectionLens120FOV,
    ProjectionLens160FOV,
    SingletStopSurf2,
    Telephoto,
    TelescopeDoublet,
    TelescopeObjective48Inch,
    TessarLens,
    TripletTelescopeObjective,
    UVProjectionLens,
    UVReflectingMicroscope,
    WideAngle100FOV,
    WideAngle170FOV,
)

__all__ = [
    "CookeTriplet", "DoubleGauss", "ReverseTelephoto",
    "TripletTelescopeObjective", "ObjectiveUS008879901",
    "TelescopeObjective48Inch", "HeliarLens", "TessarLens",
    "LensWithFieldCorrector", "PetzvalLens", "Telephoto",
    "WideAngle100FOV", "ProjectionLens120FOV", "ProjectionLens160FOV",
    "WideAngle170FOV", "EyepieceErfle", "InfraredTriplet",
    "InfraredTripletF4", "UVProjectionLens", "Objective60x",
    "Microscope20x", "UVReflectingMicroscope", "NavarroWideAngleEye",
    "Edmund_49_847", "SingletStopSurf2", "TelescopeDoublet",
    "CementedAchromat", "AsphericSinglet", "HubbleTelescope",
]
