from optiland_tpu_torch.wavefront.core import WavefrontData, wavefront_data
from optiland_tpu_torch.wavefront.opd import OPD, OPDFan, ZernikeOPD

__all__ = ["WavefrontData", "wavefront_data", "OPD", "OPDFan", "ZernikeOPD"]
