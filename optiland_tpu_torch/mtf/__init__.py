from optiland_tpu_torch.mtf.fft import (
    FFTMTF,
    ScalarFFTMTF,
    VectorialFFTMTF,
    get_working_FNO,
)
from optiland_tpu_torch.mtf.geometric import GeometricMTF
from optiland_tpu_torch.mtf.huygens import HuygensMTF
from optiland_tpu_torch.mtf.sampled import SampledMTF

__all__ = ["FFTMTF", "ScalarFFTMTF", "VectorialFFTMTF", "get_working_FNO",
           "GeometricMTF", "HuygensMTF", "SampledMTF"]
