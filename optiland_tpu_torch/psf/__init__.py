from optiland_tpu_torch.psf.fft import (
    FFTPSF,
    ScalarFFTPSF,
    VectorialFFTPSF,
    calculate_grid_size,
)
from optiland_tpu_torch.psf.huygens import (
    HuygensPSF,
    ScalarHuygensPSF,
    VectorialHuygensPSF,
)
from optiland_tpu_torch.psf.mmdft import MMDFTPSF

__all__ = ["FFTPSF", "ScalarFFTPSF", "VectorialFFTPSF", "HuygensPSF",
           "ScalarHuygensPSF", "VectorialHuygensPSF", "MMDFTPSF",
           "calculate_grid_size"]
