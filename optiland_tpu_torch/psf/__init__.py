from optiland_tpu_torch.psf.fft import FFTPSF, ScalarFFTPSF, calculate_grid_size
from optiland_tpu_torch.psf.huygens import HuygensPSF, ScalarHuygensPSF
from optiland_tpu_torch.psf.mmdft import MMDFTPSF

__all__ = ["FFTPSF", "ScalarFFTPSF", "HuygensPSF", "ScalarHuygensPSF",
           "MMDFTPSF", "calculate_grid_size"]
