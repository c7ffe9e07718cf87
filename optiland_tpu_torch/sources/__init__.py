from optiland_tpu_torch.sources.smf import SMFSource
from optiland_tpu_torch.sources.base import BaseSource

__all__ = ["BaseSource", "SMFSource"]
