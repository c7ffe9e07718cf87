from optiland_tpu_torch.fileio.optiland_handler import (
    load_optiland_file,
    optic_from_dict,
    optic_to_dict,
    save_optiland_file,
)
from optiland_tpu_torch.fileio.zemax import load_zemax_file, save_zemax_file
from optiland_tpu_torch.fileio.codev import load_codev_file, save_codev_file

__all__ = [
    "load_optiland_file",
    "save_optiland_file",
    "optic_to_dict",
    "optic_from_dict",
    "load_zemax_file",
    "save_zemax_file",
    "load_codev_file",
    "save_codev_file",
]
