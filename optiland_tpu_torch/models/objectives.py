"""Sample objective lens systems.

Port of `optiland_tpu/models/objectives.py`: classic published lens
prescriptions (the designs the reference ships in
`optiland/samples/objectives.py`; prescriptions are public design data).
The Cooke triplet is the flagship system of the repository.
"""

from __future__ import annotations

import math

from optiland_tpu_torch.system.optic import Optic

_INF = math.inf


class CookeTriplet(Optic):
    """Cooke triplet, f/5, 20-degree half field."""

    def __init__(self):
        super().__init__()
        self.surfaces.add(index=0, radius=_INF, thickness=_INF)
        self.surfaces.add(index=1, radius=22.01359, thickness=3.25896, material="SK16")
        self.surfaces.add(index=2, radius=-435.76044, thickness=6.00755)
        self.surfaces.add(index=3, radius=-22.21328, thickness=0.99997,
                          material=("F2", "schott"))
        self.surfaces.add(index=4, radius=20.29192, thickness=4.75041, is_stop=True)
        self.surfaces.add(index=5, radius=79.68360, thickness=2.95208, material="SK16")
        self.surfaces.add(index=6, radius=-18.39533, thickness=42.20778)
        self.surfaces.add(index=7)

        self.set_aperture(aperture_type="EPD", value=10)
        self.fields.set_type(field_type="angle")
        self.fields.add(y=0)
        self.fields.add(y=14)
        self.fields.add(y=20)
        self.wavelengths.add(value=0.48)
        self.wavelengths.add(value=0.55, is_primary=True)
        self.wavelengths.add(value=0.65)


class DoubleGauss(Optic):
    """Double Gauss, f/5."""

    def __init__(self):
        super().__init__()
        self.surfaces.add(index=0, radius=_INF, thickness=_INF)
        self.surfaces.add(index=1, radius=56.20238, thickness=8.75, material="N-SSK2")
        self.surfaces.add(index=2, radius=152.28580, thickness=0.5)
        self.surfaces.add(index=3, radius=37.68262, thickness=12.5, material="N-SK2")
        self.surfaces.add(index=4, radius=_INF, thickness=3.8,
                          material=("F5", "schott"))
        self.surfaces.add(index=5, radius=24.23130, thickness=16.369445)
        self.surfaces.add(index=6, radius=_INF, thickness=13.747957, is_stop=True)
        self.surfaces.add(index=7, radius=-28.37731, thickness=3.8,
                          material=("F5", "schott"))
        self.surfaces.add(index=8, radius=_INF, thickness=11, material="N-SK16")
        self.surfaces.add(index=9, radius=-37.92546, thickness=0.5)
        self.surfaces.add(index=10, radius=177.41176, thickness=7, material="N-SK16")
        self.surfaces.add(index=11, radius=-79.41143, thickness=61.487536)
        self.surfaces.add(index=12)

        self.set_aperture(aperture_type="imageFNO", value=5)
        self.fields.set_type(field_type="angle")
        self.fields.add(y=0)
        self.fields.add(y=10)
        self.fields.add(y=14)
        self.wavelengths.add(value=0.4861)
        self.wavelengths.add(value=0.5876, is_primary=True)
        self.wavelengths.add(value=0.6563)


class ReverseTelephoto(Optic):
    """Reverse telephoto (retrofocus) wide-angle design."""

    def __init__(self):
        super().__init__()
        self.surfaces.add(index=0, radius=_INF, thickness=_INF)
        self.surfaces.add(index=1, radius=1.69111096, thickness=0.08259680,
                          material="N-SK10")
        self.surfaces.add(index=2, radius=0.94414496, thickness=0.8)
        self.surfaces.add(index=3, radius=4.32100401, thickness=0.080256,
                          material="SK15")
        self.surfaces.add(index=4, radius=1.78117621, thickness=0.5)
        self.surfaces.add(index=5, radius=2.64050282, thickness=0.27638160,
                          material="BASF2")
        self.surfaces.add(index=6, radius=-3.86177348, thickness=0.1)
        self.surfaces.add(index=7, radius=1.05627661, thickness=0.2, material="FK3")
        self.surfaces.add(index=8, radius=-4.06933311, thickness=0.2001384)
        self.surfaces.add(index=9, radius=_INF, thickness=0.06688, is_stop=True)
        self.surfaces.add(index=10, radius=-2.61246583, thickness=0.064372,
                          material=("SF15", "hikari"))
        self.surfaces.add(index=11, radius=0.99117409, thickness=0.3)
        self.surfaces.add(index=12, radius=9.03045960, thickness=0.18743120,
                          material="N-LAK12")
        self.surfaces.add(index=13, radius=-1.35680743, thickness=2.35130547)
        self.surfaces.add(index=14)

        self.set_aperture(aperture_type="EPD", value=0.3)
        self.fields.set_type(field_type="angle")
        self.fields.add(y=0)
        self.fields.add(y=21)
        self.fields.add(y=30)
        self.wavelengths.add(value=0.4861)
        self.wavelengths.add(value=0.5876, is_primary=True)
        self.wavelengths.add(value=0.6563)
