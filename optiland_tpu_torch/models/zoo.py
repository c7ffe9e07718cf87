"""Prebuilt sample systems (the reference's sample zoo).

Port of `optiland_tpu/models/zoo.py`: the same 26 public lens
prescriptions (literature designs: Laikin, patents, schematic eyes, from
the reference's `optiland/samples/*.py`), each written against the port's
`Optic` builder. Seven need the system core's extras: `WideAngle100FOV`
aims iteratively, `ProjectionLens120FOV`, `ProjectionLens160FOV` and
`WideAngle170FOV` robustly, `UVProjectionLens` is telecentric in object
space, and `UVReflectingMicroscope` and `HubbleTelescope` carry an annular
`RadialAperture`.
"""

# ruff: noqa: E501

from __future__ import annotations

import math

from optiland_tpu_torch.system.apertures import RadialAperture
from optiland_tpu_torch.system.optic import Optic

class TripletTelescopeObjective(Optic):
    """A triplet telescope objective lens design.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=50.098, thickness=4.5, material='N-BK7', is_stop=True)
        self.add_surface(index=2, radius=-983.42, thickness=0.09999999999999964)
        self.add_surface(index=3, radius=56.671, thickness=4.5, material='N-BK7')
        self.add_surface(index=4, radius=-171.15, thickness=5.571)
        self.add_surface(index=5, radius=-97.339, thickness=3.5, material=('SF1', 'schott'))
        self.add_surface(index=6, radius=81.454, thickness=75.132)
        self.add_surface(index=7, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=2.8)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=0.7, x=0.0)
        self.add_field(y=1.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)


class ObjectiveUS008879901(Optic):
    """An objective lens design based on U.S. Patent 8,879,901.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=47.07125235, thickness=5.29811826, material='N-LAF32')
        self.add_surface(index=2, radius=184.28171667, thickness=0.5999999999999996)
        self.add_surface(index=3, radius=29.92177645, thickness=7.136548630000001, material='H-ZLAF52A')
        self.add_surface(index=4, radius=50.4992638, thickness=2.0)
        self.add_surface(index=5, radius=60.5004845, thickness=0.9994167099999984, material='E-SF1')
        self.add_surface(index=6, radius=17.72638376, thickness=9.900000000000002)
        self.add_surface(index=7, radius=math.inf, thickness=8.699999999999996, is_stop=True)
        self.add_surface(index=8, radius=-17.49862241, thickness=1.2993457899999967, material=('SF4', 'hikari'))
        self.add_surface(index=9, radius=1000.00000019, thickness=8.443252640000004, material='M-TAF1')
        self.add_surface(index=10, radius=-28.00122422, thickness=0.10000000000000142)
        self.add_surface(index=11, radius=-141.99976777, thickness=6.799502539999999, material='M-TAF1')
        self.add_surface(index=12, radius=-35.94103045, thickness=0.5159999999999982)
        self.add_surface(index=13, radius=92.00034667, thickness=3.299013610000003, material='Q-LAFPH1S')
        self.add_surface(index=14, radius=-277.85210888, thickness=2.1300000000000026)
        self.add_surface(index=15, radius=-157.24588662, thickness=1.2998042199999986, material='S-FSL5')
        self.add_surface(index=16, radius=740.47397742, thickness=0.25)
        self.add_surface(index=17, radius=19.91929498, thickness=5.593456880000005, material='J-LASF015')
        self.add_surface(index=18, radius=36.48852623, thickness=0.5739999999999981)
        self.add_surface(index=19, radius=45.97532235, thickness=1.0004573100000016, material='E-SF1')
        self.add_surface(index=20, radius=16.39521847, thickness=2.9509999999999934)
        self.add_surface(index=21, radius=33.86131631, thickness=3.2244423100000006, material='H-LAK52')
        self.add_surface(index=22, radius=math.inf, thickness=8.0)
        self.add_surface(index=23, radius=math.inf, thickness=4.0, material='H-LAK52')
        self.add_surface(index=24, radius=math.inf, thickness=3.15317838)
        self.add_surface(index=25, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=2.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=7.574, x=0.0)
        self.add_field(y=10.82, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class TelescopeObjective48Inch(Optic):
    """48-in. Telescope Objective
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=-12.7172, thickness=0.8, material='N-PSK3')
        self.add_surface(index=2, radius=-18.543, thickness=0.014800000000000035)
        self.add_surface(index=3, radius=math.inf, thickness=0.015000000000000013, is_stop=True)
        self.add_surface(index=4, radius=15.758, thickness=1.6701000000000001, material=('CAF2', 'Daimon-20'))
        self.add_surface(index=5, radius=-13.039, thickness=0.04870000000000019)
        self.add_surface(index=6, radius=-12.831, thickness=0.7999999999999998, material='S-LAL18')
        self.add_surface(index=7, radius=-18.543, thickness=1.1799)
        self.add_surface(index=8, radius=9.8197, thickness=0.7999999999999998, material='N-SK16')
        self.add_surface(index=9, radius=8.001, thickness=44.3502)
        self.add_surface(index=10, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=6.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=7.0, x=0.0)
        self.add_field(y=10.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class HeliarLens(Optic):
    """Heliar Lens f/5
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=4.2103, thickness=0.9004, material='N-SK16')
        self.add_surface(index=2, radius=-3.6208, thickness=0.29989999999999994, material='E-LLF6')
        self.add_surface(index=3, radius=29.1869, thickness=0.7587000000000002)
        self.add_surface(index=4, radius=-3.1715, thickness=0.20000000000000018, material='E-LLF6')
        self.add_surface(index=5, radius=3.2083, thickness=0.12639999999999985)
        self.add_surface(index=6, radius=math.inf, thickness=0.26290000000000013, is_stop=True)
        self.add_surface(index=7, radius=43.071, thickness=0.25, material='E-LLF6')
        self.add_surface(index=8, radius=2.4494, thickness=0.8308, material='N-SK16')
        self.add_surface(index=9, radius=-3.2576, thickness=8.506599999999999)
        self.add_surface(index=10, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=5.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=7.0, x=0.0)
        self.add_field(y=10.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class TessarLens(Optic):
    """Tessar Lens f/4.5
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=1.3329, thickness=0.2791, material='N-SK15')
        self.add_surface(index=2, radius=-9.9754, thickness=0.20540000000000003)
        self.add_surface(index=3, radius=-2.0917, thickness=0.08999999999999997, material=('F2', 'schott'))
        self.add_surface(index=4, radius=1.2123, thickness=0.07089999999999996)
        self.add_surface(index=5, radius=math.inf, thickness=0.15339999999999998, is_stop=True)
        self.add_surface(index=6, radius=-7.5205, thickness=0.08999999999999997, material='K10')
        self.add_surface(index=7, radius=1.301, thickness=0.3389000000000001, material='N-SK15')
        self.add_surface(index=8, radius=-1.5218, thickness=3.4025000000000003)
        self.add_surface(index=9, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=4.5)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=10.0, x=0.0)
        self.add_field(y=20.5, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class LensWithFieldCorrector(Optic):
    """5-in. Focal Length, f/3.5 Lens with Field Corrector.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=50.45202, thickness=12.7, material='N-SK16')
        self.add_surface(index=2, radius=159.76853999999997, thickness=12.39012)
        self.add_surface(index=3, radius=math.inf, thickness=2.580639999999999, is_stop=True)
        self.add_surface(index=4, radius=-65.96634, thickness=4.68122, material=('F5', 'schott'))
        self.add_surface(index=5, radius=61.14542, thickness=1.8262600000000049)
        self.add_surface(index=6, radius=147.69338, thickness=8.008619999999993, material='N-SK16')
        self.add_surface(index=7, radius=-55.69204, thickness=68.18629999999999)
        self.add_surface(index=8, radius=48.44034, thickness=12.750799999999998, material='N-SK16')
        self.add_surface(index=9, radius=58.795919999999995, thickness=0.380999999999986)
        self.add_surface(index=10, radius=30.24378, thickness=5.079999999999998, material='N-SK4')
        self.add_surface(index=11, radius=25.173939999999998, thickness=29.438600000000008)
        self.add_surface(index=12, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=3.5)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=5.0, x=0.0)
        self.add_field(y=9.65, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class PetzvalLens(Optic):
    """Petzval lens f/1.4.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=33.6931, thickness=10.16, material='N-LAK12')
        self.add_surface(index=2, radius=-68.37425999999999, thickness=1.5239999999999991)
        self.add_surface(index=3, radius=-50.87112, thickness=4.063999999999998, material=('SF4', 'schott'))
        self.add_surface(index=4, radius=138.42746, thickness=2.539999999999999)
        self.add_surface(index=5, radius=math.inf, thickness=22.857459999999996, is_stop=True)
        self.add_surface(index=6, radius=29.77896, thickness=7.6200000000000045, material='N-LAK12')
        self.add_surface(index=7, radius=-62.489079999999994, thickness=5.64134)
        self.add_surface(index=8, radius=-21.8821, thickness=2.0320000000000036, material=('LF5', 'schott'))
        self.add_surface(index=9, radius=76.29906, thickness=9.959340000000012)
        self.add_surface(index=10, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=1.4)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=3.5, x=0.0)
        self.add_field(y=7.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class Telephoto(Optic):
    """Telephoto lens f/5.6.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=21.81606, thickness=6.0731399999999995, material='N-BK7')
        self.add_surface(index=2, radius=-68.33108, thickness=2.2860000000000005, material='N-BASF2')
        self.add_surface(index=3, radius=77.00771999999999, thickness=1.2217400000000005)
        self.add_surface(index=4, radius=math.inf, thickness=26.28138, is_stop=True)
        self.add_surface(index=5, radius=-14.5161, thickness=2.2860000000000014, material='N-ZK7')
        self.add_surface(index=6, radius=-18.854419999999998, thickness=2.5527000000000015, material='N-LAF33')
        self.add_surface(index=7, radius=-29.03982, thickness=0.3962399999999988)
        self.add_surface(index=8, radius=-432.78551999999996, thickness=2.0142199999999946, material=('SF1', 'schott'))
        self.add_surface(index=9, radius=-70.3453, thickness=62.98183999999999)
        self.add_surface(index=10, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=5.6)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=7.0, x=0.0)
        self.add_field(y=10.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class WideAngle100FOV(Optic):
    """A wide-angle lens design with a 100° field of view.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=8.0107, thickness=0.25, material='N-SK4')
        self.add_surface(index=2, radius=1.1856, thickness=0.9613)
        self.add_surface(index=3, radius=1.6747, thickness=0.3578000000000001, material='SF1')
        self.add_surface(index=4, radius=-7.5157, thickness=0.2136, material='N-SK4')
        self.add_surface(index=5, radius=0.9411, thickness=0.4146000000000001)
        self.add_surface(index=6, radius=-1.7688, thickness=0.33329999999999993, material='SF1')
        self.add_surface(index=7, radius=-1.5531, thickness=0.38629999999999987, material='N-SK4')
        self.add_surface(index=8, radius=-2.2281, thickness=0.9842)
        self.add_surface(index=9, radius=math.inf, thickness=0.10000000000000009, is_stop=True)
        self.add_surface(index=10, radius=13.6803, thickness=0.13999999999999968, material='N-SK4')
        self.add_surface(index=11, radius=-3.4279, thickness=0.06050000000000022)
        self.add_surface(index=12, radius=20.0257, thickness=0.3331999999999997, material='N-SK4')
        self.add_surface(index=13, radius=-0.9258, thickness=0.43740000000000023, material='SF1')
        self.add_surface(index=14, radius=-3.2233, thickness=0.2679)
        self.add_surface(index=15, radius=10.3847, thickness=0.13999999999999968, material='SF1')
        self.add_surface(index=16, radius=2.4272, thickness=0.26090000000000035, material='N-SK4')
        self.add_surface(index=17, radius=-3.8828, thickness=0.01499999999999968)
        self.add_surface(index=18, radius=3.365, thickness=0.3167, material='N-SK4')
        self.add_surface(index=19, radius=-14.7547, thickness=1.5603999999999996)
        self.add_surface(index=20, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=4.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=35.0, x=0.0)
        self.add_field(y=50.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)
        self.set_ray_aiming('iterative')


class ProjectionLens120FOV(Optic):
    """A 120-degree FOV projection lens design.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=28.2482, thickness=0.5, material='N-SK4')
        self.add_surface(index=2, radius=2.2027, thickness=1.4379)
        self.add_surface(index=3, radius=2.7819, thickness=1.1174, material='SF1')
        self.add_surface(index=4, radius=-10.4886, thickness=0.3022, material='N-SK4')
        self.add_surface(index=5, radius=1.2417, thickness=0.7247000000000003)
        self.add_surface(index=6, radius=-2.8768, thickness=0.5087999999999999, material='SF1')
        self.add_surface(index=7, radius=-2.0989, thickness=0.4997999999999996, material='N-SK4')
        self.add_surface(index=8, radius=-4.2448, thickness=0.01499999999999968)
        self.add_surface(index=9, radius=8.4162, thickness=1.1278999999999995, material='N-SK4')
        self.add_surface(index=10, radius=-1.6294, thickness=0.2485999999999997, material='SF1')
        self.add_surface(index=11, radius=-4.5056, thickness=0.5411999999999999)
        self.add_surface(index=12, radius=math.inf, thickness=0.019999999999999574, is_stop=True)
        self.add_surface(index=13, radius=math.inf, thickness=0.16889999999999983, material='N-SK4')
        self.add_surface(index=14, radius=-3.8691, thickness=0.1064999999999996)
        self.add_surface(index=15, radius=-6.6827, thickness=0.20070000000000032, material='N-SK4')
        self.add_surface(index=16, radius=-2.2167, thickness=0.28220000000000045)
        self.add_surface(index=17, radius=-1.6444, thickness=0.18269999999999964, material='SF1')
        self.add_surface(index=18, radius=-3.3466, thickness=0.014899999999999913)
        self.add_surface(index=19, radius=-36.4599, thickness=0.5235000000000003, material='SF1')
        self.add_surface(index=20, radius=5.3765, thickness=0.03730000000000011)
        self.add_surface(index=21, radius=6.4204, thickness=0.6242999999999999, material='N-SK4')
        self.add_surface(index=22, radius=-2.7537, thickness=0.015000000000000568)
        self.add_surface(index=23, radius=5.1876, thickness=0.8475000000000001, material='N-SK4')
        self.add_surface(index=24, radius=math.inf, thickness=2.0)
        self.add_surface(index=25, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=2.8)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=42.0, x=0.0)
        self.add_field(y=60.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)
        self.set_ray_aiming('robust')


class ProjectionLens160FOV(Optic):
    """An f/2 160-degree FOV projection lens.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=38.915, thickness=0.5459, material='N-BK7')
        self.add_surface(index=2, radius=3.6152, thickness=1.6595)
        self.add_surface(index=3, radius=math.inf, thickness=0.6926999999999999, material='N-BK7')
        self.add_surface(index=4, radius=5.2515, thickness=1.4575999999999998)
        self.add_surface(index=5, radius=-5.2515, thickness=0.6927000000000003, material='N-BK7')
        self.add_surface(index=6, radius=math.inf, thickness=4.149400000000001)
        self.add_surface(index=7, radius=5.1075, thickness=0.6999999999999993, material='SF4')
        self.add_surface(index=8, radius=-10.8385, thickness=0.016199999999999548)
        self.add_surface(index=9, radius=2.3897, thickness=0.7443000000000008, material='SF4')
        self.add_surface(index=10, radius=2.2789, thickness=0.11359999999999992)
        self.add_surface(index=11, radius=math.inf, thickness=0.1039999999999992, is_stop=True)
        self.add_surface(index=12, radius=-2.3536, thickness=0.7037999999999993, material='SF1')
        self.add_surface(index=13, radius=2.7829, thickness=0.5423000000000009, material='N-LAK7')
        self.add_surface(index=14, radius=-2.8287, thickness=0.2506000000000004)
        self.add_surface(index=15, radius=13.1578, thickness=0.6349999999999998, material='N-LAK7')
        self.add_surface(index=16, radius=-1.4944, thickness=0.29219999999999935, material='SF4')
        self.add_surface(index=17, radius=-4.8082, thickness=0.06680000000000064)
        self.add_surface(index=18, radius=4.3447, thickness=0.5059000000000005, material='N-LAK21')
        self.add_surface(index=19, radius=72.8673, thickness=2.2375999999999987)
        self.add_surface(index=20, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=2.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=56.0, x=0.0)
        self.add_field(y=80.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)
        self.set_ray_aiming('robust')


class WideAngle170FOV(Optic):
    """A 170-degree FOV, f/1.8 camera lens.
    Prescription from the reference sample `optiland/samples/objectives.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=6.0515, thickness=0.1796, material='N-BK7')
        self.add_surface(index=2, radius=1.2087, thickness=0.9182000000000001)
        self.add_surface(index=3, radius=-9.4697, thickness=0.19389999999999996, material='N-SK5')
        self.add_surface(index=4, radius=1.0053, thickness=0.6402000000000001)
        self.add_surface(index=5, radius=1.6634, thickness=0.4518, material='SF1')
        self.add_surface(index=6, radius=-1.6712, thickness=0.1825000000000001, material='N-LAK9')
        self.add_surface(index=7, radius=1.1206, thickness=2.5272000000000006)
        self.add_surface(index=8, radius=1.3895, thickness=0.25, material='N-LAK9')
        self.add_surface(index=9, radius=0.5522, thickness=0.6047000000000002, material='N-PSK3')
        self.add_surface(index=10, radius=-0.8844, thickness=0.019599999999999618)
        self.add_surface(index=11, radius=-0.8804, thickness=0.08000000000000007, material='SF1')
        self.add_surface(index=12, radius=-2.1545, thickness=0.1200000000000001)
        self.add_surface(index=13, radius=math.inf, thickness=0.1200000000000001, is_stop=True)
        self.add_surface(index=14, radius=1.0354, thickness=0.48299999999999965, material='N-PSK3')
        self.add_surface(index=15, radius=-0.8443, thickness=0.05459999999999976)
        self.add_surface(index=16, radius=-0.7386, thickness=0.1075999999999997, material='SF1')
        self.add_surface(index=17, radius=-1.5285, thickness=0.8308)
        self.add_surface(index=18, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=1.8)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=60.0, x=0.0)
        self.add_field(y=85.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)
        self.set_ray_aiming('robust')


class EyepieceErfle(Optic):
    """An Erfle eyepiece design.
    Prescription from the reference sample `optiland/samples/eyepieces.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=math.inf, thickness=15.224, is_stop=True)
        self.add_surface(index=2, radius=269.0, thickness=25.099999999999998, material='L-BSL7')
        self.add_surface(index=3, radius=-125.9, thickness=36.5)
        self.add_surface(index=4, radius=93.6, thickness=18.5, material='N-BAK2')
        self.add_surface(index=5, radius=-93.6, thickness=4.099999999999994, material='N-F2')
        self.add_surface(index=6, radius=2550.0, thickness=0.18999999999999773)
        self.add_surface(index=7, radius=93.6, thickness=18.5, material='N-BAK2')
        self.add_surface(index=8, radius=-93.6, thickness=4.099999999999994, material='N-F2')
        self.add_surface(index=9, radius=2550.0, thickness=32.68500000000002)
        self.add_surface(index=10, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='EPD', value=4.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=14.0, x=0.0)
        self.add_field(y=20.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)


class InfraredTriplet(Optic):
    """An infrared air-spaced triplet lens.
    Prescription from the reference sample `optiland/samples/infrared.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=10.4578, thickness=0.5901, material=4.002, is_stop=True)
        self.add_surface(index=2, radius=14.1079, thickness=4.3909)
        self.add_surface(index=3, radius=-15.8842, thickness=0.5899999999999999, material=2.4028)
        self.add_surface(index=4, radius=-18.2105, thickness=5.6218)
        self.add_surface(index=5, radius=2.5319, thickness=0.3917999999999999, material=4.002)
        self.add_surface(index=6, radius=2.4308, thickness=1.3064999999999998)
        self.add_surface(index=7, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=2.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=2.8, x=0.0)
        self.add_field(y=4.0, x=0.0)
        self.add_wavelength(value=10.6, is_primary=True)


class InfraredTripletF4(Optic):
    """A 4-inch infrared triplet lens with f/4.
    Prescription from the reference sample `optiland/samples/infrared.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=2.0721, thickness=0.134, material=3.4222)
        self.add_surface(index=2, radius=3.5488, thickness=0.23919999999999997)
        self.add_surface(index=3, radius=math.inf, thickness=0.6105, is_stop=True)
        self.add_surface(index=4, radius=13.7583, thickness=0.10000000000000009, material=4.002)
        self.add_surface(index=5, radius=1.7491, thickness=0.8768)
        self.add_surface(index=6, radius=math.inf, thickness=0.14619999999999989, material=3.4222)
        self.add_surface(index=7, radius=-3.585, thickness=2.8385999999999996)
        self.add_surface(index=8, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=4.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=2.45, x=0.0)
        self.add_field(y=3.5, x=0.0)
        self.add_wavelength(value=4.2, is_primary=True)


class UVProjectionLens(Optic):
    """A UV projection lens for 248 nm lithography.
    Prescription from the reference sample `optiland/samples/lithography.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=110.85883544)
        self.add_surface(index=1, radius=-737.7847, thickness=27.484, material=1.5084)
        self.add_surface(index=2, radius=-235.2891, thickness=0.9160000000000004)
        self.add_surface(index=3, radius=211.1786, thickness=36.646, material=1.5084)
        self.add_surface(index=4, radius=-461.3986, thickness=0.9159999999999968)
        self.add_surface(index=5, radius=412.6778, thickness=21.070999999999998, material=1.5084)
        self.add_surface(index=6, radius=160.5391, thickness=16.197000000000003)
        self.add_surface(index=7, radius=-604.1283, thickness=7.215000000000003, material=1.5084)
        self.add_surface(index=8, radius=218.1877, thickness=23.94099999999999)
        self.add_surface(index=9, radius=-3586.063, thickness=11.978000000000009, material=1.5084)
        self.add_surface(index=10, radius=251.8168, thickness=47.506)
        self.add_surface(index=11, radius=-85.2817, thickness=11.961000000000013, material=1.5084)
        self.add_surface(index=12, radius=584.8597, thickness=9.96799999999999)
        self.add_surface(index=13, radius=4074.801, thickness=35.291, material=1.5084)
        self.add_surface(index=14, radius=-162.0185, thickness=0.9230000000000018)
        self.add_surface(index=15, radius=629.544, thickness=41.227000000000004, material=1.5084)
        self.add_surface(index=16, radius=-226.7397, thickness=0.9159999999999968)
        self.add_surface(index=17, radius=522.2739, thickness=27.841999999999985, material=1.5084)
        self.add_surface(index=18, radius=-582.424, thickness=0.9159999999999968)
        self.add_surface(index=19, radius=423.729, thickness=22.903999999999996, material=1.5084)
        self.add_surface(index=20, radius=-1385.36, thickness=0.9159999999999968, is_stop=True)
        self.add_surface(index=21, radius=212.039, thickness=33.646000000000015, material=1.5084)
        self.add_surface(index=22, radius=802.3695, thickness=55.303999999999974)
        self.add_surface(index=23, radius=-776.5697, thickness=8.702999999999975, material=1.5084)
        self.add_surface(index=24, radius=106.1728, thickness=24.089999999999975)
        self.add_surface(index=25, radius=-200.683, thickness=11.451999999999998, material=1.5084)
        self.add_surface(index=26, radius=311.8264, thickness=59.54000000000002)
        self.add_surface(index=27, radius=-77.2276, thickness=11.772000000000048, material=1.5084)
        self.add_surface(index=28, radius=2317.8032, thickness=11.861999999999966)
        self.add_surface(index=29, radius=-290.8859, thickness=22.903999999999996, material=1.5084)
        self.add_surface(index=30, radius=-148.3577, thickness=1.3730000000000473)
        self.add_surface(index=31, radius=-5658.5043, thickness=41.226999999999975, material=1.5084)
        self.add_surface(index=32, radius=-151.9858, thickness=0.9160000000000537)
        self.add_surface(index=33, radius=678.1005, thickness=32.980999999999995, material=1.5084)
        self.add_surface(index=34, radius=-358.554, thickness=0.9160000000000537)
        self.add_surface(index=35, radius=264.2734, thickness=32.813999999999965, material=1.5084)
        self.add_surface(index=36, radius=2309.6884, thickness=0.9160000000000537)
        self.add_surface(index=37, radius=171.2681, thickness=29.014999999999986, material=1.5084)
        self.add_surface(index=38, radius=364.7765, thickness=0.9180000000000064)
        self.add_surface(index=39, radius=113.37, thickness=76.25900000000001, material=1.5084)
        self.add_surface(index=40, radius=78.6982, thickness=54.303999999999974)
        self.add_surface(index=41, radius=49.5443, thickness=18.649999999999977, material=1.5084)
        self.add_surface(index=42, radius=109.8136, thickness=13.139213673986887)
        self.add_surface(index=43, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='objectNA', value=0.133)
        self.set_field_type('object_height')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=32.0, x=0.0)
        self.add_field(y=48.0, x=0.0)
        self.add_wavelength(value=0.248, is_primary=True)
        self.set_telecentric(True)


class Objective60x(Optic):
    """A 60x microscope objective lens.
    Prescription from the reference sample `optiland/samples/microscopes.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=553.26, thickness=64.9, material='N-FK51')
        self.add_surface(index=2, radius=-247.644, thickness=4.400000000000006)
        self.add_surface(index=3, radius=115.162, thickness=59.400000000000006, material='J-LLF2')
        self.add_surface(index=4, radius=57.131, thickness=17.599999999999994)
        self.add_surface(index=5, radius=math.inf, thickness=17.599999999999994, is_stop=True)
        self.add_surface(index=6, radius=-57.646, thickness=74.79999999999998, material=('SF5', 'schott'))
        self.add_surface(index=7, radius=196.614, thickness=77.0, material='N-FK51')
        self.add_surface(index=8, radius=-129.243, thickness=4.399999999999977)
        self.add_surface(index=9, radius=2062.37, thickness=15.399999999999977, material='N-KZFS4')
        self.add_surface(index=10, radius=203.781, thickness=48.39999999999998, material='LITHOTEC-CAF2')
        self.add_surface(index=11, radius=-224.003, thickness=4.399999999999977)
        self.add_surface(index=12, radius=219.864, thickness=35.19999999999999, material='LITHOTEC-CAF2')
        self.add_surface(index=13, radius=793.3, thickness=4.399999999999977)
        self.add_surface(index=14, radius=349.26, thickness=26.399999999999977, material='N-FK51')
        self.add_surface(index=15, radius=-401.95, thickness=4.399999999999977)
        self.add_surface(index=16, radius=91.992, thickness=39.60000000000002, material='N-SK11')
        self.add_surface(index=17, radius=176.0, thickness=96.18899999999996)
        self.add_surface(index=18, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=0.9)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=0.7, x=0.0)
        self.add_field(y=1.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)


class Microscope20x(Optic):
    """20x Microscope Objective
    Prescription from the reference sample `optiland/samples/microscopes.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=-5.97408, thickness=2.39014, material='N-SK16')
        self.add_surface(index=2, radius=-4.99872, thickness=1.04902, material=('SF4', 'schott'))
        self.add_surface(index=3, radius=-8.257539999999999, thickness=0.25400000000000045)
        self.add_surface(index=4, radius=14.82598, thickness=2.8320999999999996, material='N-SK16')
        self.add_surface(index=5, radius=-23.87854, thickness=0.25400000000000045)
        self.add_surface(index=6, radius=math.inf, thickness=5.67944, is_stop=True)
        self.add_surface(index=7, radius=5.27558, thickness=5.080000000000002, material='N-SK16')
        self.add_surface(index=8, radius=-4.282439999999999, thickness=0.6350000000000016, material=('SF4', 'schott'))
        self.add_surface(index=9, radius=10.43432, thickness=2.4511000000000003)
        self.add_surface(index=10, radius=math.inf, thickness=-0.19644596398682523, material='N-K5')
        self.add_surface(index=11, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='EPD', value=8.0762094)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=0.7, x=0.0)
        self.add_field(y=1.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class UVReflectingMicroscope(Optic):
    """53x UV Reflecting Objective
    Prescription from the reference sample `optiland/samples/microscopes.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=43.7642, thickness=0.889, material=1.498)
        self.add_surface(index=2, radius=73.820274, thickness=24.716739999999998)
        self.add_surface(index=3, radius=4.516882, thickness=-12.687299999999997, material="mirror", is_stop=True)
        self.add_surface(index=4, radius=18.519902, thickness=14.671039999999994, material="mirror", aperture=RadialAperture(r_max=math.inf, r_min=3.8099999999999996))
        self.add_surface(index=5, radius=67.816984, thickness=1.084579999999999, material=1.461)
        self.add_surface(index=6, radius=12.310618, thickness=0.1269999999999989)
        self.add_surface(index=7, radius=6.036817999999999, thickness=4.726939999999999, material=1.461)
        self.add_surface(index=8, radius=219.68307599999997, thickness=0.12699999999999534)
        self.add_surface(index=9, radius=184.34253199999998, thickness=1.4935199999999966, material=1.498)
        self.add_surface(index=10, radius=11.28649, thickness=1.9583399999999997)
        self.add_surface(index=11, radius=math.inf, thickness=0.18034000000000106, material=1.498)
        self.add_surface(index=12, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=0.7)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=2.8, x=0.0)
        self.add_field(y=4.0, x=0.0)
        self.add_wavelength(value=0.27, is_primary=True)


class NavarroWideAngleEye(Optic):
    """Navarro wide-angle schematic eye for 543 nm light.
    Prescription from the reference sample `optiland/samples/miscellaneous.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=7.72, thickness=0.55, conic=-0.26, material=1.3777)
        self.add_surface(index=2, radius=6.5, thickness=3.05, material=1.3391)
        self.add_surface(index=3, radius=math.inf, thickness=0.0, material=1.3391, is_stop=True)
        self.add_surface(index=4, radius=10.2, thickness=4.0, conic=-3.1316, material=1.4222)
        self.add_surface(index=5, radius=-6.0, thickness=16.320299999999996, conic=-1.0, material=1.3377)
        self.add_surface(index=6, radius=-12.0, thickness=0.0, material=1.3377)
        self.set_aperture(aperture_type='float_by_stop', value=3.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=15.0, x=0.0)
        self.add_field(y=30.0, x=0.0)
        self.add_field(y=45.0, x=0.0)
        self.add_field(y=60.0, x=0.0)
        self.add_wavelength(value=0.543, is_primary=True)


class Edmund_49_847(Optic):
    """Edmund Optics 49-847.
    Prescription from the reference sample `optiland/samples/simple.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=19.93, thickness=7.0, material='N-SF11', is_stop=True)
        self.add_surface(index=2, radius=math.inf, thickness=21.48)
        self.add_surface(index=3, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='EPD', value=25.4)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=10.0, x=0.0)
        self.add_field(y=14.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class SingletStopSurf2(Optic):
    """A simple singlet lens with the stop on surface 2.
    Prescription from the reference sample `optiland/samples/simple.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=63.73364157, thickness=10.0, material='LAC9')
        self.add_surface(index=2, radius=653.2939232, thickness=92.7383463, is_stop=True)
        self.add_surface(index=3, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='EPD', value=25.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=3.5, x=0.0)
        self.add_field(y=5.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class TelescopeDoublet(Optic):
    """A telescope doublet lens.
    Prescription from the reference sample `optiland/samples/simple.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=29.32908, thickness=0.7, material='N-BK7', is_stop=True)
        self.add_surface(index=2, radius=-20.06842, thickness=0.03200000000000003)
        self.add_surface(index=3, radius=-20.0877, thickness=0.5780000000000001, material=('SF2', 'schott'))
        self.add_surface(index=4, radius=-66.54774, thickness=47.36493640044575)
        self.add_surface(index=5, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=8.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=0.7, x=0.0)
        self.add_field(y=1.0, x=0.0)
        self.add_wavelength(value=0.4861)
        self.add_wavelength(value=0.5876, is_primary=True)
        self.add_wavelength(value=0.6563)


class CementedAchromat(Optic):
    """A cemented achromatic doublet lens.
    Prescription from the reference sample `optiland/samples/simple.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=12.38401, thickness=0.434, material='N-BAK1', is_stop=True)
        self.add_surface(index=2, radius=-7.9414, thickness=0.321, material=('SF2', 'schott'))
        self.add_surface(index=3, radius=-48.44396, thickness=19.606992633759063)
        self.add_surface(index=4, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='imageFNO', value=6.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=3.5, x=0.0)
        self.add_field(y=5.0, x=0.0)
        self.add_wavelength(value=0.4861327)
        self.add_wavelength(value=0.5875618, is_primary=True)
        self.add_wavelength(value=0.6562725)


class AsphericSinglet(Optic):
    """An aspheric singlet lens.
    Prescription from the reference sample `optiland/samples/simple.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=20.0, thickness=7.0, material='N-SF11', is_stop=True, surface_type="even_asphere", coefficients=(-0.0002248851, -4.690412e-06, -6.404376e-08,))
        self.add_surface(index=2, radius=math.inf, thickness=21.56201105)
        self.add_surface(index=3, radius=math.inf, thickness=0.0)
        self.set_aperture(aperture_type='EPD', value=20.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_wavelength(value=0.587, is_primary=True)


class HubbleTelescope(Optic):
    """Hubble Space Telescope optical design.
    Prescription from the reference sample `optiland/samples/telescopes.py` (public design data)."""

    def __init__(self):
        super().__init__()
        self.add_surface(index=0, radius=math.inf, thickness=math.inf)
        self.add_surface(index=1, radius=math.inf, thickness=4910.01016)
        self.add_surface(index=2, radius=-11040.02286, thickness=-4910.01016, conic=-1.001152, material="mirror", is_stop=True, aperture=RadialAperture(r_max=math.inf, r_min=177.80035))
        self.add_surface(index=3, radius=-1349.31166, thickness=6365.20955, conic=-1.483014, material="mirror")
        self.add_surface(index=4, radius=-635.38227, thickness=0.0)
        self.set_aperture(aperture_type='EPD', value=2400.0)
        self.set_field_type('angle')
        self.add_field(y=0.0, x=0.0)
        self.add_field(y=0.15, x=0.0)
        self.add_wavelength(value=0.55, is_primary=True)

