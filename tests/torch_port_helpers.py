"""Shared fixtures of the PyTorch-port tests (tests/test_torch_*.py): lens
prescriptions written once against the builder API that both packages
share, and a builder that makes the same system in both. JAX is imported
only by the functions that build the JAX side, so the tests on the card
(tests/test_torch_cuda.py) run where JAX is not installed."""

import importlib.util
import math
from contextlib import contextmanager
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import torch

from optiland_tpu_torch.system.optic import Optic as TOptic
from optiland_tpu_torch.system.spec import params_from_numpy, static_from_dict


def _load_smoke():
    """The repository's chip_smoke.py as a module (loaded, not run): its
    phase systems and its float64 check of a backward kernel's cotangents
    serve the card tests as they serve the smoke."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


def bench_lens(Optic, vignetted=False):
    """The 10-surface, 4-even-asphere prescription the benchmark traces
    (a copy: the benchmark module sets the JAX precision globally);
    `vignetted` gives the 14 degree field vignetting factors vx = vy = 0.1,
    as chip_smoke.py's vignetted bench lens."""
    lens = Optic("Bench10")
    inf = math.inf
    asph = (1e-7, -2e-11, 3e-15)
    lens.add_surface(index=0, radius=inf, thickness=inf)
    lens.add_surface(index=1, radius=56.20238, thickness=8.75, material=1.617,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=2, radius=152.28580, thickness=0.5)
    lens.add_surface(index=3, radius=37.68262, thickness=12.5, material=1.607)
    lens.add_surface(index=4, radius=inf, thickness=3.8, material=1.603,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=5, radius=24.23130, thickness=16.369445)
    lens.add_surface(index=6, radius=inf, thickness=13.747957, is_stop=True)
    lens.add_surface(index=7, radius=-28.37731, thickness=3.8, material=1.603,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=8, radius=inf, thickness=11, material=1.620,
                     surface_type="even_asphere", coefficients=asph)
    lens.add_surface(index=9, radius=-37.92546, thickness=0.5)
    lens.add_surface(index=10, radius=177.41176, thickness=7, material=1.620)
    lens.add_surface(index=11, radius=-79.41143, thickness=61.487536)
    lens.add_surface(index=12)
    lens.set_aperture(aperture_type="imageFNO", value=5)
    lens.set_field_type("angle")
    lens.add_field(y=0)
    if vignetted:
        lens.add_field(y=14, vx=0.1, vy=0.1)
    else:
        lens.add_field(y=14)
    lens.add_wavelength(value=0.5876, is_primary=True)
    return lens


def singlet_lens(Optic, field_type="angle", object_distance=math.inf,
                 asphere=True, odd=False, tilt=False, decenter=False,
                 mirror=False, aperture=None, max_field=5.0):
    """The asphere singlet of tests/test_fused_kernel.py (`_singlet`), with
    two fields (0 and `max_field`) and optional odd asphere, tilt, decenter,
    mirror and clear aperture."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=object_distance)
    kw = {}
    if asphere:
        kw = dict(surface_type="odd_asphere" if odd else "even_asphere",
                  coefficients=(1e-6, -1e-9))
    if tilt:
        kw["rx"] = 0.02
        kw["ry"] = -0.01
    if decenter:
        kw["dx"] = 0.3
        kw["dy"] = -0.2
    if aperture is not None:
        kw["aperture"] = aperture
    if mirror:
        lens.add_surface(index=1, radius=-100.0, material="mirror",
                         is_stop=True, thickness=-40.0, **kw)
        lens.add_surface(index=2, radius=math.inf, thickness=0.0)
        lens.add_surface(index=3)
    else:
        lens.add_surface(index=1, radius=50.0, thickness=5.0, material=1.52,
                         is_stop=True, **kw)
        lens.add_surface(index=2, radius=-50.0, thickness=47.0)
        lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type(field_type)
    lens.add_field(y=0.0)
    lens.add_field(y=max_field)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def tabulated_doublet(Optic):
    """A cemented doublet of two absorbing glasses (the port's MaterialSpec):
    a tabulated n(w) glass (formula 10) and an Abbe-model glass (formula
    11), with extinction tables of 5 and 3 points (the shorter one
    padded)."""
    from optiland_tpu_torch.materials import catalog as cat

    wl = (0.4, 0.5, 0.6, 0.7)
    tab = cat.MaterialSpec(
        10, wl + (1.53, 1.52, 1.515, 1.51), name="tabulated",
        k_table=(wl + (0.8,), (3e-7, 2e-7, 1e-7, 1e-7, 2e-7)))
    abbe = cat.abbe_material(1.62, 36.4)
    abbe = cat.MaterialSpec(abbe.formula, abbe.coefficients, name=abbe.name,
                            k_table=((0.45, 0.55, 0.65), (4e-7, 2e-7, 3e-7)))
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=40.0, thickness=6.0, material=tab,
                     is_stop=True)
    lens.add_surface(index=2, radius=-30.0, thickness=2.5, material=abbe)
    lens.add_surface(index=3, radius=-150.0, thickness=60.0)
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def coated_singlet(Optic, T=0.9, R=0.05, mirror=False):
    """The singlet of tests/test_fused_kernel.py (`_singlet`, conic) with
    the simple coating (T, R) on its interacting surfaces; `mirror` makes
    surface 1 the concave mirror (whose factor is R). Fields 0 and 5."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    coat = ("simple", T, R)
    if mirror:
        lens.add_surface(index=1, radius=-100.0, material="mirror",
                         is_stop=True, thickness=-40.0, coating=coat)
        lens.add_surface(index=2, radius=math.inf, thickness=0.0)
        lens.add_surface(index=3)
    else:
        lens.add_surface(index=1, radius=50.0, thickness=5.0, material=1.52,
                         is_stop=True, coating=coat)
        lens.add_surface(index=2, radius=-50.0, thickness=47.0, coating=coat)
        lens.add_surface(index=3)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=5.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def thin_lens_system(Optic, image_distance=100.0):
    """The ideal thin lens of tests/test_fused_kernel.py
    (`test_fused_thin_lens_parity`), f = 100 mm at the stop, coated, with
    fields 0 and 3 degrees, the image plane `image_distance` after it (at
    its focus by default, where the image does not depend on the pupil)."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, surface_type="paraxial", f=100.0,
                     thickness=image_distance, is_stop=True,
                     coating=("simple", 0.95, 0.02))
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 10.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def plane_grating(Optic):
    """The plane transmission grating of tests/test_fused_kernel.py
    (`test_fused_grating_parity`): order 1, period 2 um, grooves at 0.3
    rad; fields 0 and 3 degrees."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, thickness=30.0, is_stop=True,
                     surface_type="grating", grating_order=1,
                     grating_period=2.0, groove_orientation_angle=0.3)
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def curved_grating(Optic, coating=None):
    """The concave reflective grating of tests/test_fused_kernel.py
    (`test_fused_curved_grating_parity`): R = -100 mm, order -1, period 5
    um; fields 0 and 2 degrees; `coating` on the grating (a reflective
    grating takes T, as in JAX)."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=-100.0, thickness=30.0, is_stop=True,
                     surface_type="grating", material="mirror",
                     grating_order=-1, grating_period=5.0,
                     groove_orientation_angle=0.0, coating=coating)
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=2.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def coat(lens, coating=("simple", 0.98, 0.01)):
    """`lens` (either package's `Optic`) with `coating` on each of its
    interacting surfaces, 1 .. S-2."""
    for spec in lens.surfaces.specs[1:-1]:
        spec.coating = coating
    lens._dirty()
    return lens


def coated_cooke(Optic):
    """The Cooke triplet of `Optic`'s package (the flagship) with the simple
    coating (T, R) = (0.98, 0.01) on each of its six refracting
    surfaces."""
    import importlib

    models = importlib.import_module(Optic.__module__.split(".")[0]
                                     + ".models")
    return coat(models.CookeTriplet())


def spectrograph(Optic, vignetted=False):
    """A thin-lens transmission-grating spectrograph: a slit 100 mm before
    a thin-lens collimator (f = 100 mm, at the stop, EPD 20), a plane
    grating of 600 lines/mm in first order 20 mm after it, a thin-lens
    camera (f = 100 mm) 20 mm after that and the image plane 98 mm after
    the camera, 2 mm inside its focus (at the focus of ideal lenses the
    spot is a point whatever the pupil, and so its merit and the pupil's
    cotangents are 0); object heights 0, 0.5 and 1 mm, wavelengths 0.48,
    0.55 and 0.65 um; `vignetted` gives the 1 mm field vx = vy = 0.1. The
    same prescription as chip_smoke.py's system B."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=100.0)
    lens.add_surface(index=1, surface_type="paraxial", f=100.0,
                     thickness=20.0, is_stop=True)
    lens.add_surface(index=2, radius=math.inf, thickness=20.0,
                     surface_type="grating", grating_order=1,
                     grating_period=1e3 / 600.0,
                     groove_orientation_angle=0.0)
    lens.add_surface(index=3, surface_type="paraxial", f=100.0,
                     thickness=98.0)
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 20.0)
    lens.set_field_type("object_height")
    lens.add_field(y=0.0)
    lens.add_field(y=0.5)
    if vignetted:
        lens.add_field(y=1.0, vx=0.1, vy=0.1)
    else:
        lens.add_field(y=1.0)
    for w in (0.48, 0.55, 0.65):
        lens.add_wavelength(w, is_primary=w == 0.55)
    return lens


def phase_sheet(Optic, profile):
    """The plane phase sheet of tests/test_fused_kernel.py
    (`test_fused_phase_parity`) with `profile`: at the stop, EPD 6, the
    image plane 40 mm after it; fields 0 and 3 degrees."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, thickness=40.0, is_stop=True,
                     surface_type="phase", phase_profile=profile)
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 6.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=3.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


# the profiles of `test_fused_phase_parity`
PHASE_PROFILES = {"radial": ("radial", [-5e2, 1e-1]),
                  "linear_grating": ("linear_grating", 0.0, 3e3),
                  "constant": ("constant", 2.5)}
# chip_smoke.py's systems D-F of phase j4, defined there once: the hybrid
# achromat, the coated metalens on a conic carrier and the tilted
# reflective linear-grating sheet (with its vignetted twin), and the
# wavenumber at 0.55 um (1/mm) that their prescriptions use
K0_055 = SMOKE.K0_055
hybrid_achromat = SMOKE.hybrid_achromat
curved_metalens = SMOKE.curved_metalens
phase_mirror = SMOKE.phase_mirror


def jax_build_f64(lens):
    """Build a JAX-package lens in float64 whatever the JAX precision
    global holds, and restore it."""
    with jax_f64():
        return lens.build()


def carry_across(static, params, device="cpu", dtype=torch.float64):
    """The JAX system's tables as the port's (static_from_dict +
    params_from_numpy)."""
    ts = static_from_dict({f.name: getattr(static, f.name)
                           for f in fields(static)})
    arrays = {f.name: np.asarray(getattr(params, f.name))
              for f in fields(params) if getattr(params, f.name) is not None}
    return ts, params_from_numpy(arrays, device, dtype)


def build_both(make, newton_iters=None):
    """((jax static, jax params), (port static, port params)) of the lens
    `make(Optic)` builds, float64, port on the CPU. The port's own builder
    must reproduce the JAX tables exactly (checked here), and the returned
    port system is the one carried across from the JAX tables."""
    from optiland_tpu.system.optic import Optic as JOptic

    js, jp = jax_build_f64(make(JOptic))
    ts_own, tp_own = make(TOptic).build(device="cpu")
    ts, tp = carry_across(js, jp)
    assert ts_own == ts
    for f in fields(tp):
        a, b = getattr(tp_own, f.name), getattr(tp, f.name)
        if f.name in ("k_wl", "k_val"):
            continue  # padding of tables the ported surface types never read
        assert torch.equal(a, b), f.name
    if newton_iters is not None:
        js = replace(js, newton_iters=newton_iters)
        ts = replace(ts, newton_iters=newton_iters)
    return (js, jp), (ts, tp)


@contextmanager
def jax_f64():
    """The JAX package's precision global at float64, restored after."""
    import optiland_tpu

    prev = optiland_tpu.get_dtype()
    optiland_tpu.set_precision("float64")
    try:
        yield
    finally:
        optiland_tpu.set_precision(
            "float32" if prev == np.float32 else "float64")


def assert_close(got, ref, tol, label="", scale=None):
    """|got - ref| <= tol * scale elementwise; `scale` defaults to the
    largest |ref| (a tensor, JAX or numpy array, or a number each)."""
    got = (got.detach().cpu().numpy() if torch.is_tensor(got)
           else np.asarray(got))
    ref = np.asarray(ref)
    assert got.shape == ref.shape, label
    if scale is None:
        scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=label)


# the systems of phase j7 of chip_smoke.py, defined there once: the fold
# mirror placed by absolute coordinates, the apodized singlet and the Cooke
# triplet with image-height fields
fold_mirror = SMOKE.fold_mirror
apodized_singlet = SMOKE.apodized_singlet
image_height_cooke = SMOKE.image_height_cooke


def aimed_singlet(Optic):
    """An N-BK7 singlet (R 40 and -120 mm, 6 mm thick) with its stop 10 mm
    behind it, EPD 12, fields 0 and 30 degrees, 0.55 um: five surfaces whose
    paraxially aimed rays miss their stop targets at 30 degrees, the
    system of the aimers' parity tests."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=40.0, thickness=6.0, material="N-BK7")
    lens.add_surface(index=2, radius=-120.0, thickness=10.0)
    lens.add_surface(index=3, radius=math.inf, thickness=40.0, is_stop=True)
    lens.add_surface(index=4)
    lens.set_aperture("EPD", 12.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=30.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def telecentric_singlet(Optic):
    """The singlet of `singlet_lens` (n 1.52, R +-50 mm, no asphere) 20 mm
    behind an object of heights 0 and 1 mm, object-space telecentric,
    objectNA 0.1."""
    lens = singlet_lens(Optic, field_type="object_height",
                        object_distance=20.0, asphere=False, max_field=1.0)
    lens.set_aperture("objectNA", 0.1)
    lens.set_telecentric(True)
    return lens


def image_height_singlet(Optic, field_type):
    """The singlet of `singlet_lens` (no asphere) with fields 0 and 3 mm
    read as image heights (`field_type` "paraxial_image_height" or
    "real_image_height")."""
    return singlet_lens(Optic, field_type=field_type, asphere=False,
                        max_field=3.0)


def masked_plates(Optic, aps, masks):
    """A stack of flat air surfaces 2 mm apart behind an object at
    infinity, each clipped by one of `masks` (a list of callables taking
    the aperture module `aps`, `system/apertures.py` of either package),
    the stop on the first; EPD 12, fields 0 and 10 degrees, 0.55 um, the
    image plane 10 mm behind the last."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    for k, mask in enumerate(masks, 1):
        lens.add_surface(index=k, radius=math.inf, thickness=2.0,
                         is_stop=k == 1, aperture=mask(aps))
    lens.surfaces[len(masks)].thickness = 10.0
    lens.add_surface(index=len(masks) + 1)
    lens.set_aperture("EPD", 12.0)
    lens.set_field_type("angle")
    lens.add_field(y=0.0)
    lens.add_field(y=10.0)
    lens.add_wavelength(0.55, is_primary=True)
    return lens


def cooke_tolerancing(pkg, lens):
    """tests/test_tolerancing.py's fixture on `lens` (the Cooke triplet) in
    package `pkg`'s `tolerancing`: R1 and the gap after surface 4 drawn
    from normals, f2 and the on-axis RMS spot at 0.55 um."""
    t = pkg.Tolerancing(lens)
    t.add_perturbation("radius", pkg.NormalSampler(22.01359, 0.05),
                       surface_number=1)
    t.add_perturbation("thickness", pkg.NormalSampler(4.75041, 0.02),
                       surface_number=4)
    t.add_operand("f2")
    t.add_operand("rms_spot_size", input_data={
        "surface_number": -1, "Hx": 0, "Hy": 0.0, "num_rays": 3,
        "wavelength": 0.55})
    return t


def monte_carlo_rank(dev, draws, seed):
    """One spawned rank (`parallel.dryrun.spawn`): the port's Monte Carlo
    of `cooke_tolerancing` with its draws split over a ("rays",) mesh of
    every rank; the table's columns and values."""
    from optiland_tpu_torch import tolerancing as ttol
    from optiland_tpu_torch.models import CookeTriplet
    from optiland_tpu_torch.parallel import make_mesh

    lens = CookeTriplet()
    lens.build(device=dev)
    df = ttol.MonteCarlo(cooke_tolerancing(ttol, lens),
                         mesh=make_mesh()).run(draws, seed=seed)
    return {"columns": list(df.columns), "values": torch.tensor(df.to_numpy())}
