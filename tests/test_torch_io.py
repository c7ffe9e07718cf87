"""The port's `sources/`, `fileio/`, `ml/` and `visualization/` against the
JAX package, float64 on the CPU.

  - `SMFSource`'s rays (the same scrambled Sobol points, erfinv) and
    `trace_source`'s rows through a flat plate at rtol 1e-10 of each
    array's largest entry;
  - `optic_to_dict` equal to JAX's, key for key, for the Cooke triplet, an
    even asphere (the bench lens), a fold mirror placed by absolute
    coordinates and a grating; `from_dict` of it building JAX's tables;
  - the JSON, Zemax and CODE V files that each package writes are the same
    text, and each package's reader builds the same tables from a file of
    the other's (the tests' files are written in `tmp_path`, or are the
    small Zemax literal of a folded system below);
  - `OpticalSystemModule`: loss, gradient, `apply_bounds` and 3 Adam steps
    of `fit` against JAX's `fit` with `optax.adam`, at rtol 1e-10;
  - the viewers under matplotlib's Agg backend: every `Line2D` of
    `OpticViewer.view` on the Cooke triplet, `LensInfoViewer.table_rows`,
    `SurfaceSagViewer.sag_grid` and `OpticViewer3D.build_scene`'s meshes
    and rays at 1e-10 of each array's largest entry;
  - each new class on the CUDA card by default (it raises without one).
"""

import json
import math

import matplotlib
import numpy as np
import pytest
import torch

import jax

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from optiland_tpu import fileio as jio  # noqa: E402
from optiland_tpu import sources as jsrc  # noqa: E402
from optiland_tpu.ml import OpticalSystemModule as JModule  # noqa: E402
from optiland_tpu.models import CookeTriplet as JCooke  # noqa: E402
from optiland_tpu.optimization import (  # noqa: E402
    OptimizationProblem as JProblem,
)
from optiland_tpu.sources.base import (  # noqa: E402
    trace_source as jtrace_source,
)
from optiland_tpu.system.optic import Optic as JOptic  # noqa: E402
from optiland_tpu import visualization as jviz  # noqa: E402
from optiland_tpu_torch import fileio as tio  # noqa: E402
from optiland_tpu_torch import parallel as tpar  # noqa: E402
from optiland_tpu_torch import sources as tsrc  # noqa: E402
from optiland_tpu_torch import visualization as tviz  # noqa: E402
from optiland_tpu_torch.ml import OpticalSystemModule as TModule  # noqa: E402
from optiland_tpu_torch.models import CookeTriplet as TCooke  # noqa: E402
from optiland_tpu_torch.optimization import (  # noqa: E402
    OptimizationProblem as TProblem,
)
from optiland_tpu_torch.sources.base import (  # noqa: E402
    trace_source as ttrace_source,
)
from optiland_tpu_torch.system.optic import Optic as TOptic  # noqa: E402

from torch_port_helpers import (  # noqa: E402
    assert_close,
    bench_lens,
    carry_across,
    fold_mirror,
    jax_build_f64,
    jax_f64,
    plane_grating,
)

RTOL = 1e-10
FORMATS = {"json": ("save_optiland_file", "load_optiland_file"),
           "zmx": ("save_zemax_file", "load_zemax_file"),
           "seq": ("save_codev_file", "load_codev_file")}

# A folded singlet in Zemax's own form: coordinate breaks turn the beam
# 90 degrees at a mirror, which the readers place by absolute coordinates
FOLDED_ZMX = """VERS 240000 3 0
MODE SEQ
NAME folded
UNIT MM X W X CM MR CPMM
ENPD 1.00000000E+01
FTYP 0 0 2 1 0 0 0
XFLN 0.0 0.0
YFLN 0.0 2.0
WAVM 1 5.50000000E-01 1
PWAV 1
SURF 0
  TYPE STANDARD
  CURV 0.0
  DISZ INFINITY
SURF 1
  TYPE STANDARD
  STOP
  CURV 2.00000000E-02
  DISZ 5.00000000E+00
  GLAS N-BK7 1 0 1.5168 64.17
SURF 2
  TYPE STANDARD
  CURV -2.00000000E-02
  DISZ 3.00000000E+01
SURF 3
  TYPE COORDBRK
  PARM 3 4.50000000E+01
  DISZ 0.0
SURF 4
  TYPE STANDARD
  GLAS MIRROR 1 0 0 0
  DISZ 0.0
SURF 5
  TYPE COORDBRK
  PARM 3 4.50000000E+01
  DISZ -4.00000000E+01
SURF 6
  TYPE STANDARD
  DISZ 0.0
"""


def flat_plate(Optic):
    """tests/test_breadth.py's flat plate: the SMF source's test system."""
    lens = Optic()
    lens.add_surface(index=0, radius=math.inf, thickness=math.inf)
    lens.add_surface(index=1, radius=math.inf, thickness=10.0, is_stop=True)
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 4.0)
    lens.add_wavelength(0.55)
    return lens


def cooke(Optic):
    return (JCooke if Optic is JOptic else TCooke)()


LENSES = {"cooke": cooke, "asphere": bench_lens, "fold": fold_mirror,
          "grating": plane_grating}


def assert_same_build(t_lens, j_lens):
    """The port's build of `t_lens` equals JAX's of `j_lens` carried
    across: every static code and every parameter table."""
    ts, tp = t_lens.build(device="cpu")
    js, jp = carry_across(*jax_build_f64(j_lens))
    assert ts == js
    for name in tp.__dataclass_fields__:
        a, b = getattr(tp, name), getattr(jp, name)
        if a is None or b is None or name in ("k_wl", "k_val"):
            continue   # the extinction tables' padding is never read
        assert torch.equal(a, b), name


# -- sources ------------------------------------------------------------------
@pytest.mark.parametrize("point", [False, True], ids=["extended", "point"])
def test_smf_source_matches_jax(point):
    kw = dict(mfd_um=10.0, wavelength_um=1.55, position=(0.1, 0.0, -5.0),
              is_point_source=point)
    with jax_f64():
        jr = jsrc.SMFSource(**kw).generate_rays(200)
        jh = jtrace_source(flat_plate(JOptic), jsrc.SMFSource(**kw), 200)
    tr = tsrc.SMFSource(**kw).generate_rays(200, device="cpu")
    assert tr.x.shape == (256,) and tr.x.dtype == torch.float64
    for k in ("x", "y", "z", "L", "M", "N", "i", "w"):
        assert_close(getattr(tr, k), getattr(jr, k), RTOL, k)
    th = ttrace_source(flat_plate(TOptic), tsrc.SMFSource(**kw), 200,
                       device="cpu")
    for k in ("x", "y", "z", "L", "M", "N", "intensity", "opd"):
        assert_close(getattr(th, k), getattr(jh, k), RTOL, k,
                     scale=max(float(np.abs(np.asarray(getattr(jh, k))).max()),
                               1.0))
    assert abs(th.intensity[-1].sum().item() - 1.0) < 1e-12


def test_smf_source_refuses_no_rays():
    with pytest.raises(ValueError, match="positive"):
        tsrc.SMFSource(10.0, 1.55).generate_rays(0, device="cpu")


def test_sources_names_match_jax():
    assert tsrc.__all__ == jsrc.__all__


# -- fileio -----------------------------------------------------------------
def _as_json(d):
    return json.loads(json.dumps(d, default=float))


@pytest.mark.parametrize("name", list(LENSES))
def test_optic_to_dict_matches_jax(name):
    make = LENSES[name]
    jd, td = _as_json(make(JOptic).to_dict()), _as_json(make(TOptic).to_dict())
    assert td == jd
    assert td == _as_json(tio.optic_to_dict(make(TOptic)))
    assert_same_build(TOptic.from_dict(td), JOptic.from_dict(jd))


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("name", ["cooke", "asphere", "fold"])
def test_files_interchange(tmp_path, fmt, name):
    """Each package's writer writes the same text, and each reader builds,
    from the file of the other, the tables of its own reader's build."""
    save, load = FORMATS[fmt]
    make = LENSES[name]
    jpath, tpath = tmp_path / f"jax.{fmt}", tmp_path / f"port.{fmt}"
    getattr(jio, save)(make(JOptic), str(jpath))
    getattr(tio, save)(make(TOptic), str(tpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    for path in (jpath, tpath):
        assert_same_build(getattr(tio, load)(str(path)),
                          getattr(jio, load)(str(path)))


def test_zemax_coordinate_breaks(tmp_path):
    path = tmp_path / "folded.zmx"
    path.write_text(FOLDED_ZMX)
    t_lens = tio.load_zemax_file(str(path))
    assert t_lens.surfaces.specs[3].abs_cs is not None
    assert_same_build(t_lens, jio.load_zemax_file(str(path)))


def test_material_nd_vd_matches_jax():
    from optiland_tpu.fileio import zemax as jz
    from optiland_tpu.materials.catalog import resolve_material as jres
    from optiland_tpu_torch.fileio import zemax as tz
    from optiland_tpu_torch.materials.catalog import resolve_material as tres

    for glass in ("N-BK7", "SK16", "F2"):
        with jax_f64():
            ref = jz.material_nd_vd(jres(glass))
        np.testing.assert_allclose(tz.material_nd_vd(tres(glass)), ref,
                                   rtol=RTOL)


def test_fileio_names_match_jax():
    assert tio.__all__ == jio.__all__


# -- ml ---------------------------------------------------------------------
def ml_problem(Optic_kind, min_val=1.0, max_val=10.0):
    """tests/test_ml.py's problem: the Cooke triplet's first thickness
    within [min_val, max_val], f2 toward 12."""
    if Optic_kind == "jax":
        lens, problem = JCooke(), JProblem()
    else:
        lens, problem = TCooke(), TProblem()
        lens.build(device="cpu")
    problem.add_variable(lens, "thickness", surface_number=1,
                         min_val=min_val, max_val=max_val)
    problem.add_operand(operand_type="f2", target=12.0, weight=1.0)
    return lens, problem


def test_optical_system_module_matches_jax():
    with jax_f64():
        jl, jp = ml_problem("jax")
        jm = JModule(jl, jp)
        jx = jm.parameters()
        jloss, jgrad = jax.value_and_grad(jm.loss)(jx)
        v = jp.variables[0]
        jclamped = jm.apply_bounds(jax.numpy.asarray(
            [float(v.scaler.scale(100.0))]))
        jfx, jlosses = jm.fit(steps=3, lr=0.05)
        j_after = np.asarray(jl.params.thickness)
    tl, tp = ml_problem("port")
    tm = TModule(tl, tp, device="cpu")
    assert [n for n, _ in tm.named_parameters()] == ["x"]
    assert list(tm.parameters())[0] is tm.x
    assert_close(tm.x, jx, RTOL, "x")
    loss = tm()
    loss.backward()
    assert_close(loss, jloss, RTOL, "loss")
    assert_close(tm.x.grad, jgrad, RTOL, "gradient")
    assert_close(tm.apply_bounds(torch.tensor([float(v.scaler.scale(100.0))],
                                              dtype=torch.float64)),
                 jclamped, RTOL, "apply_bounds")
    tm.x.grad = None
    layer = tm.as_torch_module()
    assert [n for n, _ in layer.named_parameters()] == ["variables"]
    assert_close(layer(), jloss, RTOL, "as_torch_module")
    tfx, tlosses = tm.fit(steps=3, lr=0.05)
    assert_close(tfx, jfx, RTOL, "fit x")
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL)
    after = tl.params.thickness
    assert math.isinf(after[0]) and math.isinf(j_after[0])
    assert_close(after[1:], j_after[1:], RTOL, "synced to the optic")


# -- visualization ------------------------------------------------------------
@pytest.fixture(scope="module")
def viewers():
    """Both packages' viewers of the Cooke triplet (JAX in float64)."""
    with jax_f64():
        jl = JCooke()
        jfig, jax_ = jviz.OpticViewer(jl).view(reference="chief")
        jscene = jviz.OpticViewer3D(jl).build_scene()
        jrows = jviz.LensInfoViewer(jl).table_rows()
        jsag = jviz.SurfaceSagViewer(jl).sag_grid(1)
    tl = TCooke()
    tfig, tax = tviz.OpticViewer(tl, device="cpu").view(reference="chief")
    tscene = tviz.OpticViewer3D(tl, device="cpu").build_scene()
    trows = tviz.LensInfoViewer(tl).table_rows()
    tsag = tviz.SurfaceSagViewer(tl, device="cpu").sag_grid(1)
    yield dict(jax=(jax_, jscene, jrows, jsag),
               port=(tax, tscene, trows, tsag))
    plt.close(jfig)
    plt.close(tfig)


def test_optic_viewer_lines_match_jax(viewers):
    jlines = viewers["jax"][0].get_lines()
    tlines = viewers["port"][0].get_lines()
    assert len(tlines) == len(jlines) > 0
    for k, (t, j) in enumerate(zip(tlines, jlines)):
        for axis in (0, 1):
            assert_close(t.get_data()[axis], j.get_data()[axis], RTOL,
                         f"line {k}", scale=max(np.abs(np.asarray(
                             j.get_data()[axis])).max(), 1.0))
        assert (t.get_color(), t.get_linestyle(), t.get_alpha()) == (
            j.get_color(), j.get_linestyle(), j.get_alpha())


def test_scene_matches_jax(viewers):
    js, ts = viewers["jax"][1], viewers["port"][1]
    assert len(ts.surfaces) == len(js.surfaces)
    for t, j in zip(ts.surfaces, js.surfaces):
        assert t[3] == j[3]
        for a, b in zip(t[:3], j[:3]):
            assert_close(a, b, RTOL, "surface mesh", scale=1.0)
    assert len(ts.edges) == len(js.edges)
    for t, j in zip(ts.edges, js.edges):
        for a, b in zip(t, j):
            assert_close(a, b, RTOL, "edge wall", scale=1.0)
    assert len(ts.rays) == len(js.rays)
    for t, j in zip(ts.rays, js.rays):
        assert t[3] == j[3]
        for a, b in zip(t[:3], j[:3]):
            assert_close(a, b, RTOL, "ray", scale=max(np.abs(b).max(), 1.0))
    np.testing.assert_allclose(ts.extent_z, js.extent_z, rtol=RTOL)
    np.testing.assert_allclose(ts.extent_r, js.extent_r, rtol=RTOL)


def test_table_and_sag_match_jax(viewers):
    assert viewers["port"][2] == viewers["jax"][2]
    (tx, ty, tz, ts), (jx, jy, jz, js) = viewers["port"][3], viewers["jax"][3]
    assert ts == js
    for a, b in ((tx, jx), (ty, jy), (tz, jz)):
        assert_close(a, b, RTOL, "sag grid", scale=1.0)


def test_optic_draw_info_and_draw3d(capsys):
    lens = TCooke()
    fig, ax = lens.draw(device="cpu", projection="XZ", hide_vignetted=True)
    fig3, ax3 = lens.draw3D(device="cpu", num_rays=6)
    rows = lens.info()
    assert len(ax.get_lines()) > 0 and len(rows) == 8
    assert "SK16" in capsys.readouterr().out
    plt.close(fig)
    plt.close(fig3)
    with pytest.raises(ImportError, match="vtk"):
        import sys
        from unittest import mock

        with mock.patch.dict(sys.modules, {"vtk": None}):
            tviz.OpticViewer3D(lens, device="cpu").render_vtk()


def test_themes_match_jax():
    from optiland_tpu.visualization import themes as jthemes
    from optiland_tpu_torch.visualization import themes as tthemes

    assert tthemes.list_themes() == jthemes.list_themes()
    for name in tthemes.list_themes():
        assert (tthemes.resolve_theme(name).to_dict()
                == jthemes.resolve_theme(name).to_dict())
    with tthemes.theme_context("dark") as th:
        assert tthemes.get_active_theme() is th
    assert tthemes.get_active_theme().name == "light"
    assert tviz.__all__ == jviz.__all__


# -- the card by default ------------------------------------------------------
def test_new_classes_default_to_the_card(monkeypatch):
    """Without `device`, every new entry point builds or draws on the CUDA
    card, and raises without one (a mesh too, when no process group
    exists yet)."""
    lens, problem = ml_problem("port")
    src = tsrc.SMFSource(10.0, 1.55)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "OpticViewer": lambda: tviz.OpticViewer(TCooke()).view(),
        "Optic.draw": lambda: TCooke().draw(),
        "OpticViewer3D": lambda: tviz.OpticViewer3D(TCooke()).build_scene(),
        "SurfaceSagViewer": lambda: tviz.SurfaceSagViewer(
            TCooke()).sag_grid(1),
        "SMFSource": lambda: src.generate_rays(4),
        "trace_source": lambda: ttrace_source(flat_plate(TOptic), src, 4),
        "OpticalSystemModule": lambda: TModule(lens, problem),
        "make_mesh": lambda: tpar.make_mesh(),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    plt.close("all")
