"""Boundaries of the PyTorch port: `optiland_tpu_torch` and `chip_smoke.py`
import neither JAX nor the JAX package, and entry points refuse to run on
a missing card instead of falling back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "optax", "optiland_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in _FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "optiland_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_files_import_no_jax():
    bad = []
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad
    assert not _forbidden("optiland_tpu_torch.trace")
    assert _forbidden("optiland_tpu.trace") and _forbidden("jax.numpy")


def test_import_leaves_jax_unloaded():
    code = ("import sys, optiland_tpu_torch, optiland_tpu_torch.trace.fused, "
            "optiland_tpu_torch.optimization.merits, optiland_tpu_torch.psf, "
            "optiland_tpu_torch.mtf, optiland_tpu_torch.wavefront, "
            "optiland_tpu_torch.tools.vpu_peak, "
            "optiland_tpu_torch.tools.kernel_turns, "
            "optiland_tpu_torch.tools.system_probes, "
            "optiland_tpu_torch.models, optiland_tpu_torch.trace.aiming, "
            "optiland_tpu_torch.system.solves, "
            "optiland_tpu_torch.system.multiconfig, "
            "optiland_tpu_torch.system.converters, "
            "optiland_tpu_torch.system.aberrations, "
            "optiland_tpu_torch.core.apodization, "
            "optiland_tpu_torch.analysis, optiland_tpu_torch.colorimetry, "
            "optiland_tpu_torch.mtf.geometric, optiland_tpu_torch.parallel, "
            "optiland_tpu_torch.parallel.dryrun, optiland_tpu_torch.sources, "
            "optiland_tpu_torch.fileio, optiland_tpu_torch.ml, "
            "optiland_tpu_torch.visualization\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'optiland_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_defaults_to_cuda(monkeypatch):
    from optiland_tpu_torch.system.optic import Optic

    lens = Optic()
    lens.add_surface(index=0, thickness=float("inf"))
    lens.add_surface(index=1, radius=50.0, thickness=5.0, material=1.5,
                     is_stop=True)
    lens.add_surface(index=2)
    lens.set_aperture("EPD", 10.0)
    lens.add_wavelength(0.55)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lens.build()
    from optiland_tpu_torch.psf import ScalarHuygensPSF

    with pytest.raises(RuntimeError, match="CUDA"):
        ScalarHuygensPSF(lens, (0, 0), num_rays=4, image_size=2)
    from optiland_tpu_torch.tools import vpu_peak

    with pytest.raises(RuntimeError, match="CUDA"):
        vpu_peak.main()
    with pytest.raises(ValueError, match="CPU"):
        vpu_peak.run("fma", device="cpu")
    from optiland_tpu_torch.tools import kernel_turns

    with pytest.raises(RuntimeError, match="card"):
        kernel_turns.main(["--parent", "."])
    from optiland_tpu_torch.tools import system_probes

    with pytest.raises(RuntimeError, match="card"):
        system_probes.main(["--parent", "."])
    static, params = lens.build(device="cpu")
    assert params.cv.device.type == "cpu"
