"""Multi-configuration (zoom) systems.

Port of `optiland_tpu/system/multiconfig.py` (the reference's
`multiconfig/multi_configuration.py:25`):
a list of Optic configurations where new configurations deep-copy a source
and are linked back by pickups, so shared parameters track the source until
explicitly overridden (e.g. a zoom gap).
"""

from __future__ import annotations

import copy


class CrossPickup:
    """target_optic.surface.attr := source_optic.surface.attr * scale
    + offset."""

    def __init__(self, source_optic, source_surface_idx, attr_type,
                 target_optic, target_surface_idx, scale=1.0, offset=0.0):
        self.source_optic = source_optic
        self.source_surface_idx = source_surface_idx
        self.attr_type = attr_type
        self.target_optic = target_optic
        self.target_surface_idx = target_surface_idx
        self.scale = scale
        self.offset = offset

    def apply(self):
        val = getattr(
            self.source_optic.surfaces.specs[self.source_surface_idx],
            self.attr_type,
        )
        setattr(
            self.target_optic.surfaces.specs[self.target_surface_idx],
            self.attr_type, val * self.scale + self.offset,
        )
        self.target_optic._dirty()


class MultiConfiguration:
    def __init__(self, base_optic):
        self.configurations = [base_optic]
        self.cross_pickups: list[CrossPickup] = []

    def __len__(self):
        return len(self.configurations)

    def add_configuration(self, source_config_idx: int = 0,
                          link: bool = True,
                          unlink: tuple[tuple[int, str], ...] = ()):
        """Deep-copy a configuration; link its radius/conic/thickness back to
        the source by pickups, except the (surface, attr) pairs in `unlink`
        (those are the zoom variables)."""
        source = self.configurations[source_config_idx]
        new = copy.deepcopy(source)
        new.name = f"{source.name}_cfg{len(self.configurations)}"
        self.configurations.append(new)
        if link:
            skip = set(unlink)
            for i in range(len(source.surfaces)):
                for attr in ("radius", "conic", "thickness"):
                    if (i, attr) in skip:
                        continue
                    self.cross_pickups.append(CrossPickup(
                        source, i, attr, new, i))
        return new

    def update(self):
        """Re-apply all cross-configuration pickups and per-config updates."""
        for p in self.cross_pickups:
            p.apply()
        for c in self.configurations:
            c.update()

    def trace_all(self, **kwargs):
        """Each configuration's `trace(**kwargs)` (pass `device=` there)."""
        return [c.trace(**kwargs) for c in self.configurations]
