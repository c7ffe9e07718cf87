"""Visualization themes (port of `optiland_tpu/visualization/themes.py`,
the reference's `visualization/themes.py` + `palettes.py`): named
palettes, a global active theme, a context manager for temporary
switches, and a registry for user themes. Palette keys mirror the
reference's so themed plots carry the same information
(background/axis/text/grid/lens/edges/rays)."""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field

_MPL_CYCLE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
              "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]

# Solarized values are Ethan Schoonover's published standard palette.
_SOLARIZED_ACCENTS = ["#268bd2", "#2aa198", "#859900", "#d33682",
                      "#cb4b16", "#6c71c4"]

light_palette = {
    "background": "#ffffff",
    "axis": "#333333",
    "text": "#222222",
    "grid": "#d0d0d0",
    "lens": "#dbe7f5",
    "edges": "#6f6f6f",
    "aperture": "#c62828",
    "mirror": "#8a8a8a",
    "ray_cycle": list(_MPL_CYCLE),
}

dark_palette = {
    "background": "#1c1c1e",
    "axis": "#e3e3e5",
    "text": "#e3e3e5",
    "grid": "#3a3a3c",
    "lens": "#44505e",
    "edges": "#c9c9cc",
    "aperture": "#ef5350",
    "mirror": "#b0b0b4",
    "ray_cycle": ["#4ea3ff", "#ffb454", "#4cd964", "#ff5f5f", "#b094ff",
                  "#d98a62", "#ff8ad8", "#a0a0a0", "#d9dd55", "#45d4e8"],
}

midnight_palette = {
    "background": "#0b0d12",
    "axis": "#d8dce6",
    "text": "#d8dce6",
    "grid": "#23262e",
    "lens": "#2c3442",
    "edges": "#aeb4c2",
    "aperture": "#ff6b6b",
    "mirror": "#9aa2b4",
    "ray_cycle": ["#62b0ff", "#ffc26e", "#6fe08a", "#ff7d7d", "#c3a8ff",
                  "#e8a27c", "#ff9fe0", "#b5bac8", "#e3e87a", "#63dff0"],
}

solarized_light_palette = {
    "background": "#fdf6e3",
    "axis": "#657b83",
    "text": "#586e75",
    "grid": "#eee8d5",
    "lens": "#e7e0cb",
    "edges": "#657b83",
    "aperture": "#dc322f",
    "mirror": "#93a1a1",
    "ray_cycle": list(_SOLARIZED_ACCENTS),
}

solarized_dark_palette = {
    "background": "#002b36",
    "axis": "#839496",
    "text": "#93a1a1",
    "grid": "#073642",
    "lens": "#0e3a46",
    "edges": "#839496",
    "aperture": "#dc322f",
    "mirror": "#586e75",
    "ray_cycle": list(_SOLARIZED_ACCENTS),
}


@dataclass
class Theme:
    """Visual parameters for optiland_tpu_torch plots (reference `Theme`,
    `themes.py:36-114`)."""

    name: str
    description: str = ""
    palette: dict = field(default_factory=lambda: copy.deepcopy(
        light_palette))

    def color(self, key: str) -> str:
        return self.palette[key]

    @property
    def ray_cycle(self) -> list[str]:
        return list(self.palette["ray_cycle"])

    def apply_to_axes(self, fig, ax) -> None:
        """Style a matplotlib figure/axes pair with this theme."""
        p = self.palette
        fig.patch.set_facecolor(p["background"])
        ax.set_facecolor(p["background"])
        for spine in getattr(ax, "spines", {}).values():
            spine.set_color(p["axis"])
        ax.tick_params(colors=p["axis"])
        ax.xaxis.label.set_color(p["text"])
        ax.yaxis.label.set_color(p["text"])
        ax.title.set_color(p["text"])
        ax.grid(color=p["grid"], alpha=0.25)

    def to_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "palette": copy.deepcopy(self.palette)}

    @classmethod
    def from_dict(cls, d: dict) -> "Theme":
        return cls(name=d["name"], description=d.get("description", ""),
                   palette=copy.deepcopy(d["palette"]))


_THEMES: dict[str, Theme] = {
    "light": Theme("light", "Default light style", light_palette),
    "dark": Theme("dark", "High-contrast dark style", dark_palette),
    "midnight": Theme("midnight", "Near-black presentation style",
                      midnight_palette),
    "solarized_light": Theme("solarized_light", "Solarized light",
                             solarized_light_palette),
    "solarized_dark": Theme("solarized_dark", "Solarized dark",
                            solarized_dark_palette),
}
_active = _THEMES["light"]


def list_themes() -> list[str]:
    return sorted(_THEMES)


def register_theme(name: str, theme: Theme) -> None:
    _THEMES[name] = theme


def get_active_theme() -> Theme:
    return _active


def resolve_theme(theme) -> Theme:
    """None -> active theme; str -> registered theme; Theme -> itself."""
    if theme is None:
        return _active
    if isinstance(theme, Theme):
        return theme
    try:
        return _THEMES[theme]
    except KeyError:
        raise ValueError(
            f"Unknown theme {theme!r}; available: {list_themes()}") from None


def set_theme(theme) -> None:
    global _active
    _active = resolve_theme(theme)


@contextlib.contextmanager
def theme_context(theme):
    """Temporarily switch the active theme (reference `theme_context`)."""
    global _active
    prev = _active
    _active = resolve_theme(theme)
    try:
        yield _active
    finally:
        _active = prev
