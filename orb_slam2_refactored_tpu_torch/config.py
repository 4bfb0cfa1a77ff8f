"""Settings loader: reads the reference's YAML settings schema.

Port of `orb_slam2_refactored_tpu/config.py`: the keys the reference's System
constructor reads (`src/System.cc:47-120,333-375`): `Camera.{fx,fy,cx,cy,k1,
k2,p1,p2,k3,fps,RGB,bf,width,height}`, `ThDepth`, `DepthMapFactor`,
`ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}`,
`Viewer.*` and the EuRoC `LEFT./RIGHT.{K,D,R,P,height,width}` blocks, with
the same defaults.

The JAX package parses the file with PyYAML after dropping the `%YAML:1.0`
directive and the `!!opencv-matrix` tags. The port has a reader of its own
(`load_opencv_yaml`) for the subset that OpenCV settings files use: `key:
value` lines, comments, nested blocks by indentation (an `!!opencv-matrix`
node's `rows`, `cols`, `dt` and `data`) and flow lists (`[...]`) that may
span lines. Scalars resolve as PyYAML's YAML 1.1 resolver resolves those of
settings files (decimal int, float, bool, null, else str), so the `raw`
dict equals JAX's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional

import numpy as np

# PyYAML's implicit resolvers (yaml/resolver.py) for what settings files
# hold: YAML 1.1 booleans, null, decimal integers and floats (a float needs
# its dot, and a signed exponent)
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True, "no": False,
         "No": False, "NO": False, "false": False, "False": False,
         "FALSE": False, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*|[-+]?\.[0-9_]+)"
                    r"(?:[eE][-+][0-9]+)?$")


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    return t


def _strip_comment(line: str) -> str:
    """The line without a trailing `# ...` comment (outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_list(text: str) -> List[Any]:
    body = text.strip()[1:-1].strip()
    return [] if not body else [_scalar(v) for v in body.split(",")]


def _block(lines, i: int, indent: int):
    """Parse the mapping whose keys sit at column `indent` from line `i`;
    returns (dict, next line)."""
    out: Dict[str, Any] = {}
    while i < len(lines):
        col, text = lines[i]
        if col < indent:
            break
        if col > indent:
            raise ValueError(f"settings: unexpected indentation at {text!r}")
        key, sep, rest = text.partition(":")
        if not sep:
            raise ValueError(f"settings: no 'key: value' in {text!r}")
        key = _scalar(key)
        rest = rest.replace("!!opencv-matrix", "").strip()
        i += 1
        if rest.startswith("["):
            while rest.count("[") > rest.count("]") and i < len(lines):
                rest += " " + lines[i][1]
                i += 1
            out[key] = _flow_list(rest)
        elif rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load_opencv_yaml(path: str) -> Dict[str, Any]:
    """An OpenCV settings YAML as a dict (the JAX package's
    `_load_opencv_yaml`, without PyYAML)."""
    with open(path, "r") as f:
        text = f.read()
    lines = []
    for raw in text.splitlines():
        if raw.startswith("%YAML") or raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return {}
    out, _ = _block(lines, 0, lines[0][0])
    return out


def _as_matrix(node) -> np.ndarray:
    """Decode an opencv-matrix node {rows, cols, dt, data} -> ndarray."""
    if isinstance(node, dict) and "data" in node:
        rows = int(node.get("rows", 1))
        cols = int(node.get("cols", 1))
        return np.asarray(node["data"], np.float64).reshape(rows, cols)
    return np.asarray(node, np.float64)


@dataclasses.dataclass
class OrbParams:
    """ORB extractor parameters (`include/ORBextractor.h:38-47`)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7


@dataclasses.dataclass
class CameraConfig:
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: bool = True
    bf: float = 0.0
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class RectificationConfig:
    """EuRoC-style stereo rectification block
    (`Examples/Stereo/stereo_euroc.cc:61-107`)."""

    K_l: np.ndarray = None
    K_r: np.ndarray = None
    D_l: np.ndarray = None
    D_r: np.ndarray = None
    R_l: np.ndarray = None
    R_r: np.ndarray = None
    P_l: np.ndarray = None
    P_r: np.ndarray = None
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class Settings:
    camera: CameraConfig
    orb: OrbParams
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    viewer: Dict[str, float] = dataclasses.field(default_factory=dict)
    rectification: Optional[RectificationConfig] = None
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_yaml(path: str) -> "Settings":
        d = load_opencv_yaml(path)

        def g(key, default=None):
            return d.get(key, default)

        cam = CameraConfig(
            fx=float(g("Camera.fx", 0.0)),
            fy=float(g("Camera.fy", 0.0)),
            cx=float(g("Camera.cx", 0.0)),
            cy=float(g("Camera.cy", 0.0)),
            k1=float(g("Camera.k1", 0.0)),
            k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)),
            p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            fps=float(g("Camera.fps", 30.0) or 30.0),
            rgb=bool(int(g("Camera.RGB", 1))),
            bf=float(g("Camera.bf", 0.0)),
            width=int(g("Camera.width", 0)),
            height=int(g("Camera.height", 0)),
        )
        orb = OrbParams(
            n_features=int(g("ORBextractor.nFeatures", 2000)),
            scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(g("ORBextractor.nLevels", 8)),
            ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(g("ORBextractor.minThFAST", 7)),
        )
        rect = None
        if "LEFT.K" in d:
            rect = RectificationConfig(
                K_l=_as_matrix(d["LEFT.K"]),
                K_r=_as_matrix(d["RIGHT.K"]),
                D_l=_as_matrix(d["LEFT.D"]),
                D_r=_as_matrix(d["RIGHT.D"]),
                R_l=_as_matrix(d["LEFT.R"]),
                R_r=_as_matrix(d["RIGHT.R"]),
                P_l=_as_matrix(d["LEFT.P"]),
                P_r=_as_matrix(d["RIGHT.P"]),
                width=int(d.get("LEFT.width", 0)),
                height=int(d.get("LEFT.height", 0)),
            )
        viewer = {k[len("Viewer."):]: v for k, v in d.items()
                  if k.startswith("Viewer.")}
        return Settings(
            camera=cam,
            orb=orb,
            th_depth=float(g("ThDepth", 35.0) or 35.0),
            depth_map_factor=float(g("DepthMapFactor", 1.0) or 1.0),
            viewer=viewer,
            rectification=rect,
            raw=d,
        )
