"""Scene inspection + validation: the headless analogue of the reference's
editor suite (TrueTrace/Editor: RayTracingMasterEditor panels showing
object/tri/light counts, material lists and validation warnings before a
build). On a render server there is no GUI, so the same information is a
report dict + findings list, printable from scripts/scene_inspect.py or
asserted in CI.

Checks mirror the failure modes the reference surfaces in its editor:
degenerate triangles, out-of-range material ids, non-finite vertices,
emissive materials missing from the light list, texture ids outside the
atlas, NaN materials, missing CWBVH, unreferenced materials.

Port of `truetrace_tpu/tools/inspector.py`: host numpy over the port's
Scene tensors (the triangles, materials and light list copied off the
device; the traversal tables only by shape), with the JAX package's
findings and stats (tests/test_torch_build_opts.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class Finding:
    severity: str      # "error" | "warning" | "info"
    check: str
    message: str

    def __str__(self):
        return f"[{self.severity}] {self.check}: {self.message}"


@dataclass
class Report:
    stats: dict = field(default_factory=dict)
    findings: List[Finding] = field(default_factory=list)

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == "warning"]

    def ok(self) -> bool:
        return not self.errors

    def render(self) -> str:
        lines = ["scene report", "------------"]
        for k, v in self.stats.items():
            lines.append(f"{k:28s} {v}")
        if self.findings:
            lines.append("")
            lines += [str(f) for f in self.findings]
        else:
            lines.append("no findings")
        return "\n".join(lines)


def _np(x) -> np.ndarray:
    """A scene tensor as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def _mat_cols(materials):
    import dataclasses as dc
    return {f.name: _np(getattr(materials, f.name))
            for f in dc.fields(materials)}


def inspect_scene(scene, mats=None) -> Report:
    """Validate a compiled Scene; `mats` (HostMaterial list) adds
    name-level material checks. Pure host-side numpy — safe anywhere."""
    r = Report()
    add = r.findings.append

    p0 = _np(scene.tri_p0)
    e1 = _np(scene.tri_e1)
    e2 = _np(scene.tri_e2)
    mat_id = _np(scene.tri_mat)
    T = p0.shape[0]
    M = scene.materials.base_color.shape[0]

    r.stats["triangles"] = T
    r.stats["materials"] = M
    r.stats["cwbvh_nodes"] = int(scene.cw_nodes.shape[0])
    r.stats["cwbvh_leaf_rows"] = int(scene.cw_leaf_rows.shape[0])
    r.stats["cwbvh_stack_depth"] = int(scene.cw_stack)
    r.stats["mesh_lights"] = int(scene.light_tris.power.shape[0])
    r.stats["analytic_lights"] = int(scene.lights.position.shape[0])
    r.stats["env_map"] = list(scene.env.image.shape[:2])
    r.stats["has_light_bvh"] = bool(
        scene.lbvh_nodes.shape[0] > 0)
    r.stats["instanced"] = scene.mesh_table is not None
    r.stats["terrain"] = scene.terrain is not None
    gather_mb = (scene.cw_nodes.shape[0] * 30
                 + scene.cw_leaf_rows.shape[0] * 30) * 4 / 2**20
    r.stats["gather_table_mb"] = round(gather_mb, 1)

    # --- geometry validation (reference editor's mesh validation)
    if not (np.isfinite(p0).all() and np.isfinite(e1).all()
            and np.isfinite(e2).all()):
        add(Finding("error", "geometry", "non-finite vertex data"))
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    n_degen = int((area2 < 1e-20).sum())
    if n_degen:
        add(Finding("warning", "geometry",
                    f"{n_degen} degenerate (zero-area) triangles"))
    if T and (mat_id.min() < 0 or mat_id.max() >= M):
        add(Finding("error", "materials",
                    f"triangle material ids outside [0,{M})"))

    # --- material validation
    cols = _mat_cols(scene.materials)
    for name, col in cols.items():
        if np.issubdtype(col.dtype, np.floating) and not \
                np.isfinite(col).all():
            add(Finding("error", "materials", f"non-finite '{name}'"))
    n_tex = int(scene.atlas_rects.shape[0])
    for name in ("tex_albedo", "tex_normal", "tex_emission",
                 "tex_rough_metal", "tex_matcap"):
        ids = cols[name]
        if ids.size and ids.max() >= n_tex:
            add(Finding("error", "textures",
                        f"'{name}' references texture {int(ids.max())} "
                        f"but atlas holds {n_tex}"))
    used = np.zeros(M, bool)
    if T:
        used[np.unique(mat_id)] = True
    n_unused = int((~used).sum())
    if n_unused:
        add(Finding("info", "materials",
                    f"{n_unused} material slots unreferenced"))

    # --- light validation (reference editor warns on emissive-but-unlit)
    emissive = _np(scene.materials.emission).max(axis=-1) > 0
    if T:
        lit_ids = _np(scene.light_tris.tri_index)
        lit = np.zeros(T, bool)
        if lit_ids.size:
            lit[lit_ids] = True
        missing = emissive[mat_id] & ~lit
        if scene.mesh_table is None and missing.any():
            add(Finding("warning", "lights",
                        f"{int(missing.sum())} emissive triangles missing "
                        "from the NEE light list"))
    if (r.stats["mesh_lights"] == 0 and r.stats["analytic_lights"] == 0
            and float(_np(scene.env.image).max()) <= 0.0):
        add(Finding("warning", "lights",
                    "no light source: renders will be black"))

    # --- traversal validation
    if scene.cw_nodes.shape[0] == 0 and T > 0:
        add(Finding("info", "traversal",
                    "no CWBVH: only bvh2/brute traversal available"))
    if gather_mb > 28.0:
        add(Finding("info", "perf",
                    f"gather table {gather_mb:.0f} MB exceeds the ~30 MB "
                    "on-chip cache: expect the 10-40 ns/row gather regime "
                    "(BASELINE.md)"))
    return r
