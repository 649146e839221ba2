"""Material auto-pairing rules: naming-convention -> Disney parameters.

Headless counterpart of the reference's material-pairing database
(Utility/MaterialMappings.xml, loaded by AssetManager.cs:686-702 and
edited through the pairing UI, Editor/PathTracerSettings.cs:723-1141):
the reference maps arbitrary shader property names onto its material
model; here foreign assets arrive as OBJ/MTL or glTF, where PBR intent
is often encoded only in MATERIAL NAMES ("glass_pane", "gold_trim",
"curtain_red"). A rules DB maps name patterns onto Disney parameters.

Semantics:
* Rules apply in list order; several rules may fire on one material.
* A rule only fills fields the loader left at the HostMaterial DEFAULT
  (explicit MTL/glTF data wins over a name heuristic). Prefix a key
  with "!" to force it regardless.
* "emission_from_color": k is a computed key — emission becomes
  base_color * k (lamp shades keep their tint).
* User rules: JSON list of {"match": regex, "set": {...}} loaded with
  load_rules(path); per-scene manifests can extend/override
  (scene/manifest.py "material_rules" / "auto_pair" keys).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import List, Optional

from truetrace_tpu_torch.scene.mesh import HostMaterial

_DEFAULTS = HostMaterial()

DEFAULT_RULES: List[dict] = [
    # dielectrics / transmissive
    {"match": r"glass|window|vitrail|crystal", "set": {
        "spec_trans": 1.0, "roughness": 0.03, "ior": 1.5, "specular": 0.0}},
    {"match": r"water|liquid", "set": {
        "spec_trans": 1.0, "roughness": 0.01, "ior": 1.33, "specular": 0.0}},
    # metals (colored presets only fill an unset base color)
    {"match": r"gold", "set": {"metallic": 1.0, "roughness": 0.25,
                               "base_color": (1.0, 0.77, 0.34)}},
    {"match": r"copper", "set": {"metallic": 1.0, "roughness": 0.3,
                                 "base_color": (0.95, 0.64, 0.54)}},
    {"match": r"brass|bronze", "set": {"metallic": 1.0, "roughness": 0.35,
                                       "base_color": (0.91, 0.78, 0.42)}},
    {"match": r"silver|chrome|mirror", "set": {"metallic": 1.0,
                                               "roughness": 0.05}},
    {"match": r"steel|iron|alumin|metal", "set": {"metallic": 1.0,
                                                  "roughness": 0.3}},
    # organics / fabric
    {"match": r"leaf|leaves|foliage|plant|grass|ivy|frond", "set": {
        "thin": 1.0, "roughness": 0.7, "diff_trans": 0.3}},
    {"match": r"curtain|cloth|fabric|banner|flag|carpet|rug", "set": {
        "sheen": 0.6, "roughness": 0.9}},
    {"match": r"skin|flesh", "set": {"subsurface": 0.5, "roughness": 0.45}},
    # emitters
    {"match": r"light|lamp|bulb|neon|glow|emissi", "set": {
        "emission_from_color": 8.0}},
    # rough dielectric surfaces
    {"match": r"concrete|plaster|stucco|brick|stone", "set": {
        "roughness": 0.85}},
    {"match": r"ceramic|porcelain|tile", "set": {"roughness": 0.15,
                                                 "clearcoat": 0.5}},
    {"match": r"wood|timber|plank", "set": {"roughness": 0.6}},
]


def load_rules(path: str) -> List[dict]:
    """Load a user rules DB (JSON list of {"match","set"}); entries are
    PREPENDED to the defaults so they win field-fill priority."""
    with open(path) as f:
        user = json.load(f)
    for r in user:
        re.compile(r["match"])      # validate early
        if not isinstance(r.get("set"), dict):
            raise ValueError(f"rule {r.get('match')!r} missing 'set' dict")
    return list(user) + DEFAULT_RULES


def _is_default(mat: HostMaterial, field: str) -> bool:
    return getattr(mat, field) == getattr(_DEFAULTS, field)


def apply_rules(name: str, mat: HostMaterial,
                rules: Optional[List[dict]] = None) -> HostMaterial:
    """Apply every matching rule to one material (see module docstring)."""
    rules = DEFAULT_RULES if rules is None else rules
    low = name.lower()
    for rule in rules:
        if not re.search(rule["match"], low):
            continue
        updates = {}
        for key, val in rule["set"].items():
            force = key.startswith("!")
            field = key[1:] if force else key
            if field == "emission_from_color":
                if force or _is_default(mat, "emission"):
                    base = updates.get("base_color", mat.base_color)
                    updates["emission"] = tuple(c * val for c in base)
                continue
            if force or _is_default(mat, field):
                updates[field] = tuple(val) if isinstance(val, list) else val
        if updates:
            mat = dataclasses.replace(mat, **updates)
    return mat


def auto_pair(names: List[str], mats: List[HostMaterial],
              rules: Optional[List[dict]] = None) -> List[HostMaterial]:
    """Rule-pair a whole material list (parallel name/material lists)."""
    return [apply_rules(n, m, rules) for n, m in zip(names, mats)]
