"""Material persistence: save/load material sets as JSON.

Counterpart of the reference's XML material persistence (live edits written
on destroy: RayTracingMaster.cs:332-340 + Utility/SaveFile.xml; the
shader->material pairing DB Utility/MaterialMappings.xml is the analogue of
`apply_overrides`). JSON instead of XML; round-trips every HostMaterial
field, so scene material tweaks survive sessions and can be diffed/merged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from truetrace_tpu_torch.scene.mesh import HostMaterial


def save_materials(path: str, mats: List[HostMaterial],
                   names: List[str] = None) -> None:
    names = names or [f"mat_{i}" for i in range(len(mats))]
    out = {}
    for name, m in zip(names, mats):
        d = dataclasses.asdict(m)
        d = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in d.items()}
        out[name] = d
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def load_materials(path: str):
    """Returns (materials list, names list)."""
    with open(path) as f:
        data = json.load(f)
    mats, names = [], []
    fields = {f.name for f in dataclasses.fields(HostMaterial)}
    for name, d in data.items():
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in d.items() if k in fields}
        mats.append(HostMaterial(**kw))
        names.append(name)
    return mats, names


def apply_overrides(mats: List[HostMaterial], names: List[str],
                    overrides: Dict[str, Dict]) -> List[HostMaterial]:
    """Apply per-name field overrides (the live material-edit path:
    RayTracingObject.CallMaterialEdited -> AssetManager.UpdateMaterials)."""
    out = []
    for name, m in zip(names, mats):
        if name in overrides:
            out.append(dataclasses.replace(m, **overrides[name]))
        else:
            out.append(m)
    return out
