"""Scene manifests: one JSON file describing a full renderable scene.

The reference's tier-3 configuration is scattered across Unity scene
objects + the material-pairing XML (SURVEY.md §5.6); the TPU framework's
equivalent is a single declarative manifest that names the assets and
settings, so scenes are versionable text:

```json
{
  "meshes": [
    {"obj": "models/room.obj"},
    {"gltf": "models/props.glb"},
    {"primitive": "uv_sphere", "translate": [0, 1, 0], "radius": 0.5,
     "material": "chrome"}
  ],
  "materials": {"chrome": {"base_color": [0.9, 0.9, 0.9], "metallic": 1.0,
                            "roughness": 0.1}},
  "material_overrides": {"room_walls": {"roughness": 0.8}},
  "env": {"constant": [0.5, 0.6, 0.8]},          // or {"hdr": "sky.exr"}
  "terrain": {"heightmap": "terrain.npy", "origin": [-8, 0, -8],
               "size": [16, 16], "height_scale": 2.0,
               "materials": ["grass", "rock"]},
  "camera": {"eye": [0, 2, 8], "target": [0, 1, 0], "fov": 45,
              "aperture": 0.0, "focus": 5.0},
  "render": {"bounces": 5, "bsdf": "disney", "traversal": "wavefront",
              "light_sampling": "tree"}
}
```

`load_manifest(path, device)` returns (scene, camera, render_config)
ready for `render(...)`, the scene and camera on `device`. Paths are
relative to the manifest file.

Port of `truetrace_tpu/scene/manifest.py`, with the same scene tables
(tests/test_torch_sources.py). `tex_file_*` textures are PNG files read
by the port's own codec (scene/png.py; other formats raise, ROADMAP.md
A.27). A manifest whose `render.traversal` is "cwbvh" (the one-node-a-
step oracle) raises (ROADMAP.md A.19); "bvh2" builds without the CWBVH.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _resolve(base: str, p: str) -> str:
    return p if os.path.isabs(p) else os.path.join(base, p)


def load_manifest(path: str, device="cuda"):
    """Returns (Scene, Camera, RenderConfig), the scene and camera on
    `device` (the card unless the caller asks for the CPU)."""
    from truetrace_tpu_torch.integrate.pathtrace import RenderConfig
    from truetrace_tpu_torch.scene.atlas import AtlasBuilder
    from truetrace_tpu_torch.scene.ir import Camera, EnvMap
    from truetrace_tpu_torch.scene.mesh import (HostMaterial, HostMesh,
                                                compile_scene)

    base = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        doc = json.load(f)

    builder = AtlasBuilder()
    mats: list = []
    mat_names: dict = {}

    def mat_id(name: str) -> int:
        if name not in mat_names:
            spec = doc.get("materials", {}).get(name, {})
            kw = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in spec.items() if not k.startswith("tex_file")}
            for slot in ("albedo", "normal", "emission", "rough_metal",
                         "metallic", "roughness", "alpha", "matcap",
                         "matcap_mask"):
                fkey = f"tex_file_{slot}"
                if fkey in spec:
                    from truetrace_tpu_torch.scene.png import read_texture
                    img = read_texture(_resolve(base, spec[fkey]))
                    kw[f"tex_{slot}"] = builder.add(img)
            mat_names[name] = len(mats)
            mats.append(HostMaterial(**kw))
        return mat_names[name]

    # material auto-pairing (reference MaterialMappings.xml): top-level
    # "auto_pair": true enables name-rule pairing for every obj/gltf
    # entry; "material_rules": "rules.json" prepends a user rules DB
    pair_rules = None
    auto = bool(doc.get("auto_pair", False))
    if doc.get("material_rules"):
        from truetrace_tpu_torch.scene.material_rules import load_rules
        pair_rules = load_rules(_resolve(base, doc["material_rules"]))
        auto = True

    meshes = []
    for entry in doc.get("meshes", []):
        auto_e = bool(entry.get("auto_pair", auto))
        if "obj" in entry:
            from truetrace_tpu_torch.scene.obj_loader import load_obj
            ms, mlist, names = load_obj(_resolve(base, entry["obj"]),
                                        _return_names=True)
            if auto_e:
                from truetrace_tpu_torch.scene.material_rules import (
                    auto_pair as _ap)
                mlist = _ap(names, mlist, pair_rules)
            off = len(mats)
            mats.extend(mlist)
            for m in ms:
                m.mat_id = m.mat_id + off
                meshes.append(m)
        elif "gltf" in entry:
            from truetrace_tpu_torch.scene.gltf_loader import load_gltf
            ms, mlist = load_gltf(_resolve(base, entry["gltf"]),
                                  atlas_builder=builder, auto_pair=auto_e,
                                  rules=pair_rules)
            off = len(mats)
            mats.extend(mlist)
            for m in ms:
                m.mat_id = m.mat_id + off
                meshes.append(m)
        elif "primitive" in entry:
            from truetrace_tpu_torch.scene import primitives
            kind = entry["primitive"]
            mid = mat_id(entry.get("material", "_default"))
            if kind == "uv_sphere":
                v, i, _ = primitives.uv_sphere(
                    entry.get("rings", 16), entry.get("segments", 24),
                    radius=entry.get("radius", 0.5))
            elif kind == "grid":
                v, i, _ = primitives.grid(
                    entry.get("nx", 2), entry.get("nz", 2),
                    entry.get("sx", 1.0), entry.get("sz", 1.0))
            else:
                raise ValueError(f"unknown primitive {kind!r}")
            v = primitives.transform(
                v, translate=tuple(entry.get("translate", (0, 0, 0))),
                scale=entry.get("scale", 1.0))
            meshes.append(HostMesh(v, i, np.full(len(i), mid, np.int32)))
        else:
            raise ValueError(f"unknown mesh entry {entry!r}")

    # environment
    env = None
    if "env" in doc:
        e = doc["env"]
        if "constant" in e:
            env = EnvMap.constant(tuple(e["constant"]), device)
        elif "sky" in e:
            from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
            env = bake_sky_env(sun_dir=tuple(e["sky"].get(
                "sun_dir", (0.4, 0.5, 0.3))),
                sun_irradiance=e["sky"].get("sun_irradiance", 20.0),
                device=device)

    # terrain
    terrain = None
    if "terrain" in doc:
        t = doc["terrain"]
        from truetrace_tpu_torch.scene.terrain import make_terrain
        hm = np.load(_resolve(base, t["heightmap"])) \
            if t["heightmap"].endswith(".npy") else None
        if hm is None:
            raise ValueError("terrain heightmap must be a .npy file")
        terrain = make_terrain(
            hm, origin=tuple(t.get("origin", (0, 0, 0))),
            size_xz=tuple(t.get("size", (10, 10))),
            mat_ids=[mat_id(n) for n in t.get("materials", [])],
            height_scale=t.get("height_scale", 1.0), device=device)

    # material overrides (the live-edit path: materials_io.apply_overrides)
    if "material_overrides" in doc:
        from truetrace_tpu_torch.scene.materials_io import apply_overrides
        names = [n for n, _ in sorted(mat_names.items(),
                                      key=lambda kv: kv[1])]
        # overrides only apply to named materials
        full_names = [None] * len(mats)
        for n, i in mat_names.items():
            full_names[i] = n
        over = {k: {kk: (tuple(vv) if isinstance(vv, list) else vv)
                    for kk, vv in v.items()}
                for k, v in doc["material_overrides"].items()}
        mats = apply_overrides(
            mats, [n or f"_m{i}" for i, n in enumerate(full_names)], over)

    atlas, rects, level_y = builder.build()
    rc = doc.get("render", {})
    cfg = RenderConfig(
        width=rc.get("width", 512), height=rc.get("height", 512),
        bounces=rc.get("bounces", 5), bsdf=rc.get("bsdf", "disney"),
        traversal=rc.get("traversal", "wavefront"),
        light_sampling=rc.get("light_sampling", "tree"),
        use_nee=rc.get("use_nee", True))
    if cfg.traversal == "cwbvh":
        raise NotImplementedError(
            f"manifest traversal {cfg.traversal!r} is not ported yet "
            f"(ROADMAP.md A.19)")
    with_cw = cfg.traversal in ("wavefront", "cwbvh")
    scene = compile_scene(
        meshes, mats, env=env,
        atlas=atlas if builder.images else None,
        atlas_rects=rects if builder.images else None,
        atlas_level_y=level_y if builder.images else None,
        with_cwbvh=with_cw, with_light_bvh=cfg.light_sampling == "tree",
        terrain=terrain, device=device)

    c = doc.get("camera", {})
    cam = Camera.look_at(
        eye=tuple(c.get("eye", (0, 1, 5))),
        target=tuple(c.get("target", (0, 0, 0))),
        fov_y_deg=c.get("fov", 40.0), aperture=c.get("aperture", 0.0),
        focus_dist=c.get("focus", 1.0), device=device)
    return scene, cam, cfg
