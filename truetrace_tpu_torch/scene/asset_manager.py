"""AssetManager: a mutable scene registry with a per-frame commit policy.

Port of `truetrace_tpu/scene/asset_manager.py` (the reference's
AssetManager lifecycle, Resources/AssetManager.cs: add / remove / update
queues, BLAS builds cached per source, and `UpdateTLAS` picking the
cheapest refresh each frame). The registry is on the host; `commit()`
returns the render-ready instanced Scene (traversal="tlas") on the
manager's device. A transform-only commit keeps the scene's shapes, so a
captured frame (`Renderer.graph_step`) replays it without a new capture.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from truetrace_tpu_torch.scene.instances import (
    SourceBuild, _auto_leaf_k, build_source, compile_scene_instanced,
    update_instance_transforms)
from truetrace_tpu_torch.scene.ir import TEX_SLOTS
from truetrace_tpu_torch.scene.mesh import (
    HostMaterial, HostMesh, material_table, shadow_tint_table)


@dataclass
class _Source:
    mesh: HostMesh
    build: Optional[SourceBuild] = None   # the cached BLAS (None: dirty)


@dataclass
class _Instance:
    source: int                 # source handle
    l2w: np.ndarray             # 4x4 row-vector local -> world


@dataclass
class AssetManager:
    """Mutable scene front end. Mutators only queue; `commit()` applies
    everything and returns the Scene, built on `device` (the card unless
    the caller asks for the CPU)."""
    materials: List[HostMaterial]
    env: object = None
    lights: object = None
    atlas: object = None
    atlas_rects: object = None
    atlas_level_y: object = None
    with_light_bvh: bool = False
    device: str = "cuda"

    _sources: Dict[int, _Source] = field(default_factory=dict)
    _instances: Dict[int, _Instance] = field(default_factory=dict)
    _next_src: int = 0
    _next_inst: int = 0
    # what the commit policy reads
    _topology_dirty: bool = True      # add / remove / geometry: rebuild
    _transforms_dirty: bool = False   # moved instances: the TLAS only
    _materials_dirty: bool = False    # the material tables only
    # the last commit
    _scene: object = None
    _isc: object = None
    _order: List[int] = field(default_factory=list)      # instance handles
    _src_order: List[int] = field(default_factory=list)

    # ---- mutation queues -------------------------------------------------
    def add_mesh(self, mesh: HostMesh) -> int:
        """Register a source geometry; returns its handle (the
        reference's AddQueue, AssetManager.cs:430)."""
        h = self._next_src
        self._next_src += 1
        self._sources[h] = _Source(mesh=mesh)
        self._topology_dirty = True
        return h

    def remove_mesh(self, handle: int) -> None:
        """Deregister a source and all its instances (RemoveQueue,
        AssetManager.cs:470)."""
        del self._sources[handle]
        self._instances = {k: v for k, v in self._instances.items()
                           if v.source != handle}
        self._topology_dirty = True

    def update_mesh(self, handle: int, mesh: HostMesh) -> None:
        """Replace a source's geometry: only ITS cached BLAS goes
        (UpdateQueue, AssetManager.cs:500)."""
        self._sources[handle] = _Source(mesh=mesh, build=None)
        self._topology_dirty = True

    def add_instance(self, source: int, l2w: np.ndarray) -> int:
        if source not in self._sources:
            raise KeyError(f"unknown source {source}")
        h = self._next_inst
        self._next_inst += 1
        self._instances[h] = _Instance(source=source,
                                       l2w=np.asarray(l2w, np.float32))
        self._topology_dirty = True
        return h

    def remove_instance(self, handle: int) -> None:
        del self._instances[handle]
        self._topology_dirty = True

    def set_transform(self, handle: int, l2w: np.ndarray) -> None:
        """Move an instance: the cheap per-frame path (AssetManager.cs:
        1714)."""
        self._instances[handle].l2w = np.asarray(l2w, np.float32)
        self._transforms_dirty = True

    def set_material(self, index: int, mat: HostMaterial) -> None:
        """Edit a material slot. An emission edit changes the light list
        (a full rebuild); any other edit swaps the tables
        (AssetManager.cs:520)."""
        old = self.materials[index]
        if tuple(np.ravel(old.emission)) != tuple(np.ravel(mat.emission)):
            self._topology_dirty = True
        self.materials[index] = mat
        self._materials_dirty = True

    # ---- per-frame commit --------------------------------------------------
    def commit(self):
        """Apply the queued mutations with the cheapest sufficient rebuild
        and return the Scene (the reference's UpdateTLAS policy,
        AssetManager.cs:1610-1845):
          topology dirty   -> re-aggregate (cached BLAS builds reused)
          transforms dirty -> update_instance_transforms (the TLAS and the
                              world light rows), or a re-aggregation when
                              the TLAS changes its node count
          materials dirty  -> the material and shadow-tint tables
          clean            -> the cached Scene."""
        if self._topology_dirty:
            self._rebuild()
        elif self._transforms_dirty:
            try:
                self._scene, self._isc = update_instance_transforms(
                    self._scene, self._isc, self.materials, self._pairs())
            except ValueError:
                # the moved boxes gave the TLAS another node count: the
                # scene's shapes change, so re-aggregate (the BLAS builds
                # stay cached)
                self._rebuild()
        if self._materials_dirty and not self._topology_dirty:
            self._swap_materials()
        self._topology_dirty = False
        self._transforms_dirty = False
        self._materials_dirty = False
        return self._scene

    @property
    def instanced(self):
        """The committed InstancedScene (the traversal's host metadata)."""
        return self._isc

    def _pairs(self) -> List[Tuple[int, np.ndarray]]:
        """(contiguous source index, l2w) pairs in the committed order."""
        remap = {h: i for i, h in enumerate(self._src_order)}
        return [(remap[self._instances[h].source], self._instances[h].l2w)
                for h in self._order]

    def _swap_materials(self) -> None:
        mats, sc = self.materials, self._scene
        tint = shadow_tint_table(mats, sc.tri_mat.cpu().numpy())
        slots = ()
        if sc.atlas_rects.shape[0] > 0:
            slots = tuple(k for k in TEX_SLOTS
                          if any(getattr(m, k) >= 0 for m in mats))
        self._scene = dataclasses.replace(
            sc, materials=material_table(mats, self.device),
            tri_shadow=None if tint is None else torch.as_tensor(
                tint, device=self.device),
            has_media=any(m.spec_trans > 0.0 and m.thin < 0.5 for m in mats),
            tex_slots=slots)

    def _rebuild(self) -> None:
        if not self._instances:
            raise ValueError("commit() with no instances")
        self._src_order = sorted(self._sources)
        self._order = sorted(self._instances)
        # one fat-leaf width for the whole committed set (the BLAS table
        # is shared); a cached build of another width is rebuilt
        meshes = [self._sources[h].mesh for h in self._src_order]
        k = _auto_leaf_k(meshes)
        prebuilt = []
        for h in self._src_order:
            s = self._sources[h]
            if s.build is None or s.build.rows.shape[1] != 10 * k:
                s.build = build_source(s.mesh, leaf_k=k)
            prebuilt.append(s.build)
        self._scene, self._isc = compile_scene_instanced(
            meshes, self.materials, self._pairs(), env=self.env,
            lights=self.lights, atlas=self.atlas,
            atlas_rects=self.atlas_rects, atlas_level_y=self.atlas_level_y,
            with_light_bvh=self.with_light_bvh, prebuilt=prebuilt,
            leaf_k=k, device=self.device)
