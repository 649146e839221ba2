"""Dynamic (skinned) scenes: per-frame pose -> refit -> render.

Port of `truetrace_tpu/scene/dynamic.py` (the reference's per-frame
skinned-mesh refit loop, AssetManager.cs:1473-1606 and
ParentObject.cs:753-950). The CWBVH topology and the refit worklists are
built once at the rest pose on the host and moved to the device; a pose
update (`pose_scene`) is then device work only: skin, refit level by
level, rebuild the leaf rows, the skinned triangles' normals and the
emissive light rows. It copies nothing from the host and never syncs, and
it returns a new Scene of the same shapes, so a captured frame
(`Renderer.graph_step`) replays every pose without a new capture.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from truetrace_tpu_torch.build.bvh2 import build_bvh2
from truetrace_tpu_torch.build.cwbvh import build_cwbvh
from truetrace_tpu_torch.build.refit import level_worklists, refit_cwbvh
from truetrace_tpu_torch.core import aabb as aabb_ops
from truetrace_tpu_torch.core.math import cross_fma
from truetrace_tpu_torch.kernels.cwbvh_wavefront import pack_leaf_rows_torch
from truetrace_tpu_torch.scene.ir import Scene
from truetrace_tpu_torch.scene.mesh import (
    HostMaterial, HostMesh, compile_scene, flatten_meshes,
    pack_light_rows_torch)
from truetrace_tpu_torch.scene.skinning import SkinnedMesh, skin_vertices


@dataclass
class DynamicScene:
    """The rest-pose Scene and what a pose update needs, on its device."""
    scene: Scene                  # compiled at the rest pose (K = 3)
    mesh: SkinnedMesh             # the deformable part
    skin_tri_ids: torch.Tensor    # [Fs] input-order ids of the skinned tris
    perm: torch.Tensor            # CWBVH position -> input-order id
    skin_cw: torch.Tensor         # [Fs] CWBVH positions of the skinned tris
    slot_child: torch.Tensor      # [C,8] refit metadata
    slot_tri_base: torch.Tensor
    slot_tri_count: torch.Tensor
    levels: Tuple[torch.Tensor, ...]
    flat_base: torch.Tensor       # [L] leaf slots (pack_leaf_rows_torch)
    flat_count: torch.Tensor
    rest_p0: torch.Tensor         # [T,3] input-order triangles
    rest_e1: torch.Tensor
    rest_e2: torch.Tensor


def compile_dynamic_scene(mesh: SkinnedMesh, skin_mat_id: int,
                          mats: List[HostMaterial],
                          static_meshes: Optional[List[HostMesh]] = None,
                          env=None, lights=None, with_light_bvh: bool = False,
                          device="cuda") -> DynamicScene:
    """Build the Scene at the rest pose on `device` (the card unless the
    caller asks for the CPU) with the refit metadata.

    The skinned mesh joins the static meshes in ONE BLAS; only its
    triangles move. leaf_k is pinned to 3: the refit metadata comes from
    the K = 3 build, which must be the scene's."""
    static_meshes = list(static_meshes or [])
    skin_host = HostMesh(mesh.rest_verts.cpu().numpy(),
                         mesh.tri_vidx.cpu().numpy(),
                         np.full(mesh.tri_vidx.shape[0], skin_mat_id,
                                 np.int32))
    meshes = static_meshes + [skin_host]
    # compile_scene's build, keeping the CWBVH metadata
    tris = flatten_meshes(meshes)
    tri_box = aabb_ops.from_tris(
        tris["p0"], tris["p0"] + tris["e1"], tris["p0"] + tris["e2"])
    bvh = build_bvh2(tri_box, max_leaf=3, sah_leaf_cap=3)
    cw = build_cwbvh(bvh, tri_box[bvh.order])
    perm = bvh.order[cw.tri_index]
    scene = compile_scene(meshes, mats, env=env, lights=lights,
                          with_cwbvh=True, with_light_bvh=with_light_bvh,
                          leaf_k=3, device=device)
    n_static = sum(m.indices.shape[0] for m in static_meshes)
    skin_tri_ids = n_static + np.arange(mesh.tri_vidx.shape[0])
    mask = cw.slot_tri_count > 0
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                           device=device)
    i64 = torch.int64
    return DynamicScene(
        scene=scene, mesh=mesh._replace(**{
            f: getattr(mesh, f).to(device) for f in mesh._fields}),
        skin_tri_ids=t(skin_tri_ids, i64), perm=t(perm, i64),
        skin_cw=t(np.argsort(perm)[skin_tri_ids], i64),
        slot_child=t(cw.slot_child, i64),
        slot_tri_base=t(cw.slot_tri_base, i64),
        slot_tri_count=t(cw.slot_tri_count, i64),
        levels=level_worklists(cw.node_depth, device),
        flat_base=t(cw.slot_tri_base[mask], i64),
        flat_count=t(cw.slot_tri_count[mask], i64),
        rest_p0=t(tris["p0"]), rest_e1=t(tris["e1"]), rest_e2=t(tris["e2"]))


def pose_scene(dyn: DynamicScene, bones: torch.Tensor) -> Scene:
    """Skin the vertices by `bones` [B,3,4] (on the scene's device), refit
    the CWBVH level by level, rebuild the leaf rows, the skinned
    triangles' normals (face normals of the deformed triangles) and the
    emissive light rows (geometry columns; power, CDF and pmf stay).
    Returns a new Scene with the old one's shapes (its traversal table
    unpacked); the old scene is not written."""
    v = skin_vertices(dyn.mesh, bones)
    idx = dyn.mesh.tri_vidx
    sp0 = v[idx[:, 0]]
    se1 = v[idx[:, 1]] - sp0
    se2 = v[idx[:, 2]] - sp0
    sk = dyn.skin_tri_ids
    # input-order triangles with the skinned range replaced, then the
    # CWBVH order
    p0 = dyn.rest_p0.index_copy(0, sk, sp0)[dyn.perm]
    e1 = dyn.rest_e1.index_copy(0, sk, se1)[dyn.perm]
    e2 = dyn.rest_e2.index_copy(0, sk, se2)[dyn.perm]
    sc = dyn.scene
    K = sc.cw_leaf_rows.shape[1] // 10
    nodes, _ = refit_cwbvh(sc.cw_nodes, p0, e1, e2, dyn.slot_child,
                           dyn.slot_tri_base, dyn.slot_tri_count, dyn.levels,
                           leaf_k=K)
    rows = pack_leaf_rows_torch(dyn.flat_base, dyn.flat_count, p0, e1, e2,
                                k=K)
    # the deformed triangles' face normals (the JAX package normalises
    # every triangle's and keeps the skinned ones)
    skc = dyn.skin_cw
    gn = cross_fma(e1[skc], e2[skc])
    gn = gn / torch.clamp(torch.linalg.norm(gn, dim=-1, keepdim=True),
                          min=1e-20)
    tri_n = sc.tri_n.index_copy(0, skc, gn[:, None, :].expand(-1, 3, -1))
    lt = sc.light_tris
    if lt.rows is not None and lt.rows.shape[0] > 0:
        ids = lt.tri_index.to(torch.int64)
        lt = dataclasses.replace(lt, rows=pack_light_rows_torch(
            p0[ids], e1[ids], e2[ids], lt.rows[:, 14], lt.pmf))
    return dataclasses.replace(sc, cw_nodes=nodes, cw_leaf_rows=rows,
                               tri_p0=p0, tri_e1=e1, tri_e2=e2, tri_n=tri_n,
                               light_tris=lt, _cw_table=None,
                               _bvh2_table=None)
