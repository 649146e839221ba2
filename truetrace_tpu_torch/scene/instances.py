"""Instanced scenes: shared local-space BLASes under a two-level TLAS.

Port of `truetrace_tpu/scene/instances.py` (the build, the render-ready
scene and the per-frame transform update; the per-instance loop oracles
`closest_hit_instanced` / `any_hit_instanced` are not ported, ROADMAP.md
A.19). Sources are built once in local space (BVH2 -> CWBVH -> packed
leaf rows); each instance adds a W2L transform and a TLAS leaf. The TLAS
is a CWBVH over the instances' world AABBs, one instance per leaf slot,
its nodes first in the aggregate node table; the instance rows follow the
leaf rows in the traversal's table (kernels/cwbvh_tlas.py). Every table
is built on the host in numpy, bit for bit the JAX package's
(tests/test_torch_tlas.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from truetrace_tpu_torch.build.bvh2 import build_bvh2
from truetrace_tpu_torch.build.cwbvh import build_cwbvh
from truetrace_tpu_torch.core import aabb as aabb_ops
from truetrace_tpu_torch.kernels.cwbvh_tlas import pack_instance_rows
from truetrace_tpu_torch.kernels.cwbvh_wavefront import pack_leaf_rows
from truetrace_tpu_torch.scene.mesh import HostMesh, flatten_meshes


@dataclass
class InstancedScene:
    """Aggregated multi-BLAS geometry and the instance table (host
    numpy arrays)."""
    cw_nodes: np.ndarray        # [C,20] u32: TLAS nodes, then BLAS nodes
    leaf_rows: np.ndarray       # [L,10K] aggregated packed leaf rows
    tri_p0: np.ndarray          # [T,3] local space
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_mat: np.ndarray         # [T] global material id
    node_offset: np.ndarray     # [I] int32 BLAS root node per instance
    tri_offset: np.ndarray      # [I]
    l2w: np.ndarray             # [I,3,4] rows (rotation + translation)
    w2l: np.ndarray             # [I,3,4]
    world_aabb: np.ndarray      # [I,2,3]
    n_instances: int
    inst_rows: np.ndarray = None    # [I,10K] instance rows, TLAS leaf order
    n_tlas_nodes: int = 0
    tri_n: np.ndarray = None        # [T,3,3]
    tri_uv: np.ndarray = None       # [T,3,2]
    tri_tan: np.ndarray = None      # [T,3]
    src_tri_offset: np.ndarray = None   # [S]
    src_tri_count: np.ndarray = None    # [S]
    inst_src: np.ndarray = None         # [I] source id per instance
    src_local_aabb: np.ndarray = None   # [S,2,3] local root bounds


def _mat34(m: np.ndarray) -> np.ndarray:
    """4x4 row-vector-convention matrix -> 3x4 (rotation rows, then the
    translation column)."""
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = m[:3, :3].T
    out[:, 3] = m[3, :3]
    return out


def make_transform(translate=(0, 0, 0), rot_y: float = 0.0,
                   scale: float = 1.0) -> np.ndarray:
    """4x4 local -> world (row-vector convention, as Camera.c2w)."""
    c, s = np.cos(rot_y), np.sin(rot_y)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                         np.float32) * scale
    m[3, :3] = translate
    return m


class SourceBuild(NamedTuple):
    """One source mesh's BLAS build in local, un-relocated form."""
    nodes: np.ndarray       # [C,20] u32, pointers source-local
    rows: np.ndarray        # [L,10K] leaf rows, triangle ids source-local
    p0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    mat: np.ndarray
    n: np.ndarray
    uv: np.ndarray
    tan: np.ndarray
    local_boxes: np.ndarray  # [T,2,3]


def build_source(mesh: HostMesh, leaf_k: int = 3) -> SourceBuild:
    """BLAS-build one source mesh (BVH2 -> CWBVH -> packed leaf rows of
    leaf_k triangles) in local space."""
    tris = flatten_meshes([mesh])
    box = aabb_ops.from_tris(tris["p0"], tris["p0"] + tris["e1"],
                             tris["p0"] + tris["e2"])
    bvh = build_bvh2(box, max_leaf=leaf_k, sah_leaf_cap=leaf_k)
    cw = build_cwbvh(bvh, box[bvh.order], p_max=leaf_k)
    perm = bvh.order[cw.tri_index]
    w, rows = pack_leaf_rows(cw.nodes, cw.slot_tri_base, cw.slot_tri_count,
                             tris["p0"][perm], tris["e1"][perm],
                             tris["e2"][perm], k=leaf_k)
    return SourceBuild(nodes=w, rows=rows, p0=tris["p0"][perm],
                       e1=tris["e1"][perm], e2=tris["e2"][perm],
                       mat=tris["mat"][perm], n=tris["n"][perm],
                       uv=tris["uv"][perm], tan=tris["tan"][perm],
                       local_boxes=box[bvh.order][cw.tri_index])


def _auto_leaf_k(sources: Sequence[HostMesh]) -> int:
    """compile_scene(leaf_k=None)'s rule: 6 up to 400k triangles, else
    12."""
    total = sum(int(np.asarray(s.indices).shape[0]) for s in sources)
    return 6 if total <= 400_000 else 12


def _world_aabb(lo, hi, m: np.ndarray) -> np.ndarray:
    """[2,3] world bounds of the local box [lo, hi] under l2w m."""
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], np.float32)
    wc = corners @ m[:3, :3] + m[3, :3]
    return np.stack([wc.min(0), wc.max(0)])


def _tlas(world_aabb: np.ndarray):
    """The TLAS over instance world AABBs: (nodes [n_tlas,20] with word 5
    the base instance row, the instance of each instance row)."""
    bvh_t = build_bvh2(world_aabb, max_leaf=1, sah_leaf_cap=1,
                       use_native=False)
    cw_t = build_cwbvh(bvh_t, world_aabb[bvh_t.order], use_native=False)
    inst_perm = bvh_t.order[cw_t.tri_index]      # emit order -> instance
    mask = cw_t.slot_tri_count > 0
    per_node = mask.sum(axis=1)
    base_row = np.concatenate([[0], np.cumsum(per_node)[:-1]])
    nodes = cw_t.nodes.copy()
    nodes[:, 5] = base_row.astype(np.uint32)
    return nodes, inst_perm[cw_t.slot_tri_base[mask]]


def build_instanced(sources: Sequence[HostMesh],
                    instances: Sequence[Tuple[int, np.ndarray]],
                    prebuilt: Optional[Sequence[SourceBuild]] = None,
                    leaf_k: Optional[int] = None) -> InstancedScene:
    """sources: one HostMesh per unique geometry (local space);
    instances: (source id, l2w 4x4) pairs. prebuilt: optional per-source
    BLAS builds of this leaf_k; leaf_k None picks `_auto_leaf_k`."""
    if leaf_k is None:
        leaf_k = _auto_leaf_k(sources)
    parts = {k: [] for k in ("nodes", "rows", "p0", "e1", "e2", "mat", "n",
                             "uv", "tan")}
    src_tables, src_off, src_cnt, src_aabb = [], [], [], []
    n_off = t_off = l_off = 0
    for si, mesh in enumerate(sources):
        sb = (prebuilt[si] if prebuilt is not None and
              prebuilt[si] is not None else build_source(mesh, leaf_k))
        # relocate child / leaf pointers and triangle ids by the
        # aggregate offsets
        w = sb.nodes.copy()
        rows = sb.rows.copy()
        if rows.shape[1] != 10 * leaf_k:
            raise ValueError("prebuilt SourceBuild leaf_k mismatch")
        w[:, 4] += n_off
        w[:, 5] += l_off
        idv = rows.view(np.int32)[:, 9 * leaf_k: 10 * leaf_k]
        idv[idv >= 0] += t_off
        parts["nodes"].append(w)
        parts["rows"].append(rows)
        for k in ("p0", "e1", "e2", "mat", "n", "uv", "tan"):
            parts[k].append(getattr(sb, k))
        src_tables.append((n_off, t_off, sb.local_boxes))
        src_off.append(t_off)
        src_cnt.append(sb.p0.shape[0])
        src_aabb.append(np.stack([sb.local_boxes[:, 0].min(0),
                                  sb.local_boxes[:, 1].max(0)]))
        n_off += w.shape[0]
        t_off += sb.p0.shape[0]
        l_off += rows.shape[0]

    l2w_rows, w2l_rows, n_offs, t_offs, aabbs = [], [], [], [], []
    for src_id, m in instances:
        n0, t0, local_boxes = src_tables[src_id]
        n_offs.append(n0)
        t_offs.append(t0)
        l2w_rows.append(_mat34(m))
        w2l_rows.append(_mat34(np.linalg.inv(m)))
        aabbs.append(_world_aabb(local_boxes[:, 0].min(0),
                                 local_boxes[:, 1].max(0), m))

    # the TLAS nodes go first in the aggregate node table, so every BLAS
    # pointer shifts by n_tlas
    world_aabb = np.stack(aabbs).astype(np.float32)
    w2l = np.stack(w2l_rows)
    n_off_np = np.asarray(n_offs, np.int32)
    tlas_nodes, row_inst = _tlas(world_aabb)
    n_tlas = tlas_nodes.shape[0]
    inst_rows = pack_instance_rows(w2l[row_inst], n_off_np[row_inst] + n_tlas,
                                   row_inst, width=10 * leaf_k)
    blas_nodes = np.concatenate(parts["nodes"])
    blas_nodes[:, 4] += n_tlas
    cat = lambda k: np.concatenate(parts[k])
    return InstancedScene(
        cw_nodes=np.concatenate([tlas_nodes, blas_nodes]),
        leaf_rows=cat("rows"), tri_p0=cat("p0"), tri_e1=cat("e1"),
        tri_e2=cat("e2"), tri_mat=cat("mat"), node_offset=n_off_np + n_tlas,
        tri_offset=np.asarray(t_offs, np.int32), l2w=np.stack(l2w_rows),
        w2l=w2l, world_aabb=world_aabb, n_instances=len(instances),
        inst_rows=inst_rows, n_tlas_nodes=n_tlas, tri_n=cat("n"),
        tri_uv=cat("uv"), tri_tan=cat("tan"),
        src_tri_offset=np.asarray(src_off, np.int64),
        src_tri_count=np.asarray(src_cnt, np.int64),
        inst_src=np.asarray([s for s, _ in instances], np.int64),
        src_local_aabb=np.stack(src_aabb).astype(np.float32))


_APPEND_SHAPES = {"p0": (3,), "e1": (3,), "e2": (3,), "n": (3, 3),
                  "uv": (3, 2), "tan": (3,), "mat": ()}


def _world_light_tris(isc: InstancedScene, mats, l2w_rows: np.ndarray):
    """World-space copies of every emissive instance triangle (NEE needs
    world geometry; the shared BLAS rows are local). Returns (appended
    arrays, each local row's emissive rank in its source, each instance's
    first light row or -1)."""
    emis = np.array([np.max(m.emission) for m in mats], np.float32)
    mat_np = isc.tri_mat
    em_rank = np.full((mat_np.shape[0],), -1, np.int32)
    src_em_ids = []
    for s in range(len(isc.src_tri_offset)):
        o = int(isc.src_tri_offset[s])
        c = int(isc.src_tri_count[s])
        ids = o + np.nonzero(emis[mat_np[o:o + c]] > 0.0)[0]
        em_rank[ids] = np.arange(ids.size, dtype=np.int32)
        src_em_ids.append(ids.astype(np.int64))
    ap = {k: [] for k in _APPEND_SHAPES}
    light_offset = np.full((isc.n_instances,), -1, np.int32)
    total = 0
    for i in range(isc.n_instances):
        ids = src_em_ids[int(isc.inst_src[i])]
        if ids.size == 0:
            continue
        m34 = l2w_rows[i]
        rot = m34[:, :3]
        light_offset[i] = total
        total += ids.size
        ap["p0"].append(isc.tri_p0[ids] @ rot.T + m34[:, 3])
        ap["e1"].append(isc.tri_e1[ids] @ rot.T)
        ap["e2"].append(isc.tri_e2[ids] @ rot.T)
        nw = isc.tri_n[ids] @ rot.T
        nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
        ap["n"].append(nw)
        ap["uv"].append(isc.tri_uv[ids])
        ap["tan"].append(isc.tri_tan[ids] @ rot.T)
        ap["mat"].append(mat_np[ids])
    dt = lambda k: np.int32 if k == "mat" else np.float32
    if total == 0:
        app = {k: np.zeros((0,) + s, dt(k)) for k, s in
               _APPEND_SHAPES.items()}
    else:
        app = {k: np.concatenate(v).astype(dt(k)) for k, v in ap.items()}
    return app, em_rank, light_offset


def _light_power(app: dict, mats):
    """(power, cdf, pmf) of the appended world light rows."""
    area = 0.5 * np.linalg.norm(np.cross(app["e1"], app["e2"]), axis=-1)
    lum = np.array([0.2126 * m.emission[0] + 0.7152 * m.emission[1]
                    + 0.0722 * m.emission[2] for m in mats], np.float32)
    power = (area * lum[app["mat"]] * np.pi).astype(np.float32)
    cdf = np.cumsum(power)
    cdf /= max(cdf[-1], 1e-20)
    pmf = np.diff(np.concatenate([[0.0], cdf])).astype(np.float32)
    return power, cdf.astype(np.float32), pmf


def _light_bvh(tri: dict, ids: np.ndarray, power: np.ndarray) -> dict:
    """The light BVH, its pair rows and its cut over the lights `ids`."""
    from truetrace_tpu_torch.build.lightbvh import (
        build_cut, build_light_bvh, build_pairs)
    lb = build_light_bvh(tri, ids, power)
    pairs, pair_children = build_pairs(lb.nodes, lb.info)
    cut = build_cut(lb)
    return dict(lbvh_nodes=lb.nodes, lbvh_info=lb.info, lbvh_prim=lb.prim,
                lbvh_trail=lb.trail, lbvh_pairs=pairs,
                lbvh_pair_children=pair_children, lcut_bounds=cut.bounds,
                lcut_link=cut.link, lcut_node_ids=cut.node_ids,
                lcut_of_light=cut.of_light, lcut_skip=cut.skip)


def compile_scene_instanced(sources: Sequence[HostMesh], mats,
                            instances: Sequence[Tuple[int, np.ndarray]],
                            env=None, lights=None, atlas=None,
                            atlas_rects=None, atlas_level_y=None,
                            with_light_bvh: bool = False, prebuilt=None,
                            leaf_k: Optional[int] = None, device="cuda"):
    """A render-ready Scene on `device` (the card unless the caller asks
    for the CPU) for an instanced world, traced with traversal="tlas":
    the shared local-space BLASes, the TLAS, the instance rows, the world
    copies of the emissive instance triangles appended to the triangle
    arrays (NEE's light list, CDF and light BVH run over them).

    Returns (Scene, InstancedScene); keep the second for
    update_instance_transforms."""
    from truetrace_tpu_torch.scene.ir import (
        AnalyticLights, EnvMap, LightTris, MeshTable, Scene)
    from truetrace_tpu_torch.scene.mesh import (
        material_table, pack_light_rows, shadow_tint_table)

    isc = build_instanced(sources, instances, prebuilt=prebuilt,
                          leaf_k=leaf_k)
    app, em_rank, light_offset = _world_light_tris(isc, mats, isc.l2w)
    T_local = isc.tri_mat.shape[0]
    A = app["mat"].shape[0]
    tri = {k: np.concatenate([getattr(isc, f"tri_{k}"), app[k]])
           for k in _APPEND_SHAPES}
    T = T_local + A
    if A > 0:
        ids = (T_local + np.arange(A)).astype(np.int32)
        power, cdf, pmf = _light_power(app, mats)
        inv = np.full((T,), -1, np.int32)
        inv[ids] = np.arange(A, dtype=np.int32)
        lt = dict(tri_index=ids, power=power, cdf=cdf, pmf=pmf,
                  tri_to_light=inv,
                  rows=pack_light_rows(tri["p0"][ids], tri["e1"][ids],
                                       tri["e2"][ids], tri["mat"][ids], pmf))
    else:
        lt = dict(tri_index=np.zeros((0,), np.int32),
                  power=np.zeros((0,), np.float32),
                  cdf=np.zeros((0,), np.float32),
                  pmf=np.zeros((0,), np.float32),
                  tri_to_light=np.full((T,), -1, np.int32),
                  rows=np.zeros((0, 16), np.float32))
    lb = dict(lbvh_nodes=np.zeros((0, 12), np.float32),
              lbvh_info=np.zeros((0, 2), np.int32),
              lbvh_prim=np.zeros((0,), np.int32),
              lbvh_trail=np.zeros((0,), np.uint32),
              lbvh_pairs=np.zeros((0, 26), np.float32),
              lbvh_pair_children=np.zeros((0, 2), np.int32))
    if with_light_bvh and A > 1:
        lb = _light_bvh(tri, lt["tri_index"], lt["power"])

    w2l44 = np.stack([np.linalg.inv(m) for _, m in instances]).astype(
        np.float32)
    l2w44 = np.stack([m for _, m in instances]).astype(np.float32)
    mesh_table = MeshTable.from_numpy(dict(
        w2l=w2l44, l2w=l2w44, node_offset=isc.node_offset,
        tri_offset=isc.tri_offset, light_node_offset=light_offset,
        aabb=isc.world_aabb), device)
    d = dict(
        tri_p0=tri["p0"], tri_e1=tri["e1"], tri_e2=tri["e2"],
        tri_n=tri["n"], tri_uv=tri["uv"], tri_tan=tri["tan"],
        tri_mat=tri["mat"], bvh2_box=np.zeros((0, 2, 3), np.float32),
        bvh2_left=np.zeros((0,), np.int32),
        bvh2_count=np.zeros((0,), np.int32), cw_nodes=isc.cw_nodes,
        cw_tri_index=np.zeros((0,), np.int32), cw_leaf_rows=isc.leaf_rows,
        atlas=np.asarray(atlas, np.float32) if atlas is not None
        else np.zeros((1, 1, 4), np.float32),
        atlas_rects=np.asarray(atlas_rects, np.int32)
        if atlas_rects is not None else np.zeros((0, 4), np.int32),
        atlas_level_y=np.asarray(atlas_level_y, np.int32)
        if atlas_level_y is not None else np.zeros((1,), np.int32),
        tri_lod=np.zeros((T,), np.float32),
        tri_shadow=shadow_tint_table(mats, tri["mat"]),
        has_media=any(m.spec_trans > 0.0 and m.thin < 0.5 for m in mats),
        inst_rows=isc.inst_rows, inst_l2w=isc.l2w, inst_em_rank=em_rank,
        inst_light_offset=light_offset, **lb)
    scene = Scene.from_parts(
        d, material_table(mats, device), LightTris.from_numpy(lt, device),
        lights.to(device) if lights is not None
        else AnalyticLights.none(device),
        env.to(device) if env is not None
        else EnvMap.constant((0.0, 0.0, 0.0), device), device)
    return dataclasses.replace(scene, mesh_table=mesh_table), isc


def update_instance_transforms(scene, isc: InstancedScene, mats,
                               instances: Sequence[Tuple[int, np.ndarray]]):
    """New instance transforms: rebuild the TLAS over the transformed
    source AABBs on the host and refresh the instance rows, inst_l2w, the
    world light rows, the light CDF and the light BVH; the shared BLASes
    are untouched. The TLAS must keep its node count (the JAX package
    asserts it; recompile otherwise). Returns (new Scene, new
    InstancedScene); the new scene's tensors have the old one's shapes."""
    from truetrace_tpu_torch.scene.ir import LightTris, _t, light_bvh_depth
    from truetrace_tpu_torch.scene.mesh import pack_light_rows
    dev = scene.device
    l2w_rows = np.stack([_mat34(m) for _, m in instances])
    w2l_rows = np.stack([_mat34(np.linalg.inv(m)) for _, m in instances])
    world_aabb = np.stack([
        _world_aabb(*isc.src_local_aabb[src_id], m)
        for src_id, m in instances]).astype(np.float32)
    tlas_nodes, row_inst = _tlas(world_aabb)
    n_tlas = tlas_nodes.shape[0]
    if n_tlas != isc.n_tlas_nodes:
        raise ValueError("TLAS node count changed; rebuild with "
                         "compile_scene_instanced")
    inst_rows = pack_instance_rows(w2l_rows[row_inst],
                                   isc.node_offset[row_inst], row_inst,
                                   width=isc.leaf_rows.shape[1])
    nodes = isc.cw_nodes.copy()
    nodes[:n_tlas] = tlas_nodes
    new_isc = dataclasses.replace(isc, cw_nodes=nodes, l2w=l2w_rows,
                                  w2l=w2l_rows, world_aabb=world_aabb,
                                  inst_rows=inst_rows)
    app, _, light_offset = _world_light_tris(new_isc, mats, l2w_rows)
    T_local = isc.tri_mat.shape[0]
    t = lambda a: _t(a, dev)
    upd = dict(cw_nodes=_t(nodes, dev, torch.int32),
               inst_rows=t(inst_rows), inst_l2w=t(l2w_rows),
               inst_light_offset=t(light_offset), _cw_table=None,
               _bvh2_table=None)
    if app["mat"].shape[0] > 0:
        # the appended world light rows in place (the emissive topology
        # is fixed; only the transforms move)
        full = {}
        for key in ("p0", "e1", "e2", "n", "tan"):
            col = f"tri_{key}"
            full[key] = getattr(scene, col).cpu().numpy().copy()
            full[key][T_local:] = app[key]
            upd[col] = t(full[key])
        ids = scene.light_tris.tri_index.cpu().numpy()
        power, cdf, pmf = _light_power(app, mats)
        em_ids = ids - T_local
        upd["light_tris"] = LightTris(
            tri_index=scene.light_tris.tri_index, power=t(power),
            cdf=t(cdf), pmf=t(pmf),
            tri_to_light=scene.light_tris.tri_to_light,
            rows=t(pack_light_rows(app["p0"][em_ids], app["e1"][em_ids],
                                   app["e2"][em_ids], app["mat"][em_ids],
                                   pmf)))
        if scene.lbvh_pairs.shape[0] > 0:
            lb = _light_bvh(full, ids, power)
            for k, v in lb.items():
                upd[k] = _t(v, dev, torch.int32 if v.dtype == np.uint32
                            else None)
            upd["lbvh_depth"] = light_bvh_depth(lb["lbvh_info"])
    return dataclasses.replace(scene, **upd), new_isc

