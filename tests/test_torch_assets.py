"""Torch port, the AssetManager and video textures, against the JAX
package, bit for bit.

AssetManager.commit under each policy: an instance added and one
removed (topology: re-aggregated from the cached BLASes),
set_transform (the TLAS-only update, no BLAS rebuilt), a move that
changes the TLAS's node count (update_instance_transforms refuses it and
the commit re-aggregates from the cached BLASes), a material edit (the
table swap) and a clean commit (the cached scene). Every table of the
committed scene is compared with the JAX commit's. Video textures: the
atlas after binding each frame (by index, wrapped, and by time) at every
mip level."""
import dataclasses

import numpy as np
import pytest
import torch

from truetrace_tpu.scene import asset_manager as jam_mod
from truetrace_tpu.scene import video as jvideo
from truetrace_tpu.scene.atlas import AtlasBuilder as JAtlasBuilder
from truetrace_tpu.scene.instances import make_transform
from truetrace_tpu.scene.mesh import HostMaterial as JMat
from truetrace_tpu.scene.mesh import HostMesh as JMesh
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.scene import asset_manager as tam_mod
from truetrace_tpu_torch.scene import video as tvideo
from truetrace_tpu_torch.scene.atlas import AtlasBuilder as TAtlasBuilder
from truetrace_tpu_torch.scene.mesh import HostMaterial as TMat
from truetrace_tpu_torch.scene.mesh import HostMesh as TMesh
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile

from torch_parity import leaves

# tests/test_instanced_render.py's sources: a box, a floor, a light
# facing down; N_BOXES + 2 instances, so the TLAS has several nodes
_BOX = (np.array([[x, y, z] for x in (-.4, .4) for y in (0, .8)
                  for z in (-.4, .4)], np.float32),
        np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int32))


N_BOXES = 15
_CLUSTERS = ((55.0, -184.0), (-193.0, 165.0), (43.0, 17.0))


def _quad(y, half, down=False):
    v = np.array([[-half, y, -half], [half, y, -half], [half, y, half],
                  [-half, y, half]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2]] if not down else
                 [[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def _instances():
    out = [(1, make_transform((0, 0, 0)))]
    for k in range(N_BOXES):
        out.append((0, make_transform((-3.0 + 0.4 * k, 0.4, 0.3 * (k % 3)),
                                      rot_y=0.3 * k, scale=0.6 + 0.02 * k)))
    out.append((2, make_transform((0.0, 2.5, 0.0), rot_y=0.3)))
    return out


def _manager(pkg):
    mesh_cls, mat_cls, mod = ((JMesh, JMat, jam_mod) if pkg == "jax"
                              else (TMesh, TMat, tam_mod))
    mats = [mat_cls(base_color=(0.75, 0.75, 0.75)),
            mat_cls(base_color=(0.8, 0.2, 0.2)),
            mat_cls(emission=(12.0, 11.0, 10.0))]
    srcs = [mesh_cls(*_BOX, np.ones(12, np.int32)),
            mesh_cls(*_quad(0.0, 4.0), np.zeros(2, np.int32)),
            mesh_cls(*_quad(0.0, 0.6, down=True), np.full(2, 2, np.int32))]
    kw = dict(with_light_bvh=True)
    if pkg == "torch":
        kw["device"] = "cpu"
    am = mod.AssetManager(materials=mats, **kw)
    src_h = [am.add_mesh(s) for s in srcs]
    inst_h = [am.add_instance(src_h[s], m) for s, m in _instances()]
    return am, mod, inst_h


def _compare(js, ts):
    """Every tensor of the port's scene against the JAX scene's field of
    the same name (nested parts included), bit for bit."""
    want = leaves(js)
    n = 0

    def walk(obj, w, prefix):
        nonlocal n
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name.startswith("_") or f.name not in w:
                continue
            if dataclasses.is_dataclass(v):
                walk(v, w[f.name], f"{prefix}{f.name}.")
            elif isinstance(v, torch.Tensor):
                a, b = np.asarray(w[f.name]), v.numpy()
                assert a.shape == b.shape, prefix + f.name
                if a.dtype.kind == "f":
                    assert (a.view(np.int32) == b.view(np.int32)).all(), \
                        prefix + f.name
                else:
                    assert ((a.astype(np.int64) & 0xFFFFFFFF)
                            == (b.astype(np.int64) & 0xFFFFFFFF)).all(), \
                        prefix + f.name
                n += 1
            elif v is None:
                assert w[f.name] is None, prefix + f.name
    walk(ts, want, "")
    assert n >= 30, n


def _counting(mod, mp):
    """Count the manager's BLAS builds."""
    calls = []
    orig = mod.build_source
    mp.setattr(mod, "build_source",
               lambda m, **kw: calls.append(1) or orig(m, **kw))
    return calls


@pytest.mark.parametrize("policy", ["topology", "transforms",
                                    "transforms_fallback", "materials",
                                    "clean"])
def test_commit_matches_jax(policy, monkeypatch):
    """Both managers take the same queue of mutations; the committed
    scenes are equal table for table, and the port rebuilds a BLAS
    exactly where the JAX manager does (none but the first commit)."""
    out = []
    for pkg in ("jax", "torch"):
        am, mod, inst_h = _manager(pkg)
        first = am.commit()
        calls = _counting(mod, monkeypatch)
        if policy == "topology":
            am.add_instance(0, make_transform((0.0, 0.4, 1.5), rot_y=0.9,
                                              scale=0.6))
            am.remove_instance(inst_h[2])
        elif policy == "transforms":
            am.set_transform(inst_h[3], make_transform(
                (-0.6, 0.7, 0.4), rot_y=1.1))
        elif policy == "transforms_fallback":
            # the boxes gathered in three far clusters: the TLAS takes
            # another node count
            for k, h in enumerate(inst_h[1:1 + N_BOXES]):
                c = _CLUSTERS[k % 3]
                am.set_transform(h, make_transform(
                    (c[0] + 0.3 * (k // 3), 0.4, c[1] - 0.2 * (k // 3)),
                    rot_y=0.2 * k))
        elif policy == "materials":
            am.set_material(1, (JMat if pkg == "jax" else TMat)(
                base_color=(0.2, 0.6, 0.9), spec_trans=0.5, roughness=0.2))
            assert not am._topology_dirty
        scene = am.commit()
        assert (scene is first) == (policy == "clean")
        out.append((scene, am.instanced, calls))
        monkeypatch.undo()
    (js, jisc, jcalls), (ts, tisc, tcalls) = out
    assert tcalls == jcalls == []
    assert tisc.n_tlas_nodes == jisc.n_tlas_nodes
    _compare(js, ts)
    if policy == "transforms_fallback":
        am, mod, _ = _manager("torch")
        am.commit()
        assert am.instanced.n_tlas_nodes != tisc.n_tlas_nodes
    if policy == "materials":
        assert ts.tri_shadow is not None and ts.has_media


def _video(pkg, seed=0):
    """A 5-frame 20x12 RGB clip (padded to 32x16: four mip levels) in an
    atlas beside a 16x16 texture, on a textured quad."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (5, 12, 20, 3)).astype(np.float32)
    other = (rng.uniform(0, 1, (16, 16, 3)) * 255).astype(np.uint8)
    builder = JAtlasBuilder() if pkg == "jax" else TAtlasBuilder()
    builder.add(other)
    if pkg == "jax":
        vid = jvideo.register_video(builder, frames, fps=12.0)
    else:
        vid = tvideo.register_video(builder, frames, fps=12.0, device="cpu")
    atlas, rects, level_y = builder.build()
    mesh_cls, mat_cls = (JMesh, JMat) if pkg == "jax" else (TMesh, TMat)
    quad = mesh_cls(*_quad(0.0, 1.0), np.zeros(2, np.int32),
                    uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]],
                                 np.float32))
    mats = [mat_cls(emission=(4, 4, 4), tex_emission=vid.tex_id)]
    kw = dict(atlas=atlas, atlas_rects=rects, atlas_level_y=level_y,
              with_cwbvh=True)
    scene = (jcompile([quad], mats, **kw) if pkg == "jax"
             else tcompile([quad], mats, device="cpu", **kw))
    return scene, vid


def test_video_atlas_matches_jax():
    """The atlas at every mip level after bind_video_frame (each frame, a
    wrapped index, a 0-d tensor index) and bind_video_time, bit for bit;
    a bind leaves the scene it was given unchanged."""
    js, jv = _video("jax")
    ts, tv = _video("torch")
    assert np.asarray(js.atlas_level_y).shape[0] == 4
    assert (np.asarray(jv.frames) == tv.frames.numpy()).all()
    before = ts.atlas.clone()
    for k in (0, 3, 7):
        a = np.asarray(jvideo.bind_video_frame(js, jv, k).atlas)
        b = tvideo.bind_video_frame(ts, tv, k).atlas.numpy()
        assert (a.view(np.int32) == b.view(np.int32)).all(), k
    b = tvideo.bind_video_frame(ts, tv, torch.tensor(7)).atlas.numpy()
    assert (a.view(np.int32) == b.view(np.int32)).all()
    a = np.asarray(jvideo.bind_video_time(js, jv, 0.3).atlas)
    b = tvideo.bind_video_time(ts, tv, 0.3).atlas.numpy()
    assert (a.view(np.int32) == b.view(np.int32)).all()
    assert not np.array_equal(b, before.numpy())
    assert torch.equal(ts.atlas, before)
