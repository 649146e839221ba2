"""Torch port, instanced scenes: the host build (build_instanced,
compile_scene_instanced, update_instance_transforms) bit for bit against
the JAX package's, and the plain two-level traversal (the CPU path of
closest_hit_tlas / any_hit_tlas / transmit_tlas, and the CUDA kernel's
reference on the card) against the JAX `cwbvh_tlas` queries, on 3
sources under 40 instances with rotations and non-uniform scales, with
the JAX depth-16 stack and a 2-entry stack that drops entries."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.kernels import cwbvh_tlas as jtlas
from truetrace_tpu.scene import instances as jinst
from truetrace_tpu.scene.mesh import HostMaterial as JMat
from truetrace_tpu.scene.mesh import HostMesh as JMesh
from truetrace_tpu.scene.primitives import grid, uv_sphere
from truetrace_tpu_torch.kernels import cwbvh_tlas as ttlas
from truetrace_tpu_torch.kernels.cwbvh_wavefront import pack_table
from truetrace_tpu_torch.scene import instances as tinst
from truetrace_tpu_torch.scene.mesh import HostMaterial as TMat
from truetrace_tpu_torch.scene.mesh import HostMesh as TMesh

from torch_parity import leaves

N_INST = 40


def _geometry():
    """(positions, indices, material) of the 3 sources: a sphere deep
    enough for a 2-entry stack to drop entries, a ground grid, a box."""
    sv, si, _ = uv_sphere(16, 24, radius=0.5)
    gv, gi, _ = grid(3, 3, 2.0, 2.0)
    bv = np.array([[x, y, z] for x in (-.3, .3) for y in (0, .9)
                   for z in (-.3, .3)], np.float32)
    bf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                   [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                   [1, 5, 7], [1, 7, 3]], np.int32)
    return [(sv, si, 0), (gv, gi, 1), (bv, bf, 2)]


def _instances(n=N_INST, seed=0):
    """(source, l2w) pairs: yaw and pitch, non-uniform scale, translation."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        th, ph = rng.uniform(0, 2 * np.pi), rng.uniform(-0.5, 0.5)
        ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                       [-np.sin(th), 0, np.cos(th)]])
        rx = np.array([[1, 0, 0], [0, np.cos(ph), -np.sin(ph)],
                       [0, np.sin(ph), np.cos(ph)]])
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.diag(rng.uniform(0.5, 1.8, 3)) @ rx @ ry
        m[3, :3] = rng.uniform(-4, 4, 3)
        out.append((k % 3, m))
    return out


def _sources(mesh_cls):
    return [mesh_cls(positions=v.astype(np.float32),
                     indices=i.astype(np.int32),
                     mat_id=np.full(len(i), m, np.int32))
            for v, i, m in _geometry()]


@pytest.fixture(scope="module")
def built():
    inst = _instances()
    js = jinst.build_instanced(_sources(JMesh), inst)
    ts = tinst.build_instanced(_sources(TMesh), inst)
    table = pack_table(torch.from_numpy(ts.cw_nodes.view(np.int32)),
                       torch.from_numpy(ts.leaf_rows),
                       torch.from_numpy(ts.inst_rows))
    return js, ts, table


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1)
    R = 1500
    ro = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.5, 12, R).astype(np.float32)
    tm[:50] = 0.0                        # dead lanes
    tm[50:800] = 1e30
    return ro, rd, tm


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_build_instanced_tables_match_jax(built):
    """Nodes (TLAS then relocated BLASes), leaf rows, instance rows (W2L,
    BLAS root, instance id in TLAS leaf order), offsets, transforms and
    world bounds, bit for bit."""
    js, ts, table = built
    for f in ("cw_nodes", "leaf_rows", "inst_rows", "node_offset",
              "tri_offset", "l2w", "w2l", "world_aabb", "tri_p0", "tri_e1",
              "tri_e2", "tri_mat", "tri_n", "tri_uv", "tri_tan",
              "src_tri_offset", "src_tri_count", "inst_src",
              "src_local_aabb"):
        want, got = np.asarray(getattr(js, f)), getattr(ts, f)
        assert got.shape == want.shape, f
        assert (want.view(np.int32) == got.view(np.int32)).all() \
            if want.dtype.itemsize == 4 else (want == got).all(), f
    assert ts.n_tlas_nodes == js.n_tlas_nodes
    C, L, I = ts.cw_nodes.shape[0], ts.leaf_rows.shape[0], N_INST
    assert table.shape == (C + L + I, ts.leaf_rows.shape[1])


_PAIRS = {}


def _scene_pair(inst, with_light_bvh=True):
    """An emissive source (a quad facing down) among the 3, compiled by
    both packages with the light BVH over the world light rows (built
    once a module for the same instances)."""
    key = (tuple((s, m.tobytes()) for s, m in inst), with_light_bvh)
    if key not in _PAIRS:
        _PAIRS[key] = _build_pair(inst, with_light_bvh)
    return _PAIRS[key]


def _build_pair(inst, with_light_bvh):
    quad = (np.array([[-.3, 0, -.3], [.3, 0, -.3], [.3, 0, .3], [-.3, 0, .3]],
                     np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    out = []
    for mesh_cls, mat_cls, pkg in ((JMesh, JMat, jinst),
                                   (TMesh, TMat, tinst)):
        srcs = _sources(mesh_cls) + [mesh_cls(quad[0], quad[1],
                                              np.full(2, 3, np.int32))]
        mats = [mat_cls(base_color=(0.7, 0.6, 0.5)),
                mat_cls(base_color=(0.2, 0.8, 0.3), roughness=0.3),
                mat_cls(base_color=(0.5, 0.5, 0.9), metallic=0.5),
                mat_cls(emission=(8.0, 6.0, 4.0))]
        kw = {} if pkg is jinst else dict(device="cpu")
        sc, isc = pkg.compile_scene_instanced(
            srcs, mats, inst, with_light_bvh=with_light_bvh, **kw)
        out.append((sc, isc, mats))
    return out


_SCENE_FIELDS = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_tan",
                 "tri_mat", "cw_nodes", "cw_leaf_rows", "inst_rows",
                 "inst_l2w", "inst_em_rank", "inst_light_offset",
                 "tri_shadow", "lbvh_nodes", "lbvh_info", "lbvh_prim",
                 "lbvh_trail", "lbvh_pairs", "lbvh_pair_children",
                 "lcut_bounds", "lcut_link", "lcut_node_ids",
                 "lcut_of_light", "lcut_skip")


def _same_scene(js, ts):
    for f in _SCENE_FIELDS:
        want, got = getattr(js, f), getattr(ts, f)
        if want is None:
            assert got is None, f
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape, f
        if want.dtype.kind == "f":
            assert (want.view(np.int32) == got.view(np.int32)).all(), f
        else:
            m32 = lambda a: a.astype(np.int64) & 0xFFFFFFFF
            assert (m32(want) == m32(got)).all(), f
    for f in dataclasses.fields(ts.light_tris):
        want = np.asarray(getattr(js.light_tris, f.name))
        got = getattr(ts.light_tris, f.name).numpy()
        assert got.shape == want.shape and (got == want).all(), f.name
    for f in dataclasses.fields(ts.mesh_table):
        want = np.asarray(getattr(js.mesh_table, f.name))
        got = getattr(ts.mesh_table, f.name).numpy()
        assert got.shape == want.shape and (got == want).all(), f.name


@pytest.mark.parametrize("stage", ["compile", "update"])
def test_scene_instanced_matches_jax(stage):
    """compile_scene_instanced's scene (the world light rows appended to
    the triangles, inst_em_rank, inst_light_offset, the light list, the
    light BVH and its cut), and after update_instance_transforms moving
    three instances (one an emitter), exactly the JAX package's."""
    inst = _instances(12, seed=3) + [
        (3, jinst.make_transform((x, 3.0, -x), rot_y=0.2 * x))
        for x in (-1.0, 0.5, 2.0)]
    (js, jisc, jmats), (ts, tisc, tmats) = _scene_pair(inst)
    if stage == "update":
        moved = [(s, m.copy()) for s, m in inst]
        for k in (1, 5, 13):
            moved[k][1][3, 1] += 0.002 * k
        js, _ = jinst.update_instance_transforms(js, jisc, jmats, moved)
        ts, _ = tinst.update_instance_transforms(ts, tisc, tmats, moved)
    assert ts.light_tris.tri_index.shape[0] == 6
    _same_scene(js, ts)


def _jax_query(js, query, ro, rd, tm, stack, tint=None):
    a = (js.cw_nodes, js.leaf_rows, js.inst_rows)
    r = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm))
    if query == "closest":
        return jtlas.closest_hit_tlas(*a, *r, max_stack=stack)
    if query == "any":
        return jtlas.any_hit_tlas(*a, *r, max_stack=stack)
    return jtlas.transmit_tlas(*a, jnp.asarray(tint), *r, max_stack=stack)


# The closest hit is the JAX traversal's on every one of these 1500 rays
# (both stacks). Two of them once differed in t's last bits: the entry's
# sqrt(s2) went through torch.sqrt, which on a CPU tensor is not rounded
# to nearest; the port takes core/math.py sqrt_rn, as XLA and the kernel's
# __fsqrt_rn round (ROADMAP.md §C.2).
CLOSEST_SHARE = 1.0


def _closest_pair(built, rays, stack):
    js, ts, table = built
    ro, rd, tm = rays
    jh, ji = _jax_query(js, "closest", ro, rd, tm, stack)
    th, ti = ttlas.closest_hit_tlas(table, ts.cw_nodes.shape[0],
                                    ts.leaf_rows.shape[0],
                                    torch.from_numpy(ro), torch.from_numpy(rd),
                                    torch.from_numpy(tm), max_stack=stack)
    same = np.ones(len(ro), bool)
    for f in ("t", "u", "v"):
        same &= _bits(getattr(jh, f)) == _bits(getattr(th, f).numpy())
    same &= np.asarray(jh.tri) == th.tri.numpy()
    same &= np.asarray(ji) == ti.numpy()
    return (jh, ji), (th, ti), same


@pytest.mark.parametrize("stack", [16, 2])
def test_closest_hit_tlas_plain_matches_jax(built, rays, stack):
    """t, u, v bitwise, inst and tri equal, on >= CLOSEST_SHARE of the
    rays (all of them), tri and inst on all; dead lanes miss (t = 0, tri = inst = -1). The 2-entry stack drops entries,
    and changes the answer of some rays exactly as JAX's does."""
    js = built[0]
    ro, rd, tm = rays
    (jh, ji), (th, ti), same = _closest_pair(built, rays, stack)
    assert same.mean() >= CLOSEST_SHARE, same.mean()
    assert (np.asarray(jh.tri) == th.tri.numpy()).all()
    assert (np.asarray(ji) == ti.numpy()).all()
    assert (th.tri.numpy()[:50] == -1).all() and (ti.numpy()[:50] == -1).all()
    assert (th.t.numpy()[:50] == 0).all()
    hit = th.tri.numpy() >= 0
    assert hit.mean() > 0.1 and (ti.numpy()[hit] >= 0).all()
    if stack == 2:
        j16, _ = _jax_query(js, "closest", ro, rd, tm, 16)
        assert (np.asarray(j16.tri) != np.asarray(jh.tri)).any()


def test_closest_hit_tlas_entry_divides(built, rays, monkeypatch):
    """The JAX traversal divides the local direction by its length: with
    XLA:CPU's own rsqrt product (its standalone x / sqrt(s)) in the
    entry, the port's closest hit leaves the JAX one on many more rays
    than the division (which leaves it on none)."""
    _rsqrt = jax.jit(jax.lax.rsqrt)

    def xla_dir(ldx, ldy, ldz, s2):
        r = torch.from_numpy(np.array(_rsqrt(s2.numpy())))
        return torch.stack([ldx * r, ldy * r, ldz * r], -1)

    _, _, divided = _closest_pair(built, rays, 16)
    monkeypatch.setattr(ttlas, "_local_dir", xla_dir)
    _, _, rsqrt = _closest_pair(built, rays, 16)
    assert (~rsqrt).sum() > 20 * (~divided).sum()


@pytest.mark.parametrize("stack", [16, 2])
def test_any_hit_tlas_plain_matches_jax(built, rays, stack):
    """Occlusion equal on every ray."""
    js, ts, table = built
    ro, rd, tm = rays
    want = np.asarray(_jax_query(js, "any", ro, rd, tm, stack))
    got = ttlas.any_hit_tlas(table, ts.cw_nodes.shape[0],
                             ts.leaf_rows.shape[0], torch.from_numpy(ro),
                             torch.from_numpy(rd), torch.from_numpy(tm),
                             max_stack=stack).numpy()
    assert (want == got).all()
    assert 0.05 < got.mean() < 0.95 and not got[:50].any()


@pytest.mark.parametrize("stack", [16, 2])
def test_transmit_tlas_plain_matches_jax(built, rays, stack):
    """The transmittance through random tints (global triangle ids, the
    instances sharing their source's), bitwise on every ray; dead lanes
    are clear."""
    js, ts, table = built
    ro, rd, tm = rays
    tint = np.random.default_rng(4).uniform(
        0, 1, (ts.tri_p0.shape[0], 3)).astype(np.float32)
    want = np.asarray(_jax_query(js, "transmit", ro, rd, tm, stack, tint))
    got = ttlas.transmit_tlas(table, ts.cw_nodes.shape[0],
                              ts.leaf_rows.shape[0], torch.from_numpy(tint),
                              torch.from_numpy(ro), torch.from_numpy(rd),
                              torch.from_numpy(tm), max_stack=stack).numpy()
    assert (_bits(want) == _bits(got)).all()
    partial = ((got > 0) & (got < 1)).any(-1)
    assert partial.mean() > 0.05 and (got[:50] == 1).all()


def test_closest_hit_tlas_iteration_cap_matches_jax(built, rays,
                                                   monkeypatch):
    """Both loops stop a ray at the iteration cap the same way: with the
    cap lowered to 5 in the JAX loop (`_ITER_CAP`, traced afresh) and in
    the plain version (`ITER_CAP`), t, u, v, tri and inst agree bit for
    bit, where over 50 rays take an instance entry as their 5th
    iteration (their entries counted at caps 4 and 5 differ; the BLAS
    root decode is cut off) and the cap changes over 50 rays' hits.
    The card's kernel is held to the plain version at a lowered cap in
    tests/test_torch_cuda.py."""
    from functools import partial
    js, ts, table = built
    ro, rd, tm = rays
    a = (table, ts.cw_nodes.shape[0], ts.leaf_rows.shape[0],
         torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tm))
    full, _ = ttlas.closest_hit_tlas_plain(*a)
    counts = []
    for cap in (4, 5):
        monkeypatch.setattr(ttlas, "ITER_CAP", cap)
        counts.append({})
        th, ti = ttlas.closest_hit_tlas_plain(*a, counts=counts[-1])
    monkeypatch.setattr(jtlas, "_ITER_CAP", 5)
    jh, ji = jax.jit(partial(jtlas._traverse_tlas, any_hit=False,
                             tlas_root=0, max_stack=16))(
        js.cw_nodes, js.leaf_rows, js.inst_rows, jnp.asarray(ro),
        jnp.asarray(rd), jnp.asarray(tm))
    for f in ("t", "u", "v"):
        assert (_bits(getattr(jh, f)) == _bits(getattr(th, f).numpy())).all()
    assert (np.asarray(jh.tri) == th.tri.numpy()).all()
    assert (np.asarray(ji) == ti.numpy()).all()
    assert int((counts[1]["inst_entries"] > counts[0]["inst_entries"]).sum()
               ) > 50
    assert int((full.tri != th.tri).sum()) > 50


def test_plain_counts_the_work(built, rays):
    """The plain traversal's work counters (chip_smoke.py bounds the
    kernel by them): every live ray decodes the root; entries and
    triangle tests happen on the rays that reach an instance."""
    _, ts, table = built
    ro, rd, tm = rays
    counts = {}
    hit, inst = ttlas.closest_hit_tlas_plain(
        table, ts.cw_nodes.shape[0], ts.leaf_rows.shape[0],
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tm),
        counts=counts)
    live = torch.from_numpy(tm > 0)
    assert counts["live_rays"] == int(live.sum())
    assert bool((counts["node_decodes"][live] >= 1).all())
    assert int(counts["node_decodes"][~live].sum()) == 0
    entered = counts["inst_entries"] > 0
    assert bool((inst[~entered] == -1).all())
    assert bool((counts["tri_tests"][hit.tri >= 0] > 0).all())
    assert 0 < counts["rows_touched"] <= table.shape[0]


def test_scene_from_numpy_carries_instances():
    """Scene.from_numpy takes an instanced JAX scene (its mesh table and
    instance tables) and packs the three-section traversal table."""
    from truetrace_tpu_torch.scene.ir import Scene
    (js, _, _), (ts, _, _) = _scene_pair(_instances(6, seed=5) + [
        (3, jinst.make_transform((0.0, 3.0, 0.0)))], with_light_bvh=False)
    sc = Scene.from_numpy(leaves(js), "cpu")
    _same_scene(js, sc)
    assert torch.equal(sc.cw_table(), ts.cw_table())
