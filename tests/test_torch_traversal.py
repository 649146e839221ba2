"""Torch port, CWBVH traversal: the plain lock-step traversal (the CPU
path of closest_hit_wavefront / any_hit_wavefront, and the CUDA kernel's
reference on the card) against the JAX single-stage `_traverse`, the
brute-force oracle, and the Pallas step core, on the ray set of
tests/test_step_pallas.py (atrium detail 0.2: 512 camera rays and 512
bounce rays) plus dead lanes with t_max = 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import truetrace_tpu.kernels.cwbvh_wavefront as jwf
from truetrace_tpu.core import rng
from truetrace_tpu.core.math import sample_cosine_hemisphere, to_world
from truetrace_tpu.kernels.step_pallas import step_core as jstep_core
from truetrace_tpu.kernels.traverse_ref import brute_force_closest as jbrute
from truetrace_tpu.scene import atrium
from truetrace_tpu.scene.ir import camera_rays
from truetrace_tpu.scene.mesh import compile_scene
from truetrace_tpu_torch.kernels import cwbvh_wavefront as twf
from truetrace_tpu_torch.kernels.step_pallas import step_core_plain
from truetrace_tpu_torch.kernels.traverse_ref import brute_force_closest
from truetrace_tpu_torch.scene.ir import Scene

from torch_parity import leaves

N_DEAD = 64
_scenes = {}


def _scene(k):
    if k not in _scenes:
        meshes, mats, _, env = atrium.make(detail=0.2)
        js = compile_scene(meshes, mats, env=env, with_cwbvh=True, leaf_k=k)
        _scenes[k] = (js, Scene.from_numpy(leaves(js), "cpu"))
    return _scenes[k]


@pytest.fixture(scope="module")
def rays():
    meshes, mats, cam, env = atrium.make(detail=0.2)
    R = 512
    pix = jnp.arange(R, dtype=jnp.uint32)
    jit2 = rng.uniform2(pix, jnp.uint32(0), jnp.uint32(0))
    ro, rd = camera_rays(cam, 32, R // 32, pix.astype(jnp.int32), jit2)
    u2 = rng.uniform2(pix, jnp.uint32(1), jnp.uint32(3))
    gn = jnp.stack([jnp.zeros(R), jnp.ones(R), jnp.zeros(R)], -1)
    rd2 = to_world(gn, sample_cosine_hemisphere(u2))
    ro2 = ro + rd * 2.0
    ro = np.asarray(jnp.concatenate([ro, ro2, ro[:N_DEAD]]))
    rd = np.asarray(jnp.concatenate([rd, rd2, rd[:N_DEAD]]))
    t_max = np.full(ro.shape[0], 1e30, np.float32)
    t_max[-N_DEAD:] = 0.0
    return ro, rd, t_max


def _jax(js, ro, rd, t_max, any_hit):
    return jwf._traverse(js.cw_nodes, js.cw_leaf_rows, jnp.asarray(ro),
                         jnp.asarray(rd), jnp.asarray(t_max), any_hit,
                         js.cw_stack)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hit_np(h):
    return twf.Hit(*(_t(x) for x in h))


@pytest.mark.parametrize("k", [3, 6])
def test_closest_hit_bitwise(rays, k):
    """t, tri, u and v are bitwise the JAX ones (the same lock-step
    iteration, the same rounding: XLA's contracted mul-adds are fma()s).
    Dead lanes (t_max = 0) miss."""
    js, ts = _scene(k)
    ro, rd, t_max = rays
    a = _jax(js, ro, rd, t_max, False)
    b = twf.closest_hit_wavefront(ts.cw_table(), ts.cw_nodes.shape[0],
                                  _t(ro), _t(rd), _t(t_max), ts.cw_stack)
    np.testing.assert_array_equal(np.asarray(a.t), b.t.numpy())
    np.testing.assert_array_equal(np.asarray(a.tri), b.tri.numpy())
    np.testing.assert_array_equal(np.asarray(a.u), b.u.numpy())
    np.testing.assert_array_equal(np.asarray(a.v), b.v.numpy())
    tri = b.tri.numpy()
    assert (tri[:-N_DEAD] >= 0).mean() > 0.9
    assert (tri[-N_DEAD:] == -1).all() and (b.t.numpy()[-N_DEAD:] == 0).all()


@pytest.mark.parametrize("k", [3, 6])
def test_any_hit_occlusion_equal(rays, k):
    """Occlusion against finite t_max segments (and dead lanes) equals
    the JAX any-hit traversal's."""
    js, ts = _scene(k)
    ro, rd, _ = rays
    r = np.random.default_rng(5)
    t_max = r.uniform(0.05, 12.0, ro.shape[0]).astype(np.float32)
    t_max[-N_DEAD:] = 0.0
    a = np.asarray(_jax(js, ro, rd, t_max, True).tri) >= 0
    b = twf.any_hit_wavefront(ts.cw_table(), ts.cw_nodes.shape[0], _t(ro),
                              _t(rd), _t(t_max), ts.cw_stack).numpy()
    np.testing.assert_array_equal(a, b)
    assert 0.1 < b.mean() < 0.95
    assert not b[-N_DEAD:].any()


def test_brute_force_oracle(rays):
    """64 rays against every triangle: the traversal finds the brute-force
    closest hit. The brute force tests with plain dot products where the
    traversal contracts mul-adds, so t agrees to rtol 1e-5 and the
    triangle wherever no other triangle lies within that tolerance; the
    port's oracle itself agrees with the JAX one the same way."""
    js, ts = _scene(6)
    ro, rd, _ = rays
    sel = np.r_[0:32, 512:544]
    ro, rd = ro[sel], rd[sel]
    trav = twf.closest_hit_plain(ts.cw_table(), ts.cw_nodes.shape[0],
                                 _t(ro), _t(rd), 1e30, ts.cw_stack)
    bf = brute_force_closest(ts.tri_p0, ts.tri_e1, ts.tri_e2, _t(ro),
                             _t(rd), 1e30)
    jb = jbrute(js.tri_p0, js.tri_e1, js.tri_e2, jnp.asarray(ro),
                jnp.asarray(rd), 1e30)
    for other in (trav, _hit_np(jb)):
        np.testing.assert_allclose(other.t.numpy(), bf.t.numpy(), rtol=1e-5)
        same = other.tri.numpy() == bf.tri.numpy()
        assert same.mean() >= 62 / 64
    assert (bf.tri.numpy() >= 0).mean() > 0.9


def test_step_core_plain_matches_pallas(rays):
    """step_core_plain is bitwise the Pallas step_core (interpret mode) on
    gathered K=3 rows: leaf lanes hold the leaf row of a triangle the ray
    hits (so Moller tests pass), the other lanes a node row."""
    js, ts = _scene(3)
    ro, rd, _ = rays
    R = 1024
    ro, rd = ro[:R], rd[:R]
    table = ts.cw_table()
    C = ts.cw_nodes.shape[0]
    hit = twf.closest_hit_plain(table, C, _t(ro), _t(rd), 1e30, ts.cw_stack)
    ids = table[C:, 27:30].to(torch.int64)
    tri2row = torch.zeros(ts.n_tris(), dtype=torch.int64)
    rows_l = torch.arange(table.shape[0] - C)[:, None].expand(-1, 3)
    tri2row[ids[ids >= 0]] = rows_l[ids >= 0]
    r = np.random.default_rng(6)
    leaf = _t(r.random(R) < 0.5) & (hit.tri >= 0)
    node_row = _t(r.integers(0, C, R))
    idx = torch.where(leaf, C + tri2row[hit.tri.clamp(min=0).long()],
                      node_row)
    rowt = torch.nn.functional.pad(table[idx], (0, 2)).t().contiguous()
    inv = twf._inv_dir(_t(rd))
    ray9 = torch.cat([_t(ro).t(), _t(rd).t(), inv.t()]).contiguous()
    t0 = np.where(r.random(R) < 0.2, np.float32(3.0), np.float32(1e30))
    st5 = torch.stack([_t(t0.astype(np.float32)).view(torch.int32),
                       torch.full((R,), -1, dtype=torch.int32),
                       torch.zeros(R, dtype=torch.int32),
                       torch.zeros(R, dtype=torch.int32),
                       leaf.to(torch.int32)]).contiguous()
    u32 = lambda x: jnp.asarray(x.numpy().view(np.uint32))
    for write_uv in (True, False):
        a = np.asarray(jstep_core(u32(rowt), jnp.asarray(ray9.numpy()),
                                  u32(st5), write_uv=write_uv))
        b = step_core_plain(rowt, ray9, st5, write_uv).numpy()
        np.testing.assert_array_equal(a, b.view(np.uint32))
    assert (b[1] >= 0).sum() > R // 8
