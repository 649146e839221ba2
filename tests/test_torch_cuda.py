"""Torch port, the CUDA kernels against their plain PyTorch twins on the
card, at small sizes and on the edges the main path does not reach:
frame sizes that are no multiple of the 16x16 tile, a-trous steps wider
than the frame, leaf rows of K = 3, 6 and 12, a stack so shallow that
pushes drop entries, dead lanes, and the wrappers' argument checks.

Needs an NVIDIA card and nvcc; skips elsewhere. It imports no JAX, so it
runs on a machine without it (the JAX-side conftest is skipped):

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from truetrace_tpu_torch.kernels import atrous_pallas, cwbvh_wavefront as wf
from truetrace_tpu_torch.kernels import step_pallas
from truetrace_tpu_torch.scene import atrium
from truetrace_tpu_torch.scene.mesh import compile_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("h,w,step", [(37, 53, 1), (37, 53, 4), (37, 53, 8),
                                      (24, 40, 16), (24, 40, 32), (5, 7, 2)])
def test_atrous_kernel_matches_plain(dev, h, w, step):
    """rtol 1e-4 / atol 1e-5: expf/powf on the card and torch's exp/pow
    may differ in the last ulp, which the normalised sums carry."""
    r = np.random.default_rng(h * w + step)
    args = [torch.from_numpy(a).to(dev) for a in (
        r.uniform(0, 3, (h, w, 3)).astype(np.float32),
        r.uniform(0, 0.5, (h, w)).astype(np.float32),
        _unit(r, h * w).reshape(h, w, 3),
        r.uniform(0.5, 10, (h, w)).astype(np.float32))]
    n0 = atrous_pallas.atrous_pass.launches
    kc, kv = atrous_pallas.atrous_pass(*args, step)
    pc, pv = atrous_pallas.atrous_pass_plain(*args, step)
    torch.cuda.synchronize()
    assert atrous_pallas.atrous_pass.launches == n0 + 1
    torch.testing.assert_close(kc, pc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(kv, pv, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def scenes(dev):
    meshes, mats, cam, env = atrium.make(detail=0.2)
    out = {k: compile_scene(meshes, mats, env=env, with_cwbvh=True,
                            leaf_k=k, device=dev) for k in (3, 6, 12)}
    r = np.random.default_rng(3)
    R = 3000
    lo = out[3].tri_p0.amin(0).cpu().numpy()
    hi = out[3].tri_p0.amax(0).cpu().numpy()
    ro = torch.from_numpy(r.uniform(lo, hi, (R, 3)).astype(np.float32))
    rd = torch.from_numpy(_unit(r, R))
    tm = torch.from_numpy(r.uniform(0.05, 8.0, R).astype(np.float32))
    tm[:100] = 0.0                                   # dead lanes
    tm[100:1500] = 1e30
    return out, ro.to(dev), rd.to(dev), tm.to(dev)


@pytest.mark.parametrize("k", [3, 6, 12])
@pytest.mark.parametrize("stack", ["scene", 2])
def test_traversal_kernel_bitwise(scenes, k, stack):
    """Closest hit (t, tri, u, v) and occlusion are bitwise the plain
    lock-step traversal's, also with a 2-entry stack whose pushes drop
    the deepest entry (the shift-register semantics the ring mirrors)."""
    out, ro, rd, tm = scenes
    sc = out[k]
    S = sc.cw_stack if stack == "scene" else stack
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    hk = wf.closest_hit_wavefront(table, C, ro, rd, tm, S)
    hp = wf.closest_hit_plain(table, C, ro, rd, tm, S)
    for f in ("t", "tri", "u", "v"):
        a, b = getattr(hk, f), getattr(hp, f)
        assert torch.equal(a.view(torch.int32), b.to(a.dtype).view(
            torch.int32)), f
    assert bool((hk.tri[:100] == -1).all())
    ok = wf.any_hit_wavefront(table, C, ro, rd, tm, S)
    assert torch.equal(ok, wf.any_hit_plain(table, C, ro, rd, tm, S))
    assert 0.05 < float(ok.float().mean()) < 0.95


def test_step_core_kernel_bitwise(scenes, dev):
    """The standalone step_core launch on random rows of the K = 3 table
    (leaf and node lanes) at a lane count that is no multiple of the
    block, against step_core_plain."""
    out, ro, rd, _ = scenes
    sc = out[3]
    table = sc.cw_table()
    R = 1000
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, table.shape[0], (R,), generator=g).to(dev)
    C = sc.cw_nodes.shape[0]
    rowt = torch.nn.functional.pad(table[idx], (0, 2)).t().contiguous()
    inv = wf._inv_dir(rd[:R])
    ray9 = torch.cat([ro[:R].t(), rd[:R].t(), inv.t()]).contiguous()
    st5 = torch.stack([torch.full((R,), 1e30, device=dev).view(torch.int32),
                       torch.full((R,), -1, dtype=torch.int32, device=dev),
                       torch.zeros(R, dtype=torch.int32, device=dev),
                       torch.zeros(R, dtype=torch.int32, device=dev),
                       (idx >= C).to(torch.int32)]).contiguous()
    for write_uv in (True, False):
        a = step_pallas.step_core(rowt, ray9, st5, write_uv)
        b = step_pallas.step_core_plain(rowt, ray9, st5, write_uv)
        assert torch.equal(a, b)


def test_wrappers_reject_bad_arguments(scenes, dev):
    out, ro, rd, tm = scenes
    sc = out[6]
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    with pytest.raises(ValueError):
        wf.closest_hit_wavefront(table, C, ro.double(), rd, tm, 8)
    with pytest.raises(ValueError):
        wf.closest_hit_wavefront(table, C, ro.t().contiguous().t(), rd, tm,
                                 8)
    with pytest.raises(ValueError):
        wf.any_hit_wavefront(table, C, ro, rd, tm, 64)
    x = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError):
        atrous_pallas.atrous_pass(torch.zeros((8, 8, 3), device=dev), x,
                                  torch.zeros((8, 8, 3), device=dev),
                                  x.double(), 1)
