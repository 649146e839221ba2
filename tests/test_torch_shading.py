"""Torch port, shading: the Disney BSDF and the light-tree cut sampling
against the JAX package on shared inputs made from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.kernels import disney as jdisney
from truetrace_tpu.kernels import lighttree as jlt
from truetrace_tpu.scene import atrium
from truetrace_tpu.scene.mesh import HostMaterial, compile_scene
from truetrace_tpu.scene.mesh import material_table as jmaterial_table
from truetrace_tpu_torch.kernels import disney as tdisney
from truetrace_tpu_torch.kernels import lighttree as tlt
from truetrace_tpu_torch.scene.ir import MaterialTable, Scene

from torch_parity import leaves

R = 4096


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def shading_inputs():
    """32 random Disney materials (every lobe exercised), one per lane,
    with random normals, directions and uniforms."""
    r = np.random.default_rng(11)
    mats = []
    for i in range(32):
        u = r.random(12)
        mats.append(HostMaterial(
            base_color=tuple(r.uniform(0.05, 0.95, 3)),
            roughness=float(0.02 + 0.98 * u[0]),
            metallic=float(u[1] > 0.6) * float(u[2]),
            spec_trans=float(u[3] > 0.8) * float(u[4]),
            ior=float(1.2 + 0.6 * u[5]), specular=float(u[6]),
            sheen=float(u[7] > 0.5) * float(u[8]),
            clearcoat=float(u[9] > 0.6) * float(u[10]),
            anisotropic=float(u[11] > 0.7) * 0.8,
            thin=float(i % 5 == 0)))
    jt = jmaterial_table(mats)
    mid = r.integers(0, 32, R)
    jmat = jax.tree_util.tree_map(lambda a: a[jnp.asarray(mid)], jt)
    tmat = MaterialTable.from_numpy(leaves(jt), "cpu").gather(_t(mid))
    n = _unit(r, R)
    wo = _unit(r, R)
    wi = _unit(r, R)
    u_lobe = r.random(R, dtype=np.float32)
    u2 = r.random((R, 2), dtype=np.float32)
    return jmat, tmat, n, wo, wi, u_lobe, u2


# The port runs the JAX expressions op for op in f32; the two compilers
# differ in transcendentals (pow, exp, sin, cos, sqrt: an ulp or two) and
# XLA contracts some mul-adds. The GGX/GTR terms amplify those ulps near
# grazing angles and at roughness 0.02, hence rtol 2e-4 and atol 1e-5.
RTOL, ATOL = 2e-4, 1e-5


def test_disney_eval_matches(shading_inputs):
    jmat, tmat, n, wo, wi, _, _ = shading_inputs
    jf, jp = jdisney.disney_eval(jmat, jnp.asarray(n), jnp.asarray(wo),
                                 jnp.asarray(wi))
    tf, tp = tdisney.disney_eval(tmat, _t(n), _t(wo), _t(wi))
    np.testing.assert_allclose(np.asarray(jf), tf.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np.asarray(jp), tp.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert (tp.numpy() > 0).mean() > 0.3


def test_lobe_probs_match(shading_inputs):
    jmat, tmat = shading_inputs[:2]
    for a, b in zip(jdisney.lobe_probs(jmat), tdisney.lobe_probs(tmat)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_disney_sample_matches(shading_inputs):
    """Same lobe on >= 99.9% of lanes (a lobe flips only where u_lobe sits
    on a cdf boundary to the ulp), and on those lanes the same direction
    to atol 1e-5. f and pdf are then evaluated at the sampled direction,
    on the peak of a sharp GGX/GTR1 lobe, where D's 1 - cos^2 term turns
    a 1e-6 change of the direction into up to ~1.4% of f and pdf: they
    agree to rtol 2e-2, and to the eval tolerance on >= 97% of values.
    The path weight f/pdf, in which most of D cancels, agrees to 2e-3."""
    jmat, tmat, n, wo, _, u_lobe, u2 = shading_inputs
    jw, jf, jp, jl = jdisney.disney_sample(jmat, jnp.asarray(n),
                                           jnp.asarray(wo),
                                           jnp.asarray(u_lobe),
                                           jnp.asarray(u2))
    tw, tf, tp, tl = tdisney.disney_sample(tmat, _t(n), _t(wo), _t(u_lobe),
                                           _t(u2))
    same = np.asarray(jl) == tl.numpy()
    assert same.mean() >= 0.999
    np.testing.assert_allclose(np.asarray(jw)[same], tw.numpy()[same],
                               atol=1e-5)
    jf, jp = np.asarray(jf)[same], np.asarray(jp)[same]
    tf, tp = tf.numpy()[same], tp.numpy()[same]
    for a, b in ((jf, tf), (jp, tp)):
        assert np.isclose(a, b, rtol=RTOL, atol=ATOL).mean() >= 0.97
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=ATOL)
    ok = (jp > 1e-6) & (tp > 1e-6)
    np.testing.assert_allclose(jf[ok] / jp[ok, None], tf[ok] / tp[ok, None],
                               rtol=2e-3, atol=ATOL)
    assert set(np.unique(tl.numpy())) == {0, 1, 2, 3}


@pytest.fixture(scope="module")
def light_scene():
    meshes, mats, cam, env = atrium.make(detail=0.2)
    js = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                       with_light_bvh=True)
    ts = Scene.from_numpy(leaves(js), "cpu")
    r = np.random.default_rng(12)
    lo = np.asarray(js.tri_p0).min(0)
    hi = np.asarray(js.tri_p0).max(0)
    p = r.uniform(lo, hi, (R, 3)).astype(np.float32)
    n = _unit(r, R)
    u = r.random(R, dtype=np.float32)
    return js, ts, p, n, u


def test_light_tree_cut_f32_matches(light_scene):
    """f32 cut select + descent: the same light on >= 99.5% of lanes (a
    pick flips where u sits on a cdf boundary to the ulp) and there the
    same pmf to rtol 2e-4 (the cut pmf is a difference of two cumsum
    entries over up to 128 importances, which turns their last-ulp
    differences into up to ~6e-5 of a narrow bin); light_tree_pdf_cut of
    the picked light matches JAX to 1e-5 and gives the pmf back."""
    js, ts, p, n, u = light_scene
    ji, jp, _ = jlt.sample_light_tree_cut(
        js.lbvh_pairs, js.lbvh_prim, js.lcut_bounds, js.lcut_link,
        jnp.asarray(p), jnp.asarray(n), jnp.asarray(u))
    ti, tp, _ = tlt.sample_light_tree_cut(
        ts.lbvh_pairs, ts.lbvh_prim, ts.lcut_bounds, ts.lcut_link, _t(p),
        _t(n), _t(u), depth=ts.lbvh_depth)
    same = np.asarray(ji) == ti.numpy()
    assert same.mean() >= 0.995
    np.testing.assert_allclose(np.asarray(jp)[same], tp.numpy()[same],
                               rtol=2e-4)
    pdf = tlt.light_tree_pdf_cut(
        ts.lbvh_pairs, ts.lbvh_trail, ts.lcut_bounds, ts.lcut_link,
        ts.lcut_of_light, ts.lcut_skip, ti, _t(p), _t(n),
        depth=ts.lbvh_depth)
    jpdf = jlt.light_tree_pdf_cut(
        js.lbvh_pairs, js.lbvh_trail, js.lcut_bounds, js.lcut_link,
        js.lcut_of_light, js.lcut_skip, jnp.asarray(ti.numpy()),
        jnp.asarray(p), jnp.asarray(n))
    np.testing.assert_allclose(np.asarray(jpdf), pdf.numpy(), rtol=1e-5)
    np.testing.assert_allclose(pdf.numpy(), tp.numpy(), rtol=1e-4)
    assert len(np.unique(ti.numpy())) > 20


def test_light_tree_cut_bf16_select(light_scene):
    """nee_mis="approx" selects over the cut in bf16. The two frameworks
    round the bf16 importance at different points, so a pick may land in
    a neighbouring bin: the picks agree on >= 99% of lanes. In both,
    p_cut is exactly the probability of the bin realised (the width of
    the picked bin of the bf16 cdf over its total)."""
    js, ts, p, n, u = light_scene
    jpick, jpc, _ = jlt._cut_select(js.lcut_bounds, jnp.asarray(p),
                                    jnp.asarray(n), jnp.asarray(u),
                                    dtype=jnp.bfloat16)
    pick, p_cut, _ = tlt._cut_select(ts.lcut_bounds, _t(p), _t(n), _t(u),
                                     dtype=torch.bfloat16)
    assert (np.asarray(jpick) == pick.numpy()).mean() >= 0.99
    imp = tlt._importance_dense(ts.lcut_bounds, _t(p), _t(n),
                                dtype=torch.bfloat16).float()
    cdf = torch.cumsum(imp, 0)
    hi = cdf.gather(0, pick[None])[0]
    lo = torch.where(pick > 0, cdf.gather(0, (pick - 1).clamp(min=0)[None])
                     [0], 0.0)
    tot = cdf[-1]
    ok = tot > 0
    assert torch.equal(p_cut[ok], ((hi - lo).clamp(min=0) / tot)[ok])
    same = np.asarray(jpick) == pick.numpy()
    np.testing.assert_allclose(np.asarray(jpc)[same], p_cut.numpy()[same],
                               rtol=2e-2)
