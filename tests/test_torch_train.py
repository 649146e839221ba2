"""Torch port, denoiser training (post/neural.py init_params, loss_fn,
make_train_step, params_to_numpy, write_msgpack), the camera rig
(scene/camera_rig.py), the render-state checkpoint (utils/checkpoint.py)
and the training script's pair renderer, against the JAX package.

Tolerances (measured on the CPU): `loss_fn` on the same parameters and
batch to rtol 1e-5; three Adam steps (optax.adam against
torch.optim.Adam, both from the same parameters and optax state) to an
atol of 1e-5 on every weight (measured 4.4e-6: Adam divides by the root
of the second moment, which magnifies a last-ulp gradient difference on
a weight whose gradients are small) and rtol 1e-5 on the losses (the
two frameworks' convolutions sum in different orders). Checkpoints and
cameras are bit for bit.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from truetrace_tpu.post import neural as jneural
from truetrace_tpu.scene import camera_rig as jrig
from truetrace_tpu_torch.post import neural as tneural
from truetrace_tpu_torch.scene import camera_rig as trig

from torch_parity import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(key, h=32, w=32):
    """tests/test_neural.py's batch."""
    k1, k2 = jax.random.split(key)
    target = jax.random.uniform(k1, (1, h, w, 3)) * 0.5
    noisy = target * jax.random.gamma(k2, 2.0, (1, h, w, 3)) / 2.0
    albedo = jnp.full((1, h, w, 3), 0.5)
    normal = jnp.concatenate([jnp.zeros((1, h, w, 2)),
                              jnp.ones((1, h, w, 1))], -1)
    return dict(noisy=noisy, target=target, albedo=albedo, normal=normal)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _model(params):
    m = tneural.DenoiserUNet()
    m.load_state_dict(tneural.params_from_numpy(leaves(params)))
    return m


@pytest.fixture(scope="module")
def jparams():
    # jitted: one compile of flax's init (eager, it compiles op by op)
    return jax.jit(jneural.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), 32, 32)


def test_loss_fn_matches_jax(jparams):
    """loss_fn on the JAX init's parameters (carried by
    params_from_numpy) and test_neural.py's batch."""
    b = _batch(jax.random.PRNGKey(2))
    jl = float(jax.jit(jneural.loss_fn)(jparams, b))
    tl = tneural.loss_fn(_model(jparams), _t(b))
    assert tl.dim() == 0
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)


def test_three_adam_steps_match_optax(jparams):
    """Three steps of make_train_step from the JAX parameters and an
    optax state after one JAX step (count 1, non-zero moments, carried
    by adam_state_from_numpy) against optax's three: losses and every
    weight; and adam_state_to_numpy gives optax's state back."""
    b = _batch(jax.random.PRNGKey(2))
    tx, jstep = jneural.make_train_step(3e-3)
    p, st = jstep(jparams, tx.init(jparams), b)[:2]
    model = _model(p)
    init, step = tneural.make_train_step(3e-3, device="cpu")
    opt = init(model)
    adam = st[0]
    tneural.adam_state_from_numpy(opt, model, {
        "count": np.asarray(adam.count), "mu": leaves(adam.mu),
        "nu": leaves(adam.nu)})
    for _ in range(3):
        p, st, jl = jstep(p, st, b)
        tl = step(model, opt, _t(b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = tneural.params_to_numpy(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        keys = [k.key for k in path]
        mine = got[keys[0]][keys[1]] if len(keys) == 2 else \
            got[keys[0]][keys[1]][keys[2]]
        np.testing.assert_allclose(mine, np.asarray(leaf), rtol=0, atol=1e-5,
                                   err_msg=str(keys))
    back = tneural.adam_state_to_numpy(opt, model)
    assert int(back["count"]) == int(st[0].count) == 4
    np.testing.assert_allclose(
        back["nu"]["Conv_0"]["kernel"], np.asarray(st[0].nu["Conv_0"][
            "kernel"]), rtol=1e-4, atol=1e-12)


def test_training_reduces_loss():
    """tests/test_neural.py's gate on the port: 120 steps at 3e-3 from
    init_params cut the loss under 0.75 times its start, and the denoised
    image is closer to the target than the input."""
    model = tneural.init_params(torch.Generator().manual_seed(0),
                                device="cpu")
    init, step = tneural.make_train_step(3e-3, device="cpu")
    opt = init(model)
    b = _t(_batch(jax.random.PRNGKey(2)))
    with torch.no_grad():
        l0 = float(tneural.loss_fn(model, b))
    for _ in range(120):
        step(model, opt, b)
    with torch.no_grad():
        l1 = float(tneural.loss_fn(model, b))
        out = tneural.denoise(model, b["noisy"][0], b["albedo"][0],
                              b["normal"][0])
    assert np.isfinite(l1) and l1 < 0.75 * l0, (l0, l1)
    err_in = float(torch.mean(torch.abs(b["noisy"][0] - b["target"][0])))
    err_out = float(torch.mean(torch.abs(out - b["target"][0])))
    assert err_out < err_in


def test_init_params_follow_flax(jparams):
    """init_params: every kernel a normal cut at two standard deviations
    with variance 1 / fan_in (lecun-normal, as flax's nn.Conv default),
    biases zero; each layer's std within 3% of flax's own init's and of
    1 / sqrt(fan_in) within four standard errors of a sample std
    (sqrt(1 / 2n) relative for n weights; five against flax's, itself a
    sample), the mean within four of its own; the same generator seed
    gives the same weights."""
    tree = tneural.params_to_numpy(tneural.init_params(
        torch.Generator().manual_seed(0), device="cpu").state_dict())
    again = tneural.params_to_numpy(tneural.init_params(
        torch.Generator().manual_seed(0), device="cpu").state_dict())
    for blk, convs in tree.items():
        for name, conv in (convs.items() if blk != "Conv_0"
                           else [("", convs)]):
            k = conv["kernel"]
            ref = np.asarray(jparams[blk][name]["kernel"] if name
                             else jparams[blk]["kernel"])
            assert k.shape == ref.shape
            std = 1.0 / np.sqrt(np.prod(k.shape[:3]))
            se = 1.0 / np.sqrt(2.0 * k.size)
            assert abs(k.std() / std - 1) < 4 * se, (blk, name, k.std(), std)
            assert abs(k.std() / ref.std() - 1) < 5 * se, (blk, name)
            assert abs(k.mean()) < 4 * std / np.sqrt(k.size), (blk, name)
            assert np.abs(k).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
            assert (conv["bias"] == 0).all()
            same = again[blk][name]["kernel"] if name else again[blk][
                "kernel"]
            assert np.array_equal(k, same)


def test_msgpack_is_flax_bit_for_bit(jparams, tmp_path):
    """write_msgpack writes flax.serialization.to_bytes's bytes; flax's
    from_bytes reads the port's checkpoint, and read_msgpack flax's, every
    array bit for bit; load_denoiser reads what write_msgpack wrote."""
    raw = serialization.to_bytes(jparams)
    tree = tneural.read_msgpack(raw)
    assert tneural.write_msgpack(tree) == raw
    model = tneural.init_params(torch.Generator().manual_seed(3),
                                device="cpu")
    tree = tneural.params_to_numpy(model.state_dict())
    mine = tneural.write_msgpack(tree)
    back = serialization.from_bytes(jparams, mine)
    # flax writes a dict in its key order (the jitted init's is sorted)
    order = lambda t, like: {k: order(t[k], v) if isinstance(v, dict)
                             else t[k] for k, v in like.items()}
    assert serialization.to_bytes(order(back, tree)) == mine
    path = tmp_path / "d.msgpack"
    path.write_bytes(mine)
    loaded = tneural.load_denoiser(str(path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    flat = dict(model.state_dict())
    assert np.array_equal(np.asarray(back["ConvBlock_3"]["Conv_0"]["kernel"]),
                          flat["blocks.3.conv0.weight"].numpy().transpose(
                              2, 3, 1, 0))


def test_camera_rig_matches_jax():
    """FlyCamera after moves and looks, orbit_path and spline_path: every
    camera bit for bit the JAX package's."""
    def same(jc, tc):
        # the port holds a camera's scalars as [1] tensors
        for f in ("c2w", "fov_y", "aperture", "focus_dist"):
            j = np.asarray(getattr(jc, f))
            assert np.array_equal(j, getattr(tc, f).numpy().reshape(
                j.shape)), f

    kw = dict(position=np.asarray([0.5, 1.0, 3.0], np.float32), yaw=0.3,
              pitch=-0.2, aperture=0.05, focus_dist=2.5, speed=0.7)
    jf, tf = jrig.FlyCamera(**kw), trig.FlyCamera(**kw)
    for mv, lk in (((1.0, 0.0, 2.0), (0.1, 0.05)),
                   ((0.0, -0.5, 1.0), (-0.4, 2.0))):
        jf.move(*mv).look(*lk)
        tf.move(*mv).look(*lk)
        same(jf.camera(), tf.camera(device="cpu"))
    for jc, tc in zip(jrig.orbit_path((0, 3, 0), 9.0, 4.0, 5),
                      trig.orbit_path((0, 3, 0), 9.0, 4.0, 5,
                                      device="cpu")):
        same(jc, tc)
    wp = [(0, 1, 5), (2, 1.5, 3), (3, 2, 0), (1, 1, -2)]
    tg = [(0, 1, 0), (0, 1, 0.5), (0.5, 1, 0), (0, 0.5, 0)]
    js, ts = (jrig.spline_path(wp, tg, 7),
              trig.spline_path(wp, tg, 7, device="cpu"))
    assert len(js) == len(ts) == 7
    for jc, tc in zip(js, ts):
        same(jc, tc)


def test_checkpoint_round_trip(tmp_path):
    """save_render_state / restore_render_state: a loop's state (a
    parameter dict, a sample count, an SVGFState, a list, None) comes
    back bit for bit in the template's dtypes; the npz holds the leaves
    in jax.tree_util's flatten order of the same tree."""
    from truetrace_tpu_torch.post.svgf import SVGFState
    from truetrace_tpu_torch.utils.checkpoint import (restore_render_state,
                                                      save_render_state)
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.rand(s, generator=g)
    state = {"params": {"roughness": r(4), "base_color": r(4, 3)},
             "sample": 17, "svgf": SVGFState(r(2, 2, 3), r(2, 2, 2),
                                             r(2, 2), r(2, 2, 3), r(2, 2)),
             "hist": [r(3), torch.arange(5)], "none": None}
    path = str(tmp_path / "ckpt")
    assert restore_render_state(path, state) is None
    save_render_state(path, state)
    tmpl = {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()},
            "sample": 0, "svgf": SVGFState.create(2, 2, device="cpu"),
            "hist": [torch.zeros(3), torch.zeros(5, dtype=torch.int64)],
            "none": None}
    back = restore_render_state(path, tmpl)
    assert back["sample"] == 17 and back["none"] is None
    for k in state["params"]:
        assert torch.equal(back["params"][k], state["params"][k])
    for f in dataclasses.fields(SVGFState):
        assert torch.equal(getattr(back["svgf"], f.name),
                           getattr(state["svgf"], f.name))
    assert back["hist"][1].dtype == torch.int64
    assert torch.equal(back["hist"][0], state["hist"][0])
    npz = np.load(os.path.join(path, "state.npz"))
    jtree = {"params": {k: v.numpy() for k, v in state["params"].items()},
             "sample": np.int64(17), "none": None,
             "svgf": [getattr(state["svgf"], f.name).numpy()
                      for f in dataclasses.fields(SVGFState)],
             "hist": [x.numpy() for x in state["hist"]]}
    jflat = jax.tree_util.tree_leaves(jtree)
    assert len(npz.files) == len(jflat)
    for i, leaf in enumerate(jflat):
        assert np.array_equal(npz[f"arr_{i}"], np.asarray(leaf)), i


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_train_denoiser",
        os.path.join(ROOT, "scripts", "torch_train_denoiser.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_script_pairs_and_checkpoint(jparams, tmp_path):
    """The training script's pair renderer at 8x8 (render_sum's passes
    of several samples) is bit for bit the average of the port's
    render_sample_with_stats called once a sample id, with the last
    noisy sample's G-buffer; its augmentation keeps shapes; a network
    written by write_msgpack denoises alike through the JAX `denoise`
    and the port's `load_denoiser` (rtol 1e-4 / atol 1e-5)."""
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample_with_stats)
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.mesh import compile_scene
    mod = _script()
    meshes, mats, cam = cornell.make(device="cpu")
    sc = compile_scene(meshes, mats, with_cwbvh=True, device="cpu")
    kw = dict(traversal="wavefront")
    pair = mod.render_pair(sc, cam, kw, 8, 2, 3)
    cfg = RenderConfig(width=8, height=8, bounces=3, bsdf="disney", **kw)
    pix = torch.arange(64)
    runs = [render_sample_with_stats(sc, cam, cfg, pix, s)
            for s in (0, 1, 1000, 1001, 1002)]
    noisy = (torch.zeros((64, 3)) + runs[0][0] + runs[1][0]) / 2
    target = (torch.zeros((64, 3)) + runs[2][0] + runs[3][0]
              + runs[4][0]) / 3
    assert np.array_equal(pair["noisy"], noisy.reshape(8, 8, 3).numpy())
    assert np.array_equal(pair["target"], target.reshape(8, 8, 3).numpy())
    for k in ("albedo", "normal", "depth"):
        assert np.array_equal(pair[k].reshape(64, -1),
                              runs[1][1][k].reshape(64, -1).numpy()), k
    b = mod.augment(np.random.default_rng(0), pair)
    assert all(v.shape == (1, 8, 8, 3) for v in b.values())
    model = tneural.init_params(torch.Generator().manual_seed(5),
                                device="cpu")
    path = tmp_path / "net.msgpack"
    path.write_bytes(tneural.write_msgpack(tneural.params_to_numpy(
        model.state_dict())))
    jp = serialization.from_bytes(jparams, path.read_bytes())
    args = [pair[k] for k in ("noisy", "albedo", "normal")]
    jd = np.asarray(jneural.denoise(jp, *map(jnp.asarray, args)))
    with torch.no_grad():
        td = tneural.denoise(tneural.load_denoiser(str(path), device="cpu"),
                             *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
