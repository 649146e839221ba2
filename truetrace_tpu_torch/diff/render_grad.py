"""Differentiable rendering: gradients of image losses w.r.t. scene
parameters.

Port of `truetrace_tpu/diff/render_grad.py` through torch autograd, with
the JAX package's detached-sampling estimator (integrate/pathtrace.py):
every sampling decision is a pure function of the counter-based RNG, so
the forward and backward passes see the same paths; the hit record, the
shadow transmittance and the sampled direction and pdf are constants, and
gradients flow through the BSDF values, emission, env and light radiance
along those paths. No kernel is differentiated: the traversal runs
forward only (and, under `RenderConfig.remat`, hands its results to the
bounce's recompute). Geometry and silhouette gradients are out of scope,
as is the env rotation (nearest-texel lookup).

The parameters: the material columns `DEFAULT_PARAM_KEYS`, the env's
`intensity` (0-d) and the analytic lights' `radiance` [K,3]. The light
tree's emitter power was built with the scene and stays a constant: a
parameter swap rebuilds nothing, and keeps the scene's traversal table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from truetrace_tpu_torch.integrate.pathtrace import RenderConfig, render
from truetrace_tpu_torch.scene.ir import Camera, Scene

DEFAULT_PARAM_KEYS = ("base_color", "roughness", "emission", "metallic")
SCENE_KEYS = ("env_intensity", "light_radiance")


def get_scene_params(scene: Scene, keys=DEFAULT_PARAM_KEYS,
                     with_env: bool = True, with_lights: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """The trainable parameters: the material columns `keys`, and the env
    intensity and (where the scene has analytic lights) their radiance."""
    p = {k: getattr(scene.materials, k) for k in keys}
    if with_env:
        p["env_intensity"] = scene.env.intensity
    if with_lights and scene.lights.position.shape[0] > 0:
        p["light_radiance"] = scene.lights.radiance
    return p


def set_scene_params(scene: Scene, params: Dict[str, torch.Tensor]
                     ) -> Scene:
    """A new Scene with `params` swapped in (the other tables, the cached
    traversal table among them, shared with `scene`)."""
    mat_p = {k: v for k, v in params.items() if k not in SCENE_KEYS}
    sc = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mat_p))
    if "env_intensity" in params:
        sc = dataclasses.replace(sc, env=dataclasses.replace(
            sc.env, intensity=params["env_intensity"]))
    if "light_radiance" in params:
        sc = dataclasses.replace(sc, lights=dataclasses.replace(
            sc.lights, radiance=params["light_radiance"]))
    return sc


def get_material_params(scene: Scene, keys=DEFAULT_PARAM_KEYS
                        ) -> Dict[str, torch.Tensor]:
    """The material columns alone."""
    return get_scene_params(scene, keys, with_env=False, with_lights=False)


def set_material_params(scene: Scene, params: Dict[str, torch.Tensor]
                        ) -> Scene:
    return set_scene_params(scene, params)


def render_loss_and_grad(scene: Scene, cam: Camera, cfg: RenderConfig,
                         target: torch.Tensor, spp: int = 8,
                         base_sample: int = 0, device="cuda"):
    """L2 image loss against `target` [H,W,3] and its gradients w.r.t.
    every parameter of `get_scene_params(scene)`. Returns (loss 0-d,
    grads dict, image [H,W,3]), all detached; a parameter the render does
    not reach gets a zero gradient. The render runs on `device`, where
    the scene, camera and target must be (a CPU render passes
    device="cpu"). No host sync: the loss stays a device tensor."""
    if scene.device.type != torch.device(device).type:
        raise ValueError(f"the scene is on {scene.device}, not {device}")
    scene.cw_table()            # packed once, shared by the swapped scenes
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in get_scene_params(scene).items()}
    with torch.enable_grad():
        img = render(set_scene_params(scene, params), cam, cfg, spp=spp,
                     base_sample=base_sample)
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(params.items(), grads)}
    return loss.detach(), grads, img.detach()
