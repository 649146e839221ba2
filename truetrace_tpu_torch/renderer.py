"""Frame orchestrator: the user-facing renderer.

Port of `truetrace_tpu/renderer.py` for the frame the slice covers: trace
one sample per pixel, denoise with SVGF (or not at all), clamp fireflies,
accumulate, post-process. Per-frame state is an explicit `FrameState`
threaded through `Renderer.step`; everything runs eagerly on the scene's
device (there is no counterpart of the JAX `jit_step`). Options outside
the slice raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.post.pipeline import (
    Accumulator, PostConfig, firefly_clamp, postprocess)
from truetrace_tpu_torch.post.svgf import SVGFState, svgf_denoise
from truetrace_tpu_torch.scene.ir import Camera, Scene


def _todo(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


@dataclass(frozen=True)
class RendererConfig:
    """The JAX package's RendererConfig fields and defaults."""
    width: int = 512
    height: int = 512
    bounces: int = 6
    bsdf: str = "disney"
    traversal: str = "wavefront"
    light_sampling: str = "tree"
    use_nee: bool = True
    denoiser: str = "none"          # the port runs none | svgf
    neural_weights: str = ""
    use_restir: bool = False
    use_restir_di: bool = False
    use_radiance_cache: bool = False
    cache_query_bounce: int = 2
    cache_capacity: int = 1 << 20
    upscale: int = 1
    partial_rendering: int = 1
    step_barrier: bool = False
    post: PostConfig = field(default_factory=PostConfig)

    def check_supported(self) -> None:
        if self.denoiser not in ("none", "svgf"):
            item = "A.13" if self.denoiser.startswith("neural") else "A.11"
            _todo(f"denoiser={self.denoiser!r}", item)
        if self.use_restir or self.use_restir_di:
            _todo("ReSTIR GI / DI", "A.11")
        if self.use_radiance_cache:
            _todo("the radiance cache", "A.12")
        if self.upscale > 1:
            _todo("TAAU upscaling", "A.10")
        if self.partial_rendering > 1:
            _todo("partial rendering", "A.10")
        self.post.check_supported()

    def render_config(self) -> RenderConfig:
        return RenderConfig(
            width=self.width, height=self.height, bounces=self.bounces,
            bsdf=self.bsdf, traversal=self.traversal,
            light_sampling=self.light_sampling, use_nee=self.use_nee)


@dataclass
class FrameState:
    accum: Accumulator
    sample: int                          # next sample id
    svgf: Optional[SVGFState]
    taa_history: Optional[torch.Tensor]
    prev_cam: Optional[Camera] = None    # last frame's camera (motion)

    @staticmethod
    def from_numpy(d: dict, device) -> "FrameState":
        """FrameState from the JAX FrameState's leaves (numpy arrays in
        nested dicts keyed by field name)."""
        for key, item in (("asvgf", "A.11"), ("recur", "A.11"),
                          ("restir", "A.11"), ("restir_di", "A.11"),
                          ("cache", "A.12"), ("taau_history", "A.10"),
                          ("partial", "A.10"), ("exposure", "A.10"),
                          ("neural_hist", "A.13")):
            if d.get(key) is not None:
                _todo(f"FrameState.{key}", item)
        t = lambda a: None if a is None else torch.from_numpy(
            np.array(a, np.float32)).to(device)
        return FrameState(
            accum=Accumulator.from_numpy(d["accum"], device),
            sample=int(d["sample"]),
            svgf=SVGFState.from_numpy(d["svgf"], device)
            if d.get("svgf") is not None else None,
            taa_history=t(d.get("taa_history")),
            prev_cam=Camera.from_numpy(d["prev_cam"], device)
            if d.get("prev_cam") is not None else None)


class Renderer:
    """Owns scene + camera + config; `step` advances one frame."""

    def __init__(self, scene: Scene, cam: Camera, cfg: RendererConfig):
        cfg.check_supported()
        self.scene = scene
        self.cam = cam.to(scene.device)
        self.cfg = cfg
        self.rcfg = cfg.render_config()

    def init_state(self) -> FrameState:
        h, w, dev = self.cfg.height, self.cfg.width, self.scene.device
        return FrameState(
            accum=Accumulator.create(h, w, dev), sample=0,
            svgf=SVGFState.create(h, w, dev)
            if self.cfg.denoiser == "svgf" else None,
            taa_history=None, prev_cam=None)

    def reset_accumulation(self, state: FrameState) -> FrameState:
        return replace(state, accum=state.accum.reset())

    def step(self, state: FrameState, cam: Optional[Camera] = None,
             scene: Optional[Scene] = None):
        """One frame: trace, denoise, clamp fireflies, accumulate, post.
        Returns (display [H,W,3] in [0,1], accumulated radiance [H,W,3],
        new_state). Passing `cam` moves the camera (accumulation restarts
        when it changed; temporal passes reproject with motion vectors);
        passing `scene` swaps the geometry and restarts accumulation."""
        cfg = self.cfg
        if scene is not None:
            self.scene = scene
            state = self.reset_accumulation(state)
        if cam is not None:
            cam = cam.to(self.scene.device)
            if not torch.allclose(cam.c2w, self.cam.c2w, atol=1e-7):
                state = self.reset_accumulation(state)
            self.cam = cam
        h, w = cfg.height, cfg.width
        sid = state.sample
        pixel = torch.arange(h * w, device=self.scene.device)
        rad, st = render_sample_with_stats(self.scene, self.cam, self.rcfg,
                                           pixel, sid)
        frame = rad.reshape(h, w, 3)
        albedo = st["albedo"].reshape(h, w, 3)
        normal = st["normal"].reshape(h, w, 3)
        depth = st["depth"].reshape(h, w)
        emissive = st["emitted0"].reshape(h, w, 3)
        motion = None
        if state.prev_cam is not None:
            from truetrace_tpu_torch.post.motion import motion_vectors
            motion = motion_vectors(state.prev_cam, self.cam, depth)

        svgf = state.svgf
        if cfg.denoiser == "svgf":
            frame, svgf = svgf_denoise(frame, albedo, normal, depth, svgf,
                                       motion=motion, emissive=emissive)
        if cfg.post.firefly > 0.0:
            frame = firefly_clamp(frame, cfg.post.firefly)
        accum = state.accum.add(frame)
        display, taa_hist = postprocess(accum.image, cfg.post,
                                        state.taa_history, motion=motion)
        new_state = FrameState(accum=accum, sample=sid + 1, svgf=svgf,
                               taa_history=taa_hist, prev_cam=self.cam)
        return display, accum.image, new_state
