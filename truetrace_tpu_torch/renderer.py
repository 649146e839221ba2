"""Frame orchestrator: the user-facing renderer.

Port of `truetrace_tpu/renderer.py` for single-BLAS scenes: the ReSTIR
DI prepass (a 1-bounce G-buffer trace feeding the light reservoirs), one
path-traced sample per pixel (through the radiance cache, which it
queries and feeds, where that is on; with one Halton subpixel offset a
frame under TAAU; for a rolling 1/k of the pixels under partial
rendering, composed with the earlier frames' buffers), the cache's
per-frame resolve, ReSTIR GI from the trace's captures, the denoiser
(SVGF, ASVGF with its stratum replay or ReSTIR GI's gradients, ReCur,
the neural U-Net with or without its temporal blend, or none), the
firefly clamp, TAAU upscaling, accumulation and post-processing (with
temporal auto exposure). On an instanced scene the motion vectors carry
each pixel's primary-hit instance back through its previous transform
(per-object motion). Per-frame state is an explicit `FrameState`
threaded through `Renderer.step`, which runs eagerly on the scene's
device. `Renderer.graph_step` is the counterpart of the JAX `jit_step`:
on a CUDA card it captures the frame once as a CUDA graph and replays it,
so the device runs the frame's kernels without the host launching each
one. Options outside the port raise NotImplementedError naming their
ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.integrate.radiance_cache import (
    RadianceCache, cache_resolve, render_sample_cached)
from truetrace_tpu_torch.integrate.restir import (
    ReSTIRState, restir_gi_from_stats)
from truetrace_tpu_torch.integrate.restir_di import (
    ReSTIRDIState, restir_di_reservoirs)
from truetrace_tpu_torch.post.asvgf import (
    ASVGFState, asvgf_filter, asvgf_gradient, gradient_alpha,
    sample_id_tensor)
from truetrace_tpu_torch.post.motion import (
    motion_vectors, motion_vectors_objects)
from truetrace_tpu_torch.post.neural import denoise as neural_denoise
from truetrace_tpu_torch.post.neural import load_denoiser
from truetrace_tpu_torch.post.pipeline import (
    Accumulator, PostConfig, firefly_clamp, postprocess, taa, taau_jitter,
    taau_upscale, upscale_motion)
from truetrace_tpu_torch.post.recur import ReCurState, recur_denoise
from truetrace_tpu_torch.post.svgf import SVGFState, svgf_denoise
from truetrace_tpu_torch.scene.ir import Camera, Scene


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
    denoiser: str = "none"   # none | svgf | asvgf | recur | neural
                             # | neural_taa (the U-Net, then a clamped
                             # temporal blend of its output)
    neural_weights: str = ""        # flax msgpack checkpoint of the U-Net
    use_restir: bool = False
    use_restir_di: bool = False
    use_radiance_cache: bool = False
    cache_query_bounce: int = 2
    cache_capacity: int = 1 << 20
    # TAAU: trace at width/upscale x height/upscale with one Halton
    # subpixel offset a frame and reconstruct the output temporally
    # (post/pipeline.py taau_upscale); 1 = off
    upscale: int = 1
    # trace a rolling 1/k of the pixels a frame and compose them with
    # the earlier frames' buffers (reprojected on a camera move); every
    # later pass runs on the whole composed frame (reference
    # DoPartialRendering, RayTracingShader.compute:91-97); 1 = off
    partial_rendering: int = 1
    step_barrier: bool = False      # an XLA fusion barrier; no-op in torch
    post: PostConfig = field(default_factory=PostConfig)

    @property
    def internal_size(self):
        """(height, width) of the traced frame."""
        s = max(self.upscale, 1)
        return self.height // s, self.width // s

    def check_supported(self) -> None:
        if self.denoiser not in ("none", "svgf", "asvgf", "recur", "neural",
                                 "neural_taa"):
            raise ValueError(f"unknown denoiser {self.denoiser!r}")
        ih, iw = self.internal_size
        if self.partial_rendering > 1 and (ih * iw) % self.partial_rendering:
            raise ValueError("partial_rendering must divide the pixel count")
        if self.denoiser.startswith("neural") and (ih % 4 or iw % 4):
            raise ValueError("the neural denoiser's U-Net needs the traced "
                             "height and width to be multiples of 4")
        self.post.check_supported()

    def render_config(self) -> RenderConfig:
        ih, iw = self.internal_size
        return RenderConfig(
            width=iw, height=ih, bounces=self.bounces,
            bsdf=self.bsdf, traversal=self.traversal,
            light_sampling=self.light_sampling, use_nee=self.use_nee,
            restir_capture=self.use_restir,
            cache_capture=self.use_radiance_cache,
            cache_query_bounce=(self.cache_query_bounce
                                if self.use_radiance_cache else -1))


# the optional per-frame states: FrameState field -> its class
_PARTS = {"svgf": SVGFState, "asvgf": ASVGFState, "recur": ReCurState,
          "restir": ReSTIRState, "restir_di": ReSTIRDIState,
          "cache": RadianceCache}
# the optional per-frame tensors (partial: a dict of them)
_EXTRA = ("taau_history", "partial", "exposure", "neural_hist")


@dataclass
class FrameState:
    accum: Accumulator
    sample: int                          # next sample id
    svgf: Optional[SVGFState]
    taa_history: Optional[torch.Tensor]
    prev_cam: Optional[Camera] = None    # last frame's camera (motion)
    asvgf: Optional[ASVGFState] = None          # ASVGF histories
    recur: Optional[ReCurState] = None          # ReCur histories
    restir: Optional[ReSTIRState] = None        # ReSTIR GI reservoirs
    restir_di: Optional[ReSTIRDIState] = None   # ReSTIR DI reservoirs
    cache: Optional[RadianceCache] = None       # the radiance cache
    taau_history: Optional[torch.Tensor] = None  # output-size TAAU history
    # partial rendering's compose buffers at the traced size, flat [h*w,
    # ...]: rad, albedo, normal, depth, emitted0, inst (the primary hit's
    # instance, -1 off instances); direct, x1, mat1 with
    # ReSTIR GI; di_x1, di_n, di_d (the prepass G-buffer) with ReSTIR DI
    partial: Optional[dict] = None
    exposure: Optional[torch.Tensor] = None     # [] adapted; < 0: cold
    neural_hist: Optional[torch.Tensor] = None  # neural_taa's last output
    # the last frame's instance transforms [I,3,4] (per-object motion)
    prev_inst_l2w: Optional[torch.Tensor] = None

    @staticmethod
    def from_numpy(d: dict, device) -> "FrameState":
        """FrameState from the JAX FrameState's leaves (numpy arrays in
        nested dicts keyed by field name); integer buffers become
        int64."""
        def t(a):
            if a is None:
                return None
            a = np.asarray(a)
            return torch.from_numpy(np.array(
                a, np.int64 if a.dtype.kind in "iu" else
                bool if a.dtype == bool else np.float32)).to(device)
        part = d.get("partial")
        return FrameState(
            accum=Accumulator.from_numpy(d["accum"], device),
            sample=int(d["sample"]),
            taa_history=t(d.get("taa_history")),
            prev_cam=Camera.from_numpy(d["prev_cam"], device)
            if d.get("prev_cam") is not None else None,
            taau_history=t(d.get("taau_history")),
            partial=None if part is None else {
                k: t(v) for k, v in part.items()},
            exposure=t(d.get("exposure")),
            neural_hist=t(d.get("neural_hist")),
            prev_inst_l2w=t(d.get("prev_inst_l2w")),
            **{k: cls.from_numpy(d[k], device) if d.get(k) is not None
               else None for k, cls in _PARTS.items()})


class Renderer:
    """Owns scene + camera + config; `step` advances one frame."""

    def __init__(self, scene: Scene, cam: Camera, cfg: RendererConfig):
        cfg.check_supported()
        self.scene = scene
        self.cam = cam.to(scene.device)
        self.cfg = cfg
        self.rcfg = cfg.render_config()
        self.neural = (load_denoiser(cfg.neural_weights, scene.device)
                       if cfg.denoiser.startswith("neural") else None)

    def _init_partial(self, h: int, w: int) -> dict:
        """Partial rendering's compose buffers (FrameState.partial)."""
        dev = self.scene.device
        z = lambda *s, dtype=torch.float32: torch.zeros(
            (h * w,) + s, dtype=dtype, device=dev)
        p = dict(rad=z(3), albedo=torch.ones((h * w, 3), device=dev),
                 normal=z(3), depth=z(), emitted0=z(3),
                 inst=torch.full((h * w,), -1, dtype=torch.int64,
                                 device=dev))
        if self.cfg.use_restir:
            p.update(direct=z(3), x1=z(3), mat1=z(dtype=torch.int64))
        if self.cfg.use_restir_di:
            p.update(di_x1=z(3), di_n=z(3), di_d=z())
        return p

    def init_state(self) -> FrameState:
        """Trace-size states (denoisers, reservoirs, partial rendering's
        buffers) at the internal size; accumulation and the TAA and TAAU
        histories at the output size."""
        cfg = self.cfg
        dev = self.scene.device
        h, w = cfg.internal_size
        return FrameState(
            accum=Accumulator.create(cfg.height, cfg.width, dev), sample=0,
            svgf=SVGFState.create(h, w, dev)
            if cfg.denoiser == "svgf" else None,
            asvgf=ASVGFState.create(h, w, dev)
            if cfg.denoiser == "asvgf" else None,
            recur=ReCurState.create(h, w, dev)
            if cfg.denoiser == "recur" else None,
            taa_history=None, prev_cam=None,
            restir=ReSTIRState.create(h, w, dev) if cfg.use_restir
            else None,
            restir_di=ReSTIRDIState.create(h, w, dev)
            if cfg.use_restir_di else None,
            cache=RadianceCache.create(cfg.cache_capacity, dev)
            if cfg.use_radiance_cache else None,
            partial=self._init_partial(h, w)
            if cfg.partial_rendering > 1 else None,
            exposure=torch.full((), -1.0, device=dev)
            if cfg.post.auto_expose else None,
            neural_hist=torch.zeros((h, w, 3), device=dev)
            if cfg.denoiser == "neural_taa" else None)

    def reset_accumulation(self, state: FrameState) -> FrameState:
        return replace(state, accum=state.accum.reset())

    def step(self, state: FrameState, cam: Optional[Camera] = None,
             scene: Optional[Scene] = None,
             cam_moved: Optional[bool] = None):
        """One frame: trace (with the ReSTIR DI prepass, ReSTIR GI and the
        radiance cache where they are on), denoise, clamp fireflies,
        accumulate, post. Returns (display [H,W,3] in [0,1], accumulated
        radiance [H,W,3], new_state). Passing `cam` moves the camera:
        accumulation restarts when `cam_moved` is true, or, with
        `cam_moved` None, when the camera differs from the last one by
        value (a compare that reads the card back; pass `cam_moved` to
        keep the frame free of host syncs). Temporal passes and the
        reservoirs reproject with motion vectors; under a camera move the
        cache merges re-levelled cells. Passing `scene` swaps the
        geometry (an update_instance_transforms result, say: its
        instances' motion is in the next frame's vectors) and restarts
        accumulation."""
        if scene is not None:
            self.scene = scene
            state = self.reset_accumulation(state)
        if cam is not None:
            cam = cam.to(self.scene.device)
            if cam_moved is None:
                cam_moved = not torch.allclose(cam.c2w, self.cam.c2w,
                                               atol=1e-7)
            if cam_moved:
                state = self.reset_accumulation(state)
            self.cam = cam
        display, new = self._frame(state, self.cam, state.sample,
                                   bool(cam_moved))
        new_state = FrameState(sample=state.sample + 1, prev_cam=self.cam,
                               **new)
        return display, new_state.accum.image, new_state

    def _frame(self, state: FrameState, cam: Camera, sid, cam_moved: bool,
               scene: Optional[Scene] = None):
        """The device work of one frame from `state`, seen by `cam`, with
        sample id `sid` (a Python int, or a 0-d int64 tensor on the card,
        as graph_step captures it: the partial subset, the TAAU jitter
        and the warm-up gate then come from it on the device); with
        `cam_moved`, partial rendering reprojects its buffers and the
        cache runs its reprojection merge; `scene` in place of the
        renderer's. Returns (display, the new state's fields other than
        the sample id and camera)."""
        cfg, rcfg = self.cfg, self.rcfg
        scene = scene if scene is not None else self.scene
        dev = scene.device
        h, w = cfg.internal_size
        prev_cam = state.prev_cam

        def motion_of(depth, inst):
            """Per-object motion where the scene is instanced and the last
            frame's transforms are known, else the camera's."""
            if prev_cam is None:
                return None
            if state.prev_inst_l2w is not None and \
                    scene.inst_l2w is not None:
                return motion_vectors_objects(
                    prev_cam, cam, depth, inst.reshape(depth.shape),
                    state.prev_inst_l2w, scene.inst_l2w)
            return motion_vectors(prev_cam, cam, depth)

        new = {k: getattr(state, k) for k in (*_PARTS, *_EXTRA)}
        new["prev_inst_l2w"] = scene.inst_l2w
        k = cfg.partial_rendering
        if k > 1:
            # the rolling 1/k interleave: only these pixels are traced;
            # every later pass runs on the composed frame
            pixel = torch.arange(h * w // k, device=dev) * k + sid % k
            P = dict(state.partial)
            if cam_moved and prev_cam is not None:
                # stale pixels follow the new view (the traced subset
                # overwrites them after)
                mv = motion_of(P["depth"].reshape(h, w), P["inst"])
                ys = torch.clamp(torch.round(torch.arange(h, device=dev)[
                    :, None] - mv[..., 1]).to(torch.int64), 0, h - 1)
                xs = torch.clamp(torch.round(torch.arange(w, device=dev)[
                    None, :] - mv[..., 0]).to(torch.int64), 0, w - 1)
                P = {key: buf.reshape((h, w) + buf.shape[1:])[ys, xs]
                     .reshape(buf.shape) for key, buf in P.items()}
            scatter = lambda key, src: P[key].index_copy(0, pixel, src)
        else:
            pixel = torch.arange(h * w, device=dev)
        jitter = (taau_jitter(sample_id_tensor(sid, dev))
                  if cfg.upscale > 1 else None)

        # ---- ReSTIR DI prepass: the primary G-buffer feeds the light
        # reservoirs, whose samples drive the main trace's bounce-0 NEE
        di_sample = None
        if cfg.use_restir_di:
            gcfg = replace(rcfg, bounces=1, use_nee=False,
                           restir_capture=True, cache_capture=False,
                           cache_query_bounce=-1)
            _, gst = render_sample_with_stats(scene, cam, gcfg, pixel, sid)
            g_x1, g_n, g_d = gst["x1"], gst["normal"], gst["depth"]
            if k > 1:
                # the prepass G-buffer: the fresh subset over the stale
                # rest; the reservoirs reproject by themselves
                P["di_x1"], P["di_n"], P["di_d"] = (
                    scatter("di_x1", g_x1), scatter("di_n", g_n),
                    scatter("di_d", g_d))
                g_x1, g_n, g_d = P["di_x1"], P["di_n"], P["di_d"]
            g_d = g_d.reshape(h, w)
            di_sample, new["restir_di"] = restir_di_reservoirs(
                scene, cam, rcfg, state.restir_di, sid, g_x1.reshape(h, w, 3),
                g_n.reshape(h, w, 3), g_d, prev_cam=prev_cam,
                motion=motion_of(g_d, gst["inst"]) if k == 1 else None)
            if k > 1:
                # the main trace shades the fresh subset only
                di_sample = {key: v[pixel] for key, v in di_sample.items()}

        # ---- the one trace: integrator, ReSTIR GI captures and the
        # radiance cache's records come out of one bounce loop
        if cfg.use_radiance_cache:
            rad, st, cache = render_sample_cached(
                scene, cam, rcfg, state.cache, pixel, sid,
                di_sample=di_sample, jitter=jitter)
            if cam_moved and prev_cam is not None:
                # re-levelled cells inherit their previous level's
                # accumulation (reference GetReprojectedHash)
                cache = cache_resolve(cache, cam_pos=cam.c2w[3, :3],
                                      prev_cam_pos=prev_cam.c2w[3, :3])
            else:
                cache = cache_resolve(cache)
            new["cache"] = cache
        else:
            rad, st = render_sample_with_stats(scene, cam, rcfg, pixel, sid,
                                               di_sample=di_sample,
                                               jitter=jitter)
        if k > 1:
            # compose the frame: stale pixels keep their (reprojected)
            # values, the traced subset scatters fresh ones
            for key in ("albedo", "normal", "depth", "emitted0", "inst"):
                P[key] = scatter(key, st[key])
            P["rad"] = scatter("rad", rad)
            rad = P["rad"]
            comp = dict(st, albedo=P["albedo"], normal=P["normal"],
                        depth=P["depth"], emitted0=P["emitted0"],
                        inst=P["inst"])
            if cfg.use_restir:
                # the persistent channels (the final shade reads every
                # pixel); the candidate channels go into zeros, so stale
                # pixels submit no fresh candidate and their reservoirs
                # persist
                for key in ("direct", "x1", "mat1"):
                    P[key] = scatter(key, st[key])
                    comp[key] = P[key]
                for key in ("x2", "n2", "tp1", "indirect", "pdf1",
                            "cand_valid"):
                    src = st[key]
                    comp[key] = torch.zeros(
                        (h * w,) + src.shape[1:], dtype=src.dtype,
                        device=dev).index_copy(0, pixel, src)
            new["partial"] = P
            st = comp
        frame = rad.reshape(h, w, 3)
        albedo = st["albedo"].reshape(h, w, 3)
        normal = st["normal"].reshape(h, w, 3)
        depth = st["depth"].reshape(h, w)
        emissive = st["emitted0"].reshape(h, w, 3)
        motion = motion_of(depth, st["inst"])

        # ---- ReSTIR GI: the reservoir-shaded indirect replaces the
        # traced one; its temporal-validation gradients feed ASVGF
        if cfg.use_restir:
            frame, new["restir"], aux = restir_gi_from_stats(
                scene, cam, rcfg, state.restir, sid, st, prev_cam=prev_cam,
                motion=motion)

        if cfg.denoiser == "svgf":
            frame, new["svgf"] = svgf_denoise(frame, albedo, normal, depth,
                                              state.svgf, motion=motion,
                                              emissive=emissive)
        elif cfg.denoiser == "asvgf":
            ast = state.asvgf
            if cfg.use_restir:
                # ReSTIR-ASVGF: the GI gradients drive the history clamp;
                # no replay stratum, no extra trace
                alpha_map, _ = gradient_alpha(aux["gradient"], h, w)
                cur_lum = ast.prev_lum
                s2 = sample_id_tensor(sid, dev)
            else:
                alpha_map, _, cur_lum, s2 = asvgf_gradient(
                    scene, cam, rcfg, ast, sid, rad)
            frame, svgf_st, lf_hist, lf_len = asvgf_filter(
                frame, albedo, normal, depth, ast, alpha_map, motion=motion,
                emissive=emissive)
            new["asvgf"] = ASVGFState(svgf=svgf_st, prev_lum=cur_lum,
                                      prev_sid=s2, lf_hist=lf_hist,
                                      lf_len=lf_len)
        elif cfg.denoiser == "recur":
            frame, new["recur"] = recur_denoise(frame, albedo, normal, depth,
                                                state.recur, motion=motion,
                                                emissive=emissive)
        elif cfg.denoiser in ("neural", "neural_taa"):
            frame = neural_denoise(self.neural, frame, albedo, normal)
            if cfg.denoiser == "neural_taa":
                # the U-Net has no temporal term: a reprojected,
                # neighbourhood-clamped blend of its output stops it
                # flickering
                frame = taa(frame, state.neural_hist, alpha=0.2,
                            motion=motion)
                new["neural_hist"] = frame
        if cfg.post.firefly > 0.0:
            frame = firefly_clamp(frame, cfg.post.firefly)
        if cfg.upscale > 1:
            # TAAU to the output size; the post chain's TAA runs there too
            frame, new["taau_history"] = taau_upscale(
                frame, state.taau_history, scale=cfg.upscale, jitter=jitter,
                motion=motion)
            if motion is not None:
                motion = upscale_motion(motion, cfg.upscale, cfg.height,
                                        cfg.width)
        accum = state.accum
        if k > 1:
            # until every interleave phase has traced once the composed
            # frame holds cold (zero) pixels: restart the running mean in
            # each of those frames
            keep = (1.0 - (sid < k - 1).to(torch.float32)
                    if isinstance(sid, torch.Tensor) else float(sid >= k - 1))
            accum = Accumulator(image=accum.image * keep,
                                count=accum.count * keep)
        new["accum"] = accum.add(frame)
        if state.exposure is not None:
            display, new["taa_history"], new["exposure"] = postprocess(
                new["accum"].image, cfg.post, state.taa_history,
                motion=motion, exposure_state=state.exposure)
        else:
            display, new["taa_history"] = postprocess(
                new["accum"].image, cfg.post, state.taa_history,
                motion=motion)
        return display, new

    def graph_step(self, cam_moved: bool = False) -> "GraphFrame":
        """The frame as CUDA graphs, the counterpart of the JAX
        `jit_step`: returns `frame(state, cam=None) -> (display,
        radiance, new_state)` (see GraphFrame). `cam_moved` is fixed per
        frame function, as JAX's static argument: True restarts
        accumulation every frame, False never does. Needs a scene on a
        CUDA card."""
        return GraphFrame(self, cam_moved)


_CAM = ("c2w", "fov_y", "aperture", "focus_dist")
# the FrameState fields that are one tensor each
_SINGLE = ("taa_history", "taau_history", "exposure", "neural_hist",
           "prev_inst_l2w")


def _fields(prefix: str, obj) -> list:
    """(dotted name, tensor) of a state dataclass, nested ones (ASVGF's
    SVGF state) flattened."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out += (_fields(f"{prefix}{f.name}.", v)
                if dataclasses.is_dataclass(v) else
                [(f"{prefix}{f.name}", v)])
    return out


def _build(cls, t: dict, prefix: str):
    """The state dataclass `cls` of the tensors named `prefix...` in t."""
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: _build(hints[f.name], t, f"{prefix}{f.name}.")
                  if dataclasses.is_dataclass(hints[f.name])
                  else t[f"{prefix}{f.name}"]
                  for f in dataclasses.fields(cls)})


def _tensors(state: FrameState) -> list:
    """(name, tensor) of a frame state's tensors besides its cameras:
    the accumulator, the TAA and TAAU histories, the exposure, the
    neural_taa history, the last frame's instance transforms, partial
    rendering's buffers ("partial.rad",
    ...), and every tensor of the denoiser's histories, the ReSTIR GI
    and DI reservoirs and the radiance cache."""
    out = [("accum.image", state.accum.image),
           ("accum.count", state.accum.count)]
    for key in _SINGLE:
        if getattr(state, key) is not None:
            out.append((key, getattr(state, key)))
    if state.partial is not None:
        out += [(f"partial.{k}", v) for k, v in state.partial.items()]
    for part in _PARTS:
        obj = getattr(state, part)
        if obj is not None:
            out += _fields(f"{part}.", obj)
    return out


def _cams(name: str, cam: Camera) -> list:
    return [(f"{name}.{k}", getattr(cam, k)) for k in _CAM]


def _state(t: dict, sample: int, prev: str) -> FrameState:
    """FrameState of the named tensors in `t`, its previous camera the
    one named `prev` ("prev_cam" or "cam")."""
    parts = {part: _build(cls, t, f"{part}.")
             if any(k.startswith(f"{part}.") for k in t) else None
             for part, cls in _PARTS.items()}
    partial = {k[len("partial."):]: v for k, v in t.items()
               if k.startswith("partial.")}
    return FrameState(
        accum=Accumulator(image=t["accum.image"], count=t["accum.count"]),
        sample=sample, prev_cam=Camera(**{k: t[f"{prev}.{k}"] for k in _CAM}),
        partial=partial or None,
        **{k: t.get(k) for k in _SINGLE}, **parts)


def _capture(fn, device):
    """Capture fn() as a CUDA graph on `device`, after one run on a side
    stream (torch's recipe: lazy set-up happens outside the capture).
    Returns (graph, what fn returned during the capture: tensors in the
    graph's memory, which every replay writes anew)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _check_device(device):
    if device.type != "cuda":
        raise ValueError("graph_step captures CUDA graphs and needs a scene "
                         f"on a CUDA card; Renderer.step runs on {device}")


def _scene_parts(scene: Scene) -> tuple:
    """(the scene's tensors as (name, tensor), nested parts and the packed
    traversal table included; the values a captured frame takes as fixed:
    shapes, dtypes and the Python fields)."""
    tensors, fixed = [], []

    def walk(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = f"{prefix}{f.name}"
            if isinstance(v, torch.Tensor):
                tensors.append((name, v))
                fixed.append((name, tuple(v.shape), v.dtype))
            elif dataclasses.is_dataclass(v):
                walk(f"{name}.", v)
            elif name != "lbvh_depth":
                fixed.append((name, v))

    scene.cw_table()
    scene.bvh2_table()
    walk("", scene)
    return tensors, tuple(fixed)


def _clone_scene(obj):
    """A copy of a scene (or a part of one) with every tensor cloned."""
    return dataclasses.replace(obj, **{
        f.name: (getattr(obj, f.name).clone()
                 if isinstance(getattr(obj, f.name), torch.Tensor)
                 else _clone_scene(getattr(obj, f.name))
                 if dataclasses.is_dataclass(getattr(obj, f.name))
                 else getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


class _Captured:
    """The frame captured as a CUDA graph: the buffers it reads (state,
    previous camera, camera, sample id, a copy of the scene), the graph,
    its display."""

    def __init__(self, r: Renderer, state: FrameState, cam_moved: bool):
        self.src = r.scene
        r.scene.cw_table()
        r.scene.bvh2_table()
        self.scene = _clone_scene(r.scene)
        self.tensors, self.fixed = _scene_parts(self.scene)
        self.sid = torch.zeros((), dtype=torch.int64, device=r.scene.device)
        self.buf = {k: v.clone() for k, v in self._inputs(state, r.cam)}
        st_in = _state(self.buf, 0, "prev_cam")
        cam_in = Camera(**{k: self.buf[f"cam.{k}"] for k in _CAM})

        def body():
            st = r.reset_accumulation(st_in) if cam_moved else st_in
            display, new = r._frame(st, cam_in, self.sid, cam_moved,
                                    scene=self.scene)
            # the new state goes back into the buffers the next replay
            # reads
            for k, v in _tensors(FrameState(sample=0, prev_cam=cam_in,
                                            **new)):
                self.buf[k].copy_(v)
            return display

        self.sid.fill_(state.sample)
        self.graph, self.display = _capture(body, r.scene.device)

    @staticmethod
    def _inputs(state: FrameState, cam: Camera) -> list:
        # the previous camera before the camera: a state this graph
        # returned has the camera buffers as its previous camera
        return (_tensors(state) + _cams("prev_cam", state.prev_cam)
                + _cams("cam", cam))

    def load(self, scene: Scene) -> bool:
        """Copy `scene` into the captured scene's tensors on the device,
        when its shapes, dtypes and Python fields are the captured ones
        (its light-BVH depth no deeper: the captured descent loops run
        the extra levels as no-ops). Returns False, copying nothing,
        when the scene needs a new capture."""
        tensors, fixed = _scene_parts(scene)
        if fixed != self.fixed or scene.lbvh_depth > self.scene.lbvh_depth:
            return False
        for (_, dst), (_, src) in zip(self.tensors, tensors):
            dst.copy_(src)
        self.src = scene
        return True

    def run(self, state: FrameState, cam: Camera):
        """Set the sample id, copy in what the buffers do not hold
        already (device to device), replay."""
        self.sid.fill_(state.sample)
        for k, v in self._inputs(state, cam):
            if v is not self.buf[k]:
                self.buf[k].copy_(v)
        self.graph.replay()
        return (self.display, self.buf["accum.image"],
                _state(self.buf, state.sample + 1, "cam"))


class GraphFrame:
    """`Renderer.step` as a CUDA graph (made by `Renderer.graph_step`).

    `frame(state, cam=None, scene=None)` returns (display, radiance,
    new_state) as `step` does, with the camera moved to `cam` and the
    scene swapped for `scene` when they are passed, and accumulation
    restarted every frame when `cam_moved` is true and never otherwise
    (a new scene does not restart it, as the JAX `jit_step`, which takes
    the scene as a traced argument). A frame without a previous camera or
    TAA history (the first after `init_state`) runs eagerly. The next one
    is captured (`torch.cuda.CUDAGraph`) with a copy of the scene, and
    every later one replays it: the device runs the frame's kernels back
    to back with no host work between them. A new scene whose tensors
    have the captured copy's shapes (an update_instance_transforms
    result) is copied into that copy on the device, the traversal table
    included, and replayed; a scene of other shapes is captured anew.

    The graph reads buffers of its own and, as its last work, writes the
    new state back into them. Before a replay the sample id is set by a
    fill kernel (the value travels as a launch argument), and the
    cameras and any state the buffers do not already hold are copied in
    on the device: a replay makes no host copy and no sync. What a replay
    returns (display, radiance and the new state) is the graph's own
    memory, which the next replay of this frame function overwrites:
    clone what must outlive it. The kernel wrappers' launch counters
    count eager launches only.
    """

    def __init__(self, renderer: Renderer, cam_moved: bool):
        self.r = renderer
        self.cam_moved = bool(cam_moved)
        self.captures = 0
        self._captured: Optional[_Captured] = None

    def __call__(self, state: FrameState, cam: Optional[Camera] = None,
                 scene: Optional[Scene] = None):
        r = self.r
        if scene is not None:
            r.scene = scene
        _check_device(r.scene.device)
        if cam is not None:
            r.cam = cam.to(r.scene.device)
        if state.prev_cam is None or state.taa_history is None:
            if self.cam_moved:
                state = r.reset_accumulation(state)
            return r.step(state, cam_moved=self.cam_moved)
        cap = self._captured
        if cap is None or (cap.src is not r.scene and not cap.load(r.scene)):
            self._captured = _Captured(r, state, self.cam_moved)
            self.captures += 1
        return self._captured.run(state, r.cam)
