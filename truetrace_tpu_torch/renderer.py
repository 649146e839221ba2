"""Frame orchestrator: the user-facing renderer.

Port of `truetrace_tpu/renderer.py` for the frames the port covers: the
ReSTIR DI prepass (a 1-bounce G-buffer trace feeding the light
reservoirs), one path-traced sample per pixel (through the radiance
cache, which it queries and feeds, where that is on), the cache's
per-frame resolve, ReSTIR GI from the trace's captures, SVGF (or no
denoiser), the firefly clamp, accumulation and post-processing; the
JAX package's composed production frame with every option on. Per-frame
state is an explicit `FrameState` threaded through `Renderer.step`,
which runs eagerly on the scene's device. `Renderer.graph_step` is the counterpart of the JAX `jit_step`:
on a CUDA card it captures the frame once as a CUDA graph and replays it,
so the device runs the frame's kernels without the host launching each
one. Options outside the slice raise NotImplementedError naming their
ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
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
from truetrace_tpu_torch.post.motion import motion_vectors
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
        if self.upscale > 1:
            _todo("TAAU upscaling", "A.10")
        if self.partial_rendering > 1:
            _todo("partial rendering", "A.10")
        self.post.check_supported()

    def render_config(self) -> RenderConfig:
        return RenderConfig(
            width=self.width, height=self.height, bounces=self.bounces,
            bsdf=self.bsdf, traversal=self.traversal,
            light_sampling=self.light_sampling, use_nee=self.use_nee,
            restir_capture=self.use_restir,
            cache_capture=self.use_radiance_cache,
            cache_query_bounce=(self.cache_query_bounce
                                if self.use_radiance_cache else -1))


# the optional per-frame states: FrameState field -> its class
_PARTS = {"svgf": SVGFState, "restir": ReSTIRState,
          "restir_di": ReSTIRDIState, "cache": RadianceCache}


@dataclass
class FrameState:
    accum: Accumulator
    sample: int                          # next sample id
    svgf: Optional[SVGFState]
    taa_history: Optional[torch.Tensor]
    prev_cam: Optional[Camera] = None    # last frame's camera (motion)
    restir: Optional[ReSTIRState] = None        # ReSTIR GI reservoirs
    restir_di: Optional[ReSTIRDIState] = None   # ReSTIR DI reservoirs
    cache: Optional[RadianceCache] = None       # the radiance cache

    @staticmethod
    def from_numpy(d: dict, device) -> "FrameState":
        """FrameState from the JAX FrameState's leaves (numpy arrays in
        nested dicts keyed by field name)."""
        for key, item in (("asvgf", "A.11"), ("recur", "A.11"),
                          ("taau_history", "A.10"), ("partial", "A.10"),
                          ("exposure", "A.10"), ("neural_hist", "A.13")):
            if d.get(key) is not None:
                _todo(f"FrameState.{key}", item)
        t = lambda a: None if a is None else torch.from_numpy(
            np.array(a, np.float32)).to(device)
        return FrameState(
            accum=Accumulator.from_numpy(d["accum"], device),
            sample=int(d["sample"]),
            taa_history=t(d.get("taa_history")),
            prev_cam=Camera.from_numpy(d["prev_cam"], device)
            if d.get("prev_cam") is not None else None,
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

    def init_state(self) -> FrameState:
        cfg = self.cfg
        h, w, dev = cfg.height, cfg.width, self.scene.device
        return FrameState(
            accum=Accumulator.create(h, w, dev), sample=0,
            svgf=SVGFState.create(h, w, dev)
            if cfg.denoiser == "svgf" else None,
            taa_history=None, prev_cam=None,
            restir=ReSTIRState.create(h, w, dev) if cfg.use_restir
            else None,
            restir_di=ReSTIRDIState.create(h, w, dev)
            if cfg.use_restir_di else None,
            cache=RadianceCache.create(cfg.cache_capacity, dev)
            if cfg.use_radiance_cache else None)

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
        geometry and restarts accumulation."""
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

    def _frame(self, state: FrameState, cam: Camera, sid, cam_moved: bool):
        """The device work of one frame from `state`, seen by `cam`, with
        sample id `sid` (a Python int, or a 0-d int64 tensor on the card,
        as graph_step captures it); `cam_moved` runs the cache's
        reprojection merge. Returns (display, the new state's fields
        other than the sample id and camera)."""
        cfg, rcfg, scene = self.cfg, self.rcfg, self.scene
        h, w = cfg.height, cfg.width
        prev_cam = state.prev_cam
        motion_of = lambda depth: (None if prev_cam is None else
                                   motion_vectors(prev_cam, cam, depth))
        pixel = torch.arange(h * w, device=scene.device)
        new = dict(svgf=state.svgf, restir=state.restir,
                   restir_di=state.restir_di, cache=state.cache)

        # ---- ReSTIR DI prepass: the primary G-buffer feeds the light
        # reservoirs, whose samples drive the main trace's bounce-0 NEE
        di_sample = None
        if cfg.use_restir_di:
            gcfg = replace(rcfg, bounces=1, use_nee=False,
                           restir_capture=True, cache_capture=False,
                           cache_query_bounce=-1)
            _, gst = render_sample_with_stats(scene, cam, gcfg, pixel, sid)
            g_d = gst["depth"].reshape(h, w)
            di_sample, new["restir_di"] = restir_di_reservoirs(
                scene, cam, rcfg, state.restir_di, sid,
                gst["x1"].reshape(h, w, 3), gst["normal"].reshape(h, w, 3),
                g_d, prev_cam=prev_cam, motion=motion_of(g_d))

        # ---- the one trace: integrator, ReSTIR GI captures and the
        # radiance cache's records come out of one bounce loop
        if cfg.use_radiance_cache:
            rad, st, cache = render_sample_cached(
                scene, cam, rcfg, state.cache, pixel, sid,
                di_sample=di_sample)
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
                                               di_sample=di_sample)
        frame = rad.reshape(h, w, 3)
        albedo = st["albedo"].reshape(h, w, 3)
        normal = st["normal"].reshape(h, w, 3)
        depth = st["depth"].reshape(h, w)
        emissive = st["emitted0"].reshape(h, w, 3)
        motion = motion_of(depth)

        # ---- ReSTIR GI: the reservoir-shaded indirect replaces the
        # traced one
        if cfg.use_restir:
            frame, new["restir"], _ = restir_gi_from_stats(
                scene, cam, rcfg, state.restir, sid, st, prev_cam=prev_cam,
                motion=motion)

        if cfg.denoiser == "svgf":
            frame, new["svgf"] = svgf_denoise(frame, albedo, normal, depth,
                                              state.svgf, motion=motion,
                                              emissive=emissive)
        if cfg.post.firefly > 0.0:
            frame = firefly_clamp(frame, cfg.post.firefly)
        new["accum"] = state.accum.add(frame)
        display, new["taa_history"] = postprocess(
            new["accum"].image, cfg.post, state.taa_history, motion=motion)
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


def _tensors(state: FrameState) -> list:
    """(name, tensor) of a frame state's tensors besides its cameras:
    the accumulator, the TAA history, and every tensor of the SVGF
    history, the ReSTIR GI and DI reservoirs and the radiance cache."""
    out = [("accum.image", state.accum.image),
           ("accum.count", state.accum.count)]
    if state.taa_history is not None:
        out.append(("taa_history", state.taa_history))
    for part in _PARTS:
        obj = getattr(state, part)
        if obj is not None:
            out += [(f"{part}.{f.name}", getattr(obj, f.name))
                    for f in dataclasses.fields(obj)]
    return out


def _cams(name: str, cam: Camera) -> list:
    return [(f"{name}.{k}", getattr(cam, k)) for k in _CAM]


def _state(t: dict, sample: int, prev: str) -> FrameState:
    """FrameState of the named tensors in `t`, its previous camera the
    one named `prev` ("prev_cam" or "cam")."""
    parts = {}
    for part, cls in _PARTS.items():
        names = [f.name for f in dataclasses.fields(cls)]
        parts[part] = (cls(**{k: t[f"{part}.{k}"] for k in names})
                       if f"{part}.{names[0]}" in t else None)
    return FrameState(
        accum=Accumulator(image=t["accum.image"], count=t["accum.count"]),
        sample=sample, taa_history=t.get("taa_history"),
        prev_cam=Camera(**{k: t[f"{prev}.{k}"] for k in _CAM}), **parts)


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


class _Captured:
    """The frame captured as a CUDA graph: the buffers it reads (state,
    previous camera, camera, sample id), the graph, its display."""

    def __init__(self, r: Renderer, state: FrameState, cam_moved: bool):
        self.scene = r.scene
        self.sid = torch.zeros((), dtype=torch.int64, device=r.scene.device)
        self.buf = {k: v.clone() for k, v in self._inputs(state, r.cam)}
        st_in = _state(self.buf, 0, "prev_cam")
        cam_in = Camera(**{k: self.buf[f"cam.{k}"] for k in _CAM})

        def body():
            st = r.reset_accumulation(st_in) if cam_moved else st_in
            display, new = r._frame(st, cam_in, self.sid, cam_moved)
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

    `frame(state, cam=None)` returns (display, radiance, new_state) as
    `step` does, with the camera moved to `cam` when one is passed, and
    accumulation restarted every frame when `cam_moved` is true and never
    otherwise. A frame without a previous camera or TAA history (the
    first after `init_state`) runs eagerly. The next one is captured
    (`torch.cuda.CUDAGraph`; again after the renderer's scene changes)
    and every later one replays it: the device runs the frame's kernels
    back to back with no host work between them.

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

    def __call__(self, state: FrameState, cam: Optional[Camera] = None):
        r = self.r
        _check_device(r.scene.device)
        if cam is not None:
            r.cam = cam.to(r.scene.device)
        if state.prev_cam is None or state.taa_history is None:
            if self.cam_moved:
                state = r.reset_accumulation(state)
            return r.step(state, cam_moved=self.cam_moved)
        if self._captured is None or self._captured.scene is not r.scene:
            self._captured = _Captured(r, state, self.cam_moved)
            self.captures += 1
        return self._captured.run(state, r.cam)
