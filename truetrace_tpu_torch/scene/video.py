"""Video textures: animated atlas slots.

Port of `truetrace_tpu/scene/video.py` (the reference's VideoObject.cs: a
video rendered into a texture that the shade kernel samples, e.g. as an
emissive surface, RayTracingShader.compute:630). The video's frames live
on the device as one [N,H,W,4] stack; binding a frame writes it, and its
mip levels, into the texture's atlas rect of a new atlas tensor. The rect
is addressed by index tensors made from the scene's own rect and level
tables, so a bind copies nothing from the host and never syncs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from truetrace_tpu_torch.scene.atlas import AtlasBuilder, _pad_align
from truetrace_tpu_torch.scene.ir import Scene


@dataclass
class VideoTexture:
    """A registered video: its atlas slot and frame stack [N,H,W,4]."""
    tex_id: int
    frames: torch.Tensor
    fps: float = 30.0

    @property
    def n_frames(self) -> int:
        return self.frames.shape[0]


def register_video(builder: AtlasBuilder, frames: np.ndarray,
                   fps: float = 30.0, device="cuda") -> VideoTexture:
    """Reserve an atlas rect sized like one frame (its first frame fills
    it until a bind) and put the frames on `device` (the card unless the
    caller asks for the CPU). `frames`: [N,H,W,C] uint8 or float."""
    f = np.asarray(frames)
    if f.dtype == np.uint8:
        f = f.astype(np.float32) / 255.0
    if f.shape[-1] == 3:
        f = np.concatenate([f, np.ones_like(f[..., :1])], axis=-1)
    f = np.stack([_pad_align(fr) for fr in f])
    tex_id = builder.add(f[0])
    return VideoTexture(tex_id=tex_id, frames=torch.as_tensor(
        f, dtype=torch.float32, device=device), fps=fps)


def bind_video_frame(scene: Scene, video: VideoTexture, frame_index
                     ) -> Scene:
    """A new scene whose atlas shows frame `frame_index` (an int or a 0-d
    tensor on the scene's device; wraps around the clip) at EVERY mip
    level: the integrator samples through ray-cone LOD, so a level-0
    write alone would leave the first frame wherever the LOD rounds up."""
    dev = scene.atlas.device
    idx = torch.as_tensor(frame_index, dtype=torch.int64, device=dev)
    idx = torch.remainder(idx, video.n_frames).reshape(1)
    lv = torch.index_select(video.frames, 0, idx)[0]          # [H,W,4]
    rect = scene.atlas_rects[video.tex_id]                    # x, y, w, h
    atlas = scene.atlas
    for k in range(int(scene.atlas_level_y.shape[0])):
        h, w = lv.shape[0], lv.shape[1]
        if h < 1 or w < 1:
            break
        rows = (rect[1] >> k) + scene.atlas_level_y[k] + torch.arange(
            h, device=dev)
        cols = (rect[0] >> k) + torch.arange(w, device=dev)
        atlas = atlas.index_put((rows[:, None], cols[None, :]), lv)
        hh, ww = h // 2, w // 2
        if hh < 1 or ww < 1:
            break
        lv = lv[:hh * 2, :ww * 2].reshape(hh, 2, ww, 2, 4).mean((1, 3))
    return dataclasses.replace(scene, atlas=atlas)


def bind_video_time(scene: Scene, video: VideoTexture, t_seconds) -> Scene:
    """Bind by clip time: frame = floor(t * fps) (a float or a 0-d tensor
    on the scene's device)."""
    t = torch.as_tensor(t_seconds, dtype=torch.float32,
                        device=scene.atlas.device)
    return bind_video_frame(scene, video, (t * video.fps).to(torch.int64))
