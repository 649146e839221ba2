"""World-space radiance cache: a multi-level voxel hash grid (SHaRC-like).

Port of `truetrace_tpu/integrate/radiance_cache.py`: a fixed-capacity
open hash with bounded linear probing (N_PROBES slots: key match, else
empty, else stale resident, else drop), voxel levels that grow with the
distance from the camera, one batched insert per frame, per-frame decay,
and the camera-motion reprojection merge. The API is functional:
(cache, records) -> new cache.

Keys, hashes and packed cells are uint32 bit patterns held in int64 and
masked to 32 bits after every operation (the idiom of `core/rng.py`);
products with a 32-bit constant are split in two 16-bit halves so that
no int64 product overflows.

Scatters, on both devices:

* JAX drops a record by scattering it to index C with `mode="drop"`;
  torch raises on that index on the CPU and asserts on the card. Here a
  dropped record adds an exact +0.0 to slot (record index mod C), where
  it changes no bit (no slot holds -0.0), and the flags it would set go
  to a spare row C that is cut off again. Spreading the dropped records
  over the table keeps any slot from gathering the hundreds of
  thousands of them that one drop row would.
* Sums go through `index_put_(accumulate=True)`. On the CPU it adds in
  record order, as XLA:CPU's scatter-add does; on CUDA torch sorts the
  indices (a stable radix sort) and sums each slot's records in that
  order, so the result is the same from run to run, and the path makes
  no host sync and captures in a CUDA graph. (`index_add_` adds with
  atomics, in an order that changes from run to run.) A slot's records
  are summed one after another, so the time grows with the most records
  any one slot receives.
* Where several records write one slot's key and cell, the record with
  the highest index wins, on both devices (a `scatter_reduce` amax of
  record ids, then a gather): what XLA:CPU's in-order `.at[].set` gives.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from truetrace_tpu_torch.core.rng import M32

BASE_CELL = 0.02          # meters at reference distance
LEVEL_DIST = 2.0          # distance at which level 0 ends
CONFIDENT_COUNT = 8.0     # min accumulated samples before a query hits
MAX_AGE = 60.0            # frames before an entry may be evicted
N_PROBES = 4
_M17 = (1 << 17) - 1


@dataclass
class RadianceCache:
    key: torch.Tensor     # [C] uint32 tag as int64 (0 = empty)
    rad: torch.Tensor     # [C,3] accumulated radiance * count
    count: torch.Tensor   # [C]
    age: torch.Tensor     # [C] frames since last touch
    cellw0: torch.Tensor  # [C] packed cell identity (_pack_cell), int64
    cellw1: torch.Tensor  # [C]

    @staticmethod
    def create(capacity: int = 1 << 20, device="cuda") -> "RadianceCache":
        z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                        device=device)
        return RadianceCache(key=z(capacity, dtype=torch.int64),
                             rad=z(capacity, 3), count=z(capacity),
                             age=z(capacity),
                             cellw0=z(capacity, dtype=torch.int64),
                             cellw1=z(capacity, dtype=torch.int64))

    @staticmethod
    def from_numpy(d: dict, device) -> "RadianceCache":
        """From the JAX RadianceCache's leaves (uint32 words as int64)."""
        f = lambda k: torch.from_numpy(d[k].astype(
            "int64" if d[k].dtype.kind in "ui" else "float32")).to(device)
        return RadianceCache(**{k.name: f(k.name)
                                for k in dataclasses.fields(RadianceCache)})

    @property
    def capacity(self) -> int:
        return self.key.shape[0]


def _mulc(x, c: int):
    """(x * c) mod 2^32 for uint32 bits x (int64) and a 32-bit constant c,
    as two products below 2^48."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & M32


def _hash_u32(x):
    x = x & M32
    x = x ^ (x >> 16)
    x = _mulc(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulc(x, 0x846CA68B)
    return x ^ (x >> 16)


def _level_of(d):
    return torch.clamp(torch.floor(torch.log2(torch.clamp(
        d / LEVEL_DIST, min=1.0))), 0, 12).to(torch.int64)


def _cell_hash(c, level, oct_n):
    """(slot hash, key) of grid cells c [...,3] (int64, may be negative),
    levels and normal octants; the key is never 0 (0 = empty slot)."""
    h = _hash_u32((c[..., 0] & M32)
                  ^ ((_hash_u32(c[..., 1]) << 1) & M32)
                  ^ ((_hash_u32(c[..., 2]) << 2) & M32)
                  ^ ((level << 27) & M32) ^ ((oct_n << 23) & M32))
    return h, h | 1


def _pack_cell(c, level, oct_n):
    """Grid coords (signed 17 bits an axis) + level (10) + octant (3) in
    two uint32 words (the reference's CompressHash layout)."""
    cx, cy, cz = (c[..., i] & _M17 for i in range(3))
    w0 = (cx | (cy << 17)) & M32
    w1 = ((cy >> 15) | (cz << 2) | ((level << 19) & M32)
          | ((oct_n << 29) & M32)) & M32
    return w0, w1


def _unpack_cell(w0, w1):
    def sext(v):
        return torch.where((v & (1 << 16)) != 0, v | ~_M17, v)
    cx = w0 & _M17
    cy = (((w1 << 15) & M32) | (w0 >> 17)) & _M17
    cz = (w1 >> 2) & _M17
    c = torch.stack([sext(cx), sext(cy), sext(cz)], -1)
    return c, (w1 >> 19) & 0x3FF, w1 >> 29


def cache_cell(pos, normal, cam_pos):
    """(slot hash, key) of a shading point's cell."""
    h, key, _, _ = cache_cell_packed(pos, normal, cam_pos)
    return h, key


def cache_cell_packed(pos, normal, cam_pos):
    """(slot hash, key, packed cell w0, w1) of a shading point: the level
    is log2 of the camera distance, the key folds in the cell coords, the
    level and the normal octant."""
    d = torch.linalg.norm(pos - cam_pos, dim=-1)
    level = _level_of(d)
    cell_size = BASE_CELL * torch.exp2(level.to(torch.float32))
    c = torch.floor(pos / cell_size[..., None]).to(torch.int64)
    oct_n = ((normal[..., 0] > 0).to(torch.int64)
             | ((normal[..., 1] > 0).to(torch.int64) << 1)
             | ((normal[..., 2] > 0).to(torch.int64) << 2))
    h, key = _cell_hash(c, level, oct_n)
    w0, w1 = _pack_cell(c, level, oct_n)
    return h, key, w0, w1


def _probe_slots(capacity: int, slot_hash):
    base = slot_hash % capacity
    return torch.stack([(base + k) % capacity for k in range(N_PROBES)], -1)


def cache_update(cache: RadianceCache, slot_hash, key, radiance, weight,
                 w0=None, w1=None) -> RadianceCache:
    """Batch insert of N records: radiance [N,3], weight [N] (0 = skip).
    Probe order per record: key match > empty > stale resident > drop.
    Claimed slots are reset before the records accumulate."""
    C = cache.capacity
    N = slot_hash.shape[0]
    slots = _probe_slots(C, slot_hash)                   # [N,P]
    live = weight > 0.0
    resident = cache.key[slots]
    is_match = resident == key[:, None]
    is_empty = resident == 0
    is_stale = cache.age[slots] > MAX_AGE
    # matches (0) before empties (1) before stale (2); ties by probe order
    score = (torch.where(is_match, 0, torch.where(
        is_empty, 1, torch.where(is_stale, 2, 3))) * N_PROBES
        + torch.arange(N_PROBES, device=slots.device))
    best, pick = score.min(-1)
    slot = torch.gather(slots, 1, pick[:, None])[:, 0]
    picked = torch.div(best, N_PROBES, rounding_mode="floor")
    claim = live & (picked > 0) & (picked < 3)
    use = live & ((picked == 0) | claim)

    reset = torch.zeros(C + 1, dtype=torch.bool, device=slots.device)
    reset.index_fill_(0, torch.where(claim, slot, C), True)
    reset = reset[:C]
    count = torch.where(reset, 0.0, cache.count)
    rad = torch.where(reset[:, None], 0.0, cache.rad)
    rec = torch.arange(N, device=slots.device)
    idx = torch.where(use, slot, rec % C)
    rad.index_put_((idx,), torch.where(use[:, None], radiance
                                       * weight[..., None], 0.0),
                   accumulate=True)
    count.index_put_((idx,), torch.where(use, weight, 0.0), accumulate=True)
    # the record that writes each slot's key and cell: the highest index
    win = torch.full((C,), -1, dtype=torch.int64, device=slots.device)
    win.scatter_reduce_(0, idx, torch.where(use, rec, -1), "amax")
    touched = win >= 0
    src = torch.clamp(win, min=0)
    take = lambda old, new: torch.where(touched, new[src], old)
    return RadianceCache(
        key=take(cache.key, key), rad=rad[:C], count=count[:C],
        age=torch.where(touched, 0.0, cache.age),
        cellw0=cache.cellw0 if w0 is None else take(cache.cellw0, w0),
        cellw1=cache.cellw1 if w1 is None else take(cache.cellw1, w1))


def _first_confident(cache: RadianceCache, h, key):
    """(slot, found) of the first probe of h holding key with a confident
    count."""
    slots = _probe_slots(cache.capacity, h)              # [N,P]
    ok_p = (cache.key[slots] == key[..., None]) \
        & (cache.count[slots] >= CONFIDENT_COUNT)
    pick = ok_p.to(torch.int32).argmax(-1, keepdim=True)   # first True
    return (torch.gather(slots, 1, pick)[:, 0],
            torch.gather(ok_p, 1, pick)[:, 0])


def cache_query(cache: RadianceCache, pos, normal, cam_pos):
    """(radiance [N,3], hit [N]): the first confident key match among
    the N_PROBES slots cache_update probes."""
    h, key = cache_cell(pos, normal, cam_pos)
    slot, ok = _first_confident(cache, h, key)
    rad = cache.rad[slot] / torch.clamp(cache.count[slot],
                                        min=1e-6)[..., None]
    return torch.where(ok[..., None], rad, 0.0), ok


def cache_resolve(cache: RadianceCache, decay: float = 0.98,
                  count_cap: float = 256.0, cam_pos=None,
                  prev_cam_pos=None) -> RadianceCache:
    """Per-frame maintenance: age entries, decay and cap the
    accumulators. With cam_pos and prev_cam_pos, also the camera-motion
    reprojection merge: each young entry whose cell had another level
    under the previous camera pulls the accumulation of that
    previous-level entry (the reference's GetReprojectedHash)."""
    scale = torch.where(cache.count > count_cap,
                        count_cap / torch.clamp(cache.count, min=1e-6), 1.0)
    scale = scale * decay
    rad = cache.rad * scale[:, None]
    count = cache.count * scale
    if cam_pos is not None and prev_cam_pos is not None:
        c, level, oct_n = _unpack_cell(cache.cellw0, cache.cellw1)
        cell_size = BASE_CELL * torch.exp2(level.to(torch.float32))
        center = (c.to(torch.float32) + 0.5) * cell_size[:, None]
        lev_prev = _level_of(torch.linalg.norm(center - prev_cam_pos,
                                               dim=-1))
        # pull only into young entries (cold-started ones), so repeated
        # pulls do not count a still-live source twice
        young = (cache.key != 0) & (count < 2.0 * CONFIDENT_COUNT) \
            & (lev_prev != level)
        size_prev = BASE_CELL * torch.exp2(lev_prev.to(torch.float32))
        c_prev = torch.floor(center / size_prev[:, None]).to(torch.int64)
        h_src, key_src = _cell_hash(c_prev, lev_prev, oct_n)
        # the source must be confident before this frame's decay
        src, found = _first_confident(cache, h_src, key_src)
        nn = torch.arange(src.shape[0], device=src.device)
        pull = young & found & (src != nn)
        rad = rad + torch.where(pull[:, None], rad[src], 0.0)
        count = count + torch.where(pull, count[src], 0.0)
    return RadianceCache(key=cache.key, rad=rad, count=count,
                         age=cache.age + 1.0, cellw0=cache.cellw0,
                         cellw1=cache.cellw1)


def _bounce_of(a, b):
    """a[:, b] for a Python int b or a 0-d device tensor b (graph_step's
    sample id), the latter without reading it back."""
    if isinstance(b, torch.Tensor):
        return torch.index_select(a, 1, b.reshape(1))[:, 0]
    return a[:, b]


def render_sample_cached(scene, cam, cfg, cache: RadianceCache, pixel,
                         sample_id, di_sample=None, jitter=None):
    """One wavefront sample that queries and feeds the cache. Returns
    (radiance [R,3], stats, new cache). cfg must have cache_capture.

    Only one bounce level a frame is inserted (sample_id % B, one record
    a pixel): the cache accumulates across frames, so every level lands
    every B frames."""
    from truetrace_tpu_torch.core import rng
    from truetrace_tpu_torch.integrate.pathtrace import (
        render_sample_with_stats)
    radiance, st = render_sample_with_stats(scene, cam, cfg, pixel,
                                            sample_id, cache=cache,
                                            di_sample=di_sample,
                                            jitter=jitter)
    # per-bounce outgoing-radiance estimates: what was gathered after
    # entering the vertex, over the path throughput at entry
    L = (radiance[:, None, :] - st["cache_prefix"]) \
        / torch.clamp(st["cache_tp"], min=1e-6)
    b = rng.u32(sample_id) % L.shape[1]
    w0 = _bounce_of(st["cache_w0"], b)
    w1 = _bounce_of(st["cache_w1"], b)
    h, key = _cell_hash(*_unpack_cell(w0, w1))
    cache = cache_update(cache, h, key,
                         torch.clamp(_bounce_of(L, b), 0.0, 1e4),
                         _bounce_of(st["cache_live"], b).to(torch.float32),
                         w0=w0, w1=w1)
    return radiance, st, cache
