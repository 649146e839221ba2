"""Torch port, build options and tooling: presplit, heat-ordered leaf rows
and the on-disk build cache against the JAX package's compile_scene, table
for table and bit for bit (leaf_k 3 and 6, alone and together); the cache's
key, its entries read across the two packages, a hit that runs no builder
and a truncated entry that rebuilds; the plain traversal and the step
core on a heat-ordered table against the node-major one; the scene
inspector's reports; and the profiling helpers (interleaved_ab ranks two
variants of tenfold cost, and makes no other wall-clock assertion)."""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import truetrace_tpu.build.cwbvh as jcwbvh_mod
import truetrace_tpu.build.lightbvh as jlb_mod
import truetrace_tpu.kernels.cwbvh_wavefront as jwf
import truetrace_tpu.scene.mesh as jmesh
from tests.test_presplit import _scene_meshes
from truetrace_tpu.build.presplit import presplit_triangles as jpresplit
from truetrace_tpu.scene import build_cache as jbc
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.tools.inspector import inspect_scene as jinspect
from truetrace_tpu.utils import profiling as jprof
from truetrace_tpu_torch.build.presplit import presplit_triangles as tpresplit
from truetrace_tpu_torch.kernels import cwbvh_wavefront as twf
from truetrace_tpu_torch.kernels.step_pallas import step_core_plain
from truetrace_tpu_torch.scene import build_cache as tbc
from truetrace_tpu_torch.scene import cornell as tcornell
from truetrace_tpu_torch.scene import mesh as tmesh
from truetrace_tpu_torch.tools.inspector import inspect_scene as tinspect
from truetrace_tpu_torch.utils import profiling as tprof

TABLES = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_tan",
          "tri_mat", "tri_lod", "bvh2_box", "bvh2_left", "bvh2_count",
          "cw_nodes", "cw_tri_index", "cw_leaf_rows", "lbvh_nodes",
          "lbvh_info", "lbvh_prim", "lbvh_trail", "lbvh_pairs",
          "lbvh_pair_children", "lcut_bounds", "lcut_link", "lcut_node_ids",
          "lcut_of_light", "lcut_skip")


def _bits(x):
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.int64) & 0xFFFFFFFF if x.dtype.kind in "iu" \
        else x.view(np.uint32)


def same_tables(js, ts):
    """Every table of a JAX Scene and a port Scene, bit for bit."""
    for f in TABLES:
        a, b = getattr(js, f), getattr(ts, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.asarray(a).shape == tuple(b.shape), f
            assert (_bits(a) == _bits(b)).all(), f
    for part in ("light_tris", "materials"):
        for f in dataclasses.fields(getattr(ts, part)):
            a = getattr(getattr(js, part), f.name)
            b = getattr(getattr(ts, part), f.name)
            assert (_bits(a) == _bits(b)).all(), f"{part}.{f.name}"
    assert (js.cw_stack, js.has_media) == (ts.cw_stack, ts.has_media)


def _meshes():
    """tests/test_presplit.py's scene (a 40 x 40 floor under 40 small
    boxes), its first box emissive so the light BVH has 12 lights."""
    jm, jmat = _scene_meshes()
    jmat = [dataclasses.replace(jmat[0], emission=(0.0, 0.0, 0.0)),
            jmesh.HostMaterial(emission=(4.0, 3.0, 2.0))]
    jm[1] = jmesh.HostMesh(jm[1].positions, jm[1].indices,
                           np.ones(12, np.int32))
    tm = [tmesh.HostMesh(m.positions, m.indices, m.mat_id) for m in jm]
    tmat = [tmesh.HostMaterial(**dataclasses.asdict(m)) for m in jmat]
    return jm, jmat, tm, tmat


OPTS = {"presplit": dict(presplit=8.0), "hot": dict(hot_order=True),
        "cache": dict(cache=True),
        "all": dict(presplit=8.0, hot_order=True, cache=True)}


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("opt", list(OPTS))
def test_build_options_match_jax(tmp_path, opt, k):
    """compile_scene with presplit, hot_order, cache_dir and all three,
    at leaf_k 3 and 6: every table the JAX package's bits. With the
    cache, both packages write the same entry (file name and every npz
    member), and a second build from it is the first's."""
    jm, jmat, tm, tmat = _meshes()
    kw = dict(OPTS[opt])
    cache = kw.pop("cache", False)
    kw.update(with_cwbvh=True, with_light_bvh=True, leaf_k=k)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    js = jmesh.compile_scene(jm, jmat, cache_dir=jd if cache else None, **kw)
    ts = tmesh.compile_scene(tm, tmat, cache_dir=td if cache else None,
                             device="cpu", **kw)
    same_tables(js, ts)
    if "presplit" in kw:
        assert ts.n_tris() > 482
    if cache:
        assert os.listdir(jd) == os.listdir(td) and len(os.listdir(td)) == 1
        name = os.listdir(td)[0]
        with np.load(os.path.join(jd, name)) as a, \
                np.load(os.path.join(td, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                assert a[f].dtype == b[f].dtype, f
                assert a[f].tobytes() == b[f].tobytes(), f
        same_tables(js, tmesh.compile_scene(tm, tmat, cache_dir=td,
                                            device="cpu", **kw))


def test_presplit_triangles_match_jax():
    """presplit_triangles on the flattened soup at several ratios, round
    counts and budgets: every array the JAX function's bits."""
    jm, _, _, _ = _meshes()
    tris = jmesh.flatten_meshes(jm)
    for kw in (dict(max_ratio=16.0), dict(max_ratio=2.0),
               dict(max_ratio=1.0, max_rounds=3),
               dict(max_ratio=1.0, budget=1.05)):
        a, b = jpresplit(tris, **kw), tpresplit(tris, **kw)
        assert a.keys() == b.keys()
        for f in a:
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
            assert (a[f].view(np.uint32) == b[f].view(np.uint32)).all() \
                if a[f].dtype.kind == "f" else (a[f] == b[f]).all(), f


def test_build_cache_key_and_entries_cross(tmp_path, monkeypatch):
    """scene_build_key is the JAX hex digest over the same bytes (leaf_k,
    the light-BVH and hot-order flags, emissions); an entry written by
    the JAX package builds the port's Scene with no builder run, and one
    written by the port builds the JAX Scene with none, each bit for bit
    the other package's own build."""
    jm, jmat, tm, tmat = _meshes()
    tris = jmesh.flatten_meshes(jm)
    for k, lb, hot in ((3, True, False), (6, False, True), (12, True, True)):
        assert tbc.scene_build_key(tris, tmat, k, lb, hot_order=hot) == \
            jbc.scene_build_key(tris, jmat, k, lb, hot_order=hot)
    assert tbc.BUILD_VERSION == jbc.BUILD_VERSION
    kw = dict(with_cwbvh=True, with_light_bvh=True, leaf_k=3)
    js = jmesh.compile_scene(jm, jmat, cache_dir=str(tmp_path / "j"), **kw)
    ts_own = tmesh.compile_scene(tm, tmat, device="cpu", **kw)

    def boom(*a, **k):
        raise AssertionError("a builder ran on a cache hit")

    import truetrace_tpu_torch.build.cwbvh as tcw
    import truetrace_tpu_torch.build.lightbvh as tlb
    with monkeypatch.context() as mp:
        for mod, name in ((tmesh, "build_bvh2"), (tcw, "build_cwbvh"),
                          (tlb, "build_light_bvh")):
            mp.setattr(mod, name, boom)
        same_tables(js, tmesh.compile_scene(tm, tmat, device="cpu",
                                            cache_dir=str(tmp_path / "j"),
                                            **kw))
    tmesh.compile_scene(tm, tmat, device="cpu", cache_dir=str(tmp_path / "t"),
                        **kw)
    with monkeypatch.context() as mp:
        for mod, name in ((jmesh, "build_bvh2"), (jcwbvh_mod, "build_cwbvh"),
                          (jlb_mod, "build_light_bvh")):
            mp.setattr(mod, name, boom)
        same_tables(jmesh.compile_scene(jm, jmat,
                                        cache_dir=str(tmp_path / "t"), **kw),
                    ts_own)


def test_build_cache_env_and_truncated_entry(tmp_path, monkeypatch):
    """TRUETRACE_BUILD_CACHE is the default cache directory; a truncated
    entry is rebuilt (and republished whole), giving the same Scene."""
    _, _, tm, tmat = _meshes()
    monkeypatch.setenv("TRUETRACE_BUILD_CACHE", str(tmp_path))
    kw = dict(with_cwbvh=True, with_light_bvh=True, device="cpu")
    a = tmesh.compile_scene(tm, tmat, **kw)
    (entry,) = tmp_path.glob("scene_*.npz")
    full = entry.read_bytes()
    entry.write_bytes(full[:len(full) // 3])
    assert tbc.load_build(str(tmp_path), entry.name[6:-4]) is None
    b = tmesh.compile_scene(tm, tmat, **kw)
    for f in TABLES:
        assert (_bits(getattr(a, f)) == _bits(getattr(b, f))).all(), f
    assert entry.read_bytes() == full
    assert not list(tmp_path.glob("*.tmp"))
    monkeypatch.delenv("TRUETRACE_BUILD_CACHE")
    assert tbc.default_cache_dir() is None


@pytest.fixture(scope="module")
def cornell_tables():
    """The Cornell box at K = 3, its leaf rows node-major and heat-ordered
    (the port's and the JAX package's reorder), and 1024 rays into it."""
    m, mats, cam = tcornell.make(device="cpu")
    base = tmesh.compile_scene(m, mats, with_cwbvh=True, leaf_k=3,
                               device="cpu")
    hot = tmesh.compile_scene(m, mats, with_cwbvh=True, leaf_k=3,
                              hot_order=True, device="cpu")
    from truetrace_tpu_torch.scene.ir import camera_rays
    R = 1024
    jit = torch.from_numpy(np.random.default_rng(9).random((R, 2)).astype(
        np.float32))
    ro, rd = camera_rays(cam, 32, 32, torch.arange(R), jit)
    # half the rays start a way along, inside the box
    ro = torch.cat([ro[:R // 2], ro[R // 2:] + rd[R // 2:] * 2.0])
    return base, hot, ro.contiguous(), rd.contiguous()


def test_reorder_leaf_rows_hot_matches_jax(cornell_tables):
    """reorder_leaf_rows_hot gives the JAX function's node words and rows
    bit for bit; only node word 5 and the row order change, and every
    node's row group stays whole."""
    base, hot, _, _ = cornell_tables
    n0 = base.cw_nodes.numpy().view(np.uint32)
    r0 = base.cw_leaf_rows.numpy()
    jn, jr = jwf.reorder_leaf_rows_hot(n0, r0)
    tn, tr = twf.reorder_leaf_rows_hot(n0, r0)
    assert (jn == tn).all() and (jr.view(np.uint32) == tr.view(np.uint32)).all()
    assert (hot.cw_nodes.numpy().view(np.uint32) == tn).all()
    assert (n0[:, np.r_[0:5, 6:20]] == tn[:, np.r_[0:5, 6:20]]).all()
    assert (n0[:, 5] != tn[:, 5]).any()
    ids = lambda r: np.sort(r.view(np.int32)[:, -3:].reshape(-1))
    assert (ids(r0) == ids(tr)).all()


@pytest.mark.parametrize("query", ["closest", "any"])
def test_plain_traversal_on_hot_table_is_bitwise(cornell_tables, query):
    """The plain traversal (the CPU path and the kernel's reference) on
    the heat-ordered table gives the node-major table's t, tri, u, v and
    occlusion bit for bit, and the same per-ray work."""
    base, hot, ro, rd = cornell_tables
    out = []
    for s in (base, hot):
        counts = {}
        args = (s.cw_table(), s.cw_nodes.shape[0], ro, rd)
        if query == "closest":
            h = twf.closest_hit_plain(*args, 1e30, s.cw_stack, counts)
            out.append(([h.t, h.tri, h.u, h.v], counts))
        else:
            tm = torch.full((ro.shape[0],), 1.5)
            out.append(([twf.any_hit_plain(*args, tm, s.cw_stack, counts)],
                        counts))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    for k in ("node_decodes", "leaf_rows", "tri_tests"):
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    if query == "closest":
        assert (out[0][0][1] >= 0).float().mean() > 0.3


def test_step_core_plain_on_hot_table(cornell_tables):
    """step_core's plain version on the same logical rows of both tables
    (a node row, or the leaf row that holds a triangle the ray hits):
    t, tri, u, v, hits and chim bit for bit; bleaf differs only in its
    24-bit row base, which is each table's own node word 5."""
    base, hot, ro, rd = cornell_tables
    R = ro.shape[0]
    h = twf.closest_hit_plain(base.cw_table(), base.cw_nodes.shape[0], ro,
                              rd, 1e30, base.cw_stack)
    r = np.random.default_rng(6)
    leaf = torch.from_numpy(r.random(R) < 0.5) & (h.tri >= 0)
    node = torch.from_numpy(r.integers(0, base.cw_nodes.shape[0], R))
    inv = twf._inv_dir(rd)
    ray9 = torch.cat([ro.t(), rd.t(), inv.t()]).contiguous()
    st5 = torch.stack([torch.full((R,), 1e30).view(torch.int32),
                       torch.full((R,), -1, dtype=torch.int32),
                       torch.zeros(R, dtype=torch.int32),
                       torch.zeros(R, dtype=torch.int32),
                       leaf.to(torch.int32)]).contiguous()
    outs = []
    for s in (base, hot):
        table = s.cw_table()
        C = s.cw_nodes.shape[0]
        ids = table[C:, 27:30].to(torch.int64)
        tri2row = torch.zeros(s.n_tris(), dtype=torch.int64)
        rows = torch.arange(table.shape[0] - C)[:, None].expand(-1, 3)
        tri2row[ids[ids >= 0]] = rows[ids >= 0]
        idx = torch.where(leaf, C + tri2row[h.tri.clamp(min=0)], node)
        rowt = torch.nn.functional.pad(table[idx], (0, 2)).t().contiguous()
        outs.append(step_core_plain(rowt, ray9, st5))
    a, b = outs
    assert torch.equal(a[:6], b[:6])
    assert torch.equal(a[6] >> 24, b[6] >> 24)
    base5 = hot.cw_nodes[:, 5][node]
    assert torch.equal((b[6] & 0xFFFFFF)[~leaf], base5[~leaf])
    assert (b[1] >= 0).sum() > R // 8


def _jax_and_port(build):
    jm, jmat, tm, tmat = build()
    return (jmesh.compile_scene(jm, jmat, with_cwbvh=True),
            tmesh.compile_scene(tm, tmat, with_cwbvh=True, device="cpu"))


def _cornell():
    jm, jmat, _ = jcornell.make()
    tm, tmat, _ = tcornell.make(device="cpu")
    return jm, jmat, tm, tmat


def _bad_texture():
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    return ([jmesh.HostMesh(pos, idx, np.zeros(1, np.int32))],
            [jmesh.HostMaterial(tex_albedo=5)],
            [tmesh.HostMesh(pos, idx, np.zeros(1, np.int32))],
            [tmesh.HostMaterial(tex_albedo=5)])


def _degenerate_dark():
    pos = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0],
                    [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return ([jmesh.HostMesh(pos, idx, np.zeros(2, np.int32))],
            [jmesh.HostMaterial()],
            [tmesh.HostMesh(pos, idx, np.zeros(2, np.int32))],
            [tmesh.HostMaterial()])


@pytest.mark.parametrize("case", [_cornell, _bad_texture, _degenerate_dark],
                         ids=["clean", "bad_texture", "degenerate_dark"])
def test_inspector_matches_jax(case):
    """tests/test_inspector.py's three scenes: the port's report (stats,
    findings in order, ok(), the rendered text) is the JAX package's."""
    js, ts = _jax_and_port(case)
    a, b = jinspect(js), tinspect(ts)
    assert a.stats == b.stats
    assert [str(f) for f in a.findings] == [str(f) for f in b.findings]
    assert a.ok() == b.ok() and a.render() == b.render()
    assert [f.check for f in b.errors] == [f.check for f in a.errors]


def test_interleaved_ab_ranks_tenfold_costs():
    """Two variants of known relative cost (1 ms against 10 ms of
    time.sleep): the slower has the larger median and mean, every round
    a slope, and the pair's stats are there; no other timing is held."""
    calls = {"fast": 0, "slow": 0}

    def run(name, s):
        calls[name] += 1
        time.sleep(s)
        return torch.zeros(1)

    res = tprof.interleaved_ab([("fast", run, ("fast", 0.001)),
                                ("slow", run, ("slow", 0.010))],
                               rounds=3, n1=1, n2=3, verbose=False)
    assert res["fast"]["median_s"] < res["slow"]["median_s"]
    assert res["fast"]["mean_s"] < res["slow"]["mean_s"]
    assert len(res["fast"]["slopes"]) == len(res["slow"]["slopes"]) == 3
    assert set(res[("pair", "fast", "slow")]) == {"mean_s", "ci95_s",
                                                  "significant"}
    assert calls == {"fast": 1 + 3 * 5, "slow": 1 + 3 * 5}


def test_profiling_records_match_jax(tmp_path):
    """RenderMetrics records, summaries and JSON lines, and PassTimer's
    summary, as the JAX package's on the same inputs; trace_annotation
    names a torch.profiler range."""
    jm, tm = jprof.RenderMetrics(), tprof.RenderMetrics()
    for m in (jm, tm):
        m.record(0, 0.5, n_trace=2e6, n_shadow=1e6, cache_hits=0.25,
                 reservoir_m_mean=7.0, extra={"k": 1})
        m.record(1, 0.0)
        m.record(2, 0.125, n_trace=3e5)
    assert jm.frames == tm.frames and jm.summary() == tm.summary()
    jm.dump(str(tmp_path / "j.jsonl"))
    tm.dump(str(tmp_path / "t.jsonl"))
    assert (tmp_path / "j.jsonl").read_text() == \
        (tmp_path / "t.jsonl").read_text()
    jt, tt = jprof.PassTimer(), tprof.PassTimer()
    for t in (jt, tt):
        t.times = {"trace": [0.1, 0.3], "shade": [0.2]}
    assert jt.summary() == tt.summary()
    with tt.time("x"):
        pass
    x = torch.ones(3)
    assert tt.fence(x) is x and len(tt.times["x"]) == 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.trace_annotation("tt_region"):
            torch.ones(4).sum()
    assert any(e.key == "tt_region" for e in prof.key_averages())
    assert tprof.marginal_slope(lambda: x + 1, n1=1, n2=2) is not None
