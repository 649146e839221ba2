"""Minimal PLY mesh reader (ascii + binary little/big endian).

Port of `truetrace_tpu/scene/ply_loader.py`, with the same results
(tests/test_torch_sources.py). A binary face element whose every face
has the same corner count is read in one numpy call; any other element
takes the JAX package's per-record loop.

Supports the subset PBRT scene exports use (Shape "plymesh" — the
format San Miguel / Bistro-class pbrt scenes ship geometry in):
vertex properties x/y/z (+ nx/ny/nz, u/v or s/t), face property
`vertex_indices`/`vertex_index` lists (triangles or fans). Returns
(positions [V,3] f32, indices [F,3] i32, normals or None, uvs or None).
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, list]] = []   # (name, count, props)
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated header")
            t = line.decode("ascii", "replace").split()
            if not t or t[0] == "comment":
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                elements.append((t[1], int(t[2]), []))
            elif t[0] == "property":
                if t[1] == "list":
                    elements[-1][2].append((t[4], "list", t[2], t[3]))
                else:
                    elements[-1][2].append((t[2], "scalar", t[1]))
            elif t[0] == "end_header":
                break
        if fmt == "ascii":
            return _read_ascii(f, elements)
        endian = "<" if fmt == "binary_little_endian" else ">"
        return _read_binary(f, elements, endian)


def _assemble(vdata, n_verts, faces):
    pos = np.stack([vdata["x"], vdata["y"], vdata["z"]], -1
                   ).astype(np.float32)
    normals = None
    if all(k in vdata for k in ("nx", "ny", "nz")):
        normals = np.stack([vdata["nx"], vdata["ny"], vdata["nz"]], -1
                           ).astype(np.float32)
    uvs = None
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in vdata and vkey in vdata:
            uvs = np.stack([vdata[ukey], vdata[vkey]], -1
                           ).astype(np.float32)
            break
    if isinstance(faces, np.ndarray):        # [F, n] equal corner counts
        idx = np.stack([np.stack([faces[:, 0], faces[:, i],
                                  faces[:, i + 1]], 1)
                        for i in range(1, faces.shape[1] - 1)], 1
                       ).reshape(-1, 3).astype(np.int32) \
            if faces.shape[1] >= 3 else np.zeros((0, 3), np.int32)
        return pos, idx, normals, uvs
    tris = []
    for fc in faces:
        for i in range(1, len(fc) - 1):     # fan-triangulate polygons
            tris.append((fc[0], fc[i], fc[i + 1]))
    idx = np.asarray(tris, np.int32) if tris \
        else np.zeros((0, 3), np.int32)
    return pos, idx, normals, uvs


def _read_ascii(f, elements):
    vdata = {}
    n_verts = 0
    faces: List[list] = []
    for name, count, props in elements:
        if name == "vertex":
            n_verts = count
            cols = [p[0] for p in props]
            rows = np.loadtxt([f.readline() for _ in range(count)],
                              dtype=np.float64, ndmin=2)
            for i, c in enumerate(cols):
                vdata[c] = rows[:, i]
        elif name == "face":
            for _ in range(count):
                t = f.readline().split()
                n = int(t[0])
                faces.append([int(x) for x in t[1:1 + n]])
        else:
            for _ in range(count):
                f.readline()
    return _assemble(vdata, n_verts, faces)


def _uniform_faces(f, count, props, endian):
    """The face element as an [F, n] int64 array when it holds only the
    vertex-index list and every face has n corners; else None, with the
    file where it was."""
    if (len(props) != 1 or props[0][1] != "list"
            or props[0][0] not in ("vertex_indices", "vertex_index")):
        return None
    cty = np.dtype(endian + _TYPES[props[0][2]])
    ity = np.dtype(endian + _TYPES[props[0][3]])
    start = f.tell()
    head = f.read(cty.itemsize)
    if count == 0 or len(head) < cty.itemsize:
        f.seek(start)
        return None
    n = int(np.frombuffer(head, cty)[0])
    rec = np.dtype([("n", cty), ("i", ity, (n,))])
    f.seek(start)
    raw = f.read(rec.itemsize * count)
    if len(raw) == rec.itemsize * count:
        arr = np.frombuffer(raw, rec)
        if (arr["n"] == n).all():
            return arr["i"].reshape(count, n).astype(np.int64)
    f.seek(start)
    return None


def _read_binary(f, elements, endian):
    vdata = {}
    n_verts = 0
    faces: List[list] = []
    for name, count, props in elements:
        if name == "face" and isinstance(faces, list) and not faces:
            block = _uniform_faces(f, count, props, endian)
            if block is not None:
                faces = block
                continue
        if name == "vertex" and all(p[1] == "scalar" for p in props):
            dt = np.dtype([(p[0], endian + _TYPES[p[2]]) for p in props])
            arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
            n_verts = count
            for p in props:
                vdata[p[0]] = arr[p[0]].astype(np.float64)
        else:
            for _ in range(count):
                vals = {}
                for p in props:
                    if p[1] == "list":
                        cty = _TYPES[p[2]]
                        ity = _TYPES[p[3]]
                        (n,) = struct.unpack(
                            endian + {"i1": "b", "u1": "B", "i2": "h",
                                      "u2": "H", "i4": "i",
                                      "u4": "I"}[cty],
                            f.read(int(cty[1])))
                        raw = f.read(int(ity[1]) * n)
                        items = np.frombuffer(raw, dtype=endian + ity)
                        vals[p[0]] = items
                    else:
                        ty = _TYPES[p[2]]
                        raw = f.read(int(ty[1]))
                        vals[p[0]] = np.frombuffer(
                            raw, dtype=endian + ty)[0]
                if name == "face":
                    key = ("vertex_indices" if "vertex_indices" in vals
                           else "vertex_index")
                    faces.append([int(x) for x in vals[key]])
                elif name == "vertex":
                    for k, v in vals.items():
                        vdata.setdefault(k, []).append(float(v))
    if n_verts == 0 and vdata:
        vdata = {k: np.asarray(v) for k, v in vdata.items()}
        n_verts = len(next(iter(vdata.values())))
    return _assemble(vdata, n_verts, faces)
