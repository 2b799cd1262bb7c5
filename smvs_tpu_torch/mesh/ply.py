"""PLY point-cloud / mesh IO, binary little-endian (numpy; port of
`smvs_tpu/mesh/ply.py`, which writes the same bytes).

Output-compatible with the point sets the reference saves via MVE
(`app/smvsrecon.cc:278-343` -> ``smvs-B.ply`` / ``smvs-S.ply``): vertices
with normals, per-vertex scale ("value") and confidence, optional colors,
optional faces.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointSet:
    vertices: np.ndarray  # [N, 3] float32
    normals: np.ndarray | None = None  # [N, 3]
    colors: np.ndarray | None = None  # [N, 3] uint8
    values: np.ndarray | None = None  # [N] scale
    confidences: np.ndarray | None = None  # [N]
    faces: np.ndarray | None = None  # [F, 3] int32


def save_ply(path: str, ps: PointSet) -> None:
    n = len(ps.vertices)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [np.asarray(ps.vertices, np.float32)]
    if ps.normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols.append(np.asarray(ps.normals, np.float32))
    if ps.colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append(np.asarray(ps.colors, np.uint8))
    if ps.values is not None:
        props += [("value", "f4")]
        cols.append(np.asarray(ps.values, np.float32).reshape(n, 1))
    if ps.confidences is not None:
        props += [("confidence", "f4")]
        cols.append(np.asarray(ps.confidences, np.float32).reshape(n, 1))

    dtype = np.dtype([(name, t) for name, t in props])
    rec = np.zeros(n, dtype=dtype)
    i = 0
    for c in cols:
        for k in range(c.shape[1] if c.ndim == 2 else 1):
            rec[dtype.names[i]] = c[:, k] if c.ndim == 2 else c
            i += 1

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    _PLY_TYPES = {"f4": "float", "u1": "uchar"}
    for name, t in props:
        header.append(f"property {_PLY_TYPES[t]} {name}")
    if ps.faces is not None:
        header.append(f"element face {len(ps.faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
        if ps.faces is not None:
            faces = np.asarray(ps.faces, np.int32)
            fr = np.zeros(len(faces),
                          dtype=np.dtype([("n", "u1"), ("v", "i4", (3,))]))
            fr["n"] = 3
            fr["v"] = faces
            f.write(fr.tobytes())


def load_ply(path: str) -> PointSet:
    """Minimal reader for the PLY files save_ply writes (tests/tools)."""
    with open(path, "rb") as f:
        props = []
        n_verts = n_faces = 0
        elem = None
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
                elem = "vertex"
            elif line.startswith("element face"):
                n_faces = int(line.split()[-1])
                elem = "face"
            elif line.startswith("property") and elem == "vertex":
                _, t, name = line.split()
                props.append((name, {"float": "f4", "uchar": "u1"}[t]))
            elif line == "end_header":
                break
        dtype = np.dtype(props)
        rec = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype)
        faces = None
        if n_faces:
            fdt = np.dtype([("n", "u1"), ("v", "i4", (3,))])
            faces = np.frombuffer(f.read(n_faces * fdt.itemsize),
                                  dtype=fdt)["v"]

    def grab(names):
        if all(nm in rec.dtype.names for nm in names):
            return np.stack([rec[nm] for nm in names], axis=-1)
        return None

    return PointSet(
        vertices=grab(["x", "y", "z"]),
        normals=grab(["nx", "ny", "nz"]),
        colors=grab(["red", "green", "blue"]),
        values=rec["value"] if "value" in rec.dtype.names else None,
        confidences=(rec["confidence"]
                     if "confidence" in rec.dtype.names else None),
        faces=faces,
    )
