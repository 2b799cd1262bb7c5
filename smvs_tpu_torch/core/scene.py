"""MVE scene container IO (numpy, host side; port of
`smvs_tpu/core/scene.py`).

The reference consumes MVE scenes: a ``views/`` directory of per-view
containers plus a ``synth_0.out`` SfM bundle (`app/smvsrecon.cc:399-421`),
and checkpoints every stage as named image *embeddings* inside the view
containers (``smvs-sgm``, ``smvs-B2``, ``smvs-B2N``;
`lib/stereo_view.h:108-130`, `app/smvsrecon.cc:503-515`).

- directory-format views (``view_NNNN.mve/`` with ``meta.ini`` and one
  file per embedding), and MVE's legacy single-file ``.mve`` container,
  read-only (``Scene.save`` upgrades it to the directory layout);
- ``.mvei`` raw image embeddings (signature ``\\x89MVE_IMAGE\\n``, int32
  width/height/channels/type, raw data), and uint8 embeddings as PNG;
- Bundler v0.3 text bundles (what MVE's ``synth_0.out`` derives from).

Files are byte-compatible with the JAX package's in both directions.
Per-view, per-stage embeddings make checkpoint/resume free: a rerun skips
views whose outputs already exist (`app/smvsrecon.cc:544-555`).
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import Optional

import numpy as np

from smvs_tpu_torch.core.camera import Camera

MVEI_SIGNATURE = b"\x89MVE_IMAGE\n"
LEGACY_MVE_SIGNATURE = b"\x89MVE\n"

# mve::ImageType enum (image_base.h)
_TYPE_TO_DTYPE = {
    1: np.uint8, 2: np.uint16, 3: np.uint32, 4: np.uint64,
    5: np.int8, 6: np.int16, 7: np.int32, 8: np.int64,
    9: np.float32, 10: np.float64,
}
_DTYPE_TO_TYPE = {np.dtype(v): k for k, v in _TYPE_TO_DTYPE.items()}


def save_mvei(path: str, image: np.ndarray) -> None:
    """Write an MVE raw image embedding (.mvei)."""
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    code = _DTYPE_TO_TYPE[np.dtype(image.dtype)]
    with open(path, "wb") as f:
        f.write(MVEI_SIGNATURE)
        f.write(struct.pack("<iiii", w, h, c, code))
        f.write(np.ascontiguousarray(image).tobytes())


def load_mvei(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        sig = f.read(len(MVEI_SIGNATURE))
        if sig != MVEI_SIGNATURE:
            raise ValueError(f"{path}: not an MVEI file")
        w, h, c, code = struct.unpack("<iiii", f.read(16))
        data = np.frombuffer(f.read(), dtype=_TYPE_TO_DTYPE[code])
    img = data.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


@dataclasses.dataclass
class View:
    """One MVE view: camera + named embeddings, lazily loaded."""

    view_id: int
    name: str
    camera: Optional[Camera]
    path: Optional[str] = None  # directory on disk (None = in-memory)
    _cache: dict = dataclasses.field(default_factory=dict)
    _dirty: dict = dataclasses.field(default_factory=dict)

    def embedding_names(self) -> list[str]:
        names = set(self._cache) | set(self._dirty)
        if self.path and os.path.isdir(self.path):
            for fname in os.listdir(self.path):
                stem, ext = os.path.splitext(fname)
                if ext.lower() in (".mvei", ".png", ".jpg", ".jpeg", ".tiff"):
                    names.add(stem)
        return sorted(names)

    def has_embedding(self, name: str) -> bool:
        return name in self.embedding_names()

    def get_image(self, name: str) -> np.ndarray:
        if name in self._cache:
            return self._cache[name]
        if self.path is None:
            raise KeyError(name)
        for ext in (".mvei", ".png", ".jpg", ".jpeg", ".tiff"):
            p = os.path.join(self.path, name + ext)
            if os.path.exists(p):
                if ext == ".mvei":
                    img = load_mvei(p)
                else:
                    from PIL import Image

                    img = np.asarray(Image.open(p))
                self._cache[name] = img
                return img
        raise KeyError(f"view {self.view_id}: no embedding '{name}'")

    def set_image(self, name: str, image: np.ndarray) -> None:
        self._cache[name] = image
        self._dirty[name] = True

    def remove_embedding(self, name: str) -> None:
        self._cache.pop(name, None)
        self._dirty.pop(name, None)
        if self.path:
            for ext in (".mvei", ".png", ".jpg", ".jpeg", ".tiff"):
                p = os.path.join(self.path, name + ext)
                if os.path.exists(p):
                    os.remove(p)

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError(f"view {self.view_id} has no path to save to")
        if os.path.isfile(path):
            # Legacy single-file container occupying the directory name:
            # upgrade in place, keeping the original as .orig
            # (sceneupgrade-style conversion).
            os.replace(path, path + ".orig")
            self._dirty = dict.fromkeys(self._cache, True)
        os.makedirs(path, exist_ok=True)
        self.path = path
        self._write_meta()
        for name, img in self._cache.items():
            if not self._dirty.get(name):
                continue
            img = np.asarray(img)
            if img.dtype == np.uint8:
                from PIL import Image

                Image.fromarray(img).save(os.path.join(path, name + ".png"))
            else:
                save_mvei(os.path.join(path, name + ".mvei"), img)
        self._dirty.clear()

    def _write_meta(self) -> None:
        cam = self.camera
        lines = [
            "# MVE view meta data is stored in INI-file syntax.",
            "# This file is generated, formatting will get lost.",
            "",
            "[camera]",
        ]
        if cam is not None:
            rot = " ".join(repr(float(v)) for v in cam.rot.reshape(-1))
            trans = " ".join(repr(float(v)) for v in cam.trans)
            lines += [
                f"focal_length = {float(cam.flen)!r}",
                f"pixel_aspect = {float(cam.paspect)!r}",
                f"principal_point = {float(cam.ppoint[0])!r} {float(cam.ppoint[1])!r}",
                f"rotation = {rot}",
                f"translation = {trans}",
            ]
        else:
            lines += ["focal_length = 0"]
        lines += ["", "[view]", f"id = {self.view_id}", f"name = {self.name}", ""]
        with open(os.path.join(self.path, "meta.ini"), "w") as f:
            f.write("\n".join(lines))

    @staticmethod
    def load_legacy(path: str) -> "View":
        """Read a legacy single-file ``.mve`` view container (MVE's
        pre-2014 layout: signature ``\\x89MVE\\n``, ASCII header lines
        ``id``/``name``/``camera-ext``/``camera-int``/``embedding`` ended
        by ``end_headers``, then the raw little-endian payloads in order).

        The file is loaded eagerly; the view keeps the container path, and
        ``save()`` upgrades it in place to the directory layout, keeping
        the original as ``<path>.orig``.
        """
        with open(path, "rb") as f:
            blob = f.read()
        if not blob.startswith(LEGACY_MVE_SIGNATURE):
            raise ValueError(f"{path}: not a legacy .mve view container")
        head_end = blob.index(b"end_headers\n")
        header = blob[len(LEGACY_MVE_SIGNATURE):head_end].decode("ascii")
        payload = blob[head_end + len(b"end_headers\n"):]

        view_id, name = -1, ""
        flen, paspect, ppoint = 0.0, 1.0, (0.5, 0.5)
        rot = np.eye(3)
        trans = np.zeros(3)
        embeddings = []  # (name, w, h, c, dtype)
        for line in header.splitlines():
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "id":
                view_id = int(tok[1])
            elif tok[0] == "name":
                name = line.split(None, 1)[1] if len(tok) > 1 else ""
            elif tok[0] == "camera-ext":
                v = np.fromiter(map(float, tok[1:13]), np.float64)
                rot = v[:9].reshape(3, 3)
                trans = v[9:12]
            elif tok[0] == "camera-int":
                flen = float(tok[1])
                if len(tok) > 2:
                    paspect = float(tok[2])
                if len(tok) > 4:
                    ppoint = (float(tok[3]), float(tok[4]))
            elif tok[0] == "embedding":
                w, h, c, code = map(int, tok[2:6])
                embeddings.append((tok[1], w, h, c,
                                   np.dtype(_TYPE_TO_DTYPE[code])))
            else:
                raise ValueError(f"{path}: unknown legacy header {tok[0]!r}")

        camera = None
        if flen > 0:
            camera = Camera(flen=flen, rot=rot, trans=trans,
                            ppoint=ppoint, paspect=paspect)
        view = View(view_id=view_id, name=name, camera=camera, path=path)
        off = 0
        for ename, w, h, c, dt in embeddings:
            n = w * h * c * dt.itemsize
            if off + n > len(payload):
                raise ValueError(
                    f"{path}: truncated payload for embedding {ename!r}")
            img = np.frombuffer(payload[off:off + n], dtype=dt).reshape(
                h, w, c)
            view.set_image(ename, img[..., 0] if c == 1 else img)
            off += n
        return view

    @staticmethod
    def load(path: str) -> "View":
        meta = os.path.join(path, "meta.ini")
        section = None
        vals: dict[str, str] = {}
        with open(meta) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                m = re.match(r"\[(\w+)\]", line)
                if m:
                    section = m.group(1)
                    continue
                if "=" in line:
                    k, v = line.split("=", 1)
                    vals[f"{section}.{k.strip()}"] = v.strip()
        flen = float(vals.get("camera.focal_length", 0))
        camera = None
        if flen > 0:
            rot = np.fromiter(map(float, vals["camera.rotation"].split()),
                              dtype=np.float64)
            trans = np.fromiter(map(float, vals["camera.translation"].split()),
                                dtype=np.float64)
            pp = vals.get("camera.principal_point", "0.5 0.5").split()
            camera = Camera(
                flen=flen, rot=rot.reshape(3, 3), trans=trans,
                ppoint=(float(pp[0]), float(pp[1])),
                paspect=float(vals.get("camera.pixel_aspect", 1.0)),
            )
        return View(
            view_id=int(vals.get("view.id", -1)),
            name=vals.get("view.name", ""),
            camera=camera,
            path=path,
        )


# ---------------------------------------------------------------------------
# bundle (SfM features)


@dataclasses.dataclass
class Feature3D:
    pos: np.ndarray  # [3]
    color: np.ndarray  # [3]
    refs: list[int]  # view ids observing the feature


@dataclasses.dataclass
class Bundle:
    cameras: list[Optional[Camera]]
    features: list[Feature3D]

    def feature_depths_for_view(self, view_id: int, camera: Camera,
                                width: int, height: int) -> np.ndarray:
        """Z-depths of this view's features that project inside the image

        (reference `lib/sgm_stereo.cc:669-720`, `lib/surface.cc:91-130`).
        """
        out = []
        for feat in self.features:
            if view_id not in feat.refs:
                continue
            p = camera.world_to_cam(feat.pos[None])[0]
            if p[2] <= 0:
                continue
            uv = camera.project(p[None], width, height)[0]
            if 0 <= np.floor(uv[0]) < width and 0 <= np.floor(uv[1]) < height:
                out.append(p[2])
        return np.asarray(out)

    def splat_depth_map(self, view_id: int, camera: Camera, width: int,
                        height: int) -> np.ndarray:
        """Sparse z-depth image from feature projections

        (reference `Surface::initialize_depth_from_bundle`,
        `lib/surface.cc:91-130`).
        """
        depth = np.zeros((height, width), np.float32)
        for feat in self.features:
            if view_id not in feat.refs:
                continue
            p = camera.world_to_cam(feat.pos[None])[0]
            if p[2] == 0:
                continue
            uv = camera.project(p[None], width, height)[0]
            x, y = int(np.floor(uv[0])), int(np.floor(uv[1]))
            if 0 <= x < width and 0 <= y < height:
                depth[y, x] = p[2]
        return depth


def load_bundle(path: str) -> Bundle:
    """Read a Bundler v0.3 bundle (the format behind MVE's synth_0.out)."""
    with open(path) as f:
        toks = f.read().split()
    i = 0
    # skip comment lines already removed by split (comment starts with '#'
    # only on line 1 of bundler files) — handle the '#' header words:
    while toks[i].startswith("#") or not _is_number(toks[i]):
        i += 1
    n_cam = int(toks[i]); n_pts = int(toks[i + 1]); i += 2
    cameras: list[Optional[Camera]] = []
    for _ in range(n_cam):
        f_ = float(toks[i]); i += 3  # skip k1 k2
        rot = np.asarray(toks[i : i + 9], np.float64).reshape(3, 3); i += 9
        trans = np.asarray(toks[i : i + 3], np.float64); i += 3
        cameras.append(Camera(flen=f_, rot=rot, trans=trans)
                       if f_ > 0 else None)
    feats = []
    for _ in range(n_pts):
        pos = np.asarray(toks[i : i + 3], np.float64); i += 3
        color = np.asarray(toks[i : i + 3], np.float64); i += 3
        n_refs = int(toks[i]); i += 1
        refs = []
        for _ in range(n_refs):
            refs.append(int(toks[i])); i += 4  # view, key, x, y
        feats.append(Feature3D(pos=pos, color=color, refs=refs))
    return Bundle(cameras=cameras, features=feats)


def save_bundle(path: str, bundle: Bundle) -> None:
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(bundle.cameras)} {len(bundle.features)}\n")
        for cam in bundle.cameras:
            if cam is None:
                f.write("0 0 0\n0 0 0\n0 0 0\n0 0 0\n0 0 0\n")
                continue
            f.write(f"{float(cam.flen)!r} 0 0\n")
            for row in cam.rot:
                f.write(" ".join(repr(float(v)) for v in row) + "\n")
            f.write(" ".join(repr(float(v)) for v in cam.trans) + "\n")
        for feat in bundle.features:
            f.write(" ".join(repr(float(v)) for v in feat.pos) + "\n")
            f.write(" ".join(str(int(v)) for v in feat.color) + "\n")
            f.write(str(len(feat.refs)))
            for r in feat.refs:
                f.write(f" {r} 0 0 0")
            f.write("\n")


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# scene


@dataclasses.dataclass
class Scene:
    path: Optional[str]
    views: list[View]
    bundle: Optional[Bundle]

    @staticmethod
    def load(path: str) -> "Scene":
        views_dir = os.path.join(path, "views")
        views = []
        if os.path.isdir(views_dir):
            for entry in sorted(os.listdir(views_dir)):
                vdir = os.path.join(views_dir, entry)
                if os.path.isdir(vdir) and os.path.exists(
                        os.path.join(vdir, "meta.ini")):
                    views.append(View.load(vdir))
                elif os.path.isfile(vdir) and entry.endswith(".mve"):
                    # MVE's legacy single-file view container (pre-2014
                    # layout; modern MVE writes view directories and
                    # ships `sceneupgrade` to convert). Loaded read-only
                    # into an in-memory view; Scene.save upgrades it to
                    # the directory layout.
                    views.append(View.load_legacy(vdir))
        bundle = None
        bpath = os.path.join(path, "synth_0.out")
        if os.path.exists(bpath):
            bundle = load_bundle(bpath)
        return Scene(path=path, views=views, bundle=bundle)

    def save(self) -> None:
        if not self.path:
            raise ValueError("the scene has no path to save to")
        views_dir = os.path.join(self.path, "views")
        os.makedirs(views_dir, exist_ok=True)
        for v in self.views:
            vdir = v.path or os.path.join(views_dir, f"view_{v.view_id:04d}.mve")
            v.save(vdir)
        if self.bundle is not None:
            save_bundle(os.path.join(self.path, "synth_0.out"), self.bundle)

    def clean_embeddings(self, prefix: str = "smvs") -> None:
        """Remove all smvs outputs (reference --clean, `app/smvsrecon.cc:454-474`)."""
        for v in self.views:
            for name in list(v.embedding_names()):
                if name.startswith(prefix):
                    v.remove_embedding(name)
