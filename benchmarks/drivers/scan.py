"""``kind: scan``: the calls `smvsrecon` (`smvs_tpu_torch.cli.main`) makes
for a group of views of an MVE scene, in scan order.

For each view `cli.reconstruct_sgm` (SGM of its first two neighbors,
averaged), then `optimize_view_batch` for a group of two or more,
`optimize_view` for one. The input scale, the 8-bit working images,
neighbor selection and grouping are worked out once in set-up, as the
command line does once a run. The groups are the command line's, taken in
its order from the one that holds the configuration's ``first_view``,
wrapping round; every run starts there.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from benchmarks import drivers, scenes
from benchmarks.drivers import Spans, synchronize
from benchmarks.reference import scan as ref_scan
from benchmarks.reference.opt.pipeline.views import make_view as ref_view
from smvs_tpu_torch import cli
from smvs_tpu_torch.core import scene as sc
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline import view_selection as vs
from smvs_tpu_torch.pipeline.views import make_view


class Driver(drivers.Driver):
    def render(self) -> None:
        self.scan = scenes.grid_scan(self.config["scene"], self.device)
        synchronize(self.device)

    def prepare(self) -> None:
        """The command line's once-a-run work: input scale, 8-bit working
        images (`iops.rescale_half_size_gaussian` on the device), the
        bundle, neighbor selection, the shared canvas and the groups."""
        opts = self.opts
        width, height = self.scan["size"]
        n = len(self.scan["cameras"])
        self.scale = opts["scale"] if opts["scale"] >= 0 else \
            ref_scan.input_scale(width, height, opts["max_pixels"])
        self.cams = [drivers.program_camera(c) for c in self.scan["cameras"]]
        self.working = []
        for i in range(n):
            photo = self.scan["photos"][i]
            if self.scale == 0:
                self.working.append(photo.cpu().numpy())
                continue
            x = photo.to(torch.float32) / 255.0
            for _ in range(self.scale):
                x = iops.rescale_half_size_gaussian(x)
            self.working.append(np.clip(x.cpu().numpy() * 255, 0, 255)
                                .astype(np.uint8))
        feats = [sc.Feature3D(pos=p, color=np.array([128, 128, 128]),
                              refs=list(range(n)))
                 for p in self.scan["features"]]
        self.bundle = sc.Bundle(cameras=list(self.cams), features=feats)
        sizes = [(width, height)] * n
        self.neighbors = {}
        for i in range(n):
            nbrs = vs.get_neighbors_for_view(
                self.cams, sizes, self.bundle, i,
                vs.ViewSelectionOptions(num_neighbors=opts["neighbors"]))
            if len(nbrs) >= opts["min_neighbors"]:
                self.neighbors[i] = nbrs
        self.dims = self.working[0].shape
        q = max(1, opts["pad_bucket"])
        self.canvas = (-(-self.dims[0] // q) * q, -(-self.dims[1] // q) * q)
        buckets = {}
        for i in self.neighbors:
            buckets.setdefault((*self.canvas, len(self.neighbors[i])),
                               []).append(i)
        groups = [g for key, ids in buckets.items()
                  for g in VB.group_views(ids, key,
                                          self.traffic["batch_views"],
                                          cli.BATCH_MP)]
        first = next(j for j, g in enumerate(groups)
                     if self.config["first_view"] in g)
        self.requests = groups[first:] + groups[:first]
        self.mp = width * height / 1e6
        self.conf = types.SimpleNamespace(sgm_scale=opts["sgm_scale"],
                                          debug_lvl=0)

    def padded_image(self, i: int):
        """`cli.main`'s ``padded_image``: the working image over 255 on the
        shared canvas (edge padded) and the adjusted camera."""
        img = np.asarray(self.working[i], np.float64)
        if img.max() > 1.5:
            img = img / 255.0
        img = img.astype(np.float32)
        cam = self.cams[i]
        h, w = img.shape
        ph, pw = self.canvas
        if (ph, pw) != (h, w):
            img = np.pad(img, [(0, ph - h), (0, pw - w)], mode="edge")
            cam = cam.resized_canvas(w, h, pw, ph)
        return img, cam

    def stereo_view(self, i: int):
        img, cam = self.padded_image(i)
        return make_view(cam, img, view_id=i, device=self.device)

    def run(self, group: list, spans: Spans) -> list:
        dev = self.device
        mains = [self.stereo_view(i) for i in group]
        subs_list = [[self.stereo_view(n) for n in self.neighbors[i]]
                     for i in group]
        sgm_maps, inits = [], []
        for i in group:
            t0 = time.perf_counter()
            d = cli.reconstruct_sgm(self.conf, i, self.neighbors[i],
                                    self.padded_image, self.bundle, None, dev)
            spans.add("sgm", time.perf_counter() - t0)
            self.sgm_pairs += [(*self._sgm_dims(), self.opts["sgm_planes"])
                               ] * min(2, len(self.neighbors[i]))
            sgm_maps.append(d)
            inits.append(ref_scan.sgm_init(d, self.dims, self.canvas,
                                           self.opts["sgm_scale"]))
        t0 = time.perf_counter()
        results = drivers.optimize(mains, subs_list, inits,
                                   drivers.optimizer_options(self.opts), dev)
        oh, ow = self.dims
        out = [{"view": i, "group": tuple(group), "mp": self.mp,
                "sgm": torch.as_tensor(s), "depth": r.depth[:oh, :ow].cpu()}
               for i, s, r in zip(group, sgm_maps, results)]
        spans.add("opt", time.perf_counter() - t0)
        return out

    def _sgm_dims(self) -> tuple:
        """The SGM's (height, width) of a view's own pixels (no pad)."""
        h, w = self.dims
        for _ in range(self.opts["sgm_scale"]):
            h, w = (h + 1) // 2, (w + 1) // 2
        return h, w

    def reference_sgm(self, i: int, dtype=torch.float32) -> torch.Tensor:
        return ref_scan.sgm_view(self.scan, self.opts, i, dtype=dtype)

    def reference_depths(self, group, sgm_maps, tf32: bool = False) -> list:
        """The reference's final depth maps of a group, from its own
        working images, canvas, neighbors and the given SGM maps."""
        opts, dev, scan = self.opts, self.device, self.scan
        width, height = scan["size"]
        scale = opts["scale"] if opts["scale"] >= 0 else \
            ref_scan.input_scale(width, height, opts["max_pixels"])
        dims = ref_scan.working_dims(width, height, scale)
        canvas = ref_scan.padded_dims(*dims, opts["pad_bucket"])
        sizes = [(width, height)] * len(scan["cameras"])

        def view(i):
            img, cam = ref_scan.padded(
                ref_scan.working_image(scan["photos"][i], scale),
                scan["cameras"][i], canvas)
            return ref_view(cam, img, view_id=i, device=dev)

        mains = [view(i) for i in group]
        subs_list = [[view(n) for n in ref_scan.neighbors(
            scan["cameras"], sizes, scan["features"], i,
            opts["neighbors"])] for i in group]
        inits = [ref_scan.sgm_init(d, dims, canvas, opts["sgm_scale"])
                 for d in sgm_maps]
        oh, ow = dims
        return [d[:oh, :ow].cpu() for d in drivers.reference_optimize(
            mains, subs_list, inits, opts, dev, tf32)]

    def truth(self, i: int, tf32: bool = False) -> torch.Tensor:
        width, height = self.scan["size"]
        oh, ow = ref_scan.working_dims(width, height, self.scale)
        return scenes.plane_depth(self.config["scene"],
                                  self.scan["cameras"][i], ow, oh,
                                  self.device, tf32=tf32)
