"""``kind: pair``: the port's main path, `bench_main.run_once`'s calls.

One view against one neighbor: `sgm.stereo.reconstruct_auto`, then
`pipeline.optimizer.optimize_view` (`pipeline.batch.optimize_view_batch`
for a group of two or more). A pool of distinct pairs (their textures
differ) is cycled in an order drawn from the run's seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks import drivers, scenes
from benchmarks.drivers import Spans, synchronize
from benchmarks.reference import sgm_plain
from benchmarks.reference.opt.pipeline.views import make_view as ref_view
from smvs_tpu_torch import cli
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.sgm import stereo as sgm


class Driver(drivers.Driver):
    def render(self) -> None:
        self.pairs = scenes.two_view_pairs(self.config["scene"], self.device)
        self.cams = [tuple(drivers.program_camera(c) for c in p["cameras"])
                     for p in self.pairs]
        synchronize(self.device)

    def prepare(self) -> None:
        dim = int(self.config["scene"]["dim"])
        ids = [int(k) for k in
               np.random.default_rng(self.seed).permutation(len(self.pairs))]
        self.requests = VB.group_views(ids, (dim, dim, 1),
                                       self.traffic["batch_views"],
                                       cli.BATCH_MP)
        self.mp = dim * dim / 1e6

    def run(self, group: list, spans: Spans) -> list:
        dev, rng = self.device, tuple(self.opts["sgm_range"])
        sopts = sgm.SGMOptions(num_steps=self.opts["sgm_planes"])
        mains, subs, depths = [], [], []
        for k in group:
            cam0, cam1 = self.cams[k]
            img0, img1 = self.pairs[k]["images"]
            main = make_view(cam1, img1, view_id=1, device=dev)
            sub = make_view(cam0, img0, view_id=0, device=dev)
            t0 = time.perf_counter()
            d = sgm.reconstruct_auto(cam1, cam0, main.image * 255.0,
                                     sub.image * 255.0, range_main=rng,
                                     range_nbr=rng, opts=sopts, device=dev)
            synchronize(dev)
            spans.add("sgm", time.perf_counter() - t0)
            self.sgm_pairs.append((img1.shape[0], img1.shape[1],
                                   sopts.num_steps))
            mains.append(main)
            subs.append([sub])
            depths.append(d)
        t0 = time.perf_counter()
        results = drivers.optimize(mains, subs, depths,
                                   drivers.optimizer_options(self.opts), dev)
        out = [{"view": k, "group": tuple(group), "mp": self.mp,
                "sgm": d.cpu(), "depth": r.depth.cpu()}
               for k, d, r in zip(group, depths, results)]
        spans.add("opt", time.perf_counter() - t0)
        return out

    def reference_sgm(self, k: int, dtype=torch.float32) -> torch.Tensor:
        cam0, cam1 = self.pairs[k]["cameras"]
        img0, img1 = self.pairs[k]["images"]
        rng = tuple(self.opts["sgm_range"])
        return sgm_plain.sgm_depth(cam1, [cam0], img1 * 255.0, [img0 * 255.0],
                                   rng, [rng],
                                   num_steps=self.opts["sgm_planes"],
                                   dtype=dtype)

    def reference_depths(self, group, sgm_maps, tf32: bool = False) -> list:
        dev = self.device
        mains, subs = [], []
        for k in group:
            cam0, cam1 = self.pairs[k]["cameras"]
            img0, img1 = self.pairs[k]["images"]
            mains.append(ref_view(cam1, img1, view_id=1, device=dev))
            subs.append([ref_view(cam0, img0, view_id=0, device=dev)])
        return [d.cpu() for d in drivers.reference_optimize(
            mains, subs, sgm_maps, self.opts, dev, tf32)]

    def truth(self, k: int, tf32: bool = False) -> torch.Tensor:
        # Every pair shares the plane and the main view's camera.
        return scenes.two_view_depth(self.config["scene"], self.device,
                                     tf32=tf32)
