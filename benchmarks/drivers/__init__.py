"""What a request does, for each kind of configuration.

A configuration names its driver by ``kind``: the module
``drivers/<kind>.py``, whose class ``Driver`` (a subclass of `Driver`
below) renders the configuration's inputs (`scenes`), prepares what
`smvsrecon` prepares once per run, runs one request through the port's
entry points, and gives the plain reference's answers for the check. A
new kind is a new file; `load` finds it by name.

A request is a group of views (`pipeline.batch.group_views` with the
traffic's ``batch_views``); it returns one record per view: ``view``,
``group`` (the request's views), ``mp`` (input megapixels), ``sgm`` (the
SGM depth map, host) and ``depth`` (the final depth map, host). Spans:
"sgm" and "opt", each ending in a synchronize or a copy to the host. Every
SGM call appends its algorithm's (height, width, planes) to ``sgm_pairs``,
read by the kernel roofline.

`Driver.check` compares, after the window, the latest answer of groups
drawn from the run's seed with the plain reference worked out again from
the same inputs (`check` says what each number is).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os

import torch

from benchmarks import check
from benchmarks.reference.opt import device as ref_policy
from benchmarks.reference.opt.pipeline import batch as RB
from benchmarks.reference.opt.pipeline import optimizer as RO
from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline import optimizer as O

# The gap quantiles that `control.py` reads beside the one compared.
GAP_READINGS = (0.5, 0.9, 0.99, 0.999, 1.0)


HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, root: str = HERE) -> type:
    """The ``Driver`` class of ``<root>/<kind>.py`` (this folder's, or a
    folder of another tree's)."""
    if root == HERE:
        return importlib.import_module(f"benchmarks.drivers.{kind}").Driver
    spec = importlib.util.spec_from_file_location(
        f"benchmarks.drivers.{kind}", os.path.join(root, kind + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Driver


def program_camera(cam) -> Camera:
    """The program's camera for one of the benchmark's."""
    return Camera(flen=cam.flen, rot=cam.rot.copy(), trans=cam.trans.copy(),
                  ppoint=tuple(cam.ppoint), paspect=cam.paspect)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Seconds by span name (host clock)."""

    def __init__(self):
        self.seconds = {}

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


def optimizer_options(opts: dict, module=O):
    """`smvsrecon`'s optimizer options for its flags (base mode), as
    ``module.OptimizerOptions`` (the program's, or the reference's)."""
    return module.OptimizerOptions(
        regularization=0.01 * opts["alpha"], light_surf_regularization=0.0,
        num_iterations=5, min_scale=opts["output_scale"],
        use_shading=opts["shading"], use_sgm=True,
        full_optimization=False, debug_lvl=0)


def optimize(mains, subs_list, sgm_depths, opts, device) -> list:
    """The command line's optimize step for a group."""
    if len(mains) >= 2:
        return VB.optimize_view_batch(mains, subs_list, opts,
                                      sgm_depths=sgm_depths, device=device)
    return [O.optimize_view(mains[0], subs_list[0], opts, sgm_depths[0],
                            device=device)]


def reference_optimize(mains, subs_list, sgm_depths, opts: dict, device,
                       tf32: bool = False) -> list:
    """The plain reference's optimize step for a group (the same split into
    batched and single), float32 as configured, or with TF32 products for
    the control. Returns the depth maps."""
    ropts = optimizer_options(opts, RO)
    with tf32_on(ref_policy) if tf32 else contextlib.nullcontext():
        if len(mains) >= 2:
            res = RB.optimize_view_batch(mains, subs_list, ropts,
                                         sgm_depths=sgm_depths, device=device)
        else:
            res = [RO.optimize_view(mains[0], subs_list[0], ropts,
                                    sgm_depths[0], device=device)]
    return [r.depth for r in res]


@contextlib.contextmanager
def tf32_on(policy):
    """A device policy module (the program's `smvs_tpu_torch.device` or the
    reference's copy) turned to TF32 for matrix products and cuDNN
    convolutions while the block runs."""
    def allow():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    keep = policy.set_cuda_precision
    policy.set_cuda_precision = allow
    allow()
    try:
        yield
    finally:
        policy.set_cuda_precision = keep
        keep()


class Driver:
    """What every kind shares: the check. A kind's ``Driver`` gives
    `render`, `prepare` (``requests``), `run`, and the reference's answers:
    `reference_sgm`, `reference_depths` and `truth`."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.opts = config["smvsrecon"]
        self.sgm_pairs = []

    def check(self, outputs: list, rng, control: bool = False) -> dict:
        """The numbers compared (`check`) for the window's ``outputs``;
        ``control`` puts the plain reference in the program's place, one
        precision lower (its float SGM work in bfloat16, its optimizer and
        the true depth with TF32 products)."""
        chk = self.config["check"]
        latest, groups = {}, []
        for o in outputs:
            latest[o["view"]] = o
            if o["group"] not in groups:
                groups.append(o["group"])
        sample, views = [], 0
        for j in (rng.permutation(len(groups)) if groups else []):
            if views >= chk["views"]:
                break
            sample.append(groups[int(j)])
            views += len(groups[int(j)])
        mismatch = [] if sample else [1.0]
        gaps = [] if sample else [None]
        for group in sample:
            refs = [self.reference_sgm(v) for v in group]
            for v, ref in zip(group, refs):
                prog = self.reference_sgm(v, torch.bfloat16) if control \
                    else latest[v]["sgm"]
                mismatch.append(check.sgm_mismatch(prog, ref,
                                                   chk["sgm_rtol"]))
            want = self.reference_depths(group, refs)
            got = self.reference_depths(group, refs, tf32=True) if control \
                else [latest[v]["depth"] for v in group]
            gaps += [check.rel_gaps(g, w) for g, w in zip(got, want)]
            del refs, want, got
        errs = [check.depth_err(self.truth(v, tf32=True) if control
                                else latest[v]["depth"], self.truth(v),
                                chk["err_quantile"])
                for v in sorted(latest)] or [1.0]
        return {"sgm_mismatch": max(mismatch),
                "opt_gap": max(check.gap(g, chk["gap_quantile"])
                               for g in gaps),
                "depth_err": max(errs),
                "opt_gap_at": {str(q): max(check.gap(g, q) for g in gaps)
                               for q in GAP_READINGS},
                "sgm_checked": len(mismatch) if sample else 0,
                "views_checked": len(latest)}
