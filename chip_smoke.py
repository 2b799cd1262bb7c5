"""On-card smoke check of the PyTorch/CUDA port (smvs_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit;
2. build the SGM aggregation kernels from `smvs_tpu_torch/csrc/sgm_agg.cu`;
3. kernel rows 1-2 against their plain PyTorch versions at the rectified
   path's shapes: `aggregate_batch` on a seeded [2, 1440, 1696, 128] int16
   volume (with the INVALID column band of the padded main problem; 2 + 2
   launches), `fused_pass_batch` (1 launch for shifts (0,)) and
   `fused_pass`; bit-equal or fail, on the first run and on every timed
   repetition; CUDA-event times. Beside them, each of `aggregate_batch`'s
   four launches timed on its own (horizontal write and add, the two
   vertical sweeps), and one in-place straight sweep at its horizontal
   launch through `sgm_line_kernel` and through `sgm_path_kernel` (the
   same ring design walking a chain), in turns, both bit-equal to plain;
4. kernel rows 3-5 the same way at the general path's per-direction shape
   [1440, 1440, 128]: `aggregate` (3 launches: 2 `sgm_line_kernel` and
   one of `sgm_sweep3_kernel`'s two-walk form, which carries the forward
   and the backward vertical sweep) and `fused_pass_bidir` (1 launch of
   that form, row 3), both also at [640, 640, 128] (the forward-motion
   CLI's SGM size), each beside its bound and its plan's bytes floor,
   `fused_pass(loop=True)` (row 4), `scan_direction` on
   int32 costs above 2^15 with shifts 0, 1 and -1 (row 5,
   `sgm_path_kernel`); then `aggregate_batch` on [1, 8, W, 16]
   with W one tile more than the vertical sweep kernel's resident blocks
   hold, whose vertical sweeps take one `sgm_path_kernel` launch per path,
   bit-equal to plain;
5. the rectified main path: `bench_main.run_once(1440, 2)` once to warm up
   and once timed, with the kernel's launch counts; coverage >= 0.84 and
   median relative error <= 1e-4 against the analytic depth;
6. the general-warp path: `stereo.reconstruct` at dim 1440 (range (4.0,
   8.5)) on the two-view scene of tests/test_sgm.py, its plane's slope per
   pixel scaled by 160/1440, with 128 planes and then with
   `SGMOptions(num_steps=256)` (the 129-512 route: `sgm_line_kernel` and
   `sgm_sweep3_kernel` at 8 depths a lane, no `sgm_path_kernel`
   launch); row-3 launches > 0, coverage and median relative error within
   the limits set from the JAX package's result at each plane count
   (`tools/jax_cpu_reference.py general [--planes 256]`);
7. the `smvsrecon` CLI (`smvs_tpu_torch.cli.main`) with its defaults on a
   4-view 1280 x 1280 plane scene written as an MVE scene, whose pairs
   rectify: exit 0, an `smvs-B0` embedding per view, the PLY, row 1-2
   launches > 0, and the fused points' share of the pixels and median
   relative error within the limits set from the JAX package's CLI
   (`tools/jax_cpu_reference.py cli`);
8. the same CLI on the plane seen by four views moving toward it, whose
   pairs do not rectify: the chain CLI -> `reconstruct_auto_multi` ->
   `reconstruct_auto`'s general-warp fallback -> `reconstruct` ->
   `aggregate`, with row-3 launches > 0 and no row 1-2 launch, and limits
   set the same way (`tools/jax_cpu_reference.py forward`); the shapes
   `aggregate` took there and its row-3 launches, 3 a call (48 for its
   16 calls; 4 a call before the two-walk form) are logged;
9. the SGM kernels beyond their first reach: a repeated shift through
   `fused_pass` and `fused_pass(loop=True)` (one `sgm_path_kernel` launch
   per listed path), every entry point at D = 129, 192, 256 and 512
   (`sgm_line_kernel` and `sgm_sweep3_kernel` with 8 or 16 depths per
   lane) and at D = 513, 1024 and 2048 (`sgm_deep_sweep_kernel`), one
   launch per sweep (4 per `aggregate` and `aggregate_batch`, none of
   them a one-path-per-launch kernel's), each bit-equal to plain on every
   timed run, with times, at [640, 640, D], and each D's launches counted
   by row and by kernel and held to `cuda_agg.plan_route`'s plan;
   `aggregate` at every D also on the per-path route
   (`cuda_agg.per_path_plan`: 8 `sgm_path_kernel` launches to 512,
   `sgm_deep_kernel` beyond) through `run_plan`, in turns with the plan's
   route, both bit-equal to plain; the same at the general path's
   per-direction volume with 256 planes, [1440, 1440, 256] (one launch
   per sweep with 1440 lines resident); every entry point at D = 16384 on
   a small volume (straight sweeps on `sgm_deep_sweep_kernel`, diagonal
   ones on `sgm_deep_kernel`'s 32-warp form, as planned), bit-equal; and
   D = 16385 raising before any launch; row 5 at every D on [640, 640, D]
   (`sgm_path_kernel` to 512, `sgm_deep_kernel` beyond), shift 1, timed
   beside its bound and bit-equal on every run;
10. the shading-aware flagship: `bench_main.run_shading_once(1440, 2)`
   once to warm up, once timed with the kernel's launch counts (rows 1-2
   > 0), and once with its stages synchronized for their split and its
   Newton and CG counts; coverage >= 0.85 and median relative error <=
   1e-2; the fitted lighting finite with band 0 > 0; and one shading
   assembly of its final surface on the card against the same on the CPU
   (float64): the norms of g and H within rtol 1e-6 in float64 and 0.1 in
   float32, and the shading term moving H by more than half;
11. the CLI with `-S` on the 4-view 1280 x 1280 scene of phase 7: an
   `smvs-S0` embedding per view, `smvs-S0.ply`, row 1-2 launches > 0, and
   limits set from the JAX package's CLI with `-S`
   (`tools/jax_cpu_reference.py shading`);
12. the CLI on a 4-view 1280 x 1280 color plane scene (channels that
   differ): `--no-sgm` (the sparse-prior init from the bundle's
   features), then `--no-sgm -S -g` in the same directory; no kernel
   launch, color points, and limits from the JAX CLI on the same
   configuration (`tools/jax_cpu_reference.py color`);
13. the CLI on a gray 4-view 640 x 640 plane scene (the configuration
   its limits come from, `tools/jax_cpu_reference.py fullopt --dim 640`;
   1280^2 took 168 s) with `--full-opt -m` (row 1-2 launches, a triangle
   mesh whose points, faces and error are held to those limits), then
   `-m -y` in the same directory (it skips the views and only fuses them,
   no launch; the greedy triangulation's mesh has fewer faces than the
   full one), and the simplify tool (`smvs_tpu_torch.tools.simplify`) on
   the full mesh;
14. view batching: the CLI with its defaults (`--batch-views 4`) on 8 views
   of the JAX repository's DTU-scale camera grid (`make_dtu_scene`), their
   sizes alternating 1440 and 1280 as `bench_dtu.py` mixes them: input
   scale 1, two buckets of 720^2 and 640^2 (padded to 736 and 640), each
   one batched group of 4; row 1-2 launches > 0, both groups batched, and
   points per working pixel and fused error within limits from the JAX
   CLI on the same grid (`tools/jax_cpu_reference.py batch`); then
   `--batch-views 1 -r --force --force-sgm` on a copy of the scene, every
   view sequential from the same SGM depths (recomputed: a checkpoint
   read back from its embedding rounds differently from the first run's
   in-memory depth), and per view the batched and the sequential depth
   maps compared: coverage apart by < 0.5% of the pixels, fewer than 10%
   of the commonly covered pixels drifting by more than 2e-4, and, since
   the batched path reduces view by view as the sequential one does,
   equal bit for bit. Stage seconds, solver read-backs and the peak
   device memory of both runs;
15. the multi-device half (`smvs_tpu_torch.dist`), its ranks spawned on
   this one card over gloo (NCCL takes one card per rank): (a) the
   sharded Newton step (`viewbatch.training_step_fn`) on
   `make_view_batch(4)` at dim 116, scale 4 (the JAX multihost worker's
   problem) and then dim 1440, scale 2 (360 node rows), float32, over
   meshes (2, 1) and (1, 2) on 2 ranks and (2, 2) on 4, against the
   single-process `batched_newton_step` here: a 'patch' axis of 1
   bit-equal; above 1 a nonzero update, within the JAX worker's bar
   (rtol 2e-3, atol 5e-5) at its dim 116, and at 1440, where the float32
   step itself departs from float64 by more than that bar (in the JAX
   package too: `tools/jax_cpu_reference.py step`), within twice the
   single-process float32 step's own distance from the float64 step, on
   the same entries; each mesh's step seconds and peak memory per rank;
   (b) the full pipeline over views: phase 14's batched group of the
   four 720^2 views (their SGM depths from that run, rows 1-2 launched
   there), through `optimize_view_batch(mesh=(2, 1))` on 2 ranks, every
   view on every rank bit-equal to the unsharded batch of phase 14;
   optimize seconds, host read-backs and peak memory per rank; (c) the
   scaling harness (`dist.scaling.measure`) at 1 and 2 ranks on
   `make_view_batch(dim=116)`, ranks sharing the card. (a) on 2 ranks,
   (b) and (c) at 2 ranks run on one spawn of 2 ranks, (a) on 4 ranks on
   one of 4 (a spawn's start costs 15-25 s). A rank that fails or
   outlasts its timeout stops the others and fails the phase;
16. the row-split pipeline (`optimize_view_batch` over a mesh whose
   'patch' axis splits each view's node rows: band assembly, band
   multigrid, halo stencil products, summed dots), gloo ranks sharing the
   card: (a) phase 5's 1440^2 view from its SGM depth (rows 1-2 launched
   there), min_scale 2, over a (1, 2) mesh against the unsharded batch
   in this process, under the JAX dry run's fixed Newton steps (6 a
   loop; its bars: the same coverage mask, rtol 1.5e-3, atol 1e-6, fewer
   than 10% of the pixels drifting by more than 2e-4) and under
   run_once's options (the main path's bar: coverage >= 0.84, median
   relative error <= 1e-4); (b) phase 14's four 720^2 views over a (2, 2)
   mesh against phase 14's unsharded batch, under the CLI's options: per
   view the coverage apart by < 0.5% of the pixels and the median error
   on the analytic depth at most twice the unsharded map's; (c)
   the dry run of `dist.dryrun.dryrun_multichip` at 2 and 4 ranks (a
   'patch' axis of 2), on (a)'s and (b)'s spawns, with its checks. Every
   rank must hold the same bits of every depth map. Per mesh
   and rank: optimize seconds, peak memory, host read-backs, and the
   collectives (halo exchanges, all-reduces, all-gathers) per PCG
   iteration;
17. what users and a benchmark run beyond the CLI: (a) the benchmark
   driver `smvs_tpu_torch.bench` (`bench.py`'s counterpart) at 1440 with
   one pass after its warm-up (`bench`'s default is 3): the main
   path's bars (coverage >= 0.84, median relative error <= 1e-4) and the
   flagship's (>= 0.85, <= 1e-2), MP/s; (b) `smvs_tpu_torch.bench_scene` at its defaults (10 plane
   views of 720^2, groups of 5) and (c) `smvs_tpu_torch.bench_dtu` on 10
   views of the DTU grid at scale 0 (7 of 1440^2, 3 of 1280^2, two shape
   buckets) in a fresh directory, cold then warm: each at least 90% of
   the coverage and at most three times the median error of the JAX
   driver on the CPU (`tools/jax_cpu_reference.py scene` and `dtu`), and
   set beside the JAX package's TPU records; (d) run_once's rectified SGM
   at 1440 with `SGMOptions(cost_interp=True)`: rows 1-2 bit-equal to
   plain on its volume, the depth map within limits from the JAX
   package's cost-interpolated SGM (`tools/jax_cpu_reference.py
   costinterp`), and its t_sgm beside the default cost's, in turns;
   (e) the CLI with `-d 2 -S -l 0-1` on a 4-view 320^2 plane scene: each
   of the two views run alone, the debug images of the JAX CLI in both,
   finite. The
   kernel rows 1-2 launch on (a)-(e), each path's counts set to 0 just
   before it and read just after;
18. the autodiff oracle (`gn.GNOptions(analytic=False)`): the final
   surfaces of phase 5's run_once and phase 10's flagship (with its
   lighting) assembled on the card by the analytic assembly and by the
   oracle, in float64 (the view set rebuilt in float64; the largest
   entry's scaled difference of g and of H <= 1e-9, the JAX test's bar)
   and in float32 with the optimizer's bf16 view set (the norms of g and
   H of both paths within rtol 0.1 of the float64 oracle's, phase 10's
   float32 bar); each assembly's median time of 5 and peak device memory,
   beside the card's name and power limit. No kernel launches there.

The launch counts of each path are set to 0 just before it runs and read
just after (each phase's seconds are logged as it ends); the `launches`
of each kernel row come from the path named in its `path` key (rows 4
and 5 have no user path), and rows 1 and 2 also list their launches on
the flagship and the CLI with `-S`. It prints one
`{"flagship": {...}}` line with the flagship's numbers, one `{"dist":
{...}}` line with phase 15's, one `{"split": {...}}` line with phase
16's, one `{"drivers": {...}}` line with phase 17's (the three drivers'
dicts among them), one `{"oracle": {...}}` line with phase 18's, one
`{"general": {...}, "phase_seconds": {...}}` line with phase 6's runs and
every phase's seconds, the card's name and power limit again, one
`{"kernels": [...]}` line with the five TPU kernel rows, each naming the
CUDA kernel that serves it (`sgm_sweep3_kernel` for rows 1 and 4,
`sgm_line_kernel` for row 2, `sgm_line_kernel` and
`sgm_sweep3_kernel<bidir>` for row 3, whose entry lists time, bound,
plan floor and launches at both of phase 4's shapes, `sgm_path_kernel` for row
5, whose entry lists its time, bound and share of the bound at every
shape timed: `by_shape`), the 129-512 route (`sgm_line_kernel` + `sgm_sweep3_kernel` at 8 and
16 depths a lane), timed on `aggregate` at D = 256 with its launches
from phase 6's run at 256 planes, `sgm_deep_sweep_kernel`, which serves
every sweep of distinct shifts beyond 512 depths, timed on `aggregate`
at D = 2048, and
`sgm_deep_kernel`, its one-path-per-launch fallback, timed on the
per-path route there, with its row-5 times at D = 513 and 2048 and its
per-path time at 513 beside their bounds, then as the last line
`{"ok": true, "device": {...}}`. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this check runs on the GPU")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from smvs_tpu_torch import bench as bench_driver  # noqa: E402
from smvs_tpu_torch import bench_dtu, bench_main, bench_scene  # noqa: E402
from smvs_tpu_torch import cli  # noqa: E402
from smvs_tpu_torch.core import scene as sc  # noqa: E402
from smvs_tpu_torch.core import synthetic as syn  # noqa: E402
from smvs_tpu_torch.device import set_cuda_precision  # noqa: E402
from smvs_tpu_torch.dist import dryrun, launch, rows  # noqa: E402
from smvs_tpu_torch.dist import scaling, viewbatch  # noqa: E402
from smvs_tpu_torch.dist.dryrun import check_bars  # noqa: E402
from smvs_tpu_torch.dist.mesh import make_mesh, row_band  # noqa: E402
from smvs_tpu_torch.dist.mesh import view_share  # noqa: E402
from smvs_tpu_torch.dist.testing import make_view_batch  # noqa: E402
from smvs_tpu_torch.mesh.ply import load_ply  # noqa: E402
from smvs_tpu_torch.pipeline import batch as VB  # noqa: E402
from smvs_tpu_torch.pipeline import optimizer as O  # noqa: E402
from smvs_tpu_torch.pipeline.views import make_view  # noqa: E402
from smvs_tpu_torch.sgm import cuda_agg  # noqa: E402
from smvs_tpu_torch.sgm import stereo  # noqa: E402
from smvs_tpu_torch.sgm.stereo import INVALID_COST  # noqa: E402
from smvs_tpu_torch.solver import gn  # noqa: E402
from smvs_tpu_torch.tools import simplify as simplify_tool  # noqa: E402
from smvs_tpu_torch.utils.timing import host_reads  # noqa: E402

# H100 SXM memory bandwidth (NVIDIA data sheet; full 700 W power limit).
# The data sheet gives no peak rate for integer min and add work, so the
# bound of this integer kernel is its bytes (PERF.md estimates the integer
# work beside it).
PEAK_BYTES_PER_S = 3.35e12

SHAPE = (2, 1440, 1696, 128)  # both SGM directions at the main path's size
MAIN_W = 1440  # the main problem's real width; the rest is INVALID padding
GEN_SHAPE = (1440, 1440, 128)  # one direction of the general-warp path
# Row 3 is timed at these [hw, hw, 128] shapes: the general path's, and
# the forward-motion CLI's SGM on 1280^2 views at the default scale.
ROW3_HW = (1440, 640)

# Limits of the general-warp path at dim 1440, from the JAX package's own
# result on this scene at dim 720 on the CPU (coverage 0.8681, median
# relative error 1.519e-3; PERF.md): 90% of its coverage, twice its error.
GENERAL_MIN_COVERAGE = 0.78
GENERAL_MAX_ERR = 3.0e-3
# The same path with 256 planes (`SGMOptions(num_steps=256)`, the 129-512
# route of the kernels: [1440, 1440, 256] volumes), set the same way from
# the JAX package's result at dim 720 on the CPU
# (`tools/jax_cpu_reference.py general --dim 720 --planes 256`: coverage
# 0.8681, median relative error 7.661e-4; PERF.md).
GENERAL_PLANES = (128, 256)
GENERAL_LIMITS = {128: (GENERAL_MIN_COVERAGE, GENERAL_MAX_ERR),
                  256: (0.78, 1.5e-3)}
# Limits of the CLI on 4 x 1280^2, from the JAX package's CLI on the same
# configuration at dim 640 on the CPU (1,424,149 points of 4 x 640^2
# pixels, 0.8692; median fused error 1.372e-4; PERF.md): 80% of its
# points per pixel, three times its error.
CLI_MIN_POINT_SHARE = 0.69
CLI_MAX_ERR = 4.1e-4
# Limits of the CLI on the 4 x 1280^2 forward-motion scene, set the same
# way from the JAX package's CLI on it at dim 960 on the CPU (3,302,450
# points, 0.8958 per pixel; median fused error 3.392e-4; PERF.md). This
# scene's fused error grows with its size in both packages (1.8e-4 at
# 640), so the reference is taken at the largest size run on the CPU.
FORWARD_MIN_POINT_SHARE = 0.71
FORWARD_MAX_ERR = 1.0e-3
# Limits of the shading-aware flagship `run_shading_once(1440, 2)`: 90%
# of the JAX package's coverage on the TPU (0.9397, `bench_r5_final.json`)
# and an error bound of the JAX package's class there (3.553e-3); its
# endpoint is chaotic (PERF_NOTES.md r5), so the class, not the digits.
SHADING_MIN_COVERAGE = 0.85
SHADING_MAX_ERR = 1e-2
# The card's shading assembly against the CPU's float64 one (norms of g
# and H): in float64, and in float32 (see `shading_assembly_check`).
SHADING_F64_RTOL = 1e-6
SHADING_F32_RTOL = 0.1
# Limits of the CLI with -S on 4 x 1280^2, from the JAX package's CLI with
# -S on the same configuration at dim 640 on the CPU (611,754 points of
# 4 x 640^2 pixels, 0.3734; median fused error 3.920e-3; PERF.md): 80% of
# its points per pixel, three times its error.
SHADING_CLI_MIN_POINT_SHARE = 0.29
SHADING_CLI_MAX_ERR = 1.2e-2
# Limits of the CLI on the 4 x 1280^2 color plane scene, from the JAX
# package's CLI on the same configuration at dim 640 on the CPU
# (`tools/jax_cpu_reference.py color --dim 640`; PERF.md): with --no-sgm
# 1,415,938 points of 4 x 640^2 pixels (0.8642), median fused error
# 8.232e-5; with --no-sgm -S -g 545,621 (0.3330), 5.005e-3. 80% of its
# points per pixel, three times its error.
COLOR_MIN_POINT_SHARE = 0.69
COLOR_MAX_ERR = 2.5e-4
COLOR_SHADING_MIN_POINT_SHARE = 0.26
COLOR_SHADING_MAX_ERR = 1.5e-2
# The color scene's bundle features: the density of the 200 features of a
# 160 px scene (`tools/jax_cpu_reference.py`'s `features`); the splat init
# needs a few in each node's window.
CLI_DIM = 1280  # the CLI scenes' views: 4 x 1280^2
COLOR_FEATURES = round(200 * (CLI_DIM / 160) ** 2)
# Limits of the CLI with --full-opt -m on 4 x 640^2, from the JAX CLI on
# the same configuration on the CPU (`tools/jax_cpu_reference.py fullopt
# --dim 640`; PERF.md): 1,424,205 vertices (0.8693 per pixel), 2,838,597
# faces (1.7326 per pixel), median fused error 1.086e-4. 80% of its
# vertices and faces per pixel, three times its error. Its -m -y run gives
# 0 vertices and 0 faces (the greedy triangulation of maps without depth
# at the image corners; ROADMAP.md). Phase 13 ran these on 4 x 1280^2
# until its time was cut; 640^2 is the configuration the limits come from.
MESH_DIM = 640
FULLOPT_MIN_POINT_SHARE = 0.69
FULLOPT_MIN_FACE_SHARE = 1.38
FULLOPT_MAX_ERR = 3.3e-4
SIMPLIFY_RATIO = 0.25  # the simplify tool's default
# Limits of the CLI's view batching on 8 grid views of 1440^2 and 1280^2,
# from the JAX CLI with its defaults on the same grid at 720^2 and 640^2,
# the same working sizes (`tools/jax_cpu_reference.py batch --dim 720`;
# PERF.md): 80% of its fused points per working pixel, three times its
# median fused error.
BATCH_DIMS = (1440, 1280)
BATCH_VIEWS = 8
# JAX: 3,322,794 points of 3,712,000 working pixels (0.8951), median
# fused error 1.148e-4.
BATCH_MIN_POINT_SHARE = 0.71
BATCH_MAX_ERR = 3.4e-4
# Batched against sequential depth maps, per view:
BATCH_MAX_COVERAGE_GAP = 0.005
BATCH_DRIFT = 2e-4
BATCH_MAX_DRIFT_SHARE = 0.10
# Phase 15: the sharded step's problems (dim, scale), the meshes (views,
# patch) and the bars; every spawn's time limit.
DIST_STEPS = ((116, 4), (1440, 2))
DIST_MESHES = ((2, 1), (1, 2), (2, 2))
DIST_RTOL, DIST_ATOL = 2e-3, 5e-5  # the JAX multihost worker's, at dim 116
DIST_F64_RATIO = 2.0  # sharded vs single float32, each against float64
DIST_TIMEOUT = 300.0
DIST_SCALING_DIM = 116  # (c)'s make_view_batch(dim=...)
# Phase 16: (a)'s fixed-step run takes the JAX dry run's six Newton steps
# a loop; every spawn's time limit.
SPLIT_FIXED_STEPS = 6
SPLIT_TIMEOUT = 300.0
# (b) runs the CLI's options, whose Newton and PCG exits and working sets
# read sums that the row split adds band by band: a view then takes other
# iteration counts and its map moves by a convergence epsilon (the JAX
# package's own row-split batch drifts 81% of one view's pixels by more
# than 2e-4 on four plane views at dim 96, `tools/jax_cpu_reference.py
# pipeline --dim 96 --scene plane`). So (b) holds each view to phase 14's
# coverage gap and to twice the unsharded map's median error on the
# analytic depth.
SPLIT_ERR_RATIO = 2.0
STEP_ARGS = ("nodes", "node_valid", "patch_valid", "vis", "active", "view")
# Phase 17. (a) holds the main path's and the flagship's bars above. (b)
# and (c) hold 90% of the coverage and three times the median relative
# error of the JAX driver on the CPU at the same view count
# (`tools/jax_cpu_reference.py scene --dim 720` and `dtu --dim 720`;
# PERF.md): `bench_scene.py` at its defaults, 10 x 720^2, coverage 0.9046,
# error 2.1e-5; `bench_dtu.py` on 10 grid views of 720^2 and 640^2 (the
# largest the CPU runs; the card runs 1440^2 and 1280^2), 0.9447, 3.28e-4.
DRIVER_MIN_COV_SHARE = 0.9
DRIVER_MAX_ERR_FACTOR = 3.0
SCENE_JAX_CPU = (0.9046, 2.1e-5)
DTU_JAX_CPU = (0.9447, 3.28e-4)
DTU_VIEWS = 10
# (a)'s passes after its warm-up (`bench`'s default is 3; one keeps the
# run's time; the bars are held on that pass).
BENCH_PASSES = 1
# The JAX package's TPU records, a class check printed beside (b) and (c):
# `bench_scene_r5.json` and `BENCH_DTU_r5.json` (49 views).
SCENE_TPU_RECORD = (0.9046, 2.1e-5)
DTU_TPU_RECORD = (0.9447, 2.64e-4)
# (d): the cost-interpolated SGM depth of run_once's pair, held to 90% of
# the coverage and twice the median relative error of the JAX package's on
# the same pair at 1440 on the CPU (`tools/jax_cpu_reference.py
# costinterp --dim 1440`: 0.8660, 1.908e-3; the default cost 0.8670,
# 1.273e-3; PERF.md).
COST_INTERP_MIN_COVERAGE = 0.779
COST_INTERP_MAX_ERR = 3.8e-3
# (e): the CLI with -d 2 -S on 4 plane views of this size; the debug
# images the JAX CLI writes there.
DEBUG_DIM = 320
DEBUG_VIEWS = "0-1"  # the views -d 2 -S reconstructs, of 4
DEBUG_IMAGES = ("smvs-sgm-filtered", "smvs-initial", "smvs-shaded",
                "smvs-shaded-sphere", "smvs-implicit-albedo")

# Phase 18: the autodiff oracle against the analytic assembly on the
# card. float64: the largest entry's scaled difference within JAX's bar on
# the CPU (tests/test_gn_analytic.py); float32 with the optimizer's bf16
# view set: the norms of g and H within phase 10's float32 bar of the
# float64 oracle's. Times are the median of ORACLE_REPS.
ORACLE_F64_BAR = 1e-9
ORACLE_F32_RTOL = SHADING_F32_RTOL
ORACLE_REPS = 5

# Depth counts beyond 128: the line and sweep kernels at 8 and 16 depths a
# lane to 512, the deep kernels beyond; at every one `aggregate` is also
# timed on the per-path route (sgm_path_kernel to 512, sgm_deep_kernel
# beyond).
DEEP = (129, 192, 256, 512, 513, 1024, 2048)
DEEP_HW = 640  # [640, 640, D] problems for them
DEEP_MAX_SHAPE = (16, 24, cuda_agg.MAX_D)  # sgm_deep_kernel's 32-warp form
# sgm_deep_kernel's entry of the kernels line: row 5 at these D, and the
# per-path route at the first.
DEEP_KERNEL_D = (513, 2048)
DEEP_TIMED_D = 2048  # the deep kernels' entries of the kernels line
WIDE_TIMED_D = 256  # the 129-512 route's entry of the kernels line
# The general path's per-direction volume at 256 planes, timed on both
# routes: 1440 lines, one launch per vertical sweep.
WIDE_GEN_SHAPE = (1440, 1440, 256)

SOURCE = "smvs_tpu_torch/csrc/sgm_agg.cu"
# Each row's `pl.pallas_call` and the TPU kernel it runs.
REPLACES = {
    "fused_pass": ("smvs_tpu/sgm/pallas_agg.py:288", "_fused_kernel"),
    "fused_pass_batch": ("smvs_tpu/sgm/pallas_agg.py:488",
                         "_fused_kernel_batch"),
    "fused_pass_bidir": ("smvs_tpu/sgm/pallas_agg.py:389",
                         "_fused_kernel_bidir"),
    "fused_pass_loop": ("smvs_tpu/sgm/pallas_agg.py:288",
                        "_fused_kernel_loop"),
    "scan_direction": ("smvs_tpu/sgm/pallas_agg.py:99", "_scan_kernel"),
}
# The CUDA kernel that serves each row (at D <= 128).
KERNEL = {"fused_pass": "sgm_sweep3_kernel",
          "fused_pass_batch": "sgm_line_kernel",
          "fused_pass_bidir": "sgm_line_kernel + sgm_sweep3_kernel<bidir>",
          "fused_pass_loop": "sgm_sweep3_kernel",
          "scan_direction": "sgm_path_kernel"}
REPS = 10  # timed repetitions of each kernel, each checked bit-equal
P1, P2 = 6, 96


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, check, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up;
    ``check`` is called on the warm-up's and every timed run's result,
    after its time is taken."""
    check(fn())
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        check(out)
    return statistics.median(times)


def once_ms(fn):
    """(result, ms) of one run, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bound(n: int, depths: int, acc_in: bool, elem: int = 2) -> dict:
    """Least time over ``n`` cost elements of ``elem`` bytes: the bytes
    that must move (the cost and, for a sweep, the accumulator read once,
    the int32 intensities read once, the result written once) at peak
    bandwidth."""
    bytes_moved = (elem + elem * acc_in) * n + 4 * (n // depths) + elem * n
    return {"bound_ms": bytes_moved / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def compare(name: str, fn, plain, acc_in: bool, elem: int = 2) -> dict:
    """Kernel against its plain version on the same inputs: bit-equal or
    raise; then the kernel's median time, each timed run bit-equal to the
    first (a race shows as a rare run-to-run mismatch). The comparison's
    launches are not counted as any path's."""
    got = fn()
    torch.cuda.synchronize()
    want, plain_ms = once_ms(plain)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise RuntimeError(f"{name} differs from its plain version: {err}")
    del want
    runs = [1]

    def check(out):
        if not torch.equal(out, got):
            raise RuntimeError(f"{name}: run {runs[0] + 1} differs from "
                               "the first, which matched the plain version")
        runs[0] += 1

    ms = cuda_ms(fn, check)
    out = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "bit_equal_runs": runs[0], "shape": list(got.shape),
           **bound(got.numel(), got.shape[-1], acc_in, elem)}
    log(f"{name} {list(got.shape)}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {out['bound_ms']:.4f} ms, bit-equal in "
        f"{runs[0]} runs")
    return out


def phase_card() -> tuple:
    """The device entry of the last line, and the card's name and power
    limit as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}, card


def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_agg.build(verbose=True)
    log(f"built {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s")
    tile, _, resident = cuda_agg.sweep_geometry(torch.device("cuda", 0), 128)
    log(f"sgm_sweep3_kernel at D = 128: {tile} lines per block, {resident} "
        "blocks resident at once")


def _seeded(shape, seed: int, hi: int = 127):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cost = torch.randint(0, hi, shape, generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, shape[:-1], generator=g, device="cuda",
                          dtype=torch.int32)
    return cost, inten


def check_argmin_ties(agg: torch.Tensor) -> None:
    """The WTA index needs `torch.argmin` to take the first of tied minima
    on the card, as `jnp.argmin` does: held on the full aggregated volume,
    and on the same sums divided by 32, which tie far more often."""
    D = agg.shape[-1]
    planes = torch.arange(D, device=agg.device, dtype=torch.int16)
    for name, vol in (("sums", agg), ("sums >> 5", agg >> 5)):
        ties = 0
        for v in vol:  # one problem at a time bounds the temporaries
            is_min = v == v.amin(-1, keepdim=True)
            first = torch.where(is_min, planes, D).amin(-1)
            if not torch.equal(torch.argmin(v, -1), first.to(torch.int64)):
                raise RuntimeError(f"argmin of the {name} is not the first "
                                   "tied minimum")
            ties += int((is_min.sum(-1) > 1).sum())
        log(f"argmin of the {name}: first of tied minima "
            f"({ties} pixels with ties)")


def time_launches(name: str, plan: list, cost, inten, acc, want,
                  bounds: list) -> list:
    """Each launch of ``plan`` timed on its own with CUDA events, median of
    ``REPS`` runs after a warm-up, each run's result bit-equal to
    ``want``."""
    times = [[] for _ in plan]
    for rep in range(REPS + 1):
        events = [torch.cuda.Event(enable_timing=True) for _ in
                  range(len(plan) + 1)]
        out = cuda_agg.run_plan(plan, cost, inten, acc, P1, P2,
                                on_launch=lambda i: events[i].record())
        events[-1].synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"{name}: run {rep + 1} differs from the "
                               "plain version")
        if rep:
            for i in range(len(plan)):
                times[i].append(events[i].elapsed_time(events[i + 1]))
    rows = []
    for ln, ts, b in zip(plan, times, bounds):
        ms = statistics.median(ts)
        rows.append({"kernel": ln.kernel, "scan": ln.scan,
                     "reverse": ln.reverse, "mode": ln.mode, "ms": ms,
                     "bound_ms": b})
        log(f"  {name}: {ln.kernel} scan {ln.scan} reverse {ln.reverse} "
            f"{ln.mode}: {ms:.3f} ms, bound {b:.4f} ms")
    return rows


def line_against_path(cost, inten) -> dict:
    """One in-place straight sweep at `aggregate_batch`'s horizontal
    launch (scan along W, chain-contiguous) through `sgm_line_kernel` and
    through `sgm_path_kernel`, in turns (line, path, path, line, ...),
    each launch timed alone and its result held bit-equal to plain."""
    g = torch.Generator(device="cuda").manual_seed(77)
    acc = torch.randint(0, 500, cost.shape, generator=g, device="cuda",
                        dtype=torch.int16)
    plans = {k: [cuda_agg.Launch(k, 2, False, "add", (0,),
                                 "fused_pass_batch", 0, cost.shape[0])]
             for k in ("line", "path")}
    want = cuda_agg.plain_run_plan(plans["line"], cost, inten, acc, P1, P2)
    times = {k: [] for k in plans}
    for rep in range(2 * REPS + 2):
        k = ("line", "path", "path", "line")[rep % 4]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        out = cuda_agg.run_plan(plans[k], cost, inten, acc, P1, P2,
                                on_launch=lambda i: events[i].record())
        events[1].synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"the {k} kernel's straight sweep differs "
                               "from the plain version")
        if rep >= 2:  # the first of each is a warm-up
            times[k].append(events[0].elapsed_time(events[1]))
        del out
    res = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    res["bound_ms"] = bound(cost.numel(), cost.shape[-1], True)["bound_ms"]
    res["shape"] = list(cost.shape)
    log(f"straight sweep in place at {list(cost.shape)}, scan W: "
        f"sgm_line_kernel {res['line_ms']:.3f} ms, sgm_path_kernel "
        f"{res['path_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms, "
        f"bit-equal on every run")
    return res


def phase_kernel_rectified() -> dict:
    """Rows 1-2 at the rectified path's shapes."""
    cost, inten = _seeded(SHAPE, 1234)
    cost[0, :, MAIN_W:] = INVALID_COST
    inten[0, :, MAIN_W:] = 0

    cuda_agg.reset_launches()
    check_argmin_ties(cuda_agg.aggregate_batch(cost, inten, P1, P2))
    if (cuda_agg.launches["fused_pass_batch"],
            cuda_agg.launches["fused_pass"]) != (2, 2):
        raise RuntimeError("aggregate_batch did not launch 2 + 2 kernels")
    agg = compare("aggregate_batch (rows 1-2, 4 launches)",
                  lambda: cuda_agg.aggregate_batch(cost, inten, P1, P2),
                  lambda: cuda_agg.plain_aggregate_batch(cost, inten, P1,
                                                         P2),
                  acc_in=False)
    # The split of its time over its four launches.
    want = cuda_agg.aggregate_batch(cost, inten, P1, P2)
    tile, _, resident = cuda_agg.sweep_geometry(cost.device, SHAPE[3])
    plan = cuda_agg.plan_route("aggregate_batch", SHAPE[0], SHAPE[2],
                               resident, tile=tile)
    n = cost.numel()
    bounds = [bound(n, SHAPE[3], ln.mode == "add")["bound_ms"]
              for ln in plan]
    agg["launches"] = time_launches("aggregate_batch", plan, cost, inten,
                                    None, want, bounds)
    del want
    line_path = line_against_path(cost, inten)

    # The two TPU entry points at the main path's sweep shapes: the
    # horizontal 1-path sweep of both problems, the 3-path sweep of one.
    ct = cost.transpose(1, 2).contiguous()
    it = inten.transpose(1, 2).contiguous()
    acc = torch.zeros_like(ct)
    acc1 = torch.zeros_like(cost[1])
    cuda_agg.reset_launches()
    cuda_agg.fused_pass_batch(ct, it, acc, False, (0,), P1, P2)
    if cuda_agg.launches["fused_pass_batch"] != 1:
        raise RuntimeError("fused_pass_batch (0,) did not launch 1 kernel")
    rows = {
        "fused_pass_batch": compare(
            "fused_pass_batch (row 2)",
            lambda: cuda_agg.fused_pass_batch(ct, it, acc, False, (0,), P1,
                                              P2),
            lambda: cuda_agg.plain_fused_pass_batch(ct, it, acc, False, (0,),
                                                    P1, P2),
            acc_in=True),
        "fused_pass": compare(
            "fused_pass (row 1)",
            lambda: cuda_agg.fused_pass(cost[1], inten[1], acc1, True,
                                        (0, 1, -1), P1, P2),
            lambda: cuda_agg.plain_fused_pass_batch(
                cost[1:2], inten[1:2], acc1[None], True, (0, 1, -1), P1,
                P2)[0],
            acc_in=True),
    }
    for r in rows.values():
        r["aggregate_batch"] = agg
    rows["fused_pass_batch"]["line_against_path"] = line_path
    return rows


def plan_floor_ms(entry: str, cost, **kw) -> float:
    """The bytes floor of ``entry``'s plan on ``cost`` (`cuda_agg.
    plan_bytes`), with the copy of acc where the plan adds into one."""
    plan = cuda_agg.plan_route(entry, 1, cost.shape[1],
                               **cuda_agg.plan_geometry(cost), **kw)
    copy = (2 * cost.numel() * cost.element_size()
            if entry != "aggregate" and plan[0].mode == "add" else 0)
    return (cuda_agg.plan_bytes(plan, (1,) + tuple(cost.shape))
            + copy) / PEAK_BYTES_PER_S * 1e3


def row3_at(hw: int, seed: int) -> dict:
    """Row 3 at [hw, hw, 128]: `aggregate` (3 launches) and
    `fused_pass_bidir` (1), each launch count checked first, then each
    held bit-equal and timed beside its bound and plan floor."""
    cost, inten = _seeded((hw, hw, 128), seed)
    acc = torch.zeros_like(cost)
    for name, fn, want in (
            ("aggregate", lambda: cuda_agg.aggregate(cost, inten, P1, P2),
             3),
            ("fused_pass_bidir",
             lambda: cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1),
                                               P1, P2), 1)):
        cuda_agg.reset_launches()
        fn()
        kernels = {k: v for k, v in cuda_agg.kernel_launches.items() if v}
        if cuda_agg.launches["fused_pass_bidir"] != want or \
                kernels.get("sweep3_bidir") != 1:
            raise RuntimeError(f"{name} at [{hw}, {hw}, 128] launched "
                               f"{kernels}, not {want} with one two-walk "
                               "sweep")
    agg = compare(f"aggregate [{hw}, {hw}, 128] (row 3, 3 launches)",
                  lambda: cuda_agg.aggregate(cost, inten, P1, P2),
                  lambda: cuda_agg.plain_aggregate(cost, inten, P1, P2),
                  acc_in=False)
    agg.update(launches_per_call=3,
               plan_floor_ms=plan_floor_ms("aggregate", cost))
    pair = compare(
        f"fused_pass_bidir [{hw}, {hw}, 128] (row 3, 1 launch)",
        lambda: cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1),
                                          P1, P2),
        lambda: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                (0, 1, -1), P1, P2),
        acc_in=True)
    pair.update(launches_per_call=1, plan_floor_ms=plan_floor_ms(
        "fused_pass_bidir", cost, shifts=(0, 1, -1)))
    return {"aggregate": agg, "fused_pass_bidir": pair}


def phase_kernel_general() -> dict:
    """Rows 3-5 at the general path's per-direction shape (row 3 also at
    [640, 640, 128])."""
    row3 = {hw: row3_at(hw, 4321 + hw - 1440) for hw in ROW3_HW}
    cost, inten = _seeded(GEN_SHAPE, 4321)
    acc = torch.zeros_like(cost)
    rows = {
        "fused_pass_bidir": dict(row3[GEN_SHAPE[0]]["fused_pass_bidir"]),
        "fused_pass_loop": compare(
            "fused_pass(loop=True) (row 4)",
            lambda: cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1),
                                        P1, P2, loop=True, xb=8),
            lambda: cuda_agg.plain_fused_pass_batch(
                cost[None], inten[None], acc[None], False, (0, 1, -1), P1,
                P2)[0],
            acc_in=True),
    }
    rows["fused_pass_bidir"]["aggregate"] = row3[GEN_SHAPE[0]]["aggregate"]
    rows["fused_pass_bidir"]["by_shape"] = {
        f"[{hw}, {hw}, 128]": {
            k: {f: v[k][f] for f in ("ms", "bound_ms", "plan_floor_ms",
                                     "launches_per_call", "bit_equal_runs")}
            for k in ("fused_pass_bidir", "aggregate")}
        for hw, v in row3.items()}
    # Row 5 in int32, costs above 2^15 (as the TPU kernel's tests use);
    # shift 0 is the row's entry, the diagonals beside it.
    cost32 = cost.to(torch.int32) * 300
    del cost, acc
    shifts = {shift: compare(
        f"scan_direction shift {shift} (row 5)",
        lambda: cuda_agg.scan_direction(cost32, inten, shift, P1, P2),
        lambda: cuda_agg.plain_scan_direction(cost32, inten, shift, P1, P2),
        acc_in=False, elem=4) for shift in (0, 1, -1)}
    rows["scan_direction"] = {**shifts[0], "shifts": shifts}
    return rows


def phase_wide() -> dict:
    """`aggregate_batch` on one problem one tile wider than the vertical
    sweep kernel's resident blocks hold, at D = 16: its vertical sweeps
    take one `sgm_path_kernel` launch per path, bit-equal to plain."""
    tile, _, resident = cuda_agg.sweep_geometry(torch.device("cuda", 0), 16)
    shape = (1, 8, (resident + 1) * tile, 16)
    cost, inten = _seeded(shape, 99)
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate_batch(cost, inten, P1, P2)
    launches = dict(cuda_agg.launches)
    if (launches["fused_pass_batch"], launches["fused_pass"]) != (2, 6):
        raise RuntimeError(f"the wide problem launched {launches}, not "
                           "2 line + 6 path kernels")
    want = cuda_agg.plain_aggregate_batch(cost, inten, P1, P2)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise RuntimeError(f"the wide problem differs from plain: {err}")
    log(f"aggregate_batch {list(shape)} beyond {resident} resident blocks "
        f"of {tile} lines: launches {launches}, bit-equal to plain")
    return {"shape": list(shape), "launches": launches, "max_abs_err": err}


def phase_main(details: dict) -> dict:
    """The rectified main path; ``details`` receives its view, SGM depth
    and options (`bench_main.run_once`'s) for phase 16."""
    dim = 1440
    t0 = time.perf_counter()
    bench_main.run_once(dim, 2, device="cuda")
    log(f"warm-up run_once({dim}, 2): {time.perf_counter() - t0:.1f} s")
    cuda_agg.reset_launches()
    t_sgm, t_opt, cov, err = bench_main.run_once(dim, 2, device="cuda",
                                                 verbose=True,
                                                 details=details)
    launches = dict(cuda_agg.launches)
    mps = dim * dim / 1e6 / (t_sgm + t_opt)
    log(f"run_once({dim}, 2): sgm {t_sgm:.3f} s, optimizer {t_opt:.3f} s, "
        f"{mps:.3f} MP/s, coverage {cov:.4f}, median_rel_err {err:.3e}, "
        f"kernel launches {launches}")
    if launches["fused_pass"] <= 0 or launches["fused_pass_batch"] <= 0:
        raise RuntimeError("the main path did not launch the SGM kernel")
    if not cov >= 0.84:
        raise RuntimeError(f"coverage {cov:.4f} < 0.84")
    if not err <= 1e-4:
        raise RuntimeError(f"median_rel_err {err:.3e} > 1e-4")
    return launches


def phase_general(planes: int) -> dict:
    """`stereo.reconstruct` at dim 1440 with ``planes`` depth planes: row-3
    launches > 0 (at 256 planes none of them `sgm_path_kernel`), coverage
    and median relative error within ``GENERAL_LIMITS``."""
    dim = 1440
    min_cov, max_err = GENERAL_LIMITS[planes]
    slope = 0.005 * 160.0 / dim
    scene = syn.make_two_view_scene(
        dim=dim, rotate=False, baseline=0.25, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    cm, cn = scene.cameras[1], scene.cameras[0]
    mats = [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in
            (*cm.fill_reprojection(cn, dim, dim, dim, dim),
             *cn.fill_reprojection(cm, dim, dim, dim, dim))]
    main = torch.as_tensor(scene.images[1], device="cuda") * 255.0
    nbr = torch.as_tensor(scene.images[0], device="cuda") * 255.0
    opts = stereo.SGMOptions(num_steps=planes)

    def run():
        depth = stereo.reconstruct(main, nbr, *mats, (4.0, 8.5), (4.0, 8.5),
                                   opts)
        torch.cuda.synchronize()
        return depth

    t0 = time.perf_counter()
    run()
    log(f"warm-up reconstruct({dim}, {planes} planes): "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    cuda_agg.reset_launches()
    t0 = time.perf_counter()
    depth = run()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_agg.launches)
    kernels = {k: v for k, v in cuda_agg.kernel_launches.items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    depth = depth.cpu().numpy()
    gt = scene.depths[1]
    mask = depth > 0
    cov = float(mask.mean())
    err = float(np.median(np.abs(depth[mask] - gt[mask]) / gt[mask]))
    log(f"general-warp reconstruct({dim}, {planes} planes): {seconds:.3f} "
        f"s, peak {peak_gb:.2f} GB, coverage {cov:.4f}, median_rel_err "
        f"{err:.3e}, kernel launches {launches} by kernel {kernels}")
    if launches["fused_pass_bidir"] <= 0:
        raise RuntimeError("the general path did not launch the kernel")
    if planes > cuda_agg.SWEEP_MAX_D and (
            "path" in kernels or not kernels.get("line")
            or not kernels.get("sweep3")):
        raise RuntimeError(f"{planes} planes did not take sgm_line_kernel "
                           f"and sgm_sweep3_kernel alone: {kernels}")
    if not cov >= min_cov:
        raise RuntimeError(f"coverage {cov:.4f} < {min_cov}")
    if not err <= max_err:
        raise RuntimeError(f"median_rel_err {err:.3e} > {max_err}")
    return {"planes": planes, "seconds": seconds, "coverage": cov,
            "median_rel_err": err, "launches": launches, "kernels": kernels,
            "peak_gb": peak_gb}


def fused_error(vertices: np.ndarray, scene, view: int = 1) -> float:
    """Median relative depth error of fused points seen by ``view``
    (as tests/test_cli.py reckons it)."""
    cam = scene.cameras[view]
    p_cam = vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, scene.width, scene.height)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < scene.width) & \
        (uv[:, 1] >= 0) & (uv[:, 1] < scene.height) & (p_cam[:, 2] > 0)
    xi = np.clip(uv[inb, 0].astype(int), 0, scene.width - 1)
    yi = np.clip(uv[inb, 1].astype(int), 0, scene.height - 1)
    gt = scene.depths[view][yi, xi]
    ok = gt > 0
    return float(np.median(np.abs(p_cam[inb][ok, 2] - gt[ok]) / gt[ok]))


def run_cli(label: str, path: str, scene, flags: tuple, ply: str,
            rows: tuple, min_share: float | None = None,
            max_err: float | None = None, min_faces: float | None = None,
            embedding: str | None = None) -> dict:
    """One run of the CLI with ``flags`` on the scene directory ``path``
    (``scene`` its synthetic source), the kernel launch counts set to 0
    just before and read just after: exit 0, ``embedding`` in every view,
    the launches of exactly the kernel rows ``rows``, and the PLY
    ``ply``'s points (vertices) and faces per pixel and median fused error
    within the limits given."""
    n_views, dim = len(scene.cameras), scene.width
    out = io.StringIO()
    cuda_agg.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([path, *flags])
    seconds = time.perf_counter() - t0
    launches = dict(cuda_agg.launches)
    kernels = dict(cuda_agg.kernel_launches)
    text = out.getvalue()
    log("\n".join(f"  {label}: " + line for line in text.splitlines()))
    if rc != 0:
        raise RuntimeError(f"{label}: the CLI exited with {rc}")
    if embedding is not None:
        for v in sc.Scene.load(path).views:
            if not v.has_embedding(embedding):
                raise RuntimeError(f"{label}: view {v.view_id} has no "
                                   f"{embedding}")
    ps = load_ply(os.path.join(path, ply))
    stages = re.search(r"Stage seconds: (.*)", text).group(1)
    pixels = n_views * dim * dim
    share = len(ps.vertices) / pixels
    faces = 0 if ps.faces is None else len(ps.faces)
    err = fused_error(ps.vertices, scene) if len(ps.vertices) else None
    log(f"{label} {n_views} x {dim}^2: {seconds:.3f} s ({stages}), "
        f"{len(ps.vertices)} points ({share:.4f} per pixel), {faces} faces "
        f"({faces / pixels:.4f} per pixel), median fused error {err}, "
        f"kernel launches {launches} by kernel {kernels}")
    for row in cuda_agg.ROWS:
        if (launches[row] > 0) != (row in rows):
            raise RuntimeError(f"{label}: {launches[row]} launches of "
                               f"{row}; expected launches of {rows} only")
    if min_share is not None and not share >= min_share:
        raise RuntimeError(f"{label}: {share:.4f} points per pixel < "
                           f"{min_share}")
    if max_err is not None and not (err is not None and err <= max_err):
        raise RuntimeError(f"{label}: median fused error {err} > {max_err}")
    if min_faces is not None and not faces / pixels >= min_faces:
        raise RuntimeError(f"{label}: {faces / pixels:.4f} faces per pixel "
                           f"< {min_faces}")
    return {"seconds": seconds, "stages": stages,
            "points": len(ps.vertices), "points_per_pixel": share,
            "faces": faces, "median_fused_rel_err": err,
            "launches": launches, "kernel_launches": kernels, "text": text,
            "colors": ps.colors}


@contextlib.contextmanager
def aggregate_shapes():
    """The shape of every `cuda_agg.aggregate` call made while open."""
    fn, shapes = cuda_agg.aggregate, []

    def recorded(cost, *args, **kw):
        shapes.append(tuple(cost.shape))
        return fn(cost, *args, **kw)

    cuda_agg.aggregate = recorded
    try:
        yield shapes
    finally:
        cuda_agg.aggregate = fn


def phase_cli(label: str, cameras, min_share: float, max_err: float,
              rows: tuple, flags: tuple = ()) -> dict:
    """The CLI with its defaults and ``flags`` on a 4-view 1280^2 plane
    scene (``cameras`` None: the sideways views of `make_plane_scene`);
    ``rows`` are the kernel rows its SGM must launch. Returns the
    launches."""
    name = "smvs-S0" if "-S" in flags else "smvs-B0"
    scene = syn.make_plane_scene(n_views=4, dim=CLI_DIM, cameras=cameras)
    with tempfile.TemporaryDirectory() as path:
        syn.save_as_mve_scene(scene, path)
        res = run_cli(label, path, scene, flags, f"{name}.ply", rows,
                      min_share, max_err, embedding=name)
    return res["launches"]


def _summary(res: dict) -> dict:
    return {k: v for k, v in res.items() if k not in ("text", "colors")}


def phase_cli_color() -> dict:
    """The CLI on a 4-view 1280^2 color plane scene: `--no-sgm`, then
    `--no-sgm -S -g` in the same directory. No SGM runs, so no kernel
    launches; the fused points carry the RGB image's colors."""
    scene = syn.make_plane_scene(n_views=4, dim=CLI_DIM, color=True)
    with tempfile.TemporaryDirectory() as path:
        syn.save_as_mve_scene(scene, path, n_features=COLOR_FEATURES)
        base = run_cli("cli color --no-sgm", path, scene, ("--no-sgm",),
                       "smvs-B0.ply", (), COLOR_MIN_POINT_SHARE,
                       COLOR_MAX_ERR, embedding="smvs-B0")
        shading = run_cli("cli color --no-sgm -S -g", path, scene,
                          ("--no-sgm", "-S", "-g"), "smvs-S0.ply", (),
                          COLOR_SHADING_MIN_POINT_SHARE,
                          COLOR_SHADING_MAX_ERR, embedding="smvs-S0")
    for label, res in (("--no-sgm", base), ("--no-sgm -S -g", shading)):
        c = res["colors"]
        if c is None or c.shape[1] != 3 or \
                not (c[:, 0] != c[:, 1]).any():
            raise RuntimeError(f"cli color {label}: the points do not carry "
                               "the views' RGB colors")
    return {"no_sgm": _summary(base), "no_sgm_S_g": _summary(shading)}


def phase_cli_mesh() -> dict:
    """The CLI on a gray 4-view plane scene of MESH_DIM^2 with `--full-opt
    -m`, then `-m -y` in the same directory (every view skipped, only the
    fusion into greedy simplified meshes), then the simplify tool on the
    full mesh. At 1280^2 the three took 168 s: `-m -y` alone 88 s on two
    of the views and 166 s on one (uncut maps take longer), the simplify
    tool 55 s on the 11.4 million faces."""
    scene = syn.make_plane_scene(n_views=4, dim=MESH_DIM)
    with tempfile.TemporaryDirectory() as path:
        syn.save_as_mve_scene(scene, path)
        full = run_cli("cli --full-opt -m", path, scene, ("--full-opt", "-m"),
                       "smvs-m-B0.ply", ("fused_pass", "fused_pass_batch"),
                       FULLOPT_MIN_POINT_SHARE, FULLOPT_MAX_ERR,
                       FULLOPT_MIN_FACE_SHARE, embedding="smvs-B0")
        kept = os.path.join(path, "full-mesh.ply")
        shutil.copy(os.path.join(path, "smvs-m-B0.ply"), kept)
        simple = run_cli("cli -m -y", path, scene, ("-m", "-y"),
                         "smvs-m-B0.ply", ())
        if "Skipping 4 views that are already reconstructed." not in \
                simple["text"]:
            raise RuntimeError("cli -m -y: the views were reconstructed "
                               "again")
        if not (simple["faces"] < full["faces"]
                and simple["points"] <= full["points"]):
            raise RuntimeError(f"cli -m -y: {simple['faces']} faces and "
                               f"{simple['points']} vertices, not fewer "
                               "than the full mesh's")
        out = os.path.join(path, "simplified.ply")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = simplify_tool.main([kept, out, str(SIMPLIFY_RATIO)])
        seconds = time.perf_counter() - t0
        ps = load_ply(out)
    tool = {"rc": rc, "seconds": seconds, "vertices": len(ps.vertices),
            "faces": len(ps.faces), "input_faces": full["faces"]}
    log(f"simplify tool on the full mesh: {tool}")
    if rc != 0 or not 0 < tool["faces"] <= \
            SIMPLIFY_RATIO * full["faces"] + 2 or not tool["vertices"] > 0:
        raise RuntimeError(f"the simplify tool: {tool}")
    return {"full_opt_m": _summary(full), "m_y": _summary(simple),
            "simplify_tool": tool}


def _cli_quiet(argv: list) -> tuple:
    """The CLI on ``argv`` with its output captured: (rc, text, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def _groups(text: str) -> list:
    """The CLI's `Views [...] done` lines: (views, batched or sequential)."""
    return [([int(i) for i in g.split(",")], kind) for g, kind in re.findall(
        r"Views \[([\d, ]+)\] done in [\d.]+s \(\d+ neighbors, "
        r"(batched|sequential)\)", text)]


def _depths(path: str, name: str) -> dict:
    return {v.view_id: np.asarray(v.get_image(name))
            for v in sc.Scene.load(path).views}


RESULT_FIELDS = ("depth", "normals", "nodes", "node_valid", "patch_valid")


def _fields(r) -> tuple:
    """A DepthResult's tensors, in the order of RESULT_FIELDS."""
    s = r.surface
    return (r.depth, r.normals, s.nodes, s.node_valid, s.patch_valid)


def _snapshot(r) -> dict:
    """A copy on the host of a DepthResult's tensors and grid."""
    return {"tensors": [t.cpu() for t in _fields(r)],
            "grid": (r.surface.scale, r.surface.start_x, r.surface.start_y),
            "lighting": r.lighting}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN where NaN, -0.0 where -0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
    return torch.equal(a, b)


def _fresh(v):
    """A view without its cached blurs and shading images."""
    return dataclasses.replace(v, _scales={}, _shading=None)


@contextlib.contextmanager
def _captured_batches(store: list):
    """Record every `optimize_view_batch` call the CLI makes (its
    arguments and results) in ``store``."""
    real = VB.optimize_view_batch

    def spy(mains, subs_list, opts, **kw):
        results = real(mains, subs_list, opts, **kw)
        store.append({
            "mains": [_fresh(m) for m in mains],
            "subs_list": [[_fresh(v) for v in subs] for subs in subs_list],
            "opts": opts, "sgm_depths": kw.get("sgm_depths"),
            "results": [_snapshot(r) for r in results]})
        return results

    cli.VB.optimize_view_batch = spy
    try:
        yield
    finally:
        cli.VB.optimize_view_batch = real


def phase_cli_batch(captured: list) -> dict:
    """The CLI's view batching on 8 views of the DTU-scale camera grid
    (sizes alternating 1440 and 1280), with its defaults, then
    `--batch-views 1 -r --force --force-sgm` on a copy (the same SGM
    depths, in memory as in the first run); batched against sequential
    per view. The batched run's groups go to ``captured``."""
    dims = [BATCH_DIMS[i % 2] for i in range(BATCH_VIEWS)]
    scene = syn.make_dtu_scene(BATCH_VIEWS, dims)
    work = [(d + 1) // 2 for d in dims]  # input scale 1
    pixels = sum(d * d for d in work)
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        path, copy = os.path.join(root, "batched"), os.path.join(root, "seq")
        syn.save_as_mve_scene(scene, path)
        for label, where, flags in (("batch 4", path, []),
                                    ("batch 1", copy,
                                     ["--batch-views", "1", "-r", "--force",
                                      "--force-sgm"])):
            if where == copy:  # the SGM checkpoints of the first run
                shutil.copytree(path, copy)
            cuda_agg.reset_launches()
            host_reads.clear()
            torch.cuda.reset_peak_memory_stats()
            with _captured_batches(captured if where == path else []):
                rc, text, seconds = _cli_quiet([where, *flags])
            launches = dict(cuda_agg.launches)
            reads = dict(host_reads)
            log("\n".join(f"  cli {label}: " + line
                          for line in text.splitlines()))
            if rc != 0:
                raise RuntimeError(f"cli {label}: the CLI exited with {rc}")
            runs[label] = {
                "seconds": seconds,
                "stages": re.search(r"Stage seconds: (.*)", text).group(1),
                "groups": _groups(text), "launches": launches,
                "host_reads": reads,
                "kernel_launches": dict(cuda_agg.kernel_launches),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "input_scale": re.search(r"Automatic input scale: (\d+)",
                                         text).group(1)}
        ps = load_ply(os.path.join(path, "smvs-B1.ply"))
        bat, seq = _depths(path, "smvs-B1"), _depths(copy, "smvs-B1")
    b4, b1 = runs["batch 4"], runs["batch 1"]
    share = len(ps.vertices) / pixels
    err = fused_error(ps.vertices, scene)
    per_view = {}
    for i in sorted(bat):
        a, b = bat[i], seq[i]
        both = (a > 0) & (b > 0)
        drift = np.abs(a[both] - b[both]) / np.abs(b[both])
        per_view[i] = {"coverage_batched": float((a > 0).mean()),
                       "coverage_sequential": float((b > 0).mean()),
                       "coverage_gap": float(((a > 0) != (b > 0)).mean()),
                       "drift_share": float((drift > BATCH_DRIFT).mean()),
                       "max_rel_drift": float(drift.max())}
    out = {"dims": dims, "working_pixels": pixels,
           "points": len(ps.vertices), "points_per_pixel": share,
           "median_fused_rel_err": err, "per_view": per_view,
           "batch_4": b4, "batch_1": b1}
    log(f"cli view batching {BATCH_VIEWS} views {dims}: batch 4 "
        f"{b4['seconds']:.3f} s ({b4['stages']}), groups {b4['groups']}, "
        f"peak {b4['max_memory_allocated'] / 1e9:.3f} GB, host reads "
        f"{b4['host_reads']}; batch 1 -r {b1['seconds']:.3f} s "
        f"({b1['stages']}), groups {b1['groups']}, peak "
        f"{b1['max_memory_allocated'] / 1e9:.3f} GB, host reads "
        f"{b1['host_reads']}; "
        f"{len(ps.vertices)} points ({share:.4f} per working pixel), "
        f"median fused error {err:.4e}; launches {b4['launches']}; per "
        f"view {per_view}")
    if b4["input_scale"] != "1" or [k for _, k in b4["groups"]] != \
            ["batched", "batched"]:
        raise RuntimeError(f"cli batch 4: input scale {b4['input_scale']}, "
                           f"groups {b4['groups']}; expected scale 1 and "
                           "two batched groups")
    if sorted(i for g, _ in b4["groups"] for i in g) != list(range(8)) or \
            any(k != "sequential" for _, k in b1["groups"]) or \
            len(b1["groups"]) != BATCH_VIEWS:
        raise RuntimeError(f"cli batch groups: {b4['groups']} and "
                           f"{b1['groups']}")
    for row in ("fused_pass", "fused_pass_batch"):
        if b4["launches"][row] <= 0:
            raise RuntimeError(f"cli batch 4: no launch of {row}")
    if not share >= BATCH_MIN_POINT_SHARE:
        raise RuntimeError(f"cli batch 4: {share:.4f} points per working "
                           f"pixel < {BATCH_MIN_POINT_SHARE}")
    if not err <= BATCH_MAX_ERR:
        raise RuntimeError(f"cli batch 4: median fused error {err} > "
                           f"{BATCH_MAX_ERR}")
    for i, v in per_view.items():
        if not (v["coverage_gap"] < BATCH_MAX_COVERAGE_GAP
                and v["drift_share"] < BATCH_MAX_DRIFT_SHARE):
            raise RuntimeError(f"view {i}: batched and sequential depth "
                               f"maps apart: {v}")
        # Each batched reduction runs view by view as the sequential path
        # runs it, so the two depth maps are equal bit for bit; any
        # departure is a fault of the batched path.
        if v["coverage_gap"] != 0 or v["max_rel_drift"] != 0:
            raise RuntimeError(f"view {i}: batched and sequential depth "
                               f"maps not bit-equal: {v}")
    return out


def phase_deep(rows: dict) -> None:
    """Repeated shifts in rows 1 and 4, and every entry point at D > 128,
    bit-equal to plain with times; each kernel row gets a ``deep`` entry
    by D and rows 1 and 4 a ``repeated_shifts`` entry."""
    hw = DEEP_HW
    cost, inten = _seeded((hw, hw, 64), 555)
    g = torch.Generator(device="cuda").manual_seed(556)
    acc = torch.randint(0, 500, cost.shape, generator=g, device="cuda",
                        dtype=torch.int16)
    for loop, row in ((False, "fused_pass"), (True, "fused_pass_loop")):
        rep = {}
        for shifts in ((1, 1), (0, 1, 0)):
            cuda_agg.reset_launches()
            cuda_agg.fused_pass(cost, inten, acc, False, shifts, P1, P2,
                                loop=loop)
            if cuda_agg.launches[row] != len(shifts):
                raise RuntimeError(f"{row} {shifts}: {cuda_agg.launches}")
            rep[str(shifts)] = compare(
                f"{row} repeated shifts {shifts}",
                lambda: cuda_agg.fused_pass(cost, inten, acc, False, shifts,
                                            P1, P2, loop=loop),
                lambda: cuda_agg.plain_fused_pass_batch(
                    cost[None], inten[None], acc[None], False, shifts, P1,
                    P2)[0], acc_in=True)
            rep[str(shifts)]["launches"] = len(shifts)
        rows[row]["repeated_shifts"] = rep
    del cost, inten, acc

    for row in cuda_agg.ROWS:
        rows[row]["deep"] = {}
    for D in DEEP:
        cost, inten = _seeded((hw, hw, D), 600 + D)
        g = torch.Generator(device="cuda").manual_seed(700 + D)
        acc = torch.randint(0, 500, cost.shape, generator=g, device="cuda",
                            dtype=torch.int16)
        b2 = (cost[None], inten[None], acc[None])
        deep_launches = check_deep_launches(D, cost, inten,
                                            one_per_sweep=True)
        cases = {
            "fused_pass": (
                "aggregate_batch (planned launches)",
                lambda: cuda_agg.aggregate_batch(cost[None], inten[None],
                                                 P1, P2),
                lambda: cuda_agg.plain_aggregate_batch(cost[None],
                                                       inten[None], P1, P2),
                False, 2),
            "fused_pass_batch": (
                "fused_pass_batch (0,)",
                lambda: cuda_agg.fused_pass_batch(*b2, False, (0,), P1, P2),
                lambda: cuda_agg.plain_fused_pass_batch(*b2, False, (0,), P1,
                                                        P2), True, 2),
            "fused_pass_bidir": (
                "aggregate (planned launches)",
                lambda: cuda_agg.aggregate(cost, inten, P1, P2),
                lambda: cuda_agg.plain_aggregate(cost, inten, P1, P2),
                False, 2),
            "fused_pass_loop": (
                "fused_pass(loop=True) (0, 1, -1)",
                lambda: cuda_agg.fused_pass(cost, inten, acc, True,
                                            (0, 1, -1), P1, P2, loop=True),
                lambda: cuda_agg.plain_fused_pass_batch(
                    *b2, True, (0, 1, -1), P1, P2)[0], True, 2),
        }
        extra = {
            "fused_pass": (
                "fused_pass (0, 1, -1)",
                lambda: cuda_agg.fused_pass(cost, inten, acc, False,
                                            (0, 1, -1), P1, P2),
                lambda: cuda_agg.plain_fused_pass_batch(
                    *b2, False, (0, 1, -1), P1, P2)[0], True, 2),
            "fused_pass_bidir": (
                "fused_pass_bidir (0, 1, -1)",
                lambda: cuda_agg.fused_pass_bidir(cost, inten, acc,
                                                  (0, 1, -1), P1, P2),
                lambda: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                        (0, 1, -1), P1, P2),
                True, 2),
        }
        for row, (name, fn, plain, acc_in, elem) in cases.items():
            rows[row]["deep"][D] = {"aggregate" if "aggregate" in name
                                    else "sweep": compare(
                                        f"D = {D}: {name}", fn, plain,
                                        acc_in, elem)}
        for row, (name, fn, plain, acc_in, elem) in extra.items():
            rows[row]["deep"][D]["sweep"] = compare(
                f"D = {D}: {name}", fn, plain, acc_in, elem)
        for row in ("fused_pass", "fused_pass_bidir"):
            rows[row]["deep"][D]["launches"] = deep_launches[row]
        rows["fused_pass_bidir"]["deep"][D]["routes"] = routes_in_turns(
            D, cost, inten)
        cost32 = cost.to(torch.int32) * 300
        del cost, acc, b2
        rows["scan_direction"]["deep"][D] = {"sweep": compare(
            f"D = {D}: scan_direction shift 1",
            lambda: cuda_agg.scan_direction(cost32, inten, 1, P1, P2),
            lambda: cuda_agg.plain_scan_direction(cost32, inten, 1, P1, P2),
            False, 4)}
        del cost32, inten
    torch.cuda.empty_cache()
    rows["fused_pass_bidir"]["wide_general"] = phase_wide_general()
    rows["fused_pass"]["deepest"] = phase_deepest()


def phase_wide_general() -> dict:
    """`aggregate` at the general path's per-direction volume with 256
    planes, [1440, 1440, 256]: its launches held to the plan (one per
    sweep, 4, none of them `sgm_path_kernel`), and both routes in turns,
    bit-equal to plain on every run."""
    cost, inten = _seeded(WIDE_GEN_SHAPE, 1256)
    D = WIDE_GEN_SHAPE[2]
    res = {"shape": list(WIDE_GEN_SHAPE)}
    res["launches"] = check_deep_launches(D, cost, inten, one_per_sweep=True)
    res["routes"] = routes_in_turns(D, cost, inten)
    del cost, inten
    torch.cuda.empty_cache()
    return res


def check_deep_launches(D: int, cost, inten,
                        one_per_sweep: bool = False) -> dict:
    """`aggregate_batch` and `aggregate` on one [H, W, D] volume and
    `scan_direction` on its int32 costs, each with the launch counts set to
    0 just before and read just after, held to the launches
    `cuda_agg.plan_route` plans for the card (by row and by kernel): one
    launch per sweep where the card holds a problem's lines at once (4:
    `sgm_line_kernel` and `sgm_sweep3_kernel` up to 512 depths,
    `sgm_deep_sweep_kernel` beyond), otherwise one `sgm_path_kernel` or
    `sgm_deep_kernel` launch per path of a diagonal sweep; and 1 for
    `scan_direction`. ``one_per_sweep``: the two 8-path sums must also
    make exactly 4 launches, none of them a one-path-per-launch kernel's."""
    W = cost.shape[1]
    geo = cuda_agg.plan_geometry(cost)
    plans = {
        "fused_pass": cuda_agg.plan_route("aggregate_batch", 1, W, **geo),
        "fused_pass_bidir": cuda_agg.plan_route("aggregate", 1, W, **geo),
        "scan_direction": [cuda_agg.Launch(
            cuda_agg.path_kernel(D), 2, False, "write", (1,),
            "scan_direction", 0, 1)],
    }
    calls = {
        "fused_pass": lambda: cuda_agg.aggregate_batch(cost[None],
                                                       inten[None], P1, P2),
        "fused_pass_bidir": lambda: cuda_agg.aggregate(cost, inten, P1, P2),
        "scan_direction": lambda: cuda_agg.scan_direction(
            cost.to(torch.int32), inten, 1, P1, P2),
    }
    out = {}
    for row, fn in calls.items():
        want = (dict(collections.Counter(ln.row for ln in plans[row])),
                dict(collections.Counter(ln.kernel for ln in plans[row])))
        cuda_agg.reset_launches()
        fn()
        torch.cuda.synchronize()
        by_row = {k: v for k, v in cuda_agg.launches.items() if v}
        by_kernel = {k: v for k, v in cuda_agg.kernel_launches.items() if v}
        if (by_row, by_kernel) != want:
            raise RuntimeError(f"D = {D}: {row}'s path launched {by_row} "
                               f"by kernel {by_kernel}, not the planned "
                               f"{want}")
        if one_per_sweep and row != "scan_direction" and (
                sum(by_kernel.values()) != 4
                or {"path", "deep"} & set(by_kernel)):
            raise RuntimeError(f"D = {D}: {row}'s path launched "
                               f"{by_kernel}, not one launch per sweep")
        out[row] = {"rows": by_row, "kernels": by_kernel}
    log(f"D = {D}: launches {out}")
    return out


def routes_in_turns(D: int, cost, inten) -> dict:
    """`aggregate` on [H, W, D] through the plan's route and through the
    per-path route (`cuda_agg.per_path_plan`: one `sgm_path_kernel`, or
    beyond 512 depths `sgm_deep_kernel`, launch per path), in turns (plan,
    per path, per path, plan, ...), each run held bit-equal to plain;
    medians, and each plan's bytes floor (`cuda_agg.plan_bytes`)."""
    cost4, inten3 = cost[None], inten[None]
    plan = cuda_agg.plan_route("aggregate", 1, cost.shape[1],
                               **cuda_agg.plan_geometry(cost))
    plans = {"plan": plan, "per_path": cuda_agg.per_path_plan(plan, D)}
    want = cuda_agg.plain_aggregate(cost, inten, P1, P2).to(torch.int16)
    times = {k: [] for k in plans}
    for rep in range(2 * REPS + 2):
        k = ("plan", "per_path", "per_path", "plan")[rep % 4]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        got = cuda_agg.run_plan(
            plans[k], cost4, inten3, None, P1, P2,
            on_launch=lambda i, n=len(plans[k]): (
                events[0].record() if i == 0 else
                events[1].record() if i == n else None))
        events[1].synchronize()
        if not torch.equal(got[0], want):
            raise RuntimeError(f"D = {D}: aggregate on the {k} route "
                               "differs from the plain version")
        if rep >= 2:  # the first of each is a warm-up
            times[k].append(events[0].elapsed_time(events[1]))
        del got
    res = {f"{k}_ms": statistics.median(v) for k, v in times.items()}
    for k, p in plans.items():
        res[f"{k}_launches"] = len(p)
        res[f"{k}_floor_ms"] = (cuda_agg.plan_bytes(p, tuple(cost4.shape))
                                / PEAK_BYTES_PER_S * 1e3)
    log(f"D = {D}: aggregate on [{cost.shape[0]}, {cost.shape[1]}, {D}]: "
        f"plan {res['plan_ms']:.3f} ms ({len(plan)} launches, floor "
        f"{res['plan_floor_ms']:.3f} ms), per path {res['per_path_ms']:.3f}"
        f" ms ({res['per_path_launches']} launches, floor "
        f"{res['per_path_floor_ms']:.3f} ms), in turns, bit-equal on every "
        "run")
    return res


def phase_deepest() -> dict:
    """Every entry point at the plane limit (`cuda_agg.MAX_D` = 16384,
    `sgm_deep_kernel` with 32 warps a chain of 16 depths a lane) on a
    small volume, bit-equal to plain; one plane more raises before any
    launch."""
    cost, inten = _seeded(DEEP_MAX_SHAPE, 901)
    g = torch.Generator(device="cuda").manual_seed(902)
    acc = torch.randint(0, 500, cost.shape, generator=g, device="cuda",
                        dtype=torch.int16)
    b2 = (cost[None], inten[None], acc[None])
    D = cost.shape[-1]
    launches = check_deep_launches(D, cost, inten)
    res = {"shape": list(cost.shape), "launches": launches}
    for name, fn, plain, acc_in, elem in (
            ("aggregate_batch",
             lambda: cuda_agg.aggregate_batch(*b2[:2], P1, P2),
             lambda: cuda_agg.plain_aggregate_batch(*b2[:2], P1, P2),
             False, 2),
            ("aggregate", lambda: cuda_agg.aggregate(cost, inten, P1, P2),
             lambda: cuda_agg.plain_aggregate(cost, inten, P1, P2), False, 2),
            ("fused_pass_batch (0,)",
             lambda: cuda_agg.fused_pass_batch(*b2, True, (0,), P1, P2),
             lambda: cuda_agg.plain_fused_pass_batch(*b2, True, (0,), P1, P2),
             True, 2),
            ("fused_pass(loop=True)",
             lambda: cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1),
                                         P1, P2, loop=True),
             lambda: cuda_agg.plain_fused_pass_batch(
                 *b2, False, (0, 1, -1), P1, P2)[0], True, 2),
            ("fused_pass_bidir",
             lambda: cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1),
                                               P1, P2),
             lambda: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                     (0, 1, -1), P1, P2),
             True, 2)):
        res[name] = compare(f"D = {D}: {name}", fn, plain, acc_in, elem)
    cost32 = cost.to(torch.int32) * 300
    res["scan_direction"] = compare(
        f"D = {D}: scan_direction shift -1",
        lambda: cuda_agg.scan_direction(cost32, inten, -1, P1, P2),
        lambda: cuda_agg.plain_scan_direction(cost32, inten, -1, P1, P2),
        False, 4)
    over, _ = _seeded(DEEP_MAX_SHAPE[:2] + (D + 1,), 903)
    cuda_agg.reset_launches()
    try:
        cuda_agg.aggregate(over, inten, P1, P2)
    except ValueError as e:
        if str(cuda_agg.MAX_D) not in str(e) or \
                sum(cuda_agg.launches.values()):
            raise RuntimeError(f"D = {D + 1}: {e}; launches "
                               f"{cuda_agg.launches}") from e
        log(f"D = {D + 1} raises before any launch: {e}")
    else:
        raise RuntimeError(f"D = {D + 1} did not raise")
    return res


def _norms(g, H) -> tuple:
    return (float(torch.linalg.vector_norm(g.double())),
            float(torch.linalg.vector_norm(H.double())))


def shading_assembly_check(details: dict) -> dict:
    """One shading assembly of the flagship's final surface on the card
    and on the CPU (float64), from the same surface, lighting and
    visibility: a shading stage that silently dropped out or went wrong
    on the card would pass the error bounds of the whole run.

    The card assembles in float64, whose norms of g and H must equal the
    CPU's within rtol 1e-6 (the same arithmetic in another order), and in
    float32, the optimizer's precision, within rtol 0.1 of them: on this
    converged surface many shading residuals are far below the IRLS floor
    of 1e-4, where a weight 1/(1e-4 + |r|) turns float32 rounding of
    ~1e-7 into differences of a few 1e-3 in |g| and ~2e-2 in |H| (the CPU
    shows the same at dim 128, 8e-4 in |H|). The shading term itself moves
    H by a factor of ~1000, far beyond either bound."""
    res, main, subs = details["result"], details["main"], details["subs"]
    opts = details["opts"]
    surf = res.surface
    view = O._build_viewset(main, subs, surf.scale, torch.float32,
                            use_shading=True)
    surf, vis = O.compute_visibility(surf, view, None)
    act = surf.node_valid
    gopts = gn.GNOptions(regularization=opts.regularization,
                         light_surf_regularization=(
                             opts.light_surf_regularization))
    card32 = _norms(*gn.assemble(surf, view, vis, act, gopts, res.lighting))
    base = _norms(*gn.assemble(surf, view, vis, act, gopts))

    f64 = torch.float64

    def in_f64(device):
        views = [make_view(v.camera, v.image.cpu().numpy(), view_id=v.view_id,
                           device=device, dtype=f64) for v in (main, *subs)]
        s64 = dataclasses.replace(
            surf, nodes=surf.nodes.to(device, f64),
            node_valid=surf.node_valid.to(device),
            patch_valid=surf.patch_valid.to(device))
        v64 = O._build_viewset(views[0], views[1:], surf.scale, f64,
                               use_shading=True)
        return _norms(*gn.assemble(s64, v64, vis.to(device), act.to(device),
                                   gopts, res.lighting.to(device, f64)))

    card64, cpu = in_f64(surf.nodes.device), in_f64(torch.device("cpu"))
    out = {"scale": surf.scale, "card_float32_g_H": card32,
           "card_float64_g_H": card64, "cpu_float64_g_H": cpu,
           "card_float32_g_H_without_lighting": base}
    log(f"shading assembly at scale {surf.scale}: |g|, |H| card float32 "
        f"{card32[0]:.6e}, {card32[1]:.6e}; card float64 {card64[0]:.9e}, "
        f"{card64[1]:.9e}; CPU float64 {cpu[0]:.9e}, {cpu[1]:.9e}; card "
        f"float32 without the lighting {base[0]:.6e}, {base[1]:.6e}")
    for i, what in enumerate(("g", "H")):
        if not abs(card64[i] - cpu[i]) <= SHADING_F64_RTOL * cpu[i]:
            raise RuntimeError(f"the card's float64 shading assembly "
                               f"|{what}| {card64[i]:.9e} differs from the "
                               f"CPU's {cpu[i]:.9e}")
        if not abs(card32[i] - cpu[i]) <= SHADING_F32_RTOL * cpu[i]:
            raise RuntimeError(f"the card's float32 shading assembly "
                               f"|{what}| {card32[i]:.6e} differs from the "
                               f"CPU's float64 {cpu[i]:.6e}")
    if not abs(card32[1] - base[1]) > 0.5 * card32[1]:
        raise RuntimeError("the shading term does not move the system")
    return out


def phase_shading(details: dict) -> dict:
    """The flagship; ``details`` receives its `run_shading_once` details
    (result, views, options) for phase 18."""
    dim = 1440
    t0 = time.perf_counter()
    bench_main.run_shading_once(dim, 2, device="cuda")
    log(f"warm-up run_shading_once({dim}, 2): "
        f"{time.perf_counter() - t0:.1f} s")
    cuda_agg.reset_launches()
    t_sgm, t_opt, cov, err = bench_main.run_shading_once(
        dim, 2, device="cuda", details=details)
    launches = dict(cuda_agg.launches)
    mps = dim * dim / 1e6 / (t_sgm + t_opt)
    light = details["result"].lighting
    log(f"run_shading_once({dim}, 2): sgm {t_sgm:.3f} s, optimizer "
        f"{t_opt:.3f} s, {mps:.3f} MP/s, coverage {cov:.4f}, median_rel_err "
        f"{err:.3e}, kernel launches {launches}")
    if launches["fused_pass"] <= 0 or launches["fused_pass_batch"] <= 0:
        raise RuntimeError("the flagship did not launch the SGM kernels")
    if light is None or not bool(torch.isfinite(light).all()) or \
            not float(light[0]) > 0:
        raise RuntimeError(f"the fitted lighting is not usable: {light}")
    log("lighting: " + " ".join(f"{x:.4e}" for x in light.tolist()))
    if not cov >= SHADING_MIN_COVERAGE:
        raise RuntimeError(f"flagship coverage {cov:.4f} < "
                           f"{SHADING_MIN_COVERAGE}")
    if not err <= SHADING_MAX_ERR:
        raise RuntimeError(f"flagship median_rel_err {err:.3e} > "
                           f"{SHADING_MAX_ERR}")
    assembly = shading_assembly_check(details)
    # The optimizer's stage split, Newton steps and CG iterations per step,
    # with the device synchronized at each stage boundary.
    _, t_opt_sync, cov_s, err_s = bench_main.run_shading_once(
        dim, 2, device="cuda", sync_stages=True,
        log=lambda m: log("\n".join("  flagship: " + x
                                     for x in str(m).splitlines())))
    log(f"run_shading_once({dim}, 2) with synchronized stages: optimizer "
        f"{t_opt_sync:.3f} s, coverage {cov_s:.4f}, median_rel_err "
        f"{err_s:.3e}")
    return {"t_sgm": t_sgm, "t_opt": t_opt, "mps": mps, "coverage": cov,
            "median_rel_err": err, "launches": launches,
            "lighting": light.tolist(), "assembly": assembly}


def _dist_step_rank(rank: int, world: int, dev: torch.device, paths: list,
                    patch_axes: tuple) -> list:
    """Phase 15(a) on one rank: the sharded step of each saved problem on
    a (world // p, p) mesh per ``p``: shard, share, band, seconds, peak
    memory. The first problem's first step takes the process's one-time
    CUDA library set-up."""
    out = []
    for path in paths:
        data = torch.load(path, map_location=dev, weights_only=False)
        args = [data["batch"][k] for k in STEP_ARGS]
        for p in patch_axes:
            mesh = make_mesh(world, patch_axis=p, device=dev)
            step = viewbatch.training_step_fn(data["template"], gn.GNOptions(),
                                              mesh)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            shard = step(*args)
            torch.cuda.synchronize(dev)
            out.append({"path": path, "patch": p,
                        "seconds": time.perf_counter() - t0,
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(dev),
                        "share": view_share(args[0].shape[0], mesh),
                        "band": row_band(args[0].shape[1], mesh),
                        "shard": shard.cpu()})
    return out


def _dist_pipeline_rank(rank: int, world: int, dev: torch.device,
                        path: str) -> dict:
    """Phase 15(b) on one rank: `optimize_view_batch` over a (world, 1)
    mesh on the saved group; every view's result against the saved
    unsharded one."""
    data = torch.load(path, map_location=dev, weights_only=False)
    mesh = VB.make_view_mesh(world, patch_axis=1, device=dev)
    host_reads.clear()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = VB.optimize_view_batch(data["mains"], data["subs_list"],
                                 data["opts"], sgm_depths=data["sgm_depths"],
                                 mesh=mesh, device=dev)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    unequal = []  # (view, field) of every difference
    for i, (got, want) in enumerate(zip(out, data["results"])):
        s = got.surface
        unequal += [(i, f) for f, a, b in zip(RESULT_FIELDS, _fields(got),
                                              want["tensors"])
                    if not _same_bits(a, b)]
        if (s.scale, s.start_x, s.start_y) != want["grid"]:
            unequal.append((i, "grid"))
        if got.lighting is not None or want["lighting"] is not None:
            unequal.append((i, "lighting"))
    return {"share": view_share(len(out), mesh), "seconds": seconds,
            "host_reads": dict(host_reads), "unequal": unequal,
            "views": len(out),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def _tasks_rank(rank: int, world: int, dev: torch.device,
                tasks: list) -> list:
    """Several rank functions on one spawn of ranks, in turn, each as
    `launch.spawn` would run it alone; their results in order. A spawn
    costs its ranks' start (15-25 s on one card: the process, the imports,
    the first CUDA set-up), so the work of one world size shares one."""
    return [fn(rank, world, dev, *args) for fn, args in tasks]


def _dist_refs(root: str) -> tuple:
    """Phase 15(a)'s problems, saved under ``root`` for the ranks, and the
    single-process steps they are held to."""
    refs, paths, single = {}, [], {}
    for dim, scale in DIST_STEPS:
        template, batch = make_view_batch(4, dim=dim, scale=scale,
                                          device="cuda")
        args = [batch[k] for k in STEP_ARGS]
        step = viewbatch.batched_newton_step(template, gn.GNOptions())
        step(*args)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = step(*args)
        torch.cuda.synchronize()
        single[dim] = {"seconds": time.perf_counter() - t0,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated()}
        t64, b64 = make_view_batch(4, dim=dim, scale=scale,
                                   dtype=torch.float64, device="cuda")
        ref64 = viewbatch.batched_newton_step(t64, gn.GNOptions())(
            *(b64[k] for k in STEP_ARGS))
        path = os.path.join(root, f"step_{dim}.pt")
        torch.save({"template": template, "batch": batch}, path)
        paths.append(path)
        refs[path] = (dim, ref.cpu(), ref64.cpu(), batch["nodes"].cpu())
        del template, batch, args, ref, t64, b64, ref64
        torch.cuda.empty_cache()
    return refs, paths, single


def _dist_step_rows(refs: dict, outs: list) -> list:
    """Phase 15(a): each rank's shard of each mesh's step (``outs``, per
    rank) against the single-process step, within its bar."""
    rows = []
    world = len(outs)
    for rank, entries in enumerate(outs):
        for e in entries:
            dim, ref, ref64, nodes0 = refs[e["path"]]
            p = e["patch"]
            s, b = e["share"], e["band"]
            idx = (slice(s.start, s.stop), slice(b.start, b.stop))
            got, want, w64 = e["shard"], ref[idx], ref64[idx]
            diff = (got - want).abs()
            row = {"dim": dim, "mesh": (world // p, p), "rank": rank,
                   "views": list(s), "rows": [b.start, b.stop],
                   "seconds": e["seconds"],
                   "max_memory_allocated": e["max_memory_allocated"],
                   "max_abs_err": float(diff.max()),
                   "outside_jax_bar": float((diff > DIST_ATOL + DIST_RTOL
                                             * want.abs()).float().mean()),
                   "err_vs_f64": float((got.double() - w64).abs().max()),
                   "single_err_vs_f64":
                       float((want.double() - w64).abs().max()),
                   "update": float((got - nodes0[idx]).abs().max())}
            rows.append(row)
            log(f"  dist step {row}")
            if p == 1:
                if not torch.equal(got, want):
                    raise RuntimeError(f"dist step {row['mesh']}: not "
                                       "bit-equal to the single process")
                continue
            if not row["update"] > 0:
                raise RuntimeError(f"dist step: no update: {row}")
            if dim == DIST_STEPS[0][0]:
                ok = torch.allclose(got, want, rtol=DIST_RTOL,
                                    atol=DIST_ATOL)
            else:
                ok = row["err_vs_f64"] <= \
                    DIST_F64_RATIO * row["single_err_vs_f64"]
            if not ok:
                raise RuntimeError(f"dist step out of its bar: {row}")
    return rows


def _dist_pipeline_check(group: dict, outs: list) -> dict:
    """Phase 15(b): phase 14's batched 720^2 group over a (2, 1) mesh
    (``outs``, per rank), every view bit-equal to the unsharded batch."""
    out = {"views": [m.view_id for m in group["mains"]],
           "dims": list(group["mains"][0].image.shape),
           "ranks": [{**o, "share": list(o["share"])} for o in outs]}
    log(f"  dist pipeline: {out}")
    if [i for o in outs for i in o["share"]] != [0, 1, 2, 3]:
        raise RuntimeError(f"dist pipeline shares: {out}")
    for r, o in enumerate(outs):
        if o["views"] != 4 or o["unequal"]:
            raise RuntimeError(f"dist pipeline: rank {r} results not "
                               f"bit-equal to the unsharded batch: {out}")
    return out


def phase_dist(captured: list) -> dict:
    """Phase 15, the multi-device half, on ranks sharing this card: one
    spawn of 2 ranks runs (a) the step over meshes (2, 1) and (1, 2), (b)
    the pipeline over (2, 1) and (c) the scaling harness's 2-rank step;
    one of 4 ranks (a) over (2, 2); (c) at 1 rank spawns its own."""
    t0 = time.perf_counter()
    cuda_agg.reset_launches()
    with tempfile.TemporaryDirectory() as root:
        refs, paths, single = _dist_refs(root)
        group = next(g for g in captured
                     if [m.view_id for m in g["mains"]] == [0, 2, 4, 6])
        group_path = os.path.join(root, "group.pt")
        torch.save(group, group_path)
        spawn_seconds, outs = {}, {}
        for world, tasks in (
                (2, [(_dist_step_rank, (paths, (1, 2))),
                     (_dist_pipeline_rank, (group_path,)),
                     (scaling._step_rank, (2, DIST_SCALING_DIM, 5))]),
                (4, [(_dist_step_rank, (paths, (2,)))])):
            t1 = time.perf_counter()
            outs[world] = launch.spawn(
                _tasks_rank, world, backend="gloo", device="cuda",
                store_path=os.path.join(root, f"store_dist{world}"),
                args=(tasks,), timeout=DIST_TIMEOUT)
            spawn_seconds[world] = time.perf_counter() - t1
        out = {"step": {
            "single": single,
            "meshes": [r for world in (2, 4) for r in _dist_step_rows(
                refs, [o[0] for o in outs[world]])],
            "spawn_seconds": spawn_seconds},
            "pipeline": _dist_pipeline_check(group,
                                             [o[1] for o in outs[2]])}
    # (c): view-steps per second, as `scaling.measure` reckons them.
    thr = {1: scaling.measure(1, 2, dim=DIST_SCALING_DIM, steps=5,
                              backend="gloo", device="cuda"),
           2: 2 * 2 * 5 / max(o[2] for o in outs[2])}
    eff = thr[2] / (2 * thr[1])
    log(f"  dist scaling, make_view_batch(dim={DIST_SCALING_DIM}), 2 views "
        f"a rank, 5 steps: 1 rank {thr[1]:.2f} view-steps/s; 2 ranks "
        f"sharing one card {thr[2]:.2f} view-steps/s (efficiency {eff:.0%}:"
        " the two ranks share one card, so this measures sharing, not "
        "scaling)")
    out["scaling"] = {"view_steps_per_s": thr, "efficiency": eff,
                      "ranks_per_card": {n: n for n in thr}}
    out["launches_in_this_process"] = dict(cuda_agg.launches)
    out["seconds"] = time.perf_counter() - t0
    log(f"dist phase: {out['seconds']:.1f} s")
    return out


def _split_rank(rank: int, world: int, dev: torch.device, path: str,
                patch: int) -> dict:
    """Phase 16 (a)/(b) on one rank: `optimize_view_batch` over a
    (world // patch, patch) mesh on the saved problem under each saved
    option set: the depth maps, and the rank's seconds, peak memory,
    host read-backs, collectives and PCG iterations."""
    data = torch.load(path, map_location=dev, weights_only=False)
    mesh = VB.make_view_mesh(world, patch_axis=patch, device=dev)
    out = {"share": list(view_share(len(data["mains"]), mesh))}
    for name, opts in data["opts"].items():
        host_reads.clear()
        rows.collectives.clear()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = VB.optimize_view_batch(data["mains"], data["subs_list"], opts,
                                     sgm_depths=data["sgm_depths"],
                                     mesh=mesh, device=dev)
        torch.cuda.synchronize(dev)
        out[name] = _split_stats(time.perf_counter() - t0, dev)
        out[name]["depths"] = [r.depth.cpu() for r in res]
    return out


def _split_stats(seconds: float, dev) -> dict:
    """The optimize seconds, peak memory, read-backs and collectives of
    the run just ended, with the collectives per PCG iteration."""
    pcg = host_reads.get("cg", 0)
    return {"seconds": seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "host_reads": dict(host_reads),
            "collectives": dict(rows.collectives),
            "collectives_per_pcg_iteration":
                sum(rows.collectives.values()) / max(pcg, 1)}


def _split_spawn(root: str, name: str, problem: dict, world: int,
                 patch: int) -> tuple:
    """Save ``problem`` and run `_split_rank` on ``world`` ranks sharing
    the card, and on the same spawn (c), the dry run at ``world`` ranks
    (`dryrun_check`); every rank must hold the same bits of every depth
    map. Returns (per-rank outputs, seconds of the spawn)."""
    path = os.path.join(root, f"{name}.pt")
    torch.save(problem, path)
    t0 = time.perf_counter()
    both = launch.spawn(_tasks_rank, world, backend="gloo", device="cuda",
                        store_path=os.path.join(root, f"store_{name}"),
                        args=([(_split_rank, (path, patch)),
                               (dryrun._rank, ())],),
                        timeout=SPLIT_TIMEOUT)
    seconds = time.perf_counter() - t0
    outs = [o[0] for o in both]
    dryrun_check(world, [o[1] for o in both])
    for key in problem["opts"]:
        for r, o in enumerate(outs[1:], 1):
            for i, (a, b) in enumerate(zip(o[key]["depths"],
                                           outs[0][key]["depths"])):
                if not _same_bits(a, b):
                    raise RuntimeError(f"split {name} {key}: rank {r} holds "
                                       f"another depth map of view {i}")
    return outs, seconds


def dryrun_check(n: int, outs: list) -> None:
    """Phase 16(c): `dryrun.dryrun_multichip`'s checks on its ranks'
    outputs (each row's first rank has held its views to the sequential
    run's bars): every rank received rank 0's depth maps."""
    for r, o in enumerate(outs[1:], 1):
        for i, (a, b) in enumerate(zip(outs[0]["depths"], o["depths"])):
            if not torch.equal(a, b):
                raise RuntimeError(f"dry run on {n} ranks: rank {r} received "
                                   f"another depth map of view {i} than "
                                   "rank 0")
    log(f"  dryrun_multichip ok: {n} ranks, mesh={outs[0]['mesh']} "
        f"views={len(outs[0]['depths'])} "
        f"depth={tuple(outs[0]['depths'][0].shape)}")


def _per_rank(outs: list, key: str) -> list:
    return [{k: v for k, v in o[key].items() if k != "depths"}
            for o in outs]


def phase_split_main(root: str, details: dict) -> dict:
    """Phase 16(a): the main path's 1440^2 view over a (1, 2) mesh."""
    opts = {"fixed": dataclasses.replace(
                details["opts"], max_newton_steps=SPLIT_FIXED_STEPS,
                fixed_newton_steps=True),
            "defaults": details["opts"]}
    main, subs = _fresh(details["main"]), [_fresh(v) for v in
                                           details["subs"]]
    problem = {"mains": [main], "subs_list": [subs],
               "sgm_depths": [details["sgm_depth"]], "opts": opts}
    unsharded = {}
    for key, o in opts.items():
        host_reads.clear()
        rows.collectives.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = VB.optimize_view_batch([main], [subs], o,
                                     sgm_depths=[details["sgm_depth"]],
                                     device="cuda")
        torch.cuda.synchronize()
        unsharded[key] = _split_stats(time.perf_counter() - t0, None)
        unsharded[key]["depth"] = res[0].depth.cpu().numpy()
    outs, seconds = _split_spawn(root, "main", problem, 2, 2)
    gt = details["gt"]
    out = {"mesh": [1, 2], "spawn_seconds": seconds}
    for key in opts:
        got = outs[0][key]["depths"][0].numpy()
        want = unsharded[key].pop("depth")
        both = (got > 0) & (want > 0)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
        cov = float((got > 0).mean())
        err = float(np.median(np.abs(got[got > 0] - gt[got > 0])
                              / gt[got > 0]))
        out[key] = {"ranks": _per_rank(outs, key),
                    "unsharded": unsharded[key],
                    "coverage": cov, "median_rel_err": err,
                    "coverage_unsharded": float((want > 0).mean()),
                    "mask_flips": float(((got > 0) != (want > 0)).mean()),
                    "drift_share": float((rel[both] > 2e-4).mean()),
                    "max_rel_drift": float(rel[both].max())}
        log(f"  split (a) {key}: {out[key]}")
        if key == "fixed":
            out[key]["bars"] = check_bars(got, want, "split (a) fixed steps")
        elif not (cov >= 0.84 and err <= 1e-4):
            raise RuntimeError(f"split (a) defaults: coverage {cov:.4f}, "
                               f"median_rel_err {err:.3e}; the main path's "
                               "bar is 0.84 and 1e-4")
    return out


def _median_err(depth: np.ndarray, gt: np.ndarray) -> float:
    """Median relative error of a depth map's covered pixels within the
    analytic depth's extent (the working view's; the canvas pads it)."""
    d = depth[:gt.shape[0], :gt.shape[1]]
    m = d > 0
    return float(np.median(np.abs(d[m] - gt[m]) / gt[m]))


def phase_split_batch(root: str, captured: list) -> dict:
    """Phase 16(b): phase 14's four 720^2 views over a (2, 2) mesh."""
    group = next(g for g in captured
                 if [m.view_id for m in g["mains"]] == [0, 2, 4, 6])
    problem = {k: group[k] for k in ("mains", "subs_list", "sgm_depths")}
    problem["opts"] = {"defaults": group["opts"]}
    outs, seconds = _split_spawn(root, "batch", problem, 4, 2)
    # The analytic depths of the working views (input scale 1).
    gts = syn.make_dtu_scene(BATCH_VIEWS, [(BATCH_DIMS[i % 2] + 1) // 2
                                           for i in range(BATCH_VIEWS)]
                             ).depths
    per_view = {}
    for i, (got, want) in enumerate(zip(outs[0]["defaults"]["depths"],
                                        group["results"])):
        a, b = got.numpy(), want["tensors"][0].numpy()
        gt = gts[group["mains"][i].view_id]
        both = (a > 0) & (b > 0)
        drift = np.abs(a[both] - b[both]) / np.abs(b[both])
        per_view[i] = {"coverage_gap": float(((a > 0) != (b > 0)).mean()),
                       "drift_share": float((drift > BATCH_DRIFT).mean()),
                       "max_rel_drift": float(drift.max()),
                       "median_rel_err": _median_err(a, gt),
                       "median_rel_err_unsharded": _median_err(b, gt)}
    out = {"mesh": [2, 2], "views": [m.view_id for m in group["mains"]],
           "dims": list(group["mains"][0].image.shape),
           "spawn_seconds": seconds, "per_view": per_view,
           "ranks": _per_rank(outs, "defaults"),
           "shares": [o["share"] for o in outs]}
    log(f"  split (b): {out}")
    for i, v in per_view.items():
        if not (v["coverage_gap"] < BATCH_MAX_COVERAGE_GAP
                and v["median_rel_err"] <= SPLIT_ERR_RATIO
                * v["median_rel_err_unsharded"]):
            raise RuntimeError(f"split (b) view {i}: apart from the "
                               f"unsharded batch: {v}")
    return out


def phase_split(details: dict, captured: list) -> dict:
    """Phase 16, the row-split pipeline, on gloo ranks sharing this card."""
    t0 = time.perf_counter()
    cuda_agg.reset_launches()
    with tempfile.TemporaryDirectory() as root:
        out = {"main": phase_split_main(root, details),
               "batch": phase_split_batch(root, captured)}
    # (c) ran on (a)'s 2 ranks and (b)'s 4.
    out["dryrun"] = {n: {"mesh": [n // dryrun.patch_axis(n),
                                  dryrun.patch_axis(n)],
                         "spawn_seconds": out[k]["spawn_seconds"]}
                     for n, k in ((2, "main"), (4, "batch"))}
    out["launches_in_this_process"] = dict(cuda_agg.launches)
    out["seconds"] = time.perf_counter() - t0
    log(f"split phase: {out['seconds']:.1f} s; dry runs {out['dryrun']}")
    return out


def _rows_launched(label: str, launches: dict) -> None:
    if launches["fused_pass"] <= 0 or launches["fused_pass_batch"] <= 0:
        raise RuntimeError(f"{label}: no launch of kernel rows 1-2: "
                           f"{launches}")


def _against_jax_cpu(label: str, res: dict, ref: tuple, record: tuple
                     ) -> dict:
    """Phase 17's bar for a driver's coverage and median relative error
    against the JAX driver's on the CPU; the TPU record beside it."""
    cov, err = res["coverage"], res["median_rel_err"]
    bar = {"min_coverage": DRIVER_MIN_COV_SHARE * ref[0],
           "max_err": DRIVER_MAX_ERR_FACTOR * ref[1],
           "jax_cpu": list(ref), "jax_tpu_record": list(record)}
    log(f"{label}: coverage {cov}, median_rel_err {err}; bar {bar}")
    if not (cov >= bar["min_coverage"] and err <= bar["max_err"]):
        raise RuntimeError(f"{label}: coverage {cov}, median_rel_err {err}; "
                           f"the bar is {bar}")
    return bar


def phase_bench() -> dict:
    """Phase 17(a): the `bench.py` driver at 1440, one pass after its
    warm-up (each about 14 s: run_once and the flagship)."""
    cuda_agg.reset_launches()
    res = bench_driver.run(dim=1440, min_scale=2, passes=BENCH_PASSES,
                           device="cuda")
    launches = dict(cuda_agg.launches)
    _rows_launched("bench", launches)
    for key, (min_cov, max_err) in (("base", (0.84, 1e-4)),
                                    ("shading_flagship", (0.85, 1e-2))):
        r = res[key]
        log(f"bench {key}: {r}")
        if not (r["coverage"] >= min_cov and r["median_rel_err"] <= max_err):
            raise RuntimeError(f"bench {key}: {r}; the bar is coverage >= "
                               f"{min_cov}, median_rel_err <= {max_err}")
    return {"result": res, "launches": launches}


def phase_bench_scene() -> dict:
    """Phase 17(b): the `bench_scene.py` driver at its defaults."""
    cuda_agg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = bench_scene.run(device="cuda")
    launches = dict(cuda_agg.launches)
    _rows_launched("bench_scene", launches)
    bar = _against_jax_cpu("bench_scene", res, SCENE_JAX_CPU,
                           SCENE_TPU_RECORD)
    return {"result": res, "launches": launches, "bar": bar,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_bench_dtu() -> dict:
    """Phase 17(c): the `bench_dtu.py` driver on 10 views at scale 0 in a
    fresh directory, cold then warm."""
    cuda_agg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as root:
        res = bench_dtu.run(n_views=DTU_VIEWS, dim1=1440, dim2=1280,
                            scene_dir=os.path.join(root, "dtu"),
                            device="cuda")
    launches = dict(cuda_agg.launches)
    _rows_launched("bench_dtu", launches)
    bar = _against_jax_cpu("bench_dtu", res, DTU_JAX_CPU, DTU_TPU_RECORD)
    return {"result": res, "launches": launches, "bar": bar,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase_cost_interp() -> dict:
    """Phase 17(d): run_once's rectified SGM at 1440 with cost_interp."""
    dim = 1440
    slope = 0.005 * 460.0 / dim
    scene = syn.make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    main = torch.as_tensor(scene.images[1], device="cuda") * 255.0
    nbr = torch.as_tensor(scene.images[0], device="cuda") * 255.0
    gt = scene.depths[1]

    def sgm(interp: bool):
        t0 = time.perf_counter()
        depth = stereo.reconstruct_auto(
            scene.cameras[1], scene.cameras[0], main, nbr, (3.5, 9.5),
            (3.5, 9.5), stereo.SGMOptions(cost_interp=interp),
            device="cuda")
        torch.cuda.synchronize()
        return depth.cpu().numpy(), time.perf_counter() - t0

    # The kernel rows on the cost-interpolated volume against plain.
    checked = []
    real = cuda_agg.aggregate_batch

    def against_plain(cost, inten, p1, p2):
        got = real(cost, inten, p1, p2)
        want = cuda_agg.plain_aggregate_batch(cost, inten, p1, p2)
        checked.append(int((got.to(torch.int64) - want.to(torch.int64))
                           .abs().max()))
        return got

    cuda_agg.aggregate_batch = against_plain
    try:
        sgm(True)
    finally:
        cuda_agg.aggregate_batch = real
    if checked != [0]:
        raise RuntimeError(f"cost_interp: aggregate_batch against plain: "
                           f"max abs differences {checked}")
    sgm(False)  # warm-up of the default cost
    times = {False: [], True: []}
    launches = None
    for interp in (False, True, True, False):
        cuda_agg.reset_launches()
        depth, seconds = sgm(interp)
        times[interp].append(seconds)
        if interp:
            launches = dict(cuda_agg.launches)
            interp_depth = depth
        else:
            default_depth = depth
    _rows_launched("cost_interp", launches)
    out = {"launches": launches, "aggregate_batch_max_abs_err": checked[0],
           "t_sgm_default": times[False], "t_sgm_cost_interp": times[True]}
    for key, depth in (("default", default_depth),
                       ("cost_interp", interp_depth)):
        m = depth > 0
        out[key] = {"coverage": float(m.mean()), "median_rel_err": float(
            np.median(np.abs(depth[m] - gt[m]) / gt[m]))}
    log(f"cost_interp: {out}")
    c = out["cost_interp"]
    if not (c["coverage"] >= COST_INTERP_MIN_COVERAGE
            and c["median_rel_err"] <= COST_INTERP_MAX_ERR):
        raise RuntimeError(f"cost_interp SGM depth: {c}; the bar is "
                           f"coverage >= {COST_INTERP_MIN_COVERAGE}, median "
                           f"relative error <= {COST_INTERP_MAX_ERR}")
    return out


def phase_debug_cli() -> dict:
    """Phase 17(e): the CLI with -d 2 -S on views 0 and 1 (`-l 0-1`) of 4
    plane views of 320^2 (each view about 7 s, run alone)."""
    scene = syn.make_plane_scene(n_views=4, dim=DEBUG_DIM)
    with tempfile.TemporaryDirectory() as path:
        syn.save_as_mve_scene(scene, path)
        res = run_cli("cli -d 2 -S", path, scene,
                      ("-d", "2", "-S", "-l", DEBUG_VIEWS), "smvs-S0.ply",
                      ("fused_pass", "fused_pass_batch"))
        views = [v for v in sc.Scene.load(path).views
                 if v.view_id in cli.parse_view_list(DEBUG_VIEWS, 4)]
        for v in views:
            for name in (*DEBUG_IMAGES, "smvs-S0"):
                if not v.has_embedding(name):
                    raise RuntimeError(f"cli -d 2 -S: view {v.view_id} has "
                                       f"no {name}")
                if not np.isfinite(np.asarray(v.get_image(name))).all():
                    raise RuntimeError(f"cli -d 2 -S: view {v.view_id}'s "
                                       f"{name} is not finite")
    groups = _groups(res["text"])
    if not groups or any(kind != "sequential" for _, kind in groups):
        raise RuntimeError(f"cli -d 2 -S: groups {groups}; -d 2 runs every "
                           "view alone")
    out = _summary(res)
    out["groups"] = groups
    out["views"] = len(views)
    return out


def phase_drivers() -> dict:
    """Phase 17: the benchmark drivers, cost_interp and -d 2 -S."""
    t0 = time.perf_counter()
    out = {}
    for key, phase in (("bench", phase_bench),
                       ("bench_scene", phase_bench_scene),
                       ("bench_dtu", phase_bench_dtu),
                       ("cost_interp", phase_cost_interp),
                       ("cli_debug", phase_debug_cli)):
        t1 = time.perf_counter()
        out[key] = phase()
        out[key]["phase_seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    log(f"drivers phase: {out['seconds']:.1f} s")
    return out


def _scaled_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _timed_assembly(surf, view, vis, act, gopts, light) -> dict:
    """One assembly's (g, H), its peak device memory above what was
    allocated before it, and the median seconds of ORACLE_REPS more, each
    between two synchronizes."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g, H = gn.assemble(surf, view, vis, act, gopts, light)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    if g.device.type != "cuda" or H.device.type != "cuda":
        raise RuntimeError(f"the assembly left the card: {g.device}")
    times = []
    for _ in range(ORACLE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gn.assemble(surf, view, vis, act, gopts, light)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"g": g, "H": H, "ms": 1e3 * statistics.median(times),
            "peak_mib": peak / 2**20}


def oracle_check(label: str, details: dict, card: str) -> dict:
    """Phase 18 on one final surface: the analytic assembly and the
    autodiff oracle (`GNOptions(analytic=False)`) on the card, in float64
    (the view set rebuilt in float64, as `shading_assembly_check` does)
    and in float32 with the optimizer's bf16 view set, from the same
    surface, visibility and lighting."""
    res, main, subs = details["result"], details["main"], details["subs"]
    opts, light = details["opts"], details["result"].lighting
    shading = light is not None
    surf = res.surface
    view32 = O._build_viewset(main, subs, surf.scale, torch.float32,
                              bf16_gather=opts.bf16_gather,
                              use_shading=shading)
    surf, vis = O.compute_visibility(surf, view32, None)
    act = surf.node_valid
    f64 = torch.float64
    dev = surf.nodes.device
    views = [make_view(v.camera, v.image.cpu().numpy(), view_id=v.view_id,
                       device=dev, dtype=f64) for v in (main, *subs)]
    view64 = O._build_viewset(views[0], views[1:], surf.scale, f64,
                              use_shading=shading)
    surf64 = dataclasses.replace(surf, nodes=surf.nodes.to(f64))
    analytic = gn.GNOptions(regularization=opts.regularization,
                            light_surf_regularization=(
                                opts.light_surf_regularization))
    oracle = dataclasses.replace(analytic, analytic=False)
    runs = {}
    for prec, s, v, lt in (
            ("float64", surf64, view64, light.to(f64) if shading else None),
            ("float32", surf, view32, light)):
        for path, gopts in (("analytic", analytic), ("oracle", oracle)):
            runs[prec, path] = _timed_assembly(s, v, vis, act, gopts, lt)
    ref = _norms(runs["float64", "oracle"]["g"], runs["float64", "oracle"]["H"])
    out = {"label": label, "card": card, "scale": surf.scale,
           "patches": int(surf.patch_valid.sum()),
           "neighbors": len(subs), "shading": shading,
           "sub_gh": str(view32.sub_gh.dtype), "reps": ORACLE_REPS}
    for prec in ("float64", "float32"):
        an, orc = runs[prec, "analytic"], runs[prec, "oracle"]
        out[prec] = {
            "scaled_diff_g": _scaled_diff(an["g"], orc["g"]),
            "scaled_diff_H": _scaled_diff(an["H"], orc["H"]),
            "analytic_ms": an["ms"], "oracle_ms": orc["ms"],
            "analytic_peak_mib": an["peak_mib"],
            "oracle_peak_mib": orc["peak_mib"],
            "analytic_g_H_norms": _norms(an["g"], an["H"]),
            "oracle_g_H_norms": _norms(orc["g"], orc["H"])}
    log(f"oracle on {label} (scale {surf.scale}, {out['patches']} patches, "
        f"{len(subs)} neighbors, shading {shading}), {card}: "
        + "; ".join(f"{p}: scaled |dg| {out[p]['scaled_diff_g']:.3e}, "
                    f"|dH| {out[p]['scaled_diff_H']:.3e}, analytic "
                    f"{out[p]['analytic_ms']:.2f} ms "
                    f"({out[p]['analytic_peak_mib']:.1f} MiB), oracle "
                    f"{out[p]['oracle_ms']:.2f} ms "
                    f"({out[p]['oracle_peak_mib']:.1f} MiB)"
                    for p in ("float64", "float32")))
    f64r = out["float64"]
    if not (f64r["scaled_diff_g"] <= ORACLE_F64_BAR
            and f64r["scaled_diff_H"] <= ORACLE_F64_BAR):
        raise RuntimeError(f"{label}: the float64 analytic assembly departs "
                           f"from the oracle: {f64r}")
    for path in ("analytic", "oracle"):
        got = out["float32"][f"{path}_g_H_norms"]
        for i, what in enumerate(("g", "H")):
            if not abs(got[i] - ref[i]) <= ORACLE_F32_RTOL * ref[i]:
                raise RuntimeError(
                    f"{label}: the float32 {path} assembly's |{what}| "
                    f"{got[i]:.6e} is not within {ORACLE_F32_RTOL} of the "
                    f"float64 oracle's {ref[i]:.6e}")
    return out


def phase_oracle(main_details: dict, shading_details: dict,
                 card: str) -> dict:
    """Phase 18: the oracle on run_once's and the flagship's final
    surfaces."""
    t0 = time.perf_counter()
    out = {"run_once": oracle_check("bench_main.run_once(1440, 2)",
                                    main_details, card),
           "flagship": oracle_check("bench_main.run_shading_once(1440, 2)",
                                    shading_details, card)}
    out["seconds"] = time.perf_counter() - t0
    log(f"oracle phase: {out['seconds']:.1f} s")
    return out


def wide_kernel_entry(rows: dict, general: dict) -> dict:
    """The kernels line's entry of the 129-512 route (`sgm_line_kernel`
    and `sgm_sweep3_kernel` at 8 and 16 depths a lane), timed on phase 9's
    `aggregate` at [640, 640, 256] against the per-path route in turns;
    its launches are those of phase 6's general-warp `reconstruct` with
    256 planes (counts reset just before, read just after)."""
    deep = rows["fused_pass_bidir"]["deep"][WIDE_TIMED_D]
    routes = deep["routes"]
    wide_general = rows["fused_pass_bidir"]["wide_general"]
    run = general[WIDE_TIMED_D]
    return {
        "name": "sgm_line_kernel + sgm_sweep3_kernel via aggregate at "
                f"D = {WIDE_TIMED_D}",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES["fused_pass_bidir"][0],
        "tpu_kernel": "every row at 129 <= D <= 512 (here row 3, "
                      + REPLACES["fused_pass_bidir"][1] + ")",
        "launches": run["kernels"].get("line", 0)
        + run["kernels"].get("sweep3", 0),
        "path": f"stereo.reconstruct(1440) with SGMOptions(num_steps="
                f"{WIDE_TIMED_D}): general-warp SGM; timed on aggregate on "
                f"[{DEEP_HW}, {DEEP_HW}, {WIDE_TIMED_D}], "
                f"{routes['plan_launches']} launches",
        "max_abs_err": deep["aggregate"]["max_abs_err"],
        "ms": routes["plan_ms"],
        "plain_ms": deep["aggregate"]["plain_ms"],
        "bound_ms": deep["aggregate"]["bound_ms"],
        "bound_by": deep["aggregate"]["bound_by"],
        "library_ms": None,
        "shape": deep["aggregate"]["shape"],
        "bytes_floor_ms": routes["plan_floor_ms"],
        "per_path_ms": routes["per_path_ms"],
        "per_path_floor_ms": routes["per_path_floor_ms"],
        "by_depth": {D: {k: rows["fused_pass_bidir"]["deep"][D]["routes"][k]
                         for k in ("plan_ms", "per_path_ms")}
                     for D in DEEP if D <= cuda_agg.PATH_MAX_D},
        "general_1440": {k: wide_general["routes"][k]
                         for k in ("plan_ms", "per_path_ms", "plan_launches",
                                   "per_path_launches")},
        "reconstruct": run,
    }


def row5_by_shape(rows: dict) -> dict:
    """Row 5's times beside their bounds at every shape this run timed it:
    [1440, 1440, 128] with shifts 0, 1 and -1 (phase 4) and [640, 640, D]
    with shift 1 (phase 9; `sgm_deep_kernel` beyond 512 depths)."""
    r = rows["scan_direction"]
    runs = {f"{GEN_SHAPE} shift {s}": (v, "sgm_path_kernel")
            for s, v in r["shifts"].items()}
    runs.update({f"({DEEP_HW}, {DEEP_HW}, {D}) shift 1": (
        r["deep"][D]["sweep"], cuda_agg.KERNELS[cuda_agg.path_kernel(D)])
        for D in DEEP})
    return {k: {"kernel": kernel, "ms": v["ms"], "bound_ms": v["bound_ms"],
                "share_of_bound": v["bound_ms"] / v["ms"],
                "bit_equal_runs": v["bit_equal_runs"]}
            for k, (v, kernel) in runs.items()}


def deep_kernel_times(rows: dict) -> dict:
    """sgm_deep_kernel's own times from phase 9: row 5 (`scan_direction`,
    int32, shift 1, one launch) at [640, 640, D] for D in DEEP_KERNEL_D,
    and `aggregate` on the per-path route (8 launches) at the first D,
    each beside its bound (for the per-path route the 8-path sum's bound
    and the plan's bytes floor)."""
    out = {"row5": {}}
    for D in DEEP_KERNEL_D:
        r = rows["scan_direction"]["deep"][D]["sweep"]
        out["row5"][D] = {"ms": r["ms"], "bound_ms": r["bound_ms"],
                          "share_of_bound": r["bound_ms"] / r["ms"],
                          "launches": 1}
    D = DEEP_KERNEL_D[0]
    deep = rows["fused_pass_bidir"]["deep"][D]
    out[f"per_path_{D}"] = {
        "ms": deep["routes"]["per_path_ms"],
        "launches": deep["routes"]["per_path_launches"],
        "bound_ms": deep["aggregate"]["bound_ms"],
        "bytes_floor_ms": deep["routes"]["per_path_floor_ms"]}
    log(f"sgm_deep_kernel: row 5 "
        + ", ".join(f"D = {D}: {v['ms']:.3f} ms (bound {v['bound_ms']:.4f})"
                    for D, v in out["row5"].items())
        + f"; per-path aggregate D = {D}: "
        f"{out[f'per_path_{D}']['ms']:.3f} ms (floor "
        f"{out[f'per_path_{D}']['bytes_floor_ms']:.3f})")
    return out


def deep_kernel_entries(rows: dict) -> list:
    """The kernels line's entries of the two deep kernels, from phase 9's
    results in ``rows``. No user path sets more than 512 planes.
    sgm_deep_sweep_kernel's launches are those of phase 9's `aggregate` at
    the timed depth (its plan: one launch per sweep); sgm_deep_kernel's
    those of `aggregate` at the plane limit, whose diagonal sweeps the card
    cannot hold at once (one launch per path). Both are timed on
    `aggregate` at the timed depth, sgm_deep_kernel through the per-path
    route, in turns; sgm_deep_kernel's entry also gives row 5 at
    [640, 640, D] for D in DEEP_KERNEL_D and the per-path route at the
    first, each beside its bound."""
    entries = []
    deep = rows["fused_pass_bidir"]["deep"][DEEP_TIMED_D]
    routes = deep["routes"]
    deepest = rows["fused_pass"]["deepest"]["launches"]["fused_pass_bidir"]
    for name, launches, path, ms, extra in (
            ("sgm_deep_sweep_kernel",
             deep["launches"]["kernels"]["deep_sweep"],
             f"aggregate on [{DEEP_HW}, {DEEP_HW}, {DEEP_TIMED_D}], "
             f"{routes['plan_launches']} launches (tests only: no user "
             "path sets more than 512 planes)", routes["plan_ms"],
             {"bytes_floor_ms": routes["plan_floor_ms"],
              "per_path_ms": routes["per_path_ms"]}),
            ("sgm_deep_kernel", deepest["kernels"]["deep"],
             f"aggregate on {list(DEEP_MAX_SHAPE)} (its diagonal sweeps, "
             "one launch per path; tests only); timed on the per-path "
             f"route of aggregate on [{DEEP_HW}, {DEEP_HW}, "
             f"{DEEP_TIMED_D}], {routes['per_path_launches']} launches",
             routes["per_path_ms"],
             {"bytes_floor_ms": routes["per_path_floor_ms"],
              **deep_kernel_times(rows)})):
        entries.append({
            "name": f"{name} via aggregate at D = {DEEP_TIMED_D}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES["fused_pass_bidir"][0],
            "tpu_kernel": "every row at D > 512 (here row 3, "
                          + REPLACES["fused_pass_bidir"][1] + ")",
            "launches": launches,
            "path": path,
            "max_abs_err": deep["aggregate"]["max_abs_err"],
            "ms": ms,
            "plain_ms": deep["aggregate"]["plain_ms"],
            "bound_ms": deep["aggregate"]["bound_ms"],
            "bound_by": deep["aggregate"]["bound_by"],
            "library_ms": None,
            "shape": deep["aggregate"]["shape"],
            **extra,
        })
    return entries


def main() -> int:
    set_cuda_precision()
    start = last = time.perf_counter()
    phase_seconds = {}

    def lap(name: str) -> None:
        """Logs the seconds of the phase that just ended, and the run's."""
        nonlocal last
        now = time.perf_counter()
        phase_seconds[name] = now - last
        log(f"phase {name}: {now - last:.1f} s (run {now - start:.1f} s)")
        last = now

    device, card = phase_card()
    phase_build()
    lap("1-2 card, build")
    rows = phase_kernel_rectified()
    rows.update(phase_kernel_general())
    rows["fused_pass"]["wide_problem"] = phase_wide()
    lap("3-4 kernel rows")
    main_details = {}
    main_launches = phase_main(main_details)
    lap("5 run_once")
    general = {p: phase_general(p) for p in GENERAL_PLANES}
    lap("6 general-warp SGM")
    phase_cli("cli", None, CLI_MIN_POINT_SHARE, CLI_MAX_ERR,
              ("fused_pass", "fused_pass_batch"))
    lap("7 cli")
    with aggregate_shapes() as shapes:
        forward = phase_cli("cli forward", syn.forward_cameras(),
                            FORWARD_MIN_POINT_SHARE, FORWARD_MAX_ERR,
                            ("fused_pass_bidir",))
    log(f"cli forward: aggregate took {dict(collections.Counter(shapes))} "
        f"({len(shapes)} calls); {forward['fused_pass_bidir']} row-3 "
        f"launches, 3 a call ({4 * len(shapes)} at 4 a call before the "
        "two-walk form)")
    if forward["fused_pass_bidir"] != 3 * len(shapes):
        raise RuntimeError("cli forward: not 3 row-3 launches an aggregate")
    lap("8 cli forward")
    phase_deep(rows)
    lap("9 kernels beyond 128 planes")
    shading_details = {}
    shading = phase_shading(shading_details)
    lap("10 flagship")
    shading_cli = phase_cli("cli -S", None, SHADING_CLI_MIN_POINT_SHARE,
                            SHADING_CLI_MAX_ERR,
                            ("fused_pass", "fused_pass_batch"), flags=("-S",))
    lap("11 cli -S")
    color_cli = phase_cli_color()
    lap("12 cli color")
    mesh_cli = phase_cli_mesh()
    lap("13 cli mesh")
    captured = []
    batch_cli = phase_cli_batch(captured)
    lap("14 view batching")
    dist = phase_dist(captured)
    lap("15 multi-device")
    split = phase_split(main_details, captured)
    lap("16 row split")
    del captured
    drivers = phase_drivers()
    lap("17 drivers")
    oracle = phase_oracle(main_details, shading_details, card)
    lap("18 oracle")
    del main_details, shading_details
    main_path = "bench_main.run_once(1440, 2): rectified SGM"
    path_launches = {  # (path, launches on it)
        "fused_pass": (main_path, main_launches["fused_pass"]),
        "fused_pass_batch": (main_path, main_launches["fused_pass_batch"]),
        "fused_pass_bidir": ("CLI on the forward-motion scene: general-warp"
                             " SGM", forward["fused_pass_bidir"]),
        "fused_pass_loop": (None, 0),  # tests only: no user path
        "scan_direction": (None, 0),  # tests only: no user path
    }
    flagship = "bench_main.run_shading_once(1440, 2): rectified SGM of 2 pairs"
    for row in ("fused_pass", "fused_pass_batch"):
        rows[row]["other_paths"] = {flagship: shading["launches"][row],
                                    "CLI -S on 4 x 1280^2": shading_cli[row]}
    kernels = []
    for row in cuda_agg.ROWS:
        r = rows[row]
        kernels.append({
            "name": f"{KERNEL[row]} via {row}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[row][0],
            "tpu_kernel": REPLACES[row][1],
            "launches": path_launches[row][1],
            "path": path_launches[row][0],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
        })
    kernels[-1]["by_shape"] = row5_by_shape(rows)
    kernels.append(wide_kernel_entry(rows, general))
    kernels += deep_kernel_entries(rows)
    print(json.dumps({"flagship": shading}), flush=True)
    print(json.dumps({"cli_color": color_cli, "cli_mesh": mesh_cli,
                      "cli_batch": batch_cli}), flush=True)
    print(json.dumps({"dist": dist}, default=str), flush=True)
    print(json.dumps({"split": split}, default=str), flush=True)
    print(json.dumps({"drivers": drivers}, default=str), flush=True)
    print(json.dumps({"oracle": oracle}), flush=True)
    print(json.dumps({"general": general,
                      "phase_seconds": phase_seconds}), flush=True)
    print(card, flush=True)  # beside the numbers of the lines around it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
