"""The plain reference against the port at a tiny size on the CPU: the same
inputs give the same SGM and final depth maps, bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from benchmarks import drivers
from benchmarks.drivers import pair, scan
from benchmarks.reference import scan as ref_scan
from benchmarks.reference import sgm_plain
from benchmarks.tests import tiny
from smvs_tpu_torch import cli
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.sgm import stereo as sgm


def test_pair_sgm_equals_the_port():
    _, _, config, traffic = tiny.cell("rect2mp.seq")
    drv = pair.Driver(config, traffic, 11, tiny.CPU)
    drv.render()
    (cam0, cam1), (img0, img1) = drv.pairs[0]["cameras"], \
        drv.pairs[0]["images"]
    pcam0, pcam1 = drv.cams[0]
    rng = tuple(config["smvsrecon"]["sgm_range"])
    prog = sgm.reconstruct_auto(pcam1, pcam0, img1 * 255.0, img0 * 255.0,
                                rng, rng, device="cpu")
    ref = sgm_plain.sgm_depth(cam1, [cam0], img1 * 255.0, [img0 * 255.0],
                              rng, [rng])
    assert (prog > 0).float().mean() > 0.5
    assert torch.equal(prog, ref)


def test_scan_set_up_and_sgm_equal_the_port():
    """A 4:3 scan through the command line's set-up and its SGM."""
    _, _, config, traffic = tiny.cell("dtu49.batch4")
    drv = scan.Driver(config, traffic, 12, tiny.CPU)
    drv.render()
    drv.prepare()
    opts = config["smvsrecon"]
    width, height = drv.scan["size"]
    assert (width, height) == (160, 120)
    assert drv.canvas == (128, 160)
    scale = ref_scan.input_scale(width, height, opts["max_pixels"])
    sizes = [(width, height)] * len(drv.cams)
    for i in range(len(drv.cams)):
        ref_img = ref_scan.working_image(drv.scan["photos"][i], scale)
        prog_img, _ = drv.padded_image(i)
        assert np.array_equal(prog_img[:120, :160], ref_img.numpy())
        assert drv.neighbors[i] == ref_scan.neighbors(
            drv.scan["cameras"], sizes, drv.scan["features"], i,
            opts["neighbors"])
    for i in (0, 5):
        prog = cli.reconstruct_sgm(drv.conf, i, drv.neighbors[i],
                                   drv.padded_image, drv.bundle, None,
                                   tiny.CPU)
        ref = ref_scan.sgm_view(drv.scan, opts, i)
        assert (ref > 0).float().mean() > 0.3
        assert np.array_equal(prog, ref.numpy())


def test_working_image_at_scale_one_equals_the_command_lines():
    photo = torch.randint(0, 256, (24, 32), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    x = iops.rescale_half_size_gaussian(
        torch.as_tensor(photo.numpy().astype(np.float32) / 255.0))
    u8 = np.clip(x.numpy() * 255, 0, 255).astype(np.uint8)
    want = (u8.astype(np.float64) / 255.0).astype(np.float32)
    assert np.array_equal(ref_scan.working_image(photo, 1).numpy(), want)


def test_pair_optimizer_equals_the_port():
    _, _, config, traffic = tiny.cell("rect2mp.seq")
    drv = pair.Driver(config, traffic, 13, tiny.CPU)
    drv.render()
    drv.prepare()
    (rec,) = drv.run([1], drivers.Spans())
    (ref,) = drv.reference_depths([1], [drv.reference_sgm(1)])
    assert (ref > 0).float().mean() > 0.5
    assert torch.equal(rec["depth"], ref)


def test_scan_batch_optimizer_equals_the_port():
    """A batched group of the 4:3 scan, through the reference's own set-up
    (working images, canvas, neighbors, SGM)."""
    _, _, config, traffic = tiny.cell("dtu49.batch4")
    drv = scan.Driver(config, traffic, 14, tiny.CPU)
    drv.render()
    drv.prepare()
    group = drv.requests[0]
    assert len(group) >= 2
    recs = drv.run(group, drivers.Spans())
    refs = drv.reference_depths(group, [drv.reference_sgm(i)
                                        for i in group])
    for rec, ref in zip(recs, refs):
        assert rec["depth"].shape == (120, 160)
        assert (ref > 0).float().mean() > 0.3
        assert torch.equal(rec["depth"], ref)
