"""Shape from shading on the textureless Lambertian sphere: the port's
shading-aware optimizer against the JAX package's, on the CPU.

The JAX package's own sphere test (tests/test_shading.py) runs the
sparse-prior mode with full optimization, neither of which the port has
yet (ROADMAP.md queue 1, items 3 and 5); this one runs both packages
through the SGM-init path instead, on the same inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.image import ops as jops
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu_torch import convert
from smvs_tpu_torch.pipeline import optimizer as tO
from torch_threads import one_torch_thread  # noqa: F401


def _sphere_run(package, scene, init, use_shading):
    fields = dict(regularization=0.01, light_surf_regularization=50.0,
                  num_iterations=3, min_scale=2, use_sgm=True,
                  use_shading=use_shading, max_newton_steps=40)
    if package == "jax":
        views = [jviews.make_view(scene.cameras[i], scene.images[i],
                                  view_id=i) for i in (1, 0, 2)]
        r = jO.optimize_view(views[0], views[1:],
                             jO.OptimizerOptions(**fields),
                             sgm_depth=jnp.asarray(init))
        depth = np.asarray(r.depth)
    else:
        views = [convert.view(dataclasses.asdict(scene.cameras[i]),
                              scene.images[i], view_id=i, device="cpu")
                 for i in (1, 0, 2)]
        r = tO.optimize_view(views[0], views[1:],
                             convert.options(tO.OptimizerOptions, fields),
                             sgm_depth=init, device="cpu")
        depth = r.depth.numpy()
    gt = scene.depths[1]
    mask = (depth > 0) & (gt > 0)
    rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
    return float(mask.mean()), float(np.median(rel))


def test_lambertian_sphere_shading_on_and_off_match_jax_class():
    """The textureless sphere at dim 200 through the SGM-init path, its
    heavily blurred ground truth as the SGM depth, shading on and off
    (light_surf_regularization 50, 3 iterations to scale 2), against JAX
    on the same inputs: coverage within 0.05 of JAX's, the shading-on
    error at most max(2 x JAX's, 1.5e-2), and where JAX's shading beats
    its shading-off by 1.25x or more, the port's must too.

    JAX's numbers here (float32, CPU): shading off coverage 0.7967,
    median error 1.624e-2; shading on 0.7534, 1.073e-2, a ratio of 1.51,
    so the 1.25x check applies (the port: 0.7964, 1.587e-2; 0.7730,
    1.058e-2).
    """
    scene = jsyn.make_lambertian_sphere_scene(n_views=3, dim=200)
    gt = scene.depths[1]
    g = jnp.asarray(np.where(gt > 0, gt, 0.0))
    init = np.asarray(jnp.where(g > 0, jops.gaussian_blur(
        jnp.where(g > 0, g, 3.9), 6.0), 0.0), np.float32)
    res = {(pkg, on): _sphere_run(pkg, scene, init, on)
           for pkg in ("jax", "port") for on in (False, True)}
    for on in (False, True):
        assert abs(res["port", on][0] - res["jax", on][0]) <= 0.05, res
    assert res["port", True][1] <= max(2 * res["jax", True][1], 1.5e-2), res
    if res["jax", False][1] >= 1.25 * res["jax", True][1]:
        assert res["port", False][1] >= 1.25 * res["port", True][1], res
