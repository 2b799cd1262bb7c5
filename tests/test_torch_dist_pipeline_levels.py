"""The row-split pipeline of tests/test_torch_dist_pipeline.py where the
finest grid has two multigrid levels (dim 160 down to scale 3: 21 node
rows, split 11 + 10 over two ranks, its coarse level 6 + 5), against the
port's unsharded batch and the JAX package's pipeline with a 'patch'
axis of 2. A file of its own, so that the two JAX references compile on
two test workers.
"""

from test_torch_dist_pipeline import check_pipeline
from torch_threads import one_torch_thread  # noqa: F401


def test_pipeline_on_mesh_two_levels(tmp_path):
    check_pipeline(tmp_path, 160, 3)
