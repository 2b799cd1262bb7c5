"""The PCG loop's CUDA graph against the same loop launched op by op, on
the card.

On a CUDA device, `cg.solve_batch` without ``reduce`` runs its first pass
op by op, captures the pass as a CUDA graph and replays it for every later
pass. The graph launches the kernels the loop launches, in its order, so
a solve must give the loop's x, residual and iterations bit for bit, with
one pass op by op, one capture and the rest replayed. Held on
`solver.testing.GRAPH_CASES`: the multigrid hierarchies of the `dtu49`
cells (fine grids of 37 x 49, 75 x 99 and 151 x 199 nodes, one system as
`cg.solve` takes it; 151 x 199 in a batch of 4 whose views exit at
different passes, one not running) and `rect2mp`'s finest grid (359 x
359); the block-Jacobi preconditioner and the flexible beta at 75 x 99.
Each solve runs twice on each path, in turns.

These tests need a CUDA device and skip without one. This file imports
neither JAX nor the JAX package, so on the GPU machine it runs without
the JAX test configuration:

    python -m pytest tests/test_torch_pcg_graph.py --noconftest -q -p no:cacheprovider
"""

import pytest
import torch

from smvs_tpu_torch.solver import testing as tsys

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("case", list(tsys.GRAPH_CASES))
def test_graph_replays_the_eager_loop(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    print(case, tsys.check_case(case))
