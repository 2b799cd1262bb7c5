"""The port's multi-device step (`smvs_tpu_torch.dist`) on the CPU: the
('views', 'patch') mesh over gloo ranks spawned by `dist.launch.spawn`,
the placement of views and node rows, the halo exchange and the band's
stencil product, the band's own assembly, and the sharded Newton step
against the port's single-process step and the JAX package's sharded
step on its 8-device CPU mesh (tests/test_dist.py's problem and bar:
`make_view_batch(4, dim=116, scale=4)` in float64, rtol 1e-9 and atol
1e-11).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as ranks
from smvs_tpu.dist import testing as jtesting
from smvs_tpu.dist import viewbatch as jvb
from smvs_tpu.solver import gn as jgn
from smvs_tpu_torch.dist import launch
from smvs_tpu_torch.dist import mesh as M
from smvs_tpu_torch.dist import testing as ttesting
from smvs_tpu_torch.dist import viewbatch as tvb
from smvs_tpu_torch.solver import gn as tgn
from smvs_tpu_torch.solver import stencil
from torch_threads import one_torch_thread  # noqa: F401

ARGS = ranks.ARGS


def _spawn(tmp_path, fn, n, *args):
    return launch.spawn(fn, n, backend="gloo", device="cpu",
                        store_path=str(tmp_path / f"store{n}"), args=args,
                        timeout=300)


@pytest.fixture(scope="module")
def problem():
    """The port's batch and single-process step, and the JAX package's
    sharded steps on make_mesh(4, 1) and make_mesh(8, 2)."""
    jt, jb = jtesting.make_view_batch(4, dim=116, scale=4, dtype=jnp.float64)
    want = {}
    for n, p in ((4, 1), (8, 2)):
        step = jvb.training_step_fn(jt, jgn.GNOptions(chunk=32),
                                    jvb.make_mesh(n, patch_axis=p))
        want[(n, p)] = np.asarray(step(*(jb[k] for k in ARGS)))
    tt, tb = ttesting.make_view_batch(4, dim=116, scale=4,
                                      dtype=torch.float64, device="cpu")
    single = tvb.batched_newton_step(tt, tgn.GNOptions())(
        *(tb[k] for k in ARGS))
    return tt, tb, single, want


@pytest.mark.parametrize("n,parts", [(4, 1), (4, 4), (5, 2), (8, 3),
                                     (3, 3), (2, 4), (360, 7)])
def test_split_covers_every_index_once(n, parts):
    got = [M.split(n, parts, i) for i in range(parts)]
    assert [i for r in got for i in r] == list(range(n))
    want = torch.tensor_split(torch.arange(n), parts)
    assert [list(r) for r in got] == [w.tolist() for w in want]


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh(1, device="cpu")


def test_mesh_layout_and_placement(tmp_path):
    """Shape, names and the row-major rank layout of the (4, 1), (2, 2)
    and (1, 4) meshes; view shares and row bands (uneven: 5 views, 7
    rows) cover each view and row once per mesh row and column."""
    outs = _spawn(tmp_path, ranks.mesh_layout, 4, (1, 2, 4), 5, 7)
    for p in (1, 2, 4):
        for r, o in enumerate(outs):
            got = o[p]
            assert got["shape"] == (4 // p, p)
            assert got["names"] == ("views", "patch")
            assert got["coord"] == (r // p, r % p)
        rows_of = {}
        shares = {}
        for o in outs:
            c = o[p]["coord"]
            shares.setdefault(c[1], []).append(o[p]["share"])
            rows_of.setdefault(c[0], []).append(o[p]["band"])
        for col in shares.values():  # each 'patch' column: all 5 views
            assert [i for s in col for i in s] == list(range(5))
        for row in rows_of.values():  # each 'views' row: all 7 rows
            assert [i for b in row for i in b] == list(range(7))


def test_mesh_rejects_what_it_cannot_split(tmp_path):
    msgs = _spawn(tmp_path, ranks.mesh_errors, 2)
    assert "do not split into rows of 3" in msgs[0]["patch_3"]
    assert "band would be empty" in msgs[0]["band"]
    assert "start as many ranks" in msgs[0]["size"]


@pytest.mark.parametrize("patch,ny1", [(2, 7), (3, 8), (3, 3)])
def test_halo_spmv_equals_stencil_rows(tmp_path, patch, ny1):
    """The halo rows are the neighbor bands' edge rows and zeros at the
    grid's edges (the zero pad of `stencil._pad_yx`), and the band's
    product is the whole grid's rows bit for bit, bands of one row
    included."""
    data = ranks.seeded_system(2, ny1, 6)
    path = str(tmp_path / "system.pt")
    torch.save(data, path)
    want = stencil.spmv(data["Hb"], data["x"])
    padded = stencil._pad_yx(data["x"], 1, 1, 0, 0)
    outs = _spawn(tmp_path, ranks.halo_spmv, patch, path)
    assert [i for o in outs for i in o["band"]] == list(range(ny1))
    for o in outs:
        b = o["band"]
        assert torch.equal(o["halo"], padded[..., b.start:b.stop + 2, :])
        assert torch.equal(o["y"], want[..., b.start:b.stop, :])


@pytest.mark.parametrize("band", [range(0, 3), range(3, 6), range(6, 8),
                                  range(0, 1), range(7, 8), range(4, 5),
                                  range(0, 8)])
def test_band_assembly_equals_whole_grid_rows(problem, band):
    tt, tb, _, _ = problem
    act = tb["active"] & tb["node_valid"]
    surf = dataclasses.replace(tt, nodes=tb["nodes"],
                               node_valid=tb["node_valid"],
                               patch_valid=tb["patch_valid"])
    g, Hb = tgn.assemble(surf, tb["view"], tb["vis"], act, tgn.GNOptions())
    gb, Hbb = tvb.assemble_band(tt, tb["nodes"], tb["node_valid"],
                                tb["patch_valid"], tb["vis"], act,
                                tb["view"], band, tgn.GNOptions())
    assert torch.equal(gb, g[..., band.start:band.stop, :])
    assert torch.equal(Hbb, Hb[..., band.start:band.stop, :])
    assert gb.abs().max() > 0


@pytest.mark.parametrize("views,patch", [(4, 1), (2, 2), (1, 2)])
def test_training_step_matches_single_and_jax(tmp_path, problem, views,
                                              patch):
    """The sharded step on each mesh against the port's single-process
    step (bit-equal with a 'patch' axis of 1) and the JAX package's
    sharded steps, at tests/test_dist.py's bar; each rank's shard is its
    part of the gathered nodes, and the step moves the nodes."""
    tt, tb, single, want = problem
    outs = _spawn(tmp_path, ranks.training_step, views * patch, patch)
    full = outs[0]["full"]
    for o in outs:
        s, b = o["share"], o["band"]
        assert torch.equal(o["shard"], full[s.start:s.stop, b.start:b.stop])
        assert torch.equal(o["full"], full)
    if patch == 1:
        assert torch.equal(full, single)
    np.testing.assert_allclose(full.numpy(), single.numpy(), rtol=1e-9,
                               atol=1e-11)
    for w in want.values():
        np.testing.assert_allclose(full.numpy(), w, rtol=1e-9, atol=1e-11)
    assert (full - tb["nodes"]).abs().max() > 0
