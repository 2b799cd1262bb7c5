"""Standalone mesh simplification tool (port of
`smvs_tpu/tools/simplify.py`).

Counterpart of reference `tools/simplify.cc`: load a PLY mesh, decimate it
with the QEM simplifier (native C++, `smvs_tpu_torch/native`), save the
result.

Usage: python -m smvs_tpu_torch.tools.simplify IN.ply OUT.ply [ratio]
"""

import sys

from smvs_tpu_torch import native
from smvs_tpu_torch.mesh.ply import PointSet, load_ply, save_ply


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    in_path, out_path = argv[0], argv[1]
    ratio = float(argv[2]) if len(argv) > 2 else 0.25
    ps = load_ply(in_path)
    if ps.faces is None or len(ps.faces) == 0:
        print("error: input has no faces", file=sys.stderr)
        return 1
    verts, faces = native.simplify_mesh(ps.vertices, ps.faces, ratio)
    save_ply(out_path, PointSet(vertices=verts, faces=faces))
    print(f"{len(ps.faces)} -> {len(faces)} faces, "
          f"{len(ps.vertices)} -> {len(verts)} vertices")
    return 0


if __name__ == "__main__":
    sys.exit(main())
