"""No run loads JAX or the JAX package; the reference loads nothing of the
program."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmarks import run


def test_forbidden_names_compare_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "smvs_tpu", "smvs_tpu.cli", "smvs_tpu_torch",
             "smvs_tpu_torch.cli", "jaxtyping", "flaxen", "smvs_tpux", "numpy"]
    assert run.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "smvs_tpu",
        "smvs_tpu.cli"]
    assert run.forbidden_modules(["smvs_tpu_torch.sgm.stereo"]) == []


def _loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    mods = _loaded_after(
        "import benchmarks.reference.sgm_plain, benchmarks.reference.scan\n"
        "import benchmarks.reference.camera, benchmarks.scenes\n"
        "import benchmarks.check")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"smvs_tpu_torch", "smvs_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_the_port_and_no_jax():
    mods = _loaded_after(
        "import torch\n"
        "from benchmarks.tests import tiny\n"
        "assert tiny.run_tiny('rect2mp.seq')['correct']")
    assert "smvs_tpu_torch" in mods
    assert run.forbidden_modules(mods) == []
