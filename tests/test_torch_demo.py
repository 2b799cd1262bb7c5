"""The port's two-view demo (`smvs_tpu_torch/examples/two_view_demo.py`)
at its defaults on the CPU, with and without `--sgm`: the bars the
repository's verify notes give the JAX demo (coverage above 60%, median
depth error below 0.1%), and its coverage and error against the JAX
demo's (`python examples/two_view_demo.py --platform cpu [--sgm]`: 73.7%
and 0.0308%; with `--sgm` 74.2% and 0.0249%).
"""

import contextlib
import io
import re

import pytest

from smvs_tpu_torch.examples import two_view_demo
from torch_threads import one_torch_thread  # noqa: F401

JAX_DEMO = {(): (0.737, 0.000308), ("--sgm",): (0.742, 0.000249)}


@pytest.mark.parametrize("flags", [(), ("--sgm",)])
def test_two_view_demo(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = two_view_demo.main(["--device", "cpu", *flags])
    text = out.getvalue()
    assert rc == 0
    assert "### scale 4:" in text
    cov = float(re.search(r"coverage:\s+([\d.]+)%", text).group(1)) / 100
    err = float(re.search(r"median depth error:\s+([\d.]+)%", text)
                .group(1)) / 100
    assert cov > 0.6 and err < 1e-3
    j_cov, j_err = JAX_DEMO[flags]
    assert abs(cov - j_cov) <= 0.01, (cov, j_cov)
    assert err <= 1.5 * j_err, (err, j_err)
