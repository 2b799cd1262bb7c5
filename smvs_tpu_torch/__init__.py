"""smvs_tpu_torch — the PyTorch/CUDA port of the `smvs_tpu` package.

The package mirrors `smvs_tpu/`'s sub-packages module for module. Plain
tensor code is PyTorch; the SGM path-cost aggregation, five Pallas kernels
on the TPU, is one hand-written CUDA kernel (`csrc/sgm_agg.cu`, bound in
`sgm/cuda_agg.py`); scene IO, view selection and fusion are numpy on the
host, as in the JAX package. The package imports neither JAX nor
`smvs_tpu`. The user entry point is the `smvsrecon` CLI, `cli.py`.

Entry points take an explicit ``device``. With ``device=None`` they run
on the GPU and raise when there is none (see `device.resolve_device`).
"""
