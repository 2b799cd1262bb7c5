"""smvs_tpu_torch — the PyTorch/CUDA port of the `smvs_tpu` package.

The package mirrors `smvs_tpu/`'s sub-packages module for module. Plain
tensor code is PyTorch; the SGM path-cost aggregation, a Pallas kernel on
the TPU, is a hand-written CUDA kernel (`csrc/sgm_agg.cu`, bound in
`sgm/cuda_agg.py`). The package imports neither JAX nor `smvs_tpu`.

Entry points take an explicit ``device``. With ``device=None`` they run
on the GPU and raise when there is none (see `device.resolve_device`).
"""
