"""Plain reference of the optimizer: a frozen copy of the port's optimizer
path on one card (`pipeline/optimizer.py`, `pipeline/batch.py` without its
path over ranks, `pipeline/views.py`, and what they import: `surface/`,
`solver/`, `image/`, `geometry/`, `shading/`, the camera (`reference.camera`),
`device.py`, `utils/`), its module layout kept and its imports pointed
here. It is plain PyTorch, imports nothing of the program, and is kept with
the benchmark so that a later change to the program is held to what the
optimizer computes today, at the precision the configurations state
(float32 with TF32 off, the copy's own `device.set_cuda_precision`).

The check builds its views (`pipeline.views.make_view`) from the
benchmark's photos and cameras and starts it from the plain SGM
reference's depth maps, so it takes nothing the program derived.
"""
