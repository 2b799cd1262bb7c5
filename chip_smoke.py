"""On-card smoke check of the PyTorch/CUDA port (smvs_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit;
2. build the SGM aggregation kernel from `smvs_tpu_torch/csrc/sgm_agg.cu`;
3. kernel against its plain PyTorch version at the main path's shapes:
   `aggregate_batch` on a seeded [2, 1440, 1696, 128] int16 volume (with the
   INVALID column band of the padded main problem), `fused_pass_batch` and
   `fused_pass`; bit-equal or fail; CUDA-event times;
4. the main path: `bench_main.run_once(1440, 2)` once to warm up and once
   timed, with the kernel's launch count; coverage >= 0.84 and median
   relative error <= 1e-4 against the analytic depth.

It prints one `{"kernels": [...]}` line, then as the last line
`{"ok": true, "device": {...}}`. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this check runs on the GPU")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from smvs_tpu_torch import bench_main  # noqa: E402
from smvs_tpu_torch.device import set_cuda_precision  # noqa: E402
from smvs_tpu_torch.sgm import cuda_agg  # noqa: E402
from smvs_tpu_torch.sgm.stereo import INVALID_COST  # noqa: E402

# H100 SXM memory bandwidth (NVIDIA data sheet; full 700 W power limit).
# The data sheet gives no peak rate for integer min and add work, so the
# bound of this integer kernel is its bytes (PERF.md estimates the integer
# work beside it).
PEAK_BYTES_PER_S = 3.35e12

SHAPE = (2, 1440, 1696, 128)  # both SGM directions at the main path's size
MAIN_W = 1440  # the main problem's real width; the rest is INVALID padding


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def once_ms(fn):
    """(result, ms) of one run, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_agg.build(verbose=True)
    log(f"built {os.path.relpath(path)} in {time.perf_counter() - t0:.1f} s")


def _seeded_volume():
    g = torch.Generator(device="cuda").manual_seed(1234)
    cost = torch.randint(0, 127, SHAPE, generator=g, device="cuda",
                         dtype=torch.int16)
    cost[0, :, MAIN_W:] = INVALID_COST
    inten = torch.randint(0, 256, SHAPE[:-1], generator=g, device="cuda",
                          dtype=torch.int32)
    inten[0, :, MAIN_W:] = 0
    return cost, inten


def bound(n: int, depths: int, acc_in: bool) -> dict:
    """Least time over ``n`` int16 cost elements: the bytes that must move
    (the cost and, for a sweep, the accumulator read once, the int32
    intensities read once, the int16 result written once) at peak
    bandwidth."""
    bytes_moved = (2 + 2 * acc_in) * n + 4 * (n // depths) + 2 * n
    return {"bound_ms": bytes_moved / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def check_argmin_ties(agg: torch.Tensor) -> None:
    """The WTA index needs `torch.argmin` to take the first of tied minima
    on the card, as `jnp.argmin` does: held on the full aggregated volume,
    and on the same sums divided by 32, which tie far more often."""
    D = agg.shape[-1]
    planes = torch.arange(D, device=agg.device, dtype=torch.int16)
    for name, vol in (("sums", agg), ("sums >> 5", agg >> 5)):
        ties = 0
        for v in vol:  # one problem at a time bounds the temporaries
            is_min = v == v.amin(-1, keepdim=True)
            first = torch.where(is_min, planes, D).amin(-1)
            if not torch.equal(torch.argmin(v, -1), first.to(torch.int64)):
                raise RuntimeError(f"argmin of the {name} is not the first "
                                   "tied minimum")
            ties += int((is_min.sum(-1) > 1).sum())
        log(f"argmin of the {name}: first of tied minima "
            f"({ties} pixels with ties)")


def phase_kernel() -> dict:
    cost, inten = _seeded_volume()
    D = cost.shape[-1]
    p1, p2 = 6, 96

    before = cuda_agg.launches
    got = cuda_agg.aggregate_batch(cost, inten, p1, p2)
    torch.cuda.synchronize()
    if cuda_agg.launches - before != 8:
        raise RuntimeError("aggregate_batch did not launch 8 kernels")
    want, plain_ms = once_ms(
        lambda: cuda_agg.plain_aggregate_batch(cost, inten, p1, p2))
    err = int((got.to(torch.int32) - want).abs().max())
    del want
    if err != 0:
        raise RuntimeError(f"aggregate_batch differs from plain: {err}")
    ms = cuda_ms(lambda: cuda_agg.aggregate_batch(cost, inten, p1, p2))
    log(f"aggregate_batch {list(SHAPE)}: kernel {ms:.3f} ms (8 launches), "
        f"plain {plain_ms:.1f} ms, bit-equal")
    check_argmin_ties(got)
    del got

    # The two TPU entry points at the main path's sweep shapes: the
    # horizontal 1-path sweep of both problems, the 3-path sweep of one.
    ct = cost.transpose(1, 2).contiguous()
    it = inten.transpose(1, 2).contiguous()
    acc = torch.zeros_like(ct)
    acc1 = torch.zeros_like(cost[1])
    wrappers = {}
    for name, fn, plain in (
            ("fused_pass_batch",
             lambda: cuda_agg.fused_pass_batch(ct, it, acc, False, (0,),
                                               p1, p2),
             lambda: cuda_agg.plain_fused_pass_batch(ct, it, acc, False,
                                                     (0,), p1, p2)),
            ("fused_pass",
             lambda: cuda_agg.fused_pass(cost[1], inten[1], acc1, True,
                                         (0, 1, -1), p1, p2),
             lambda: cuda_agg.plain_fused_pass_batch(
                 cost[1:2], inten[1:2], torch.zeros_like(cost[1:2]), True,
                 (0, 1, -1), p1, p2)[0])):
        k = fn()
        ref, ref_ms = once_ms(plain)
        e = int((k.to(torch.int32) - ref).abs().max())
        if e != 0:
            raise RuntimeError(f"{name} differs from plain: {e}")
        wrappers[name] = {"ms": cuda_ms(fn), "plain_ms": ref_ms,
                          "max_abs_err": e, "shape": list(k.shape),
                          **bound(k.numel(), k.shape[-1], acc_in=True)}
        log(f"{name}: kernel {wrappers[name]['ms']:.3f} ms, plain "
            f"{ref_ms:.1f} ms, bit-equal")
        del k, ref

    return {
        "name": "sgm_path_kernel",
        "route": "cuda",
        "source": "smvs_tpu_torch/csrc/sgm_agg.cu",
        "replaces": "smvs_tpu/sgm/pallas_agg.py:488",
        "also_replaces": "smvs_tpu/sgm/pallas_agg.py:288",
        "launches": None,
        "max_abs_err": err,
        "equals_plain": True,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound(cost.numel(), D, acc_in=False),
        "library_ms": None,
        "shape": list(SHAPE),
        "wrappers": wrappers,
    }


def phase_main() -> int:
    dim = 1440
    t0 = time.perf_counter()
    bench_main.run_once(dim, 2, device="cuda")
    log(f"warm-up run_once({dim}, 2): {time.perf_counter() - t0:.1f} s")
    cuda_agg.launches = 0
    t_sgm, t_opt, cov, err = bench_main.run_once(dim, 2, device="cuda",
                                                 verbose=True)
    launches = cuda_agg.launches
    mps = dim * dim / 1e6 / (t_sgm + t_opt)
    log(f"run_once({dim}, 2): sgm {t_sgm:.3f} s, optimizer {t_opt:.3f} s, "
        f"{mps:.3f} MP/s, coverage {cov:.4f}, median_rel_err {err:.3e}, "
        f"kernel launches {launches}")
    if launches <= 0:
        raise RuntimeError("the main path did not launch the SGM kernel")
    if not cov >= 0.84:
        raise RuntimeError(f"coverage {cov:.4f} < 0.84")
    if not err <= 1e-4:
        raise RuntimeError(f"median_rel_err {err:.3e} > 1e-4")
    return launches


def main() -> int:
    set_cuda_precision()
    device = phase_card()
    phase_build()
    kernel = phase_kernel()
    kernel["launches"] = phase_main()
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
