"""SGM path-cost aggregation: the CUDA kernel and its plain PyTorch twin.

Port of `smvs_tpu/sgm/pallas_agg.py`. The entry points keep the JAX
signatures and results:

- `fused_pass` (`_fused_pass`): one sweep of ``len(shifts)`` paths over
  an [X, L, D] int16 volume scanned along X, added to ``acc``;
- `fused_pass_batch` (`_fused_pass_batch`): the same over [B, X, L, D];
- `aggregate_batch`: all 8 paths of B problems, returned as int16.

For a CUDA tensor they launch the hand-written kernel of
`csrc/sgm_agg.cu` (one launch per path and direction, eight per
`aggregate_batch`) or raise; for a CPU tensor they run the plain version
below, the `lax.scan` recurrence of `smvs_tpu/sgm/stereo.py:aggregate` as a
Python loop over the scan axis. The TPU's pad to multiples of 8 and its
VMEM dispatch models are not needed: the kernel takes any H, W and
D <= 128, the main path's plane count.

``launches`` counts kernel launches (and nothing else), so a run can show
that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

BIG = 1 << 24

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "sgm_agg.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

launches = 0  # kernel launches since import (or since a caller reset it)
_lib = None


# ---------------------------------------------------------------------------
# build and binding


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the SGM kernel is built from "
                           f"{SOURCE} on a machine with the CUDA toolkit")
    return path


def library_path() -> str:
    """Where the built kernel lives, keyed by the source's content."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsgm_agg_{digest}.so")


def build(verbose: bool = False) -> str:
    """Compile `csrc/sgm_agg.cu` for sm_90a with nvcc (once per source
    version) and return the library path. ``verbose`` prints nvcc's
    register and spill report."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.sgm_agg_path
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch_paths(cost, inten, acc, dims, vstrides, istrides, reverse: bool,
                  shifts: tuple, p1: int, p2: int) -> None:
    """One kernel launch per path: ``acc += path costs`` in place."""
    global launches
    fn = _library().sgm_agg_path
    B, X, L, D = dims
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        for shift in shifts:
            err = fn(cost.data_ptr(), inten.data_ptr(), acc.data_ptr(),
                     B, X, L, D, *vstrides, *istrides, int(reverse),
                     int(shift), int(p1), int(p2), stream)
            if err != 0:
                raise RuntimeError(f"sgm_agg_path launch failed: CUDA error "
                                   f"{err}")
            launches += 1


def _check(cost, inten, acc, vol_ndim: int) -> None:
    if cost.ndim != vol_ndim or inten.ndim != vol_ndim - 1:
        raise ValueError(f"expected a {vol_ndim}-d volume and a "
                         f"{vol_ndim - 1}-d intensity, got "
                         f"{tuple(cost.shape)} / {tuple(inten.shape)}")
    if inten.shape != cost.shape[:-1]:
        raise ValueError(f"intensity {tuple(inten.shape)} does not match "
                         f"the volume {tuple(cost.shape)}")
    if acc is not None and acc.shape != cost.shape:
        raise ValueError("accumulator and cost volume shapes differ")
    for t in (cost, inten) + ((acc,) if acc is not None else ()):
        if t.device != cost.device:
            raise ValueError("all tensors must be on one device")
    if cost.device.type == "cuda":
        if cost.dtype != torch.int16 or (acc is not None
                                         and acc.dtype != torch.int16):
            raise TypeError("the kernel takes int16 cost and accumulator")
        if inten.dtype != torch.int32:
            raise TypeError("the kernel takes int32 intensities")
        if not (cost.is_contiguous() and inten.is_contiguous()
                and (acc is None or acc.is_contiguous())):
            raise ValueError("the kernel takes contiguous tensors")
        if not 1 <= cost.shape[-1] <= 128:
            raise ValueError("the kernel takes 1 <= D <= 128 depths")
    elif cost.device.type != "cpu":
        raise ValueError(f"unsupported device {cost.device}")


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tensors, tests, and the on-card comparison)


def _min_plus(prev, cost, p1: int, p2a):
    """new = cost + min(prev, prev[d+-1] + P1, min(prev) + P2a) - min(prev)."""
    big = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([prev[..., 1:], big], dim=-1)
    dn = torch.cat([big, prev[..., :-1]], dim=-1)
    min_prev = prev.amin(dim=-1, keepdim=True)
    upd = torch.minimum(torch.minimum(prev, torch.minimum(up, dn) + p1),
                        min_prev + p2a[..., None])
    return cost + upd - min_prev


def plain_fused_pass_batch(cost, inten, acc, reverse: bool, shifts: tuple,
                           p1: int, p2: int) -> torch.Tensor:
    """Plain version of `fused_pass_batch`: returns ``acc`` plus the paths
    in int32. cost/acc [B, X, L, D], inten [B, X, L]."""
    B, X, L, D = cost.shape
    out = acc.to(torch.int32, copy=True)
    inten = inten.to(torch.int32)
    order = range(X - 1, -1, -1) if reverse else range(X)
    prevs = [None] * len(shifts)
    prev_int = None
    p2min = p1 * 3 // 2
    for step, x in enumerate(order):
        c = cost[:, x].to(torch.int32)  # [B, L, D]
        it = inten[:, x]  # [B, L]
        for k, shift in enumerate(shifts):
            if step == 0:
                new = c
            else:
                prev = prevs[k]
                pi = prev_int
                if shift:
                    prev = torch.roll(prev, shift, dims=1)
                    pi = torch.roll(pi, shift, dims=1)
                    prev[:, 0 if shift > 0 else L - 1] = BIG
                p2a = torch.clamp(p2 // (torch.abs(it - pi) + 1), min=p2min)
                new = _min_plus(prev, c, p1, p2a)
            prevs[k] = new
            out[:, x] += new
        prev_int = it
    return out


def plain_aggregate_batch(cost, intensity, p1: int, p2: int) -> torch.Tensor:
    """Plain version of `aggregate_batch`: the 8-path sum in int32."""
    inten = intensity.to(torch.int32)
    ct = cost.transpose(1, 2)  # [B, W, H, D]: horizontal sweeps scan x
    it = inten.transpose(1, 2)
    acc = torch.zeros(ct.shape, dtype=torch.int32, device=cost.device)
    acc = plain_fused_pass_batch(ct, it, acc, False, (0,), p1, p2)
    acc = plain_fused_pass_batch(ct, it, acc, True, (0,), p1, p2)
    acc = acc.transpose(1, 2)
    acc = plain_fused_pass_batch(cost, inten, acc, False, (0, 1, -1), p1, p2)
    return plain_fused_pass_batch(cost, inten, acc, True, (0, 1, -1), p1, p2)


# ---------------------------------------------------------------------------
# entry points


def fused_pass_batch(cost: torch.Tensor, inten: torch.Tensor,
                     acc: torch.Tensor, reverse: bool, shifts: tuple,
                     p1: int, p2: int) -> torch.Tensor:
    """One scan sweep of ``len(shifts)`` paths over B problems.

    cost/acc [B, X, L, D] int16 scanned along X; inten [B, X, L] int32.
    Returns ``acc`` plus the path costs as a new int16 tensor.
    """
    _check(cost, inten, acc, 4)
    if cost.device.type == "cpu":
        return plain_fused_pass_batch(cost, inten, acc, reverse, shifts,
                                      p1, p2).to(torch.int16)
    B, X, L, D = cost.shape
    out = acc.clone()
    _launch_paths(cost, inten, out, (B, X, L, D), (X * L * D, L * D, D),
                  (X * L, L, 1), reverse, shifts, p1, p2)
    return out


def fused_pass(cost: torch.Tensor, inten: torch.Tensor, acc: torch.Tensor,
               reverse: bool, shifts: tuple, p1: int, p2: int
               ) -> torch.Tensor:
    """One scan sweep of ``len(shifts)`` paths over one [X, L, D] int16
    volume scanned along X (inten [X, L] int32); returns acc + paths."""
    _check(cost, inten, acc, 3)
    return fused_pass_batch(cost[None], inten[None], acc[None], reverse,
                            shifts, p1, p2)[0]


def aggregate_batch(cost: torch.Tensor, intensity: torch.Tensor, p1: int,
                    p2: int) -> torch.Tensor:
    """All 8 SGM paths for B cost volumes [B, H, W, D] (values <= 255)
    with intensities [B, H, W]; returns the int16 8-path sum.

    On the card: two horizontal launches (scan along W, no transposed
    copy) and six vertical/diagonal ones, accumulating in place.
    """
    _check(cost, intensity, None, 4)
    if cost.device.type == "cpu":
        return plain_aggregate_batch(cost, intensity, p1, p2).to(torch.int16)
    B, H, W, D = cost.shape
    acc = torch.zeros_like(cost)
    vb, ib = H * W * D, H * W
    for reverse in (False, True):  # horizontal: scan x, lines are rows
        _launch_paths(cost, intensity, acc, (B, W, H, D), (vb, D, W * D),
                      (ib, 1, W), reverse, (0,), p1, p2)
    for reverse in (False, True):  # vertical + diagonals: scan y
        _launch_paths(cost, intensity, acc, (B, H, W, D), (vb, W * D, D),
                      (ib, W, 1), reverse, (0, 1, -1), p1, p2)
    return acc
