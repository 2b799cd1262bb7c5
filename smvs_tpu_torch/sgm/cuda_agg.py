"""SGM path-cost aggregation: the CUDA kernel and its plain PyTorch twins.

Port of `smvs_tpu/sgm/pallas_agg.py`. The entry points keep the JAX
signatures and results, one for each TPU kernel:

- `fused_pass` (`_fused_pass`, row 1; with ``loop=True`` row 4): one sweep
  of ``len(shifts)`` distinct paths over an [X, L, D] int16 volume scanned
  along X, added to ``acc``;
- `fused_pass_batch` (`_fused_pass_batch`, row 2): the same over
  [B, X, L, D];
- `fused_pass_bidir` (`_fused_pass_bidir`, row 3): the forward and the
  backward sweep, returning ``acc`` plus both;
- `scan_direction` (row 5): one path in one direction over an int32
  [L, X, D] volume scanned along axis 1, returning the path cost itself;

and the two 8-path sums built on them: `aggregate_batch` (B problems,
rows 1-2, the rectified SGM) and `aggregate` (one problem, row 3, the
general-warp SGM).

For a CUDA tensor they launch a hand-written kernel of `csrc/sgm_agg.cu`
or raise: `sgm_sweep3_kernel`, one cooperative launch per sweep carrying
all its paths, for rows 1 and 4 and `aggregate_batch`'s vertical sweeps;
`sgm_path_kernel`, one launch per path, for the rest. For a CPU tensor
they run the plain version below, the `lax.scan` recurrence of
`smvs_tpu/sgm/stereo.py:aggregate` as a Python loop over the scan axis.
The TPU's pad to multiples of 8, its VMEM dispatch models and the ``xb``
blocking of row 4 are not needed: the kernels take any H, W and D <= 128,
the plane count of both SGM paths.

``launches`` counts kernel launches by TPU kernel row (and nothing else),
so a run can show which kernels it went through.
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

# The TPU kernels of `pallas_agg.py` by the entry point that replaces each
# (rows 1-5 of the kernel table in PERF.md).
ROWS = ("fused_pass", "fused_pass_batch", "fused_pass_bidir",
        "fused_pass_loop", "scan_direction")
launches = dict.fromkeys(ROWS, 0)  # kernel launches per row
_lib = None
_sweep_geometry_cache = {}  # (device, D) -> (tile, edge_words, resident)


def reset_launches() -> None:
    """Set every row's launch count to 0."""
    for row in ROWS:
        launches[row] = 0


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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.sgm_agg_sweep3
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.sgm_sweep3_geometry
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch_paths(row: str, cost, inten, out, dims, vstrides, istrides,
                  reverse: bool, shifts: tuple, p1: int, p2: int,
                  out_b=None) -> None:
    """One `sgm_path_kernel` launch per path. int16 volumes: ``out += path
    costs`` in place, and with ``out_b`` the reverse sweep in the same
    launch (``out_b += reverse path costs``). int32 volumes: ``out = path
    cost``.
    """
    fn = _library().sgm_agg_path
    B, X, L, D = dims
    add = cost.dtype == torch.int16
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        for shift in shifts:
            err = fn(cost.data_ptr(), inten.data_ptr(), out.data_ptr(),
                     None if out_b is None else out_b.data_ptr(),
                     cost.element_size(), int(add), B, X, L, D, *vstrides,
                     *istrides, 1 if out_b is None else 2, int(reverse),
                     int(shift), int(p1), int(p2), stream)
            if err != 0:
                raise RuntimeError(f"sgm_agg_path launch failed: CUDA error "
                                   f"{err}")
            launches[row] += 1


def sweep_geometry(device: torch.device, D: int) -> tuple:
    """(lines per block, edge-buffer words per block, most blocks resident
    at once) of the vertical sweep kernel for D depths on ``device``."""
    key = (device, D)
    if key not in _sweep_geometry_cache:
        vals = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(device):
            err = _library().sgm_sweep3_geometry(
                D, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"sgm_sweep3_geometry failed: CUDA error "
                               f"{err}")
        _sweep_geometry_cache[key] = tuple(v.value for v in vals)
    return _sweep_geometry_cache[key]


def _launch_sweep(row: str, cost, inten, out, dims, vstrides, istrides,
                  reverse: bool, shifts: tuple, p1: int, p2: int) -> None:
    """``out += path costs`` of all ``shifts`` (distinct, from 0, +1, -1)
    in place, in one cooperative `sgm_sweep3_kernel` launch per chunk of
    problems (one launch unless B problems exceed the resident blocks)."""
    if len(set(shifts)) != len(shifts) or not set(shifts) <= {0, 1, -1}:
        raise ValueError(f"the kernel takes distinct shifts from 0, 1 and "
                         f"-1, got {shifts}")
    fn = _library().sgm_agg_sweep3
    B, X, L, D = dims
    tile, edge_words, resident = sweep_geometry(cost.device, D)
    tiles = -(-L // tile)
    paths = sum({0: 1, 1: 2, -1: 4}[s] for s in shifts)
    vsize, isize = cost.element_size(), inten.element_size()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        for b0, nb in plan_chunks(B, tiles, resident):
            # Each word carries the scan step that wrote it; -1 is none.
            edge = torch.full((nb * tiles * edge_words,), -1,
                              dtype=torch.int64, device=cost.device)
            voff = b0 * vstrides[0] * vsize
            err = fn(cost.data_ptr() + voff,
                     inten.data_ptr() + b0 * istrides[0] * isize,
                     out.data_ptr() + voff, edge.data_ptr(), nb, X, L, D,
                     *vstrides, *istrides,
                     int(reverse), paths, int(p1), int(p2), stream)
            if err != 0:
                raise RuntimeError(f"sgm_agg_sweep3 launch failed: CUDA "
                                   f"error {err}")
            launches[row] += 1


def plan_chunks(B: int, tiles: int, resident: int) -> list:
    """``(first problem, problem count)`` of each launch of the vertical
    sweep kernel over B problems of ``tiles`` blocks each. Its blocks wait
    on their neighbours, so a launch may hold only as many blocks as the
    card keeps resident at once (``resident``); a problem is never split.
    """
    if tiles > resident:
        raise ValueError(f"one problem needs {tiles} resident blocks of the "
                         f"vertical sweep kernel; the card holds {resident}")
    per = resident // tiles
    return [(b, min(per, B - b)) for b in range(0, B, per)]


def _check(cost, inten, acc, vol_ndim: int, dtype=torch.int16) -> None:
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
        if cost.dtype != dtype or (acc is not None and acc.dtype != dtype):
            raise TypeError(f"the kernel takes {dtype} cost and accumulator")
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
# plain PyTorch versions (CPU tensors, tests, and the on-card comparison)


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


def plain_fused_pass_bidir(cost, inten, acc, shifts: tuple, p1: int,
                           p2: int) -> torch.Tensor:
    """Plain version of `fused_pass_bidir`: ``acc`` plus the forward and
    the backward paths in int32. cost/acc [X, L, D], inten [X, L]."""
    out = plain_fused_pass_batch(cost[None], inten[None], acc[None], False,
                                 shifts, p1, p2)
    return plain_fused_pass_batch(cost[None], inten[None], out, True,
                                  shifts, p1, p2)[0]


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


def plain_aggregate(cost, intensity, p1: int, p2: int) -> torch.Tensor:
    """Plain version of `aggregate`: the 8-path sum of one [H, W, D]
    volume in int32."""
    return plain_aggregate_batch(cost[None], intensity[None], p1, p2)[0]


def plain_scan_direction(cost, intensity, shift: int, p1: int, p2: int
                         ) -> torch.Tensor:
    """Plain version of `scan_direction`: the path cost [L, X, D] in the
    cost's dtype."""
    c = cost.transpose(0, 1)[None]  # [1, X, L, D]
    it = intensity.to(cost.dtype).transpose(0, 1)[None]
    zero = torch.zeros(c.shape, dtype=torch.int32, device=cost.device)
    out = plain_fused_pass_batch(c, it, zero, False, (shift,), p1, p2)
    return out[0].transpose(0, 1).to(cost.dtype).contiguous()


# ---------------------------------------------------------------------------
# entry points


def fused_pass_batch(cost: torch.Tensor, inten: torch.Tensor,
                     acc: torch.Tensor, reverse: bool, shifts: tuple,
                     p1: int, p2: int) -> torch.Tensor:
    """One scan sweep of ``len(shifts)`` paths over B problems.

    cost/acc [B, X, L, D] int16 scanned along X; inten [B, X, L] int32.
    Returns ``acc`` plus the path costs as a new int16 tensor.
    """
    return _fused_pass_batch(cost, inten, acc, reverse, shifts, p1, p2,
                             "fused_pass_batch")


def _fused_pass_batch(cost, inten, acc, reverse, shifts, p1, p2, row,
                      launch=_launch_paths):
    _check(cost, inten, acc, 4)
    if cost.device.type == "cpu":
        return plain_fused_pass_batch(cost, inten, acc, reverse, shifts,
                                      p1, p2).to(torch.int16)
    B, X, L, D = cost.shape
    out = acc.clone()
    launch(row, cost, inten, out, (B, X, L, D), (X * L * D, L * D, D),
           (X * L, L, 1), reverse, shifts, p1, p2)
    return out


def fused_pass(cost: torch.Tensor, inten: torch.Tensor, acc: torch.Tensor,
               reverse: bool, shifts: tuple, p1: int, p2: int,
               loop: bool = False, xb: int = 1) -> torch.Tensor:
    """One scan sweep of ``len(shifts)`` paths over one [X, L, D] int16
    volume scanned along X (inten [X, L] int32); returns acc + paths.

    ``loop`` selects the TPU's `fori_loop` kernel (row 4), which computes
    the same result; on the card both forms are one launch of the vertical
    sweep kernel, counted as row 4 when ``loop`` is set. ``xb``, that
    kernel's scan-block size on the TPU, is taken for the JAX signature and
    not read: the card has no counterpart.
    """
    _check(cost, inten, acc, 3)
    row = "fused_pass_loop" if loop else "fused_pass"
    return _fused_pass_batch(cost[None], inten[None], acc[None], reverse,
                             shifts, p1, p2, row, launch=_launch_sweep)[0]


def fused_pass_bidir(cost: torch.Tensor, inten: torch.Tensor,
                     acc: torch.Tensor, shifts: tuple, p1: int, p2: int
                     ) -> torch.Tensor:
    """Both scan directions of ``len(shifts)`` paths over one [X, L, D]
    int16 volume scanned along X (inten [X, L] int32); returns acc plus the
    forward and the backward paths as a new int16 tensor.

    On the card: one launch per path, its forward chains adding into the
    result and its backward chains into a second volume, added once at
    the end.
    """
    _check(cost, inten, acc, 3)
    if cost.device.type == "cpu":
        return plain_fused_pass_bidir(cost, inten, acc, shifts, p1,
                                      p2).to(torch.int16)
    X, L, D = cost.shape
    out = acc.clone()
    _sweep_bidir(cost, inten, out, (1, X, L, D), (X * L * D, L * D, D),
                 (X * L, L, 1), shifts, p1, p2)
    return out


def _sweep_bidir(cost, inten, out, dims, vstrides, istrides, shifts, p1, p2
                 ) -> None:
    """``out += forward and backward paths`` in place (row 3)."""
    bwd = torch.zeros_like(out)
    _launch_paths("fused_pass_bidir", cost, inten, out, dims, vstrides,
                  istrides, False, shifts, p1, p2, out_b=bwd)
    out += bwd


def aggregate(cost: torch.Tensor, intensity: torch.Tensor, p1: int, p2: int
              ) -> torch.Tensor:
    """All 8 SGM paths of one cost volume [H, W, D] (values <= 255) with
    intensities [H, W]; returns the int16 8-path sum.

    Casts like the JAX entry point (cost to int16, intensity to int32).
    On the card: four bidirectional launches (row 3), one horizontal
    (scan along W, no transposed copy) and three vertical/diagonal.
    """
    cost = cost.to(torch.int16).contiguous()
    intensity = intensity.to(torch.int32).contiguous()
    _check(cost, intensity, None, 3)
    if cost.device.type == "cpu":
        return plain_aggregate(cost, intensity, p1, p2).to(torch.int16)
    H, W, D = cost.shape
    acc = torch.zeros_like(cost)
    vb, ib = H * W * D, H * W
    _sweep_bidir(cost, intensity, acc, (1, W, H, D), (vb, D, W * D),
                 (ib, 1, W), (0,), p1, p2)
    _sweep_bidir(cost, intensity, acc, (1, H, W, D), (vb, W * D, D),
                 (ib, W, 1), (0, 1, -1), p1, p2)
    return acc


def aggregate_batch(cost: torch.Tensor, intensity: torch.Tensor, p1: int,
                    p2: int) -> torch.Tensor:
    """All 8 SGM paths for B cost volumes [B, H, W, D] (values <= 255)
    with intensities [B, H, W]; returns the int16 8-path sum.

    On the card: two horizontal launches (scan along W, no transposed
    copy), counted as row 2, and one launch of the vertical sweep kernel
    per vertical direction carrying the straight path and both diagonals,
    counted as row 1, accumulating in place.
    """
    _check(cost, intensity, None, 4)
    if cost.device.type == "cpu":
        return plain_aggregate_batch(cost, intensity, p1, p2).to(torch.int16)
    B, H, W, D = cost.shape
    acc = torch.zeros_like(cost)
    vb, ib = H * W * D, H * W
    for reverse in (False, True):  # horizontal: scan x, lines are rows
        _launch_paths("fused_pass_batch", cost, intensity, acc, (B, W, H, D),
                      (vb, D, W * D), (ib, 1, W), reverse, (0,), p1, p2)
    for reverse in (False, True):  # vertical + diagonals: scan y
        _launch_sweep("fused_pass", cost, intensity, acc, (B, H, W, D),
                      (vb, W * D, D), (ib, W, 1), reverse, (0, 1, -1), p1,
                      p2)
    return acc


def scan_direction(cost: torch.Tensor, intensity: torch.Tensor, shift: int,
                   p1: int, p2: int) -> torch.Tensor:
    """One path, one direction, along axis 1 of an int32 cost [L, X, D];
    intensity [L, X] is cast to the cost's dtype. Returns the path cost
    [L, X, D] (not accumulated)."""
    intensity = intensity.to(torch.int32).contiguous()
    if shift not in (-1, 0, 1):
        raise ValueError(f"shift must be -1, 0 or 1, got {shift}")
    _check(cost, intensity, None, 3, dtype=torch.int32)
    if cost.device.type == "cpu":
        return plain_scan_direction(cost, intensity, shift, p1, p2)
    L, X, D = cost.shape
    out = torch.empty_like(cost)
    _launch_paths("scan_direction", cost, intensity, out,
                  (1, X, L, D), (L * X * D, D, X * D), (L * X, 1, X), False,
                  (shift,), p1, p2)
    return out
