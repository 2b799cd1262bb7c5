"""SGM path-cost aggregation: the CUDA kernels and their plain PyTorch twins.

Port of `smvs_tpu/sgm/pallas_agg.py`. The entry points keep the JAX
signatures and results, one for each TPU kernel:

- `fused_pass` (`_fused_pass`, row 1; with ``loop=True`` row 4): one sweep
  of ``len(shifts)`` paths over an [X, L, D] int16 volume scanned along X,
  added to ``acc``;
- `fused_pass_batch` (`_fused_pass_batch`, row 2): the same over
  [B, X, L, D];
- `fused_pass_bidir` (`_fused_pass_bidir`, row 3): the forward and the
  backward sweep, returning ``acc`` plus both;
- `scan_direction` (row 5): one path in one direction over an int32
  [L, X, D] volume scanned along axis 1, returning the path cost itself;

and the two 8-path sums built on them: `aggregate_batch` (B problems,
rows 1-2, the rectified SGM) and `aggregate` (one problem, row 3, the
general-warp SGM).

`plan_route` chooses from the shape which hand-written kernel of
`csrc/sgm_agg.cu` runs each sweep of a call, before anything launches. Up
to 512 depths: `sgm_line_kernel` for a straight-only sweep (the
horizontal sweeps, and rows 2-3 with shifts (0,)), one launch writing or
adding the path costs; `sgm_sweep3_kernel` for a sweep of distinct shifts
with a diagonal, all its paths in one cooperative launch, where one
problem fits the blocks the card keeps resident (at 129 to 512 depths in
chunks of problems, one block an SM, a problem's lines spread over the
SMs); `sgm_path_kernel`, one launch per path, for the rest (a repeated
shift, a problem wider than the resident blocks) and for row 5: the line
kernel's design walking a chain (a straight line or a diagonal), one warp
per chain with a private cp.async ring of scan positions. At more
than 512 depths `sgm_deep_sweep_kernel` takes every sweep of distinct
shifts in one launch (a straight-only sweep over any number of lines; one
with a diagonal cooperatively, in chunks of problems whose lines the card
holds at once), and `sgm_deep_kernel`, one launch per path with one
chain's depths split evenly across the warps of a block (`deep_shape`,
`deep_slices`), each filling its own cp.async ring, the rest (a repeated
shift, a problem too wide, row 5). Row 3's vertical pair (the forward
and the backward sweep of distinct shifts with a diagonal) at D <= 128
takes one launch of `sgm_sweep3_kernel`'s two-walk form, whose blocks
walk their lines both ways at once, where all its blocks are resident.
`aggregate_batch` makes 2 line launches (row 2) and 2 sweep launches (row
1); `aggregate` 2 line launches and one two-walk launch, counted as row 3;
`fused_pass_bidir` 1 (2 for shifts (0,)); at 129 to 2048 depths on [640,
640, D] `aggregate` takes 4 and `fused_pass_bidir` 2. The sweeps of one call add
into one int16 accumulator in place: int16 sums wrap modulo 2^16, so
their order does not change the bits, and no second volume or copy is
needed.

For a CUDA tensor the entry points launch those kernels or raise. For a
CPU tensor they run the same plan through the plain sweep below, the
`lax.scan` recurrence of `smvs_tpu/sgm/stereo.py:aggregate` as a Python
loop over the scan axis. The TPU's pad to multiples of 8, its VMEM
dispatch models and the ``xb`` blocking of row 4 are not needed: the
kernels take any H and W. The line, sweep and path kernels hold a line in
one warp, built for 1-4, 8 and 16 depths per lane (D <= 128, the plane
count of both SGM paths by default, 256 and 512: more planes through
`SGMOptions.num_steps`), and the two deep kernels take 512 < D <= 16384
(``MAX_D``), up to 16 depths a lane and 32 warps a line. More depths raise on the card; the
plain sweep takes any D.

``launches`` counts kernel launches by TPU kernel row, and
``kernel_launches`` the same launches by CUDA kernel (and nothing else),
so a run can show which kernels it went through.
"""

from __future__ import annotations

import collections
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
# The library's sources: these kernels and the census and cost volume's
# (`csrc/sgm_cost.cu`, bound by `sgm.cuda_cost`).
SOURCES = (SOURCE, os.path.join(_PKG_DIR, "csrc", "sgm_cost.cu"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# The TPU kernels of `pallas_agg.py` by the entry point that replaces each
# (rows 1-5 of the kernel table in PERF.md).
ROWS = ("fused_pass", "fused_pass_batch", "fused_pass_bidir",
        "fused_pass_loop", "scan_direction")
launches = dict.fromkeys(ROWS, 0)  # kernel launches per row
# The CUDA kernels of `csrc/sgm_agg.cu` by their name in a plan (`Launch`).
KERNELS = {"line": "sgm_line_kernel", "sweep3": "sgm_sweep3_kernel",
           "sweep3_bidir": "sgm_sweep3_kernel<bidir>",
           "path": "sgm_path_kernel", "deep": "sgm_deep_kernel",
           "deep_sweep": "sgm_deep_sweep_kernel"}
kernel_launches = dict.fromkeys(KERNELS, 0)  # launches per CUDA kernel
_lib = None
_sweep_geometry_cache = {}  # (device, D) -> (tile, edge_words, resident)
_bidir_geometry_cache = {}  # (device, D, lines) -> (edge_words, resident)
_deep_geometry_cache = {}  # (device, D) -> (max_lines, edge_words, sms)

# Lines per block of sgm_sweep3_kernel (kTile in the source): every
# block's at D <= 128, the most a block holds beyond.
TILE = 16
# Depths of the sweep kernel's fixed tile of 16 lines (32 lanes x 4; the
# main path's), the most that the line, sweep and path kernels hold (32
# lanes x 16; kPathMaxD in the source), and the most that the deep kernels
# hold (32 warps of 512; kDeepMaxD).
SWEEP_MAX_D = 128
PATH_MAX_D = 512
MAX_D = 16384
# Blocks of sgm_sweep3_kernel the H100 keeps resident at once (two per SM,
# `sweep_geometry` at D = 128). CPU tensors are planned as for that card.
CPU_RESIDENT = 264
# The most lines a block of sgm_sweep3_kernel's two-walk form
# ("sweep3_bidir" in a plan, D <= 128) holds (kBidirMaxLines in the
# source): each line walked forward by one warp and backward by another,
# so 16 warps, as a block of the one-walk form, which the H100 also keeps
# two an SM (CPU_RESIDENT, the stand-in CPU tensors are planned with).
# `bidir_lines` chooses the lines a block from L.
BIDIR_LINES = 8
# The H100's SMs, shared memory a block may take, and sgm_deep_sweep_kernel's
# threads a block with a diagonal (kDeepSweepDiagThreads): the stand-in for
# `deep_sweep_geometry` that CPU tensors are planned with.
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448
DEEP_SWEEP_DIAG_THREADS = 640
# About how many warps of sgm_deep_kernel walk a chain (kDeepWarps in the
# source): `deep_shape` chooses the depths a lane from it.
DEEP_WARPS = 4
# sgm_sweep3_kernel's ring stages by depths a lane beyond 128 depths
# (Sweep3<K>::kStages in the source).
WIDE_SWEEP_STAGES = {8: 4, 16: 3}
# The plain run's stand-in for the card's uninitialised output before the
# first write, so that a plan which adds into it first gives other sums.
UNSET = 0x2AAA

# One kernel launch of a plan (`plan_route`). kernel: "line", "sweep3",
# "sweep3_bidir" (both directions of a scan-1 sweep in one launch),
# "path", "deep" or "deep_sweep"; scan: the axis of the [B, A, C, D] volume
# it scans (1 or 2; its lines run along the other); reverse: the
# direction (False for "sweep3_bidir": forward, then backward); mode:
# "write" (out = path costs), "into" (out = acc + path costs) or "add"
# (out += path costs in place); shifts: its paths; row: the TPU kernel row
# it counts under; b0, nb: the problems it takes; lines: lines per block
# of "deep_sweep" and "sweep3_bidir", and of "sweep3" beyond 128 depths (0
# where the kernel fixes its own).
Launch = collections.namedtuple(
    "Launch", "kernel scan reverse mode shifts row b0 nb lines",
    defaults=(0,))


def reset_launches() -> None:
    """Set every row's and every kernel's launch count to 0."""
    for row in ROWS:
        launches[row] = 0
    for k in KERNELS:
        kernel_launches[k] = 0


# ---------------------------------------------------------------------------
# build and binding


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the SGM kernels are built from "
                           f"{SOURCES} on a machine with the CUDA toolkit")
    return path


def library_path(defines: tuple = ()) -> str:
    """Where the built kernels live, keyed by the sources' content and the
    preprocessor ``defines`` (``"NAME=value"``) they were built with."""
    h = hashlib.sha256()
    for source in SOURCES:
        with open(source, "rb") as f:
            h.update(f.read())
    for d in defines:
        h.update(b"\0" + d.encode())
    return os.path.join(BUILD_DIR, f"libsgm_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False, defines: tuple = (),
          report: list | None = None) -> str:
    """Compile ``SOURCES`` into one library for sm_90a with nvcc (once per
    source version and ``defines``) and return its path. ``verbose``
    prints nvcc's register and spill report; a ``report`` list receives it
    instead."""
    out = library_path(defines)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *SOURCES]
    cmd[1:1] = [f"-D{d}" for d in defines]
    if verbose or report is not None:
        cmd[1:1] = ["-Xptxas", "-v"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        if report is not None:
            report.append(proc.stdout + proc.stderr)
        elif verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built library's functions."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sgm_agg_path.argtypes = ([ptr] * 3 + [i32] * 6 + [i64] * 6
                                 + [i32] * 4 + [ptr])
    lib.sgm_agg_deep.argtypes = lib.sgm_agg_path.argtypes
    lib.sgm_agg_line.argtypes = ([ptr] * 4 + [i32] * 4 + [i64] * 6
                                 + [i32] * 3 + [ptr])
    lib.sgm_agg_sweep3.argtypes = ([ptr] * 4 + [i32] * 4 + [i64] * 6
                                   + [i32] * 5 + [ptr])
    lib.sgm_sweep3_geometry.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
    lib.sgm_agg_sweep3_bidir.argtypes = ([ptr] * 4 + [i32] * 4 + [i64] * 6
                                         + [i32] * 4 + [ptr])
    lib.sgm_sweep3_bidir_geometry.argtypes = ([i32] * 2
                                              + [ctypes.POINTER(i32)] * 2)
    lib.sgm_agg_deep_sweep.argtypes = ([ptr] * 5 + [i32] * 4 + [i64] * 6
                                       + [i32] * 5 + [ptr])
    lib.sgm_deep_sweep_geometry.argtypes = lib.sgm_sweep3_geometry.argtypes
    for fn in (lib.sgm_agg_path, lib.sgm_agg_deep, lib.sgm_agg_line,
               lib.sgm_agg_sweep3, lib.sgm_sweep3_geometry,
               lib.sgm_agg_sweep3_bidir, lib.sgm_sweep3_bidir_geometry,
               lib.sgm_agg_deep_sweep, lib.sgm_deep_sweep_geometry):
        fn.restype = i32
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()))
    return _lib


def sweep_geometry(device: torch.device, D: int) -> tuple:
    """(lines per block, edge-buffer words per block, most blocks resident
    at once) of the vertical sweep kernel for D <= ``PATH_MAX_D`` depths
    on ``device``. Beyond ``SWEEP_MAX_D`` the lines are the most a block
    holds (0 where one line does not fit) and the blocks one per SM, as
    `plan_route` plans them (`sweep_stand_in` on the H100)."""
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


def bidir_lines(L: int, sms: int) -> int:
    """Lines a block of the two-walk form for a problem of L lines on a
    card of ``sms`` SMs: the lines spread evenly over one block an SM, or
    over two where one block would hold more than ``BIDIR_LINES``; 0 where
    two blocks an SM cannot hold them. What paces the form is a step's work
    on the busiest SM (`tools/bidir_pace.py`: at [1440, 1440, 128], 6 lines
    a block, 240 blocks, took 3.244 ms against 4.056 for 8 lines, 180
    blocks)."""
    for per_sm in (1, 2):
        lines = -(-L // (per_sm * sms))
        if lines <= BIDIR_LINES:
            return lines
    return 0


def bidir_geometry(device: torch.device, D: int,
                   lines: int = BIDIR_LINES) -> tuple:
    """(edge-buffer words per block, most blocks resident at once) of the
    vertical sweep kernel's two-walk form with ``lines`` lines a block at
    D <= ``SWEEP_MAX_D`` depths on ``device`` (its own occupancy query)."""
    key = (device, D, lines)
    if key not in _bidir_geometry_cache:
        vals = [ctypes.c_int() for _ in range(2)]
        with torch.cuda.device(device):
            err = _library().sgm_sweep3_bidir_geometry(
                D, lines, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"sgm_sweep3_bidir_geometry failed: CUDA "
                               f"error {err}")
        _bidir_geometry_cache[key] = tuple(v.value for v in vals)
    return _bidir_geometry_cache[key]


def wide_sweep_k(D: int) -> int:
    """Depths a lane of the line and sweep kernels at ``SWEEP_MAX_D`` < D
    <= ``PATH_MAX_D``: 8 to 256 depths, 16 beyond."""
    return 8 if D <= 256 else 16


def sweep_smem_bytes(lines: int, D: int) -> int:
    """Shared memory of a `sgm_sweep3_kernel` block of ``lines`` lines at
    ``SWEEP_MAX_D`` < D <= ``PATH_MAX_D`` (``sweep3_layout`` in the
    source: both diagonals' lines by step parity in rows of 32 K ints, a
    ring of each line's cost and accumulator in rows of 32 K + 8 int16,
    the intensities, the P2a table)."""
    K = wide_sweep_k(D)
    S, row = WIDE_SWEEP_STAGES[K], 32 * K
    return (16 * (lines + 2) * row + 4 * S * lines * (row + 8)
            + 4 * S * (lines + 2) + 4 * 256)


def sweep_stand_in(D: int) -> tuple:
    """`sweep_geometry` as the H100 gives it at ``SWEEP_MAX_D`` < D <=
    ``PATH_MAX_D``, computed: (most lines a block holds, at most ``TILE``
    and within 227 KB of shared memory; edge words per block, 2 slots of
    2 lines of 32 K; blocks resident, one per SM). CPU tensors are planned
    with it."""
    lines = TILE
    while lines and sweep_smem_bytes(lines, D) > H100_SMEM_PER_BLOCK:
        lines -= 1
    return lines, 4 * 32 * wide_sweep_k(D), H100_SMS


def deep_sweep_shape(D: int, diag: bool = False) -> tuple:
    """(warps per line W, depths per lane K) of `sgm_deep_sweep_kernel` at
    D > ``PATH_MAX_D`` depths (``deep_sweep_shape`` in the source). Straight
    only: W = ceil(D / 512), K = ceil(D / (32 W)) rounded up to even. With
    a diagonal (``diag``), about 4 warps a line: K = ceil(D / 128) rounded
    up to even, at most 16, and W = ceil(D / (32 K))."""
    if diag:
        k = -(-D // 128)
        k = min(k + (k & 1), 16)
        return -(-D // (32 * k)), k
    W = -(-D // PATH_MAX_D)
    k = -(-D // (32 * W))
    return W, k + (k & 1)


def deep_shape(D: int, warps: int = DEEP_WARPS) -> tuple:
    """(warps per chain W, depths per lane K) of `sgm_deep_kernel` at D >
    ``PATH_MAX_D`` depths (``deep_shape`` in the source, built with
    ``SGM_DEEP_WARPS`` = ``warps``): K = ceil(D / (32 warps)) rounded up to
    even, so that about ``warps`` warps walk a chain, at least what keeps W
    <= 32 and no less than at D = 513, at most 16; W = ceil(D / (32 K)).
    With a diagonal `deep_sweep_shape` gives the same at 4 warps."""
    def even(k):
        return k + (k & 1)
    k = max(even(-(-D // (32 * warps))), even(-(-(PATH_MAX_D + 1)
                                                // (32 * warps))),
            even(-(-D // (32 * 32))))
    k = min(k, 16)
    return -(-D // (32 * k)), k


def deep_slices(D: int, warps: int = DEEP_WARPS) -> list:
    """Each warp's (first depth, depths) of a chain in `sgm_deep_kernel`
    (``deep_slice`` in the source): the ceil(D / K) lane runs of K depths
    spread evenly over the W warps of `deep_shape`, the first (runs % W)
    warps one run more."""
    W, K = deep_shape(D, warps)
    runs = -(-D // K)
    q, rem = divmod(runs, W)
    out = []
    for w in range(W):
        first = (w * q + min(w, rem)) * K
        out.append((first, min((q + (w < rem)) * K, D - first)))
    return out


def _align16(x: int) -> int:
    return (x + 15) & ~15


def deep_sweep_smem_bytes(lines: int, D: int) -> int:
    """Shared memory of a `sgm_deep_sweep_kernel` block of ``lines`` lines
    with a diagonal (``deep_sweep_layout`` in the source: both diagonals'
    lines by step parity, a 2-stage cost ring of rows of Dp + 8, the
    intensities, the P2a table, the warps' minima and ends)."""
    W, K = deep_sweep_shape(D, diag=True)
    Dp, S = 32 * W * K, 2
    return (_align16(16 * lines * Dp) + _align16(2 * S * lines * (Dp + 8))
            + _align16(4 * S * (lines + 2))
            + 4 * 256 + _align16(24 * lines * W) + _align16(16 * lines * W))


def deep_sweep_stand_in(D: int) -> tuple:
    """`deep_sweep_geometry` as the H100 gives it, computed: (most lines a
    block with a diagonal holds, edge words per block, SMs). CPU tensors
    are planned with it."""
    W, K = deep_sweep_shape(D, diag=True)
    lines = DEEP_SWEEP_DIAG_THREADS // (32 * W)
    while lines and deep_sweep_smem_bytes(lines, D) > H100_SMEM_PER_BLOCK:
        lines -= 1
    return lines, 8 * (32 * W * K + 32), H100_SMS


def deep_sweep_geometry(device: torch.device, D: int) -> tuple:
    """(most lines a block of `sgm_deep_sweep_kernel` with a diagonal
    holds, edge-buffer words per block, SMs) on ``device`` at D depths
    (512 < D <= ``MAX_D``); 0 lines where one line does not fit."""
    key = (device, D)
    if key not in _deep_geometry_cache:
        vals = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(device):
            err = _library().sgm_deep_sweep_geometry(
                D, *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"sgm_deep_sweep_geometry failed: CUDA error "
                               f"{err}")
        _deep_geometry_cache[key] = tuple(v.value for v in vals)
    return _deep_geometry_cache[key]


def plan_geometry(cost: torch.Tensor) -> dict:
    """``plan_route``'s ``resident``, ``tile``, ``D``, ``wide``, ``deep``
    and ``bidir`` for ``cost``'s device and depth count."""
    D = cost.shape[-1]
    cpu = cost.device.type == "cpu"
    geo = {"resident": CPU_RESIDENT, "tile": TILE, "D": D}
    if D > PATH_MAX_D:
        # Beyond PATH_MAX_D only the deep kernels run, so only theirs is
        # asked.
        lines, _, sms = (deep_sweep_stand_in(D) if cpu
                         else deep_sweep_geometry(cost.device, D))
        geo["deep"] = (lines, sms)
    elif D > SWEEP_MAX_D:
        lines, _, sms = (sweep_stand_in(D) if cpu
                         else sweep_geometry(cost.device, D))
        geo["wide"] = (lines, sms)
    elif not cpu:
        geo["tile"], _, geo["resident"] = sweep_geometry(cost.device, D)
        # The two-walk form's blocks resident at the lines a block it takes
        # for the scan-1 sweeps' lines (the volume's second-last axis).
        sms = torch.cuda.get_device_properties(
            cost.device).multi_processor_count
        lines = bidir_lines(cost.shape[-2], sms)
        geo["bidir"] = (sms, bidir_geometry(cost.device, D, lines)[1]
                        if lines else 0)
    return geo


# ---------------------------------------------------------------------------
# routes


def path_kernel(D: int) -> str:
    """The kernel that runs one path per launch at D depths: "path"
    (`sgm_path_kernel`, one warp per chain, each with a private ring of
    scan positions filled by cp.async ahead of the walk) up to
    ``PATH_MAX_D``, "deep" (`sgm_deep_kernel`, a block of `deep_shape`'s
    W warps per chain, each walking its slice of the depths with its own
    ring) above."""
    return "path" if D <= PATH_MAX_D else "deep"


def deep_sweep_chunks(B: int, L: int, max_lines: int, sms: int):
    """``(first problem, problem count, lines per block)`` of each
    cooperative launch of a sweep with a diagonal over B problems of L
    lines (`sgm_deep_sweep_kernel`, and `sgm_sweep3_kernel` at 129 to 512
    depths), or None where one problem does not fit. Its blocks wait on
    their neighbours, so a launch holds at most one block (of at most
    ``max_lines`` lines) per SM; a problem is never split, and its lines
    spread evenly over the SMs its launch leaves it."""
    if max_lines < 1 or -(-L // max_lines) > sms:
        return None
    per = sms // -(-L // max_lines)
    return [(b0, min(per, B - b0), -(-L // (sms // min(per, B - b0))))
            for b0 in range(0, B, per)]


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


def plan_route(entry: str, B: int, L: int, resident: int,
               shifts: tuple | None = None, reverse: bool = False,
               tile: int = TILE, D: int = SWEEP_MAX_D,
               wide: tuple | None = None, deep: tuple | None = None,
               bidir: tuple | None = None) -> list:
    """The kernel launches (`Launch`) of one call of the entry point
    ``entry``, in order, chosen from the shape alone.

    B problems whose scan-1 sweep has L lines (W for `aggregate_batch`
    and `aggregate`, whose horizontal sweeps scan axis 2 with shifts (0,)
    and vertical ones axis 1 with (0, 1, -1)); ``shifts`` and ``reverse``
    as the other entry points take them; ``resident`` blocks of ``tile``
    lines of `sgm_sweep3_kernel` fit the card at once (D <= 128); D
    depths; ``wide`` = (most lines a `sgm_sweep3_kernel` block holds, SMs)
    at 128 < D <= 512, and ``deep`` = (most lines a block of
    `sgm_deep_sweep_kernel` with a diagonal holds, SMs) beyond, by default
    the H100's (`sweep_stand_in`, `deep_sweep_stand_in`); ``bidir`` =
    (SMs, blocks of `sgm_sweep3_kernel`'s two-walk form resident at once
    at the lines a block `bidir_lines` gives for L) at D <= 128, by
    default (``H100_SMS``, ``CPU_RESIDENT``).

    A straight-only sweep takes `sgm_line_kernel` (row 1 keeps its sweep
    kernel); distinct shifts take `sgm_sweep3_kernel` where one problem
    fits the resident blocks (in chunks of problems: `plan_chunks`, at 128
    < D <= 512 `deep_sweep_chunks`, one block an SM); anything else one
    `sgm_path_kernel` launch per path. At D > ``PATH_MAX_D`` a sweep of
    distinct shifts takes one `sgm_deep_sweep_kernel` launch (straight
    only: every problem; with a diagonal: per chunk of problems whose lines
    the card holds at once, `deep_sweep_chunks`), and anything else one
    `sgm_deep_kernel` launch per path. Row 3's vertical pair (both
    directions of distinct shifts with a diagonal: `fused_pass_bidir`, and
    `aggregate`'s vertical sweeps) at D <= 128 takes one launch of the
    two-walk form ("sweep3_bidir") where all its blocks are resident at
    once, and the two sweeps above otherwise. The first launch on a problem
    may write ("write" or "into"), or add into a copy of acc ("add"); every
    later one adds in place. The sgm_path and sgm_deep kernels and
    `sgm_sweep3_kernel` only add, so where they take a sweep that starts
    with "into", they add into a copy.
    """
    tiles = -(-L // tile)
    small = D <= PATH_MAX_D  # the line and sweep kernels' reach
    per_path = path_kernel(D)
    if D > PATH_MAX_D and deep is None:
        deep = deep_sweep_stand_in(D)[::2]
    if SWEEP_MAX_D < D <= PATH_MAX_D and wide is None:
        wide = sweep_stand_in(D)[::2]
    if bidir is None:
        bidir = (H100_SMS, CPU_RESIDENT)

    def sweep(row, scan, rev, paths, first, line=True):
        if D > PATH_MAX_D and len(set(paths)) == len(paths):
            if paths == (0,):
                return [Launch("deep_sweep", scan, rev, first, paths, row, 0,
                               B, 1)]
            chunks = deep_sweep_chunks(B, L, *deep)
            if chunks is not None:
                return [Launch("deep_sweep", scan, rev, first, paths, row,
                               b0, nb, n) for b0, nb, n in chunks]
        if paths == (0,) and line and small:
            return [Launch("line", scan, rev, first, paths, row, 0, B)]
        if len(set(paths)) == len(paths) and small:
            if D <= SWEEP_MAX_D and tiles <= resident:
                return [Launch("sweep3", scan, rev, "add", paths, row, b0,
                               nb) for b0, nb in plan_chunks(B, tiles,
                                                             resident)]
            chunks = (deep_sweep_chunks(B, L, *wide) if D > SWEEP_MAX_D
                      else None)
            if chunks is not None:
                return [Launch("sweep3", scan, rev, "add", paths, row, b0,
                               nb, n) for b0, nb, n in chunks]
        # The path kernel writes (the first launch of an 8-path sum) or
        # adds; "into" adds into a copy of acc.
        return [Launch(per_path, scan, rev,
                       "write" if first == "write" and i == 0 else "add",
                       (s,), row, 0, B) for i, s in enumerate(paths)]

    def both(row, paths, first):
        """The forward and the backward scan-1 sweep of ``paths``."""
        sms, held = bidir
        lines = bidir_lines(L, sms)
        if (lines and D <= SWEEP_MAX_D and any(paths)
                and len(set(paths)) == len(paths) and -(-L // lines) <= held):
            return [Launch("sweep3_bidir", 1, False, "add", paths, row, b0,
                           nb, lines)
                    for b0, nb in plan_chunks(B, -(-L // lines), held)]
        return (sweep(row, 1, False, paths, first)
                + sweep(row, 1, True, paths, "add"))

    if entry == "aggregate_batch":
        h, v = "fused_pass_batch", "fused_pass"
        return (sweep(h, 2, False, (0,), "write") + sweep(h, 2, True, (0,), "add")
                + sweep(v, 1, False, (0, 1, -1), "add")
                + sweep(v, 1, True, (0, 1, -1), "add"))
    if entry == "aggregate":
        r = "fused_pass_bidir"
        return (sweep(r, 2, False, (0,), "write") + sweep(r, 2, True, (0,), "add")
                + both(r, (0, 1, -1), "add"))
    shifts = tuple(shifts)
    valid = set(shifts) <= {0, 1, -1}
    if not shifts or not valid:
        raise ValueError(f"the kernels take one or more shifts from 0, 1 "
                         f"and -1, got {shifts}")
    if entry in ("fused_pass", "fused_pass_loop"):
        return sweep(entry, 1, reverse, shifts, "into", line=False)
    if entry == "fused_pass_batch":
        return sweep(entry, 1, reverse, shifts, "into")
    if entry == "fused_pass_bidir":
        return both(entry, shifts, "into")
    raise ValueError(f"no route for the entry point {entry!r}")


def per_path_plan(plan: list, D: int) -> list:
    """``plan`` with every launch of several paths split into one launch
    per path of the path kernel for D depths (`path_kernel`): the route
    that one-path-per-launch kernels take, for timing against the plan. A
    first "into" becomes an "add" into a copy of acc."""
    out = []
    for ln in plan:
        dirs = (False, True) if ln.kernel == "sweep3_bidir" else (ln.reverse,)
        for j, rev in enumerate(dirs):
            for i, s in enumerate(ln.shifts):
                mode = ln.mode if ln.mode == "write" and i + j == 0 else "add"
                out.append(Launch(path_kernel(D), ln.scan, rev, mode, (s,),
                                  ln.row, ln.b0, ln.nb))
    return out


def plan_bytes(plan: list, shape: tuple, elem: int = 2) -> int:
    """Bytes the launches of ``plan`` over a [B, A, C, D] volume of
    ``elem``-byte elements must move: each sweep of a launch (two for
    "sweep3_bidir") reads its problems' cost and int32 intensities once,
    its accumulator once unless it writes, and writes its result once."""
    B, A, C, D = shape
    per = A * C * D
    return sum(ln.nb * (1 + (ln.kernel == "sweep3_bidir"))
               * (per * elem * (2 + (ln.mode != "write")) + 4 * A * C)
               for ln in plan)


def run_plan(plan: list, cost, inten, acc, p1: int, p2: int,
             on_launch=None) -> torch.Tensor:
    """Runs ``plan`` over ``cost`` [B, A, C, D] with ``inten`` [B, A, C]
    int32 and ``acc`` (like ``cost``; None where no launch reads it) and
    returns the result in ``cost``'s dtype: the kernels for CUDA tensors,
    the plain sweep for CPU tensors. On the card, ``on_launch(i)`` (if
    given) is called just before launch i and once after the last (i =
    ``len(plan)``), where a caller can record CUDA events.
    """
    covered = set()  # problems an earlier launch has written
    for i, ln in enumerate(plan):
        probs = set(range(ln.b0, ln.b0 + ln.nb))
        if ((ln.mode != "add" and probs & covered)
                or (ln.mode == "add" and not probs <= covered
                    and plan[0].mode != "add")
                or (ln.mode == "into" and acc is None)):
            raise ValueError(f"launch {i} cannot {ln.mode}: only the first "
                             "launch on a problem writes, every first launch "
                             "writes or none does, and 'into' reads acc")
        covered |= probs
    if acc is None and plan[0].mode == "add":
        raise ValueError("the plan adds into an accumulator; none given")
    if cost.device.type == "cpu":
        return plain_run_plan(plan, cost, inten, acc, p1, p2)
    lib = _library()
    B, A, C, D = cost.shape
    vb, ib = A * C * D, A * C
    esize = cost.element_size()
    by_scan = {1: ((A, C), (C * D, D), (C, 1)),
               2: ((C, A), (D, C * D), (1, C))}
    out = acc.clone() if plan[0].mode == "add" else torch.empty_like(cost)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        for i, ln in enumerate(plan):
            if on_launch is not None:
                on_launch(i)
            (X, L), (vx, vl), (ix, il) = by_scan[ln.scan]
            voff = ln.b0 * vb * esize
            ptrs = (cost.data_ptr() + voff,
                    inten.data_ptr() + ln.b0 * ib * inten.element_size())
            dims = (ln.nb, X, L, D, vb, vx, vl, ib, ix, il, int(ln.reverse))
            if ln.kernel == "line":
                src = {"write": None, "into": acc, "add": out}[ln.mode]
                err = lib.sgm_agg_line(
                    *ptrs, None if src is None else src.data_ptr() + voff,
                    out.data_ptr() + voff, *dims, int(p1), int(p2), stream)
            elif ln.kernel == "deep_sweep":
                src = {"write": None, "into": acc, "add": out}[ln.mode]
                paths = sum({0: 1, 1: 2, -1: 4}[s] for s in ln.shifts)
                edge = None
                if paths & 6:
                    _, edge_words, _ = deep_sweep_geometry(cost.device, D)
                    # Each word carries the scan step that wrote it; -1 is
                    # none.
                    edge = torch.full(
                        (ln.nb * -(-L // ln.lines) * edge_words,), -1,
                        dtype=torch.int64, device=cost.device)
                err = lib.sgm_agg_deep_sweep(
                    *ptrs, None if src is None else src.data_ptr() + voff,
                    out.data_ptr() + voff,
                    None if edge is None else edge.data_ptr(), *dims, paths,
                    int(p1), int(p2), ln.lines, stream)
            elif ln.kernel == "sweep3_bidir":
                edge_words, _ = bidir_geometry(cost.device, D, ln.lines)
                # Each word carries the scan step that wrote it; -1 is none.
                edge = torch.full((ln.nb * -(-L // ln.lines) * edge_words,),
                                  -1, dtype=torch.int64, device=cost.device)
                paths = sum({0: 1, 1: 2, -1: 4}[s] for s in ln.shifts)
                err = lib.sgm_agg_sweep3_bidir(
                    *ptrs, out.data_ptr() + voff, edge.data_ptr(), *dims[:-1],
                    paths, int(p1), int(p2), ln.lines, stream)
            elif ln.kernel == "sweep3":
                tile, edge_words, _ = sweep_geometry(cost.device, D)
                lines = ln.lines or tile
                # Each word carries the scan step that wrote it; -1 is none.
                edge = torch.full((ln.nb * -(-L // lines) * edge_words,), -1,
                                  dtype=torch.int64, device=cost.device)
                paths = sum({0: 1, 1: 2, -1: 4}[s] for s in ln.shifts)
                err = lib.sgm_agg_sweep3(
                    *ptrs, out.data_ptr() + voff, edge.data_ptr(), *dims,
                    paths, int(p1), int(p2), lines, stream)
            else:
                (shift,) = ln.shifts
                if ln.mode == "into":
                    raise ValueError("the path kernel writes or adds")
                fn = lib.sgm_agg_deep if ln.kernel == "deep" else \
                    lib.sgm_agg_path
                err = fn(
                    *ptrs, out.data_ptr() + voff, esize,
                    int(ln.mode == "add"), *dims, shift, int(p1), int(p2),
                    stream)
            if err != 0:
                raise RuntimeError(f"the {ln.kernel} kernel's launch failed: "
                                   f"CUDA error {err}")
            launches[ln.row] += 1
            kernel_launches[ln.kernel] += 1
        if on_launch is not None:
            on_launch(len(plan))
    return out


def plain_run_plan(plan, cost, inten, acc, p1, p2) -> torch.Tensor:
    """Plain version of `run_plan`: the plain sweep for each launch (the
    forward and the backward one for "sweep3_bidir"), in its mode, in int32
    (int16 sums wrap to the same bits at the end)."""
    if plan[0].mode == "add":
        out = acc.to(torch.int32, copy=True)
    else:
        out = torch.full(cost.shape, UNSET, dtype=torch.int32,
                         device=cost.device)
    for ln in plan:
        pb = slice(ln.b0, ln.b0 + ln.nb)
        c, i = cost[pb], inten[pb]
        if ln.scan == 2:
            c, i = c.transpose(1, 2), i.transpose(1, 2)
        path = plain_paths(c, i, ln.reverse, ln.shifts, p1, p2)
        if ln.kernel == "sweep3_bidir":  # forward, then backward
            path += plain_paths(c, i, True, ln.shifts, p1, p2)
        if ln.scan == 2:
            path = path.transpose(1, 2)
        if ln.mode == "write":
            out[pb] = path
        elif ln.mode == "into":
            out[pb] = acc[pb].to(torch.int32) + path
        else:
            out[pb] += path
    return out.to(cost.dtype)


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
        if not 1 <= cost.shape[-1] <= MAX_D:
            raise ValueError(f"the kernels take 1 <= D <= {MAX_D} depths, "
                             f"got D = {cost.shape[-1]}")
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


def plain_paths(cost, inten, reverse: bool, shifts: tuple, p1: int,
                p2: int) -> torch.Tensor:
    """The plain sweep: the sum of the path costs of ``shifts`` in int32.
    cost [B, X, L, D] scanned along X, inten [B, X, L]."""
    B, X, L, D = cost.shape
    out = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
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


def plain_fused_pass_batch(cost, inten, acc, reverse: bool, shifts: tuple,
                           p1: int, p2: int) -> torch.Tensor:
    """Plain version of `fused_pass_batch`: returns ``acc`` plus the paths
    in int32. cost/acc [B, X, L, D], inten [B, X, L]."""
    return acc.to(torch.int32) + plain_paths(cost, inten, reverse, shifts,
                                             p1, p2)


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
    it = intensity.transpose(0, 1)[None]
    out = plain_paths(c, it, False, (shift,), p1, p2)
    return out[0].transpose(0, 1).to(cost.dtype).contiguous()


# ---------------------------------------------------------------------------
# entry points


def fused_pass_batch(cost: torch.Tensor, inten: torch.Tensor,
                     acc: torch.Tensor, reverse: bool, shifts: tuple,
                     p1: int, p2: int) -> torch.Tensor:
    """One scan sweep of ``len(shifts)`` paths over B problems.

    cost/acc [B, X, L, D] int16 scanned along X; inten [B, X, L] int32.
    Returns ``acc`` plus the path costs as a new int16 tensor. On the card
    (`plan_route`): shifts (0,) is one `sgm_line_kernel` launch writing
    acc + path into the result; distinct shifts with a diagonal one
    `sgm_sweep3_kernel` launch (at 129 to 512 depths one per chunk of
    problems); anything else one launch per path. Beyond
    512 depths distinct shifts take one `sgm_deep_sweep_kernel` launch
    writing acc + paths into the result (per chunk of problems with a
    diagonal).
    """
    _check(cost, inten, acc, 4)
    B, X, L, D = cost.shape
    plan = plan_route("fused_pass_batch", B, L, shifts=shifts,
                      reverse=reverse, **plan_geometry(cost))
    return run_plan(plan, cost, inten, acc, p1, p2)


def fused_pass(cost: torch.Tensor, inten: torch.Tensor, acc: torch.Tensor,
               reverse: bool, shifts: tuple, p1: int, p2: int,
               loop: bool = False, xb: int = 1) -> torch.Tensor:
    """One scan sweep of ``len(shifts)`` paths over one [X, L, D] int16
    volume scanned along X (inten [X, L] int32); returns acc + paths.

    ``loop`` selects the TPU's `fori_loop` kernel (row 4), which computes
    the same result; on the card both forms are one launch of the vertical
    sweep kernel for distinct shifts, counted as row 4 when ``loop`` is set
    (one `sgm_path_kernel` launch per path, as the JAX kernel keeps one
    scratch line per listed shift, for a repeated shift or a problem wider
    than the resident blocks). At D > 512 distinct shifts take
    one `sgm_deep_sweep_kernel` launch writing acc + paths into the result
    where the card holds the problem's lines at once, and anything else
    one `sgm_deep_kernel` launch per path. ``xb``, that
    kernel's scan-block size on the TPU, is taken for the JAX signature and
    not read: the card has no counterpart.
    """
    _check(cost, inten, acc, 3)
    X, L, D = cost.shape
    plan = plan_route("fused_pass_loop" if loop else "fused_pass", 1, L,
                      shifts=shifts, reverse=reverse, **plan_geometry(cost))
    return run_plan(plan, cost[None], inten[None], acc[None], p1, p2)[0]


def fused_pass_bidir(cost: torch.Tensor, inten: torch.Tensor,
                     acc: torch.Tensor, shifts: tuple, p1: int, p2: int
                     ) -> torch.Tensor:
    """Both scan directions of ``len(shifts)`` paths over one [X, L, D]
    int16 volume scanned along X (inten [X, L] int32); returns acc plus the
    forward and the backward paths as a new int16 tensor.

    On the card: distinct shifts with a diagonal at D <= 128 take one
    launch of `sgm_sweep3_kernel`'s two-walk form (both directions adding
    into a copy of acc in place) where its blocks are all resident;
    otherwise the forward sweep, then the backward one adding into the
    same result in place (2 launches for (0,) or distinct shifts with a
    diagonal where the card holds the problem's lines at once; one launch
    per path and direction otherwise).
    """
    _check(cost, inten, acc, 3)
    X, L, D = cost.shape
    plan = plan_route("fused_pass_bidir", 1, L, shifts=shifts,
                      **plan_geometry(cost))
    return run_plan(plan, cost[None], inten[None], acc[None], p1, p2)[0]


def aggregate(cost: torch.Tensor, intensity: torch.Tensor, p1: int, p2: int
              ) -> torch.Tensor:
    """All 8 SGM paths of one cost volume [H, W, D] (values <= 255) with
    intensities [H, W]; returns the int16 8-path sum.

    Casts like the JAX entry point (cost to int16, intensity to int32).
    On the card, counted as row 3: the two horizontal `sgm_line_kernel`
    launches and, at D <= 128, one launch of `sgm_sweep3_kernel`'s
    two-walk form for both vertical sweeps, 3 launches; beyond 128 depths
    (or W lines wider than the two-walk form's resident blocks)
    `aggregate_batch`'s 4 launches for one problem (at D > 512 all four
    `sgm_deep_sweep_kernel`), where the card holds the W lines at once;
    else the vertical sweeps take one launch per path (`sgm_path_kernel`,
    beyond 512 `sgm_deep_kernel`).
    """
    cost = cost.to(torch.int16).contiguous()
    intensity = intensity.to(torch.int32).contiguous()
    _check(cost, intensity, None, 3)
    H, W, D = cost.shape
    plan = plan_route("aggregate", 1, W, **plan_geometry(cost))
    return run_plan(plan, cost[None], intensity[None], None, p1, p2)[0]


def aggregate_batch(cost: torch.Tensor, intensity: torch.Tensor, p1: int,
                    p2: int) -> torch.Tensor:
    """All 8 SGM paths for B cost volumes [B, H, W, D] (values <= 255)
    with intensities [B, H, W]; returns the int16 8-path sum.

    On the card: two horizontal `sgm_line_kernel` launches (scan along W,
    no transposed copy; the first writes the path cost, so nothing is
    zeroed), counted as row 2, and one `sgm_sweep3_kernel` launch per
    vertical direction carrying the straight path and both diagonals,
    counted as row 1, all into one accumulator (at 129 to 512 depths one
    per chunk of problems whose W lines the card holds at once). At D >
    512 the same four sweeps take `sgm_deep_sweep_kernel` (the vertical
    ones per chunk of problems, likewise).
    """
    _check(cost, intensity, None, 4)
    B, H, W, D = cost.shape
    plan = plan_route("aggregate_batch", B, W, **plan_geometry(cost))
    return run_plan(plan, cost, intensity, None, p1, p2)


def scan_direction(cost: torch.Tensor, intensity: torch.Tensor, shift: int,
                   p1: int, p2: int) -> torch.Tensor:
    """One path, one direction, along axis 1 of an int32 cost [L, X, D];
    intensity [L, X] is cast to int32. Returns the path cost [L, X, D] (not
    accumulated): one `sgm_path_kernel` launch on the card
    (`sgm_deep_kernel` at D > 512)."""
    intensity = intensity.to(torch.int32).contiguous()
    if shift not in (-1, 0, 1):
        raise ValueError(f"shift must be -1, 0 or 1, got {shift}")
    _check(cost, intensity, None, 3, dtype=torch.int32)
    plan = [Launch(path_kernel(cost.shape[-1]), 2, False, "write", (shift,),
                   "scan_direction", 0, 1)]
    return run_plan(plan, cost[None], intensity[None], None, p1, p2)[0]
