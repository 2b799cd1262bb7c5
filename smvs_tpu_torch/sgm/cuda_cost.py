"""The SGM census and the rectified sweep's Hamming cost volume on the card.

`census_transform` and `disparity_cost` launch the hand-written kernels of
`csrc/sgm_cost.cu` on CUDA tensors, and raise on anything they do not
take: `census_kernel`, the 9 x 7 census of a batch of images in one
launch, and `census_cost_kernel`, one direction's whole [H, W, D] int16
cost volume of the rectified sweep in one launch (blend, census, Hamming
distance and the invalid fill of every plane, the plane offsets taken
from ``shifts`` on the card). `sgm.stereo` calls them for CUDA tensors;
its plain PyTorch code (`stereo.plain_census_transform`,
`stereo.plain_disparity_cost`) is their twin on the CPU, bit for bit.
They replace no TPU kernel: the JAX package leaves the cost volume to
XLA.

They are built into `cuda_agg`'s library (`cuda_agg.build`).
``launches`` counts the launches by kernel: 4 a rectified pair (the two
images' censuses and one cost volume a direction). The aggregation's
`cuda_agg.launches` does not count them.
"""

from __future__ import annotations

import ctypes

import torch

from smvs_tpu_torch.sgm import cuda_agg

SOURCE = cuda_agg.SOURCES[1]
KERNELS = ("census_kernel", "census_cost_kernel")
launches = dict.fromkeys(KERNELS, 0)  # kernel launches by kernel

_lib = None


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        launches[k] = 0


def _library() -> ctypes.CDLL:
    """`cuda_agg`'s library, which holds these kernels too, with their C
    signatures declared."""
    global _lib
    if _lib is None:
        lib = cuda_agg._library()
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sgm_census.argtypes = [ptr, ptr] + [i32] * 3 + [ptr]
        lib.sgm_census_cost.argtypes = [ptr] * 4 + [i32] * 4 + [i64] * 3 \
            + [ptr]
        lib.sgm_cost_plan.argtypes = [i32] * 5 + [ctypes.POINTER(i32)] * 2
        for fn in (lib.sgm_census, lib.sgm_census_cost, lib.sgm_cost_plan):
            fn.restype = i32
        _lib = lib
    return _lib


def cost_plan(h: int, w: int, wn: int, D: int, sms: int) -> tuple:
    """(planes a block, window columns) that `census_cost_kernel` takes for
    an [h, w, D] volume against an [h, wn] neighbor on a card of ``sms``
    SMs, as `csrc/sgm_cost.cu` plans each launch."""
    group, cap = ctypes.c_int(), ctypes.c_int()
    err = _library().sgm_cost_plan(h, w, wn, D, sms, ctypes.byref(group),
                                   ctypes.byref(cap))
    if err != 0:
        raise ValueError(f"no census_cost_kernel plan for [{h}, {w}, {D}] "
                         f"against {wn} columns on {sms} SMs")
    return group.value, cap.value


def _require(name: str, t: torch.Tensor, dtype: torch.dtype,
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def census_transform(img: torch.Tensor) -> torch.Tensor:
    """`stereo.census_transform` of [..., H, W] float32 intensities on the
    card: one `census_kernel` launch for the whole batch."""
    if not img.is_cuda or img.ndim < 2:
        raise ValueError("census_kernel takes a CUDA tensor of [..., H, W] "
                         f"intensities, got {img.device} {tuple(img.shape)}")
    _require("img", img, torch.float32, img.device)
    img = img.contiguous()
    H, W = img.shape[-2:]
    out = torch.empty(img.shape, dtype=torch.int64, device=img.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _library().sgm_census(img.data_ptr(), out.data_ptr(),
                                    img.numel() // (H * W), H, W, stream)
    if err != 0:
        raise RuntimeError(f"census_kernel's launch failed: CUDA error {err}")
    launches["census_kernel"] += 1
    return out


def disparity_cost(m_census: torch.Tensor, nbr_img: torch.Tensor,
                   shifts: torch.Tensor, out: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """`stereo._disparity_cost` on the card: the [H, W, D] int16 volume of
    main census words ``m_census`` [H, W] (int64) against the neighbor
    ``nbr_img`` [H, Wn] (float32) over the ``shifts`` [D] (float32), one
    `census_cost_kernel` launch, written into ``out`` (any strides) where
    given."""
    dev = nbr_img.device
    if not nbr_img.is_cuda:
        raise ValueError(f"census_cost_kernel takes CUDA tensors, got {dev}")
    _require("m_census", m_census, torch.int64, dev)
    _require("nbr_img", nbr_img, torch.float32, dev)
    _require("shifts", shifts, torch.float32, dev)
    if m_census.ndim != 2 or nbr_img.ndim != 2 or shifts.ndim != 1 \
            or nbr_img.shape[0] != m_census.shape[0]:
        raise ValueError(f"census [H, W], neighbor [H, Wn] and shifts [D] "
                         f"expected, got {tuple(m_census.shape)}, "
                         f"{tuple(nbr_img.shape)}, {tuple(shifts.shape)}")
    h, w = m_census.shape
    wn = nbr_img.shape[1]
    D = shifts.shape[0]
    if out is None:
        out = torch.empty((h, w, D), dtype=torch.int16, device=dev)
    _require("out", out, torch.int16, dev)
    if tuple(out.shape) != (h, w, D):
        raise ValueError(f"out must be [{h}, {w}, {D}], got "
                         f"{tuple(out.shape)}")
    if out.numel() == 0:
        return out
    m_census, nbr_img, shifts = (t.contiguous()
                                 for t in (m_census, nbr_img, shifts))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().sgm_census_cost(
            m_census.data_ptr(), nbr_img.data_ptr(), shifts.data_ptr(),
            out.data_ptr(), h, w, wn, D, *out.stride(), stream)
    if err != 0:
        raise RuntimeError(f"census_cost_kernel's launch failed: CUDA error "
                           f"{err}")
    launches["census_cost_kernel"] += 1
    return out
