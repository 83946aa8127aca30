"""Stable counting sort by bin id, port of raytracer2_tpu/ops/pallas_binning.py.

The JAX module measures a TPU kernel (B6, `_scatter_kernel`) that runs the
counting-sort scatter chain one element at a time: read an id, take that
id's cursor as the element's slot, bump the cursor. The cursors persist
over the sequential grid, so each element's slot is its stable rank among
all earlier elements of its id. The TPU has no vector scatter, which is
why that chain ran on its scalar core; this card has one, and atomics.

Here the chain is the real binning of the pair engine (ops/cuda_pairs.py):
`bin_scatter` gives every element its stable rank in its bin and stores a
payload at `base[bin] + rank`, where `base` is the exclusive scan of the
bin counts, each rounded up to `pad`. The kernel (csrc/binning.cu) ranks
deterministically (a per-tile histogram, a scan of the counts, then a
stable counting sort of each tile in shared memory, ranked by warp
matches), so its output does not depend on the order in which threads run:
it equals the stable sort's, slot for slot. It writes every slot, the -1s
included.

On a CUDA tensor `bin_scatter` launches the kernel (and counts the launch
in `bin_scatter.launches`); on a CPU tensor it runs `bin_scatter_reference`,
a stable torch.argsort. Anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

MAX_BINS = 1024  # bins the kernel takes (csrc/binning.cu: kMaxBins)
TILE = 4096  # elements per block of the kernel (csrc/binning.cu: kTile)


class Binned(NamedTuple):
    """What bin_scatter returns."""

    slots: torch.Tensor  # [out_size] i32: payload at base[bin] + rank, else -1
    counts: torch.Tensor  # [n_bins] i32: elements per bin
    ranks: torch.Tensor | None  # [n] i32: stable rank in the bin (-1: no bin)


def _check(ids: torch.Tensor, n_bins: int, pad: int, n_write: int, div: int,
           out_size: int) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids must be a 1-d int32 tensor, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [1, {MAX_BINS}], got {n_bins}")
    if pad < 1 or div < 1 or out_size < 0 or not 0 <= n_write <= n_bins:
        raise ValueError(f"bad pad {pad}, div {div}, out_size {out_size} or "
                         f"n_write {n_write}")
    if ids.shape[0] >= 1 << 31 or out_size >= 1 << 31:
        raise ValueError("ids and slots are indexed with int32")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bin_scatter runs on cuda or cpu, not {ids.device}")


def bin_scatter(ids: torch.Tensor, n_bins: int, *, pad: int = 1,
                n_write: int | None = None, div: int = 1, out_size: int = 0,
                ranks: bool = False) -> Binned:
    """Stable counting sort of ids [n] (int32; an id outside [0, n_bins)
    belongs to no bin). counts[b] is the number of elements of bin b, and
    base[b] the exclusive scan over bins of counts rounded up to `pad`.
    Element j of bin b with stable rank r (the number of earlier elements
    of bin b) stores j // div at slots[base[b] + r] if b < n_write and the
    slot is below out_size; every other slot holds -1. With ranks=True it
    also returns every element's rank (-1 for an element of no bin).

    A CUDA tensor launches csrc/binning.cu on the current stream; a CPU
    tensor runs bin_scatter_reference."""
    n_write = n_bins if n_write is None else n_write
    _check(ids, n_bins, pad, n_write, div, out_size)
    if ids.device.type == "cpu":
        return bin_scatter_reference(ids, n_bins, pad=pad, n_write=n_write,
                                     div=div, out_size=out_size, ranks=ranks)
    from raytracer2_tpu_torch.ops import _build

    lib = _build.library()
    n = ids.shape[0]
    tiles = (n + TILE - 1) // TILE
    dev = ids.device
    scratch = torch.empty(n_bins * tiles, dtype=torch.int32, device=dev)
    counts = torch.empty(n_bins, dtype=torch.int32, device=dev)
    slots = torch.empty(out_size, dtype=torch.int32, device=dev)
    rank = torch.empty(n if ranks else 0, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt2_bin_scatter(
            ids.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
            slots.data_ptr() if out_size else None,
            rank.data_ptr() if ranks else None, n, n_bins, n_write, pad, div,
            out_size, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bin_scatter launch failed: "
                           f"{lib.rt2_error_string(err).decode()} ({err})")
    bin_scatter.launches += 1
    return Binned(slots, counts, rank if ranks else None)


bin_scatter.launches = 0


def bin_scatter_reference(ids: torch.Tensor, n_bins: int, *, pad: int = 1,
                          n_write: int | None = None, div: int = 1,
                          out_size: int = 0, ranks: bool = False) -> Binned:
    """Plain torch version of bin_scatter: a stable argsort by bin."""
    n_write = n_bins if n_write is None else n_write
    _check(ids, n_bins, pad, n_write, div, out_size)
    n, dev = ids.shape[0], ids.device
    valid = (ids >= 0) & (ids < n_bins)
    key = torch.where(valid, ids, n_bins).long()
    order = torch.argsort(key, stable=True)
    counts_all = torch.bincount(key, minlength=n_bins + 1)
    dense_base = torch.cumsum(counts_all, 0) - counts_all
    rank = torch.empty(n, dtype=torch.int64, device=dev).index_put_(
        (order,), torch.arange(n, device=dev) - dense_base[key[order]])
    rank = torch.where(valid, rank, -1)
    counts = counts_all[:n_bins]
    padded = (counts + pad - 1) // pad * pad
    base = torch.cumsum(padded, 0) - padded
    slots = torch.full((out_size,), -1, dtype=torch.int32, device=dev)
    if out_size:
        j = torch.nonzero(valid & (ids < n_write)).reshape(-1)
        slot = base[key[j]] + rank[j]
        keep = slot < out_size
        slots[slot[keep]] = (j[keep] // div).to(torch.int32)
    return Binned(slots, counts.to(torch.int32),
                  rank.to(torch.int32) if ranks else None)


def scatter_rate_probe(ids: torch.Tensor, block: int = 8192,
                       n_bins: int = 256) -> torch.Tensor:
    """Port of the JAX probe: [n / block, 1] i32, per block of `block`
    consecutive elements the sum of their slots, each element's slot being
    its stable rank among all earlier elements of its id (the TPU kernel's
    cursors carry over from one grid step to the next). The sum wraps as
    int32, as the TPU kernel's accumulator does. ids must be int32 in
    [0, n_bins)."""
    n = ids.shape[0]
    if n % block:
        raise ValueError(f"{n} ids are not whole blocks of {block}")
    rank = bin_scatter(ids, n_bins, ranks=True).ranks
    sums = rank.reshape(-1, block).sum(dim=1, dtype=torch.int64)
    wrapped = (sums + (1 << 31)) % (1 << 32) - (1 << 31)
    return wrapped.to(torch.int32)[:, None]
