"""Transfers between the host and the device: the frame path's counted
reads, its uploads, and the deadline-guarded read (port of
raytracer2_tpu/utils/readback.py).

Every read the frame path makes from the device (a count the host needs,
a data-dependent size) goes through item, nonzero or masked. Each makes
the host wait until the device has drained the work queued before it, so
each is counted, under "readback" and "readback.<site>"
(utils/profiler.count), and runs inside the span "readback.<site>"
(utils/profiler.span). The sites: overflow_count and overflow_rays (the
bundle walk's overflow count and fallback rows, ops/cuda_traverse.py),
live_lanes (render/reference.py's dead-lane compaction), lbvh_check and
bundle_engine_check (the live sets of the torch-op walks,
ops/traverse.py and ops/traverse_bundle.py).

A constant or index table the frame path builds on the host goes to the
device through upload, which never makes the host wait: a plain copy from
pageable memory (torch.tensor(..., device=...), .to(device)) first
synchronises the stream, as a read does. A constant it uses again (a
weight, a matrix, a frame's view constants) goes through constant, which
uploads each value once.

A value the package must read back outside a frame (the k_cand probe's
maxima) goes through guarded_scalar: the read runs in a daemon thread with
a deadline, and a read that stalls past it returns the fallback instead of
wedging renderer creation.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch

from raytracer2_tpu_torch.utils import profiler


def _site(site: str):
    profiler.count("readback")
    profiler.count("readback." + site)
    return profiler.span("readback." + site)


def item(x: torch.Tensor, site: str):
    """x.item(): a one-element tensor's value as a Python number."""
    with _site(site):
        return x.item()


def nonzero(mask: torch.Tensor, site: str) -> torch.Tensor:
    """The flat indices of a 1-D mask's true entries."""
    with _site(site):
        return torch.nonzero(mask).reshape(-1)


def masked(x: torch.Tensor, mask: torch.Tensor, site: str) -> torch.Tensor:
    """x[mask], whose length the host reads from the device."""
    with _site(site):
        return x[mask]


def upload(x, device, dtype=None) -> torch.Tensor:
    """Host data (numbers, nested sequences or a numpy array) as a tensor
    on `device`, converted on the host first (torch.as_tensor's dtype
    rules); on a CUDA device through pinned memory and a non-blocking
    copy, so the host does not wait for the queued work."""
    t = torch.as_tensor(x, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@lru_cache(maxsize=1024)
def constant(values, device, dtype=None) -> torch.Tensor:
    """upload(values, device, dtype), once per (values, device, dtype):
    values is hashable, a tuple of numbers or of tuples of them. Every
    caller gets the same tensor, to read and never to write."""
    return upload(values, device, dtype)


def guarded_scalar(x: torch.Tensor, timeout: float = 60.0, default=None):
    """x.cpu().numpy() with a deadline: `default` when the read has not
    finished after `timeout` seconds. Unlike the JAX package's, an
    exception raised by the read (a CUDA fault, say) is raised again here
    rather than returned as `default`, so a failing device never reads as
    "no value"."""
    box: dict = {}

    def work():
        try:
            box["v"] = np.asarray(x.detach().cpu().numpy())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["e"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout)
    if "e" in box:
        raise box["e"]
    return box.get("v", default)
