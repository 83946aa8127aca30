"""Deadline-guarded device-to-host reads, port of
raytracer2_tpu/utils/readback.py.

A value the package must read back from the device (the k_cand probe's
maxima) goes through guarded_scalar: the read runs in a daemon thread with
a deadline, and a read that stalls past it returns the fallback instead of
wedging renderer creation.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


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
