"""The port's build cache: where the kernels and the cluster builder are
compiled, port of raytracer2_tpu/compile_cache.py (JAX's persistent XLA
compilation cache).

The port compiles no trace program (torch runs eagerly); what it builds
at first use are the CUDA kernel library (ops/_build.py, nvcc) and the
native cluster builder (ops/native.py, the host C++ compiler), both named
by a hash of their sources and flags, so a directory of them is a cache.
In a writable checkout they go to build/ at the repository root; an
installed, read-only package builds them in a user-level cache instead.
"""

from __future__ import annotations

import os
from pathlib import Path


def default_cache_dir() -> Path:
    """Repo-root build/ when running from a writable checkout, else
    $XDG_CACHE_HOME/raytracer2_tpu_torch (~/.cache without XDG)."""
    repo_root = Path(__file__).resolve().parent.parent
    if (repo_root / "raytracer2_tpu_torch").is_dir() \
            and os.access(repo_root, os.W_OK):
        return repo_root / "build"
    base = Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache"))
    return base / "raytracer2_tpu_torch"


def enable_compile_cache(cache_dir: str | os.PathLike | None = None) -> bool:
    """Point the kernel library's and the cluster builder's builds at
    cache_dir (default_cache_dir() when None): kernels/ and native/ under
    it. A library already loaded in this process stays loaded. Returns
    True when the directory is usable, False where it cannot be made."""
    from raytracer2_tpu_torch.ops import _build, native

    cache = Path(cache_dir) if cache_dir else default_cache_dir()
    try:
        cache.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    _build.BUILD_DIR = cache / "kernels"
    native.BUILD_DIR = cache / "native"
    return True
