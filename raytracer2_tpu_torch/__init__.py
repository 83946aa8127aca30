"""raytracer2_tpu_torch — the PyTorch/CUDA port of raytracer2_tpu.

The same renderer as the JAX package beside it, written against torch
tensors on an explicit device, with the traversal kernel hand-written in
CUDA C++ for Hopper (sm_90a). The JAX package stays the reference: every
module here keeps its counterpart's array layouts at the public functions,
so the tests feed both the same numpy inputs and compare.

Ported so far (the reference-mode frame):
- utils/     Z-curve packing, RNG, BRDF sampling
- scene/     camera, SoA scene tensors, texture/environment sampling
- ops/       clusters, brute-force oracle, the closest-hit bundle walk
             (csrc/bundle_walk.cu) and its host-side candidate prep
- render/    tracers, primary rays, surfaces, the reference path tracer,
             post-processing and the reference branch of render_frame

The JAX-free modules of the old package (glTF/EXR import, procedural
scenes, the native SAH cluster builder) are shared, not copied.
"""

__version__ = "0.1.0"
