"""raytracer2_tpu_torch — the PyTorch/CUDA port of raytracer2_tpu.

The same renderer as the JAX package beside it, written against torch
tensors on an explicit device, with the TPU kernels hand-written in CUDA
C++ for Hopper (sm_90a, csrc/). The JAX package stays the reference: every
module here keeps its counterpart's array layouts at the public functions,
so the tests feed both the same numpy inputs and compare.

- app.py     the CLI (python -m raytracer2_tpu_torch.app), viewer.py the
             terminal viewer
- utils/     Z-curve packing, RNG, BRDF sampling, pass timers, PNG files
- scene/     camera, glTF/EXR import, SoA scene tensors
- lights/    light tables, PDF mips, RIS presampling
- ops/       clusters, the bundle walks, the exact cull, the pair engine,
             the LBVH and its walk, the brute-force oracles
- restir/    the DI and GI reservoir library, DI resampling, ReGIR
- render/    tracers, the G-buffer, DI and GI passes, the reference path
             tracer, post-processing and render_frame

Nothing here imports JAX or the JAX package; the JAX-free host modules it
needs (glTF/EXR import, procedural scenes, the native SAH cluster builder)
are its own copies.
"""

__version__ = "0.1.0"
