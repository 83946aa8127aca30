"""Correctness checks of their own, one module a check: checks/<name>.py.

A mix's "checks" object names its checks. A name that check.CHECKS holds
is one of check.py's own; any other is this folder's <name>.py, which
check.load_check finds by that name, so a new check is a new file and a
new entry in a mix. The module gives:

- numbers(ev, scene, spec, seed, control) -> dict, required: its compared
  numbers by name, each with a limit in limits/<cell>.json. ev is the
  run's evidence (check.Sampler.evidence), scene the plain reference's
  scene (reference.glb.load_glb), spec the check's entry in the mix,
  seed the run's seed; control=True computes the reference in
  check.CONTROL_DTYPE in the program's place.
- install(sampler, spec), optional: called from check.Sampler.install once
  the renderer exists. It observes or wraps the program's functions with
  sampler.run.observe and sampler.run.wrap, and keeps nothing from the
  profiled frames (sampler.run.profiling) or from outside the window
  (sampler.run.frame < 0).
- evidence(sampler, state, prior, img, g_const, pose, frame, spec) -> dict,
  optional: called from check.Sampler.evidence after the window, before
  the program's state is freed. It returns tensors gathered small;
  numbers() finds them as ev[<name>].

The reference a check compares with is plain PyTorch in reference/ and
imports nothing of the program. This package holds no check itself.
"""
