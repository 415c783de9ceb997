"""tpupt_torch — the PyTorch/CUDA port of the tpupt path tracer.

A second package beside ``tpupt/`` (the JAX reference, left unedited). Module
names follow the reference so each part has an obvious counterpart:

    core/      float32 math, counter-based RNG, device selection
    scene/     builder API, SceneData, scene compiler, numpy -> SceneData bridge
    ops/       intersection (hand-written CUDA closest-hit kernel), BSDFs,
               lights, textures, environment
    render/    camera, path-regeneration wavefront integrator, render driver
    io/        PNG output
    csrc/      CUDA C++ kernel sources, built with nvcc at first use

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; without
a GPU they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"
