"""tpupt_torch — the PyTorch/CUDA port of the tpupt path tracer.

A second package beside ``tpupt/`` (the JAX reference, left unedited). Module
names follow the reference so each part has an obvious counterpart:

    core/      float32 math (float64 under the CPU oracle, TPUPT_ORACLE_X64),
               counter-based RNG, device selection
    scene/     builder API, SceneData, scene compiler, numpy -> SceneData bridge
    ops/       intersection (hand-written CUDA kernels for spheres/quads, triangle
               clusters and the stackless BVH; the matmul sweep), Morton and SAH
               builds, BSDFs, lights, textures, environment (constant, LDR map, or
               f32 HDR map with importance sampling)
    render/    camera, path-regeneration wavefront integrator, render driver,
               gradients through the detached estimator (diff.py)
    io/        OBJ and image input, PNG output
    csrc/      CUDA C++ kernel sources and the C++ host library (OBJ parse,
               Morton and SAH builds), built at first use by build.py; native.py
               binds the latter
    trace.py   spans of the program's work, and the card's stamps inside its CUDA
               graphs, on one clock (recorded only within trace.recording())

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; without
a GPU they raise instead of falling back to the CPU.
"""

__version__ = "0.1.0"
