"""scene_compile_s: host seconds of Scene.compile(device="cuda") and a synchronise, in set-up
(scene/compile.py, io/obj.py, io/image.py, native.py, ops/bvh.py, ops/envmap.py)."""


def read(run):
    return run.layer.get("scene_compile_s")
