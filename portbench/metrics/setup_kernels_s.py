"""The wall seconds of the process's load of the kernel library
(``ops/_build.py`` ``load``: the nvcc build where the checkout has no
library of the sources' digest, the dlopen and the binding), a part of
``setup_s``.  None where the program keeps no such count or loaded no
library."""


def read(ctx):
    try:
        from falcon_genome_tpu_torch.ops import _build
    except ImportError:
        return None
    load = getattr(_build, "LOAD", None)
    if not load or not load["loads"]:
        return None
    return float(load["seconds"])
