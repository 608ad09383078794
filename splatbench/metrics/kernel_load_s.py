"""Seconds the program took to get its CUDA kernels (``_build.build_seconds``):
an nvcc build on a checkout's first run, a load from the cache after it."""


def read(reading, part):
    return reading.get("build_seconds")
