"""splatpu_torch — the PyTorch / CUDA port of ``splatpu`` for NVIDIA Hopper.

The JAX package ``splatpu`` is the reference; this package reproduces its
observable behaviour module by module (same module names where that helps a
reader find the counterpart) and replaces each Pallas TPU kernel with a
kernel written by hand for Hopper (``csrc/``, built by ``_build.py``).

Ported so far, the serving path:

- ``core``      cloud / camera / render-arg types, quaternions, positional
                encoding, EWA preprocess.
- ``render``    exact tile binning (host-side torch), the forward composite
                (CUDA kernel ``csrc/composite_fwd.cu`` beside its plain
                PyTorch version), the public ``render``.
- ``dynamics``  the deformation network and state encoding.
- ``train``     the stage-2 rollout step and orbit-camera inference.
- ``io``        the npz cloud reader and a flax-msgpack reader.

Entry points take ``device`` (default ``"cuda"``); the CPU path uses each
kernel's plain version and exists for tests.
"""

__version__ = "0.1.0"
