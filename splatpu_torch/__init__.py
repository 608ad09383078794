"""splatpu_torch — the PyTorch / CUDA port of ``splatpu`` for NVIDIA Hopper.

The JAX package ``splatpu`` is the reference; this package reproduces its
observable behaviour module by module (same module names where that helps a
reader find the counterpart) and replaces each Pallas TPU kernel with a
kernel written by hand for Hopper (``csrc/``, built by ``_build.py``).

Ported so far, the serving path and the single-device stage-2 trainer:

- ``core``      cloud / camera / render-arg types, quaternions, positional
                encoding, EWA preprocess, SSIM.
- ``render``    exact tile binning (host-side torch), the forward and
                backward composites (CUDA kernels ``csrc/composite_fwd.cu``
                and ``csrc/composite_bwd.cu``) and the gradient routing
                (``csrc/route_pairs.cu``), each beside its plain PyTorch
                version, inside one ``torch.autograd.Function``; the naive
                oracle renderer; the public ``render``.
- ``dynamics``  the deformation network, state encoding, rigidity.
- ``neighbors`` exact brute-force kNN.
- ``train``     losses, the Adam / warmup-cosine optimizer, the stage-2
                trainer, rollout and orbit-camera inference.
- ``data``      ``ViewData`` and look-at cameras.
- ``io``        the npz cloud reader and a flax-msgpack reader (network and
                Adam state).
- ``tools``     profilers of serving and training, the config-3 training
                scene.

Entry points take ``device`` (default ``"cuda"``); the CPU path uses each
kernel's plain version and exists for tests.
"""

__version__ = "0.1.0"
