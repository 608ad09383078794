"""splatpu_torch — the PyTorch / CUDA port of ``splatpu`` for NVIDIA Hopper.

The JAX package ``splatpu`` is the reference; this package reproduces its
observable behaviour module by module (same module names where that helps a
reader find the counterpart) and replaces each Pallas TPU kernel with a
kernel written by hand for Hopper (``csrc/``, built by ``_build.py``).

Ported so far, the serving path, stage 1 (fit and densify), the stage-2
trainer, both stages' command lines and the distributed modes:

- ``core``      cloud / camera / render-arg types (with the
                ``means2d_offset`` screen-gradient collector), quaternions,
                positional encoding, EWA preprocess, SSIM.
- ``render``    exact tile binning (host-side torch), the forward and
                backward composites (CUDA kernels ``csrc/composite_*.cu``)
                and the gradient routing (``csrc/route_pairs.cu``), each
                beside its plain PyTorch version, inside one
                ``torch.autograd.Function``; the padded pair stream and its
                composite (``csrc/padded_*.cu``); the naive oracle
                renderer; the public ``render`` and stage 1's
                ``render_dual`` (one binning, two composites).
- ``growth``    densification of the fixed-capacity cloud: clone, split,
                prune, opacity reset, with the Adam moments edited.
- ``dynamics``  the deformation network (float32 or bfloat16), state
                encoding, rigidity.
- ``neighbors`` exact kNN: brute force, and the repo's native KD-tree
                (``native/knn``) above 200,000 points.
- ``train``     losses, the stage-1 Adam and the stage-2 Adam /
                warmup-cosine optimizer, the stage-1 fit and the stage-2
                trainer (view staging, checkpoints, resume), rollout and
                orbit-camera inference with real-view evaluation.
- ``data``      the Panoptic-layout sequence loader and writer, random
                clouds, look-at cameras.
- ``io``        npz clouds, flax-msgpack checkpoints (reader and writer),
                the deformation bundle, images (PIL or a PNG codec), frames
                and video.
- ``obs``       the metrics logger, PSNR, timing and tracing helpers.
- ``dist``      the distributed modes on ``torch.distributed``: the
                (cameras, tiles) rank grid, camera-sharded and 2D stage-2
                losses and step, tile-strip renders for stage 1, process
                topologies and multi-sequence batches, and a launcher of
                ranks on one host (gloo when they share a card).
- ``cli``       ``densify``, ``train``, ``render`` and ``train_batch``.
- ``tools``     profilers of serving and training, the config-3 training
                scene and the config-2 stage-1 scene, comparisons with
                another commit's kernels.

Entry points take ``device`` (default ``"cuda"``); the CPU path uses each
kernel's plain version and exists for tests.
"""

__version__ = "0.1.0"
