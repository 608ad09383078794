"""The distributed modes on ``torch.distributed`` (port of ``splatpu/dist/``):
the rank grid, camera-sharded and 2D stage-2 losses and step, tile-strip
renders for stage 1, processes and multi-sequence batches, and a launcher
of ranks on one host."""
