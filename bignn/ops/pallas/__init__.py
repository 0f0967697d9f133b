"""Pallas kernels for the GPU, written for the Triton route.

  * flash_gat.py — flash-tiled masked GAT attention of the dense outer graph.

ops/dispatch.py selects them on a CUDA GPU; every kernel has a plain XLA
counterpart that runs elsewhere and that its tests compare against in
interpret mode.
"""
