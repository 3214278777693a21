"""PyTorch / CUDA port of internvideo_tpu for NVIDIA Hopper (H100).

The JAX package `internvideo_tpu` stays the reference; this package mirrors
its module paths (ops/, nn/, models/, eval/, cli/) for the slices ported so
far. It imports torch and numpy only, never jax or internvideo_tpu.
"""
