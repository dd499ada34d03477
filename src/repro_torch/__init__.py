"""PyTorch/CUDA port of the repro serving system (rwkv6-1.6b greedy serving
through the Representer-Sketch LM head, on hand-written Hopper kernels).

The JAX package ``repro`` is the reference; this package imports none of it.
"""
