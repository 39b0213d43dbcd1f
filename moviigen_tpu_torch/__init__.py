"""PyTorch / CUDA port of moviigen_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports torch and never
jax or moviigen_tpu. Entry points run on the CUDA device unless the
caller asks for the CPU.
"""
