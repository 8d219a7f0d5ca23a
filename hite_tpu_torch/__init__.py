"""hite_tpu_torch: the PyTorch + CUDA port of hite_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference (`hite_tpu`), with the same
module and function names so each counterpart is easy to find.  It imports
`torch`, never `jax`, and nothing of `hite_tpu`.  Public entry points run
on the card unless the caller passes `device="cpu"` (see `device.py`).
"""
