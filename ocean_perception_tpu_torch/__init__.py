"""PyTorch + CUDA port of ``ocean_perception_tpu`` for NVIDIA Hopper.

Module paths and public names mirror the JAX package. The entry point is
``ocean_perception_tpu_torch.models.perception.perception_step``. The
hand-written kernels live in ``csrc/`` and are built and launched by
``ops/cuda.py``.
"""
