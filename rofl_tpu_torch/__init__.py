"""rofl_tpu_torch — the PyTorch/CUDA port of rofl_tpu for NVIDIA Hopper.

Module names mirror ``rofl_tpu`` so a reader finds each counterpart. The
package imports ``torch`` and ``numpy`` only; it shares no code with the
JAX package. Entry points that create tensors take an explicit ``device``
(default ``"cuda"``): a CUDA tensor goes through the hand-written kernels in
``csrc/``, a CPU tensor through the plain torch versions beside them.
"""
