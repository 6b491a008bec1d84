"""The trainer's side of the port (counterpart of ``rofl_tpu.models``): the
networks as ``torch.nn`` modules, their Flax initialisation, the synthetic
datasets, the intrinsic-dimension projection and the local trainer."""
