"""The port's experiment scripts — counterparts of the JAX package's
``scripts/run_e2e.py``, ``run_e2e_suite.py``, ``parse_benchlog.py`` and
``gen_init_models.py``; each runs as ``python -m rofl_tpu_torch.scripts.<name>``."""
