"""The benchmark of ``mcaat_tpu_torch``: see ``run.py`` and ``harness.py``."""
