"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module."""
