"""Part of the mcaat_tpu_torch port; see the matching mcaat_tpu module.

Exports nothing: the one export of ``mcaat_tpu/utils/__init__.py``,
``honor_cpu_env``, belongs to the JAX package's remote-TPU set-up and has
no counterpart here (the port's device is explicit, see
``mcaat_tpu_torch.resolve_device``)."""

__all__: list[str] = []
