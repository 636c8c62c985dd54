"""Runnable integrations (counterparts of the JAX repository's
``examples/``), each run as ``python -m tinman_sandbox_tpu_torch.examples.
<name>``: the packed production cadence with the remap and the mass fixer
(``packed_cadence``) and a simulated day of the field-form cadence
(``simulated_day``)."""
