"""Measurement tools (counterparts of the JAX repository's ``tools/``), each
run as ``python -m tinman_sandbox_tpu_torch.tools.<name>``: the roofline
probe (``probe_kernel``) and the long-run energy and mass drift of the full
cadence (``energy_drift``)."""
