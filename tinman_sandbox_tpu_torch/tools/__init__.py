"""Measurement tools (counterparts of the JAX repository's ``tools/``), each
run as ``python -m tinman_sandbox_tpu_torch.tools.<name>``: the roofline
probe (``probe_kernel``), the long-run energy and mass drift of the full
cadence (``energy_drift``), the scaling sweep of the element-sharded step
over a ``LocalMesh`` (``scaling``, an emulation) and the band-sharded steps
at 16 and 32 shards (``validate_n16_32``)."""
