"""Measurement tools (counterparts of the JAX repository's ``tools/``), each
run as ``python -m tinman_sandbox_tpu_torch.tools.<name>``: the
reference's benchmark matrix in one JSON report (``bench_all``), the
roofline probe (``probe_kernel``), the long-run energy and mass drift of
the full cadence (``energy_drift``), the scaling sweep of the
element-sharded step over a ``LocalMesh`` (``scaling``, an emulation), the
band-sharded steps at 16 and 32 shards (``validate_n16_32``) and the
on-card equivalence check of every kernel path against an independent form
of the same step (``equiv_check``, its report ``H100_EQUIV.json``)."""
