"""Measurement tools (counterparts of the JAX repository's ``tools/``), each
run as ``python -m tinman_sandbox_tpu_torch.tools.<name>``: the
reference's benchmark matrix in one JSON report (``bench_all``), the
roofline probe (``probe_kernel``), the long-run energy and mass drift of
the full cadence (``energy_drift``), the scaling sweep of the
element-sharded step over a ``LocalMesh`` (``scaling``, an emulation), the
band-sharded steps at 16 and 32 shards (``validate_n16_32``) and the
on-card equivalence check of every kernel path against an independent form
of the same step (``equiv_check``, its report ``H100_EQUIV.json``), and the
stage breakdowns of the step, timed by CUDA events, from CUDA graphs and by
the host's issue time (``profile_prim``: dynamics, hyperviscosity,
tracers; ``profile_dss``: the CAAR kernel, the DSS and its parts;
``profile_limiter``: the limited tracer stage by the differences of a
ladder; ``profile_dss_ne120``: the assembled step at ne120), and the
assembled-step variants on both layouts and in bf16 storage
(``bench_assembled``).
``bench_ne120_kernel`` of the JAX repository has no counterpart: every
variant it times is a TPU option, and ``bench --nelem 86400`` times the
chunked CAAR kernel at ne120."""
