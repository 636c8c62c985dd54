#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``tinman_sandbox_tpu_torch``) on one
NVIDIA card and check it, phase by phase:

  1. the card's name and power limit; build every CUDA kernel from
     ``tinman_sandbox_tpu_torch/csrc`` (nvcc, sm_90a, one process per
     source, all at once) and time the build; nvcc's registers and spills,
     and those of each instance of the sweep, the banded sweep, the chunked
     CAAR kernel, the ring CAAR kernel, the remap kernel and the tracer
     kernels by name;
  2. saxpby: the kernel against its plain version (bitwise, f32) at
     8192 x 4096, with kernel / plain / library times and GB/s;
  3. CAAR: the level-chunked kernel against its plain version on the card
     at 1024 x 72, 5,400 x 72 and 1,001 x 72 (a half-live last warp;
     random init from a numpy seed, f32), each output field on its own (u1,
     v1, t1, dp1, phi and the in-place accumulators) within 5e-5 scaled
     max-abs error, in three cases (``caar_cases``): the bench problem, and
     two probes that zero what would hide a tendency term below f32
     resolution; timed by events and from a CUDA graph, with its plan
     (``caar_plan``: tile, chunks, levels, stash, threads, shared memory,
     the blocks an SM it reckons with and cudaOccupancy's, waves); then at
     ne30 x 26 (7 level chunks, the last short) and ne30 x 150 (no stash),
     ne30 x 400 (``caar_plan``'s largest nlev, 8 chunks of 50), the pair
     form and the stage mode with the slab, in the three cases, each field
     within 5e-5 scaled, the slab bit for bit s1 at the fix lanes, and the
     ring kernel bit for bit the two launches it fuses;
  4. DSS on the ne30 cubed sphere (5,400 elements) on a random [288, 86400]
     f32 field: the extract, fixup and sweep kernels each bit for bit equal
     to their plain versions, every alias of every dof equal after the whole
     DSS, and a field that is a function of the dof projected onto itself
     within 2e-6; the extract, fixup and sweep kernels (and the gather)
     also replayed from CUDA graphs, the device's time alone, the
     extract beside its sector floor (``extract_floor_ms``); the sweep's
     plan (``sweep_plan``: groups of 4 lanes a block, one row a thread, grid,
     blocks an SM reckoned and by cudaOccupancy, waves), every sweep form
     (merged, merge-free, mix, in place) bit for bit at ragged shapes (75
     rows of ne30; 1, 5 and 7 rows of ne3, one and two rspheremp rows), and
     a misaligned field refused;
  5. CAAR with the fix-lane slab on the ne30 geometry, in the three cases of
     phase 3: fields within 5e-5, the slab bit for bit s1 at the fix lanes;
  6. golden: analytic init at 3 elements through ``caar_t`` on the card,
     T/u/v within 5e-5 x max|gold| of the golden arrays (f32 against f64);
  7. the raw main path, with every launch count set to 0 just before it and
     read just after: the CLI at 1024 elements x 100 steps
     (golden-checked), the packed leapfrog loop for 10 steps at 5,400 x 72
     against the same loop on the plain version (1e-4 scaled, all finite;
     this checks the loop's rotation and accumulators, while phase 3 holds
     the tendencies), and the raw-kernel bench at 1024 x 72;
  8. the assembled main path at ne30 x 72, its launch counts set to 0 just
     before it and read just after: 10 chained assembled steps on the
     kernels against the same chain on the plain versions (1e-4 scaled per
     field, finite, continuity exactly 0), the CLI ``--ne 30 --dss
     --leapfrog --num-exec 20 --init random --dt 0.05`` (no warning,
     continuity exactly 0) and ``bench --ne 30``;
  9. the dynamics kernels at ne30 x 72: the chunked CAAR kernel's
     single-state stage mode (with and without phi, with the slab) against
     ``caar_t4_plain(s, s, ...)`` in the three cases of phase 3 at 5e-5 per
     field, timed by events and from CUDA graphs beside the pair form with
     the slab; the sweep with its affine ``mix`` output bit for bit against
     ``dss_sweep_plain(mix=)``, into a new tensor and in place into a
     [4*nlev] buffer whose dp rows stay bit for bit, both also from CUDA
     graphs (and the [3*nlev] sweep without mix timed beside them); the
     fixup of the [3*nlev] and [4*nlev] slabs bit for bit
     ``dss_fixup_plain``, also from CUDA graphs; the weak-Laplacian
     kernel against ``vlap_plain`` at 5e-5 per output block, its slab bit
     for bit the output at the fix lanes; each timed against its bound;
 10. the dynamics main path at ne30 x 72, its launch counts set to 0 just
     before it and read just after: 10 chained SSPRK3 + hyperviscosity steps
     from a continuous random state on the kernels against the same chain on
     the plain versions (1e-5 scaled per field, finite, continuity exactly 0
     after each step), the CLI ``--ne 30 --rk --hypervis-nu 1e15 --leapfrog
     --init random`` (no warning, continuity exactly 0) and ``bench --ne 30
     --rk --hypervis-nu 1e15``; per step 3 CAAR launches in stage mode, 2
     Laplacians, 5 fixups and 5 sweeps;
 11. the tracer kernels at ne30 x 72, at qsize 1 and 35 (the stack
     [2520, 86400]), winds read out of the [4*nlev] state, with the slab;
     first the design (4 lanes a thread, the warps, lanes and levels of a
     block, cudaOccupancy's blocks an SM and ptxas's registers of the Euler
     and the two limited instances); then
     ``tracer_euler_cuda`` against ``tracer_euler_plain`` within 5e-5 per
     tracer block, at the run's dt and at a dt long enough for the
     divergence to carry the output, the slab bit for bit the output at the
     fix lanes; ``tracer_limit_cuda`` against ``tracer_limit_plain`` within
     5e-5 per tracer block without and with the Shu-Osher combination, on a
     uniform field and on a field with a tenth of its nodes pushed outside
     the bounds, with each element's mass kept to 4e-6 and the result inside
     the bounds wherever they are feasible; with no clip-and-redistribute
     pass (``iters=0``, the residual pass alone), with and without the
     combination, within 5e-5 and the mass to 4e-6; each timed by events
     and from a CUDA graph against its bound; the fixup of the 72- and
     2,520-row
     stacks bit for bit
     ``dss_fixup_plain``, also from a CUDA graph;
 12. the full model step at ne30 x 72, qsize 1, its launch counts set to 0
     just before it and read just after: 10 chained ``prim_step_packed_t4``
     steps (dynamics, hyperviscosity, tracers) on the kernels against the
     same chain on the plain versions (1e-5 scaled per field and for the
     tracers, continuity exactly 0 after each step for the state and the
     tracers), without and with the limiter; the CLI ``--ne 30 --prim
     --hypervis-nu 1e15 --init random``; ``bench --ne 30 --prim
     --hypervis-nu 1e15``, again with ``--limit``, with ``--qsize 35`` and
     with ``--qsize 35 --limit`` (the production configuration); with the
     limiter min qdp >= 0 at qsize 1 and >= -1e-6 (the limiter's bounds
     gate: its residual pass leaves a node on a zero bound a few ulps
     below) at qsize 35; per step 3 CAAR launches, 2 Laplacians, 3 tracer
     launches, 8 fixups and 8 sweeps;
 13. the rsplit=0 and row-layout kernels at 1024 x 72 and 5,400 x 72 (the
     ne30 geometry), with a hybi ramp (linspace(0, 1, nlev+1)) and a random
     eta accumulator: the plans of the t rsplit=0 kernel (``caar_plan(
     r0=True)``: chunks, stash, shared memory, blocks an SM reckoned and by
     cudaOccupancy) and of the row kernel (``caar_row_plan``: staged or
     windowed) at nlev 72 and ``CAAR_OTHER_NLEV``; the rsplit=0 mode on the
     t layout (``caar_packed_rsplit0_t``) and on the row layout
     (``caar_packed_rsplit0``) and the row rsplit>0 mode (``caar_packed``),
     each against its plain version, each output field on its own within
     5e-5 scaled, in the three cases of phase 3, a ``wind`` case (sm1 =
     0, winds x30, where the vertical advection of u and v carries ~2e-3 of
     the output) and a ``long`` case (the bench problem at a dt2 where the
     rsplit=0 dp update is half of dpm1); each also within 5e-5 of its
     plain version in f64 on the same inputs (with the plain f32 dp1's own
     error beside it: the cancellation of the rsplit=0 dp tendency), the t
     rsplit=0 kernel bit for bit ``caar_packed_rsplit0`` and the row
     rsplit>0 kernel bit for bit ``caar_t4_cuda`` on the transposed
     problem; each timed by events and from a CUDA graph beside its bound
     and the t pair form; at 1024 x 26, 150 and 400 the three kernels in
     the same cases against their plain versions in f64 (5e-5; the t
     rsplit=0 kernel also in f32), with the same bit-for-bit checks, timed
     from graphs;
     the row tracer kernel (``euler_packed``) against its plain
     version within 5e-5 per tracer block at qsize 1 and 35 on ne30, at the
     run's dt and at a dt long enough for the divergence to carry the
     output; each timed against its bound, its plain version and the t form
     at the same shape;
 14. the rsplit=0 and row-layout main paths, their launch counts set to 0
     just before and read just after: the CLI ``--layout row`` at 1024
     elements x 100 steps (golden-checked) and ``--layout row --ne 30 --dss
     --leapfrog --init random --dt 0.05`` (no warning, continuity exactly
     0); 10 chained rsplit=0 leapfrog steps through ``caar_t`` and through
     ``kernels.caar.caar`` at 5,400 x 72 (hybi ramp) against the same chains
     on the plain versions (1e-4 scaled, all finite); 10 chained tracer
     steps through ``euler_step_fast`` at ne30 against the field form
     ``timeloop.tracer.euler_step`` on the card (1e-5 scaled); ``bench
     --layout row`` and ``bench --layout row --ne 30``;
 15. the four kernels of the ring path at ne30 x 72: the ring-fused CAAR
     kernel (``caar_ring_packed_t4``) in pair and stage modes, with and
     without phi and mix, in the three cases of phase 3, every output block
     (the swept w at every lane, phi, the accumulators, the slab) within
     5e-5 scaled of ``caar_ring_plain`` and bit for bit the two launches it
     fuses (the CAAR kernel, the merge-free sweep); the ring-fused tracer
     kernel (``tracer_ring_packed_t``) at qsize 1 and 35, at the run's dt and
     a long dt, with and without mix, likewise, and captured in a CUDA graph
     with mix and replayed three times on fresh q and mix copied into its
     inputs, each replay bit for bit the two launches; both rings at once on
     two streams (``rings_on_two_streams``), every output bit for bit its
     two launches; the merge-free sweep at 288,
     72 and 2,520 rows (new, mix, in place) and the patch (with and without
     mix), each bit for bit its plain version, and the split DSS bit for bit
     the merged one; each timed against its bound, its plain version, the
     two launches it fuses and (the patch) ``index_copy_``; the patch and
     ``index_copy_`` by events (host included) and from CUDA graphs (the
     device alone), with and without mix, and the host's time per call,
     beside the patch's sector floor (``patch_floor_ms``), and at 2,520
     rows the patch on contiguous lanes;
     blocks per SM and waves of the ring kernels (the CAAR ring: the
     chunked kernel's own tile and plan, ``ring_plan``, so the same bits)
     and of the chunked CAAR and Euler kernels; both rings and the two
     launches each fuses also from CUDA graphs (a ring's launch clears its
     state, so its graph replays correctly), beside the recorded times of
     the CAAR ring's design before (``PARENT``);
 16. the ring paths at ne30 x 72, launch counts set to 0 just before and
     read just after: 10 chained ``caar_dss_ring_t4`` and 10
     ``ssprk3_ring_t4`` steps and 3 ``ssprk3_tracer_ring_t`` steps at qsize 1
     and 35, each step bit for bit the same chain on the two-launch kernels,
     continuity exactly 0, per step 1 (3) ring, fixup and patch launches and
     no sweep; the split DSS of the tracer stacks; ring against two-launch
     step times; ``bench --ne 30 --ring`` beside ``bench --ne 30`` and the
     recorded ring bench of the design before;
 17. one JSON line of kernels (launches on the main paths, errors, times,
     bounds), the card line, and last the result line;
 18. the multi-device DSS kernels (run before the line of phase 17): the
     banded sweep (``dss_sweep_banded_cuda``, merged; with and without mix;
     216 rows in place into a 288-row state), its merge-free form
     (``dss_sweep_banded_nomerge_cuda``) and the shard-local patch
     (``dss_patch_tiles_cuda``, with and without mix, a taller w), each bit
     for bit its plain version on every shard of ne30 x 72 with m = 2 bands
     a face over 12 shards (first and last bands) at 288, 216, 72 and 2,520
     rows, and of ne32 with m = 4 over 6 shards (four chunks a shard:
     first, middle and last bands) at 288 rows; each timed over the whole
     sphere's shards by CUDA events (the sweep, merged and merge-free, and
     the patch, with and without mix, also replayed from CUDA graphs, the
     device's time alone) against its bound, its plain version,
     ``dss_sweep_cuda`` on the same sphere in one launch and (the patch)
     ``index_copy_`` and the sector floor, beside the recorded times of the
     banded sweep's design before;
 19. the multi-device paths at ne30 x 72, launch counts set to 0 just
     before and read just after, each step bit for bit the single-device
     step and continuity exactly 0: 10 chained ``caar_dss_banded_t4`` steps
     over ``LocalMesh(12)`` (m = 2, two-float rspheremp, random projected
     state), overlap off and on; ``caar_dss_sharded_t4`` on 6, 3 and 2
     shards, overlap off and on; 3 chained ``prim_step_banded_t4`` steps
     (nu 1e15, qsize 1), one step with overlap and one at qsize 35;
     ``multichip.dryrun_multichip(8)``; the multi-device step times beside
     the single-device ones, by events and from CUDA graphs. ``LocalMesh``
     emulates the shards on one card, one launch a shard: these times are
     no scaling result; beside them the recorded step times with the
     banded sweep's design before;
 20. the probe's chained FP32 product (``probe_mm_cuda``, PERF.md row 31)
     against ``probe_mm_plain`` within 2e-6 of max|o| at the probe tool's
     five shapes, the same bits on a second run, with the launch plan of
     ``probe_plan`` (tile, cluster and k ranges, resident or pipelined,
     shared memory, nvcc's registers, CTAs, blocks a SM, clusters at once
     and waves), each timed against its bound (a time under the FLOP bound
     fails: the twenty products were folded), its plain version and the
     same twenty products by cuBLAS (``torch.addmm``, the yardstick); the
     pipelined mode at two longer-k shapes (``PROBE_PIPELINED_SHAPES``),
     bit for bit plain on integer operands, whose sums are exact; then,
     launch counts set to 0 just before and read just after, the probe tool
     itself (``tools.probe_kernel``: triad, the five products, the row CAAR
     kernel);
 21. the rsplit cadence at ne30 x 72, qsize 1, launch counts set to 0 just
     before and read just after: 6 steps of ``examples.packed_cadence``'s
     loop (``prim_step_packed_t4`` with limited tracers and qsplit 2, then
     ``remap_packed_t4`` with the mass fixer every 3 steps) from its random
     projected init, on the kernels (the remap kernel included) against
     the same loop on the plain step whose remap is
     ``remap_packed_t4_plain`` in float64 on its float32 state, rounded to
     float32 (1e-4 scaled per block; each step against the plain step from
     the same input at 1e-5), continuity exactly 0 after every step's
     DSS, the air mass within 1e-6 of its target after each remap (the
     remap's own continuity reported); then the remap kernel's gates on
     the last remap's input, for pcm, plm and ppm: its dp rows bit for bit
     ``remap_packed_t4_plain``'s (without and with the fixer), u, v, T and
     qdp against ``remap_packed_t4_plain`` in float64 no further off than
     the plain float32 code (both printed), every column's totals of x*dp
     and of qdp within 1e-6 of its sum |x|*dp (the plain code's figure
     beside it), and the float64 instances (packed and level form) within
     1e-12 scaled of the plain float64 code; the remap's time by events
     and from a CUDA graph beside the dense plain code's, its plan (shared
     memory a block against ``remap_plan``, blocks an SM), its peak memory,
     its launches a call (``torch.profiler``) and share of the cadence; the
     same gates at qsize 35 (E3SM's tracers, each gated on its own) on the
     cadence's input after rsplit steps (``cadence_input``), with the
     kernel's time, bound, blocks an SM and registers;
     the example as a user runs it, and from one checkpoint of its start 6
     steps at once against 3 steps, a ``--checkpoint`` restart and 3 more,
     bit for bit equal; ``tools.energy_drift`` (float64, the field form:
     the level-form remap kernel); the CLI ``--ne 30 --prim --diag`` from
     one checkpoint run 3 steps at once and as 2 steps, ``--checkpoint``,
     ``--restore`` and 1 step, bit for bit equal; the remap kernel launched
     in float32 and in float64 on the path;
 22. the element-sharded tiers at ne30 x 72, f32, over LocalMesh(8) (675
     elements a shard), launch counts set to 0 just before and read just
     after: from one projected random start the psum halo, ppermute,
     partitioned segment-sum and interior / boundary overlap steps (the
     array-form CAAR and segment sums, no kernel of the table), u, v, T
     and dp3d at np1 of each within 1e-5 of max|x| of the single-device
     ``caar_dss_step``, continuity exactly 0 for the psum and segment-sum
     tiers and at most 4 ulps of max|x| for the ppermute tiers, the
     perimeter fraction, the rounds and each step's ms (an emulation);
     then ``dryrun_multichip(8)`` with every tier, 1-8;
 23. the ne120-class path, 86,400 elements x 72, f32, launch counts set to
     0 just before and read just after: the host build seconds of the cubed
     sphere and the plans, the assembled problem drawn on the card and the
     peak device memory after it, one CAAR launch with the slab against its
     plain version on the last 8,192 elements' lanes (5e-5 per field, the
     slab bit for bit), one assembled step with continuity exactly 0, and
     ``bench --nelem 86400`` and ``bench --ne 120`` (20 chained steps a
     timed run; their JSON lines carry the card's name and power limit);
 24. ``profiling.trace`` around 10 chained prim steps at ne30 x 72 (qsize
     1) and 10 assembled steps at ne120, launch counts set to 0 just before
     and read just after: the device's busy and idle shares of each window
     and its five longest device operations; a native ``Timers`` region
     around the same prim steps (``get_full``; the native timer must have
     built);
 25. the benchmark sweep ``tools.bench_all`` (the JAX tool's five entries at
     its sizes: the row CAAR step at 1024 x 72 and 8 x 26, the row tracer
     step at 128 x 72 x 35 tracers, the row CAAR step with the structured
     DSS at ne30, the saxpby triad). First each wrapper it times, one step
     on each entry's own inputs (``bench_all``'s problem builders and
     seeds) against its plain version: ``caar_packed`` at 1024 x 72, 8 x 26
     and on the ne30 entry's problem and ``euler_packed`` at 128 x 72 x 35,
     every output within 5e-5 scaled, ``saxpby_cuda`` bit for bit. Then,
     launch counts set to 0 just before and read just after, the sweep: its
     report on one line, every entry's numbers finite and positive,
     ``caar_packed``, ``euler_packed`` and ``saxpby_cuda`` launched;
 26. the JAX suite's long-run gates at ne30 x 72, f32, seed 7, launch
     counts set to 0 just before and read just after, each run beside its
     plain twin (f32) and the same plain code in float64 over the same
     steps, the kernel's distance from float64 at most 2x the plain f32
     run's plus 1e-7 (all three printed at steps 10, 100 and the last):
     300 projections c <- rsp*DSS(sph*c) through the DSS kernels with the
     one-float rspheremp row and the two-float pair (the two-float drift
     d2 < 3e-7 and < d1/5, the kernels bit for bit plain); a cosine bell
     at every level (its radius falling from 0.5 to 0.2 rad) once round
     the sphere by solid-body winds through ``ssprk3_tracer_packed_t``,
     2,400 steps (tests/test_advection.py's CFL at ne30: L2 error < 0.3,
     peak in (0.6, 1.2), relative mass drift < 1e-5 and within the 2x
     rule), and half round with the limiter (min > -1e-3, max < 1 + 1e-3,
     the mass rule), the twins at 9 of the levels (each level is computed
     on its own: those rows are a full-height twin's); 100
     ``bench.run_prim`` steps with the limiter at dt 0.1, nu 1e15 from
     the random init (continuity 0 after every step,
     finite, dp3d > 0, the norms under 10 x (start + 1), the rule for u, v,
     T, dp and qdp), its step time beside the card line;
 27. ``tools.equiv_check --ne 30`` (every kernel path against an
     independent form on the card, ``H100_EQUIV.json``'s keys), its report
     written to a temporary file and printed as one line, launch counts
     set to 0 just before and read just after; fails unless ``pass``.

 28. the breakdown tools and the GSPMD axes, launch counts set to 0 just
     before and read just after: ``bench.make_prim_problem``'s in-place
     tracer draw bit for bit the stacked draw it replaced (ne30, qsize 3);
     ``tools.profile_prim`` at ne30 x 72 with qsize 1 and with qsize 35
     ``--limit``, ``tools.profile_dss`` at ne30, ``tools.profile_limiter``
     at ne30 x 72 x 35 (the ladder nolimit, iters 0, 1, 2) and
     ``tools.profile_dss_ne120``, each with a small ``--nexec``, every
     line printed with the card's name and power limit; the tracer path at
     ne120 x 72 x qsize 35 (``profile_prim --ne 120 --qsize 35 --limit
     --gate``: the Euler and the limited kernels on the last NE120_BLOCK
     elements' lanes against their plain versions at 5e-5 a tracer block,
     one limited SSPRK3 step with continuity exactly 0, relative mass
     change within 4e-6 and min qdp >= -1e-6, its time and peak memory);
     the GSPMD axes of the JAX tests: ``dist.caar_level_sharded`` over
     ``LocalMesh(4)`` on levels at ne30 x 72 (4 shards of 18 levels) at
     rsplit 1 and 0 against the unsharded ``caar_array`` in f32 (1e-5
     scaled) and f64 (1e-12), and ``euler_step_sharded`` on the (4, 2)
     element x tracer mesh at ne30 x qsize 8 against ``euler_step`` (f64
     1e-12, f32 1e-6; whether bit for bit is printed); every kernel the
     tools time launched (CAAR, sweep, fixup, extract, Laplacian, Euler,
     limited).
 29. the CAAR kernels' bf16 storage (``storage="bf16_aux"`` / ``"bf16_ro"``,
     ``kernels.caar_t.STORAGE``): the plans of the storage instances
     (cudaOccupancy's blocks an SM beside the f32 instances' and the plan's,
     nvcc's registers and spills); every CAAR entry (``caar_t4_cuda``
     stacked, with the slab at ne30, ``caar_packed_t``, the t and row
     rsplit=0 steps, ``caar_packed``, the ring with and without mix) in
     each storage at 1024 x 72 and ne30 x 72 (bench and vort cases) and at
     1024 x 26, 150 and 400 (bench case): bit for bit the same kernel in
     f32 mode on the bf16 operands upcast, within 5e-5 scaled of its plain
     version on the same operands, within the JAX tests' envelopes of its
     f32 run (1e-4, 1.5e-2), the storage launch counters up by the bf16
     calls only, and a bf16 call allocating its outputs alone (no f32 copy
     of an operand); each mode's times by events and from CUDA graphs
     beside its bound, and the bf16_ro chain's cast of the old n0 to the
     bf16 nm1 slot timed alone. Then, launch counts set to 0 just before and read
     just after, 10 chained assembled steps at ne30 a storage on the
     stacked step, the ring and the row step, each step within 5e-5 of the
     plain step from its own input and the chain against its plain chain
     (1e-4 scaled in bf16_aux; 1.5e-2 in bf16_ro, whose bf16 rounding of
     each new nm1 turns an f32 ulp between the chains into a bf16 one),
     continuity exactly 0 after every step, the ring bit for bit the
     stacked step, the nm1 slot still bf16 in bf16_ro;
     ``tools.bench_assembled --ne 30 --nexec 5`` and
     ``bench --storage`` in f32 and both storages (raw on both layouts,
     ``--ne 30``, ``--ne 30 --ring``), each line's bytes the f32 count less
     2 bytes an element of each bf16 field.
 30. the bf16 operands of ``bench --prim / --rk --storage``: the CAAR stage
     mode with bf16 qdp and pecnd (contract a) and with an f32 qdp beside a
     bf16 pecnd (contract b), with and without phi and the slab, in the
     bench and vort cases at 1024 x 72 and ne30 x 72; the Euler and limited
     tracer stages with a bf16 q and the limited stage with a bf16 mix
     field, at qsize 1 and 35, at the run's dt and a long one; the merged
     sweep with a bf16 mix field at 72 and 2,520 rows: each bit for bit the
     same kernel on the upcast operands, within 5e-5 of its plain version
     (the sweep bit for bit), the storage launch counters up by the bf16
     calls; the new instances' blocks an SM and registers; their times from
     CUDA graphs beside the f32 instance's, each with its bound. Then,
     launch counts set to 0 just before and read just after, 10 chained
     ne30 ``prim_step_packed_t4`` steps from ``make_prim_problem(storage=
     "bf16_aux")``, unlimited at qsize 1 and limited at qsize 35, each step
     within 5e-5 of the plain step from its input, continuity 0, the first
     step's tracer mass within 1e-6 of its bf16 input's (the JAX package's
     bf16 Shu-Osher pair would add 2**-9), min qdp above the bounds gate;
     ``bench --ne 30 --prim --storage bf16_aux`` (also ``--limit --qsize
     35`` and ``--limit-iters 1``) and ``--rk --storage bf16_ro``, their
     bytes the f32 count less the bf16 reads of the timed steps; the
     field-form ``ssprk3_step`` at rsplit=0 on the card against the CPU in
     f64 at ne 4 (1e-12, eta_dot_dpdn included); a non-blocking
     ``save_checkpoint_dir`` of the ne30 state, 10 prim steps written in
     place, ``finish_async_checkpoints`` and a load equal to the state at
     the call bit for bit, with the host ms the save call blocked beside
     the blocking npz save's.

Phases 22-30 run after phase 21, before the lines of phase 17.

Any failure raises and exits non-zero before the result line is printed.
Run from the repository root: ``python3 chip_smoke.py``.

``kernel_times()`` times the sweep, the t-layout CAAR kernel, the fixup, the
packed remap, the two tracer stages, the two row CAAR kernels, the t
rsplit=0 kernel and both rings through
entry points that older trees share, so the same
measurement runs against a parent checkout: from that checkout's root,
``python3 -c "import importlib.util as u; s = u.spec_from_file_location(
'cs', '<this file>'); m = u.module_from_spec(s); s.loader.exec_module(m);
m.kernel_times()"`` prints one JSON line for its kernels.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
import shutil
import sys
import time

# what the ring CAAR kernel's and the banded sweep's designs before their
# redesign for the H100 took (NVIDIA H100 80GB HBM3, 700.00 W), as PERF.md
# records them: printed beside this run's times of the new designs, never
# compared with them by the script
PARENT = {
    "caar_ring": "PERF.md row 18 (128-column tiles, a lane a thread "
                 "sweep): pair 0.7031 ms, stage with mix 0.6866 ms, the two "
                 "launches 0.3115 ms (events)",
    "ring_bench": "bench --ne 30 --ring ~721 us/step (PERF.md)",
    "banded": "PERF.md rows 27-29 (a lane a thread): 12 shards of "
              "ne30 x 288 rows graph 0.2706-0.2742 ms, 2,520 rows graph "
              "2.0515-2.0568 ms, merge-free 2,520 rows 1.9180-1.9287 ms "
              "(events)",
    "banded_steps": "phase 19 before the redesign (PERF.md): banded "
                    "assembled step graph 0.9395-0.9416 ms, events "
                    "2.0454-3.2489 ms; banded prim step events "
                    "16.7991-27.1150 ms",
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, non-tensor FP32
# FP32 operations per grid point of one CAAR step, counted from
# csrc/caar.cu (derivative contractions, scans, tendencies, apply)
CAAR_OPS_PER_POINT = 190
# FP32 operations per grid point of the weak Laplacians, counted from
# csrc/hypervis.cu (9 contractions of 7, the metric products, the rigid term)
VLAP_OPS_PER_POINT = 140
# FP32 operations per grid point and tracer of the two tracer stages: the
# flux and metric products and two contractions of 7, and for the limited
# stage the limiter's 8 group reductions and two passes (an upper count:
# csrc/tracer.cu forms the metric products once a level, not a tracer)
TRACER_OPS_PER_POINT = 36
LIMIT_OPS_PER_POINT = 110
# the rsplit=0 mode adds per grid point the divergence of pass 1, the two
# interface fluxes, 1/dp, the vertical advection of u, v, T and the dp
# stencil, counted from csrc/caar.cu
RSPLIT0_OPS_PER_POINT = 250
# the row tracer kernel: two flux products, the metric products and two
# contractions of 7 per point and tracer (csrc/tracer.cu)
TRACER_ROW_OPS_PER_POINT = 32
# the merge-free sweep: per output element up to 3 adds and the two-float
# scale (2 products, 1 add), and with mix 3 more (dss_sweep.cuh)
SWEEP_OPS_PER_POINT = 6
MIX_OPS_PER_POINT = 3
WIND = 30.0                    # m/s: the wind case's winds, U(-1, 1) x this
# the rsplit=0 cases' long step: the dp update this share of max|dpm1|
LONG_STEP = 0.5
CAAR_TOL = 5e-5                # the repo's on-chip equivalence gate
# nlev off the main path that phase 3 also checks: 26 (7 level chunks of 4,
# the last of 2), 150 (8 of 19, the last of 17, and no stash) and 400, the
# most caar_plan admits (8 of 50)
CAAR_OTHER_NLEV = (26, 150, 400)
# the probe kernel against twenty cuBLAS products in full f32: dots of up to
# 1024 terms in another order, of max|o|
PROBE_TOL = 2e-6
# shapes where probe_plan takes the pipelined mode (a rank's k range too long
# to stay resident), one on each tile, the second ragged in m, n and k
PROBE_PIPELINED_SHAPES = ((512, 4096, 512), (250, 2000, 250))
# the remap cadence's kernel chain against its plain chain, whose remap is
# the plain code in float64 (the plain float32 remap is itself 7e-5 to
# 1.6e-4 of max|x| off the float64 remap at ne30 x 72 on the H100, and a
# chain limit would then hold the reference's error, not the kernel's);
# each step alone is held against the plain step from the same input at
# DYN_TOL
CADENCE_TOL = 1e-4
# the fixer's air mass against its target: f32 sums of 6.2M terms before and
# after one rescale (a few ulps)
REMAP_MASS_TOL = 1e-6
# the remap kernel's column totals of x*dp (and of qdp) against the input's,
# of the column's sum |x|*dp: its pieces partition every source cell, so
# only the rounding of ~2K pieces and of x' * dp_tgt is left
REMAP_TOTAL_TOL = 1e-6
# the float64 remap kernel against the plain float64 remap, scaled: the
# plain code's prefix differences lose ~K ulps
REMAP_F64_TOL = 1e-12
# f32 operations per level, column and field of the remap kernel, counted
# from csrc/remap.cu: the reconstruction's slope and limiter (~12), the
# target pass's lower integral, sums and mean (~9) and a share of the
# column's chains and geometry (~8)
REMAP_OPS_PER_POINT = 30
CONSERVE_TOL = 4e-6            # limiter: an element's mass, of its sum|w*y|
BOUNDS_TOL = 1e-6              # limiter: outside the bounds, of max|q|
QSIZE_TALL = 35                # E3SM's tracer count: the [2520, E16] stack
LEAPFROG_TOL = 1e-4
# 10 dynamics steps, kernels against plain: the chain moves the state by a
# few 1e-4 of its size, so the looser leapfrog limit would pass a chain that
# stood still
DYN_TOL = 1e-5
PROJECTION_TOL = 2e-6          # f32 rounding of a 4-term mass-weighted mean
NE = 30                        # E3SM's standard grid: 5,400 elements
NLEV = 72
# the dynamics runs: E3SM's ne30 hyperviscosity coefficient, and a step far
# inside the stability limit of the random (unbalanced) initial state
DYN_NU = 1e15
DYN_DT = 0.1
# phase 22: the element-sharded tiers' shards (675 elements a shard at ne30),
# their gate against the single-device step (the same sums in another order),
# and the ulps of max|x| that a ppermute tier's aliases may differ by
TIER_SHARDS = 8
TIER_TOL = 1e-5
TIER_CONT_ULPS = 4
TIER_FIELDS = ("u", "v", "t", "dp3d")
# phase 23: the ne120-class grid (86,400 elements), the CAAR gate's block of
# elements and the benches' chained steps a timed run
NE120 = 120
NE120_BLOCK = 8192
NE120_STEPS = 20
# phase 24: traces taken of one window at most, until one holds every CAAR
# launch of it
TRACE_TRIES = 3
# phase 26: the long runs at ne30 x 72, f32, seed 7. Each kernel run is held
# against its plain twin (f32) and the same plain code in float64 over the
# same steps: the kernel's distance from the float64 run may be at most
# LONG_RATIO times the plain f32 run's plus LONG_FLOOR (a long f32 chain is
# not expected to stay bit-close to plain); the distances are printed at
# LONG_SHOWN steps and the last
LONG_RATIO = 2.0
LONG_FLOOR = 1e-7
LONG_SHOWN = (10, 100)
SEED = 7
# 300 projections c <- rsp*DSS(sph*c) (tests/test_conservation.py): the
# two-float rspheremp's relative mass drift d2 under CONSERVE_DRIFT and a
# fifth of the one-float drift d1
PROJECTIONS = 300
CONSERVE_DRIFT = 3e-7
# the cosine bell once round the sphere by solid-body rotation in 12 days:
# tests/test_advection.py's 480 steps at ne 6 keep CFL ~0.3 of its minimum
# GLL spacing ~0.217/ne, so the steps grow with ne (2,400 at ne30); the
# bell's radius falls over the levels (LEVEL_RADII rad), its L2 error after
# a revolution under BELL_L2 and its peak inside BELL_PEAK; its relative
# mass drift (f64 sums over f32 data) under BELL_MASS_TOL
BELL_STEPS_PER_NE = 80
BELL_PERIOD = 12.0 * 86400.0
LEVEL_RADII = (0.5, 0.2)
BELL_L2 = 0.3
BELL_PEAK = (0.6, 1.2)
BELL_MASS_TOL = 1e-5
BELL_LIMIT_SLACK = 1e-3        # limited: min > -this, max < 1 + this
# the bell's plain twins run every TWIN_STRIDE-th level and the last: the
# tracer step computes every level on its own (the winds, the limiter's
# elements and the DSS are per level), so these rows are a full-height
# twin's, bit for bit, at an eighth of its cost (tests/test_torch_advection.py
# checks the independence)
TWIN_STRIDE = 9
# the prim soak: 100 steps of bench.run_prim with the limiter, norms under
# 10 x (their start + 1) (tests/test_soak.py)
SOAK_STEPS = 100
# phase 28: the breakdown tools' chained calls a timed run (small, to keep
# the phase short), the GSPMD axes' meshes and their gates against the
# unsharded forms (scaled max-abs; the level shards' scans add in another
# order)
TOOL_NEXEC = 5
LEVEL_SHARDS = 4
EQ_MESH = (4, 2)
EQ_QSIZE = 8
AXES_TOL = {"float64": 1e-12, "float32": 1e-5}
EULER_TOL = {"float64": 1e-12, "float32": 1e-6}
# phase 29: the bf16 storage modes of the CAAR kernels, the JAX tests'
# envelopes of the f32 path (tests/test_caar_pallas.py:221), the chained
# assembled steps a storage, and the wrapper whose storage_launches counts
# each entry
STORAGE_MODES = ("bf16_aux", "bf16_ro")
STORAGE_ENVELOPE = {"bf16_aux": 1e-4, "bf16_ro": 1.5e-2}
STORAGE_STEPS = 10
STORAGE_WRAPPER = {"t4": "caar_t4_cuda", "t": "caar_t4_cuda",
                   "t r0": "caar_packed_rsplit0_t", "row": "caar_packed",
                   "row r0": "caar_packed_rsplit0",
                   "ring": "caar_ring_packed_t4",
                   "ring mix": "caar_ring_packed_t4"}


# phase 30: the bf16 operands that the JAX package's full step hands its
# stage, tracer and sweep kernels under bench --prim / --rk --storage:
# each instance against the same kernel on the upcast
# operands (bit for bit) and its plain version (CAAR_TOL); the chains a
# step against the plain step from its input (CAAR_TOL); the first bf16
# tracer step's mass against its upcast input's (PRIM_MASS_TOL: JAX's bf16
# Shu-Osher pair would add 2**-9 of it)
PRIM_STORAGE_STEPS = 10
PRIM_MASS_TOL = 1e-6
# the field-form SSPRK3 step at rsplit=0 on the card against the CPU, f64
R0_FIELD_NE = 4
R0_FIELD_NLEV = 8
R0_FIELD_TOL = 1e-12
# the directory checkpoint's scratch, under the gitignored build/
CKPT_DIR = os.path.join("build", "chip_smoke_checkpoints")



def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    from tinman_sandbox_tpu_torch.bench import card_name_and_power

    line = card_name_and_power()
    if not line:
        raise RuntimeError("nvidia-smi did not report the card")
    return line


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph over ``n``
    replays, by CUDA events: the device's time for its launches without the
    host's cost of issuing them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, n)


def scaled_err(a, b) -> float:
    """max|a - b| / max|b|; the plain max|a - b| where b is all zero."""
    b = b.double()
    diff, scale = float((a.double() - b).abs().max()), float(b.abs().max())
    return diff / scale if scale > 0 else diff


def caar_cases(const, acc):
    """The CAAR gate's cases as (name, args), args the operands of
    ``caar_t4_cuda`` / ``caar_t4_plain``. s1 = spheremp*(sm1 + dt2*tendency).
    On the bench problem dt2 * T's tendency is ~2e-3 against T ~ 300, near
    f32 resolution, and in u and v the vorticity and kinetic-energy terms
    are ~1e-7 of the Coriolis and pressure-gradient terms. A kernel that
    dropped one of them would pass there, so besides the bench problem:
      tend:  sm1 = 0, so s1 is the scaled tendency itself;
      vort:  sm1 = 0, T = 0, phis = 0, fcor = 0 and a random pecnd, so the
             vorticity, kinetic-energy and pecnd gradients carry u1 and v1."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS

    scal, meta, s0, sm1, qdp, pecnd, dvv = const
    k = qdp.shape[0]
    zero = torch.zeros_like(sm1)
    cold = s0.clone()
    cold[2 * k:3 * k] = 0
    flat = meta.clone()
    flat[META_COLS.index("phis")] = 0
    flat[META_COLS.index("fcor")] = 0
    rng = np.random.default_rng(3)
    pec = torch.from_numpy(rng.uniform(-1, 1, tuple(pecnd.shape)).astype(
        np.float32)).to(pecnd.device)
    return [("bench", (scal, meta, s0, sm1, qdp, pecnd, *acc, dvv)),
            ("tend", (scal, meta, s0, zero, qdp, pecnd, *acc, dvv)),
            ("vort", (scal, flat, cold, zero, qdp, pec, *acc, dvv))]


def caar_field_errs(got, want, nlev) -> dict:
    """Scaled error of each output field on its own: the four row blocks of
    s1, phi and the three accumulators."""
    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")
    pairs = list(zip(got[0].split(nlev), want[0].split(nlev)))
    pairs += list(zip(got[1:], want[1:]))
    return {n: scaled_err(g, w) for n, (g, w) in zip(names, pairs)}


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sector_floor_ms(lanes, rows: int, e16: int, passes: int) -> float:
    """ms at HBM_BYTES_PER_S for ``passes`` whole 32-byte sectors of a row
    for each sector that one of ``lanes`` falls in, plus one 4-byte value a
    lane and row, and the lane table once; rows of e16 lanes start on a
    sector."""
    import torch

    if e16 % 8:
        raise ValueError(f"sector floor: rows of {e16} lanes straddle "
                         "sectors")
    sectors = torch.unique(lanes.long() // 8).numel()
    n = lanes.numel()
    nbytes = rows * (sectors * 32 * passes + n * 4) + n * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def patch_floor_ms(lanes, rows: int, e16: int, mix: bool) -> float:
    """The patch's sector floor: each 32-byte sector of w that a fix lane
    falls in written whole (and with mix the same sectors of mx read), vd
    and the lane table read once; rows of e16 lanes start on a sector."""
    return _sector_floor_ms(lanes, rows, e16, 2 if mix else 1)


def extract_floor_ms(lanes, rows: int, e16: int) -> float:
    """The extract's sector floor: each 32-byte sector of x that a read
    lane falls in read whole, the slab [lanes, rows] written and the lane
    table read once; rows of e16 lanes start on a sector."""
    return _sector_floor_ms(lanes, rows, e16, 1)


def host_ms(fn, n: int) -> float:
    """The host's milliseconds per ``fn()`` call: the least over five
    loops of ``n`` calls, the host clock stopped before the device is waited
    for (n well under the launch queue's depth)."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e3)
        torch.cuda.synchronize()
    return best


def patch_times(w, vd, fix, mx, ca, cb, reps: int) -> dict:
    """The merge patch (without and with mix) and ``index_copy_`` on the
    same operands, each by CUDA events over ``reps`` back-to-back calls
    (what a caller sees, host included), replayed from a CUDA graph (the
    device's time alone) and, without mix, the host's time per call
    (``host_ms``). w is patched in place by every call."""
    from tinman_sandbox_tpu_torch.kernels.dss import dss_merge_patch_cuda

    lanes = fix.fix_lanes.long()
    run = lambda: dss_merge_patch_cuda(w, vd, fix)
    run_mix = lambda: dss_merge_patch_cuda(w, vd, fix, (mx, ca, cb))
    lib = lambda: w.index_copy_(1, lanes, vd)
    return dict(ms=cuda_ms(run, reps), mix_ms=cuda_ms(run_mix, reps),
                library_ms=cuda_ms(lib, reps), graph_ms=graph_ms(run, reps),
                mix_graph_ms=graph_ms(run_mix, reps),
                library_graph_ms=graph_ms(lib, reps),
                host_ms=host_ms(run, reps),
                library_host_ms=host_ms(lib, reps))


def kernel_times() -> dict:
    """The kernels the last trees redesigned, timed through entry points that
    every tree since the remap cadence was ported has, by CUDA events over
    back-to-back calls (``ms``), replayed from a CUDA graph (``graph_ms``,
    the device alone) and by the host's clock per call (``host_ms``, the
    wrapper's checks and the launch): ``dss_sweep_cuda`` on ne30 at 72, 288
    and 2,520 rows, without and with mix (a new output), and at 216 rows
    with mix in place into a 288-row field (the dynamics step's form);
    ``caar_t4_cuda`` in the pair form at 1024 x 72, the pair form with the
    slab at ne30 x 72, and the stage mode with the slab, with and without
    phi, at ne30 x 72; ``dss_fixup_cuda`` on ne30 at 72, 288 and 2,520
    rows; ``dist.remap_packed_t4`` (no fixer) at ne30 x 72, qsize 1 and 35,
    on phase 21's input (``cadence_input``: the cadence after rsplit steps;
    ``ms`` and ``graph_ms`` over 20 calls); ``tracer_euler_cuda``
    and ``tracer_limit_cuda`` without and with mix at ne30 x 72, qsize 1
    and 35, on the prim bench's tracers with the winds read out of its
    state and the slab, as the prim step calls them; the row-layout CAAR
    step ``caar_packed`` and its rsplit=0 mode ``caar_packed_rsplit0``
    (hybi ramp, random eta accumulator) at 1024 x 72 and ne30 x 72 on the
    row benches' problems and at 1024 x 400; the t-layout rsplit=0 step
    ``caar_packed_rsplit0_t`` on the same problems transposed; the row
    assembled step at ne30
    (``dist.caar_dss_structured_packed``: by events, the host's time a
    call and its kernels a call by ``torch.profiler``). Run against
    another tree by importing this file with that tree first on
    ``sys.path``; prints and returns one JSON object."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import remap_packed_t4
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
    from tinman_sandbox_tpu_torch.kernels.dss import (dss_fixup_cuda,
                                                      dss_sweep_cuda,
                                                      fix_tables)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (tracer_euler_cuda,
                                                           tracer_limit_cuda)

    dev = torch.device("cuda", 0)
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(NE, NLEV, dev)
    fix = fix_tables(plan, dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    ca, cb = float(np.float32(1.0 / 3.0)), float(np.float32(2.0 / 3.0))
    out = {"card": card_line(), "sweep": {}, "caar": {}, "fixup": {}}

    def both(fn, reps):
        return dict(ms=cuda_ms(fn, reps), graph_ms=graph_ms(fn, reps),
                    host_ms=host_ms(fn, reps))

    for rows in (NLEV, 4 * NLEV, QSIZE_TALL * NLEV):
        x = torch.randn(rows, fix.e16, generator=gen, device=dev)
        mx = torch.randn(rows, fix.e16, generator=gen, device=dev)
        vd = torch.randn(rows, fix.nfix, generator=gen, device=dev)
        reps = 50 if rows < 1000 else 10
        out["sweep"][rows] = dict(
            plain=both(lambda: dss_sweep_cuda(x, rsp, vd, fix), reps),
            mix=both(lambda: dss_sweep_cuda(x, rsp, vd, fix, (mx, ca, cb)),
                     reps))
        del x, mx, vd
    k3 = 3 * NLEV
    x3 = torch.randn(k3, fix.e16, generator=gen, device=dev)
    buf = torch.randn(4 * NLEV, fix.e16, generator=gen, device=dev)
    vd3 = torch.randn(k3, fix.nfix, generator=gen, device=dev)
    out["sweep"]["216_in_place"] = both(
        lambda: dss_sweep_cuda(x3, rsp, vd3, fix, (buf, 1.0, cb)), 50)
    del x3, buf, vd3

    const, racc = bench.make_problem(1024, NLEV, dev, seed=7)
    r_scal, r_meta, r_s0, r_sm1, r_qdp, r_pecnd, r_dvv = const
    racc = [a.clone() for a in racc]
    out["caar"]["pair_1024"] = both(lambda: caar_t4_cuda(
        r_scal, r_meta, r_s0, r_sm1, r_qdp, r_pecnd, *racc, r_dvv), 50)
    acc = [a.clone() for a in acc]
    out["caar"]["pair_slab_ne30"] = both(lambda: caar_t4_cuda(
        scal, meta, s0, sm1, qdp, pecnd, *acc, dvv, fix=fix), 20)
    for emit_phi in (True, False):
        out["caar"][f"stage_slab_ne30_phi{int(emit_phi)}"] = both(
            lambda: caar_t4_cuda(scal, meta, s0, None, qdp, pecnd, *acc, dvv,
                                 fix=fix, single=True, emit_phi=emit_phi), 20)
    for rows in (NLEV, 4 * NLEV, QSIZE_TALL * NLEV):
        slab = torch.randn(fix.nsrc, rows, generator=gen, device=dev)
        out["fixup"][rows] = both(lambda: dss_fixup_cuda(slab, fix, rsp),
                                  50 if rows < 1000 else 20)
        del slab
    out["remap"] = {}
    for qsize in (1, QSIZE_TALL):
        prob, rs, rq = cadence_input(dev, qsize)
        remap = lambda: remap_packed_t4(rs, rq, prob["hv"],
                                        prob["cfg"].nelem, NLEV, qsize)
        out["remap"][qsize] = dict(ms=cuda_ms(remap, 20),
                                   graph_ms=graph_ms(remap, 20))
        del prob, rs, rq
        torch.cuda.empty_cache()
    const, ps0, _, _, _, _ = bench.make_prim_problem(NE, NLEV, dev, DYN_DT, 1)
    pmeta, pdvv = const[1], const[3]
    kw = dict(wind_rows=(0, 1), fix=fix)
    out["tracer"] = {}
    for qsize in (1, QSIZE_TALL):
        q = bench.make_prim_problem(NE, NLEV, dev, DYN_DT, qsize)[2]
        mx = torch.rand(q.shape, generator=gen, device=dev)
        reps = 50 if qsize == 1 else 10
        out["tracer"][qsize] = dict(
            euler=both(lambda: tracer_euler_cuda(
                pmeta, ps0, ps0, q, pdvv, DYN_DT, NLEV, **kw), reps),
            limit=both(lambda: tracer_limit_cuda(
                pmeta, ps0, ps0, q, pdvv, DYN_DT, NLEV, **kw), reps),
            limit_mix=both(lambda: tracer_limit_cuda(
                pmeta, ps0, ps0, q, pdvv, DYN_DT, NLEV, mix=(mx, ca, cb),
                **kw), reps))
        del q, mx
        torch.cuda.empty_cache()
    from tinman_sandbox_tpu_torch.kernels.caar import (caar_packed,
                                                       caar_packed_rsplit0)
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_packed_rsplit0_t
    out["row"] = {}
    rc, racc = bench.make_problem(1024, NLEV, dev, seed=7, layout="row")
    shapes = {"1024": (rc[:-1], racc, rc[-1])}
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, *rest = \
        bench.make_assembled_problem(NE, NLEV, dev, layout="row")
    shapes["ne30"] = ((scal, meta, *s0, *sm1, qdp, pecnd), acc, dvv)
    deep = CAAR_OTHER_NLEV[-1]
    rc, racc = bench.make_problem(1024, deep, dev, seed=7, layout="row")
    shapes[f"1024x{deep}"] = (rc[:-1], racc, rc[-1])
    for tag, (head, acc, dvv) in shapes.items():
        nlev = head[-1].shape[1]
        hybi = torch.linspace(0.0, 1.0, nlev + 1, device=dev)
        hyb = torch.stack([hybi[:nlev], hybi[1:]]).contiguous()
        acc = [a.clone() for a in acc]
        eta = torch.rand(acc[0].shape, generator=gen, device=dev)
        reps = 50 if tag == "1024" else 10
        out["row"][f"pair_{tag}"] = both(
            lambda: caar_packed(*head, *acc, dvv), reps)
        out["row"][f"rsplit0_{tag}"] = both(
            lambda: caar_packed_rsplit0(head[0], hyb, *head[1:], *acc, eta,
                                        dvv), reps)
        # the t layout's rsplit=0 step on the transposed problem
        th = (head[0], *(x.T.contiguous() for x in head[1:]))
        thyb = hyb.T.contiguous()
        tacc = [a.T.contiguous() for a in acc]
        teta = eta.T.contiguous()
        out["row"][f"t_rsplit0_{tag}"] = both(
            lambda: caar_packed_rsplit0_t(th[0], thyb, *th[1:], *tacc, teta,
                                          dvv), reps)
        del th, thyb, tacc, teta
    # the row assembled step (the bench's ``--layout row --ne 30``): the row
    # kernel, then the structured DSS in plain PyTorch
    from tinman_sandbox_tpu_torch.dist.step_t import \
        caar_dss_structured_packed
    acc = [a.clone() for a in shapes["ne30"][1]]
    plan, rsp = rest
    step = lambda: caar_dss_structured_packed(*shapes["ne30"][0], *acc,
                                              shapes["ne30"][2], plan, rsp)
    out["row"]["assembled_ne30"] = dict(
        ms=cuda_ms(step, 10), host_ms=host_ms(step, 10),
        launches=kernel_launches(step))
    del shapes, acc
    torch.cuda.empty_cache()
    out.update(ring_times(dev))
    out["banded"] = banded_times(dev)
    print(json.dumps(out))
    return out


def ring_times(dev) -> dict:
    """``kernel_times()``'s ring kernels at ne30 x 72: ``caar_ring_packed_t4``
    in the pair form with the slab and the stage mode without phi with mix,
    by events, and from CUDA graphs where the tree's ring launch clears its
    flags (a tree with ``ring_fused.ring_plan``: an older ring flagged with
    a per-call epoch, which a graph replays unchanged, so its graph would
    not wait); the two launches it fuses by events and from graphs;
    ``tracer_ring_packed_t`` at qsize 1 and 35, without and with mix, by
    events, and from CUDA graphs where the tree's tracer ring launch clears
    its state (a tree with ``ring_fused.tracer_ring_plan``; before, its
    flags kept a per-call epoch), beside the two launches it fuses by
    events and from graphs. Returns {"ring": ..., "tracer_ring": ...}."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import ring_fused
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
    from tinman_sandbox_tpu_torch.kernels.dss import (dss_sweep_nomerge_cuda,
                                                      fix_tables)

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(NE, NLEV, dev)
    fix = fix_tables(plan, dev)
    mx = torch.randn(s0.shape, generator=torch.Generator(
        device=dev).manual_seed(15), device=dev)
    ca, cb = float(np.float32(1.0 / 3.0)), float(np.float32(2.0 / 3.0))
    acc = [a.clone() for a in acc]
    safe = hasattr(ring_fused, "ring_plan")
    ring, tracer = {}, {}
    for mode, sm, kw, mix in (
            ("pair_slab", sm1, {}, None),
            ("stage_mix", None, dict(single=True, emit_phi=False),
             (mx, ca, cb))):
        run = lambda: ring_fused.caar_ring_packed_t4(
            scal, meta, s0, sm, qdp, pecnd, *acc, dvv, rsp, fix, mix=mix,
            **kw)
        two = lambda: dss_sweep_nomerge_cuda(caar_t4_cuda(
            scal, meta, s0, sm, qdp, pecnd, *acc, dvv, fix=fix, **kw)[0],
            rsp, fix, mix)
        ring[mode] = dict(ms=cuda_ms(run, 20), two_launch_ms=cuda_ms(two, 20),
                          two_launch_graph_ms=graph_ms(two, 20))
        if safe:
            ring[mode]["graph_ms"] = graph_ms(run, 20)
    del s0, sm1, mx, acc
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    const, ps0, _, _, _, _ = bench.make_prim_problem(NE, NLEV, dev, DYN_DT, 1)
    pmeta, pdvv = const[1], const[3]
    tsafe = hasattr(ring_fused, "tracer_ring_plan")
    kw = dict(wind_rows=(0, 1))
    for qsize in (1, QSIZE_TALL):
        q = bench.make_prim_problem(NE, NLEV, dev, DYN_DT, qsize)[2]
        mx = torch.rand(q.shape, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        reps = 20 if qsize == 1 else 5
        tracer[qsize] = {}
        for tag, mix in (("", None), ("mix_", (mx, ca, cb))):
            run = lambda: ring_fused.tracer_ring_packed_t(
                pmeta, ps0, ps0, q, pdvv, DYN_DT, NLEV, rsp, fix, mix=mix,
                **kw)
            two = lambda: dss_sweep_nomerge_cuda(tracer_euler_cuda(
                pmeta, ps0, ps0, q, pdvv, DYN_DT, NLEV, fix=fix, **kw)[0],
                rsp, fix, mix)
            tracer[qsize].update({
                f"{tag}ms": cuda_ms(run, reps),
                f"{tag}two_launch_ms": cuda_ms(two, reps),
                f"{tag}two_launch_graph_ms": graph_ms(two, reps)})
            if tsafe:
                tracer[qsize][f"{tag}graph_ms"] = graph_ms(run, reps)
        del q, mx
        torch.cuda.empty_cache()
    return {"ring": ring, "tracer_ring": tracer}


def banded_times(dev) -> dict:
    """``kernel_times()``'s banded sweep over the 12 shards of ne30 (m 2) at
    288 and 2,520 rows, merged and merge-free, one launch a shard, by
    events and from CUDA graphs; and the banded assembled step
    (``caar_dss_banded_t4`` over ``LocalMesh(12)``) by events and from a
    CUDA graph."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (
        LocalMesh, build_cubed_sphere, caar_dss_banded_t4,
        make_structured_plan, rsp_lanes_2f, shard_packed_t4)
    from tinman_sandbox_tpu_torch.dist.banded_t4 import (_band_shard,
                                                         band_extend)
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_sweep_banded_cuda, dss_sweep_banded_nomerge_cuda)

    m, N = 2, 12
    cs = build_cubed_sphere(NE, dtype=torch.float32, device=dev)
    plan = make_structured_plan(cs.gdof, NE)
    rsp = torch.from_numpy(rsp_lanes_2f(cs.geometry.spheremp, cs.gdof,
                                        cs.ndof)).to(dev)
    mesh = LocalMesh(N, dev)
    bts = [_band_shard(plan, m, N, s, str(dev)).band for s in range(N)]
    (rsps,) = shard_packed_t4(mesh, rsp)
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for rows in (4 * NLEV, QSIZE_TALL * NLEV):
        x = torch.randn(rows, cs.nelem * 16, generator=gen, device=dev)
        xe = band_extend(mesh, plan, m, shard_packed_t4(mesh, x)[0])
        vds = [torch.randn(rows, bt.fix.nfix, generator=gen, device=dev)
               for bt in bts]
        sw = lambda: [dss_sweep_banded_cuda(a, b, c, d)
                      for a, b, c, d in zip(xe, rsps, vds, bts)]
        nm = lambda: [dss_sweep_banded_nomerge_cuda(a, b, d)
                      for a, b, d in zip(xe, rsps, bts)]
        reps = 20 if rows < 1000 else 5
        out[rows] = dict(ms=cuda_ms(sw, reps), graph_ms=graph_ms(sw, reps),
                         nomerge_ms=cuda_ms(nm, reps),
                         nomerge_graph_ms=graph_ms(nm, reps))
        del x, xe, vds
        torch.cuda.empty_cache()
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, splan, srsp = \
        bench.make_assembled_problem(NE, NLEV, dev)
    sh = shard_packed_t4(mesh, meta, s0, sm1, qdp, pecnd, srsp, *acc)
    step = lambda: caar_dss_banded_t4(scal, sh[0], sh[1], sh[2], sh[3], sh[4],
                                      *sh[6:9], dvv, splan, sh[5], mesh, m)
    out["assembled_step"] = dict(ms=cuda_ms(step, 10),
                                 graph_ms=graph_ms(step, 10))
    return out


def phase_saxpby(dev):
    import torch

    from tinman_sandbox_tpu_torch.kernels.saxpby import saxpby_cuda, saxpby_plain

    rows, cols, a, b = 8192, 4096, 3.0, -0.25
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, cols, generator=gen, device=dev)
    y = torch.randn(rows, cols, generator=gen, device=dev)
    want = saxpby_plain(a, b, x, y)
    got = saxpby_cuda(a, b, x.clone(), y)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("saxpby kernel differs from its plain version")
    xk = x.clone()
    k_ms = cuda_ms(lambda: saxpby_cuda(1.0, 1e-6, xk, y), 50)
    p_ms = cuda_ms(lambda: saxpby_plain(1.0, 1e-6, x, y), 20)
    xl = x.clone()
    l_ms = cuda_ms(lambda: xl.mul_(1.0).add_(y, alpha=1e-6), 50)
    n = rows * cols
    nbytes = 3 * n * 4
    bnd, by = bound_ms(nbytes, 3 * n)
    print(f"phase 2 saxpby {rows}x{cols} f32: bitwise equal; kernel "
          f"{k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s), plain "
          f"{p_ms:.4f} ms, library mul_+add_ {l_ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({by})")
    return dict(name="saxpby_cuda", route="cuda",
                source="tinman_sandbox_tpu_torch/csrc/saxpby.cu",
                replaces="tinman_sandbox_tpu/kernels/saxpby.py:24",
                max_abs_err=float((got - want).abs().max()), ms=k_ms,
                plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=l_ms)


def caar_plan_line(plan, dev) -> str:
    """The chunked CAAR kernel's plan: tile, chunks, stash, threads, shared
    memory, the blocks an SM it reckons with and cudaOccupancy's, waves."""
    import torch

    from tinman_sandbox_tpu_torch.kernels import _build

    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = _build.library("caar").caar_blocks_per_sm(
        0, plan.nlev, plan.chunks, int(plan.stash), 0, dev.index)
    if occ <= 0:
        raise AssertionError(f"caar occupancy: error {-occ}")
    return (f"tile {plan.tile}, {plan.chunks} chunks of {plan.levels} levels,"
            f" stash {'on' if plan.stash else 'off'}, {plan.threads} threads, "
            f"{plan.smem} B shared; {plan.blocks} blocks, "
            f"{plan.blocks_per_sm} a SM reckoned, {occ} by cudaOccupancy x "
            f"{nsm} SMs = "
            f"{plan.blocks / (occ * nsm):.3f} waves")


def phase_caar(dev):
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import (caar_plan,
                                                         caar_t4_cuda,
                                                         caar_t4_plain)

    row = None
    # 1001 elements: the last warp of the last tile half live
    for nelem in (1024, 5400, 1001):
        nlev = 72
        const, acc = bench.make_problem(nelem, nlev, dev, seed=7)
        max_abs = 0.0
        for case, args in caar_cases(const, acc):
            want = caar_t4_plain(*args)
            kacc = [x.clone() for x in args[6:9]]
            got = caar_t4_cuda(*args[:6], *kacc, args[9])
            torch.cuda.synchronize()
            for g in got:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"caar {nelem} {case}: non-finite")
            errs = caar_field_errs(got, want, nlev)
            print(f"phase 3 caar {nelem}x{nlev} {case}: scaled errors "
                  + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            if max(errs.values()) > CAAR_TOL:
                raise AssertionError(
                    f"caar {nelem}x{nlev} {case}: {errs} > {CAAR_TOL}")
            max_abs = max(max_abs, *(float((g - w).abs().max())
                                     for g, w in zip(got, want)))
        if nelem == 1001:
            continue
        scal, meta, s0, sm1, qdp, pecnd, dvv = const
        kacc = [x.clone() for x in acc]
        run = lambda: caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *kacc,
                                   dvv)
        k_ms, g_ms = cuda_ms(run, 20), graph_ms(run, 20)
        p_ms = cuda_ms(lambda: caar_t4_plain(scal, meta, s0, sm1, qdp, pecnd,
                                             *acc, dvv), 5)
        e16 = nelem * 16
        # 21 fields, the 13 meta rows the kernel reads, dvv and 3 scalars
        nbytes = (21 * nlev + 13) * e16 * 4 + 16 * 4 + 3 * 4
        bnd, by = bound_ms(nbytes, CAAR_OPS_PER_POINT * e16 * nlev)
        print(f"phase 3 caar {nelem}x{nlev}: kernel {k_ms:.4f} ms (from a "
              f"graph {g_ms:.4f} ms), plain {p_ms:.4f} ms, bound {bnd:.4f} ms "
              f"({by}, {nbytes} B); plan: "
              + caar_plan_line(caar_plan(e16, nlev), dev))
        if nelem == 1024:
            row = dict(name="caar_t4_cuda", route="cuda",
                       source="tinman_sandbox_tpu_torch/csrc/caar.cu",
                       replaces="tinman_sandbox_tpu/kernels/caar_pallas_t.py:542",
                       max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms,
                       bound_ms=bnd, bound_by=by, library_ms=None,
                       graph_ms=g_ms)
    for nlev in CAAR_OTHER_NLEV:
        caar_other_nlev(dev, nlev)
    return row


def caar_other_nlev(dev, nlev: int):
    """Phase 3 off the main path's nlev: at ne30 x ``nlev`` the chunked
    kernel in the pair form and the stage mode, with the slab, in the three
    cases of ``caar_cases``, each field within 5e-5 scaled of
    ``caar_t4_plain`` and the slab bit for bit s1 at the fix lanes; the ring
    kernel bit for bit the two launches it fuses (this kernel, the
    merge-free sweep)."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import (caar_plan,
                                                         caar_t4_cuda,
                                                         caar_t4_plain)
    from tinman_sandbox_tpu_torch.kernels.dss import (dss_sweep_nomerge_cuda,
                                                      fix_tables)
    from tinman_sandbox_tpu_torch.kernels.ring_fused import \
        caar_ring_packed_t4

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(NE, nlev, dev)
    fix = fix_tables(plan, dev)
    lanes = fix.read_lanes.long()
    p = caar_plan(fix.e16, nlev)
    print(f"phase 3 caar ne{NE}x{nlev} plan: " + caar_plan_line(p, dev))
    const = (scal, meta, s0, sm1, qdp, pecnd, dvv)
    for (case, args), single in itertools.product(caar_cases(const, acc),
                                                  (False, True)):
        tag = f"ne{NE}x{nlev} {case} {'stage' if single else 'pair'}"
        sc, mt, s, sm, q, pec = args[:6]
        sm = None if single else sm
        want = caar_t4_plain(sc, mt, s, sm, q, pec, *args[6:9], args[9],
                             fix=fix, single=single)
        kacc = [x.clone() for x in args[6:9]]
        got = caar_t4_cuda(sc, mt, s, sm, q, pec, *kacc, args[9], fix=fix,
                           single=single)
        racc = [x.clone() for x in args[6:9]]
        ring = caar_ring_packed_t4(sc, mt, s, sm, q, pec, *racc, args[9], rsp,
                                   fix, single=single)
        tw = dss_sweep_nomerge_cuda(got[0], rsp, fix)
        torch.cuda.synchronize()
        for g in got:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"caar {tag}: non-finite")
        errs = caar_field_errs(got[:5], want[:5], nlev)
        slab_ok = torch.equal(got[5], got[0][:, lanes].T)
        same = torch.equal(ring[0], tw) and torch.equal(ring[1], got[1]) \
            and torch.equal(ring[5], got[5]) and \
            all(torch.equal(a, b) for a, b in zip(racc, kacc))
        print(f"phase 3 caar {tag}: scaled errors "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; slab bitwise {slab_ok}; ring bit for bit the two "
              f"launches: {same}")
        if max(errs.values()) > CAAR_TOL or not slab_ok or not same:
            raise AssertionError(f"caar {tag}: {errs} > {CAAR_TOL}, or the "
                                 "slab or the ring's bits differ")
        del want, got, ring, tw


def phase_dss(dev, cs):
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.dist import (
        continuity_error_t, make_structured_plan, rsp_lanes_2f)
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_cuda, dss_extract_plain, dss_fixup_cuda, dss_fixup_plain,
        dss_structured_t_cuda, dss_sweep_cuda, dss_sweep_plain, fix_tables,
        sweep_plan)

    plan = make_structured_plan(cs.gdof, cs.ne)
    rsp = torch.from_numpy(rsp_lanes_2f(cs.geometry.spheremp, cs.gdof,
                                        cs.ndof)).to(dev)
    k, e16 = 4 * NLEV, cs.nelem * 16
    t = fix_tables(plan, dev)
    n, nr = t.nfix, rsp.shape[0]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((k, e16)).astype(
        np.float32)).to(dev)
    slab_p = dss_extract_plain(x, t)
    vd_p = dss_fixup_plain(slab_p, t, rsp)
    out_p = dss_sweep_plain(x, rsp, vd_p, t)
    got = {"dss_extract_cuda": (dss_extract_cuda(x, t), slab_p),
           "dss_fixup_cuda": (dss_fixup_cuda(slab_p, t, rsp), vd_p),
           "dss_sweep_cuda": (dss_sweep_cuda(x, rsp, vd_p, t), out_p)}
    full = dss_structured_t_cuda(x, plan, rsp)
    torch.cuda.synchronize()
    abs_errs = {name: float((a - b).abs().max())
                for name, (a, b) in got.items()}
    for name, (a, b) in got.items():
        if not torch.equal(a, b):
            raise AssertionError(f"{name} differs from its plain version: "
                                 f"{abs_errs[name]}")
    if not torch.equal(full, out_p):
        raise AssertionError("dss: extract + fixup + sweep differ from plain")
    cont = continuity_error_t(full, cs.gdof)
    if cont != 0.0:
        raise AssertionError(f"dss: continuity error {cont}")
    dof = torch.from_numpy(cs.gdof.reshape(1, -1).astype(np.float32)).to(dev)
    rows = torch.arange(1, k + 1, device=dev, dtype=torch.float32)[:, None]
    smooth = torch.sin(1e-3 * dof * (1.0 + rows / k))
    sph = cs.geometry.spheremp.reshape(1, -1)
    proj = dss_structured_t_cuda((sph * smooth).contiguous(), plan, rsp)
    proj_err = float((proj - smooth).abs().max())
    if not proj_err <= PROJECTION_TOL:
        raise AssertionError(f"dss: projection identity {proj_err} > "
                             f"{PROJECTION_TOL}")

    lanes = t.read_lanes.long()
    times = {
        "dss_extract_cuda": (cuda_ms(lambda: dss_extract_cuda(x, t), 50),
                             cuda_ms(lambda: dss_extract_plain(x, t), 20),
                             cuda_ms(lambda: x[:, lanes].T.contiguous(), 50)),
        "dss_fixup_cuda": (cuda_ms(lambda: dss_fixup_cuda(slab_p, t, rsp), 50),
                           cuda_ms(lambda: dss_fixup_plain(slab_p, t, rsp), 20),
                           None),
        "dss_sweep_cuda": (cuda_ms(lambda: dss_sweep_cuda(x, rsp, vd_p, t), 50),
                           cuda_ms(lambda: dss_sweep_plain(x, rsp, vd_p, t), 20),
                           None),
    }
    # the extraction, the fixup (and the gather) and the sweep replayed
    # from CUDA graphs: the device's time without the host's
    graphs = {
        "dss_extract_cuda": (graph_ms(lambda: dss_extract_cuda(x, t), 50),
                             graph_ms(lambda: x[:, lanes].T.contiguous(), 50)),
        "dss_fixup_cuda": (graph_ms(lambda: dss_fixup_cuda(slab_p, t, rsp),
                                    50), None),
        "dss_sweep_cuda": (graph_ms(lambda: dss_sweep_cuda(x, rsp, vd_p, t),
                                    50), None),
    }
    # bytes each function must move (the gathered elements, the slab, the
    # tables and rspheremp rows it reads, its output) and its f32 operations
    bounds = {
        "dss_extract_cuda": bound_ms(2 * n * k * 4 + n * 4, 0),
        "dss_fixup_cuda": bound_ms(2 * n * k * 4 + n * 20 + nr * n * 4,
                                   6 * n * k),
        "dss_sweep_cuda": bound_ms(2 * k * e16 * 4 + nr * e16 * 4
                                   + k * n * 4 + e16 * 4, 6 * k * e16),
    }
    src = "tinman_sandbox_tpu_torch/csrc/dss.cu"
    replaces = {
        "dss_extract_cuda": "tinman_sandbox_tpu/kernels/dss_pallas.py:721",
        "dss_fixup_cuda": "tinman_sandbox_tpu/kernels/dss_pallas.py:1306",
        "dss_sweep_cuda": "tinman_sandbox_tpu/kernels/dss_pallas.py:617",
    }
    # the extract gathers scattered lanes: every 32-byte sector they fall
    # in is read whole
    floors = {"dss_extract_cuda": extract_floor_ms(t.read_lanes, k, e16)}
    out = {}
    for name, (k_ms, p_ms, l_ms) in times.items():
        out[name] = dict(route="cuda", source=src, replaces=replaces[name],
                         max_abs_err=abs_errs[name], ms=k_ms, plain_ms=p_ms,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1],
                         library_ms=l_ms)
        if name in floors:
            out[name]["sector_floor_ms"] = floors[name]
        g_ms, gl_ms = graphs.get(name, (None, None))
        graph = ""
        if g_ms is not None:
            out[name].update(graph_ms=g_ms, library_graph_ms=gl_ms)
            graph = (f"; from a graph kernel {g_ms:.4f} ms" + (
                "" if gl_ms is None else f", library {gl_ms:.4f} ms"))
        print(f"phase 4 {name} ne{cs.ne} [{k}, {e16}] (nfix {n}): bitwise "
              f"equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"{'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})"
              + (f", sector floor {floors[name]:.4f} ms" if name in floors
                 else "") + graph)
    print(f"phase 4 dss ne{cs.ne}: continuity error {cont:.1e}, projection "
          f"identity {proj_err:.2e} (limit {PROJECTION_TOL})")
    print(f"phase 4 dss_sweep plan [{k}, {e16}]: " + sweep_plan_line(
        sweep_plan(k, e16), dev))
    sweep_edges(dev, x, rsp, t)
    return out


def sweep_plan_line(plan, dev) -> str:
    """The sweep kernel's plan: threads, grid (one row a thread), the
    blocks an SM it reckons with and cudaOccupancy's (merged, without mix),
    waves."""
    import torch

    from tinman_sandbox_tpu_torch.kernels import _build

    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = _build.library("dss").dss_sweep_blocks_per_sm(1, 0, dev.index)
    if occ <= 0:
        raise AssertionError(f"sweep occupancy: error {-occ}")
    return (f"{plan.threads} groups of 4 lanes a block, one row a thread, "
            f"grid {plan.grid}, {plan.blocks} blocks, "
            f"{plan.blocks_per_sm} a SM reckoned, {occ} by cudaOccupancy x "
            f"{nsm} SMs = {plan.blocks / (occ * nsm):.3f} waves")


def sweep_edges(dev, x, rsp, tables):
    """The sweep where its groups and rows are ragged or its partners near:
    every form bit for bit its plain version at 75 rows of ne30 and at 1, 5
    and 7 rows of ne3 (beta partners one element row away), with both
    rspheremp forms; a misaligned field raises."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.dist import (build_cubed_sphere,
                                               make_structured_plan)
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_sweep_cuda, dss_sweep_nomerge_cuda, dss_sweep_nomerge_plain,
        dss_sweep_plain, fix_tables)

    ca, cb = float(np.float32(1.0 / 3.0)), float(np.float32(2.0 / 3.0))
    cs3 = build_cubed_sphere(3, dtype=torch.float32, device=dev)
    t3 = fix_tables(make_structured_plan(cs3.gdof, cs3.ne), dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    cases = [(x[:75].contiguous(), rsp, tables)]
    for rows in (1, 5, 7):
        x3 = torch.randn(rows, t3.e16, generator=gen, device=dev)
        r3 = torch.rand(2, t3.e16, generator=gen, device=dev)
        cases += [(x3, r3, t3), (x3, r3[:1].contiguous(), t3)]
    for xx, rr, tt in cases:
        vd = torch.randn(xx.shape[0], tt.nfix, generator=gen, device=dev)
        mx = torch.randn(xx.shape[0] + 2, tt.e16, generator=gen, device=dev)
        pairs = [
            (dss_sweep_cuda(xx, rr, vd, tt), dss_sweep_plain(xx, rr, vd, tt)),
            (dss_sweep_cuda(xx, rr, vd, tt, (mx[:-2], ca, cb)),
             dss_sweep_plain(xx, rr, vd, tt, (mx[:-2], ca, cb))),
            (dss_sweep_nomerge_cuda(xx, rr, tt),
             dss_sweep_nomerge_plain(xx, rr, tt)),
            (dss_sweep_nomerge_cuda(xx, rr, tt, (mx[:-2], ca, cb)),
             dss_sweep_nomerge_plain(xx, rr, tt, (mx[:-2], ca, cb)))]
        want = dss_sweep_plain(xx, rr, vd, tt, (mx, ca, cb))
        pairs.append((dss_sweep_cuda(xx, rr, vd, tt, (mx, ca, cb)), want))
        torch.cuda.synchronize()
        for i, (got, ref) in enumerate(pairs):
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"dss_sweep form {i} at {tuple(xx.shape)}, nrsp "
                    f"{rr.shape[0]}: {float((got - ref).abs().max())}")
    flat = torch.zeros(4 * tables.e16 + 1, device=dev)
    try:
        dss_sweep_nomerge_cuda(flat[1:].view(4, tables.e16), rsp, tables)
    except ValueError:
        pass
    else:
        raise AssertionError("dss_sweep took a misaligned field")
    print(f"phase 4 dss_sweep edges: {len(cases)} fields (75 rows of ne30; "
          "1, 5, 7 rows of ne3, both rspheremp forms), every form bitwise "
          "equal; a misaligned field raised")


def phase_caar_slab(dev, cs):
    """CAAR with the fix-lane slab on the ne30 geometry: returns the slab
    mode's numbers as extra keys of the CAAR row."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda, caar_t4_plain
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, _ = \
        bench.make_assembled_problem(cs.ne, NLEV, dev)
    const = (scal, meta, s0, sm1, qdp, pecnd, dvv)
    fix = fix_tables(plan, dev)
    lanes = fix.read_lanes.long()
    max_abs = 0.0
    for case, args in caar_cases(const, acc):
        want = caar_t4_plain(*args, fix=fix)
        kacc = [x.clone() for x in args[6:9]]
        got = caar_t4_cuda(*args[:6], *kacc, args[9], fix=fix)
        torch.cuda.synchronize()
        for g in got:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"caar slab {case}: non-finite")
        errs = caar_field_errs(got[:5], want[:5], NLEV)
        print(f"phase 5 caar+slab ne{cs.ne}x{NLEV} {case}: scaled errors "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if max(errs.values()) > CAAR_TOL:
            raise AssertionError(f"caar slab {case}: {errs} > {CAAR_TOL}")
        if not torch.equal(got[5], got[0][:, lanes].T):
            raise AssertionError(f"caar slab {case}: slab is not s1 at the "
                                 "fix lanes")
        max_abs = max(max_abs, *(float((g - w).abs().max())
                                 for g, w in zip(got, want)))
    kacc = [x.clone() for x in acc]
    k_ms = cuda_ms(lambda: caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd,
                                        *kacc, dvv, fix=fix), 20)
    p_ms = cuda_ms(lambda: caar_t4_plain(scal, meta, s0, sm1, qdp, pecnd,
                                         *acc, dvv, fix=fix), 5)
    e16, n = cs.nelem * 16, fix.nfix
    nbytes = (21 * NLEV + 13) * e16 * 4 + 16 * 4 + 3 * 4 + e16 * 4 \
        + n * 4 * NLEV * 4
    bnd, by = bound_ms(nbytes, CAAR_OPS_PER_POINT * e16 * NLEV)
    print(f"phase 5 caar+slab ne{cs.ne}x{NLEV}: slab bitwise s1 at the "
          f"{n} fix lanes; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}, {nbytes} B)")
    return dict(slab_max_abs_err=max_abs, slab_ms=k_ms, slab_plain_ms=p_ms,
                slab_bound_ms=bnd, slab_shape=f"ne{cs.ne}x{NLEV}")


def phase_golden(dev):
    import numpy as np
    import torch

    import tinman_sandbox_tpu_torch as tt
    from tinman_sandbox_tpu_torch.golden import golden_caar
    from tinman_sandbox_tpu_torch.kernels import caar_t

    cfg = tt.Config(nelem=3, nlev=72)
    kw = dict(dtype=torch.float32, device=dev)
    s, _ = caar_t(tt.analytic_state(cfg, **kw), tt.analytic_derived(cfg, **kw),
                  tt.analytic_geometry(cfg, **kw), tt.analytic_hvcoord(cfg, **kw),
                  cfg, 1.0, 1.0, device=dev)
    gold = golden_caar()
    line = []
    for field, key in (("t", "T"), ("u", "v1"), ("v", "v2")):
        got = getattr(s, field)[cfg.np1, 0].double().cpu().numpy()
        diff = float(np.max(np.abs(got - gold[key])))
        lim = CAAR_TOL * float(np.max(np.abs(gold[key])))
        if not diff < lim:
            raise AssertionError(f"golden {key}: {diff:.3e} >= {lim:.3e}")
        line.append(f"{key} {diff:.3e} (limit {lim:.3e})")
    print("phase 6 golden (f32 kernel vs f64 gold): " + ", ".join(line))


def phase_main_path(dev):
    import torch

    import tinman_sandbox_tpu_torch as tt
    from tinman_sandbox_tpu_torch import bench, cli
    from tinman_sandbox_tpu_torch.golden import golden_caar
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        _leapfrog_loop, caar_t4_plain, run_leapfrog_t)

    # CLI at 1024 elements, golden-checked (element 1 is the golden element
    # at any element count)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--num-elems", "1024", "--num-exec", "100",
                       "--golden-check"])
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"cli exited {rc}:\n{out}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    gold = [ln for ln in out.splitlines() if "golden diffs" in ln]
    print("phase 7 cli 1024x72 x100:" + speed[0].split(":", 1)[1])
    print("phase 7 cli" + gold[0].split("---", 1)[1])
    diffs = gold[0].split("golden diffs: T")[1].split()
    ref = golden_caar()
    for key, diff in (("T", diffs[0]), ("v1", diffs[2]), ("v2", diffs[4])):
        lim = CAAR_TOL * float(abs(ref[key]).max())
        if not float(diff) < lim:
            raise AssertionError(f"cli golden {key}: {diff} >= {lim:.3e}")

    # packed leapfrog loop at 5,400 x 72 (random init is not a balanced
    # atmosphere: dt = 0.05 keeps 10 steps finite, as in the unit tests)
    cfg = tt.Config(nelem=5400, nlev=72, dt=0.05)
    kw = dict(dtype=torch.float32, device=dev)
    prob = (tt.random_state(cfg, seed=7, **kw), tt.zero_derived(cfg, **kw),
            tt.random_geometry(cfg, seed=8, **kw), tt.analytic_hvcoord(cfg, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ks, kd, kc = run_leapfrog_t(*prob, cfg, 10, device=dev)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    ps, pd, pc = _leapfrog_loop(caar_t4_plain, *prob, cfg, 10, True, dev)
    errs = {}
    for name in ("u", "v", "t", "dp3d"):
        a, b = getattr(ks, name), getattr(ps, name)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"leapfrog: non-finite {name}")
        errs[name] = scaled_err(a, b)
    for name in ("vn0_u", "vn0_v", "omega_p", "phi"):
        errs[name] = scaled_err(getattr(kd, name), getattr(pd, name))
    if max(errs.values()) > LEAPFROG_TOL or kc != pc:
        raise AssertionError(f"leapfrog: {errs} > {LEAPFROG_TOL}")
    print(f"phase 7 leapfrog 5400x72 x10 (kernel {k_s:.3f} s incl. pack): "
          "scaled errors vs plain " + " ".join(f"{k} {v:.2e}"
                                               for k, v in errs.items()))

    # raw-kernel bench at 1024 x 72
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.main(["--nelem", "1024", "--nlev", "72", "--nexec", "500",
                          "--reps", "3"])
    print("phase 7 bench " + buf.getvalue().strip())
    return res


def phase_assembled_path(dev, cs):
    import torch

    from tinman_sandbox_tpu_torch import bench, cli
    from tinman_sandbox_tpu_torch.dist import (
        caar_dss_structured_packed_t4_plain, continuity_error_t)

    # 10 chained assembled steps at ne30 x 72, kernels against plain
    const, levels, acc, plan, rsp = bench.make_assembled_problem(
        cs.ne, NLEV, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (k0, km1), kacc, kphi = bench.run_assembled(
        const, levels, [a.clone() for a in acc], plan, rsp, 10)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    (p0, pm1), pacc, pphi = bench.run_assembled(
        const, levels, acc, plan, rsp, 10,
        step=caar_dss_structured_packed_t4_plain)
    errs = {}
    for lev, (a, b) in (("n0", (k0, p0)), ("nm1", (km1, pm1))):
        for name, fa, fb in zip(("u", "v", "t", "dp"), a.split(NLEV),
                                b.split(NLEV)):
            errs[f"{lev}.{name}"] = scaled_err(fa, fb)
    for name, a, b in zip(("phi", "vn0u", "vn0v", "omg"), (kphi, *kacc),
                          (pphi, *pacc)):
        errs[name] = scaled_err(a, b)
    for x in (k0, km1, kphi, *kacc):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("assembled chain: non-finite output")
    cont = continuity_error_t(k0, cs.gdof)
    if max(errs.values()) > LEAPFROG_TOL or cont != 0.0:
        raise AssertionError(f"assembled chain: {errs} > {LEAPFROG_TOL} or "
                             f"continuity {cont}")
    print(f"phase 8 assembled chain ne{cs.ne}x{NLEV} x10 (kernels "
          f"{k_s:.3f} s): continuity {cont:.1e}; scaled errors vs plain "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    # the CLI's assembled leapfrog run, from the random init (the analytic
    # init depends on the element index, so at ne30 its dp jumps by ~ne^2
    # across a cube edge, and 20 steps at dt2 = 1 drive the top levels' dp
    # negative there)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ne", str(cs.ne), "--dss", "--leapfrog",
                       "--num-exec", "20", "--init", "random",
                       "--dt", "0.05"])
    out = buf.getvalue()
    if rc != 0 or "WARNING" in out:
        raise AssertionError(f"cli --ne {cs.ne} --dss exited {rc}:\n{out}")
    spread = [ln for ln in out.splitlines() if "continuity:" in ln]
    if float(spread[0].split()[-1]) != 0.0:
        raise AssertionError(f"cli --dss: {spread[0]}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    print(f"phase 8 cli --ne {cs.ne} --dss --leapfrog --init random x20:"
          + speed[0].split(":", 1)[1] + ";" + spread[0].split("---", 1)[1])

    # the assembled bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.main(["--ne", str(cs.ne), "--nlev", str(NLEV),
                          "--nexec", "1000", "--reps", "3"])
    print("phase 8 bench " + buf.getvalue().strip())
    return res


def phase_dynamics_kernels(dev, cs):
    """The three pieces of kernel work of the dynamics step at ne30 x 72.
    Returns {name: extra keys or row}: the stage-mode numbers for the CAAR
    row, the mix numbers for the sweep row, and the vlap row."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda, caar_t4_plain
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_plain, dss_fixup_cuda, dss_fixup_plain, dss_sweep_cuda,
        dss_sweep_plain,
        fix_tables)
    from tinman_sandbox_tpu_torch.kernels.hypervis_t import vlap_cuda, vlap_plain

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(cs.ne, NLEV, dev)
    const = (scal, meta, s0, sm1, qdp, pecnd, dvv)
    fix = fix_tables(plan, dev)
    lanes = fix.read_lanes.long()
    e16, n, k = cs.nelem * 16, fix.nfix, NLEV
    out = {}

    # -- CAAR, stage mode: base state = evaluation state, never fetched
    # twice. s1 = spheremp*(s0 + dt2*tendency): at the bench's dt2 = 0.1 the
    # base state carries s1, which holds the dropped fetch; at dt2 = 1e6 the
    # tendency does (the formula is linear in dt2), which holds every term
    # of it in this mode as the cases of phase 3 do in the pair mode
    worst = 0.0
    for dt2, (case, args) in itertools.product(
            (float(scal[0, 0]), 1e6), caar_cases(const, acc)):
        if case == "tend":          # differs from bench only in the unread sm1
            continue
        case = f"{case} dt2={dt2:g}"
        sc, mt, s, _, q, pec = args[:6]
        sc = sc.clone()
        sc[0, 0] = dt2
        want = caar_t4_plain(sc, mt, s, s, q, pec, *args[6:9], args[9],
                             fix=fix)
        for emit_phi in (True, False):
            kacc = [x.clone() for x in args[6:9]]
            got = caar_t4_cuda(sc, mt, s, None, q, pec, *kacc, args[9],
                               fix=fix, single=True, emit_phi=emit_phi)
            torch.cuda.synchronize()
            if (got[1] is None) == emit_phi:
                raise AssertionError(f"caar single {case}: phi output wrong")
            if not emit_phi:        # hold the other seven fields all the same
                got = (got[0], want[1], *got[2:])
            for g in got:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"caar single {case}: non-finite")
            errs = caar_field_errs(got[:5], want[:5], k)
            print(f"phase 9 caar single ne{cs.ne}x{k} {case} "
                  f"phi={'yes' if emit_phi else 'no'}: scaled errors "
                  + " ".join(f"{a} {b:.2e}" for a, b in errs.items()))
            if max(errs.values()) > CAAR_TOL:
                raise AssertionError(f"caar single {case}: {errs} > {CAAR_TOL}")
            if not torch.equal(got[5], got[0][:, lanes].T):
                raise AssertionError(f"caar single {case}: slab is not s1 at "
                                     "the fix lanes")
            worst = max(worst, *errs.values())
    kacc = [x.clone() for x in acc]
    times, graphs = {}, {}
    for emit_phi in (True, False):
        run = lambda: caar_t4_cuda(scal, meta, s0, None, qdp, pecnd, *kacc,
                                   dvv, fix=fix, single=True,
                                   emit_phi=emit_phi)
        times[emit_phi], graphs[emit_phi] = cuda_ms(run, 20), graph_ms(run, 20)
    pair = lambda: caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *kacc, dvv,
                                fix=fix)
    pair_ms, pair_graph_ms = cuda_ms(pair, 20), graph_ms(pair, 20)
    p_ms = cuda_ms(lambda: caar_t4_plain(scal, meta, s0, None, qdp, pecnd,
                                         *acc, dvv, fix=fix, single=True), 5)
    # 17 fields (16 without phi), the 13 meta rows, dvv, 3 scalars, fix_rank
    # and the slab
    nb = lambda rows: (rows * k + 13) * e16 * 4 + 16 * 4 + 3 * 4 + e16 * 4 \
        + n * 4 * k * 4
    ops = CAAR_OPS_PER_POINT * e16 * k
    (b_phi, by), (b_nophi, _) = bound_ms(nb(17), ops), bound_ms(nb(16), ops)
    print(f"phase 9 caar single ne{cs.ne}x{k}: kernel {times[True]:.4f} ms "
          f"with phi (from a graph {graphs[True]:.4f}; bound {b_phi:.4f} ms), "
          f"{times[False]:.4f} ms without (graph {graphs[False]:.4f}; bound "
          f"{b_nophi:.4f} ms, {by}); the pair form with the slab in the same "
          f"run {pair_ms:.4f} ms (graph {pair_graph_ms:.4f}); plain "
          f"{p_ms:.4f} ms")
    out["caar_t4_cuda"] = dict(
        single_max_scaled_err=worst, single_ms=times[True],
        single_graph_ms=graphs[True], single_nophi_ms=times[False],
        single_nophi_graph_ms=graphs[False], single_pair_ms=pair_ms,
        single_pair_graph_ms=pair_graph_ms, single_plain_ms=p_ms,
        single_bound_ms=b_phi, single_nophi_bound_ms=b_nophi)

    # -- sweep with mix: a new tensor, and in place into a taller buffer
    nr = rsp.shape[0]
    rng = np.random.default_rng(12)
    rnd = lambda rows: torch.from_numpy(rng.standard_normal(
        (rows, e16)).astype(np.float32)).to(dev)
    x4, mx4 = rnd(4 * k), rnd(4 * k)
    x3 = x4[:3 * k].contiguous()
    ca, cb = float(np.float32(1.0 / 3.0)), float(np.float32(2.0 / 3.0))
    vd4 = dss_fixup_plain(dss_extract_plain(x4, fix), fix, rsp)
    vd3 = dss_fixup_plain(dss_extract_plain(x3, fix), fix, rsp)
    # the fixup at the hyperviscosity's [3k] and the state's [4k] rows
    fixup_graph = {}
    for x, vd_p in ((x3, vd3), (x4, vd4)):
        slab = dss_extract_plain(x, fix)
        got = dss_fixup_cuda(slab, fix, rsp)
        torch.cuda.synchronize()
        if not torch.equal(got, vd_p):
            raise AssertionError(f"dss_fixup at {x.shape[0]} rows differs "
                                 "from plain")
        fixup_graph[x.shape[0]] = graph_ms(
            lambda: dss_fixup_cuda(slab, fix, rsp), 50)
    print(f"phase 9 dss_fixup ne{cs.ne}: bitwise equal at {3 * k} and "
          f"{4 * k} rows; from a graph " + ", ".join(
              f"{r} rows {v:.4f} ms" for r, v in fixup_graph.items()))
    want = dss_sweep_plain(x4, rsp, vd4, fix, mix=(mx4, ca, cb))
    got = dss_sweep_cuda(x4, rsp, vd4, fix, mix=(mx4, ca, cb))
    torch.cuda.synchronize()
    mix_err = float((got - want).abs().max())
    if got is mx4 or not torch.equal(got, want):
        raise AssertionError("dss_sweep mix (new tensor) differs from plain: "
                             f"{mix_err}")
    # in place, as the hyperviscosity update x - step*lap: x is a [3k]
    # field, mx the [4k] state, ca = 1 and a negative cb
    cb3 = -1e-3
    buf = mx4.clone()
    want = dss_sweep_plain(x3, rsp, vd3, fix, mix=(mx4, 1.0, cb3))
    got = dss_sweep_cuda(x3, rsp, vd3, fix, mix=(buf, 1.0, cb3))
    torch.cuda.synchronize()
    mix_err = max(mix_err, float((got - want).abs().max()))
    if got is not buf or not torch.equal(got, want):
        raise AssertionError("dss_sweep mix (in place) differs from plain: "
                             f"{mix_err}")
    if not torch.equal(buf[3 * k:], mx4[3 * k:]):
        raise AssertionError("dss_sweep mix (in place) touched the dp rows")
    if torch.equal(buf[:3 * k], mx4[:3 * k]):
        raise AssertionError("dss_sweep mix (in place) changed nothing")
    new_run = lambda: dss_sweep_cuda(x4, rsp, vd4, fix, mix=(mx4, ca, cb))
    inp_run = lambda: dss_sweep_cuda(x3, rsp, vd3, fix, mix=(buf, 1.0, cb3))
    new_ms, new_graph_ms = cuda_ms(new_run, 50), graph_ms(new_run, 50)
    inp_ms, inp_graph_ms = cuda_ms(inp_run, 50), graph_ms(inp_run, 50)
    pn_ms = cuda_ms(lambda: dss_sweep_plain(x4, rsp, vd4, fix,
                                            mix=(mx4, ca, cb)), 10)
    # the hyperviscosity's first sweep: [3k] rows, no mix
    s3_ms = cuda_ms(lambda: dss_sweep_cuda(x3, rsp, vd3, fix), 50)
    # x and mx read, the output written, rsp rows, vd, fix_col
    sweep_bytes = lambda rows: 3 * rows * e16 * 4 + nr * e16 * 4 \
        + rows * n * 4 + e16 * 4
    b_new, by = bound_ms(sweep_bytes(4 * k), 9 * 4 * k * e16)
    b_inp, _ = bound_ms(sweep_bytes(3 * k), 9 * 3 * k * e16)
    b_s3, _ = bound_ms(sweep_bytes(3 * k) - 3 * k * e16 * 4, 6 * 3 * k * e16)
    print(f"phase 9 dss_sweep mix ne{cs.ne}: bitwise equal; [{4 * k}] rows "
          f"into a new tensor {new_ms:.4f} ms (graph {new_graph_ms:.4f}; bound"
          f" {b_new:.4f} ms, {by}), [{3 * k}] rows in place into [{4 * k}] "
          f"{inp_ms:.4f} ms (graph {inp_graph_ms:.4f}; bound {b_inp:.4f} ms),"
          f" [{3 * k}] rows without mix {s3_ms:.4f} ms (bound {b_s3:.4f} ms);"
          f" plain {pn_ms:.4f} ms")
    out["dss_fixup_cuda"] = {f"rows{r}_graph_ms": v
                             for r, v in fixup_graph.items()}
    out["dss_sweep_cuda"] = dict(
        mix_max_abs_err=mix_err, mix_ms=new_ms, mix_graph_ms=new_graph_ms,
        mix_bound_ms=b_new, mix_plain_ms=pn_ms, mix_inplace_ms=inp_ms,
        mix_inplace_graph_ms=inp_graph_ms, mix_inplace_bound_ms=b_inp,
        rows3k_ms=s3_ms, rows3k_bound_ms=b_s3)

    # -- weak Laplacians, on the taller [4k] state (no slice copy)
    max_abs = 0.0
    for nu_ratio, x in ((1.0, s0), (2.5, x4)):
        want, wslab = vlap_plain(meta, x, dvv, k, nu_ratio, fix=fix)
        got, slab = vlap_cuda(meta, x, dvv, k, nu_ratio, fix=fix)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("vlap: non-finite")
        errs = {name: scaled_err(a, b) for name, a, b in zip(
            ("lap_u", "lap_v", "lap_t"), got.split(k), want.split(k))}
        print(f"phase 9 vlap ne{cs.ne}x{k} nu_ratio {nu_ratio}: scaled errors "
              + " ".join(f"{a} {b:.2e}" for a, b in errs.items()))
        if max(errs.values()) > CAAR_TOL:
            raise AssertionError(f"vlap: {errs} > {CAAR_TOL}")
        if not torch.equal(slab, got[:, lanes].T):
            raise AssertionError("vlap: slab is not the output at the fix "
                                 "lanes")
        if not torch.equal(got, vlap_cuda(meta, x, dvv, k, nu_ratio)):
            raise AssertionError("vlap: the slab changes the output")
        max_abs = max(max_abs, float((got - want).abs().max()))
    k_ms = cuda_ms(lambda: vlap_cuda(meta, s0, dvv, k, 1.0, fix=fix), 50)
    p_ms = cuda_ms(lambda: vlap_plain(meta, s0, dvv, k, 1.0, fix=fix), 5)
    # 3 row blocks read, 3 written, 12 meta rows, dvv, fix_rank, the slab
    nbytes = (6 * k + 12) * e16 * 4 + 16 * 4 + e16 * 4 + n * 3 * k * 4
    bnd, by = bound_ms(nbytes, VLAP_OPS_PER_POINT * e16 * k)
    print(f"phase 9 vlap ne{cs.ne}x{k}: slab bitwise the output at the {n} "
          f"fix lanes; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}, {nbytes} B)")
    out["vlap_cuda"] = dict(
        route="cuda", source="tinman_sandbox_tpu_torch/csrc/hypervis.cu",
        replaces="tinman_sandbox_tpu/kernels/hypervis_pallas_t.py:144",
        max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
        bound_by=by, library_ms=None)
    return out


def phase_dynamics_path(dev, cs):
    import torch

    from tinman_sandbox_tpu_torch import bench, cli
    from tinman_sandbox_tpu_torch.dist import (
        apply_hypervis_packed_t, apply_hypervis_packed_t_plain,
        continuity_error_t, ssprk3_packed_t4, ssprk3_packed_t4_plain)

    # 10 chained SSPRK3 + hyperviscosity steps at ne30 x 72 from a continuous
    # random state, kernels against plain, continuity after every step
    const, s0, acc, plan, rsp = bench.make_dynamics_problem(
        cs.ne, NLEV, dev, DYN_DT)
    scal, meta, qdp, pecnd, dvv = const
    if continuity_error_t(s0, cs.gdof) != 0.0:
        raise AssertionError("dynamics: the projected start is not continuous")
    ks, kacc = s0, [a.clone() for a in acc]
    ps, pacc = s0, list(acc)
    k_s = 0.0
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks, kphi, *kacc = ssprk3_packed_t4(scal, meta, ks, qdp, pecnd, *kacc,
                                           dvv, plan, rsp)
        ks = apply_hypervis_packed_t(dvv, meta, ks, plan, rsp, DYN_NU,
                                     DYN_DT, NLEV)
        torch.cuda.synchronize()
        k_s += time.perf_counter() - t0
        cont = continuity_error_t(ks, cs.gdof)
        if cont != 0.0:
            raise AssertionError(f"dynamics chain: continuity {cont} after "
                                 f"step {i + 1}")
        ps, pphi, *pacc = ssprk3_packed_t4_plain(scal, meta, ps, qdp, pecnd,
                                                 *pacc, dvv, plan, rsp)
        ps = apply_hypervis_packed_t_plain(dvv, meta, ps, plan, rsp, DYN_NU,
                                           DYN_DT, NLEV)
    errs = {name: scaled_err(a, b) for name, a, b in zip(
        ("u", "v", "t", "dp"), ks.split(NLEV), ps.split(NLEV))}
    for name, a, b in zip(("phi", "vn0u", "vn0v", "omg"), (kphi, *kacc),
                          (pphi, *pacc)):
        errs[name] = scaled_err(a, b)
    for x in (ks, kphi, *kacc):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("dynamics chain: non-finite output")
    dp_min = float(ks[3 * NLEV:].min())
    if max(errs.values()) > DYN_TOL or not dp_min > 0.0:
        raise AssertionError(f"dynamics chain: {errs} > {DYN_TOL} or "
                             f"min dp {dp_min}")
    moved = scaled_err(ks[:3 * NLEV], s0[:3 * NLEV])
    print(f"phase 10 dynamics chain ne{cs.ne}x{NLEV} x10 (kernels {k_s:.3f} "
          f"s): continuity 0 after every step; min dp {dp_min:.3f}; state "
          f"moved {moved:.2e}; scaled errors vs plain "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ne", str(cs.ne), "--rk", "--hypervis-nu",
                       str(DYN_NU), "--leapfrog", "--num-exec", "10",
                       "--init", "random", "--dt", str(DYN_DT)])
    out = buf.getvalue()
    if rc != 0 or "WARNING" in out:
        raise AssertionError(f"cli --ne {cs.ne} --rk exited {rc}:\n{out}")
    spread = [ln for ln in out.splitlines() if "continuity:" in ln]
    if float(spread[0].split()[-1]) != 0.0:
        raise AssertionError(f"cli --rk: {spread[0]}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    print(f"phase 10 cli --ne {cs.ne} --rk --hypervis-nu {DYN_NU:g} "
          f"--leapfrog --init random --dt {DYN_DT} x10:"
          + speed[0].split(":", 1)[1] + ";" + spread[0].split("---", 1)[1])

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.main(["--ne", str(cs.ne), "--nlev", str(NLEV), "--rk",
                          "--hypervis-nu", str(DYN_NU), "--dt", str(DYN_DT),
                          "--nexec", "300", "--reps", "3"])
    print("phase 10 bench " + buf.getvalue().strip())
    if not res["min_dp3d"] > 0.0:
        raise AssertionError(f"bench --rk: min dp3d {res['min_dp3d']}")
    return res


def limiter_properties(out, y_in, q, w):
    """What the limited stage must keep, in f64 on the card: the largest
    change of an element's mass sum(w*y) relative to its sum|w*y|, and the
    largest excursion outside the bounds (the extrema of q over the
    element) among the elements whose bounds can hold their mass. Returns
    (conservation error, bounds violation, number of feasible elements)."""
    grp = lambda x: x.reshape(x.shape[0], -1, 16)
    wd = w.double()
    y = out.double() / wd
    m_in = grp(wd * y_in.double()).sum(2)
    cons = float(((grp(wd * y).sum(2) - m_in).abs()
                  / grp((wd * y_in.double()).abs()).sum(2)).max())
    qmin, qmax = grp(q).amin(2).double(), grp(q).amax(2).double()
    wsum = grp(wd[None]).sum(2)
    feasible = (m_in >= wsum * qmin) & (m_in <= wsum * qmax)
    viol = ((grp(y) - qmax[..., None]).clamp(min=0)
            + (qmin[..., None] - grp(y)).clamp(min=0)).amax(2)
    nfeas = int(feasible.sum())
    return cons, float(viol[feasible].max()) if nfeas else 0.0, nfeas


def phase_tracer_kernels(dev, cs):
    """The two tracer kernels at ne30 x 72, qsize 1 and QSIZE_TALL. Returns
    their two rows."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_fixup_cuda, dss_fixup_plain, dss_sweep_cuda, fix_tables)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (
        TRACER_LEVELS, TRACER_TILE, TRACER_WARPS, tracer_euler_cuda,
        tracer_euler_plain, tracer_limit_cuda, tracer_limit_plain)

    (scal, meta, pecnd, dvv), s0, _, _, plan, rsp = bench.make_prim_problem(
        cs.ne, NLEV, dev, DYN_DT, 1)
    fix = fix_tables(plan, dev)
    lanes = fix.read_lanes.long()
    e16, n, k = cs.nelem * 16, fix.nfix, NLEV
    w = meta[11]                                    # spheremp
    kw = dict(wind_rows=(0, 1), fix=fix)
    ca, cb = np.float32(1.0 / 3.0), np.float32(2.0 / 3.0)
    rows = {}

    # the design: 4 lanes a thread, a block's warps splitting its levels;
    # cudaOccupancy's blocks an SM and ptxas's registers of each instance
    tr_lib = _build.library("tracer")
    occ = {case: tr_lib.tracer_blocks_per_sm(kind, dev.index)
           for case, kind in (("euler", 0), ("limit_mix", 2), ("limit", 3))}
    regs = {{"ILb0ELb0EE": "euler", "ILb1ELb1EE": "limit_mix",
             "ILb1ELb0EE": "limit"}.get(inst, inst): rep
            for inst, rep in ptxas_report("tracer", "tracer_kernel")}
    nblocks = -(-e16 // TRACER_TILE) * -(-k // TRACER_LEVELS)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, bps in occ.items():
        warps = TRACER_WARPS["euler" if case == "euler" else "limit"]
        print(f"phase 11 tracer_kernel {case}: {warps} warps x {TRACER_TILE} "
              f"lanes x {TRACER_LEVELS} levels a block, {nblocks} blocks at "
              f"ne{cs.ne}x{k}; {bps} blocks per SM x {nsm} SMs = "
              f"{nblocks / max(bps * nsm, 1):.3f} waves; ptxas "
              f"{regs.get(case)}")
        if bps <= 0:
            raise AssertionError(f"occupancy of tracer_kernel {case}: error "
                                 f"{-bps}")

    def block_errs(got, want):
        return max(scaled_err(a, b) for a, b in zip(got.split(k),
                                                    want.split(k)))

    for qsize in (1, QSIZE_TALL):
        tag = f"ne{cs.ne}x{k} qsize {qsize}"
        q = bench.make_prim_problem(cs.ne, k, dev, DYN_DT, qsize)[2]
        gen = torch.Generator(device=dev).manual_seed(5)
        mx = torch.rand(q.shape, generator=gen, device=dev)
        # a step long enough for dt*div to be ~ half of q: at the run's dt
        # the divergence sits below f32 resolution of q
        div = (q - tracer_euler_plain(meta, s0, s0, q, dvv, 1.0, k,
                                      fold_sph=False, wind_rows=(0, 1)))
        dt_long = 0.5 * float(q.abs().max()) / float(div.abs().max())
        del div

        # -- tracer_euler
        worst_abs = worst = 0.0
        for dt, fold in ((DYN_DT, True), (dt_long, True), (dt_long, False)):
            want, _ = tracer_euler_plain(meta, s0, s0, q, dvv, dt, k,
                                         fold_sph=fold, **kw)
            got, slab = tracer_euler_cuda(meta, s0, s0, q, dvv, dt, k,
                                          fold_sph=fold, **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"tracer_euler {tag}: non-finite")
            err = block_errs(got, want)
            print(f"phase 11 tracer_euler {tag} dt {dt:.4g} fold_sph "
                  f"{fold}: worst scaled error of a tracer block {err:.2e}")
            if err > CAAR_TOL:
                raise AssertionError(f"tracer_euler {tag}: {err} > {CAAR_TOL}")
            if tuple(slab.shape) != (n, qsize * k) \
                    or not torch.equal(slab, got[:, lanes].T):
                raise AssertionError(f"tracer_euler {tag}: slab is not the "
                                     "output at the fix lanes")
            worst = max(worst, err)
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            del want, got, slab
        reps = 50 if qsize == 1 else 10
        k_ms = cuda_ms(lambda: tracer_euler_cuda(meta, s0, s0, q, dvv, DYN_DT,
                                                 k, **kw), reps)
        kg_ms = graph_ms(lambda: tracer_euler_cuda(meta, s0, s0, q, dvv,
                                                   DYN_DT, k, **kw), reps)
        p_ms = cuda_ms(lambda: tracer_euler_plain(meta, s0, s0, q, dvv,
                                                  DYN_DT, k, **kw), 3)
        # 2 wind blocks, q read, out written, 7 meta rows, dvv, fix_rank, slab
        nb = lambda blocks: (blocks * k + 7) * e16 * 4 + 16 * 4 + e16 * 4 \
            + n * qsize * k * 4
        bnd, by = bound_ms(nb(2 + 2 * qsize),
                           TRACER_OPS_PER_POINT * qsize * k * e16)
        print(f"phase 11 tracer_euler {tag}: slab bitwise the output at the "
              f"{n} fix lanes; kernel {k_ms:.4f} ms (from a graph "
              f"{kg_ms:.4f}), plain {p_ms:.4f} ms, library none, bound "
              f"{bnd:.4f} ms ({by}, {nb(2 + 2 * qsize)} B)")
        if qsize == 1:
            rows["tracer_euler_cuda"] = dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/tracer.cu",
                replaces="tinman_sandbox_tpu/kernels/tracer_pallas_t.py:404",
                max_abs_err=worst_abs, max_scaled_err=worst, ms=k_ms,
                plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None,
                graph_ms=kg_ms, blocks_per_sm=occ["euler"],
                ptxas=regs.get("euler"))
        else:
            rows["tracer_euler_cuda"].update(
                tall_qsize=qsize, tall_max_scaled_err=worst, tall_ms=k_ms,
                tall_graph_ms=kg_ms, tall_plain_ms=p_ms, tall_bound_ms=bnd)

        # -- what closes a tracer stage: the fixup (bit for bit plain) and
        # the sweep (held bit for bit in phases 4 and 9) on qsize*k rows,
        # timed at this height
        e, slab = tracer_euler_cuda(meta, s0, s0, q, dvv, DYN_DT, k, **kw)
        vd = dss_fixup_cuda(slab, fix, rsp)
        if not torch.equal(vd, dss_fixup_plain(slab, fix, rsp)):
            raise AssertionError(f"dss_fixup {tag} differs from plain")
        fx_ms = cuda_ms(lambda: dss_fixup_cuda(slab, fix, rsp), reps)
        fxg_ms = graph_ms(lambda: dss_fixup_cuda(slab, fix, rsp), reps)
        sw = lambda: dss_sweep_cuda(e, rsp, vd, fix)
        swm = lambda: dss_sweep_cuda(e, rsp, vd, fix, mix=(q, ca, cb))
        sw_ms, swg_ms = cuda_ms(sw, reps), graph_ms(sw, reps)
        swm_ms, swmg_ms = cuda_ms(swm, reps), graph_ms(swm, reps)
        nr, qk = rsp.shape[0], qsize * k
        sweep_bytes = lambda blocks: blocks * qk * e16 * 4 + nr * e16 * 4 \
            + qk * n * 4 + e16 * 4
        b_sw, _ = bound_ms(sweep_bytes(2), 6 * qk * e16)
        b_swm, _ = bound_ms(sweep_bytes(3), 9 * qk * e16)
        b_fx, _ = bound_ms(2 * n * qk * 4 + n * 20 + nr * n * 4, 6 * n * qk)
        print(f"phase 11 stage closure {tag} [{qk}, {e16}]: fixup "
              f"{fx_ms:.4f} ms (from a graph {fxg_ms:.4f}; bound "
              f"{b_fx:.4f} ms), sweep {sw_ms:.4f} ms (graph {swg_ms:.4f}; "
              f"bound {b_sw:.4f} ms), sweep with mix {swm_ms:.4f} ms (graph "
              f"{swmg_ms:.4f}; bound {b_swm:.4f} ms)")
        sfx = f"rows{qk}"
        rows.setdefault("dss_sweep_cuda", {}).update({
            f"{sfx}_ms": sw_ms, f"{sfx}_graph_ms": swg_ms,
            f"{sfx}_bound_ms": b_sw, f"{sfx}_mix_ms": swm_ms,
            f"{sfx}_mix_graph_ms": swmg_ms, f"{sfx}_mix_bound_ms": b_swm})
        rows.setdefault("dss_fixup_cuda", {}).update({
            f"{sfx}_ms": fx_ms, f"{sfx}_graph_ms": fxg_ms,
            f"{sfx}_bound_ms": b_fx})
        del e, slab, vd

        # -- tracer_limit: (case, q, mix, dt); y_in is the value handed to
        # the limiter, from the unlimited kernel
        rng = torch.Generator(device=dev).manual_seed(6)
        bump = (torch.rand(q.shape, generator=rng, device=dev) < 0.1).float() \
            * (torch.rand(q.shape, generator=rng, device=dev) < 0.5).float() \
            .mul_(2).sub_(1)
        # (case, q, mix, dt, clip-and-redistribute passes); with no pass
        # (the JAX kernel's iters=0) only the residual pass runs: the
        # bounds are not the gate's there, the error and the mass are
        cases = [("free", q, None, dt_long, 2),
                 ("mix", q, (mx, ca, cb), DYN_DT, 2),
                 ("mix long", q, (mx, ca, cb), dt_long, 2),
                 ("uniform", torch.full_like(q, 0.5), None, dt_long, 2),
                 ("pushed", q, (q + bump, 1.0, 0.0), 0.0, 2),
                 ("free iters=0", q, None, dt_long, 0),
                 ("mix long iters=0", q, (mx, ca, cb), dt_long, 0)]
        del bump
        worst_abs = worst = worst_cons = worst_viol = worst_i0 = 0.0
        for case, qc, mix, dt, iters in cases:
            want, _ = tracer_limit_plain(meta, s0, s0, qc, dvv, dt, k,
                                         mix=mix, iters=iters, **kw)
            got, slab = tracer_limit_cuda(meta, s0, s0, qc, dvv, dt, k,
                                          mix=mix, iters=iters, **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"tracer_limit {tag} {case}: non-finite")
            err = block_errs(got, want)
            if not torch.equal(slab, got[:, lanes].T):
                raise AssertionError(f"tracer_limit {tag} {case}: slab is "
                                     "not the output at the fix lanes")
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            del want, slab
            y_in = tracer_euler_cuda(meta, s0, s0, qc, dvv, dt, k,
                                     fold_sph=False, wind_rows=(0, 1))
            if mix is not None:
                y_in = float(mix[1]) * mix[0] + float(mix[2]) * y_in
            cons, viol, nfeas = limiter_properties(got, y_in, qc, w)
            clipped = float((got / w - y_in).abs().max())
            del got, y_in
            print(f"phase 11 tracer_limit {tag} {case} dt {dt:.4g} iters "
                  f"{iters}: worst "
                  f"scaled error of a tracer block {err:.2e}; mass of an "
                  f"element kept to {cons:.2e}; outside the bounds "
                  f"{viol:.2e} over {nfeas} feasible elements; the limiter "
                  f"moved a node by up to {clipped:.2e}")
            if err > CAAR_TOL:
                raise AssertionError(f"tracer_limit {tag} {case}: {err} > "
                                     f"{CAAR_TOL}")
            if cons > CONSERVE_TOL:
                raise AssertionError(f"tracer_limit {tag} {case}: mass "
                                     f"{cons} > {CONSERVE_TOL}")
            if iters == 0:
                worst_i0 = max(worst_i0, err)
            elif viol > BOUNDS_TOL * float(qc.abs().max()):
                raise AssertionError(f"tracer_limit {tag} {case}: bounds "
                                     f"{viol}")
            if case == "pushed" and not clipped > 0.5:
                raise AssertionError(f"tracer_limit {tag}: the pushed nodes "
                                     "were not clipped")
            if case != "uniform" and nfeas == 0:
                raise AssertionError(f"tracer_limit {tag} {case}: no "
                                     "feasible element")
            worst = max(worst, err)
            worst_cons, worst_viol = max(worst_cons, cons), max(worst_viol,
                                                                viol)
        del cases
        mix = (mx, ca, cb)
        k_ms = cuda_ms(lambda: tracer_limit_cuda(meta, s0, s0, q, dvv, DYN_DT,
                                                 k, mix=mix, **kw), reps)
        k0_ms = cuda_ms(lambda: tracer_limit_cuda(meta, s0, s0, q, dvv,
                                                  DYN_DT, k, **kw), reps)
        kg_ms = graph_ms(lambda: tracer_limit_cuda(
            meta, s0, s0, q, dvv, DYN_DT, k, mix=mix, **kw), reps)
        k0g_ms = graph_ms(lambda: tracer_limit_cuda(
            meta, s0, s0, q, dvv, DYN_DT, k, **kw), reps)
        p_ms = cuda_ms(lambda: tracer_limit_plain(meta, s0, s0, q, dvv,
                                                  DYN_DT, k, mix=mix, **kw), 3)
        ops = LIMIT_OPS_PER_POINT * qsize * k * e16
        bnd, by = bound_ms(nb(2 + 3 * qsize), ops)
        bnd0, _ = bound_ms(nb(2 + 2 * qsize), ops)
        print(f"phase 11 tracer_limit {tag}: slab bitwise; kernel "
              f"{k_ms:.4f} ms with the combination (from a graph "
              f"{kg_ms:.4f}; bound {bnd:.4f} ms, {by}, {nb(2 + 3 * qsize)} "
              f"B), {k0_ms:.4f} ms without (from a graph {k0g_ms:.4f}; bound "
              f"{bnd0:.4f} ms); plain {p_ms:.4f} ms, library none")
        if qsize == 1:
            rows["tracer_limit_cuda"] = dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/tracer.cu",
                replaces="tinman_sandbox_tpu/kernels/tracer_pallas_t.py:322",
                max_abs_err=worst_abs, max_scaled_err=worst,
                max_conservation_err=worst_cons, max_bounds_violation=worst_viol,
                iters0_max_scaled_err=worst_i0,
                ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
                library_ms=None, nomix_ms=k0_ms, nomix_bound_ms=bnd0,
                graph_ms=kg_ms, nomix_graph_ms=k0g_ms,
                blocks_per_sm=occ["limit_mix"],
                nomix_blocks_per_sm=occ["limit"],
                ptxas=regs.get("limit_mix"), nomix_ptxas=regs.get("limit"))
        else:
            rows["tracer_limit_cuda"].update(
                tall_qsize=qsize, tall_max_scaled_err=worst,
                tall_iters0_max_scaled_err=worst_i0,
                tall_max_conservation_err=worst_cons, tall_ms=k_ms,
                tall_nomix_ms=k0_ms, tall_graph_ms=kg_ms,
                tall_nomix_graph_ms=k0g_ms, tall_plain_ms=p_ms,
                tall_bound_ms=bnd, tall_nomix_bound_ms=bnd0)
        del q, mx, mix
        torch.cuda.empty_cache()
    return rows


def phase_prim_path(dev, cs):
    """The full model step at ne30 x 72, qsize 1: the chain against its plain
    twin without and with the limiter, the CLI and the benches. Returns the
    four bench results (plain, limited, tall, tall limited)."""
    import torch

    from tinman_sandbox_tpu_torch import bench, cli
    from tinman_sandbox_tpu_torch.dist import (
        continuity_error_t, prim_step_packed_t4_plain)

    const, s0, qdp, acc, plan, rsp = bench.make_prim_problem(
        cs.ne, NLEV, dev, DYN_DT, 1)
    if continuity_error_t(qdp, cs.gdof) != 0.0 or float(qdp.min()) < 0.0:
        raise AssertionError("prim: the projected tracer is not continuous "
                             "and non-negative")
    sph = const[1][11].double()
    mass0 = float((sph * qdp.double()).sum())
    for limit in (False, True):
        tag = f"prim chain ne{cs.ne}x{NLEV} x10 limit {limit}"
        kstate = (s0, qdp, tuple(a.clone() for a in acc))
        pstate = (s0, qdp, acc)
        k_s = 0.0
        for i in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *kstate, kphi = bench.run_prim(const, *kstate, plan, rsp, 1,
                                           DYN_NU, DYN_DT, 1, limit)
            torch.cuda.synchronize()
            k_s += time.perf_counter() - t0
            for name, x in (("state", kstate[0]), ("tracer", kstate[1])):
                cont = continuity_error_t(x, cs.gdof)
                if cont != 0.0:
                    raise AssertionError(f"{tag}: {name} continuity {cont} "
                                         f"after step {i + 1}")
            *pstate, pphi = bench.run_prim(const, *pstate, plan, rsp, 1,
                                           DYN_NU, DYN_DT, 1, limit,
                                           step=prim_step_packed_t4_plain)
        (ks, kq, kacc), (ps, pq, pacc) = kstate, pstate
        errs = {name: scaled_err(a, b) for name, a, b in zip(
            ("u", "v", "t", "dp"), ks.split(NLEV), ps.split(NLEV))}
        errs["qdp"] = scaled_err(kq, pq)
        for name, a, b in zip(("phi", "vn0u", "vn0v", "omg"), (kphi, *kacc),
                              (pphi, *pacc)):
            errs[name] = scaled_err(a, b)
        for x in (ks, kq, kphi, *kacc):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{tag}: non-finite output")
        dp_min, q_min = float(ks[3 * NLEV:].min()), float(kq.min())
        drift = float((sph * kq.double()).sum()) / mass0 - 1.0
        print(f"phase 12 {tag} (kernels {k_s:.3f} s): continuity 0 after "
              f"every step for the state and the tracer; min dp {dp_min:.3f}; "
              f"min qdp {q_min:.3e}; tracer mass drift {drift:.2e}; tracer "
              f"moved {scaled_err(kq, qdp):.2e}; scaled errors vs plain "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if max(errs.values()) > DYN_TOL or not dp_min > 0.0:
            raise AssertionError(f"{tag}: {errs} > {DYN_TOL} or min dp "
                                 f"{dp_min}")
        if limit and q_min < 0.0:
            raise AssertionError(f"{tag}: min qdp {q_min} < 0")
    del kstate, pstate, ks, kq, kacc, ps, pq, pacc

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ne", str(cs.ne), "--prim", "--hypervis-nu",
                       str(DYN_NU), "--num-exec", "10", "--init", "random",
                       "--dt", str(DYN_DT)])
    out = buf.getvalue()
    if rc != 0 or "WARNING" in out:
        raise AssertionError(f"cli --ne {cs.ne} --prim exited {rc}:\n{out}")
    spread = [ln for ln in out.splitlines() if "continuity:" in ln]
    tracers = [ln for ln in out.splitlines() if "--- tracers:" in ln]
    if float(spread[0].split()[-1]) != 0.0 \
            or float(tracers[0].split("continuity")[1].split(",")[0]) != 0.0:
        raise AssertionError(f"cli --prim: {spread[0]} {tracers[0]}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    print(f"phase 12 cli --ne {cs.ne} --prim --hypervis-nu {DYN_NU:g} --init "
          f"random --dt {DYN_DT} x10:" + speed[0].split(":", 1)[1] + ";"
          + spread[0].split("---", 1)[1] + ";" + tracers[0].split("---", 1)[1])

    results = []
    for extra in (["--nexec", "300", "--reps", "3"],
                  ["--nexec", "300", "--reps", "3", "--limit"],
                  ["--nexec", "20", "--reps", "2", "--qsize",
                   str(QSIZE_TALL)],
                  ["--nexec", "20", "--reps", "2", "--qsize",
                   str(QSIZE_TALL), "--limit"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = bench.main(["--ne", str(cs.ne), "--nlev", str(NLEV),
                              "--prim", "--hypervis-nu", str(DYN_NU), "--dt",
                              str(DYN_DT)] + extra)
        print("phase 12 bench " + buf.getvalue().strip())
        if not res["min_dp3d"] > 0.0:
            raise AssertionError(f"bench --prim: min dp3d {res['min_dp3d']}")
        # with the limiter no tracer goes below its element's bounds; at
        # qsize 1 the bench's min qdp stays >= 0. The limiter's uniform
        # residual pass (exact conservation) can leave a node on a zero
        # lower bound a few ulps below it, and with E3SM's 35 tracers in
        # [0, 1] some do (with the kernels before the quad layout too):
        # there the floor is the limiter's own bounds gate of phase 11
        floor = -BOUNDS_TOL if "--qsize" in extra else 0.0
        if "--limit" in extra and res["min_qdp"] < floor:
            raise AssertionError(f"bench --prim {' '.join(extra)}: min qdp "
                                 f"{res['min_qdp']} < {floor}")
        results.append(res)
        torch.cuda.empty_cache()
    return results


def r0_cases(const, acc):
    """The rsplit=0 gate's cases as (name, args), args the operands of
    ``caar_packed_rsplit0_t``: (scal, hyb, meta, u0, v0, t0, dp0, um1, vm1,
    tm1, dpm1, qdp, pecnd, vn0u, vn0v, omg, etaacc, dvv), with a hybi ramp
    (the analytic hvcoord's hybi = 0 would hide the hybi*sdot term) and a
    random eta accumulator. The cases of ``caar_cases``, ``wind``: sm1 =
    0 and the winds x WIND (the vertical advection of u and v grows as the
    wind squared, the pressure-gradient term beside it does not: in the
    other cases it is ~1e-5 of u1 and v1, below the gate, here ~2e-3), and
    ``long``: the bench problem at a dt2 where the dp update is half of
    dpm1 (``LONG_STEP``: the rsplit=0 dp tendency cancels in f32, so its
    error shows at a long step and not at the bench's)."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.kernels.caar_t import \
        caar_packed_rsplit0_t_plain
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS

    scal, meta, s0, sm1, qdp, pecnd, dvv = const
    k, e16 = qdp.shape
    hybi = torch.linspace(0.0, 1.0, k + 1, device=qdp.device)
    hyb = torch.stack([hybi[:k], hybi[1:]], dim=1).contiguous()
    eta = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (k, e16)).astype(np.float32)).to(qdp.device)
    windy = s0.clone()
    windy[:2 * k] *= WIND
    cases = caar_cases(const, acc) + [
        ("wind", (scal, meta, windy, torch.zeros_like(sm1), qdp, pecnd, *acc,
                  dvv))]
    # the dp tendency of the bench problem: dp1 of the tend case / dt2
    tend = caar_packed_rsplit0_t_plain(scal, hyb, meta, *s0.split(k),
                                       *torch.zeros_like(sm1).split(k), qdp,
                                       pecnd, *acc, eta, dvv)[3]
    sph = meta[META_COLS.index("spheremp")]
    rate = float((tend / sph).abs().max()) / float(scal[0, 0])
    long = scal.clone()
    long[0, 0] = LONG_STEP * float(sm1[3 * k:].abs().max()) / rate
    cases.append(("long", (long, meta, s0, sm1, qdp, pecnd, *acc, dvv)))
    return [(name, (a[0], hyb, a[1], *a[2].split(k), *a[3].split(k), *a[4:9],
                    eta, a[9])) for name, a in cases]


def row_args(args, hyb=True):
    """Operands of the t-layout rsplit=0 step on the row layout: each
    [nlev, E16] field, the meta and hyb transposed (contiguous); without
    ``hyb`` the operands of ``caar_packed`` (no hyb, no etaacc)."""
    t = lambda x: x.T.contiguous()
    scal, h, meta, *fields, eta, dvv = args
    if hyb:
        return (scal, t(h), t(meta), *map(t, fields), t(eta), dvv)
    return (scal, t(meta), *map(t, fields), dvv)


R0_NAMES = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg", "eta")


def t_pair_of(targs):
    """``caar_t4_cuda`` on the t problem of rsplit=0 operands ``targs``
    (its own accumulators): the row rsplit>0 kernel's reference for bits."""
    import torch

    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda

    acc = [x.clone() for x in targs[13:16]]
    return caar_t4_cuda(targs[0], targs[2], torch.cat(targs[3:7]),
                        torch.cat(targs[7:11]), targs[11], targs[12], *acc,
                        targs[17])


def same_as_t(row_out, t_out) -> bool:
    """Whether the row rsplit>0 outputs are the t pair form's transposed,
    bit for bit."""
    import torch

    rows = [torch.cat([x.T for x in row_out[:4]]), row_out[4].T,
            *(x.T for x in row_out[5:8])]
    return all(torch.equal(a, b) for a, b in zip(rows, t_out))


def same_as_row_r0(t_out, targs) -> bool:
    """Whether the t rsplit=0 outputs are ``caar_packed_rsplit0``'s (the row
    rsplit=0 kernel, its own accumulators) on the transposed problem,
    transposed back, bit for bit."""
    import torch

    from tinman_sandbox_tpu_torch.kernels.caar import caar_packed_rsplit0

    args = row_args(targs)
    acc = [x.clone() for x in args[-5:-1]]
    row = caar_packed_rsplit0(*args[:-5], *acc, args[-1])
    return all(torch.equal(a, b.T) for a, b in zip(t_out, row))


def same_bits(name, got, targs, tag) -> str:
    """Phase 13's bit-for-bit checks: the row rsplit>0 kernel against the t
    pair form, the t rsplit=0 kernel against the row rsplit=0 kernel, each
    on the transposed problem. Raises where they differ; returns the note
    to print."""
    if name == "caar_packed":
        bits, other = same_as_t(got, t_pair_of(targs)), "caar_t4_cuda"
    elif name == "caar_packed_rsplit0_t":
        bits, other = same_as_row_r0(got, targs), "caar_packed_rsplit0"
    else:
        return ""
    if not bits:
        raise AssertionError(f"{tag}: not {other}'s bits")
    return f"; bit for bit {other} transposed: {bits}"


def row_modes():
    """The CAAR modes of phase 13: name -> (kernel, plain, operands of the
    rsplit=0 t arguments, output names)."""
    from tinman_sandbox_tpu_torch.kernels.caar import (
        caar_packed, caar_packed_plain, caar_packed_rsplit0,
        caar_packed_rsplit0_plain)
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        caar_packed_rsplit0_t, caar_packed_rsplit0_t_plain)

    return {
        "caar_packed_rsplit0_t": (caar_packed_rsplit0_t,
                                  caar_packed_rsplit0_t_plain,
                                  lambda a: a, R0_NAMES),
        "caar_packed_rsplit0": (caar_packed_rsplit0,
                                caar_packed_rsplit0_plain, row_args,
                                R0_NAMES),
        "caar_packed": (caar_packed, caar_packed_plain,
                        lambda a: row_args(a, hyb=False), R0_NAMES[:8]),
    }


def run_mode(mode, targs):
    """One mode on the rsplit=0 t arguments: (kernel outputs, plain outputs
    in f32, plain outputs in f64 on the same f32 inputs)."""
    import torch

    kern, plain, conv, names = mode
    args = conv(targs)
    nacc = 4 if len(names) == 9 else 3
    want = plain(*args)
    want64 = plain(*(x.double() for x in args))
    kacc = [x.clone() for x in args[-1 - nacc:-1]]
    got = kern(*args[:-1 - nacc], *kacc, args[-1])
    torch.cuda.synchronize()
    return got, want, want64


def phase_row_kernels(dev, cs):
    """The rsplit=0 modes on both layouts, the row rsplit>0 mode and the row
    tracer kernel. Returns their four kernel rows."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.caar_t import (caar_packed_t,
                                                         caar_plan,
                                                         caar_row_plan)
    from tinman_sandbox_tpu_torch.kernels.tracer import (
        euler_packed, euler_packed_plain)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    rows = {}
    modes = row_modes()
    lib = _build.library("caar")
    for nlev in (NLEV, *CAAR_OTHER_NLEV):
        p = caar_plan(NE * NE * 6 * 16, nlev, r0=True)
        occ = lib.caar_blocks_per_sm(5 if p.cap else 4, nlev, p.chunks,
                                     int(p.stash), 0, dev.index)
        print(f"phase 13 t rsplit=0 plan nlev {nlev}: {p.chunks} chunks of "
              f"{p.levels} levels, {'stash' if p.stash else 'no stash'}, "
              f"{p.smem} B shared, {p.blocks_per_sm} blocks a SM reckoned, "
              f"{occ} by cudaOccupancy")
        if occ <= 0:
            raise AssertionError(f"caar t rsplit=0 occupancy: error {-occ}")
    for r0 in (False, True):
        for nlev in (NLEV, *CAAR_OTHER_NLEV):
            p = caar_row_plan(NE * NE * 6 * 16, nlev, r0)
            occ = lib.caar_blocks_per_sm(2 + int(r0), nlev, p.chunks,
                                         int(p.stash), 0, dev.index)
            print(f"phase 13 row plan {'rsplit=0' if r0 else 'rsplit>0'} "
                  f"nlev {nlev}: {p.chunks} chunks of {p.levels} levels, "
                  f"{'staged' if p.stash else 'windowed'}, {p.smem} B "
                  f"shared, {p.blocks_per_sm} blocks a SM reckoned, {occ} "
                  "by cudaOccupancy")
            if occ <= 0:
                raise AssertionError(f"caar row occupancy: error {-occ}")
    for nelem in (1024, 5400):
        if nelem == 1024:
            const, acc = bench.make_problem(nelem, NLEV, dev, seed=7)
            tag = f"{nelem}x{NLEV}"
        else:
            (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, _, _ = \
                bench.make_assembled_problem(cs.ne, NLEV, dev)
            const = (scal, meta, s0, sm1, qdp, pecnd, dvv)
            tag = f"ne{cs.ne}x{NLEV}"
        e16 = nelem * 16
        worst = {name: [0.0, 0.0] for name in modes}
        bench_args = None
        for case, targs in r0_cases(const, acc):
            if case == "bench":
                bench_args = targs
            for name, mode in modes.items():
                got, want, want64 = run_mode(mode, targs)
                names = mode[3]
                for g in got:
                    if not bool(torch.isfinite(g).all()):
                        raise AssertionError(f"{name} {tag} {case}: "
                                             "non-finite")
                errs = {n: scaled_err(g, w)
                        for n, g, w in zip(names, got, want)}
                e64 = {n: scaled_err(g, w)
                       for n, g, w in zip(names, got, want64)}
                own = scaled_err(want[3], want64[3])
                same = same_bits(name, got, targs, f"{name} {tag} {case}")
                print(f"phase 13 {name} {tag} {case}: scaled errors "
                      + " ".join(f"{a} {b:.2e}" for a, b in errs.items())
                      + "; against plain in f64: worst "
                      f"{max(e64.values()):.2e}, dp1 {e64['dp1']:.2e} "
                      "(plain f32's own dp1 "
                      f"{own:.2e}){same}")
                if max(errs.values()) > CAAR_TOL:
                    raise AssertionError(f"{name} {tag} {case}: {errs} > "
                                         f"{CAAR_TOL}")
                if max(e64.values()) > CAAR_TOL:
                    raise AssertionError(f"{name} {tag} {case}: against "
                                         f"plain in f64 {e64} > {CAAR_TOL}")
                worst[name][0] = max(worst[name][0], *errs.values())
                worst[name][1] = max(worst[name][1], *(
                    float((g - w).abs().max()) for g, w in zip(got, want)))
                del want, want64, got
        # times on the bench case; the t form's pair step at the same shape
        times = {}
        for name, (kern, plain, conv, names) in modes.items():
            args = conv(bench_args)
            nacc = 4 if len(names) == 9 else 3
            kacc = [x.clone() for x in args[-1 - nacc:-1]]
            run = lambda: kern(*args[:-1 - nacc], *kacc, args[-1])
            times[name] = (cuda_ms(run, 20), cuda_ms(lambda: plain(*args), 5),
                           graph_ms(run, 20))
        targs = bench_args
        tacc = [x.clone() for x in targs[13:16]]
        trun = lambda: caar_packed_t(targs[0], *targs[2:13], *tacc,
                                     targs[17])
        t_ms, t_graph = cuda_ms(trun, 20), graph_ms(trun, 20)
        # fields read once and written once, the 13 meta rows, dvv, scal;
        # rsplit=0 also the eta accumulator (read, written) and hyb
        nb_pair = (21 * NLEV + 13) * e16 * 4 + 16 * 4 + 3 * 4
        nb_r0 = nb_pair + 2 * NLEV * e16 * 4 + 2 * NLEV * 4
        bounds = {
            "caar_packed_rsplit0_t": bound_ms(
                nb_r0, RSPLIT0_OPS_PER_POINT * e16 * NLEV),
            "caar_packed_rsplit0": bound_ms(
                nb_r0, RSPLIT0_OPS_PER_POINT * e16 * NLEV),
            "caar_packed": bound_ms(nb_pair, CAAR_OPS_PER_POINT * e16 * NLEV),
        }
        for name, (k_ms, p_ms, g_ms) in times.items():
            print(f"phase 13 {name} {tag}: kernel {k_ms:.4f} ms (from a "
                  f"graph {g_ms:.4f} ms), plain {p_ms:.4f} ms, library none, "
                  f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}; graph"
                  f" / bound {g_ms / bounds[name][0]:.2f}); the t-layout "
                  f"pair step caar_packed_t {t_ms:.4f} ms (graph "
                  f"{t_graph:.4f}; kernel / t pair {g_ms / t_graph:.2f} from "
                  "graphs)")
        r0_ratio = times["caar_packed_rsplit0"][2] / \
            times["caar_packed_rsplit0_t"][2]
        print(f"phase 13 {tag}: row / t at the same shape from graphs: "
              f"rsplit>0 {times['caar_packed'][2] / t_graph:.2f}, rsplit=0 "
              f"{r0_ratio:.2f}")
        for name in modes:
            sfx = "" if nelem == 1024 else "ne30_"
            r = rows.setdefault(name, dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/caar.cu",
                replaces={
                    "caar_packed_rsplit0_t":
                        "tinman_sandbox_tpu/kernels/caar_pallas_t.py:856",
                    "caar_packed_rsplit0":
                        "tinman_sandbox_tpu/kernels/caar_pallas.py:365",
                    "caar_packed":
                        "tinman_sandbox_tpu/kernels/caar_pallas.py:307"}[name],
                library_ms=None))
            r.update({f"{sfx}max_scaled_err": worst[name][0],
                      f"{sfx}ms": times[name][0],
                      f"{sfx}plain_ms": times[name][1],
                      f"{sfx}graph_ms": times[name][2],
                      f"{sfx}bound_ms": bounds[name][0],
                      f"{sfx}bound_by": bounds[name][1],
                      f"{sfx}t_pair_ms": t_ms,
                      f"{sfx}t_pair_graph_ms": t_graph})
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), worst[name][1])
        del const, acc, bench_args, targs
        torch.cuda.empty_cache()
    for nlev in CAAR_OTHER_NLEV:
        for name, extra in row_other_nlev(dev, nlev).items():
            rows[name].update(extra)


    # -- the row tracer kernel at ne30, qsize 1 and QSIZE_TALL
    (scal, meta_t, _, dvv), s0, _, _, _, _ = bench.make_prim_problem(
        cs.ne, NLEV, dev, DYN_DT, 1)
    k, e16 = NLEV, cs.nelem * 16
    meta = meta_t.T.contiguous()
    vu, vv = s0[:k].T.contiguous(), s0[k:2 * k].T.contiguous()
    for qsize in (1, QSIZE_TALL):
        tag = f"ne{cs.ne}x{k} qsize {qsize}"
        qt = bench.make_prim_problem(cs.ne, k, dev, DYN_DT, qsize)[2]
        q = qt.T.contiguous()                       # [E16, qsize*nlev]
        div = q - euler_packed_plain(meta, vu, vv, q, dvv, 1.0, k)
        dt_long = 0.5 * float(q.abs().max()) / float(div.abs().max())
        del div
        worst = worst_abs = 0.0
        for dt in (DYN_DT, dt_long):
            want = euler_packed_plain(meta, vu, vv, q, dvv, dt, k)
            got = euler_packed(meta, vu, vv, q, dvv, dt, k)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"euler_packed {tag}: non-finite")
            err = max(scaled_err(a, b) for a, b in zip(got.split(k, 1),
                                                       want.split(k, 1)))
            print(f"phase 13 euler_packed {tag} dt {dt:.4g}: worst scaled "
                  f"error of a tracer block {err:.2e}")
            if err > CAAR_TOL:
                raise AssertionError(f"euler_packed {tag}: {err} > {CAAR_TOL}")
            worst = max(worst, err)
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            del want, got
        reps = 50 if qsize == 1 else 10
        k_ms = cuda_ms(lambda: euler_packed(meta, vu, vv, q, dvv, DYN_DT, k),
                       reps)
        p_ms = cuda_ms(lambda: euler_packed_plain(meta, vu, vv, q, dvv,
                                                  DYN_DT, k), 3)
        # the t form at the same shape: no spheremp, no slab
        t_ms = cuda_ms(lambda: tracer_euler_cuda(meta_t, s0, s0, qt, dvv,
                                                 DYN_DT, k, fold_sph=False,
                                                 wind_rows=(0, 1)), reps)
        # q read, out written, the two wind blocks, 6 meta values, dvv
        nbytes = (2 * qsize * k + 2 * k + 6) * e16 * 4 + 16 * 4
        bnd, by = bound_ms(nbytes, TRACER_ROW_OPS_PER_POINT * qsize * k * e16)
        print(f"phase 13 euler_packed {tag}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library none, bound {bnd:.4f} ms ({by}, "
              f"{nbytes} B); the t form tracer_euler_cuda {t_ms:.4f} ms "
              f"(row / t {k_ms / t_ms:.2f})")
        if qsize == 1:
            rows["euler_packed"] = dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/tracer.cu",
                replaces="tinman_sandbox_tpu/kernels/tracer_pallas.py:61",
                max_abs_err=worst_abs, max_scaled_err=worst, ms=k_ms,
                plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None,
                t_form_ms=t_ms)
        else:
            rows["euler_packed"].update(
                tall_qsize=qsize, tall_max_scaled_err=worst, tall_ms=k_ms,
                tall_plain_ms=p_ms, tall_bound_ms=bnd, tall_t_form_ms=t_ms)
            rows["euler_packed"]["max_abs_err"] = max(
                rows["euler_packed"]["max_abs_err"], worst_abs)
        del q, qt
        torch.cuda.empty_cache()
    return rows


def row_other_nlev(dev, nlev: int) -> dict:
    """Phase 13 off the main path's nlev, at 1024 x ``nlev``: the t
    rsplit=0 kernel and the row kernels (``caar_packed_rsplit0_t``,
    ``caar_packed``, ``caar_packed_rsplit0``) in the cases of ``r0_cases``,
    each field within 5e-5 scaled of its plain version in f64 on the same
    f32 inputs (the plain version in f32 printed beside it: at 400 levels
    its own rsplit=0 dp1 is off the f64 one by the cancellation of its
    running sums), the t rsplit=0 kernel also within 5e-5 of plain f32 and
    bit for bit ``caar_packed_rsplit0`` on the transposed problem, the
    rsplit>0 row kernel bit for bit ``caar_t4_cuda``; timed from graphs
    beside the t pair form. Returns extra keys of their kernel rows."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import (caar_plan,
                                                         caar_row_plan,
                                                         caar_t4_cuda)

    modes = row_modes()
    const, acc = bench.make_problem(1024, nlev, dev, seed=7)
    tag = f"1024x{nlev}"
    out = {name: {} for name in modes}
    bench_args = None
    for case, targs in r0_cases(const, acc):
        if case == "bench":
            bench_args = targs
        for name, mode in modes.items():
            got, want, want64 = run_mode(mode, targs)
            names = mode[3]
            for g in got:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name} {tag} {case}: non-finite")
            errs = {n: scaled_err(g, w) for n, g, w in zip(names, got, want)}
            e64 = {n: scaled_err(g, w) for n, g, w in zip(names, got, want64)}
            own = scaled_err(want[3], want64[3])
            same = same_bits(name, got, targs, f"{name} {tag} {case}")
            print(f"phase 13 {name} {tag} {case}: against plain in f64 "
                  + " ".join(f"{a} {b:.2e}" for a, b in e64.items())
                  + f"; against plain in f32 worst {max(errs.values()):.2e}"
                  f" (plain f32's own dp1 {own:.2e}){same}")
            if max(e64.values()) > CAAR_TOL:
                raise AssertionError(f"{name} {tag} {case}: against plain in "
                                     f"f64 {e64} > {CAAR_TOL}")
            if name == "caar_packed_rsplit0_t" and \
                    max(errs.values()) > CAAR_TOL:
                raise AssertionError(f"{name} {tag} {case}: against plain in "
                                     f"f32 {errs} > {CAAR_TOL}")
            key = f"nlev{nlev}_max_scaled_err_f64"
            out[name][key] = max(out[name].get(key, 0.0), *e64.values())
            key = f"nlev{nlev}_max_scaled_err"
            out[name][key] = max(out[name].get(key, 0.0), *errs.values())
            del got, want, want64
    tacc = [x.clone() for x in bench_args[13:16]]
    s0, sm1 = torch.cat(bench_args[3:7]), torch.cat(bench_args[7:11])
    t_graph = graph_ms(lambda: caar_t4_cuda(
        bench_args[0], bench_args[2], s0, sm1, bench_args[11], bench_args[12],
        *tacc, bench_args[17]), 10)
    for name, (kern, plain, conv, names) in modes.items():
        args = conv(bench_args)
        nacc = 4 if len(names) == 9 else 3
        kacc = [x.clone() for x in args[-1 - nacc:-1]]
        g_ms = graph_ms(lambda: kern(*args[:-1 - nacc], *kacc, args[-1]), 10)
        if name == "caar_packed_rsplit0_t":
            plan = caar_plan(1024 * 16, nlev, r0=True)
            how = "stash" if plan.stash else "no stash"
        else:
            plan = caar_row_plan(1024 * 16, nlev, name != "caar_packed")
            how = "staged" if plan.stash else "windowed"
        print(f"phase 13 {name} {tag}: from a graph {g_ms:.4f} ms ({how}); "
              f"the t pair form {t_graph:.4f} ms")
        out[name][f"nlev{nlev}_graph_ms"] = g_ms
    del const, acc, bench_args
    torch.cuda.empty_cache()
    return out


def phase_row_path(dev, cs):
    """The rsplit=0 and row-layout main paths. Returns the two bench
    results (raw, assembled)."""
    import dataclasses

    import torch

    import tinman_sandbox_tpu_torch as tt
    from tinman_sandbox_tpu_torch import bench, cli
    from tinman_sandbox_tpu_torch.golden import golden_caar
    from tinman_sandbox_tpu_torch.kernels.caar import (
        ROW_PACKING, caar, caar_packed_rsplit0_plain)
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        T_PACKING, caar_packed_rsplit0_t_plain, caar_t, full_step)
    from tinman_sandbox_tpu_torch.kernels.tracer import euler_step_fast
    from tinman_sandbox_tpu_torch.timeloop import rotated
    from tinman_sandbox_tpu_torch.timeloop.tracer import euler_step

    # the CLI's raw row path at 1024 elements, golden-checked
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--layout", "row", "--num-elems", "1024",
                       "--num-exec", "100", "--golden-check"])
    out = buf.getvalue()
    if rc != 0 or "row-layout" not in out:
        raise AssertionError(f"cli --layout row exited {rc}:\n{out}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    gold = [ln for ln in out.splitlines() if "golden diffs" in ln]
    diffs = gold[0].split("golden diffs: T")[1].split()
    ref = golden_caar()
    for key, diff in (("T", diffs[0]), ("v1", diffs[2]), ("v2", diffs[4])):
        lim = CAAR_TOL * float(abs(ref[key]).max())
        if not float(diff) < lim:
            raise AssertionError(f"cli --layout row golden {key}: {diff} >= "
                                 f"{lim:.3e}")
    print("phase 14 cli --layout row 1024x72 x100:" + speed[0].split(":", 1)[1]
          + ";" + gold[0].split("---", 1)[1])

    # the CLI's row assembled path at ne30
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--layout", "row", "--ne", str(cs.ne), "--dss",
                       "--leapfrog", "--num-exec", "20", "--init", "random",
                       "--dt", "0.05"])
    out = buf.getvalue()
    if rc != 0 or "WARNING" in out:
        raise AssertionError(f"cli --layout row --ne {cs.ne} --dss exited "
                             f"{rc}:\n{out}")
    spread = [ln for ln in out.splitlines() if "continuity:" in ln]
    if float(spread[0].split()[-1]) != 0.0:
        raise AssertionError(f"cli --layout row --dss: {spread[0]}")
    speed = [ln for ln in out.splitlines() if "Mgridpoints/s" in ln]
    print(f"phase 14 cli --layout row --ne {cs.ne} --dss --leapfrog --init "
          "random x20:" + speed[0].split(":", 1)[1] + ";"
          + spread[0].split("---", 1)[1])

    # 10 chained rsplit=0 leapfrog steps at 5,400 x 72, hybi ramp, through
    # both full-state wrappers, each against the same chain on its plain
    # version
    cfg = tt.Config(nelem=5400, nlev=NLEV, dt=0.05, rsplit=0)
    kw = dict(dtype=torch.float32, device=dev)
    hv = tt.analytic_hvcoord(cfg, **kw)
    hv = dataclasses.replace(hv, hybi=torch.linspace(0.0, 1.0, NLEV + 1,
                                                     **kw))
    prob = (tt.random_state(cfg, seed=7, **kw), tt.zero_derived(cfg, **kw),
            tt.random_geometry(cfg, seed=8, **kw), hv)
    for label, wrapper, plain, packing in (
            ("caar_t", caar_t, caar_packed_rsplit0_t_plain, T_PACKING),
            ("kernels.caar.caar", caar, caar_packed_rsplit0_plain,
             ROW_PACKING)):
        (ks, kd), (ps, pd), c = prob[:2], prob[:2], cfg
        k_s = 0.0
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ks, kd = wrapper(ks, kd, *prob[2:], c, 2 * cfg.dt, 0.1,
                             device=dev)
            torch.cuda.synchronize()
            k_s += time.perf_counter() - t0
            ps, pd = full_step(plain, packing, ps, pd, *prob[2:], c,
                               2 * cfg.dt, 0.1, device=dev)
            c = rotated(c)
        errs = {n: scaled_err(getattr(ks, n), getattr(ps, n))
                for n in ("u", "v", "t", "dp3d")}
        errs.update({n: scaled_err(getattr(kd, n), getattr(pd, n)) for n in
                     ("vn0_u", "vn0_v", "omega_p", "phi", "eta_dot_dpdn")})
        for n in ("u", "v", "t", "dp3d"):
            if not bool(torch.isfinite(getattr(ks, n)).all()):
                raise AssertionError(f"rsplit=0 chain {label}: non-finite {n}")
        if max(errs.values()) > LEAPFROG_TOL:
            raise AssertionError(f"rsplit=0 chain {label}: {errs} > "
                                 f"{LEAPFROG_TOL}")
        moved = scaled_err(kd.eta_dot_dpdn, prob[1].eta_dot_dpdn)
        print(f"phase 14 rsplit=0 chain {label} 5400x{NLEV} x10 (kernels "
              f"{k_s:.3f} s incl. pack): eta_dot_dpdn moved {moved:.2e}; "
              "scaled errors vs plain "
              + " ".join(f"{a} {b:.2e}" for a, b in errs.items()))
    del prob, ks, kd, ps, pd

    # 10 chained tracer steps through the full-state row wrapper at ne30,
    # against the field form, at a step where they move the tracer
    tcfg = tt.Config(nelem=cs.nelem, nlev=NLEV, qsize=1)
    st = tt.random_state(tcfg, seed=7, **kw)
    q0, u, v = st.qdp[0], st.u[0], st.v[0]
    div = q0 - euler_step(q0, u, v, cs.geometry, tcfg, 1.0)
    dt = 0.05 * float(q0.abs().max()) / float(div.abs().max())
    del div
    kq = fq = q0
    k_s = 0.0
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kq = euler_step_fast(kq, u, v, cs.geometry, tcfg, dt, device=dev)
        torch.cuda.synchronize()
        k_s += time.perf_counter() - t0
        fq = euler_step(fq, u, v, cs.geometry, tcfg, dt)
    err = scaled_err(kq, fq)
    if not bool(torch.isfinite(kq).all()) or err > DYN_TOL:
        raise AssertionError(f"euler_step_fast chain: {err} > {DYN_TOL}")
    print(f"phase 14 euler_step_fast chain ne{cs.ne}x{NLEV} x10 dt {dt:.4g} "
          f"(kernels {k_s:.3f} s incl. pack): tracer moved "
          f"{scaled_err(kq, q0):.2e}; scaled error vs the field form "
          f"{err:.2e}")
    del st, q0, u, v, kq, fq

    results = []
    for extra in (["--nelem", "1024", "--nexec", "500"],
                  ["--ne", str(cs.ne), "--nexec", "100"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = bench.main(["--layout", "row", "--nlev", str(NLEV),
                              "--reps", "3"] + extra)
        print("phase 14 bench " + buf.getvalue().strip())
        if res["layout"] != "row":
            raise AssertionError(f"bench --layout row: {res}")
        results.append(res)
    return results


def ring_field_errs(got, want, nlev) -> dict:
    """Scaled error of each output of a CAAR ring call on its own: the four
    row blocks of the swept w (every lane), phi (where it is stored), the
    three accumulators and the slab's four column blocks."""
    names = ("w_u", "w_v", "w_t", "w_dp")
    pairs = list(zip(names, got[0].split(nlev), want[0].split(nlev)))
    if got[1] is not None:
        pairs.append(("phi", got[1], want[1]))
    pairs += zip(("vn0u", "vn0v", "omg"), got[2:5], want[2:5])
    pairs += zip(("slab_u", "slab_v", "slab_t", "slab_dp"),
                 got[5].split(nlev, 1), want[5].split(nlev, 1))
    return {n: scaled_err(a, b) for n, a, b in pairs}


def tracer_ring_replays(meta, ps0, q, mx, dvv, dt, k, rsp, fix, cacb, tag,
                        n: int = 3) -> int:
    """``tracer_ring_packed_t`` with mix captured in a CUDA graph and
    replayed ``n`` times, fresh q and mix copied into the captured inputs
    before each replay; each replay's w and slab bit for bit the two
    launches it fuses on the same inputs. Returns n; raises where a replay
    differs."""
    import torch

    from tinman_sandbox_tpu_torch.kernels.dss import dss_sweep_nomerge_cuda
    from tinman_sandbox_tpu_torch.kernels.ring_fused import \
        tracer_ring_packed_t
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    gq, gm = q.clone(), mx.clone()
    kw = dict(wind_rows=(0, 1))
    cap = lambda: tracer_ring_packed_t(meta, ps0, ps0, gq, dvv, dt, k, rsp,
                                       fix, mix=(gm, *cacb), **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cap()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w, slab = cap()
    gen = torch.Generator(device=q.device).manual_seed(16)
    for i in range(n):
        gq.copy_(q * (0.5 + torch.rand(q.shape, generator=gen,
                                       device=q.device)))
        gm.copy_(torch.rand(mx.shape, generator=gen, device=q.device))
        graph.replay()
        e, eslab = tracer_euler_cuda(meta, ps0, ps0, gq, dvv, dt, k, fix=fix,
                                     **kw)
        want = dss_sweep_nomerge_cuda(e, rsp, fix, (gm, *cacb))
        torch.cuda.synchronize()
        if not (torch.equal(w, want) and torch.equal(slab, eslab)):
            raise AssertionError(f"tracer_ring {tag}: graph replay {i + 1} "
                                 "is not the two launches' bits")
    del graph
    return n


def rings_on_two_streams(const, acc, ps0, q_tall, rsp, fix, k,
                         rounds: int = 3) -> int:
    """Both rings at once on two streams, three times: on one the CAAR ring
    (pair form with the slab) and the tracer ring at QSIZE_TALL, on the
    other the tracer ring at qsize 1 and the CAAR ring, each launched as the
    other stream runs; every output bit for bit its two launches (the CAAR
    or Euler kernel, then the merge-free sweep) on the current stream.
    Returns the rounds; raises where an output differs."""
    import torch

    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
    from tinman_sandbox_tpu_torch.kernels.dss import dss_sweep_nomerge_cuda
    from tinman_sandbox_tpu_torch.kernels.ring_fused import (
        caar_ring_packed_t4, tracer_ring_packed_t)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    scal, meta, s0, sm1, qdp, pecnd, dvv = const
    kw = dict(wind_rows=(0, 1))
    q1 = q_tall[:k].contiguous()
    cur = torch.cuda.current_stream()
    sa, sb = torch.cuda.Stream(), torch.cuda.Stream()

    def caar():
        a = [x.clone() for x in acc]
        return caar_ring_packed_t4(scal, meta, s0, sm1, qdp, pecnd, *a, dvv,
                                   rsp, fix), a

    def tracer(q):
        return tracer_ring_packed_t(meta, ps0, ps0, q, dvv, DYN_DT, k, rsp,
                                    fix, **kw)

    for i in range(rounds):
        sa.wait_stream(cur)
        sb.wait_stream(cur)
        with torch.cuda.stream(sa):
            ca, ta = caar(), tracer(q_tall)
        with torch.cuda.stream(sb):
            tb, cb = tracer(q1), caar()
        cur.wait_stream(sa)
        cur.wait_stream(sb)
        torch.cuda.synchronize()
        tacc = [x.clone() for x in acc]
        two = caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *tacc, dvv,
                           fix=fix)
        cw = dss_sweep_nomerge_cuda(two[0], rsp, fix)
        for (got, a), tag in ((ca, "a"), (cb, "b")):
            same = torch.equal(got[0], cw) and torch.equal(got[1], two[1]) \
                and torch.equal(got[5], two[5]) and \
                all(torch.equal(x, y) for x, y in zip(a, tacc))
            if not same:
                raise AssertionError(f"caar_ring on stream {tag}, round "
                                     f"{i + 1}: not the two launches' bits")
        for (w, slab), q, tag in ((ta, q_tall, "a"), (tb, q1, "b")):
            e, eslab = tracer_euler_cuda(meta, ps0, ps0, q, dvv, DYN_DT, k,
                                         fix=fix, **kw)
            if not (torch.equal(w, dss_sweep_nomerge_cuda(e, rsp, fix))
                    and torch.equal(slab, eslab)):
                raise AssertionError(f"tracer_ring on stream {tag}, round "
                                     f"{i + 1}: not the two launches' bits")
        del ca, cb, ta, tb, two, cw
    print(f"phase 15 rings on two streams at once: {rounds} rounds (the CAAR"
          f" ring and the tracer ring at qsize {q_tall.shape[0] // k} on one,"
          " the tracer ring at qsize 1 and the CAAR ring on the other), every"
          " output bit for bit its two launches")
    return rounds


def phase_ring_kernels(dev, cs):
    """The four kernels of the ring path at ne30 x 72: the CAAR and tracer
    ring kernels against their plain versions (5e-5 per output block) and
    bit for bit against the two-launch kernels they fuse, the merge-free
    sweep and the patch bit for bit their plain versions, the split DSS bit
    for bit the merged one; each timed against its bound, its plain
    version and (the patch) its library call. Returns the four rows."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.caar_t import (caar_plan,
                                                         caar_t4_cuda)
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_cuda, dss_fixup_cuda, dss_merge_patch_cuda,
        dss_merge_patch_plain, dss_structured_t_cuda_pre,
        dss_structured_t_cuda_patch, dss_sweep_nomerge_cuda,
        dss_sweep_nomerge_plain, fix_tables, make_fix_tables)
    from tinman_sandbox_tpu_torch.kernels.ring_fused import (
        caar_ring_packed_t4, caar_ring_plain, ring_plan, tracer_ring_packed_t,
        tracer_ring_plain, tracer_ring_plan)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (
        TRACER_LEVELS, TRACER_TILE, tracer_euler_cuda, tracer_euler_plain)

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(cs.ne, NLEV, dev)
    const = (scal, meta, s0, sm1, qdp, pecnd, dvv)
    fix = fix_tables(plan, dev)
    e16, n, k, nr = cs.nelem * 16, fix.nfix, NLEV, rsp.shape[0]
    tplan = tracer_ring_plan(e16, k, cs.ne)    # the tracer ring's, qsize 1
    rplan = ring_plan(e16, k, cs.ne)           # the CAAR ring's
    gen = torch.Generator(device=dev).manual_seed(15)
    rnd = lambda rows: torch.randn(rows, e16, generator=gen, device=dev)
    ca, cb = float(np.float32(1.0 / 3.0)), float(np.float32(2.0 / 3.0))
    rows = {}

    # -- occupancy: blocks an SM holds, and the waves of each launch
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    caar_lib, tr_lib = _build.library("caar"), _build.library("tracer")
    cplan = caar_plan(e16, k)
    occ = {"caar_chunk_kernel": (caar_lib.caar_blocks_per_sm(
               0, k, cplan.chunks, int(cplan.stash), 0, dev.index),
               cplan.blocks),
           "caar_ring_kernel": (caar_lib.caar_blocks_per_sm(
               1, k, rplan.caar.chunks, int(rplan.caar.stash), 0, dev.index),
               rplan.tickets),
           "tracer_kernel (Euler)": (
               tr_lib.tracer_blocks_per_sm(0, dev.index),
               -(-e16 // TRACER_TILE) * -(-k // TRACER_LEVELS)),
           "tracer_ring_kernel": (tr_lib.tracer_blocks_per_sm(1, dev.index),
                                  tplan.tickets)}
    for name, (bps, blocks) in occ.items():
        if bps <= 0:
            raise AssertionError(f"occupancy of {name}: error {-bps}")
        print(f"phase 15 occupancy ne{cs.ne}x{k}: {name} {bps} blocks per SM "
              f"x {nsm} SMs = {bps * nsm} resident; {blocks} blocks = "
              f"{blocks / (bps * nsm):.3f} waves")

    # -- the CAAR ring kernel: pair, stage with and without phi, with and
    # without mix, in the three cases of phase 3
    mx4 = rnd(4 * k)
    worst = worst_abs = 0.0
    for (case, args), (single, emit_phi), mixed in itertools.product(
            caar_cases(const, acc), ((False, True), (True, True),
                                     (True, False)), (False, True)):
        tag = (f"{case} {'stage' if single else 'pair'} phi="
               f"{'yes' if emit_phi else 'no'} mix={'yes' if mixed else 'no'}")
        sc, mt, s, sm, q, pec = args[:6]
        sm = None if single else sm
        mix = (mx4, ca, cb) if mixed else None
        kw = dict(single=single, emit_phi=emit_phi)
        want = caar_ring_plain(sc, mt, s, sm, q, pec, *args[6:9], args[9], rsp,
                               fix, mix=mix, **kw)
        kacc = [x.clone() for x in args[6:9]]
        got = caar_ring_packed_t4(sc, mt, s, sm, q, pec, *kacc, args[9], rsp,
                                  fix, mix=mix, **kw)
        # the two launches it fuses: the CAAR kernel, the merge-free sweep
        tacc = [x.clone() for x in args[6:9]]
        two = caar_t4_cuda(sc, mt, s, sm, q, pec, *tacc, args[9], fix=fix,
                           **kw)
        tw = dss_sweep_nomerge_cuda(two[0], rsp, fix, mix)
        torch.cuda.synchronize()
        if (got[1] is None) == emit_phi or any(
                a is not b for a, b in zip(got[2:5], kacc)):
            raise AssertionError(f"caar_ring {tag}: outputs misplaced")
        for g in got:
            if g is not None and not bool(torch.isfinite(g).all()):
                raise AssertionError(f"caar_ring {tag}: non-finite")
        errs = ring_field_errs(got, want, k)
        same = torch.equal(got[0], tw) and torch.equal(got[5], two[5]) and \
            all(torch.equal(a, b) for a, b in zip(got[2:5], tacc)) and \
            (not emit_phi or torch.equal(got[1], two[1]))
        print(f"phase 15 caar_ring ne{cs.ne}x{k} {tag}: bit for bit the two "
              f"launches: {same}; scaled errors vs plain "
              + " ".join(f"{a} {b:.2e}" for a, b in errs.items()))
        if max(errs.values()) > CAAR_TOL or not same:
            raise AssertionError(f"caar_ring {tag}: {errs} > {CAAR_TOL} or "
                                 "not the two launches' bits")
        worst = max(worst, *errs.values())
        worst_abs = max(worst_abs, *(float((a - b).abs().max()) for a, b in
                                     zip(got, want) if a is not None))
        del want, got, two, tw
    kacc = [x.clone() for x in acc]
    ring_pair = lambda: caar_ring_packed_t4(
        scal, meta, s0, sm1, qdp, pecnd, *kacc, dvv, rsp, fix)
    ring_mix = lambda: caar_ring_packed_t4(
        scal, meta, s0, None, qdp, pecnd, *kacc, dvv, rsp, fix, single=True,
        emit_phi=False, mix=(mx4, ca, cb))
    ring_ms, ring_mix_ms = cuda_ms(ring_pair, 20), cuda_ms(ring_mix, 20)
    # the launch clears its flags, so a graph of it replays correctly
    ring_graph, ring_mix_graph = graph_ms(ring_pair, 20), graph_ms(ring_mix,
                                                                   20)

    def two_launch(mix=None, **kw):
        s1, *_, slab = caar_t4_cuda(scal, meta, s0, None if kw else sm1,
                                    qdp, pecnd, *kacc, dvv, fix=fix, **kw)
        return dss_sweep_nomerge_cuda(s1, rsp, fix, mix)

    two_mix = lambda: two_launch((mx4, ca, cb), single=True, emit_phi=False)
    two_ms, two_graph = cuda_ms(two_launch, 20), graph_ms(two_launch, 20)
    two_mix_graph = graph_ms(two_mix, 20)
    p_ms = cuda_ms(lambda: caar_ring_plain(scal, meta, s0, sm1, qdp, pecnd,
                                           *acc, dvv, rsp, fix), 5)
    # the CAAR step's 21 rows with w in place of s1, the 13 meta rows, dvv,
    # 3 scalars, fix_rank, the slab and the rspheremp rows; with mix 16 rows
    # (the stage without phi) plus the 4 of mx
    nb_ring = lambda rows: (rows * k + 13 + nr) * e16 * 4 + 16 * 4 + 3 * 4 \
        + e16 * 4 + n * 4 * k * 4
    ops = (CAAR_OPS_PER_POINT + 4 * SWEEP_OPS_PER_POINT) * e16 * k
    bnd, by = bound_ms(nb_ring(21), ops)
    bnd_mix, _ = bound_ms(nb_ring(20), ops + 4 * MIX_OPS_PER_POINT * e16 * k)
    print(f"phase 15 caar_ring ne{cs.ne}x{k} pair: kernel {ring_ms:.4f} ms "
          f"(bound {bnd:.4f} ms, {by}), from a graph {ring_graph:.4f}; the "
          f"two launches it fuses {two_ms:.4f} ms, graph {two_graph:.4f}; "
          f"stage without phi with mix {ring_mix_ms:.4f} ms, graph "
          f"{ring_mix_graph:.4f} (bound {bnd_mix:.4f} ms; the two launches "
          f"graph {two_mix_graph:.4f}); plain {p_ms:.4f} ms, library none. "
          f"The design before: {PARENT['caar_ring']}")
    # the same at ne28 (588 + 4 tiles against ne30's 675 + 4)
    (sc28, mt28, q28, pec28, _), (a28, b28), acc28, plan28, rsp28 = \
        bench.make_assembled_problem(28, k, dev)
    fix28 = fix_tables(plan28, dev)
    acc28 = list(acc28)
    ne28 = dict(
        caar_ms=cuda_ms(lambda: caar_t4_cuda(sc28, mt28, a28, b28, q28, pec28,
                                             *acc28, dvv, fix=fix28), 20),
        two_launch_ms=cuda_ms(lambda: dss_sweep_nomerge_cuda(caar_t4_cuda(
            sc28, mt28, a28, b28, q28, pec28, *acc28, dvv, fix=fix28)[0],
            rsp28, fix28), 20),
        ring_ms=cuda_ms(lambda: caar_ring_packed_t4(
            sc28, mt28, a28, b28, q28, pec28, *acc28, dvv, rsp28, fix28), 20))
    rp28 = ring_plan(a28.shape[1], k, 28)
    print(f"phase 15 caar_ring ne28x{k} ({rp28.nb} + {rp28.geo.halo} "
          f"blocks): kernel {ne28['ring_ms']:.4f} "
          f"ms, the two launches {ne28['two_launch_ms']:.4f} ms, the CAAR "
          f"kernel alone {ne28['caar_ms']:.4f} ms")
    del sc28, mt28, q28, pec28, a28, b28, acc28, plan28, rsp28, fix28
    rows["caar_ring_packed_t4"] = dict(
        route="cuda", source="tinman_sandbox_tpu_torch/csrc/caar.cu",
        replaces="tinman_sandbox_tpu/kernels/ring_fused.py:189",
        max_abs_err=worst_abs, max_scaled_err=worst, ms=ring_ms,
        plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None,
        two_launch_ms=two_ms, stage_mix_ms=ring_mix_ms,
        stage_mix_bound_ms=bnd_mix, graph_ms=ring_graph,
        stage_mix_graph_ms=ring_mix_graph, two_launch_graph_ms=two_graph,
        stage_mix_two_launch_graph_ms=two_mix_graph,
        blocks_per_sm=occ["caar_ring_kernel"][0],
        caar_kernel_blocks_per_sm=occ["caar_chunk_kernel"][0],
        **{f"ne28_{key}": v for key, v in ne28.items()})
    del kacc, mx4

    # -- the tracer ring kernel at qsize 1 and QSIZE_TALL, the run's dt and a
    # long one, with and without mix (qsize 1: the first tracer of the stack)
    _, ps0, q_tall, _, _, _ = bench.make_prim_problem(cs.ne, k, dev, DYN_DT,
                                                      QSIZE_TALL)
    kw = dict(wind_rows=(0, 1))
    for qsize in (1, QSIZE_TALL):
        tag0 = f"ne{cs.ne}x{k} qsize {qsize}"
        q = q_tall[:qsize * k].contiguous()
        mx = torch.rand(q.shape, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        div = (q - tracer_euler_plain(meta, ps0, ps0, q, dvv, 1.0, k,
                                      fold_sph=False, wind_rows=(0, 1)))
        dt_long = 0.5 * float(q.abs().max()) / float(div.abs().max())
        del div
        worst = worst_abs = 0.0
        for dt, mixed in ((DYN_DT, False), (dt_long, False), (dt_long, True)):
            tag = f"{tag0} dt {dt:.4g} mix={'yes' if mixed else 'no'}"
            mix = (mx, ca, cb) if mixed else None
            want, wslab = tracer_ring_plain(meta, ps0, ps0, q, dvv, dt, k, rsp,
                                            fix, mix=mix, **kw)
            got, slab = tracer_ring_packed_t(meta, ps0, ps0, q, dvv, dt, k,
                                             rsp, fix, mix=mix, **kw)
            e, eslab = tracer_euler_cuda(meta, ps0, ps0, q, dvv, dt, k,
                                         fix=fix, **kw)
            same = torch.equal(got, dss_sweep_nomerge_cuda(e, rsp, fix, mix)) \
                and torch.equal(slab, eslab)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"tracer_ring {tag}: non-finite")
            err = max(max(scaled_err(a, b) for a, b in zip(got.split(k),
                                                            want.split(k))),
                      max(scaled_err(a, b) for a, b in zip(
                          slab.split(k, 1), wslab.split(k, 1))))
            print(f"phase 15 tracer_ring {tag}: bit for bit the two launches: "
                  f"{same}; worst scaled error of a tracer block {err:.2e}")
            if err > CAAR_TOL or not same:
                raise AssertionError(f"tracer_ring {tag}: {err} > {CAAR_TOL} "
                                     "or not the two launches' bits")
            worst = max(worst, err)
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            del want, wslab, got, slab, e, eslab
        replays = tracer_ring_replays(meta, ps0, q, mx, dvv, dt_long, k, rsp,
                                      fix, (ca, cb),
                                      f"{tag0} dt {dt_long:.4g}")
        reps = 50 if qsize == 1 else 10
        run = lambda: tracer_ring_packed_t(
            meta, ps0, ps0, q, dvv, DYN_DT, k, rsp, fix, **kw)
        run_mix = lambda: tracer_ring_packed_t(
            meta, ps0, ps0, q, dvv, DYN_DT, k, rsp, fix, mix=(mx, ca, cb),
            **kw)
        two = lambda: dss_sweep_nomerge_cuda(tracer_euler_cuda(
            meta, ps0, ps0, q, dvv, DYN_DT, k, fix=fix, **kw)[0], rsp, fix)
        two_mix = lambda: dss_sweep_nomerge_cuda(tracer_euler_cuda(
            meta, ps0, ps0, q, dvv, DYN_DT, k, fix=fix, **kw)[0], rsp, fix,
            (mx, ca, cb))
        t_ms, tm_ms, two_ms = (cuda_ms(run, reps), cuda_ms(run_mix, reps),
                               cuda_ms(two, reps))
        # the launch clears its state, so a graph of it replays correctly
        t_graph, tm_graph = graph_ms(run, reps), graph_ms(run_mix, reps)
        two_graph, two_mix_graph = graph_ms(two, reps), graph_ms(two_mix,
                                                                  reps)
        p_ms = cuda_ms(lambda: tracer_ring_plain(
            meta, ps0, ps0, q, dvv, DYN_DT, k, rsp, fix, **kw), 3)
        qk = qsize * k
        # the 2 wind blocks, q read, w written (and mx read), 7 meta rows,
        # the rspheremp rows, dvv, fix_rank and the slab
        nbt = lambda blocks: (blocks * k + 7 + nr) * e16 * 4 + 16 * 4 \
            + e16 * 4 + n * qk * 4
        ops = (TRACER_OPS_PER_POINT + SWEEP_OPS_PER_POINT) * qk * e16
        bnd, by = bound_ms(nbt(2 + 2 * qsize), ops)
        bnd_m, _ = bound_ms(nbt(2 + 3 * qsize), ops + MIX_OPS_PER_POINT * qk
                            * e16)
        tplan = tracer_ring_plan(e16, k, cs.ne, qsize)
        print(f"phase 15 tracer_ring {tag0}: kernel {t_ms:.4f} ms, from a "
              f"graph {t_graph:.4f} (bound {bnd:.4f} ms, {by}), with mix "
              f"{tm_ms:.4f} ms, graph {tm_graph:.4f} (bound {bnd_m:.4f} ms); "
              f"the two launches it fuses {two_ms:.4f} ms, graph "
              f"{two_graph:.4f} (with mix {two_mix_graph:.4f}); plain "
              f"{p_ms:.4f} ms, library none; {tplan.items} items of "
              f"{tplan.group * 8} levels x {tplan.tracers} tracers + halo "
              f"{tplan.geo.halo} + lag {tplan.lag} = {tplan.tickets} blocks; "
              f"{replays} graph replays on fresh inputs bit for bit the two "
              "launches")
        pre = "" if qsize == 1 else "tall_"
        r = rows.setdefault("tracer_ring_packed_t", dict(
            route="cuda", source="tinman_sandbox_tpu_torch/csrc/tracer.cu",
            replaces="tinman_sandbox_tpu/kernels/ring_fused.py:369",
            max_abs_err=0.0, library_ms=None,
            blocks_per_sm=occ["tracer_ring_kernel"][0]))
        r.update({f"{pre}max_scaled_err": worst, f"{pre}ms": t_ms,
                  f"{pre}plain_ms": p_ms, f"{pre}bound_ms": bnd,
                  f"{pre}mix_ms": tm_ms, f"{pre}mix_bound_ms": bnd_m,
                  f"{pre}two_launch_ms": two_ms, f"{pre}graph_ms": t_graph,
                  f"{pre}mix_graph_ms": tm_graph,
                  f"{pre}two_launch_graph_ms": two_graph,
                  f"{pre}two_launch_mix_graph_ms": two_mix_graph,
                  f"{pre}graph_replays_bitwise": replays})
        if qsize == 1:
            r["bound_by"] = by
        else:
            r["tall_qsize"] = qsize
        r["max_abs_err"] = max(r["max_abs_err"], worst_abs)
        del q, mx
        torch.cuda.empty_cache()
    rows["tracer_ring_packed_t"]["two_streams_bitwise"] = rings_on_two_streams(
        const, acc, ps0, q_tall, rsp, fix, k)
    del q_tall

    # -- the merge-free sweep and the patch at 288, 72 and 2,520 rows
    abs_sw = abs_pt = 0.0
    for rows_k in (4 * k, k, QSIZE_TALL * k):
        x, mx = rnd(rows_k), rnd(rows_k)
        slab = dss_extract_cuda(x, fix)
        vd = dss_fixup_cuda(slab, fix, rsp)
        tall = rnd(rows_k + k)
        for label, mix in (("", None), (" mix", (mx, ca, cb)),
                           (" in place", (tall, 1.0, -1e-3))):
            ref = tall.clone() if label == " in place" else None
            want = dss_sweep_nomerge_plain(
                x, rsp, fix, mix if ref is None else (ref, 1.0, -1e-3))
            got = dss_sweep_nomerge_cuda(x, rsp, fix, mix)
            torch.cuda.synchronize()
            abs_sw = max(abs_sw, float((got - want).abs().max()))
            if not torch.equal(got, want) or (ref is not None and (
                    got is not tall or not torch.equal(tall[rows_k:],
                                                       ref[rows_k:]))):
                raise AssertionError(f"dss_sweep_nomerge [{rows_k}]{label} "
                                     "differs from its plain version")
            del want, got
        for label, mix in (("", None), (" mix", (mx, ca, cb))):
            w0 = dss_sweep_nomerge_cuda(x, rsp, fix, mix)
            want = dss_merge_patch_plain(w0.clone(), vd, fix, mix)
            got = dss_merge_patch_cuda(w0, vd, fix, mix)
            split = dss_structured_t_cuda_patch(x, slab, plan, rsp, mix)
            merged = dss_structured_t_cuda_pre(x, slab, plan, rsp, mix)
            torch.cuda.synchronize()
            abs_pt = max(abs_pt, float((got - want).abs().max()))
            if got is not w0 or not torch.equal(got, want):
                raise AssertionError(f"dss_merge_patch [{rows_k}]{label} "
                                     "differs from its plain version")
            if not torch.equal(split, merged):
                raise AssertionError(f"split DSS [{rows_k}]{label} differs "
                                     "from the merged DSS")
            del w0, want, got, split, merged
        reps = 50 if rows_k < 1000 else 10
        sw_ms = cuda_ms(lambda: dss_sweep_nomerge_cuda(x, rsp, fix), reps)
        swm_ms = cuda_ms(lambda: dss_sweep_nomerge_cuda(x, rsp, fix,
                                                        (mx, ca, cb)), reps)
        swp_ms = cuda_ms(lambda: dss_sweep_nomerge_plain(x, rsp, fix), 3)
        w0 = dss_sweep_nomerge_cuda(x, rsp, fix)
        pt = patch_times(w0, vd, fix, mx, ca, cb, reps)
        ptp_ms = cuda_ms(lambda: dss_merge_patch_plain(w0, vd, fix), reps)
        if not torch.equal(w0, dss_merge_patch_plain(w0.clone(), vd, fix)):
            raise AssertionError("index_copy_ is not the patch")
        # x read, w written (and mx read), the rspheremp rows
        sw_b, sw_by = bound_ms(2 * rows_k * e16 * 4 + nr * e16 * 4,
                               SWEEP_OPS_PER_POINT * rows_k * e16)
        swm_b, _ = bound_ms(3 * rows_k * e16 * 4 + nr * e16 * 4,
                            (SWEEP_OPS_PER_POINT + MIX_OPS_PER_POINT)
                            * rows_k * e16)
        # vd read, the fix lanes written, fix_lanes (and mx at them)
        pt_b, pt_by = bound_ms(2 * rows_k * n * 4 + n * 4, 0)
        ptm_b, _ = bound_ms(3 * rows_k * n * 4 + n * 4,
                            MIX_OPS_PER_POINT * rows_k * n)
        floor = patch_floor_ms(fix.fix_lanes, rows_k, e16, False)
        floor_m = patch_floor_ms(fix.fix_lanes, rows_k, e16, True)
        dense = ""
        if rows_k == QSIZE_TALL * k:
            # the same kernel and counts on the first nfix lanes of a row:
            # what the scattered sectors cost
            ar = np.arange(n)
            dt = make_fix_tables(cs.ne, e16, ar, ar, np.zeros((n, 4)), dev)
            pt["dense_lanes_graph_ms"] = graph_ms(
                lambda: dss_merge_patch_cuda(w0, vd, dt), reps)
            dense = (f"; the same kernel on {n} contiguous lanes from a "
                     f"graph {pt['dense_lanes_graph_ms']:.4f} ms")
        print(f"phase 15 dss_sweep_nomerge ne{cs.ne} [{rows_k}, {e16}]: "
              f"bitwise (new, mix, in place); kernel {sw_ms:.4f} ms (bound "
              f"{sw_b:.4f} ms, {sw_by}), with mix {swm_ms:.4f} (bound "
              f"{swm_b:.4f}); plain {swp_ms:.4f} ms")
        print(f"phase 15 dss_merge_patch ne{cs.ne} [{rows_k}, {n} fix lanes]: "
              f"bitwise; the split DSS bitwise the merged one; kernel by "
              f"events {pt['ms']:.4f} ms, from a graph {pt['graph_ms']:.4f} "
              f"(bound {pt_b:.4f} ms, {pt_by}; sector floor {floor:.4f}); "
              f"with mix {pt['mix_ms']:.4f}, graph {pt['mix_graph_ms']:.4f} "
              f"(bound {ptm_b:.4f}, sector floor {floor_m:.4f}); plain "
              f"{ptp_ms:.4f} ms; library index_copy_ {pt['library_ms']:.4f} "
              f"ms, graph {pt['library_graph_ms']:.4f}{dense}; the host's "
              f"time per call: kernel {pt['host_ms']:.4f} ms, "
              f"index_copy_ {pt['library_host_ms']:.4f}")
        sfx = "" if rows_k == 4 * k else f"rows{rows_k}_"
        rows.setdefault("dss_sweep_nomerge_cuda", dict(
            route="cuda", source="tinman_sandbox_tpu_torch/csrc/dss.cu",
            replaces="tinman_sandbox_tpu/kernels/dss_pallas.py:335",
            library_ms=None)).update({
                f"{sfx}ms": sw_ms, f"{sfx}plain_ms": swp_ms,
                f"{sfx}bound_ms": sw_b, f"{sfx}bound_by": sw_by,
                f"{sfx}mix_ms": swm_ms, f"{sfx}mix_bound_ms": swm_b})
        rows.setdefault("dss_merge_patch_cuda", dict(
            route="cuda", source="tinman_sandbox_tpu_torch/csrc/dss.cu",
            replaces="tinman_sandbox_tpu/kernels/dss_pallas.py:1477")).update({
                f"{sfx}plain_ms": ptp_ms, f"{sfx}bound_ms": pt_b,
                f"{sfx}bound_by": pt_by, f"{sfx}mix_bound_ms": ptm_b,
                f"{sfx}sector_floor_ms": floor,
                f"{sfx}mix_sector_floor_ms": floor_m,
                **{f"{sfx}{key}": v for key, v in pt.items()}})
        del x, mx, slab, vd, tall, w0
        torch.cuda.empty_cache()
    rows["dss_sweep_nomerge_cuda"]["max_abs_err"] = abs_sw
    rows["dss_merge_patch_cuda"]["max_abs_err"] = abs_pt
    return rows


def phase_ring_path(dev, cs):
    """The ring paths at ne30 x 72, each step bit for bit the same chain on
    the two-launch kernels: 10 assembled steps, 10 SSPRK3 steps, 3 tracer
    steps at qsize 1 and QSIZE_TALL, the split DSS; the launches of each
    ring step; ring against two-launch times; ``bench --ne 30 --ring``
    beside ``bench --ne 30``. Returns the two bench results (ring,
    two-launch)."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (
        caar_dss_ring_t4, caar_dss_structured_packed_t4, continuity_error_t,
        ssprk3_packed_t4, ssprk3_ring_t4, ssprk3_tracer_packed_t,
        ssprk3_tracer_ring_t)
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_fixup_cuda, dss_merge_patch_cuda, dss_structured_t_cuda,
        dss_structured_t_cuda_patch, dss_sweep_cuda, dss_sweep_nomerge_cuda,
        dss_extract_cuda, fix_tables)
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
    from tinman_sandbox_tpu_torch.kernels.ring_fused import (
        caar_ring_packed_t4, tracer_ring_packed_t)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    watched = (caar_ring_packed_t4, tracer_ring_packed_t, dss_fixup_cuda,
               dss_merge_patch_cuda, dss_sweep_cuda, caar_t4_cuda,
               tracer_euler_cuda)

    def ring_step(fn):
        """fn() and the launches it made, by wrapper."""
        before = [w.launches for w in watched]
        out = fn()
        return out, {w.__name__: w.launches - b
                     for w, b in zip(watched, before) if w.launches - b}

    def check_launches(label, got, ring, per):
        want = {ring.__name__: per, "dss_fixup_cuda": per,
                "dss_merge_patch_cuda": per}
        if got != want:
            raise AssertionError(f"{label}: launches {got} != {want}")

    def cont(label, x, i):
        c = continuity_error_t(x, cs.gdof)
        if c != 0.0:
            raise AssertionError(f"{label}: continuity {c} after step {i}")

    # -- 10 chained assembled steps
    const, levels, acc, plan, rsp = bench.make_assembled_problem(
        cs.ne, NLEV, dev)
    scal, meta, qdp, pecnd, dvv = const
    (r0, rm1), ra = levels, [a.clone() for a in acc]
    (t0, tm1), ta = levels, [a.clone() for a in acc]
    for i in range(10):
        (r1, rphi, *ra), got = ring_step(lambda: caar_dss_ring_t4(
            scal, meta, r0, rm1, qdp, pecnd, *ra, dvv, plan, rsp))
        check_launches("assembled ring step", got, caar_ring_packed_t4, 1)
        t1, tphi, *ta = caar_dss_structured_packed_t4(
            scal, meta, t0, tm1, qdp, pecnd, *ta, dvv, plan, rsp)
        if not (torch.equal(r1, t1) and torch.equal(rphi, tphi)
                and all(torch.equal(a, b) for a, b in zip(ra, ta))):
            raise AssertionError(f"assembled ring chain differs from the "
                                 f"two-launch chain at step {i + 1}")
        cont("assembled ring chain", r1, i + 1)
        r0, rm1, t0, tm1 = r1, r0, t1, t0
    if not all(bool(torch.isfinite(x).all()) for x in (r0, rphi, *ra)):
        raise AssertionError("assembled ring chain: non-finite")
    moved = scaled_err(r0, levels[0])
    print(f"phase 16 assembled ring chain ne{cs.ne}x{NLEV} x10: bit for bit "
          f"the two-launch chain after every step, continuity 0; state moved "
          f"{moved:.2e}; launches per step {json.dumps(got)}")
    kacc = [a.clone() for a in acc]
    s0, sm1 = levels
    asm_ring = cuda_ms(lambda: caar_dss_ring_t4(scal, meta, s0, sm1, qdp,
                                                pecnd, *kacc, dvv, plan, rsp),
                       20)
    asm_two = cuda_ms(lambda: caar_dss_structured_packed_t4(
        scal, meta, s0, sm1, qdp, pecnd, *kacc, dvv, plan, rsp), 20)
    del r0, rm1, t0, tm1, r1, t1, rphi, tphi, ra, ta, kacc, levels

    # -- 10 chained SSPRK3 steps from a continuous state: the prim problem's
    # (the dynamics problem with QSIZE_TALL projected tracers, the first of
    # them its moisture)
    (scal, meta, pecnd, dvv), s0, q_tall, acc, plan, rsp = \
        bench.make_prim_problem(cs.ne, NLEV, dev, DYN_DT, QSIZE_TALL)
    qdp = q_tall[:NLEV]
    rs, ra = s0, [a.clone() for a in acc]
    ts, ta = s0, [a.clone() for a in acc]
    for i in range(10):
        (rs, rphi, *ra), got = ring_step(lambda: ssprk3_ring_t4(
            scal, meta, rs, qdp, pecnd, *ra, dvv, plan, rsp))
        check_launches("SSPRK3 ring step", got, caar_ring_packed_t4, 3)
        ts, tphi, *ta = ssprk3_packed_t4(scal, meta, ts, qdp, pecnd, *ta, dvv,
                                         plan, rsp)
        if not (torch.equal(rs, ts) and torch.equal(rphi, tphi)
                and all(torch.equal(a, b) for a, b in zip(ra, ta))):
            raise AssertionError(f"SSPRK3 ring chain differs from the "
                                 f"two-launch chain at step {i + 1}")
        cont("SSPRK3 ring chain", rs, i + 1)
    if not all(bool(torch.isfinite(x).all()) for x in (rs, rphi, *ra)):
        raise AssertionError("SSPRK3 ring chain: non-finite")
    print(f"phase 16 SSPRK3 ring chain ne{cs.ne}x{NLEV} x10: bit for bit the "
          f"two-launch chain after every step, continuity 0; state moved "
          f"{scaled_err(rs, s0):.2e}; launches per step {json.dumps(got)}")
    kacc = [a.clone() for a in acc]
    rk_ring = cuda_ms(lambda: ssprk3_ring_t4(scal, meta, s0, qdp, pecnd,
                                             *kacc, dvv, plan, rsp), 10)
    rk_two = cuda_ms(lambda: ssprk3_packed_t4(scal, meta, s0, qdp, pecnd,
                                              *kacc, dvv, plan, rsp), 10)
    del rs, ts, rphi, tphi, ra, ta, kacc

    # -- 3 chained tracer steps at qsize 1 and QSIZE_TALL, and the split DSS
    # on the same stack
    times = {}
    fix = fix_tables(plan, dev)
    sph = meta[META_COLS.index("spheremp")]
    ps0 = s0
    for qsize in (1, QSIZE_TALL):
        q0 = q_tall[:qsize * NLEV].contiguous()
        rq = tq = q0
        for i in range(3):
            rq, got = ring_step(lambda: ssprk3_tracer_ring_t(
                dvv, meta, ps0, ps0, rq, plan, rsp, DYN_DT, NLEV,
                wind_rows=(0, 1)))
            check_launches("tracer ring step", got, tracer_ring_packed_t, 3)
            tq = ssprk3_tracer_packed_t(dvv, meta, ps0, ps0, tq, plan, rsp,
                                        DYN_DT, NLEV, wind_rows=(0, 1))
            if not torch.equal(rq, tq):
                raise AssertionError(f"tracer ring chain qsize {qsize} "
                                     f"differs at step {i + 1}")
            cont(f"tracer ring chain qsize {qsize}", rq, i + 1)
        if not bool(torch.isfinite(rq).all()):
            raise AssertionError("tracer ring chain: non-finite")
        print(f"phase 16 tracer ring chain ne{cs.ne}x{NLEV} qsize {qsize} x3: "
              f"bit for bit the two-launch chain after every step, continuity"
              f" 0; tracer moved {scaled_err(rq, q0):.2e}; launches per step "
              f"{json.dumps(got)}")
        reps = 10 if qsize == 1 else 2
        times[qsize] = (
            cuda_ms(lambda: ssprk3_tracer_ring_t(
                dvv, meta, ps0, ps0, q0, plan, rsp, DYN_DT, NLEV,
                wind_rows=(0, 1)), reps),
            cuda_ms(lambda: ssprk3_tracer_packed_t(
                dvv, meta, ps0, ps0, q0, plan, rsp, DYN_DT, NLEV,
                wind_rows=(0, 1)), reps))
        # the split DSS of the stack, as it projects the tracers
        x = (q0 * sph).contiguous()
        split = dss_structured_t_cuda_patch(x, dss_extract_cuda(x, fix), plan,
                                            rsp)
        if not torch.equal(split, dss_structured_t_cuda(x, plan, rsp)):
            raise AssertionError(f"split DSS qsize {qsize} differs from the "
                                 "merged DSS")
        print(f"phase 16 split DSS ne{cs.ne} [{qsize * NLEV}, "
              f"{cs.nelem * 16}]: bit for bit the merged DSS")
        del q0, rq, tq, x, split
        torch.cuda.empty_cache()
    del q_tall
    if dss_sweep_nomerge_cuda.launches <= 0:
        raise AssertionError("the split DSS launched no merge-free sweep")
    print(f"phase 16 ring vs two-launch step (events, ms): assembled "
          f"{asm_ring:.4f} / {asm_two:.4f}; SSPRK3 {rk_ring:.4f} / "
          f"{rk_two:.4f}; tracer qsize 1 {times[1][0]:.4f} / "
          f"{times[1][1]:.4f}; tracer qsize {QSIZE_TALL} "
          f"{times[QSIZE_TALL][0]:.4f} / {times[QSIZE_TALL][1]:.4f}. The "
          f"CAAR ring's design before: {PARENT['caar_ring']}; "
          f"{PARENT['ring_bench']}")

    results = []
    for extra in (["--ring"], []):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = bench.main(["--ne", str(cs.ne), "--nlev", str(NLEV),
                              "--nexec", "300", "--reps", "3"] + extra)
        print("phase 16 bench " + buf.getvalue().strip())
        if res["ring"] != bool(extra):
            raise AssertionError(f"bench {extra}: {res}")
        results.append(res)
    launches = results[0]["kernel_launches"]
    if launches["dss_sweep_cuda"] or launches["caar_t4_cuda"] or \
            not launches["caar_ring_packed_t4"] == \
            launches["dss_merge_patch_cuda"] == launches["dss_fixup_cuda"] > 0:
        raise AssertionError(f"bench --ring launches: {launches}")
    return results, dict(assembled_ring_ms=asm_ring,
                         assembled_two_launch_ms=asm_two,
                         ssprk3_ring_ms=rk_ring, ssprk3_two_launch_ms=rk_two,
                         tracer_ring_ms=times[1][0],
                         tracer_two_launch_ms=times[1][1],
                         tall_tracer_ring_ms=times[QSIZE_TALL][0],
                         tall_tracer_two_launch_ms=times[QSIZE_TALL][1])


def phase_banded_kernels(dev, cs):
    """The multi-device DSS kernels, each bit for bit its plain version:
    the banded sweep (merged and merge-free, with and without mix, 216
    rows in place into a 288-row state) and the shard-local patch (with
    and without mix, a taller w) on every shard of ne30 x 72 with m = 2
    bands over N = 12 shards at 288, 216, 72 and 2,520 rows, and of the
    multi-chunk ne32 with m = 4 over N = 6 (four chunks a shard: first,
    middle, middle, last bands) at 288 rows; each timed over the whole
    sphere's shards against its bound, its plain version, ``dss_sweep_cuda``
    on the same sphere in one launch and (the patch) ``index_copy_``.
    Returns the three rows."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.dist import (
        LocalMesh, build_cubed_sphere, make_structured_plan, rsp_lanes_2f,
        shard_packed_t4)
    from tinman_sandbox_tpu_torch.dist.banded_t4 import (
        _band_shard, _banded_tables, band_extend)
    from tinman_sandbox_tpu_torch.dist.sharded_t4 import PLAIN
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_cuda, dss_fixup_cuda, dss_patch_tiles_cuda,
        dss_sweep_banded_cuda, dss_sweep_banded_nomerge_cuda, dss_sweep_cuda,
        fix_tables)

    k = NLEV
    gen = torch.Generator(device=dev).manual_seed(18)
    ca, cb = float(np.float32(1.0 / 3.0)), float(np.float32(2.0 / 3.0))
    rows = {}
    worst = {"sweep": 0.0, "nomerge": 0.0, "patch": 0.0}

    def same(label, got, want, what):
        worst[what] = max(worst[what], float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"{label} differs from its plain version")

    ne32 = build_cubed_sphere(32, dtype=torch.float32, device=dev)
    for grid, m, N, heights in ((cs, 2, 12, (4 * k, 3 * k, k, QSIZE_TALL * k)),
                                (ne32, 4, 6, (4 * k,))):
        ne, e16 = grid.ne, grid.nelem * 16
        plan = make_structured_plan(grid.gdof, ne)
        rsp = torch.from_numpy(rsp_lanes_2f(grid.geometry.spheremp, grid.gdof,
                                            grid.ndof)).to(dev)
        mesh = LocalMesh(N, dev)
        T = _banded_tables(plan, m, N)
        bts = [_band_shard(plan, m, N, s, str(dev)).band for s in range(N)]
        (rsps,) = shard_packed_t4(mesh, rsp)
        lanes = T["cps"] * T["bl"]
        nr = rsp.shape[0]
        tag0 = (f"ne{ne} m={m} N={N} (cps {T['cps']}, bl {T['bl']}, "
                f"variants {sorted(set(T['first_last']))})")
        for rk in heights:
            x = torch.randn(rk, e16, generator=gen, device=dev)
            xe = band_extend(mesh, plan, m, shard_packed_t4(mesh, x)[0])
            mxs = shard_packed_t4(mesh, torch.randn(
                rk, e16, generator=gen, device=dev))[0]
            vds = [torch.randn(rk, bt.fix.nfix, generator=gen, device=dev)
                   for bt in bts]
            for s, bt in enumerate(bts):
                tag = f"{tag0} shard {s} [{rk}]"
                x_ext, r, vd, mx = xe[s], rsps[s], vds[s], mxs[s]
                for mix in (None, (mx, ca, cb)):
                    mt = " mix" if mix else ""
                    same(f"dss_sweep_banded {tag}{mt}",
                         dss_sweep_banded_cuda(x_ext, r, vd, bt, mix),
                         PLAIN.banded(x_ext, r, vd, bt, mix), "sweep")
                    w0 = dss_sweep_banded_nomerge_cuda(x_ext, r, bt, mix)
                    same(f"dss_sweep_banded_nomerge {tag}{mt}", w0,
                         PLAIN.banded_nomerge(x_ext, r, bt, mix), "nomerge")
                    want = PLAIN.patch(w0.clone(), vd, bt.fix, mix)
                    got = dss_patch_tiles_cuda(w0, vd, bt.fix, mix)
                    same(f"dss_patch_tiles {tag}{mt}", got, want, "patch")
                if rk != 3 * k:
                    continue
                # in place into the 288-row state, its further rows kept
                tall = torch.randn(4 * k, lanes, generator=gen, device=dev)
                ref = tall.clone()
                for fn, args, what in (
                        (dss_sweep_banded_cuda, (vd,), "sweep"),
                        (dss_sweep_banded_nomerge_cuda, (), "nomerge")):
                    t = tall.clone()
                    got = fn(x_ext, r, *args, bt, (t, 1.0, -1e-3))
                    want = (PLAIN.banded(x_ext, r, vd, bt, (ref, 1.0, -1e-3))
                            if args else PLAIN.banded_nomerge(
                                x_ext, r, bt, (ref, 1.0, -1e-3)))
                    if got is not t:
                        raise AssertionError(f"{fn.__name__} {tag}: not in "
                                             "place")
                    same(f"{fn.__name__} {tag} in place", got, want, what)
                for mix in (None, (mx, ca, cb)):
                    tw, mt = tall.clone(), " mix" if mix else ""
                    mix_t = mix and (torch.cat([mx, mx[:k]]), ca, cb)
                    want = PLAIN.patch(tw.clone(), vd, bt.fix, mix_t)
                    got = dss_patch_tiles_cuda(tw, vd, bt.fix, mix_t)
                    same(f"dss_patch_tiles {tag} taller w{mt}", got, want,
                         "patch")
                del tall, ref, t, tw
            print(f"phase 18 {tag0} [{rk}]: the banded sweep (merged, "
                  f"merge-free; with and without mix"
                  + ("; in place into 288 rows" if rk == 3 * k else "")
                  + ") and the patch (with and without mix"
                  + ("; a taller w" if rk == 3 * k else "")
                  + ") bit for bit their plain versions on every shard")
            # the whole sphere: one launch a shard
            reps = 3 if rk > 1000 else 20
            sw = lambda: [dss_sweep_banded_cuda(a, b, c, d)
                          for a, b, c, d in zip(xe, rsps, vds, bts)]
            swm = lambda: [dss_sweep_banded_cuda(a, b, c, d, (e, ca, cb))
                           for a, b, c, d, e in zip(xe, rsps, vds, bts, mxs)]
            nm = lambda: [dss_sweep_banded_nomerge_cuda(a, b, d)
                          for a, b, d in zip(xe, rsps, bts)]
            w0s = nm()
            pt = lambda: [dss_patch_tiles_cuda(w, c, d.fix)
                          for w, c, d in zip(w0s, vds, bts)]
            lib = lambda: [w.index_copy_(1, d.fix.fix_lanes.long(), c)
                           for w, c, d in zip(w0s, vds, bts)]
            t = dict(sweep=cuda_ms(sw, reps), sweep_mix=cuda_ms(swm, reps),
                     nomerge=cuda_ms(nm, reps), patch=cuda_ms(pt, reps),
                     patch_library=cuda_ms(lib, reps),
                     sweep_plain=cuda_ms(lambda: [
                         PLAIN.banded(a, b, c, d) for a, b, c, d in zip(
                             xe, rsps, vds, bts)], 2),
                     nomerge_plain=cuda_ms(lambda: [
                         PLAIN.banded_nomerge(a, b, d) for a, b, d in zip(
                             xe, rsps, bts)], 2),
                     patch_plain=cuda_ms(lambda: [
                         PLAIN.patch(w, c, d.fix) for w, c, d in zip(
                             w0s, vds, bts)], reps))
            # one shard's launch alone, and the single-device merged sweep
            # of the same sphere in one launch
            t["sweep_one_shard"] = cuda_ms(
                lambda: dss_sweep_banded_cuda(xe[0], rsps[0], vds[0], bts[0]),
                reps)
            fix = fix_tables(plan, dev)
            vd1 = dss_fixup_cuda(dss_extract_cuda(x, fix), fix, rsp)
            t["single_device_sweep"] = cuda_ms(
                lambda: dss_sweep_cuda(x, rsp, vd1, fix), reps)
            # the same launches replayed from CUDA graphs: device time alone
            t["sweep_graph"] = graph_ms(sw, reps)
            t["sweep_mix_graph"] = graph_ms(swm, reps)
            t["nomerge_graph"] = graph_ms(nm, reps)
            t["single_device_sweep_graph"] = graph_ms(
                lambda: dss_sweep_cuda(x, rsp, vd1, fix), reps)
            ptm = lambda: [dss_patch_tiles_cuda(w, c, d.fix, (e, ca, cb))
                           for w, c, d, e in zip(w0s, vds, bts, mxs)]
            t.update(patch_graph=graph_ms(pt, reps),
                     patch_mix=cuda_ms(ptm, reps),
                     patch_mix_graph=graph_ms(ptm, reps),
                     patch_library_graph=graph_ms(lib, reps))
            nfix = sum(bt.fix.nfix for bt in bts)
            ext_b = rk * N * T["cps"] * T["ext"] * 4
            # x_ext read, the bands written (and mx read), the rspheremp
            # rows, vd and fix_col
            sb = lambda extra: bound_ms(
                ext_b + (1 + extra) * rk * e16 * 4 + nr * e16 * 4
                + rk * nfix * 4 + e16 * 4,
                (SWEEP_OPS_PER_POINT + extra * MIX_OPS_PER_POINT) * rk * e16)
            (bs, by), (bsm, _) = sb(0), sb(1)
            bn, _ = bound_ms(ext_b + rk * e16 * 4 + nr * e16 * 4,
                             SWEEP_OPS_PER_POINT * rk * e16)
            bp, bpy = bound_ms(2 * rk * nfix * 4 + nfix * 4, 0)
            floor = sum(patch_floor_ms(bt.fix.fix_lanes, rk, lanes, False)
                        for bt in bts)
            print(f"phase 18 {tag0} [{rk}] times over the {N} shards (events,"
                  f" ms): sweep {t['sweep']:.4f} (bound {bs:.4f}, {by}; one "
                  f"shard {t['sweep_one_shard']:.4f}), with mix "
                  f"{t['sweep_mix']:.4f} (bound {bsm:.4f}), merge-free "
                  f"{t['nomerge']:.4f} (bound {bn:.4f}), patch "
                  f"{t['patch']:.4f} (bound {bp:.4f}, sector floor "
                  f"{floor:.4f}; index_copy_ {t['patch_library']:.4f}), with "
                  f"mix {t['patch_mix']:.4f}; plain sweep "
                  f"{t['sweep_plain']:.4f}, merge-free {t['nomerge_plain']:.4f}"
                  f", patch {t['patch_plain']:.4f}; dss_sweep_cuda on the same "
                  f"sphere in one launch {t['single_device_sweep']:.4f}; from "
                  f"CUDA graphs (device time): the {N} sweeps "
                  f"{t['sweep_graph']:.4f} (with mix "
                  f"{t['sweep_mix_graph']:.4f}, merge-free "
                  f"{t['nomerge_graph']:.4f}), dss_sweep_cuda "
                  f"{t['single_device_sweep_graph']:.4f}, the {N} patches "
                  f"{t['patch_graph']:.4f} (with mix "
                  f"{t['patch_mix_graph']:.4f}), index_copy_ "
                  f"{t['patch_library_graph']:.4f}. The banded sweep's "
                  f"design before: {PARENT['banded']}")
            sfx = "" if (ne, rk) == (cs.ne, 4 * k) else f"ne{ne}_rows{rk}_"
            rows.setdefault("dss_sweep_banded_cuda", dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/dss.cu",
                replaces="tinman_sandbox_tpu/kernels/dss_pallas.py:428",
                also_replaces="tinman_sandbox_tpu/kernels/dss_pallas.py:544",
                library_ms=None)).update({
                    f"{sfx}ms": t["sweep"], f"{sfx}plain_ms": t["sweep_plain"],
                    f"{sfx}bound_ms": bs, f"{sfx}bound_by": by,
                    f"{sfx}mix_ms": t["sweep_mix"], f"{sfx}mix_bound_ms": bsm,
                    f"{sfx}mix_graph_ms": t["sweep_mix_graph"],
                    f"{sfx}one_shard_ms": t["sweep_one_shard"],
                    f"{sfx}single_device_sweep_ms":
                        t["single_device_sweep"],
                    f"{sfx}graph_ms": t["sweep_graph"],
                    f"{sfx}single_device_sweep_graph_ms":
                        t["single_device_sweep_graph"]})
            rows.setdefault("dss_sweep_banded_nomerge_cuda", dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/dss.cu",
                replaces="tinman_sandbox_tpu/kernels/dss_pallas.py:190",
                library_ms=None)).update({
                    f"{sfx}ms": t["nomerge"],
                    f"{sfx}plain_ms": t["nomerge_plain"],
                    f"{sfx}graph_ms": t["nomerge_graph"],
                    f"{sfx}bound_ms": bn, f"{sfx}bound_by": "bytes"})
            rows.setdefault("dss_patch_tiles_cuda", dict(
                route="cuda", source="tinman_sandbox_tpu_torch/csrc/dss.cu",
                replaces="tinman_sandbox_tpu/kernels/dss_pallas.py:251"
                )).update({
                    f"{sfx}ms": t["patch"], f"{sfx}plain_ms": t["patch_plain"],
                    f"{sfx}bound_ms": bp, f"{sfx}bound_by": bpy,
                    f"{sfx}library_ms": t["patch_library"],
                    f"{sfx}sector_floor_ms": floor,
                    f"{sfx}graph_ms": t["patch_graph"],
                    f"{sfx}mix_ms": t["patch_mix"],
                    f"{sfx}mix_graph_ms": t["patch_mix_graph"],
                    f"{sfx}library_graph_ms": t["patch_library_graph"]})
            del x, xe, mxs, vds, w0s, vd1
            torch.cuda.empty_cache()
    for name, what in (("dss_sweep_banded_cuda", "sweep"),
                       ("dss_sweep_banded_nomerge_cuda", "nomerge"),
                       ("dss_patch_tiles_cuda", "patch")):
        rows[name]["max_abs_err"] = worst[what]
    return rows


def phase_multidevice_path(dev, cs):
    """The multi-device paths at ne30 x 72 on one card, each step bit for
    bit the single-device port's and continuity exactly 0: 10 chained
    ``caar_dss_banded_t4`` steps over LocalMesh(12), m = 2, overlap off
    and on, from a random projected state; ``caar_dss_sharded_t4`` on
    LocalMesh(6), (3) and (2), overlap off and on; 3 chained
    ``prim_step_banded_t4`` steps (nu 1e15, qsize 1), one with overlap and
    one at qsize 35; ``multichip.dryrun_multichip(8)``; step times by
    events beside the single-device steps. Returns the times."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (
        LocalMesh, caar_dss_banded_t4, caar_dss_sharded_t4,
        caar_dss_structured_packed_t4, continuity_error_t, make_face_mesh,
        prim_step_banded_t4, prim_step_packed_t4, shard_packed_t4,
        unshard_packed_t4)
    from tinman_sandbox_tpu_torch.kernels.dss import dss_structured_t_cuda
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
    from tinman_sandbox_tpu_torch.multichip import dryrun_multichip

    m, N = 2, 12
    mesh = LocalMesh(N, dev)

    def check(label, on, got, want, conts):
        for i, (g, w) in enumerate(zip(got, want)):
            g = unshard_packed_t4(on, g)
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: output {i} differs from the "
                                     f"single-device step by "
                                     f"{float((g - w).abs().max())}")
            if i in conts:
                c = continuity_error_t(g, cs.gdof)
                if c != 0.0:
                    raise AssertionError(f"{label}: continuity {c}")
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label}: non-finite")

    # -- 10 chained assembled steps from a random projected state
    const, levels, acc, plan, rsp = bench.make_assembled_problem(
        cs.ne, NLEV, dev)
    scal, meta, qdp, pecnd, dvv = const
    sph = meta[META_COLS.index("spheremp")]
    levels = [dss_structured_t_cuda((sph * x).contiguous(), plan, rsp)
              for x in levels]
    sh = shard_packed_t4(mesh, meta, qdp, pecnd, rsp)
    for overlap in (False, True):
        (t0, tm1), ta = levels, [a.clone() for a in acc]
        b0, bm1 = shard_packed_t4(mesh, *levels)
        ba = shard_packed_t4(mesh, *acc)
        for i in range(10):
            b1, bphi, *ba = caar_dss_banded_t4(
                scal, sh[0], b0, bm1, sh[1], sh[2], *ba, dvv, plan, sh[3],
                mesh, m, overlap=overlap)
            t1, tphi, *ta = caar_dss_structured_packed_t4(
                scal, meta, t0, tm1, qdp, pecnd, *ta, dvv, plan, rsp)
            check(f"banded assembled chain overlap={overlap} step {i + 1}",
                  mesh, (b1, bphi, *ba), (t1, tphi, *ta), (0,))
            b0, bm1, t0, tm1 = b1, b0, t1, t0
        print(f"phase 19 banded assembled chain ne{cs.ne}x{NLEV} m={m} N={N} "
              f"overlap={overlap} x10: bit for bit the single-device chain "
              f"after every step, continuity 0; state moved "
              f"{scaled_err(t0, levels[0]):.2e}")
    del b0, bm1, b1, t0, tm1, t1, bphi, tphi, ba, ta
    times = {}
    s0s, sm1s = shard_packed_t4(mesh, *levels)
    bacc = shard_packed_t4(mesh, *[a.clone() for a in acc])
    kacc = [a.clone() for a in acc]
    for overlap in (False, True):
        times[f"banded_assembled{'_overlap' if overlap else ''}_ms"] = \
            cuda_ms(lambda: caar_dss_banded_t4(
                scal, sh[0], s0s, sm1s, sh[1], sh[2], *bacc, dvv, plan, sh[3],
                mesh, m, overlap=overlap), 10)
    times["single_device_assembled_ms"] = cuda_ms(
        lambda: caar_dss_structured_packed_t4(scal, meta, *levels, qdp, pecnd,
                                              *kacc, dvv, plan, rsp), 10)
    # replayed from CUDA graphs: the steps' device time alone
    times["banded_assembled_graph_ms"] = graph_ms(
        lambda: caar_dss_banded_t4(scal, sh[0], s0s, sm1s, sh[1], sh[2],
                                   *bacc, dvv, plan, sh[3], mesh, m), 10)
    times["single_device_assembled_graph_ms"] = graph_ms(
        lambda: caar_dss_structured_packed_t4(scal, meta, *levels, qdp, pecnd,
                                              *kacc, dvv, plan, rsp), 10)

    # -- the face-sharded step on 6, 3 and 2 shards
    want = caar_dss_structured_packed_t4(scal, meta, *levels, qdp, pecnd,
                                         *[a.clone() for a in acc], dvv, plan,
                                         rsp)
    for nf in (6, 3, 2):
        fmesh = make_face_mesh(nf, dev)
        fs = shard_packed_t4(fmesh, meta, *levels, qdp, pecnd, *acc, rsp)
        for overlap in (False, True):
            got = caar_dss_sharded_t4(scal, *fs[:5],
                                      *[[a.clone() for a in x]
                                        for x in fs[5:8]],
                                      dvv, plan, fs[8], fmesh,
                                      overlap=overlap)
            check(f"face-sharded N={nf} overlap={overlap}", fmesh, got, want,
                  (0,))
        if nf == 6:
            fa = [[a.clone() for a in x] for x in fs[5:8]]
            times["face_sharded6_ms"] = cuda_ms(
                lambda: caar_dss_sharded_t4(scal, *fs[:5], *fa, dvv, plan,
                                            fs[8], fmesh), 10)
    print(f"phase 19 face-sharded ne{cs.ne}x{NLEV} on 6, 3 and 2 shards, "
          f"overlap off and on: bit for bit the single-device step, "
          f"continuity 0")
    del want, fs, got, sh, s0s, sm1s, bacc, kacc, levels
    torch.cuda.empty_cache()

    # -- 3 chained full model steps (qsize 1), one with overlap, one at
    # qsize QSIZE_TALL
    (scal, meta, pecnd, dvv), s0, q_tall, acc, plan, rsp = \
        bench.make_prim_problem(cs.ne, NLEV, dev, DYN_DT, QSIZE_TALL)
    sh = shard_packed_t4(mesh, meta, pecnd, rsp)
    kw = dict(nu=DYN_NU, nlev=NLEV, dt=DYN_DT)
    for qsize, nsteps, overlap in ((1, 3, False), (1, 1, True),
                                   (QSIZE_TALL, 1, False)):
        q = q_tall[:qsize * NLEV].contiguous()
        ts, tq, ta = s0, q, [a.clone() for a in acc]
        bs, bq = shard_packed_t4(mesh, s0, q)
        ba = shard_packed_t4(mesh, *acc)
        for i in range(nsteps):
            bs, bq, bphi, *ba = prim_step_banded_t4(
                scal, sh[0], bs, bq, sh[1], *ba, dvv, plan, sh[2], mesh, m,
                overlap=overlap, **kw)
            ts, tq, tphi, *ta = prim_step_packed_t4(
                scal, meta, ts, tq, pecnd, *ta, dvv, plan, rsp, **kw)
            check(f"banded prim qsize {qsize} overlap={overlap} step "
                  f"{i + 1}", mesh, (bs, bq, bphi, *ba), (ts, tq, tphi, *ta),
                  (0, 1))
        print(f"phase 19 banded prim ne{cs.ne}x{NLEV} qsize {qsize} m={m} "
              f"N={N} overlap={overlap} x{nsteps}: bit for bit the "
              f"single-device chain after every step, continuity 0 (state "
              f"and tracers); state moved {scaled_err(ts, s0):.2e}, tracers "
              f"{scaled_err(tq, q):.2e}")
        if qsize == 1 and not overlap:
            bs, bq = shard_packed_t4(mesh, s0, q)
            ba = shard_packed_t4(mesh, *[a.clone() for a in acc])
            kacc = [a.clone() for a in acc]
            times["banded_prim_ms"] = cuda_ms(lambda: prim_step_banded_t4(
                scal, sh[0], bs, bq, sh[1], *ba, dvv, plan, sh[2], mesh, m,
                **kw), 5)
            times["single_device_prim_ms"] = cuda_ms(
                lambda: prim_step_packed_t4(scal, meta, s0, q, pecnd, *kacc,
                                            dvv, plan, rsp, **kw), 5)
        del bs, bq, ba, ts, tq, ta, q
        torch.cuda.empty_cache()
    del q_tall, sh
    ran = dryrun_multichip(8, device=dev, tiers=(5, 6, 7))
    print(f"phase 19 dryrun_multichip(8): {json.dumps(ran)}")
    print("phase 19 step times (events, ms; LocalMesh emulates the shards "
          "on one card, one launch a shard: not a scaling result): "
          + ", ".join(f"{a} {b:.4f}" for a, b in times.items())
          + ". With the banded sweep's design before: "
          + PARENT["banded_steps"])
    return times


def ptxas_report(source: str, tag: str) -> list:
    """[(template arguments, registers and spills)] of each instance of the
    kernel ``tag`` in nvcc's report of the build of ``source``; the
    arguments as mangled (ILb1ELb0EE = <true, false>)."""
    from tinman_sandbox_tpu_torch.kernels import _build

    with open(_build.ptxas_log(source)) as f:
        lines = f.read().splitlines()
    found, inst = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            inst = None
            if tag in name:
                m = re.match(r"I(?:L[^E]+E)+E", name.split(tag, 1)[1])
                inst = m.group(0) if m else ""
        elif inst is not None and ("registers" in ln or "spill" in ln):
            found.setdefault(inst, []).append(ln.split(":", 1)[-1].strip())
    if not found:
        raise AssertionError(f"no ptxas report for {tag}")
    return [(i, "; ".join(r)) for i, r in found.items()]


def remap_ptxas() -> str:
    """Registers and spills of the remap kernel's f32 plm packed instance
    (remap_kernel<float, 1, true>), from nvcc's report of the build."""
    from tinman_sandbox_tpu_torch.kernels import _build

    found, inst = [], False
    with open(_build.ptxas_log("remap")) as f:
        for ln in f:
            if "Compiling entry function" in ln:
                inst = "remap_kernelIfLi1ELb1E" in ln
            elif inst and ("registers" in ln or "spill" in ln):
                found.append(ln.split(":", 1)[-1].strip())
    if not found:
        raise AssertionError("no ptxas report for remap_kernel<float, 1, "
                             "true>")
    return "; ".join(found)


def probe_ptxas(plan) -> str:
    """Registers, spills and static shared memory of the plan's instance of
    the probe kernel, from nvcc's report of the build."""
    inst = f"ILi{plan.tm}ELi{plan.tn}ELb{int(plan.resident)}EE"
    found = dict(ptxas_report("probe", "probe_mm_kernel"))
    if inst not in found:
        raise AssertionError(f"no ptxas report for probe_mm_kernel{inst}")
    return found[inst]


def phase_probe_kernels(dev):
    """Phase 20, row 31: the probe kernel against its plain version at the
    probe tool's five shapes with the launch plan of ``probe_plan`` (its
    tile, cluster, k ranges, registers, shared memory, CTAs and waves
    printed), the same bits on a second run, each timed beside its bound,
    its plain version and the same twenty products by cuBLAS; then the
    pipelined mode at ``PROBE_PIPELINED_SHAPES`` on integer operands, bit
    for bit plain. Returns the kernel's row."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.kernels.probe import (
        PROBE_REPS, PROBE_SHAPES, TILES, probe_bytes, probe_flops,
        probe_mm_cuda, probe_mm_plain, probe_occupancy, probe_plan)

    torch.backends.cuda.matmul.allow_tf32 = False

    def cublas(a, b):
        acc = torch.zeros(a.shape[0], b.shape[1], device=a.device)
        for _ in range(PROBE_REPS):
            acc = torch.addmm(acc, a, b)
        return acc

    def describe(plan):
        blocks, clusters = probe_occupancy(plan, dev)
        if clusters < 1:
            raise AssertionError(f"probe plan {plan}: no cluster fits")
        waves = plan.ctas / (clusters * plan.ksplit)
        return (f"tile {plan.tm}x{plan.tn} ({plan.threads} threads), "
                f"cluster {plan.ksplit} (k ranges of {plan.kc}), "
                f"{'resident' if plan.resident else 'pipelined'} "
                f"({plan.stages} k-steps), {plan.smem} B shared; "
                f"{probe_ptxas(plan)}; {plan.ctas} CTAs, {blocks} a SM, "
                f"{clusters} clusters at once: {waves:.2f} waves"), waves

    shapes, max_abs = [], 0.0
    for m, k, n in PROBE_SHAPES:
        a = torch.from_numpy(np.random.default_rng(0).normal(size=(m, k))
                             .astype(np.float32)).to(dev)
        b = torch.from_numpy(np.random.default_rng(1).normal(size=(k, n))
                             .astype(np.float32)).to(dev)
        plan = probe_plan(m, k, n)
        got = probe_mm_cuda(a, b)
        again = probe_mm_cuda(a, b)
        torch.cuda.synchronize()
        want = probe_mm_plain(a, b)
        err = scaled_err(got, want)
        max_abs = max(max_abs, float((got - want).abs().max()))
        if not bool(torch.isfinite(got).all()) or not err <= PROBE_TOL:
            raise AssertionError(f"probe [{m},{k}]@[{k},{n}]: scaled error "
                                 f"{err} > {PROBE_TOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"probe [{m},{k}]@[{k},{n}]: two runs "
                                 "differ")
        iters = 50 if m < 1024 else 20
        flops = probe_flops(m, k, n)
        op_ms = flops / FP32_FLOPS_PER_S * 1e3
        bnd, by = bound_ms(probe_bytes(m, k, n), flops)

        text, waves = describe(plan)
        k_ms = cuda_ms(lambda: probe_mm_cuda(a, b), iters)
        # a time below the operations bound would mean the twenty products
        # were folded into fewer
        if k_ms < op_ms:
            raise AssertionError(f"probe [{m},{k}]@[{k},{n}]: {k_ms} ms is "
                                 f"below the FLOP bound {op_ms} ms")
        p_ms = cuda_ms(lambda: probe_mm_plain(a, b), iters)
        l_ms = cuda_ms(lambda: cublas(a, b), iters)
        print(f"phase 20 probe_mm [{m},{k}]@[{k},{n}] x{PROBE_REPS}: plan "
              f"{text}")
        print(f"phase 20 probe_mm [{m},{k}]@[{k},{n}] x{PROBE_REPS}: scaled "
              f"error {err:.2e}, the same bits twice; kernel {k_ms:.4f} ms "
              f"({flops / k_ms / 1e9:.2f} TFLOP/s, {bnd / k_ms:.3f} of the "
              f"bound {bnd:.4f} ms by {by}), plain {p_ms:.4f} ms, cuBLAS "
              f"{l_ms:.4f} ms ({flops / l_ms / 1e9:.2f} TFLOP/s)")
        shapes.append(dict(m=m, k=k, n=n, ms=k_ms, plain_ms=p_ms,
                           library_ms=l_ms, bound_ms=bnd, bound_by=by,
                           scaled_err=err, tm=plan.tm, tn=plan.tn,
                           ksplit=plan.ksplit, resident=plan.resident,
                           ctas=plan.ctas, waves=waves))
    # the pipelined mode, which the plan takes where a rank's k range does
    # not fit resident: integer operands in [-4, 4] make every product and
    # partial sum exact in f32 (|o| <= 20 * 16 * k < 2^24), so any order of
    # summation gives the same bits and the kernel must equal plain exactly
    pipelined = []
    for m, k, n in PROBE_PIPELINED_SHAPES:
        plan = probe_plan(m, k, n)
        if plan.resident:
            raise AssertionError(f"probe [{m},{k}]@[{k},{n}]: the plan "
                                 f"{plan} is not pipelined")
        a = torch.from_numpy(np.random.default_rng(2).integers(
            -4, 5, size=(m, k)).astype(np.float32)).to(dev)
        b = torch.from_numpy(np.random.default_rng(3).integers(
            -4, 5, size=(k, n)).astype(np.float32)).to(dev)
        got = probe_mm_cuda(a, b)
        want = probe_mm_plain(a, b)
        if not torch.equal(got, want):
            raise AssertionError(
                f"probe [{m},{k}]@[{k},{n}] pipelined: differs from plain by "
                f"{float((got - want).abs().max())} on exact operands")
        k_ms = cuda_ms(lambda: probe_mm_cuda(a, b), 10)
        op_ms = probe_flops(m, k, n) / FP32_FLOPS_PER_S * 1e3
        if k_ms < op_ms:
            raise AssertionError(f"probe [{m},{k}]@[{k},{n}] pipelined: "
                                 f"{k_ms} ms is below the FLOP bound {op_ms}")
        text, waves = describe(plan)
        print(f"phase 20 probe_mm [{m},{k}]@[{k},{n}] x{PROBE_REPS} "
              f"pipelined: plan {text}; equal to plain bit for bit on "
              f"integer operands; kernel {k_ms:.4f} ms "
              f"({probe_flops(m, k, n) / k_ms / 1e9:.2f} TFLOP/s)")
        pipelined.append(dict(m=m, k=k, n=n, ms=k_ms, tm=plan.tm, tn=plan.tn,
                              ksplit=plan.ksplit, waves=waves))
    if {(p["tm"], p["tn"]) for p in pipelined} != set(TILES):
        raise AssertionError("probe: the pipelined shapes miss a tile")
    big = shapes[-1]
    return dict(name="probe_mm_cuda", route="cuda",
                source="tinman_sandbox_tpu_torch/csrc/probe.cu",
                replaces="tools/probe_kernel.py:47", max_abs_err=max_abs,
                ms=big["ms"], plain_ms=big["plain_ms"],
                bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                library_ms=big["library_ms"], shape="1024x1024x1024",
                shapes=shapes, pipelined=pipelined)


def phase_probe_path(dev):
    """Phase 20, the probe tool's main path: ``python -m
    tinman_sandbox_tpu_torch.tools.probe_kernel`` in process (triad, the
    five products, the row CAAR kernel). Returns its result."""
    from tinman_sandbox_tpu_torch.tools import probe_kernel

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = probe_kernel.main([])
    for ln in buf.getvalue().splitlines():
        print("phase 20 tool " + ln)
    if len(out["matmul"]) != 5 or not out["triad_gb_per_s"] > 0:
        raise AssertionError(f"probe tool: {out}")
    return out


@contextlib.contextmanager
def uncounted(*wrappers):
    """Launches of ``wrappers`` inside the block are not counted: a kernel
    held against its plain version or timed is not the main path's run."""
    saved = [(w.launches, w.f64_launches) for w in wrappers]
    try:
        yield
    finally:
        for w, (n, n64) in zip(wrappers, saved):
            w.launches, w.f64_launches = n, n64


def kernel_launches(fn):
    """Kernels one call of ``fn`` launches on the card, by
    ``torch.profiler``'s CUDA events (memory copies and sets left out);
    None where the profiler records no CUDA event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    except RuntimeError as e:
        print(f"kernel_launches: the profiler failed: {e}")
        return None
    kernels = [n for n in names if not n.lower().startswith(("memcpy",
                                                             "memset"))]
    return len(kernels) if names else None


def column_total_err(x_in, dp_in, x_out, dp_out, mass: bool) -> float:
    """The largest column's |sum x_out*dp_out - sum x_in*dp_in| over its
    sum |x_in|*dp_in (with ``mass`` x is already a mass: sum x_out against
    sum x_in over sum |x_in|), in float64. Arguments [K, C]."""
    if mass:
        tin, tout = x_in.double().sum(0), x_out.double().sum(0)
        scale = x_in.double().abs().sum(0)
    else:
        tin = (x_in.double() * dp_in.double()).sum(0)
        tout = (x_out.double() * dp_out.double()).sum(0)
        scale = (x_in.double().abs() * dp_in.double()).sum(0)
    return float(((tout - tin).abs() / scale).max())


def cadence_input(dev, qsize: int, steps: int = 3):
    """Phase 21's remap input at ne30 x 72 and ``qsize`` tracers: the packed
    cadence's problem (``make_cadence_problem``) after ``steps`` (its
    rsplit) steps of ``prim_step_packed_t4`` on the kernels with limited
    tracers and qsplit 2, where the Lagrangian levels have moved. Returns
    (prob, s, qdp)."""
    from tinman_sandbox_tpu_torch.dist import prim_step_packed_t4
    from tinman_sandbox_tpu_torch.examples import packed_cadence

    prob = packed_cadence.make_cadence_problem(NE, NLEV, qsize, DYN_DT,
                                               "random", dev)
    s, q, acc = prob["s"], prob["qdp"], [a.clone() for a in prob["acc"]]
    for _ in range(steps):
        s, q, _, *acc = prim_step_packed_t4(
            prob["scal"], prob["meta"], s, q, prob["pecnd"], *acc,
            prob["dvv"], prob["plan"], prob["rsp"], DYN_NU, NLEV, qsplit=2,
            limit_tracers=True, dt=DYN_DT)
    return prob, s, q


def remap_gates(dev, prob, pre, mass0, qsize: int = 1, f64: bool = True):
    """Phase 21's gates of the remap kernel on a remap's input ``pre`` =
    (s, qdp) with ``qsize`` tracers, for pcm, plm and ppm; with ``f64`` the
    float64 instances too; raises on a failure. Returns the measurements of
    the kernel's row in the kernels line (each tracer gated on its own, the
    worst printed as qdp)."""
    import torch

    from tinman_sandbox_tpu_torch.dist import (
        remap_packed_t4, remap_packed_t4_plain)
    from tinman_sandbox_tpu_torch.kernels.remap import (
        remap_levels_cuda, remap_packed_cuda)
    from tinman_sandbox_tpu_torch.ops.remap import (remap_levels,
                                                    remap_levels_plain)

    k, nelem = NLEV, prob["cfg"].nelem
    s, q = pre
    hv, sph = prob["hv"], prob["sph_lanes"]
    dp = s[3 * k:]
    names = ("u", "v", "t") + tuple(f"qdp{i}" for i in range(qsize))
    blocks = lambda x, y: list(x[:3 * k].split(k)) + list(y.split(k))
    shown = lambda e: {**{n: e[n] for n in names[:3]}, "qdp": max(
        e[n] for n in names[3:])}
    worst = {}
    for scheme in ("pcm", "plm", "ppm"):
        ks, kq = remap_packed_cuda(s, q, hv, k, qsize, scheme)
        ps, pq = remap_packed_t4_plain(s, q, hv, nelem, k, qsize, scheme)
        rs, rq = remap_packed_t4_plain(s.double(), q.double(), hv, nelem, k,
                                       qsize, scheme)
        kf = remap_packed_t4(s, q, hv, nelem, k, qsize, scheme, sph, mass0)
        pf = remap_packed_t4_plain(s, q, hv, nelem, k, qsize, scheme, sph,
                                   mass0)
        torch.cuda.synchronize()
        dp_same = torch.equal(ks[3 * k:], ps[3 * k:]) \
            and torch.equal(kf[0][3 * k:], pf[0][3 * k:])
        del kf, pf
        ref = blocks(rs, rq)
        kern = {n: scaled_err(a, b) for n, a, b in zip(names, blocks(ks, kq),
                                                       ref)}
        kern_abs = max(float((a.double() - b).abs().max())
                       for a, b in zip(blocks(ks, kq), ref))
        plain = {n: scaled_err(a, b) for n, a, b in zip(names, blocks(ps, pq),
                                                        ref)}
        tot_k = {n: column_total_err(a, dp, b, ks[3 * k:], i >= 3)
                 for i, (n, a, b) in enumerate(zip(names, blocks(s, q),
                                                   blocks(ks, kq)))}
        tot_p = {n: column_total_err(a, dp, b, ps[3 * k:], i >= 3)
                 for i, (n, a, b) in enumerate(zip(names, blocks(s, q),
                                                   blocks(ps, pq)))}
        finite = bool(torch.isfinite(ks).all() and torch.isfinite(kq).all())
        print(f"phase 21 remap kernel qsize {qsize} {scheme}: dp rows bit for "
              f"bit the plain code's (without and with the fixer) {dp_same}; "
              f"scaled errors against the plain float64 remap, kernel / "
              f"plain float32: " + " ".join(
                  f"{n} {a:.2e} / {b:.2e}" for (n, a), b in zip(
                      shown(kern).items(), shown(plain).values()))
              + "; column totals of sum|x|*dp, kernel / plain float32: "
              + " ".join(f"{n} {a:.2e} / {b:.2e}" for (n, a), b in zip(
                  shown(tot_k).items(), shown(tot_p).values()))
              + (" (qdp: the worst tracer)" if qsize > 1 else ""))
        if not dp_same or not finite:
            raise AssertionError(f"remap kernel {scheme}: dp rows differ from "
                                 f"the plain code's, or non-finite")
        for n in names:
            if kern[n] > plain[n]:
                raise AssertionError(f"remap kernel {scheme} {n}: {kern[n]} "
                                     f"off the float64 remap, the plain "
                                     f"float32 code {plain[n]}")
            if tot_k[n] > REMAP_TOTAL_TOL:
                raise AssertionError(f"remap kernel {scheme} {n}: column "
                                     f"totals {tot_k[n]} > {REMAP_TOTAL_TOL}")
        worst[scheme] = dict(kernel=shown(kern), kernel_abs=kern_abs,
                             plain_f32=shown(plain), totals=shown(tot_k),
                             plain_totals=shown(tot_p))
        del ks, kq, ps, pq, rs, rq, ref
        torch.cuda.empty_cache()
    if not f64:
        return dict(gates=worst)
    # the float64 instances against the plain float64 code
    s64, q64, hv64 = s.double(), q.double(), hv.to(dtype=torch.float64)
    ks, kq = remap_packed_t4(s64, q64, hv64, nelem, k, 1)
    rs, rq = remap_packed_t4_plain(s64, q64, hv64, nelem, k, 1)
    f64_packed = max(scaled_err(a, b) for a, b in zip(
        blocks(ks, kq) + [ks[3 * k:]], blocks(rs, rq) + [rs[3 * k:]]))
    dp64, dpt64 = s64[3 * k:], rs[3 * k:]
    lev = remap_levels(s64[:k], dp64, dpt64)
    three = remap_levels_cuda(s64[:3 * k], dp64, dpt64, "ppm")
    f64_levels = max(
        scaled_err(lev, remap_levels_plain(s64[:k], dp64, dpt64)),
        max(scaled_err(a, remap_levels_plain(b, dp64, dpt64, "ppm"))
            for a, b in zip(three.split(k), s64[:3 * k].split(k))))
    print(f"phase 21 remap kernel float64 against the plain float64 code, "
          f"scaled: packed {f64_packed:.2e}, level form (plm; three fields "
          f"in one launch, ppm) {f64_levels:.2e} (limit {REMAP_F64_TOL})")
    if max(f64_packed, f64_levels) > REMAP_F64_TOL:
        raise AssertionError(f"remap kernel float64: {f64_packed}, "
                             f"{f64_levels} > {REMAP_F64_TOL}")
    del s64, q64, ks, kq, rs, rq, lev, three
    return dict(gates=worst, f64_packed_scaled_err=f64_packed,
                f64_levels_scaled_err=f64_levels)


def phase_remap_cadence(dev, cs):
    """Phase 21: the packed remap cadence at ne30 x 72, qsize 1 (the
    ``examples.packed_cadence`` problem and loop), kernels against plain,
    the remap kernel's gates, time, memory, launches and share; the example
    and the energy-drift tool on the card; the CLI's --diag with a
    --checkpoint / --restore pair. Returns the kernels' rows of the
    kernels line and the remap's measurements."""
    import json as _json
    import tempfile

    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import cli
    from tinman_sandbox_tpu_torch.dist import (
        continuity_error_t, packed_air_mass, prim_step_packed_t4,
        prim_step_packed_t4_plain, remap_packed_t4, remap_packed_t4_plain)
    from tinman_sandbox_tpu_torch.examples import packed_cadence
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.remap import (
        SCHEMES, remap_levels_cuda, remap_packed_cuda, remap_packed_plain,
        remap_plan)
    from tinman_sandbox_tpu_torch.ops.remap import remap_levels_plain
    from tinman_sandbox_tpu_torch.ops.diagnostics import (
        energy_diagnostics_packed_t)
    from tinman_sandbox_tpu_torch.tools import energy_drift

    steps, rsplit, qsplit = 6, 3, 2
    prob = packed_cadence.make_cadence_problem(cs.ne, NLEV, 1, DYN_DT,
                                               "random", dev)
    cfg, sph = prob["cfg"], prob["sph_lanes"]
    s0, q0 = prob["s"], prob["qdp"]
    mass0 = packed_air_mass(s0, sph, NLEV)

    def diag(s):
        return " ".join(f"{k}={float(v):.6e}" for k, v in
                        energy_diagnostics_packed_t(s, prob["meta"],
                                                    NLEV).items())

    print(f"phase 21 cadence ne{cs.ne}x{NLEV} qsize 1 start: {diag(s0)}")
    args = (prob["dvv"], prob["plan"], prob["rsp"], DYN_NU, NLEV)
    kw = dict(qsplit=qsplit, limit_tracers=True, dt=DYN_DT)

    def step(fn, s, q, acc):
        s1, q1, _, *acc1 = fn(prob["scal"], prob["meta"], s, q,
                              prob["pecnd"], *acc, *args, **kw)
        return s1, q1, tuple(acc1)

    def remap(s, q):
        return remap_packed_t4(s, q, prob["hv"], cfg.nelem, NLEV, 1,
                               sph_lanes=sph, mass_target=mass0)

    def remap_ref(s, q):
        # the plain chain's remap: the plain code in float64 on the float32
        # state, rounded to float32
        rs, rq = remap_packed_t4_plain(s.double(), q.double(), prob["hv"],
                                       cfg.nelem, NLEV, 1,
                                       sph_lanes=sph.double(),
                                       mass_target=mass0.double())
        return rs.float(), rq.float()

    # the example's loop, on the kernels and on the plain step
    ks, kq, kacc = s0, q0, tuple(a.clone() for a in prob["acc"])
    ps, pq, pacc = s0, q0, prob["acc"]
    masses, remap_conts, step_errs = [], [], []
    pre = None
    for i in range(1, steps + 1):
        # each step alone against the plain step from the same input
        os_, oq, _ = step(prim_step_packed_t4_plain, ks, kq, kacc)
        ks, kq, kacc = step(prim_step_packed_t4, ks, kq, kacc)
        one = {name: scaled_err(a, b) for name, a, b in zip(
            ("u", "v", "t", "dp"), ks.split(NLEV), os_.split(NLEV))}
        one["qdp"] = scaled_err(kq, oq)
        step_errs.append(max(one.values()))
        if max(one.values()) > DYN_TOL:
            raise AssertionError(f"cadence step {i} from the same input: "
                                 f"{one} > {DYN_TOL}")
        for name, x in (("state", ks), ("tracer", kq)):
            cont = continuity_error_t(x, cs.gdof)
            if cont != 0.0:
                raise AssertionError(f"cadence step {i}: {name} continuity "
                                     f"{cont}")
        ps, pq, pacc = step(prim_step_packed_t4_plain, ps, pq, pacc)
        if i % rsplit == 0:
            pre = (ks, kq)
            ks, kq = remap(ks, kq)
            ps, pq = remap_ref(ps, pq)
            rel = abs(float(packed_air_mass(ks, sph, NLEV)) / float(mass0)
                      - 1.0)
            masses.append(rel)
            if not rel < REMAP_MASS_TOL:
                raise AssertionError(f"cadence step {i}: relative mass {rel} "
                                     f"after the remap")
            remap_conts.append(max(continuity_error_t(ks, cs.gdof),
                                   continuity_error_t(kq, cs.gdof)))
        errs = {name: scaled_err(a, b) for name, a, b in zip(
            ("u", "v", "t", "dp"), ks.split(NLEV), ps.split(NLEV))}
        errs["qdp"] = scaled_err(kq, pq)
        if max(errs.values()) > CADENCE_TOL \
                or not bool(torch.isfinite(ks).all()):
            raise AssertionError(f"cadence chain step {i}: {errs} > "
                                 f"{CADENCE_TOL}")
    print(f"phase 21 cadence ne{cs.ne}x{NLEV} qsize 1 x{steps} (dt {DYN_DT}, "
          f"nu {DYN_NU:g}, qsplit {qsplit}, limited tracers, remap + fixer "
          f"every {rsplit}): each step within "
          f"{' '.join(f'{e:.2e}' for e in step_errs)} of the plain step from "
          f"the same input; the chains after {steps} steps, scaled errors "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; continuity 0 after every step's DSS; after each remap "
          f"relative mass {' '.join(f'{m:.2e}' for m in masses)}, the "
          f"remap's own continuity {' '.join(f'{c:.1e}' for c in remap_conts)}"
          f"; min dp {float(ks[3 * NLEV:].min()):.3f}, min qdp "
          f"{float(kq.min()):.3e}; end: {diag(ks)}")
    del ps, pq, pacc, os_, oq

    # the remap kernel's gates on the last remap's input, its times against
    # the dense plain code's, its peak memory and launches a call, and its
    # share of the cadence; none of these launches is the main path's
    wrappers = (remap_packed_cuda, remap_levels_cuda)
    with uncounted(*wrappers):
        gates = remap_gates(dev, prob, pre, mass0)
        ks_, kq_ = pre
        hv, nelem, k = prob["hv"], cfg.nelem, NLEV
        kernel = lambda: remap_packed_cuda(ks_, kq_, hv, k, 1)
        plain = lambda: remap_packed_plain(ks_, kq_, hv, k, 1)
        user = lambda: remap(ks_, kq_)
        user_plain = lambda: remap_packed_t4_plain(
            ks_, kq_, hv, nelem, k, 1, sph_lanes=sph, mass_target=mass0)
        k_ms, k_graph = cuda_ms(kernel, 50), graph_ms(kernel, 50)
        u_ms, u_graph = cuda_ms(user, 50), graph_ms(user, 50)
        p_ms, up_ms = cuda_ms(plain, 3), cuda_ms(user_plain, 3)
        peaks = {}
        for name, fn in (("remap_packed_t4", user),
                         ("remap_packed_t4_plain", user_plain)):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        launches = {name: kernel_launches(fn) for name, fn in (
            ("remap_packed_cuda", kernel), ("remap_packed_t4", user),
            ("remap_packed_t4_plain", user_plain))}
        acc = tuple(a.clone() for a in kacc)
        step_ms = cuda_ms(lambda: step(prim_step_packed_t4, ks, kq, acc), 10)
        share = u_ms / (rsplit * step_ms + u_ms)
        share_plain = up_ms / (rsplit * step_ms + up_ms)
        # the level form at the field-form cadence's shape on the card (the
        # drift tool's ne4 x 8, float64, one field a launch) and at ne30 x
        # 72 (float64, one field)
        lv = {}
        for tag, ncol, nl in (("ne4x8", 96 * 16, 8), ("ne30x72", ks_.shape[1],
                                                     NLEV)):
            gen = torch.Generator(device=dev).manual_seed(13)
            dps = torch.rand(nl, ncol, generator=gen, device=dev,
                             dtype=torch.float64) + 0.5
            w = torch.rand(nl, ncol, generator=gen, device=dev,
                           dtype=torch.float64) + 0.5
            dpt = w / w.sum(0) * dps.sum(0)
            x = torch.randn(nl, ncol, generator=gen, device=dev,
                            dtype=torch.float64)
            got, want = (remap_levels_cuda(x, dps, dpt),
                         remap_levels_plain(x, dps, dpt))
            err = scaled_err(got, want)
            b, by = bound_ms(4 * nl * ncol * 8, 0)
            lv[tag] = dict(
                ms=cuda_ms(lambda: remap_levels_cuda(x, dps, dpt), 50),
                graph_ms=graph_ms(lambda: remap_levels_cuda(x, dps, dpt), 50),
                plain_ms=cuda_ms(lambda: remap_levels_plain(x, dps, dpt), 3),
                bound_ms=b, bound_by=by, scaled_err=err,
                abs_err=float((got - want).abs().max()))
            if err > REMAP_F64_TOL:
                raise AssertionError(f"remap_levels_cuda {tag}: {err}")
            del dps, w, dpt, x, got, want
    # the plan: csrc/remap.cu's shared memory a block against remap_plan's,
    # and the blocks an SM by cudaOccupancy
    lib = _build.library("remap")
    for itemsize, scheme in itertools.product((4, 8), SCHEMES):
        smem = lib.remap_smem_bytes(NLEV, itemsize, SCHEMES.index(scheme))
        if remap_plan(NLEV, itemsize, scheme) != smem:
            raise AssertionError(f"remap_plan({NLEV}, {itemsize}, {scheme}) "
                                 f"!= the kernel's {smem} B")
    plans = {scheme: (remap_plan(NLEV, 4, scheme), lib.remap_blocks_per_sm(
        0, SCHEMES.index(scheme), 1, NLEV, dev.index)) for scheme in SCHEMES}
    print(f"phase 21 remap kernel plan ne{cs.ne}x{NLEV} f32, 32 columns a "
          f"block: " + ", ".join(
              f"{sch} {b} B shared, {n} blocks an SM"
              for sch, (b, n) in plans.items()))
    ncol = ks_.shape[1]
    nbytes = 2 * 5 * NLEV * ncol * 4 + 2 * (NLEV + 1) * 4
    bnd, by = bound_ms(nbytes, REMAP_OPS_PER_POINT * 4 * NLEV * ncol)
    # the fixer: packed_air_mass reads the dp rows and spheremp, the two
    # scales read and write the dp and tracer rows
    fix_bytes = (NLEV + 1) * ncol * 4 + 2 * 2 * NLEV * ncol * 4
    bnd_user = bnd + fix_bytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 21 remap kernel ne{cs.ne}x{NLEV} qsize 1 f32 plm "
          f"(remap_packed_cuda, {nbytes} B): {k_ms:.4f} ms (graph "
          f"{k_graph:.4f}), bound {bnd:.4f} ms ({by}); dense plain "
          f"(remap_packed_plain) {p_ms:.3f} ms, {p_ms / k_ms:.0f}x; "
          f"remap_packed_t4 with the fixer {u_ms:.4f} ms (graph "
          f"{u_graph:.4f}; bound {bnd_user:.4f}) against the plain "
          f"{up_ms:.3f} ms; peak above the inputs "
          + ", ".join(f"{n} {v:.1f} MiB" for n, v in peaks.items())
          + "; launches a call " + ", ".join(
              f"{n} {'not measured' if v is None else v}"
              for n, v in launches.items())
          + f"; the cadence step {step_ms:.3f} ms, the remap {share:.4f} of "
          f"the cadence (the plain remap's {share_plain:.3f}; one remap per "
          f"{rsplit} steps)")
    print(f"phase 21 remap_levels_cuda float64 (one field): " + "; ".join(
        f"{t} {v['ms']:.4f} ms (graph {v['graph_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f}), plain {v['plain_ms']:.3f} ms, scaled error "
        f"{v['scaled_err']:.1e}" for t, v in lv.items()))
    # E3SM's 35 tracers: the cadence's input after rsplit steps at qsize 35,
    # the same gates (the float64 instances above), the kernel's time, its
    # registers and blocks an SM
    prob35, s35, q35 = cadence_input(dev, QSIZE_TALL, rsplit)
    mass35 = packed_air_mass(prob35["s"], prob35["sph_lanes"], NLEV)
    with uncounted(*wrappers):
        gates35 = remap_gates(dev, prob35, (s35, q35), mass35, QSIZE_TALL,
                              f64=False)
        kernel35 = lambda: remap_packed_cuda(s35, q35, prob35["hv"], NLEV,
                                             QSIZE_TALL)
        k35_ms, k35_graph = cuda_ms(kernel35, 20), graph_ms(kernel35, 20)
    nbytes35 = 2 * (4 + QSIZE_TALL) * NLEV * ncol * 4 + 2 * (NLEV + 1) * 4
    bnd35, by35 = bound_ms(nbytes35, REMAP_OPS_PER_POINT
                           * (3 + QSIZE_TALL) * NLEV * ncol)
    regs = remap_ptxas()
    print(f"phase 21 remap kernel ne{cs.ne}x{NLEV} qsize {QSIZE_TALL} f32 plm "
          f"(remap_packed_cuda, {nbytes35} B): {k35_ms:.4f} ms (graph "
          f"{k35_graph:.4f}), bound {bnd35:.4f} ms ({by35}); "
          f"{plans['plm'][1]} blocks an SM, ptxas {regs}")
    del prob35, s35, q35, kernel35
    torch.cuda.empty_cache()
    rows = {
        "remap_packed_cuda": dict(
            route="cuda", source="tinman_sandbox_tpu_torch/csrc/remap.cu",
            replaces="tinman_sandbox_tpu/dist/step_pallas.py:693 "
                     "remap_packed_t4 (XLA, no pallas_call)",
            max_abs_err=gates["gates"]["plm"]["kernel_abs"],
            max_abs_err_against="remap_packed_t4_plain in float64 (plm)",
            ms=k_ms, graph_ms=k_graph, plain_ms=p_ms, bound_ms=bnd,
            bound_by=by, library_ms=None, with_fixer_ms=u_ms,
            with_fixer_graph_ms=u_graph, with_fixer_bound_ms=bnd_user,
            with_fixer_plain_ms=up_ms, peak_mib=peaks,
            launches_a_call=launches, cadence_share=share,
            plain_cadence_share=share_plain, plan=plans, ptxas=regs,
            qsize35=dict(ms=k35_ms, graph_ms=k35_graph, bound_ms=bnd35,
                         bound_by=by35, **gates35), **gates),
        "remap_levels_cuda": dict(
            route="cuda", source="tinman_sandbox_tpu_torch/csrc/remap.cu",
            replaces="tinman_sandbox_tpu/ops/remap.py:68 remap_column (XLA, "
                     "no pallas_call)",
            max_abs_err=lv["ne4x8"]["abs_err"],
            ms=lv["ne4x8"]["ms"], plain_ms=lv["ne4x8"]["plain_ms"],
            bound_ms=lv["ne4x8"]["bound_ms"],
            bound_by=lv["ne4x8"]["bound_by"], library_ms=None,
            shape="ne4 x 8 float64, the drift tool's", ne30x72=lv["ne30x72"]),
    }
    times = dict(remap_ms=u_ms, remap_peak_mib=peaks["remap_packed_t4"],
                 cadence_step_ms=step_ms, remap_share=share,
                 remap_mass_rel=masses)
    del ks, kq, kacc, acc, pre, ks_, kq_
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # the example as a user runs it, with its --checkpoint restart: from
        # one checkpoint z of the start (two runs from the init differ in the
        # last bits on the card: the seeded start's projection adds by
        # atomics), 6 steps at once, and 3 steps, a restart, 3 more, equal
        # bit for bit; the fixer's target travels in the checkpoint
        def example(*extra):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = packed_cadence.main([
                    "--ne", str(cs.ne), "--nlev", str(NLEV), "--qsize", "1",
                    "--dt", str(DYN_DT), *extra])
            last = buf.getvalue().strip().splitlines()[-1]
            if rc != 0:
                raise AssertionError(f"packed_cadence {extra} exited {rc}: "
                                     f"{last}")
            return buf.getvalue(), last

        drift = os.path.join(tmp, "drift.json")
        z, whole, split = (os.path.join(tmp, f"{n}.npz")
                           for n in ("z", "whole", "split"))
        example("--steps", "0", "--checkpoint", z)
        shutil.copy(z, whole)
        shutil.copy(z, split)
        _, last = example("--steps", str(steps), "--checkpoint", whole,
                          "--drift-out", drift)
        print(f"phase 21 examples.packed_cadence --ne {cs.ne} --nlev {NLEV} "
              f"--qsize 1 --steps {steps} --dt {DYN_DT}:{last}")
        example("--steps", str(steps // 2), "--checkpoint", split)
        out, _ = example("--steps", str(steps // 2), "--checkpoint", split)
        if f"restarted packed chain at step {steps // 2}" not in out:
            raise AssertionError(f"packed_cadence did not restart:\n{out}")
        with np.load(whole) as zw, np.load(split) as zs:
            mw, ms = (_json.loads(bytes(x["meta"]).decode())
                      for x in (zw, zs))
            same = {key: np.array_equal(zw[key], zs[key]) for key in (
                "packed.s", "packed.qdp", "packed.vn0u", "packed.vn0v",
                "packed.omg")}
        if not all(same.values()) or mw != ms or mw["step"] != steps:
            raise AssertionError(f"packed_cadence restart differs from the "
                                 f"uninterrupted run: {same}, {mw}, {ms}")
        print(f"phase 21 examples.packed_cadence: {steps // 2} steps, "
              f"--checkpoint, restart, {steps // 2} steps equal {steps} "
              f"steps at once bit for bit (state, tracers, accumulators; "
              f"fixer target {mw['mass_target']!r} from the checkpoint)")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rep = energy_drift.main(["--ne", "4", "--nlev", "8", "--steps",
                                     "6", "--every", "3", "--out",
                                     os.path.join(tmp, "ed.json")])
        print(f"phase 21 tools.energy_drift --ne 4 --nlev 8 --steps 6 "
              f"({rep['device']}, f64): mass drift "
              f"{rep['mass_drift_rel']:.3e}, IE drift "
              f"{rep['ie_drift_rel']:.3e}")
        if not rep["mass_drift_rel"] < 1e-10:
            raise AssertionError(f"energy_drift: {rep['mass_drift_rel']}")

        # the CLI's --diag, and from one checkpoint z: 2 steps +
        # --checkpoint, then --restore + 1, equal to 3 steps at once bit for
        # bit (each run from the init would project it anew, and the
        # segment-sum projection adds by atomics on the card: its bits
        # differ from run to run)
        base = ["--ne", str(cs.ne), "--prim", "--hypervis-nu", str(DYN_NU),
                "--init", "random", "--dt", str(DYN_DT), "--diag"]
        z, a, b, c = (os.path.join(tmp, f"{n}.npz") for n in "zabc")
        paths = (a, c)
        runs = (["--num-exec", "1", "--checkpoint", z],
                ["--num-exec", "3", "--restore", z, "--checkpoint", a],
                ["--num-exec", "2", "--restore", z, "--checkpoint", b],
                ["--num-exec", "1", "--restore", b, "--checkpoint", c])
        for extra in runs:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(base + extra)
            out = buf.getvalue()
            if rc != 0 or "WARNING" in out:
                raise AssertionError(f"cli {extra} exited {rc}:\n{out}")
        d = [ln for ln in out.splitlines() if "diagnostics:" in ln]
        print(f"phase 21 cli --ne {cs.ne} --prim --diag --restore: "
              + "; ".join(ln.split("---", 1)[1].strip() for ln in d))
        za, zc = np.load(paths[0]), np.load(paths[1])
        ma, mc = (_json.loads(bytes(z["meta"]).decode()) for z in (za, zc))
        same = [np.array_equal(za[f"state.{f}"][ma["n0"]],
                               zc[f"state.{f}"][mc["n0"]])
                for f in ("u", "v", "t", "dp3d")]
        same.append(np.array_equal(za["state.qdp"][ma["qn0"]],
                                   zc["state.qdp"][mc["qn0"]]))
        same += [np.array_equal(za[f"derived.{f}"], zc[f"derived.{f}"])
                 for f in ("vn0_u", "vn0_v", "phi", "omega_p")]
        if not all(same) or ma["step"] != 4 or mc["step"] != 4:
            raise AssertionError(f"cli --restore: resumed run differs from "
                                 f"the uninterrupted one: {same}")
        print(f"phase 21 cli --ne {cs.ne} --prim: from one checkpoint, 2 "
              f"steps, --checkpoint, --restore, 1 step equal 3 steps at once "
              f"bit for bit (state, tracers, derived)")
        del za, zc
    return rows, times

def ulp32(x: float) -> float:
    """The spacing of float32 numbers at |x| (x > 0)."""
    import math

    return 2.0 ** (math.floor(math.log2(x)) - 23)


def phase_element_tiers(dev, cs):
    """Phase 22: the element-sharded tiers at ne30 x 72, f32, over
    LocalMesh(TIER_SHARDS) on the card, from one projected random start
    (every time level of u, v, T and dp3d projected onto the continuous
    space): the psum halo, ppermute, partitioned segment-sum and overlap
    steps, each of u, v, T, dp3d at np1 within TIER_TOL of max|x| of the
    single-device ``caar_dss_step``; continuity (``continuity_error_t`` on
    the np1 fields in [nlev, E16] lane order) exactly 0 for the psum and
    segment-sum tiers (every alias gathers one sum) and at most
    TIER_CONT_ULPS ulps of max|x| for the ppermute tiers (a dof of three
    shards adds its rounds in a shard-dependent order); the perimeter
    fraction, the rounds and each step's ms by events (an emulation: the
    shards run one after another); then ``dryrun_multichip(8)`` with every
    tier."""
    import dataclasses

    import torch

    from tinman_sandbox_tpu_torch import (
        Config, analytic_hvcoord, random_state, zero_derived)
    from tinman_sandbox_tpu_torch.dist import (
        LocalMesh, caar_dss_sharded_step, caar_dss_step, caar_halo_step,
        caar_ppermute_overlap_step, caar_ppermute_step, continuity_error_t,
        dss_project, make_dss_plan, make_overlap_plan, make_ppermute_plan,
        shard_problem, unshard)
    from tinman_sandbox_tpu_torch.kernels.layout import pack_field_t
    from tinman_sandbox_tpu_torch.multichip import TIERS, dryrun_multichip

    n = TIER_SHARDS
    kw = dict(dtype=torch.float32, device=dev)
    cfg = Config(nelem=cs.nelem, nlev=NLEV)
    g = cs.geometry
    st, dv = random_state(cfg, seed=7, **kw), zero_derived(cfg, **kw)
    hv = analytic_hvcoord(cfg, **kw)
    proj = lambda x: torch.stack([
        dss_project(x[i], cs.gdof, cs.ndof, g.spheremp, g.rspheremp)
        for i in range(x.shape[0])])
    st = dataclasses.replace(st, **{k: proj(getattr(st, k))
                                    for k in TIER_FIELDS})
    ref, _ = caar_dss_step(st, dv, g, hv, cs.gdof, cs.ndof, cfg, 0.1, 1.0,
                           device=dev)
    mesh = LocalMesh(n, dev)
    t0 = time.perf_counter()
    plan, pplan = make_dss_plan(cs.gdof, n), make_ppermute_plan(cs.gdof, n)
    oplan = make_overlap_plan(cs.gdof, n)
    plan_s = time.perf_counter() - t0
    ss, sd, sg = shard_problem(mesh, st, dv, g)
    steps = {
        "halo": lambda: caar_halo_step(ss, sd, sg, hv, plan, mesh, cfg, 0.1,
                                       1.0),
        "ppermute": lambda: caar_ppermute_step(ss, sd, sg, hv, pplan, mesh,
                                               cfg, 0.1, 1.0),
        "segment sum": lambda: caar_dss_sharded_step(
            ss, sd, sg, hv, cs.gdof, cs.ndof, mesh, cfg, 0.1, 1.0),
        "overlap": lambda: caar_ppermute_overlap_step(
            ss, sd, sg, hv, pplan, oplan, mesh, cfg, 0.1, 1.0),
    }
    exact = ("halo", "segment sum")
    for name, step in steps.items():
        out = unshard(mesh, step()[0])
        errs, ulps = {}, {}
        for k in TIER_FIELDS:
            got, want = getattr(out, k)[cfg.np1], getattr(ref, k)[cfg.np1]
            errs[k] = scaled_err(got, want)
            cont = continuity_error_t(pack_field_t(got), cs.gdof)
            ulps[k] = cont / ulp32(float(got.abs().max()))
            if not errs[k] <= TIER_TOL:
                raise AssertionError(f"phase 22 {name}: {k} at np1 "
                                     f"{errs[k]:.3e} of max|x| from "
                                     "caar_dss_step")
            if (cont != 0.0) if name in exact else ulps[k] > TIER_CONT_ULPS:
                raise AssertionError(f"phase 22 {name}: {k} continuity "
                                     f"{cont:.3e} ({ulps[k]:.2f} ulps)")
        ms = cuda_ms(step, 3)
        print(f"phase 22 tier {name} ne{cs.ne}x{NLEV} on LocalMesh({n}): "
              "scaled errors against caar_dss_step "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + "; continuity in ulps of max|x| "
              + ", ".join(f"{k} {u:.2f}" for k, u in ulps.items())
              + f"; {ms:.2f} ms a step (events, an emulation)")
    print(f"phase 22 plans ne{cs.ne} on {n} shards ({plan_s:.2f} s): "
          f"perimeter_fraction {plan.perimeter_fraction:.4f} "
          f"({plan.n_gshared} of {cs.nelem * 16} dofs), {pplan.rounds} "
          f"ppermute rounds of up to {pplan.pair_len} dofs, boundary / "
          f"interior elements a shard {oplan.nb_max} / {oplan.ni_max}")
    ran = dryrun_multichip(8, device=dev, tiers=TIERS)
    if set(ran) != set(TIERS):
        raise AssertionError(f"phase 22 dryrun_multichip(8) ran {ran}")
    print(f"phase 22 dryrun_multichip(8): {json.dumps(ran)}")


def phase_ne120(dev):
    """Phase 23: the ne120-class path, 86,400 elements x 72, f32: the build
    seconds of the cubed sphere and the plans, the assembled problem drawn
    on the card and the peak device memory after it; one CAAR launch with
    the slab held against its plain version on the last NE120_BLOCK
    elements' lanes (columns are independent; the plain version at full
    width would need ~30 GB of temporaries) at CAAR_TOL per field, the slab
    bit for bit s1 at the fix lanes; one assembled step with continuity
    exactly 0; the raw bench (``--nelem 86400``) and the assembled bench
    (``--ne 120``), NE120_STEPS chained steps a timed run. Returns (the raw
    and assembled bench results, the assembled problem) for phase 24."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (
        build_cubed_sphere, caar_dss_structured_packed_t4, continuity_error_t,
        make_structured_plan)
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        caar_t4_cuda, caar_t4_plain)
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs = build_cubed_sphere(NE120, dtype=torch.float32, device=dev)
    cs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fix = fix_tables(make_structured_plan(cs.gdof, NE120), dev)
    plan_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    const, (s0, sm1), acc, plan, rsp = bench.make_assembled_problem(
        NE120, NLEV, dev, cs=cs)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    e16 = s0.shape[1]
    print(f"phase 23 ne{NE120}: {cs.nelem} elements, E16 {e16}; cubed sphere "
          f"built in {cs_s:.1f} s, structured plan and fix tables "
          f"({fix.nfix} fix lanes) in {plan_s:.1f} s, the assembled problem "
          f"drawn on the card in {init_s:.1f} s; peak device memory after "
          f"init {peak / 2**30:.2f} GiB")
    scal, meta, qdp, pecnd, dvv = const
    # the gate's launch is not the main path's: its counts are restored
    n_launch, n_slab = caar_t4_cuda.launches, caar_t4_cuda.slab_launches
    kacc = [a.clone() for a in acc]
    got = caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd, *kacc, dvv, fix=fix)
    torch.cuda.synchronize(dev)
    caar_t4_cuda.launches, caar_t4_cuda.slab_launches = n_launch, n_slab
    lanes = slice(e16 - NE120_BLOCK * 16, e16)
    blk = lambda x: x[:, lanes].contiguous()
    want = caar_t4_plain(scal, blk(meta), blk(s0), blk(sm1), blk(qdp),
                         blk(pecnd), *(blk(a) for a in acc), dvv)
    errs = caar_field_errs(tuple(blk(x) for x in got[:5]), want, NLEV)
    if not all(e <= CAAR_TOL for e in errs.values()):
        raise AssertionError(f"phase 23 caar ne{NE120}: {errs}")
    if not torch.equal(got[5], got[0][:, fix.read_lanes.long()].T):
        raise AssertionError(f"phase 23 caar ne{NE120}: the slab is not s1 "
                             "at the fix lanes")
    del got, kacc, want
    print(f"phase 23 caar ne{NE120}x{NLEV} with the slab: the last "
          f"{NE120_BLOCK} elements' lanes ({lanes.start}..{e16 - 1}) of the "
          "full launch against caar_t4_plain on that block, scaled errors "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" (gate {CAAR_TOL:g}); slab bitwise s1 at the fix lanes")
    out = caar_dss_structured_packed_t4(scal, meta, s0, sm1, qdp, pecnd,
                                        *acc, dvv, plan, rsp)
    cont = continuity_error_t(out[0], cs.gdof)
    if cont != 0.0 or not bool(torch.isfinite(out[0]).all()):
        raise AssertionError(f"phase 23 assembled step ne{NE120}: continuity "
                             f"{cont}")
    print(f"phase 23 assembled step ne{NE120}x{NLEV}: continuity error "
          f"{cont:.1e}, finite")
    problem = (const, (out[0], s0), tuple(out[2:]), plan, rsp)
    del out, sm1
    res = {}
    for label, argv in (("raw", ["--nelem", str(cs.nelem)]),
                        ("assembled", ["--ne", str(NE120)])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res[label] = bench.main(argv + ["--nexec", str(NE120_STEPS),
                                            "--reps", "3"])
        if res[label]["init"] != "device" or not res[label]["card"]:
            raise AssertionError(f"phase 23 bench {label}: {res[label]}")
        print(f"phase 23 bench {label} " + buf.getvalue().strip())
    return res, problem


def phase_trace(dev, cs, big):
    """Phase 24: ``profiling.trace`` around 10 chained prim steps at ne30 x
    72, qsize 1 (nu 1e15, dt 0.1), and 10 chained assembled steps at ne120
    (phase 23's problem): the device's busy share and idle share of each
    window and its five longest device operations, from a trace that holds
    every CAAR launch of its window (taken again, up to TRACE_TRIES, where
    the profiler lost some); one native ``Timers`` region around the same
    10 prim steps (``get_full``)."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
    from tinman_sandbox_tpu_torch.profiling import (
        Timers, busy_share, trace, trace_path)

    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "traces")
    const, s0, qdp, acc, plan, rsp = bench.make_prim_problem(
        cs.ne, NLEV, dev, DYN_DT)
    prim = lambda: bench.run_prim(const, s0, qdp, acc, plan, rsp, 10,
                                  DYN_NU, DYN_DT)
    prim()                                        # warm-up
    torch.cuda.synchronize(dev)
    bconst, blevels, bacc, bplan, brsp = big
    runs = {f"prim ne{cs.ne}x{NLEV} qsize 1 x10": prim,
            f"assembled ne{NE120}x{NLEV} x10": lambda: bench.run_assembled(
                bconst, blevels, bacc, bplan, brsp, 10)}
    shares = {}
    for i, (label, run) in enumerate(runs.items()):
        d = os.path.join(logdir, f"window{i}")
        # a trace whose window lacks some of its CAAR launches would
        # understate the busy share: it is taken again, up to TRACE_TRIES
        for attempt in range(1, TRACE_TRIES + 1):
            n0 = caar_t4_cuda.launches
            with trace(d, device=dev):
                run()
            launched = caar_t4_cuda.launches - n0
            r = busy_share(trace_path(d))
            seen = sum(c for n, c in r["kernels"].items()
                       if "caar_chunk_kernel" in n)
            if seen == launched:
                break
            print(f"phase 24 trace {label}: attempt {attempt} holds {seen} "
                  f"of {launched} CAAR launches")
        else:
            raise AssertionError(f"phase 24 {label}: no trace held every "
                                 f"CAAR launch in {TRACE_TRIES} attempts")
        if not (0.0 < r["busy_share"] <= 1.0 and r["top"]):
            raise AssertionError(f"phase 24 {label}: no device time in the "
                                 f"trace: {r}")
        shares[label] = r["busy_share"]
        print(f"phase 24 trace {label} (attempt {attempt}, {seen} of "
              f"{launched} CAAR launches in the trace): busy "
              f"{r['busy_s'] * 1e3:.3f} ms of a {r['window_s'] * 1e3:.3f} ms "
              f"window, busy_share {r['busy_share']:.4f}, idle share "
              f"{1 - r['busy_share']:.4f}; top device operations: "
              + "; ".join(f"{n[:60]} {t * 1e3:.3f} ms x{c}"
                          for n, t, c in r["top"]))
    timers = Timers(dev)
    if not timers.is_native:
        raise AssertionError("phase 24: the native timer did not build")
    timers.reset()
    label = next(iter(runs))
    with timers.region(label):
        prim()
    calls, total, mn, mx, usr, sys_ = timers.get_full(label)
    print(f"phase 24 Timers (native) {label}: calls {calls}, total "
          f"{total * 1e3:.3f} ms, min {mn * 1e3:.3f}, max {mx * 1e3:.3f}, usr "
          f"{usr * 1e3:.3f} ms, sys {sys_ * 1e3:.3f} ms")
    return shares


def phase_bench_all_kernels(dev) -> None:
    """Phase 25's gates: each wrapper that ``tools.bench_all`` times, one
    step on the entry's own inputs (its problem builder, its seeds, at the
    JAX tool's sizes) against its plain version on the same inputs: the
    row CAAR at 1024 x 72, 8 x 26 and on the ne30 entry's problem, each
    output at CAAR_TOL scaled; the row tracer at 128 x 72 x 35, each
    tracer block at CAAR_TOL scaled; the triad bit for bit. Runs before the
    launch counts are reset, so these launches are not the sweep's."""
    import torch

    from tinman_sandbox_tpu_torch.kernels.caar import (caar_packed,
                                                       caar_packed_plain)
    from tinman_sandbox_tpu_torch.kernels.saxpby import (saxpby_cuda,
                                                         saxpby_plain)
    from tinman_sandbox_tpu_torch.kernels.tracer import (euler_packed,
                                                         euler_packed_plain)
    from tinman_sandbox_tpu_torch.tools import bench_all

    names = ("u1", "v1", "t1", "dp1", "phi", "vn0u", "vn0v", "omg")

    def caar_gate(tag, fields, acc, dvv):
        want = caar_packed_plain(*fields, *acc, dvv)
        got = caar_packed(*fields, *(a.clone() for a in acc), dvv)
        torch.cuda.synchronize()
        errs = {n: scaled_err(g, w) for n, g, w in zip(names, got, want)}
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"bench_all {tag}: non-finite output")
        print(f"phase 25 gate caar_packed {tag}: worst scaled error "
              f"{max(errs.values()):.2e} ({max(errs, key=errs.get)}) against "
              f"caar_packed_plain")
        if max(errs.values()) > CAAR_TOL:
            raise AssertionError(f"bench_all {tag}: {errs} > {CAAR_TOL}")

    for nelem, nlev in ((1024, 72), (8, 26)):
        const, acc = bench_all.caar_problem(nelem, nlev, dev)
        caar_gate(f"{nelem}x{nlev}", const[:-1], acc, const[-1])
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, _, _ = \
        bench_all.ne30_problem(30, 72, dev)
    caar_gate("ne30 x 72", (scal, meta, *s0, *sm1, qdp, pecnd), acc, dvv)

    nelem, nlev, qsize, dt = 128, 72, 35, 1e-4
    meta, vu, vv, q, dvv = bench_all.tracer_problem(nelem, nlev, qsize, dev)
    want = euler_packed_plain(meta, vu, vv, q, dvv, dt, nlev)
    got = euler_packed(meta, vu, vv, q, dvv, dt, nlev)
    torch.cuda.synchronize()
    err = max(scaled_err(a, b) for a, b in zip(got.split(nlev, 1),
                                               want.split(nlev, 1)))
    print(f"phase 25 gate euler_packed {nelem}x{nlev} qsize {qsize}: worst "
          f"scaled error of a tracer block {err:.2e} against "
          f"euler_packed_plain")
    if not bool(torch.isfinite(got).all()) or err > CAAR_TOL:
        raise AssertionError(f"bench_all tracer: {err} > {CAAR_TOL}")

    x, y = bench_all.saxpby_problem(8192, 4096, dev)
    want = saxpby_plain(0.999, 0.001, x, y)
    got = saxpby_cuda(0.999, 0.001, x.clone(), y)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("bench_all saxpby: the kernel differs from its "
                             "plain version")
    print("phase 25 gate saxpby_cuda 8192x4096 (0.999, 0.001): bit for bit "
          "saxpby_plain")


def phase_bench_all(dev) -> dict:
    """The port's benchmark sweep (``tools.bench_all``) in process at the
    JAX tool's full sizes: every entry's numbers finite and positive, each
    entry's kernel launched, the backend the card. Returns the report."""
    import math

    from tinman_sandbox_tpu_torch.tools import bench_all

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report = bench_all.main([])
    print("phase 25 bench_all " + json.dumps(report))
    if report["backend"] != "cuda" or not report["card"]:
        raise AssertionError(f"bench_all: backend {report['backend']}, card "
                             f"{report['card']}")
    keys = {"caar_1024x72": ("gridpoints_per_s", "us_per_step"),
            "caar_single_element_26lev": ("gridpoints_per_s", "us_per_step"),
            "tracer_128x72_q35": ("tracer_gridpoints_per_s", "us_per_step"),
            "ne30_caar_dss_5400elem": ("gridpoints_per_s", "us_per_step"),
            "saxpby_triad": ("gb_per_s", "us_per_step")}
    for name, want in keys.items():
        e = report[name]
        for k in (*want, "bytes_per_step", "bound_us"):
            if not (math.isfinite(e[k]) and e[k] > 0):
                raise AssertionError(f"bench_all {name}: {k} = {e[k]}")
        if min(e["kernel_launches"].values()) <= 0:
            raise AssertionError(f"bench_all {name}: launches "
                                 f"{e['kernel_launches']}")
        first = want[0]
        print(f"phase 25 {name}: {first} {e[first]:.6g}, us_per_step "
              f"{e['us_per_step']:.4f} against the bound "
              f"{e['bound_us']:.4f} us, launches "
              f"{json.dumps(e['kernel_launches'])}")
    return report


def long_rule(tag: str, step: int, fields: dict) -> None:
    """Phase 26's rule at ``step``: for each name -> (kernel, plain f32,
    plain f64), the distances kernel - f64, plain - f64 and kernel - plain
    (``scaled_err``, of max|f64| or max|plain|) printed; fails where the
    kernel's distance from f64 exceeds LONG_RATIO x the plain run's plus
    LONG_FLOOR."""
    import torch

    parts, bad = [], []
    for name, (k, p, d) in fields.items():
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{tag}: non-finite {name} at step {step}")
        dk, dp, dkp = scaled_err(k, d), scaled_err(p, d), scaled_err(k, p)
        parts.append(f"{name} {dk:.3e} / {dp:.3e} / {dkp:.3e}")
        if not dk <= LONG_RATIO * dp + LONG_FLOOR:
            bad.append(f"{name} {dk:.3e} > {LONG_RATIO:g} x {dp:.3e} + "
                       f"{LONG_FLOOR:g}")
    print(f"phase 26 {tag} step {step}: kernel-f64 / plain-f64 / "
          "kernel-plain " + ", ".join(parts))
    if bad:
        raise AssertionError(f"{tag} step {step}: " + "; ".join(bad))


def _shown(i: int, last: int) -> bool:
    return i in LONG_SHOWN or i == last


def f64_mass(sph, x) -> float:
    """sum(sph * x) in float64 over the [k, E16] field x (f32 or f64)."""
    return float((sph.double() * x.double()).sum())


def long_conservation(dev, cs, plan) -> None:
    """Phase 26's projections: PROJECTIONS passes c <- rsp*DSS(sph*c) of a
    positive random [NLEV, E16] field through the DSS kernels (extract,
    fixup, sweep) with the one-float rspheremp row and with the two-float
    pair (``rsp_lanes_2f``), each beside the same passes on the plain
    versions in f32 and the exact projection in float64 (sph and
    hi + lo as float64); the two-float drift d2 < CONSERVE_DRIFT and
    < d1 / 5, the kernels bit for bit the plain f32 passes."""
    import torch

    from tinman_sandbox_tpu_torch.dist import rsp_lanes_2f
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_plain, dss_fixup_plain, dss_structured_t_cuda,
        dss_sweep_plain, fix_tables)

    fix = fix_tables(plan, dev)
    sph = cs.geometry.spheremp.to(torch.float32).reshape(1, -1)
    rsp2 = torch.from_numpy(rsp_lanes_2f(cs.geometry.spheremp, cs.gdof,
                                         cs.ndof)).to(dev)
    rsp1 = cs.geometry.rspheremp.to(torch.float32).reshape(1, -1)
    rsp64 = (rsp2[0:1].double() + rsp2[1:2].double())

    def plain(x, rsp):
        return dss_sweep_plain(x, rsp, dss_fixup_plain(
            dss_extract_plain(x, fix), fix, rsp), fix)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = torch.randn(NLEV, cs.nelem * 16, generator=gen, device=dev).abs() + 1
    d = plain(sph.double() * x0.double(), rsp64)
    exact = {0: d}
    for i in range(1, PROJECTIONS + 1):
        d = plain(sph.double() * d, rsp64)
        if _shown(i, PROJECTIONS):
            exact[i] = d
    drifts = {}
    for case, rsp in (("one-float", rsp1), ("two-float", rsp2)):
        k = dss_structured_t_cuda((sph * x0).contiguous(), plan, rsp)
        p = plain(sph * x0, rsp)
        m0, p0 = f64_mass(sph, k), f64_mass(sph, p)
        t0 = time.perf_counter()
        for i in range(1, PROJECTIONS + 1):
            k = dss_structured_t_cuda((sph * k).contiguous(), plan, rsp)
            p = plain(sph * p, rsp)
            if _shown(i, PROJECTIONS):
                long_rule(f"projection {case} rsp", i,
                          {"c": (k, p, exact[i])})
                if not torch.equal(k, p):
                    raise AssertionError(f"projection {case}: the DSS "
                                         "kernels left their plain "
                                         f"versions' bits at pass {i}")
        drifts[case] = abs(f64_mass(sph, k) - m0) / abs(m0)
        d64 = f64_mass(sph, exact[PROJECTIONS]) / f64_mass(sph, exact[0])
        print(f"phase 26 projection {case} rsp x{PROJECTIONS}: relative "
              f"mass drift kernels {drifts[case]:.3e}, plain f32 "
              f"{abs(f64_mass(sph, p) - p0) / abs(p0):.3e}, f64 "
              f"{abs(d64 - 1.0):.3e} ({time.perf_counter() - t0:.1f} s with "
              "the plain twin)")
    d1, d2 = drifts["one-float"], drifts["two-float"]
    if not (d2 < CONSERVE_DRIFT and d2 < d1 / 5):
        raise AssertionError(f"projection: d2 {d2:.3e} not < "
                             f"{CONSERVE_DRIFT:g} and d1/5 {d1 / 5:.3e}")


def long_bell(dev, cs, plan) -> None:
    """Phase 26's cosine bell through ``ssprk3_tracer_packed_t`` (the Euler
    or limited tracer kernel, fixup and sweep a stage) at every one of the
    NLEV levels, its radius falling over them, carried by solid-body zonal
    winds in the wind rows: once round the sphere without the limiter, half
    round with it, beside the plain f32 and float64 twins at every
    TWIN_STRIDE-th level."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch.constants import CONSTANTS
    from tinman_sandbox_tpu_torch.dist import (
        cosine_bell, rsp_lanes_2f, ssprk3_tracer_packed_t,
        ssprk3_tracer_packed_t_plain)
    from tinman_sandbox_tpu_torch.kernels.dss import dss_structured_t_cuda
    from tinman_sandbox_tpu_torch.kernels.layout import (META_COLS,
                                                         pack_field_t,
                                                         pack_meta_t)

    geom = cs.geometry
    nsteps = BELL_STEPS_PER_NE * cs.ne
    dt = BELL_PERIOD / nsteps
    u0 = 2.0 * np.pi * CONSTANTS.rearth / BELL_PERIOD
    radii = np.linspace(*LEVEL_RADII, NLEV)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        dev, torch.float32)
    bell = f32(np.stack([cosine_bell(cs.sphere_xyz, r) for r in radii], 1))
    wind = np.broadcast_to((u0 * np.cos(cs.lat))[:, None],
                           (cs.nelem, NLEV, 4, 4))
    vu = pack_field_t(f32(wind))
    vv = torch.zeros_like(vu)
    meta = pack_meta_t(geom, torch.zeros_like(geom.spheremp), torch.float32)
    dvv = geom.dvv.to(torch.float32).contiguous()
    rsp = torch.from_numpy(rsp_lanes_2f(geom.spheremp, cs.gdof,
                                        cs.ndof)).to(dev)
    sph = meta[META_COLS.index("spheremp")]
    q0 = dss_structured_t_cuda((sph * pack_field_t(bell)).contiguous(),
                               plan, rsp)
    lv = sorted(set(range(0, NLEV, TWIN_STRIDE)) | {NLEV - 1})
    vu_t, vv_t = vu[lv].contiguous(), vv[lv].contiguous()
    ops64 = [x.double() for x in (dvv, meta, vu_t, vv_t)]
    m0, m0_t = f64_mass(sph, q0), f64_mass(sph, q0[lv])
    print(f"phase 26 bell ne{cs.ne}x{NLEV}: radius {LEVEL_RADII[0]} -> "
          f"{LEVEL_RADII[1]} rad over the levels, dt {dt:.3f} s, {nsteps} "
          f"steps a revolution, u0 {u0:.3f} m/s, max {float(q0.max()):.4f}; "
          f"the twins at levels {lv}")
    for limit, steps in ((False, nsteps), (True, nsteps // 2)):
        tag = f"bell {'limited, half' if limit else 'full'} revolution"
        k, p, d = q0, q0[lv].contiguous(), q0[lv].double()
        k_s = 0.0
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            k = ssprk3_tracer_packed_t(dvv, meta, vu, vv, k, plan, rsp, dt,
                                       NLEV, limit=limit)
            torch.cuda.synchronize()
            k_s += time.perf_counter() - t1
            p = ssprk3_tracer_packed_t_plain(dvv, meta, vu_t, vv_t, p, plan,
                                             rsp, dt, len(lv), limit=limit)
            d = ssprk3_tracer_packed_t_plain(*ops64, d, plan, rsp.double(),
                                             dt, len(lv), limit=limit)
            if _shown(i, steps):
                long_rule(tag, i, {"q": (k[lv], p, d)})
        drift = {"kernel": f64_mass(sph, k[lv]) / m0_t - 1.0,
                 "plain": f64_mass(sph, p) / m0_t - 1.0,
                 "f64": f64_mass(sph, d) / m0_t - 1.0}
        whole = f64_mass(sph, k) / m0 - 1.0
        l2 = float((k.double() - q0.double()).norm() / q0.double().norm())
        lvl = ((k.double() - q0.double()).norm(dim=1)
               / q0.double().norm(dim=1))
        qmin, qmax = float(k.min()), float(k.max())
        print(f"phase 26 {tag}: {steps} steps, kernels "
              f"{k_s / steps * 1e3:.3f} ms a step "
              f"({time.perf_counter() - t0:.1f} s with both twins); L2 error "
              f"{l2:.4f} (levels "
              f"{float(lvl.min()):.4f}-{float(lvl.max()):.4f}), min "
              f"{qmin:.3e}, max {qmax:.4f}; relative mass drift kernels "
              f"{whole:.3e} (all levels); at the twins' levels kernels "
              f"{drift['kernel']:.3e}, plain f32 {drift['plain']:.3e}, f64 "
              f"{drift['f64']:.3e}")
        if not abs(whole) < BELL_MASS_TOL or not \
                abs(drift["kernel"]) <= LONG_RATIO * abs(drift["plain"]) \
                + LONG_FLOOR:
            raise AssertionError(f"{tag}: mass drift {whole}, at the twins' "
                                 f"levels {drift}")
        if limit:
            if not (qmin > -BELL_LIMIT_SLACK
                    and qmax < 1.0 + BELL_LIMIT_SLACK):
                raise AssertionError(f"{tag}: min {qmin}, max {qmax}")
        elif not (l2 < BELL_L2 and BELL_PEAK[0] < qmax < BELL_PEAK[1]):
            raise AssertionError(f"{tag}: L2 {l2}, max {qmax}")
        del k, p, d
        torch.cuda.empty_cache()


def packed_norms(s, nlev: int) -> dict:
    """tests/test_soak.py's norms of a stacked [4*nlev, E16] state in
    float64: ||(u, v)||, ||T||, ||dp||."""
    u, v, t, dp = (x.double() for x in s.split(nlev))
    return {"v": float((u.square().sum() + v.square().sum()).sqrt()),
            "T": float(t.norm()), "dp": float(dp.norm())}


def long_soak(dev, cs) -> None:
    """Phase 26's prim soak: SOAK_STEPS chained ``bench.run_prim`` steps
    with the limiter at DYN_DT and DYN_NU from ``bench.make_prim_problem``'s
    random init, beside the plain f32 and float64 twins: continuity 0 after
    every step, finite, dp3d > 0, the norms bounded, the long-run rule for
    u, v, T, dp and qdp."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (continuity_error_t,
                                               prim_step_packed_t4_plain)

    const, s0, qdp, acc, plan, rsp = bench.make_prim_problem(
        cs.ne, NLEV, dev, DYN_DT, 1, seed=SEED)
    f64 = lambda xs: tuple(x.double() for x in xs)
    const64, rsp64 = f64(const), rsp.double()
    kst = (s0, qdp, tuple(a.clone() for a in acc))
    pst = (s0, qdp, tuple(a.clone() for a in acc))
    dst = (s0.double(), qdp.double(), f64(acc))
    n0 = packed_norms(s0, NLEV)
    k_s = 0.0
    tag = f"prim soak ne{cs.ne}x{NLEV}"
    for i in range(1, SOAK_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *kst, kphi = bench.run_prim(const, *kst, plan, rsp, 1, DYN_NU, DYN_DT,
                                    1, True)
        torch.cuda.synchronize()
        k_s += time.perf_counter() - t0
        for name, x in (("state", kst[0]), ("tracer", kst[1])):
            cont = continuity_error_t(x, cs.gdof)
            if cont != 0.0:
                raise AssertionError(f"{tag}: {name} continuity {cont} after "
                                     f"step {i}")
        *pst, _ = bench.run_prim(const, *pst, plan, rsp, 1, DYN_NU, DYN_DT, 1,
                                 True, step=prim_step_packed_t4_plain)
        *dst, _ = bench.run_prim(const64, *dst, plan, rsp64, 1, DYN_NU,
                                 DYN_DT, 1, True,
                                 step=prim_step_packed_t4_plain)
        if _shown(i, SOAK_STEPS):
            fields = {n: (a, b, c) for n, a, b, c in zip(
                ("u", "v", "T", "dp"), kst[0].split(NLEV),
                pst[0].split(NLEV), dst[0].split(NLEV))}
            fields["qdp"] = (kst[1], pst[1], dst[1])
            long_rule(tag, i, fields)
    ks, kq, kacc = kst
    for x in (ks, kq, kphi, *kacc):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: non-finite output")
    n1 = packed_norms(ks, NLEV)
    dp_min, q_min = float(ks[3 * NLEV:].min()), float(kq.min())
    print(f"phase 26 {tag} x{SOAK_STEPS} (limiter, dt {DYN_DT}, nu "
          f"{DYN_NU:g}): {k_s / SOAK_STEPS * 1e3:.3f} ms a step on the "
          f"kernels ({card_line()}); continuity 0 after every step for the "
          f"state and the tracer; min dp {dp_min:.3f}, min qdp {q_min:.3e}; "
          "norms start -> end " + ", ".join(
              f"{n} {n0[n]:.6e} -> {n1[n]:.6e}" for n in n0))
    if not dp_min > 0.0:
        raise AssertionError(f"{tag}: min dp {dp_min}")
    for n in n0:
        if not n1[n] < 10.0 * (n0[n] + 1.0):
            raise AssertionError(f"{tag}: norm {n} {n0[n]} -> {n1[n]}")


def phase_long_runs(dev, cs) -> None:
    """Phase 26: the JAX suite's long-run gates at ne30 x 72 through the
    kernels (the projections, the bell with and without the limiter, the
    prim soak)."""
    import torch

    from tinman_sandbox_tpu_torch.dist import make_structured_plan

    plan = make_structured_plan(cs.gdof, cs.ne)
    for run in (lambda: long_conservation(dev, cs, plan),
                lambda: long_bell(dev, cs, plan),
                lambda: long_soak(dev, cs)):
        t0 = time.perf_counter()
        run()
        torch.cuda.empty_cache()
        print(f"phase 26 part seconds: {time.perf_counter() - t0:.1f}")


def phase_equiv(dev) -> dict:
    """Phase 27: ``tools.equiv_check`` at ne30 (every kernel path against an
    independent form on the card), its report written to a temporary file
    and printed as one line; fails unless it passes. Returns the report."""
    import tempfile

    from tinman_sandbox_tpu_torch.tools import equiv_check

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "equiv.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = equiv_check.main(["--ne", str(NE), "--out", out])
        with open(out) as f:
            report = json.load(f)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if len(lines) != 1 or json.loads(lines[0]) != report:
        raise AssertionError("equiv_check: the printed line is not its "
                             "report")
    print("phase 27 equiv_check " + lines[0])
    print(f"phase 27 equiv_check --ne {NE}: pass {report['pass']}; worst "
          f"single step {report['worst_relmax']:.3e} ({report['worst_key']}),"
          f" prim {report['prim_worst_relmax']:.3e}, q35 "
          f"{report['prim_q35_worst_relmax']:.3e}, q35 limited "
          f"{report['prim_q35_limit_worst_relmax']:.3e} (mass drift "
          f"{report['prim_packed_q35_limit_relmax']['mass_drift']:.3e}); "
          f"card {report['card']}")
    if rc != 0 or not report["pass"]:
        raise AssertionError(f"equiv_check failed its pass rule: {report}")
    return report


def run_tool(module, argv, phase: int = 28) -> list:
    """``module.main(argv)`` with its printed lines captured; prints each
    as "phase <phase> <tool> <line>" and returns them."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    name = module.__name__.rsplit(".", 1)[-1]
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    for ln in lines:
        print(f"phase {phase} {name} {' '.join(argv)}: {ln}")
    return lines


def _tool_json(lines) -> dict:
    """The JSON lines of a tool's output merged into one dict."""
    out = {}
    for ln in lines:
        if ln.startswith("{"):
            out.update(json.loads(ln))
    return out


def tool_gate(name: str, report: dict, stages) -> None:
    """Every stage a tool reported has finite positive times and the card's
    line."""
    for stage in stages:
        line = report.get(stage)
        if not isinstance(line, dict) or not line["us_per_call"] > 0 \
                or not line["host_us_per_call"] > 0 or not line["card"] \
                or line["clock"] != "cuda events":
            raise AssertionError(f"{name}: stage {stage}: {line}")


def phase_axes(dev) -> None:
    """Phase 28's GSPMD axes: the level-sharded CAAR over
    LocalMesh(LEVEL_SHARDS) at ne30 x 72 (rsplit 1 and 0, hybi ramp) and
    the (e, q) mesh's Euler step at ne30 x EQ_QSIZE, each against its
    unsharded form in f32 and f64."""
    import dataclasses

    import torch

    from tinman_sandbox_tpu_torch import (
        Config, analytic_hvcoord, random_state, zero_derived)
    from tinman_sandbox_tpu_torch.dist import build_cubed_sphere
    from tinman_sandbox_tpu_torch.dist.level_sharded import (
        caar_level_sharded, euler_step_sharded, shard_levels, unshard_levels)
    from tinman_sandbox_tpu_torch.dist.sharding import LocalMesh
    from tinman_sandbox_tpu_torch.kernels.caar_array import caar_array
    from tinman_sandbox_tpu_torch.timeloop.tracer import euler_step

    cs64 = build_cubed_sphere(NE, dtype=torch.float64, device=dev)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).rsplit(".", 1)[-1]
        geom = cs64.geometry.to(dtype=dtype)
        for rsplit in (1, 0):
            cfg = Config(nelem=cs64.nelem, nlev=NLEV, rsplit=rsplit)
            kw = dict(dtype=dtype, device=dev)
            st, dv = random_state(cfg, seed=SEED, **kw), zero_derived(cfg,
                                                                      **kw)
            hv = analytic_hvcoord(cfg, **kw)
            hv = dataclasses.replace(hv, hybi=torch.linspace(
                0.0, 1.0, NLEV + 1, **kw))
            mesh = LocalMesh(LEVEL_SHARDS, dev)
            t0 = time.perf_counter()
            ss, ds = shard_levels(mesh, st, dv)
            out = caar_level_sharded(mesh, ss, ds, geom, hv, cfg, 0.1, 1.0)
            got_s, got_d = unshard_levels(mesh, *out)
            torch.cuda.synchronize(dev)
            sharded_s = time.perf_counter() - t0
            want_s, want_d = caar_array(st, dv, geom, hv, cfg, 0.1, 1.0,
                                        device=dev)
            errs = {name: scaled_err(getattr(got_s, name)[cfg.np1],
                                     getattr(want_s, name)[cfg.np1])
                    for name in ("u", "v", "t", "dp3d")}
            errs.update({name: scaled_err(getattr(got_d, name),
                                          getattr(want_d, name))
                         for name in ("phi", "omega_p", "eta_dot_dpdn",
                                      "vn0_u")})
            per = NLEV // LEVEL_SHARDS
            print(f"phase 28 level-sharded caar ne{NE}x{NLEV} {tag} rsplit "
                  f"{rsplit} over LocalMesh({LEVEL_SHARDS}) ({per} levels a "
                  f"shard; {sharded_s:.2f} s): scaled "
                  "errors against caar_array "
                  + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                  + f" (gate {AXES_TOL[tag]:g})")
            if not all(e <= AXES_TOL[tag] for e in errs.values()):
                raise AssertionError(f"phase 28 level-sharded caar {tag} "
                                     f"rsplit {rsplit}: {errs}")
            del st, dv, ss, ds, out, got_s, got_d, want_s, want_d
        cfg = Config(nelem=cs64.nelem, nlev=NLEV, qsize=EQ_QSIZE)
        st = random_state(cfg, seed=SEED, dtype=dtype, device=dev)
        qdp, vu, vv = st.qdp[cfg.qn0], st.u[cfg.n0], st.v[cfg.n0]
        mesh = LocalMesh(EQ_MESH, dev, axis_names=("e", "q"))
        for dt in (0.3, 1e4):
            want = euler_step(qdp, vu, vv, geom, cfg, dt)
            got = euler_step_sharded(mesh, qdp, vu, vv, geom, cfg, dt,
                                     tracer_axis="q", elem_axis="e")
            q_only = euler_step_sharded(LocalMesh(EQ_MESH[1], dev,
                                                  axis_names=("q",)),
                                        qdp, vu, vv, geom, cfg, dt)
            err = max(scaled_err(got, want), scaled_err(q_only, want))
            moved = scaled_err(want, qdp)
            print(f"phase 28 euler_step ne{NE}x{NLEV} qsize {EQ_QSIZE} {tag} "
                  f"dt {dt:g} on the {EQ_MESH} (e, q) mesh and on "
                  f"{EQ_MESH[1]} tracer shards: scaled error {err:.2e} (gate "
                  f"{EULER_TOL[tag]:g}), bit for bit "
                  f"{torch.equal(got, want) and torch.equal(q_only, want)}; "
                  f"the step moved qdp by {moved:.2e} of it")
            if not err <= EULER_TOL[tag]:
                raise AssertionError(f"phase 28 euler_step {tag}: {err}")
        del st, qdp, vu, vv
    torch.cuda.empty_cache()


def phase_tools(dev) -> dict:
    """Phase 28: the breakdown tools at full size, the tracer path at ne120
    x qsize 35 with its gates (``profile_prim --gate``), and the GSPMD axes
    (``phase_axes``). Returns the tools' reports by run."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.dss import dss_structured_t_cuda
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
    from tinman_sandbox_tpu_torch.tools import (
        profile_dss, profile_dss_ne120, profile_limiter, profile_prim)

    # the in-place tracer draw of make_prim_problem against the stacked
    # draw it replaced (torch.rand of the rows after the first tracer)
    (scal, meta, q0, pecnd, dvv), s0, acc, plan, rsp = \
        bench.make_dynamics_problem(NE, NLEV, dev, DYN_DT)
    gen = torch.Generator(device=dev).manual_seed(7)
    more = torch.rand(2 * NLEV, q0.shape[1], generator=gen, device=dev)
    sph = meta[META_COLS.index("spheremp")]
    want = dss_structured_t_cuda(torch.cat([q0, more]) * sph, plan, rsp)
    got = bench.make_prim_problem(NE, NLEV, dev, DYN_DT, 3)[2]
    if not torch.equal(got, want):
        raise AssertionError("make_prim_problem: the in-place draw is not "
                             "the stacked draw's bits")
    print(f"phase 28 make_prim_problem ne{NE}x{NLEV} qsize 3: the in-place "
          "draw bit for bit the stacked torch.rand draw")
    del scal, meta, q0, pecnd, dvv, s0, acc, more, sph, want, got
    torch.cuda.empty_cache()

    reports = {}
    n = ["--nexec", str(TOOL_NEXEC)]
    for label, argv in (("prim q1", ["--ne", str(NE), "--qsize", "1"]),
                        (f"prim q{QSIZE_TALL} limit",
                         ["--ne", str(NE), "--qsize", str(QSIZE_TALL),
                          "--limit"])):
        t0 = time.perf_counter()
        rep = _tool_json(run_tool(profile_prim, argv + n))
        q = rep["qsize"]
        stages = ["ssprk3_dynamics", "hyperviscosity", f"tracers_q{q}",
                  f"tracer_kernel_q{q}", f"tracer_dss_q{q}", "prim_step"]
        tool_gate(f"profile_prim {label}", rep, stages)
        print(f"phase 28 profile_prim {label}: sum {rep['sum_us']:.1f} us, "
              f"composed step {rep['prim_step_us']:.1f} us (gap "
              f"{rep['gap_us']:.1f}); graph sum {rep['sum_graph_us']}, "
              f"composed {rep['prim_step_graph_us']}; "
              f"{time.perf_counter() - t0:.1f} s")
        reports[label] = rep
    t0 = time.perf_counter()
    rep = _tool_json(run_tool(profile_dss, ["--ne", str(NE)] + n))
    tool_gate("profile_dss", rep, ["kernel_t4", "full_step_t4", "full_dss",
                                   "sweep_only", "extract+fixup",
                                   "c_sweep_only", "c_fixup+scat"])
    if not str(rep.get("scatter_zeros", "")).startswith("not applicable"):
        raise AssertionError(f"profile_dss: scatter_zeros {rep}")
    print(f"phase 28 profile_dss: {time.perf_counter() - t0:.1f} s")
    reports["dss"] = rep
    t0 = time.perf_counter()
    rep = json.loads(run_tool(profile_limiter, ["--ne", str(NE)] + n)[-1])
    if set(rep["stage_us"]) != {"nolimit", "limit_i0", "limit_i1",
                                "limit_i2"} \
            or not all(v > 0 for v in rep["stage_us"].values()) \
            or not rep["card"]:
        raise AssertionError(f"profile_limiter: {rep}")
    print(f"phase 28 profile_limiter: {time.perf_counter() - t0:.1f} s")
    reports["limiter"] = rep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep = _tool_json(run_tool(profile_dss_ne120, ["--nexec", "4"]))
    tool_gate("profile_dss_ne120", rep, ["kernel_t4", "full_step", "c_sweep",
                                         "c_fixup"])
    print(f"phase 28 profile_dss_ne120: {time.perf_counter() - t0:.1f} s")
    reports["dss ne120"] = rep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep = _tool_json(run_tool(profile_prim, [
        "--ne", str(NE120), "--qsize", str(QSIZE_TALL), "--limit", "--gate",
        "--nexec", "2"]))
    g = rep["gates"]
    tool_gate("profile_prim ne120", rep, [
        "ssprk3_dynamics", "hyperviscosity", f"tracers_q{QSIZE_TALL}",
        f"tracer_kernel_q{QSIZE_TALL}", f"tracer_limit_kernel_q{QSIZE_TALL}",
        f"tracer_dss_q{QSIZE_TALL}", "prim_step"])
    print(f"phase 28 tracer path ne{NE120}x{NLEV} qsize {QSIZE_TALL} limited: "
          f"Euler kernel {g['euler_block_err']:.2e} and limited kernel "
          f"{g['limit_block_err']:.2e} of plain on the last "
          f"{g['gate_elems']} elements (gate 5e-05); one SSPRK3 step: "
          f"continuity {g['continuity']:.1e}, relative mass change "
          f"{g['mass_rel_change']:.3e} (gate 4e-06), min qdp "
          f"{g['min_qdp']:.3e}; the step "
          f"{rep[f'tracers_q{QSIZE_TALL}']['us_per_call']:.1f} us, the prim "
          f"step {rep['prim_step_us']:.1f} us; peak "
          f"{rep['peak_device_bytes'] / 2**30:.2f} GiB; card {rep['card']}; "
          f"{time.perf_counter() - t0:.1f} s")
    reports["tracer path ne120"] = rep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_axes(dev)
    print(f"phase 28 GSPMD axes: {time.perf_counter() - t0:.1f} s")
    return reports


def storage_modes(fix=None, rsp=None):
    """Phase 29's CAAR entries on the rsplit=0 t arguments (``r0_cases``):
    name -> (operands of the arguments, fresh accumulators each call;
    kernel; plain version; whether the new state is one stacked output).
    With ``fix`` and ``rsp`` (the ne30 grid) the stacked step takes the
    slab, and the ring runs with and without mix."""
    import torch

    from tinman_sandbox_tpu_torch.kernels.caar import (
        caar_packed, caar_packed_plain, caar_packed_rsplit0,
        caar_packed_rsplit0_plain)
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        caar_packed_rsplit0_t, caar_packed_rsplit0_t_plain, caar_packed_t,
        caar_t4_cuda, caar_t4_plain)
    from tinman_sandbox_tpu_torch.kernels.ring_fused import (
        caar_ring_packed_t4, caar_ring_plain)

    cl = lambda xs: [x.clone() for x in xs]
    stacked = lambda a: (a[0], a[2], torch.cat(a[3:7]), torch.cat(a[7:11]),
                         a[11], a[12], *cl(a[13:16]), a[17])

    def t_plain(*x):
        """``caar_t4_plain`` in ``caar_packed_t``'s call and output form."""
        kk = x[10].shape[0]
        s1, *rest = caar_t4_plain(x[0], x[1], torch.cat(x[2:6]),
                                  torch.cat(x[6:10]), *x[10:])
        return (*s1.split(kk), *rest)

    modes = {
        "t4": (stacked, caar_t4_cuda, caar_t4_plain, True),
        "t": (lambda a: (a[0], a[2], *a[3:13], *cl(a[13:16]), a[17]),
              caar_packed_t, t_plain, False),
        "t r0": (lambda a: (*a[:13], *cl(a[13:17]), a[17]),
                 caar_packed_rsplit0_t, caar_packed_rsplit0_t_plain, False),
        "row": (lambda a: row_args(a, hyb=False), caar_packed,
                caar_packed_plain, False),
        "row r0": (row_args, caar_packed_rsplit0, caar_packed_rsplit0_plain,
                   False),
    }
    if fix is None:
        return modes
    modes["t4"] = (stacked, lambda *x: caar_t4_cuda(*x, fix=fix),
                   lambda *x: caar_t4_plain(*x, fix=fix), True)
    for name, mix in (("ring", False), ("ring mix", True)):
        def build(a, mix=mix):
            x = stacked(a)
            # the mix field: a copy of s0 (never an output)
            return (*x, rsp, fix, (x[2].clone(), 0.25, 0.75) if mix
                    else None)
        modes[name] = (build,
                       lambda *x: caar_ring_packed_t4(*x[:-1], mix=x[-1]),
                       lambda *x: caar_ring_plain(*x[:-1], mix=x[-1]), True)
    return modes


def storage_args(targs, storage: str):
    """The rsplit=0 t arguments with the nm1 fields (indices 7-10), qdp and
    pecnd (11, 12) in ``storage``'s contract (``caar_t.STORAGE``)."""
    import torch

    bf = {"f32": (), "bf16_aux": (11, 12),
          "bf16_ro": (7, 8, 9, 10, 11, 12)}[storage]
    return tuple(x.to(torch.bfloat16) if i in bf else x
                 for i, x in enumerate(targs))


def upcast(args):
    """Every bf16 tensor of ``args`` as a new f32 tensor (the f32 mode's
    operands for the bit-for-bit gate)."""
    import torch

    return tuple(x.float() if isinstance(x, torch.Tensor)
                 and x.dtype == torch.bfloat16 else x for x in args)


def flat_outputs(out):
    """The tensors of one call's outputs, in order."""
    import torch

    return [x for x in out if isinstance(x, torch.Tensor)]


def call_bytes(args, out) -> int:
    """Bytes one call must move: each tensor operand read once (the fix
    tables aside) and each output written once."""
    import torch

    ins = [x for x in args if isinstance(x, torch.Tensor)]
    ins += [x[0] for x in args if isinstance(x, tuple)]          # mix field
    return sum(x.numel() * x.element_size() for x in ins + flat_outputs(out))


def storage_counts():
    """The storage launch counters of the five CAAR wrappers, the two tracer
    stages and the sweep."""
    from tinman_sandbox_tpu_torch.kernels.caar import (
        caar_packed, caar_packed_rsplit0)
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        caar_packed_rsplit0_t, caar_t4_cuda)
    from tinman_sandbox_tpu_torch.kernels.dss import dss_sweep_cuda
    from tinman_sandbox_tpu_torch.kernels.ring_fused import (
        caar_ring_packed_t4)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (
        tracer_euler_cuda, tracer_limit_cuda)

    return {w.__name__: w.storage_launches
            for w in (caar_t4_cuda, caar_packed_rsplit0_t, caar_packed,
                      caar_packed_rsplit0, caar_ring_packed_t4,
                      tracer_euler_cuda, tracer_limit_cuda, dss_sweep_cuda)}


def storage_plans(dev, ncol: int, nlev: int) -> None:
    """The plans of the storage instances beside the f32 ones: each family's
    blocks an SM by cudaOccupancy in f32, bf16_aux and bf16_ro against the
    plan's reckoning (printed; a drop would show here), and nvcc's
    registers and spills of every storage instance."""
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        STORAGE, caar_plan, caar_row_plan)
    from tinman_sandbox_tpu_torch.kernels.ring_fused import ring_plan

    lib = _build.library("caar")
    r0 = caar_plan(ncol, nlev, r0=True)
    fams = {"caar_chunk_kernel": (0, caar_plan(ncol, nlev)),
            "caar_ring_kernel": (1, ring_plan(ncol, nlev, NE).caar),
            "caar_row_kernel rsplit>0": (2, caar_row_plan(ncol, nlev)),
            "caar_row_kernel rsplit=0": (3, caar_row_plan(ncol, nlev, True)),
            "caar_r0_kernel": (5 if r0.cap else 4, r0)}
    for fam, (fused, p) in fams.items():
        occ = {s: lib.caar_blocks_per_sm(fused, nlev, p.chunks, int(p.stash),
                                         code, dev.index)
               for s, code in STORAGE.items()}
        if min(occ.values()) <= 0:
            raise AssertionError(f"{fam} occupancy: {occ}")
        note = "" if len(set(occ.values())) == 1 else " (CHANGED by storage)"
        print(f"phase 29 plan {fam} ncol {ncol} x {nlev}: {p.chunks} chunks, "
              f"{'stash' if p.stash else 'no stash'}, {p.smem} B shared, "
              f"{p.blocks_per_sm} blocks a SM reckoned; cudaOccupancy "
              + ", ".join(f"{s} {n}" for s, n in occ.items()) + note)
    for tag in ("caar_chunk_kernel", "caar_row_kernel", "caar_r0_kernel",
                "caar_ring_kernel"):
        for inst, report in ptxas_report("caar", tag):
            if inst.endswith(("Li1EE", "Li2EE")):
                print(f"phase 29 ptxas {tag}{inst}: {report}")


def phase_storage_kernels(dev, cs) -> dict:
    """Phase 29: the CAAR kernels' bf16 storage (``storage="bf16_aux"`` /
    ``"bf16_ro"``). Every entry (the t pair step stacked and unstacked, with
    the slab at ne30, t rsplit=0, row at both rsplits, the ring with and
    without mix) in each storage, in the bench and vort cases at 1024 x 72
    and ne30 x 72 and at 1024 x CAAR_OTHER_NLEV (bench case): bit for bit
    the same kernel in f32 mode on the bf16 operands upcast, within CAAR_TOL
    of its plain version on the same operands, and (bench case) within the
    JAX tests' envelopes of its f32 run; the storage launch counters rise by
    the bf16 launches only; a bf16 call allocates its outputs alone (no f32
    copy of an operand); the times of each mode by events and from CUDA
    graphs beside their bounds, and the bf16_ro chain's rotation cast
    alone. Returns extra keys for the kernel rows."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables

    problems = []
    for nlev in (NLEV, *CAAR_OTHER_NLEV):
        const, acc = bench.make_problem(1024, nlev, dev, seed=7)
        problems.append((f"1024x{nlev}", const, acc, storage_modes(),
                         nlev == NLEV))
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(cs.ne, NLEV, dev, cs=cs)
    fix = fix_tables(plan, dev)
    problems.append((f"ne{cs.ne}x{NLEV}", (scal, meta, s0, sm1, qdp, pecnd,
                                           dvv), acc,
                     storage_modes(fix, rsp), True))
    storage_plans(dev, NE * NE * 6 * 16, NLEV)
    rows = {}
    counts0, expect = storage_counts(), {w: 0 for w in storage_counts()}
    for tag, const, acc, modes, main in problems:
        cases = [(n, a) for n, a in r0_cases(const, acc)
                 if n == "bench" or (main and n == "vort")]
        for case, targs in cases:
            k = targs[11].shape[0]
            for name, (build, kern, plain, stacked) in modes.items():
                for storage in STORAGE_MODES:
                    args = build(storage_args(targs, storage))
                    got = flat_outputs(kern(*args))
                    expect[STORAGE_WRAPPER[name]] += 1
                    up = flat_outputs(kern(*upcast(build(
                        storage_args(targs, storage)))))
                    want = flat_outputs(plain(*build(storage_args(
                        targs, storage))))
                    torch.cuda.synchronize()
                    same = all(torch.equal(g, u) for g, u in zip(got, up))
                    errs = [scaled_err(g, w) for g, w in zip(got, want)]
                    if not same or len(got) != len(up) or \
                            max(errs) > CAAR_TOL or \
                            any(g.dtype != torch.float32 for g in got) or \
                            not all(bool(torch.isfinite(g).all())
                                    for g in got):
                        raise AssertionError(
                            f"phase 29 {name} {tag} {case} {storage}: bits "
                            f"{same}, plain {errs}")
                    env = ""
                    if case == "bench":
                        f32 = flat_outputs(kern(*build(targs)))
                        new = (lambda o: o[0].split(k)) if stacked \
                            else (lambda o: o[:4])
                        envs = [scaled_err(a, b) for a, b in
                                zip(new(got), new(f32))]
                        if max(envs) > STORAGE_ENVELOPE[storage]:
                            raise AssertionError(
                                f"phase 29 {name} {tag} {storage}: "
                                f"{envs} of f32 > "
                                f"{STORAGE_ENVELOPE[storage]}")
                        env = f"; of f32 {max(envs):.3e}"
                    print(f"phase 29 {name} {tag} {case} {storage}: bit for "
                          f"bit the f32 mode on the upcast operands; plain "
                          f"{max(errs):.3e}{env}")
    counts = storage_counts()
    got = {w: counts[w] - counts0[w] for w in counts}
    if got != expect:
        raise AssertionError(f"phase 29 storage launches {got} != the bf16 "
                             f"calls {expect}")
    print(f"phase 29 storage launches (bf16 calls only): {json.dumps(got)}")

    # a bf16 call allocates its outputs and nothing else: no f32 copy of an
    # operand (6 fields would be 149 MB at ne30)
    _, const, acc, modes, _ = problems[-1]
    targs = dict(r0_cases(const, acc))["bench"]
    for name in ("t4", "row", "ring"):
        build, kern, _, _ = modes[name]
        args = build(storage_args(targs, "bf16_ro"))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = flat_outputs(kern(*args))
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        outs = sum(x.numel() * x.element_size() for x in out
                   if not any(x is a for a in args))
        # the ring's scratch s1 (w's size) and launch state, and rounding
        slack = (out[0].numel() * 4 if name == "ring" else 0) + (2 << 20)
        if extra > outs + slack:
            raise AssertionError(f"phase 29 {name} bf16_ro: {extra} B "
                                 f"allocated for {outs} B of outputs")
        print(f"phase 29 {name} ne{cs.ne} bf16_ro: {extra} B allocated in "
              f"the call for {outs} B of new outputs (the ring's scratch s1 "
              "and launch state beside them): no f32 copy of an operand")

    # times of each mode beside its bound (bench case)
    card = card_line()
    for tag, const, acc, modes, main in problems:
        if not main:
            continue
        targs = dict(r0_cases(const, acc))["bench"]
        for name, (build, kern, _, _) in modes.items():
            line = {}
            for storage in ("f32", *STORAGE_MODES):
                args = build(storage_args(targs, storage))
                fn = lambda: kern(*args)
                nbytes = call_bytes(args, fn())
                line[storage] = dict(
                    ms=cuda_ms(fn, 50), graph_ms=graph_ms(fn, 50),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, mb=nbytes / 1e6)
            print(f"phase 29 times {name} {tag} ({card}): " + "; ".join(
                f"{s} {v['ms']:.4f} ms (graph {v['graph_ms']:.4f}) bound "
                f"{v['bound_ms']:.4f} ({v['mb']:.2f} MB)"
                for s, v in line.items()))
            rows.setdefault(STORAGE_WRAPPER[name], {}).setdefault(
                "storage_ms", {})[f"{name} {tag}"] = line
    # the assembled chain's rotation in bf16_ro casts the old n0 (f32) to
    # the bf16 nm1 slot (bench.run_assembled, the JAX bench's cast): a
    # plain PyTorch op timed with the step, alone here
    s0 = torch.cat(targs[3:7])
    cast = lambda: s0.to(torch.bfloat16)
    nbytes = s0.numel() * (4 + 2)
    print(f"phase 29 times the bf16_ro rotation's cast of the "
          f"[{s0.shape[0]}, {s0.shape[1]}] n0 state ({card}): "
          f"{cuda_ms(cast, 50):.4f} ms (graph {graph_ms(cast, 50):.4f}) "
          f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ({nbytes / 1e6:.2f} "
          "MB)")
    return rows


def storage_row_plain(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1, qdp,
                      pecnd, vn0u, vn0v, omg, dvv, plan, rsp):
    """``dist.caar_dss_structured_packed`` from the plain row step: the row
    CAAR step's plain version, then the same plain structured DSS of the
    four fields stacked [E16, 4*nlev]."""
    import torch

    from tinman_sandbox_tpu_torch.dist import dss_structured_scaled
    from tinman_sandbox_tpu_torch.kernels.caar import caar_packed_plain

    o = caar_packed_plain(scal, meta, u0, v0, t0, dp0, um1, vm1, tm1, dpm1,
                          qdp, pecnd, vn0u, vn0v, omg, dvv)
    nlev = qdp.shape[1]
    a = dss_structured_scaled(torch.cat(o[:4], dim=1), plan, rsp)
    return tuple(a[:, i * nlev:(i + 1) * nlev].contiguous()
                 for i in range(4)) + tuple(o[4:])


def phase_storage_path(dev, cs) -> dict:
    """Phase 29's main path in each bf16 storage, launch counts set to 0
    just before and read just after (by ``main``): STORAGE_STEPS chained
    assembled steps at ne30 x 72 (``bench.run_assembled``: the stacked
    step, the ring and the row step; the nm1 slot cast back to bf16 in
    bf16_ro), each step against the plain step from its own input
    (CAAR_TOL) and the chain against the same chain on the plain versions
    (LEAPFROG_TOL in bf16_aux, the bf16_ro envelope in bf16_ro: see the
    note in the code), finite, the ring's chain bit for bit the stacked
    step's, continuity exactly 0 after every step's DSS;
    ``tools.bench_assembled --ne 30 --nexec 5``; and ``bench --storage``
    (f32, bf16_aux, bf16_ro) raw at 1024 x 72 on both layouts, ``--ne 30``
    and ``--ne 30 --ring``, each line's bytes the f32 count less 2 bytes
    an element of each bf16 field. Returns the bench lines by run."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (
        caar_dss_ring_t4, caar_dss_ring_t4_plain,
        caar_dss_structured_packed_t4_plain, continuity_error_t)
    from tinman_sandbox_tpu_torch.tools import bench_assembled

    for storage in STORAGE_MODES:
        # the chain against its plain chain: in bf16_aux the bf16 operands
        # are the same every step, so the two part by f32 rounding alone
        # (LEAPFROG_TOL); in bf16_ro each step's n0 is rounded to bf16 as
        # the next nm1, and two n0 an f32 ulp apart can round a bf16 ulp
        # (2^-8) apart, so the chains part by bf16 rounding: held to the
        # JAX tests' envelope of what bf16_ro does to the state. Each step
        # is also held at CAAR_TOL against the plain step from its own
        # input, and the ring's chain bit for bit the stacked step's.
        chain_tol = (LEAPFROG_TOL if storage == "bf16_aux"
                     else STORAGE_ENVELOPE[storage])
        finals = {}
        for label, layout, step, plain in (
                ("structured", "t", None,
                 caar_dss_structured_packed_t4_plain),
                ("ring", "t", caar_dss_ring_t4, caar_dss_ring_t4_plain),
                ("row", "row", None, storage_row_plain)):
            const, levels, acc, plan, rsp = bench.make_assembled_problem(
                cs.ne, NLEV, dev, layout=layout, cs=cs, storage=storage)
            flat = (lambda lv: (*lv[0], *lv[1])) if layout == "row" \
                else (lambda lv: lv)
            kl, ka = levels, [a.clone() for a in acc]
            worst = 0.0
            t0 = time.perf_counter()
            for i in range(STORAGE_STEPS):
                start = (kl, [a.clone() for a in ka])
                kl, ka, kphi = bench.run_assembled(const, kl, ka, plan, rsp,
                                                   1, step=step,
                                                   layout=layout)
                sl, sa, sphi = bench.run_assembled(const, *start, plan, rsp,
                                                   1, step=plain,
                                                   layout=layout)
                worst = max([worst] + [
                    scaled_err(a.float(), b.float()) for a, b in zip(
                        (*flat(kl), kphi, *ka), (*flat(sl), sphi, *sa))])
                cont = (continuity_error_t(kl[0], cs.gdof) if layout == "t"
                        else max(continuity_error_t(x.T.contiguous(),
                                                    cs.gdof)
                                 for x in kl[0]))
                if cont != 0.0 or worst > CAAR_TOL:
                    raise AssertionError(f"phase 29 {label} {storage} step "
                                         f"{i + 1}: continuity {cont}, "
                                         f"vs plain {worst} (> {CAAR_TOL})")
                del start, sl, sa, sphi
            torch.cuda.synchronize()
            k_s = time.perf_counter() - t0
            pl, pa, pphi = bench.run_assembled(
                const, levels, [a.clone() for a in acc], plan, rsp,
                STORAGE_STEPS, step=plain, layout=layout)
            nm1 = kl[1] if layout == "t" else kl[1][0]
            if (nm1.dtype == torch.bfloat16) != (storage == "bf16_ro"):
                raise AssertionError(f"phase 29 {label} {storage}: the nm1 "
                                     f"slot is {nm1.dtype}")
            errs = {f"lev{i}": scaled_err(a.float(), b.float())
                    for i, (a, b) in enumerate(zip(flat(kl), flat(pl)))}
            errs.update({n: scaled_err(a, b) for n, a, b in zip(
                ("phi", "vn0u", "vn0v", "omg"), (kphi, *ka), (pphi, *pa))})
            for x in (*flat(kl), kphi, *ka):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"phase 29 {label} {storage}: "
                                         "non-finite")
            if max(errs.values()) > chain_tol:
                raise AssertionError(f"phase 29 {label} {storage} chain: "
                                     f"{errs} > {chain_tol}")
            finals[label] = (*flat(kl), kphi, *ka)
            same = ""
            if label == "ring":
                if not all(torch.equal(a, b) for a, b in
                           zip(finals["ring"], finals["structured"])):
                    raise AssertionError(f"phase 29 ring {storage}: not the "
                                         "stacked step's chain bit for bit")
                same = "; bit for bit the stacked step's chain"
            print(f"phase 29 {label} chain ne{cs.ne}x{NLEV} {storage} "
                  f"x{STORAGE_STEPS} (kernels {k_s:.3f} s): continuity 0 "
                  f"after every step; each step vs plain from its input "
                  f"{worst:.2e} (gate {CAAR_TOL}); the chain vs the plain "
                  f"chain {max(errs.values()):.2e} (gate {chain_tol}); nm1 "
                  f"slot {nm1.dtype}{same}")
            del const, levels, acc, kl, ka, pl, pa
        del finals
    lines = run_tool(bench_assembled, ["--ne", str(cs.ne), "--nlev",
                                       str(NLEV), "--nexec", "5"], phase=29)
    sweep = json.loads(lines[-1])["sweep"]
    for name in bench_assembled.VARIANTS:
        if not sweep[name]["us_per_step"] > 0 or not sweep[name]["card"]:
            raise AssertionError(f"bench_assembled {name}: {sweep[name]}")
    for name in bench_assembled.NOT_APPLICABLE:
        if not str(sweep[name]).startswith("not applicable"):
            raise AssertionError(f"bench_assembled {name}: {sweep[name]}")
    torch.cuda.empty_cache()
    results = {}
    for label, argv in (
            ("raw", ["--nelem", "1024", "--nexec", "500"]),
            ("raw row", ["--nelem", "1024", "--nexec", "500", "--layout",
                         "row"]),
            ("ne30", ["--ne", str(cs.ne), "--nexec", "300"]),
            ("ne30 ring", ["--ne", str(cs.ne), "--nexec", "300", "--ring"])):
        # the lanes of a field: E16
        n = 16 * (int(argv[1]) if argv[0] == "--nelem" else 6 * cs.ne ** 2)
        for storage in ("f32", *STORAGE_MODES):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = bench.main(argv + ["--nlev", str(NLEV), "--reps", "2",
                                         "--storage", storage])
            print(f"phase 29 bench {label} --storage {storage} "
                  + buf.getvalue().strip())
            f32 = results.get((label, "f32"), res)["bytes_per_step"]
            saved = bench.BF16_FIELDS[storage] * 2 * n * NLEV
            if res["storage"] != storage or \
                    res["bytes_per_step"] != f32 - saved or \
                    (res["storage_launches"] > 0) != (storage != "f32"):
                raise AssertionError(f"bench {label} {storage}: {res}")
            results[(label, storage)] = res
    for label in ("raw", "raw row", "ne30", "ne30 ring"):
        print(f"phase 29 bench {label} us/step: " + ", ".join(
            f"{s} {results[(label, s)]['us_per_step']:.2f}"
            for s in ("f32", *STORAGE_MODES)))
    return results


def held(tag: str, kern, plain, build):
    """``kern`` on the bf16 operands ``build(False)`` against ``kern`` on the
    same operands upcast (``build(True)``, the f32 mode), bit for bit, and
    against ``plain`` on the bf16 operands (which upcasts them), each
    output within CAAR_TOL scaled, all f32 and finite. ``build`` makes fresh
    operands each call (the CAAR accumulators are updated in place).
    Returns (worst scaled error against plain, max abs error)."""
    import torch

    got = flat_outputs(kern(*build(False)))
    up = flat_outputs(kern(*build(True)))
    want = flat_outputs(plain(*build(False)))
    torch.cuda.synchronize()
    same = len(got) == len(up) and all(torch.equal(g, u)
                                       for g, u in zip(got, up))
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    if not same or len(got) != len(want) or max(errs) > CAAR_TOL or \
            any(g.dtype != torch.float32 for g in got) or \
            not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"phase 30 {tag}: bits {same}, plain {errs}")
    return max(errs), max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got, want))


def upcast_bf16(x, up: bool):
    """x upcast to f32 where ``up`` and x is bf16, else x."""
    import torch

    return x.float() if up and x.dtype == torch.bfloat16 else x


def phase_prim_storage_kernels(dev, cs) -> dict:
    """Phase 30's kernel instances: the CAAR stage mode (row 5) in contracts
    (a) bf16 qdp and pecnd and (b) f32 qdp beside a bf16 pecnd, with and
    without phi and the slab, in the bench and vort cases at 1024 x 72 and
    ne30 x 72; the Euler and limited tracer stages (rows 11-14) with a bf16
    q and the limited stage with a bf16 mix field, at qsize 1 and
    QSIZE_TALL, at the run's dt and a long one; the merged sweep (rows
    20/23) with a bf16 mix field at both heights. Each held by ``held``,
    the storage launch counters up by the bf16 calls alone; the new
    instances' blocks an SM and registers; their times from CUDA graphs
    beside the f32 instance's, each with its bound (bf16 at 2 bytes).
    Returns extra keys for the kernel rows."""
    import numpy as np
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.caar_t import (
        caar_t4_cuda, caar_t4_plain)
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_fixup_cuda, dss_sweep_cuda, dss_sweep_plain, fix_tables)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (
        tracer_euler_cuda, tracer_euler_plain, tracer_limit_cuda,
        tracer_limit_plain)

    bf = lambda x: x.to(torch.bfloat16)
    card = card_line()
    counts0 = storage_counts()
    expect = dict.fromkeys(counts0, 0)
    times = {}

    def timed(wrapper, tag, calls, before):
        """Graph times of the f32 and bf16 forms of one call beside their
        bounds: calls = {form: (fn, bytes)}. The launches since the counts
        ``before`` (the forms' own calls and the timing's) are left out of
        the storage launch check."""
        line = {}
        for form, (fn, nbytes) in calls.items():
            line[form] = dict(graph_ms=graph_ms(fn, 20),
                              bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                              mb=nbytes / 1e6)
        for w, n in storage_counts().items():
            expect[w] += n - before[w]
        print(f"phase 30 times {tag} ({card}): " + "; ".join(
            f"{f} graph {v['graph_ms']:.4f} ms bound {v['bound_ms']:.4f} "
            f"({v['mb']:.2f} MB)" for f, v in line.items()))
        times.setdefault(wrapper, {})[tag] = line

    # the new instances' occupancy and registers
    tr = _build.library("tracer")
    occ = {case: tr.tracer_blocks_per_sm(kind, dev.index)
           for case, kind in (("euler bf16 q", 4), ("limit bf16 q", 5),
                              ("limit bf16 mx", 6), ("euler f32", 0),
                              ("limit f32 mx", 2))}
    sw = _build.library("dss").dss_sweep_blocks_per_sm(1, 2, dev.index)
    print(f"phase 30 blocks an SM (cudaOccupancy): tracer_kernel "
          f"{json.dumps(occ)}; dss_sweep_kernel bf16 mix {sw}")
    if min(occ.values()) <= 0 or sw <= 0:
        raise AssertionError(f"phase 30 occupancy: {occ}, sweep {sw}")
    # the instances by their mangled template arguments: the stage mode
    # (kSingle) in storage 1 or 3; the tracer stages and the sweep with a
    # bf16 operand (a third or fourth bool argument true)
    bits = lambda i: re.findall(r"L(?:b|i)(\d)E", i)
    for source, tag, keep in (
            ("caar", "caar_chunk_kernel",
             lambda b: b[0] == "1" and b[-1] in ("1", "3")),
            ("tracer", "tracer_kernel", lambda b: "1" in b[2:]),
            ("dss", "dss_sweep_kernel", lambda b: "1" in b[2:])):
        for inst, report in ptxas_report(source, tag):
            if keep(bits(inst)):
                print(f"phase 30 ptxas {tag}{inst}: {report}")

    # -- row 5: the stage mode in contracts (a) and (b)
    problems = [("1024x72", *bench.make_problem(1024, NLEV, dev, seed=7),
                 None)]
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(cs.ne, NLEV, dev, cs=cs)
    fix = fix_tables(plan, dev)
    problems.append((f"ne{cs.ne}x{NLEV}", (scal, meta, s0, sm1, qdp, pecnd,
                                           dvv), acc, fix))
    worst = worst_abs = 0.0
    for tag, const, acc, pfix in problems:
        for case, a in caar_cases(const, acc):
            if case == "tend":
                continue
            for contract in ("a", "b"):
                q_x = bf(a[4]) if contract == "a" else a[4]
                pec_x = bf(a[5])
                for phi, slab in itertools.product(
                        (True, False), (False, True) if pfix else (False,)):
                    fx = pfix if slab else None
                    kw = dict(single=True, emit_phi=phi, fix=fx)

                    def build(up, a=a, q_x=q_x, pec_x=pec_x):
                        return (a[0], a[1], a[2], None,
                                upcast_bf16(q_x, up), upcast_bf16(pec_x, up),
                                *(x.clone() for x in a[6:9]), a[9])

                    err, ab = held(f"caar stage {tag} {case} ({contract}) "
                                   f"phi {phi} slab {slab}",
                                   lambda *x, kw=kw: caar_t4_cuda(*x, **kw),
                                   lambda *x, kw=kw: caar_t4_plain(*x, **kw),
                                   build)
                    expect["caar_t4_cuda"] += 1
                    worst, worst_abs = max(worst, err), max(worst_abs, ab)
                    print(f"phase 30 caar stage {tag} {case} contract "
                          f"({contract}) phi {phi} slab {slab}: bit for bit "
                          f"the f32 mode on the upcast operands; plain "
                          f"{err:.3e}")
            if case != "bench":
                continue
            for contract in ("a", "b"):
                forms, before = {}, storage_counts()
                for form in ("f32", "bf16"):
                    x = build(form == "f32", a=a,
                              q_x=bf(a[4]) if contract == "a" else a[4],
                              pec_x=bf(a[5]))
                    fn = lambda x=x: caar_t4_cuda(*x, single=True, fix=pfix)
                    forms[form] = (fn, call_bytes(x, fn()))
                timed("caar_t4_cuda", f"stage ({contract}) {tag}", forms,
                      before)
    rows = {"caar_t4_cuda": dict(prim_storage_max_scaled_err=worst,
                                 prim_storage_max_abs_err=worst_abs)}
    del problems, s0, sm1, acc, qdp, pecnd

    # -- rows 11-14 and 20/23: the tracer stages and the sweep
    ca, cb = np.float32(1.0 / 3.0), np.float32(2.0 / 3.0)
    e16, n, k = cs.nelem * 16, fix.nfix, NLEV
    kw = dict(wind_rows=(0, 1), fix=fix)
    block = lambda a, b: max(scaled_err(x, y) for x, y in zip(a.split(k),
                                                             b.split(k)))
    for qsize in (1, QSIZE_TALL):
        (_, meta, _, dvv), s0, q, _, _, rsp = bench.make_prim_problem(
            cs.ne, k, dev, DYN_DT, qsize)
        qb = bf(q)
        gen = torch.Generator(device=dev).manual_seed(5)
        mxb = bf(torch.rand(q.shape, generator=gen, device=dev))
        div = q - tracer_euler_plain(meta, s0, s0, q, dvv, 1.0, k,
                                     fold_sph=False, wind_rows=(0, 1))
        dt_long = 0.5 * float(q.abs().max()) / float(div.abs().max())
        del div
        qtag = f"ne{cs.ne}x{k} qsize {qsize}"
        stages = {
            "tracer_euler bf16 q": (
                "tracer_euler_cuda", tracer_euler_cuda, tracer_euler_plain,
                lambda up, dt: (meta, s0, s0, upcast_bf16(qb, up), dvv, dt,
                                k)),
            "tracer_limit bf16 q": (
                "tracer_limit_cuda", tracer_limit_cuda, tracer_limit_plain,
                lambda up, dt: (meta, s0, s0, upcast_bf16(qb, up), dvv, dt,
                                k)),
            "tracer_limit bf16 mx": (
                "tracer_limit_cuda", tracer_limit_cuda, tracer_limit_plain,
                lambda up, dt: (meta, s0, s0, q, dvv, dt, k,
                                (upcast_bf16(mxb, up), ca, cb))),
        }
        for name, (wname, kern, plain, args) in stages.items():
            for dt in (DYN_DT, dt_long):
                got = kern(*args(False, dt), **kw)
                up = kern(*args(True, dt), **kw)
                want = plain(*args(False, dt), **kw)
                torch.cuda.synchronize()
                expect[wname] += 1
                same = all(torch.equal(g, u) for g, u in zip(got, up))
                err = max(block(g, w) for g, w in zip(got, want))
                f32 = got[0].dtype == torch.float32
                if not same or err > CAAR_TOL or not f32 or \
                        not bool(torch.isfinite(got[0]).all()):
                    raise AssertionError(f"phase 30 {name} {qtag} dt {dt}: "
                                         f"bits {same}, plain {err}")
                r = rows.setdefault(wname, {})
                r["prim_storage_max_scaled_err"] = max(
                    err, r.get("prim_storage_max_scaled_err", 0.0))
                print(f"phase 30 {name} {qtag} dt {dt:.4g}: bit for bit the "
                      f"f32 instance on the upcast operand; worst scaled "
                      f"error of a tracer block against plain {err:.2e}")
                del got, up, want
            forms, before = {}, storage_counts()
            for form in ("f32", "bf16"):
                x = args(form == "f32", DYN_DT)
                fn = lambda x=x, kern=kern: kern(*x, **kw)
                stored = x[3].element_size() * x[3].numel() + (
                    x[7][0].element_size() * x[7][0].numel()
                    if len(x) > 7 else 0)
                # 2 wind blocks and 7 meta rows read, q (and mx) read, out
                # and the slab written
                nbytes = (2 * k + 7) * e16 * 4 + stored \
                    + qsize * k * e16 * 4 + n * qsize * k * 4
                forms[form] = (fn, nbytes)
            timed(wname, f"{name} {qtag}", forms, before)
        # the sweep with a bf16 mix field, on the Euler stage's output
        e, slab = tracer_euler_cuda(meta, s0, s0, q, dvv, DYN_DT, k, **kw)
        vd = dss_fixup_cuda(slab, fix, rsp)
        mk = lambda up: (e, rsp, vd, fix, (upcast_bf16(qb, up), ca, cb))
        got = dss_sweep_cuda(*mk(False)[:4], mix=mk(False)[4])
        up = dss_sweep_cuda(*mk(True)[:4], mix=mk(True)[4])
        want = dss_sweep_plain(*mk(False)[:4], mix=mk(False)[4])
        torch.cuda.synchronize()
        expect["dss_sweep_cuda"] += 1
        if not torch.equal(got, up) or not torch.equal(got, want) or \
                got.dtype != torch.float32:
            raise AssertionError(f"phase 30 dss_sweep bf16 mx {qtag}: bits "
                                 f"{torch.equal(got, up)}, plain "
                                 f"{scaled_err(got, want)}")
        print(f"phase 30 dss_sweep bf16 mx {qtag}: bit for bit the f32 "
              "instance on the upcast mix field and the plain version")
        rows.setdefault("dss_sweep_cuda", {})[
            "prim_storage_max_scaled_err"] = 0.0
        forms, before = {}, storage_counts()
        for form in ("f32", "bf16"):
            x = mk(form == "f32")
            fn = lambda x=x: dss_sweep_cuda(*x[:4], mix=x[4])
            mxx = x[4][0]
            # x and vd read, the mix field read, rsp read, out written
            nbytes = 2 * e.numel() * 4 + vd.numel() * 4 + rsp.numel() * 4 \
                + mxx.numel() * mxx.element_size()
            forms[form] = (fn, nbytes)
        timed("dss_sweep_cuda", f"sweep bf16 mx {qtag}", forms, before)
        del e, slab, vd, got, up, want, q, qb, mxb, s0
        torch.cuda.empty_cache()
    counts = storage_counts()
    got = {w: counts[w] - counts0[w] for w in counts}
    if got != expect:
        raise AssertionError(f"phase 30 storage launches {got} != the bf16 "
                             f"calls {expect}")
    print(f"phase 30 storage launches (bf16 calls only): {json.dumps(got)}")
    for wname, t in times.items():
        rows.setdefault(wname, {})["prim_storage_ms"] = t
    return rows


def phase_rsplit0_field(dev) -> None:
    """The field-form SSPRK3 step at rsplit=0 (a hybi ramp, a random
    eta_dot_dpdn accumulator) on the card against the same step on the CPU,
    f64 at ne R0_FIELD_NE with the DSS projection, every output at
    R0_FIELD_TOL scaled, eta_dot_dpdn included."""
    import dataclasses

    import torch

    from tinman_sandbox_tpu_torch import (Config, analytic_hvcoord,
                                          random_state, zero_derived)
    from tinman_sandbox_tpu_torch.dist import build_cubed_sphere
    from tinman_sandbox_tpu_torch.timeloop import ssprk3_step

    kw = dict(dtype=torch.float64, device="cpu")
    cs4 = build_cubed_sphere(R0_FIELD_NE, **kw)
    cfg = Config(nelem=cs4.nelem, nlev=R0_FIELD_NLEV, rsplit=0)
    st = random_state(cfg, seed=3, **kw)
    dv = zero_derived(cfg, **kw)
    gen = torch.Generator().manual_seed(9)
    dv = dataclasses.replace(dv, eta_dot_dpdn=torch.rand(
        dv.eta_dot_dpdn.shape, generator=gen, dtype=torch.float64))
    hv = analytic_hvcoord(cfg, **kw)
    hv = dataclasses.replace(hv, hybi=torch.linspace(
        0.0, 1.0, cfg.nlev + 1, dtype=torch.float64))
    outs = {}
    t = {}
    for where in ("cpu", dev):
        t0 = time.perf_counter()
        outs[str(where)] = ssprk3_step(st, dv, cs4.geometry, hv, cfg, 0.05,
                                       gdof=cs4.gdof, ndof=cs4.ndof,
                                       device=where)
        torch.cuda.synchronize()
        t[str(where)] = time.perf_counter() - t0
    (cs_, cd), (gs, gd) = outs["cpu"], outs[str(dev)]
    errs = {n: scaled_err(getattr(gs, n)[cfg.np1].cpu(),
                          getattr(cs_, n)[cfg.np1])
            for n in ("u", "v", "t", "dp3d")}
    errs.update({n: scaled_err(getattr(gd, n).cpu(), getattr(cd, n))
                 for n in ("vn0_u", "vn0_v", "phi", "omega_p",
                           "eta_dot_dpdn")})
    moved = scaled_err(cd.eta_dot_dpdn, dv.eta_dot_dpdn)
    if max(errs.values()) > R0_FIELD_TOL or not moved > 0.0:
        raise AssertionError(f"phase 30 ssprk3_step rsplit=0: {errs}, "
                             f"eta_dot_dpdn moved {moved}")
    print(f"phase 30 ssprk3_step rsplit=0 f64 ne{R0_FIELD_NE} x "
          f"{R0_FIELD_NLEV} on {torch.cuda.get_device_name(dev)} against the "
          f"CPU: worst scaled error {max(errs.values()):.2e} (gate "
          f"{R0_FIELD_TOL}; eta_dot_dpdn {errs['eta_dot_dpdn']:.2e}, moved "
          f"{moved:.2e} of itself); {t[str(dev)]:.3f} s on the card, "
          f"{t['cpu']:.3f} s on the CPU")


def phase_checkpoint_dir(dev, cs) -> None:
    """A non-blocking ``save_checkpoint_dir`` of the ne30 prim state,
    then PRIM_STORAGE_STEPS prim steps written back IN PLACE into the saved
    tensors, then ``finish_async_checkpoints`` and a load: the load is the
    state at the call bit for bit (the in-place writes did not reach it),
    and the state did move. Prints the host ms the save call blocked beside
    the blocking npz save's."""
    import shutil

    import torch

    from tinman_sandbox_tpu_torch import (Config, analytic_hvcoord,
                                          random_state, zero_derived)
    from tinman_sandbox_tpu_torch.dist import (
        make_structured_plan, prim_pack_t, prim_step_packed_t4,
        prim_unpack_t)
    from tinman_sandbox_tpu_torch.timeloop import (
        finish_async_checkpoints, load_checkpoint_dir, save_checkpoint,
        save_checkpoint_dir)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    cfg = Config(nelem=cs.nelem, nlev=NLEV, qsize=1, dt=DYN_DT)
    kw = dict(dtype=torch.float32, device=dev)
    state, derived = random_state(cfg, seed=7, **kw), zero_derived(cfg, **kw)
    fields = lambda st, dv: {**{f"state.{n}": getattr(st, n) for n in
                                ("u", "v", "t", "dp3d", "qdp", "phis",
                                 "ps_v")},
                             **{f"derived.{n}": getattr(dv, n) for n in
                                ("vn0_u", "vn0_v", "phi", "omega_p",
                                 "eta_dot_dpdn", "pecnd")}}
    torch.cuda.synchronize()
    snap = {n: x.clone() for n, x in fields(state, derived).items()}
    path = os.path.join(CKPT_DIR, "prim")
    # a first save allocates its pinned host buffers (PyTorch's host
    # allocator caches them for the saves after it): timed on its own
    t0 = time.perf_counter()
    save_checkpoint_dir(path + "_first", state, derived, cfg, 9)
    first_ms = (time.perf_counter() - t0) * 1e3
    finish_async_checkpoints()
    t0 = time.perf_counter()
    save_checkpoint_dir(path, state, derived, cfg, 10)
    save_ms = (time.perf_counter() - t0) * 1e3
    # the chained steps, each written back into the saved tensors in place
    p = prim_pack_t(state, derived, cs.geometry, analytic_hvcoord(cfg, **kw),
                    cfg, DYN_DT)
    plan = make_structured_plan(cs.gdof, cs.ne)
    s1, q1, acc = p["s0"], p["qdp"], p["acc"]
    for _ in range(PRIM_STORAGE_STEPS):
        s1, q1, phi, *acc = prim_step_packed_t4(
            p["scal"], p["meta"], s1, q1, p["pecnd"], *acc, p["dvv"], plan,
            p["rsp"], DYN_NU, NLEV, dt=DYN_DT)
        new_st, new_dv = prim_unpack_t(state, derived, cfg, s1, q1, phi, acc)
        for n, x in fields(new_st, new_dv).items():
            fields(state, derived)[n].copy_(x)
    finish_async_checkpoints()
    t0 = time.perf_counter()
    save_checkpoint(path + ".npz", state, derived, cfg, 20)
    npz_ms = (time.perf_counter() - t0) * 1e3
    st2, dv2, cfg2, step = load_checkpoint_dir(path, cfg, device=dev)
    loaded = fields(st2, dv2)
    same = all(torch.equal(loaded[n], snap[n]) for n in snap)
    moved = not torch.equal(state.u, snap["state.u"])
    nbytes = sum(x.numel() * x.element_size() for x in snap.values())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if not same or not moved or step != 10 or (cfg2.n0, cfg2.np1) != (
            cfg.n0, cfg.np1):
        raise AssertionError(f"phase 30 checkpoint: the load is the snapshot "
                             f"{same}, the state moved {moved}, step {step}")
    print(f"phase 30 save_checkpoint_dir ne{cs.ne}x{NLEV} ({nbytes / 1e6:.1f}"
          f" MB): the call blocked the host {save_ms:.2f} ms (the first "
          f"call, which allocates its pinned buffers, {first_ms:.2f} ms), "
          f"the blocking npz save {npz_ms:.2f} ms; after "
          f"{PRIM_STORAGE_STEPS} prim steps "
          "written in place and finish_async_checkpoints the load is the "
          "state at the call bit for bit")


def phase_prim_storage_path(dev, cs) -> dict:
    """Phase 30's main path, launch counts set to 0 just before and read
    just after (by ``main``): PRIM_STORAGE_STEPS chained ne30 x 72
    ``prim_step_packed_t4`` steps from ``bench.make_prim_problem(storage=
    "bf16_aux")``, unlimited at qsize 1 and limited at QSIZE_TALL, each step
    against the plain step from its own input (CAAR_TOL per block of the
    state, per tracer block and per derived field), continuity exactly 0,
    the first step's tracer mass against its upcast input's
    (PRIM_MASS_TOL), min qdp above the bounds gate with the limiter; then
    ``bench --prim --storage bf16_aux`` (and ``--limit --qsize 35``,
    ``--limit-iters 1``) and ``--rk --storage bf16_ro`` lines, each with
    its storage, storage launches and byte count; the rsplit=0 field-form
    step (``phase_rsplit0_field``) and the directory checkpoint
    (``phase_checkpoint_dir``). Returns the bench lines by label."""
    import torch

    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.dist import (
        continuity_error_t, make_structured_plan, prim_step_packed_t4_plain)
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables

    bf16 = torch.bfloat16
    for qsize, limit in ((1, False), (QSIZE_TALL, True)):
        tag = (f"prim chain ne{cs.ne}x{NLEV} bf16_aux qsize {qsize} limit "
               f"{limit} x{PRIM_STORAGE_STEPS}")
        const, s0, qdp, acc, plan, rsp = bench.make_prim_problem(
            cs.ne, NLEV, dev, DYN_DT, qsize, cs=cs, storage="bf16_aux")
        if qdp.dtype != bf16 or const[2].dtype != bf16 or \
                continuity_error_t(qdp.float(), cs.gdof) != 0.0:
            raise AssertionError(f"{tag}: the problem's qdp {qdp.dtype}, "
                                 f"pecnd {const[2].dtype}, or not continuous")
        sph = const[1][11]
        kstate = (s0, qdp, tuple(a.clone() for a in acc))
        worst, k_s, mass = 0.0, 0.0, None
        for i in range(PRIM_STORAGE_STEPS):
            start = (kstate[0], kstate[1],
                     tuple(a.clone() for a in kstate[2]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *kstate, kphi = bench.run_prim(const, *kstate, plan, rsp, 1,
                                           DYN_NU, DYN_DT, 1, limit)
            torch.cuda.synchronize()
            k_s += time.perf_counter() - t0
            ps, pq, pacc, pphi = bench.run_prim(
                const, *start, plan, rsp, 1, DYN_NU, DYN_DT, 1, limit,
                step=prim_step_packed_t4_plain)
            ks, kq, kacc = kstate
            errs = [scaled_err(a, b) for a, b in zip(ks.split(NLEV),
                                                     ps.split(NLEV))]
            errs += [scaled_err(a, b) for a, b in zip(kq.split(NLEV),
                                                     pq.split(NLEV))]
            errs += [scaled_err(a, b) for a, b in zip((kphi, *kacc),
                                                     (pphi, *pacc))]
            worst = max([worst] + errs)
            conts = [continuity_error_t(x, cs.gdof) for x in (ks, kq)]
            if max(errs) > CAAR_TOL or max(conts) != 0.0 or \
                    kq.dtype != torch.float32 or \
                    not all(bool(torch.isfinite(x).all())
                            for x in (ks, kq, kphi, *kacc)):
                raise AssertionError(f"{tag} step {i + 1}: vs plain "
                                     f"{max(errs)} (> {CAAR_TOL}), "
                                     f"continuity {conts}, qdp {kq.dtype}")
            if i == 0:
                # the bf16 input's mass, upcast exactly, against the f32
                # output's: the port's last Shu-Osher pair sums to 1 in f32
                m_in, m_out = f64_mass(sph, start[1]), f64_mass(sph, kq)
                mass = m_out / m_in - 1.0
                jax_pair = float(torch.tensor(1.0 / 3.0, dtype=bf16)) + \
                    float(torch.tensor(2.0 / 3.0, dtype=bf16)) - 1.0
                if abs(mass) > PRIM_MASS_TOL:
                    raise AssertionError(f"{tag}: the first step's tracer "
                                         f"mass moved {mass} of itself")
            del start, ps, pq, pacc, pphi
        q_min = float(kstate[1].min())
        floor = -BOUNDS_TOL * max(1.0, float(kstate[1].abs().max()))
        if limit and q_min < floor:
            raise AssertionError(f"{tag}: min qdp {q_min} < {floor}")
        print(f"phase 30 {tag} (kernels {k_s:.3f} s): each step vs the plain "
              f"step from its input {worst:.2e} (gate {CAAR_TOL}); "
              f"continuity 0 after every step; the first step's tracer mass "
              f"{mass:+.3e} of its bf16 input's (gate {PRIM_MASS_TOL}; the "
              f"JAX package's bf16 pair 1/3 + 2/3 sums to 1 + {jax_pair:.3e}"
              f"); min qdp {q_min:.3e}")
        del const, s0, qdp, acc, kstate
        torch.cuda.empty_cache()

    results = {}
    nfix = fix_tables(make_structured_plan(cs.gdof, cs.ne), dev).nfix
    e16 = cs.nelem * 16
    for label, extra in (
            ("prim", ["--prim", "--storage", "bf16_aux", "--nexec", "100"]),
            ("prim limit q35", ["--prim", "--storage", "bf16_aux", "--limit",
                                "--qsize", str(QSIZE_TALL), "--nexec", "10"]),
            ("prim limit q35 iters 1",
             ["--prim", "--storage", "bf16_aux", "--limit", "--qsize",
              str(QSIZE_TALL), "--limit-iters", "1", "--nexec", "10"]),
            ("rk", ["--rk", "--storage", "bf16_ro", "--nexec", "100"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = bench.main(["--ne", str(cs.ne), "--nlev", str(NLEV),
                              "--hypervis-nu", str(DYN_NU), "--dt",
                              str(DYN_DT), "--reps", "2"] + extra)
        print(f"phase 30 bench {label} " + buf.getvalue().strip())
        st = extra[extra.index("--storage") + 1]
        # the timed steps read pecnd bf16 on 3 stages; --rk qdp too
        if label == "rk":
            f32 = bench.dynamics_bytes_per_step(cs.ne, NLEV, nfix, True)
            saved = 6 * 2 * e16 * NLEV
        else:
            qsize = QSIZE_TALL if "--qsize" in extra else 1
            f32 = bench.prim_bytes_per_step(cs.ne, NLEV, nfix, qsize, 1, True)
            saved = 3 * 2 * e16 * NLEV
        if res["bytes_per_step"] != f32 - saved:
            raise AssertionError(f"bench {label}: {res['bytes_per_step']} B "
                                 f"!= {f32} - {saved}")
        if res["storage"] != st or not res["storage_launches"] > 0 or \
                not res["min_dp3d"] > 0.0 or \
                ("--limit" in extra and res["min_qdp"] < -BOUNDS_TOL):
            raise AssertionError(f"bench {label}: {res}")
        if "iters 1" in label and "limit iters=1" not in res["config"]:
            raise AssertionError(f"bench {label}: {res['config']}")
        results[label] = res
        torch.cuda.empty_cache()
    phase_rsplit0_field(dev)
    phase_checkpoint_dir(dev, cs)
    return results


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        from tinman_sandbox_tpu_torch.dist import build_cubed_sphere
        from tinman_sandbox_tpu_torch.kernels import _build
        from tinman_sandbox_tpu_torch.kernels.caar import (
            caar_packed, caar_packed_rsplit0)
        from tinman_sandbox_tpu_torch.kernels.caar_t import (
            caar_packed_rsplit0_t, caar_t4_cuda)
        from tinman_sandbox_tpu_torch.kernels.dss import (
            dss_extract_cuda, dss_fixup_cuda, dss_merge_patch_cuda,
            dss_patch_tiles_cuda, dss_sweep_banded_cuda,
            dss_sweep_banded_nomerge_cuda, dss_sweep_cuda,
            dss_sweep_nomerge_cuda)
        from tinman_sandbox_tpu_torch.kernels.hypervis_t import vlap_cuda
        from tinman_sandbox_tpu_torch.kernels.probe import probe_mm_cuda
        from tinman_sandbox_tpu_torch.kernels.remap import (
            remap_levels_cuda, remap_packed_cuda)
        from tinman_sandbox_tpu_torch.kernels.ring_fused import (
            caar_ring_packed_t4, tracer_ring_packed_t)
        from tinman_sandbox_tpu_torch.kernels.saxpby import saxpby_cuda
        from tinman_sandbox_tpu_torch.kernels.tracer import euler_packed
        from tinman_sandbox_tpu_torch.kernels.tracer_t import (
            tracer_euler_cuda, tracer_limit_cuda)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_kernels()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        log = _build.ptxas_log(name)
        if not os.path.exists(log):                 # built by an older tree
            print(f"phase 1 ptxas {name}: no report (cached build)")
            continue
        with open(log) as f:
            for ln in f:
                if "registers" in ln or "spill" in ln or "error" in ln.lower():
                    print(f"phase 1 ptxas {name}: " + ln.strip())
    # the redesigned kernels, instance by instance
    for source, tag in (("dss", "dss_sweep_kernel"),
                        ("dss", "dss_sweep_banded_kernel"),
                        ("caar", "caar_chunk_kernel"),
                        ("caar", "caar_ring_kernel"),
                        ("caar", "caar_r0_kernel"),
                        ("remap", "remap_kernel"),
                        ("tracer", "tracer_kernel"),
                        ("tracer", "tracer_ring_kernel")):
        for inst, report in ptxas_report(source, tag):
            print(f"phase 1 ptxas {tag}{inst}: {report}")

    rows = {"saxpby_cuda": phase_saxpby(dev), "caar_t4_cuda": phase_caar(dev)}
    t0 = time.perf_counter()
    cs = build_cubed_sphere(NE, dtype=torch.float32, device=dev)
    print(f"phase 4 cubed sphere ne{NE}: {cs.nelem} elements, {cs.ndof} "
          f"dofs, built in {time.perf_counter() - t0:.1f} s")
    rows.update(phase_dss(dev, cs))
    rows["caar_t4_cuda"].update(phase_caar_slab(dev, cs))
    phase_golden(dev)

    wrappers = {w.__name__: w for w in (caar_t4_cuda, saxpby_cuda,
                                        dss_extract_cuda, dss_fixup_cuda,
                                        dss_sweep_cuda, vlap_cuda,
                                        tracer_euler_cuda,
                                        tracer_limit_cuda,
                                        caar_packed_rsplit0_t, caar_packed,
                                        caar_packed_rsplit0, euler_packed,
                                        caar_ring_packed_t4,
                                        tracer_ring_packed_t,
                                        dss_merge_patch_cuda,
                                        dss_sweep_nomerge_cuda,
                                        dss_sweep_banded_cuda,
                                        dss_sweep_banded_nomerge_cuda,
                                        dss_patch_tiles_cuda, probe_mm_cuda,
                                        remap_packed_cuda, remap_levels_cuda)}

    def reset():
        for w in wrappers.values():
            w.launches = 0
        for name in storage_counts():
            wrappers[name].storage_launches = 0
        remap_packed_cuda.f64_launches = remap_levels_cuda.f64_launches = 0
        caar_t4_cuda.slab_launches = 0
        caar_t4_cuda.single_launches = 0
        tracer_euler_cuda.slab_launches = 0
        tracer_limit_cuda.slab_launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    reset()
    raw_res = phase_main_path(dev)
    raw = counts()
    reset()
    asm_res = phase_assembled_path(dev, cs)
    asm = counts()
    slab_launches = caar_t4_cuda.slab_launches
    for name, extra in phase_dynamics_kernels(dev, cs).items():
        rows.setdefault(name, {}).update(extra)
    reset()
    dyn_res = phase_dynamics_path(dev, cs)
    dyn = counts()
    single_launches = caar_t4_cuda.single_launches
    for name, extra in phase_tracer_kernels(dev, cs).items():
        rows.setdefault(name, {}).update(extra)
    reset()
    prim_res, lim_res, tall_res, tall_lim_res = phase_prim_path(dev, cs)
    prim = counts()
    tracer_slabs = (tracer_euler_cuda.slab_launches,
                    tracer_limit_cuda.slab_launches)
    t0 = time.perf_counter()
    for name, extra in phase_row_kernels(dev, cs).items():
        rows.setdefault(name, {}).update(extra)
    print(f"phase 13 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    row_res, row_asm_res = phase_row_path(dev, cs)
    row = counts()
    print(f"phase 14 seconds: {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    for name, extra in phase_ring_kernels(dev, cs).items():
        rows.setdefault(name, {}).update(extra)
    print(f"phase 15 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    (ring_res, ring_two_res), ring_times = phase_ring_path(dev, cs)
    ring = counts()
    print(f"phase 16 seconds: {time.perf_counter() - t0:.1f}")
    rows["caar_ring_packed_t4"].update(ring_times)
    t0 = time.perf_counter()
    rows.update(phase_banded_kernels(dev, cs))
    print(f"phase 18 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    multi_times = phase_multidevice_path(dev, cs)
    multi = counts()
    print(f"phase 19 seconds: {time.perf_counter() - t0:.1f}")
    rows["dss_sweep_banded_cuda"].update(multi_times)
    t0 = time.perf_counter()
    rows["probe_mm_cuda"] = phase_probe_kernels(dev)
    reset()
    phase_probe_path(dev)
    probe = counts()
    print(f"phase 20 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    remap_rows, remap_times = phase_remap_cadence(dev, cs)
    cadence = counts()
    cadence_f64 = {w.__name__: w.f64_launches
                   for w in (remap_packed_cuda, remap_levels_cuda)}
    rows.update(remap_rows)
    print(f"phase 21 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    phase_element_tiers(dev, cs)
    tiers = counts()
    print(f"phase 22 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    big_res, big_problem = phase_ne120(dev)
    big = counts()
    print(f"phase 23 seconds: {time.perf_counter() - t0:.1f}")
    reset()
    t0 = time.perf_counter()
    phase_trace(dev, cs, big_problem)
    traced = counts()
    del big_problem
    print(f"phase 24 seconds: {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_bench_all_kernels(dev)
    reset()
    phase_bench_all(dev)
    swept = counts()
    print(f"phase 25 seconds: {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    phase_long_runs(dev, cs)
    longs = counts()
    print(f"phase 26 seconds: {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    phase_equiv(dev)
    equiv = counts()
    print(f"phase 27 seconds: {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    phase_tools(dev)
    tools = counts()
    print(f"phase 28 seconds: {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, extra in phase_storage_kernels(dev, cs).items():
        rows.setdefault(name, {}).update(extra)
    torch.cuda.empty_cache()
    reset()
    storage_res = phase_storage_path(dev, cs)
    stored, stored_bf16 = counts(), storage_counts()
    print(f"phase 29 seconds: {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, extra in phase_prim_storage_kernels(dev, cs).items():
        rows.setdefault(name, {}).update(extra)
    torch.cuda.empty_cache()
    reset()
    prim_storage_res = phase_prim_storage_path(dev, cs)
    prim_stored, prim_stored_bf16 = counts(), storage_counts()
    print(f"phase 30 seconds: {time.perf_counter() - t0:.1f}")
    for label, res, got in (("raw", raw_res, raw), ("assembled", asm_res,
                                                     asm),
                            ("dynamics", dyn_res, dyn),
                            ("prim", prim_res, prim),
                            ("row/rsplit=0", row_res, row),
                            ("ring", ring_res, ring)):
        print(f"phase 17 {label} main-path launches: {json.dumps(got)}; bench "
              f"{res['us_per_step']:.2f} us/step, "
              f"{res['achieved_gb_per_s']:.1f} GB/s, "
              f"fraction_of_triad {res['fraction_of_triad']:.3f}")
    for label, res in (("--limit", lim_res),
                       (f"--qsize {QSIZE_TALL}", tall_res),
                       (f"--qsize {QSIZE_TALL} --limit", tall_lim_res)):
        print(f"phase 17 prim bench {label}: {res['us_per_step']:.2f} "
              f"us/step, {res['achieved_gb_per_s']:.1f} GB/s, "
              f"fraction_of_triad {res['fraction_of_triad']:.3f}, min qdp "
              f"{res['min_qdp']:.3e}")
    print(f"phase 17 ring bench {ring_res['us_per_step']:.2f} us/step "
          f"against the two-launch bench {ring_two_res['us_per_step']:.2f} "
          f"in the same run; launches "
          f"{json.dumps(ring_res['kernel_launches'])}")
    print(f"phase 17 row assembled bench: {row_asm_res['us_per_step']:.2f} "
          f"us/step, {row_asm_res['achieved_gb_per_s']:.1f} GB/s, "
          f"fraction_of_triad {row_asm_res['fraction_of_triad']:.3f}, "
          f"launches {json.dumps(row_asm_res['kernel_launches'])}")
    print(f"phase 17 assembled main-path CAAR launches with the slab: "
          f"{slab_launches}; dynamics main-path CAAR launches in stage mode: "
          f"{single_launches} of {dyn['caar_t4_cuda']}; per bench step "
          f"{json.dumps(dyn_res['kernel_launches_per_step'])}; prim "
          f"main-path tracer launches with the slab: {tracer_slabs[0]} Euler, "
          f"{tracer_slabs[1]} limited; per prim bench step "
          f"{json.dumps(prim_res['kernel_launches_per_step'])}")
    for name in ("caar_t4_cuda", "saxpby_cuda"):
        if raw[name] <= 0:
            raise AssertionError(f"{name} was not launched on the raw path")
    for name, n in asm.items():
        if n <= 0 and name not in ("vlap_cuda", "tracer_euler_cuda",
                                   "tracer_limit_cuda",
                                   "caar_packed_rsplit0_t", "caar_packed",
                                   "caar_packed_rsplit0", "euler_packed",
                                   "caar_ring_packed_t4",
                                   "tracer_ring_packed_t",
                                   "dss_merge_patch_cuda",
                                   "dss_sweep_nomerge_cuda",
                                   "dss_sweep_banded_cuda",
                                   "dss_sweep_banded_nomerge_cuda",
                                   "dss_patch_tiles_cuda", "probe_mm_cuda",
                                   "remap_packed_cuda", "remap_levels_cuda"):
            raise AssertionError(f"{name} was not launched on the assembled "
                                 "path")
    for name in ("caar_t4_cuda", "vlap_cuda", "dss_fixup_cuda",
                 "dss_sweep_cuda"):
        if dyn[name] <= 0:
            raise AssertionError(f"{name} was not launched on the dynamics "
                                 "path")
    want = {"caar_t4_cuda": 3.0, "vlap_cuda": 2.0, "dss_fixup_cuda": 5.0,
            "dss_sweep_cuda": 5.0}
    if dyn_res["kernel_launches_per_step"] != want:
        raise AssertionError("dynamics bench: launches per step "
                             f"{dyn_res['kernel_launches_per_step']} != {want}")
    for name in ("caar_t4_cuda", "vlap_cuda", "dss_fixup_cuda",
                 "dss_sweep_cuda", "tracer_euler_cuda", "tracer_limit_cuda"):
        if prim[name] <= 0:
            raise AssertionError(f"{name} was not launched on the prim path")
    want = {"caar_t4_cuda": 3.0, "vlap_cuda": 2.0, "tracer_euler_cuda": 3.0,
            "tracer_limit_cuda": 0.0, "dss_fixup_cuda": 8.0,
            "dss_sweep_cuda": 8.0}
    want_lim = dict(want, tracer_euler_cuda=0.0, tracer_limit_cuda=3.0)
    for label, res, w in (
            ("", prim_res, want), (f" --qsize {QSIZE_TALL}", tall_res, want),
            (" --limit", lim_res, want_lim),
            (f" --qsize {QSIZE_TALL} --limit", tall_lim_res, want_lim)):
        if res["kernel_launches_per_step"] != w:
            raise AssertionError(
                f"prim bench{label}: launches per step "
                f"{res['kernel_launches_per_step']} != {w}")
    if tracer_slabs != (prim["tracer_euler_cuda"], prim["tracer_limit_cuda"]):
        raise AssertionError("a tracer launch of the prim path left out the "
                             f"slab: {tracer_slabs} of {prim}")
    for name in ("caar_packed_rsplit0_t", "caar_packed",
                 "caar_packed_rsplit0", "euler_packed", "saxpby_cuda"):
        if row[name] <= 0:
            raise AssertionError(f"{name} was not launched on the row / "
                                 "rsplit=0 path")
    for name in ("caar_ring_packed_t4", "tracer_ring_packed_t",
                 "dss_merge_patch_cuda", "dss_sweep_nomerge_cuda",
                 "dss_fixup_cuda"):
        if ring[name] <= 0:
            raise AssertionError(f"{name} was not launched on the ring path")
    print(f"phase 19 multi-device main-path launches: {json.dumps(multi)}")
    for name in ("caar_t4_cuda", "vlap_cuda", "tracer_euler_cuda",
                 "dss_fixup_cuda", "dss_sweep_cuda", "dss_sweep_nomerge_cuda",
                 "dss_sweep_banded_cuda", "dss_sweep_banded_nomerge_cuda",
                 "dss_patch_tiles_cuda"):
        if multi[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 "multi-device path")
    print(f"phase 20 probe tool main-path launches: {json.dumps(probe)}")
    for name in ("probe_mm_cuda", "saxpby_cuda", "caar_packed"):
        if probe[name] <= 0:
            raise AssertionError(f"{name} was not launched on the probe "
                                 "tool's path")
    print(f"phase 21 remap cadence main-path launches: {json.dumps(cadence)}"
          f" (float64: {json.dumps(cadence_f64)}); remap "
          f"{remap_times['remap_ms']:.4f} ms a call, "
          f"{remap_times['remap_share']:.4f} of the cadence")
    for name in ("caar_t4_cuda", "vlap_cuda", "tracer_limit_cuda",
                 "tracer_euler_cuda", "dss_fixup_cuda", "dss_sweep_cuda",
                 "remap_packed_cuda", "remap_levels_cuda"):
        if cadence[name] <= 0:
            raise AssertionError(f"{name} was not launched on the remap "
                                 "cadence's path")
    if cadence["remap_packed_cuda"] - cadence_f64["remap_packed_cuda"] <= 0 \
            or cadence_f64["remap_levels_cuda"] <= 0:
        raise AssertionError("the remap kernel was not launched in float32 "
                             "and in float64 on the remap cadence's path: "
                             f"{cadence}, float64 {cadence_f64}")
    print(f"phase 22 element-sharded tiers and dry run main-path launches: "
          f"{json.dumps(tiers)}")
    for name in ("caar_t4_cuda", "dss_fixup_cuda", "dss_sweep_banded_cuda",
                 "dss_patch_tiles_cuda"):
        if tiers[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 22's "
                                 "path")
    print(f"phase 23 ne{NE120} main-path launches: {json.dumps(big)}; raw "
          f"{big_res['raw']['us_per_step']:.2f} us/step "
          f"(fraction_of_triad {big_res['raw']['fraction_of_triad']:.3f}), "
          f"assembled {big_res['assembled']['us_per_step']:.2f} us/step "
          f"(fraction_of_triad "
          f"{big_res['assembled']['fraction_of_triad']:.3f})")
    for name in ("caar_t4_cuda", "dss_fixup_cuda", "dss_sweep_cuda",
                 "saxpby_cuda"):
        if big[name] <= 0:
            raise AssertionError(f"{name} was not launched on the ne{NE120} "
                                 "path")
    print(f"phase 24 traced main-path launches: {json.dumps(traced)}")
    for name in ("caar_t4_cuda", "vlap_cuda", "tracer_euler_cuda",
                 "dss_fixup_cuda", "dss_sweep_cuda"):
        if traced[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 24's "
                                 "path")
    print(f"phase 25 bench_all main-path launches: {json.dumps(swept)}")
    for name in ("caar_packed", "euler_packed", "saxpby_cuda"):
        if swept[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 25's "
                                 "path")
    print(f"phase 26 long runs main-path launches: {json.dumps(longs)}")
    for name in ("caar_t4_cuda", "vlap_cuda", "tracer_euler_cuda",
                 "tracer_limit_cuda", "dss_extract_cuda", "dss_fixup_cuda",
                 "dss_sweep_cuda"):
        if longs[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 26's "
                                 "path")
    print(f"phase 27 equiv_check main-path launches: {json.dumps(equiv)}")
    for name in ("caar_packed", "caar_t4_cuda", "vlap_cuda",
                 "tracer_euler_cuda", "tracer_limit_cuda", "dss_extract_cuda",
                 "dss_fixup_cuda", "dss_sweep_cuda", "dss_sweep_banded_cuda"):
        if equiv[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 27's "
                                 "path")
    print(f"phase 28 tools main-path launches: {json.dumps(tools)}")
    for name in ("caar_t4_cuda", "vlap_cuda", "tracer_euler_cuda",
                 "tracer_limit_cuda", "dss_extract_cuda", "dss_fixup_cuda",
                 "dss_sweep_cuda"):
        if tools[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 28's "
                                 "path")
    print(f"phase 29 storage main-path launches: {json.dumps(stored)}; in a "
          f"bf16 storage: {json.dumps(stored_bf16)}; bench --ne {NE} "
          "us/step f32 / bf16_aux / bf16_ro: " + " / ".join(
              f"{storage_res[('ne30', s)]['us_per_step']:.2f}"
              for s in ("f32", *STORAGE_MODES)))
    for name in ("caar_t4_cuda", "caar_ring_packed_t4", "caar_packed",
                 "dss_fixup_cuda", "dss_sweep_cuda", "dss_merge_patch_cuda"):
        if stored[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 29's "
                                 "path")
    for name in ("caar_t4_cuda", "caar_ring_packed_t4", "caar_packed"):
        if stored_bf16[name] <= 0:
            raise AssertionError(f"{name} was not launched in a bf16 storage "
                                 "on phase 29's path")
        rows[name]["storage_launches"] = stored_bf16[name]
    print(f"phase 30 prim storage main-path launches: "
          f"{json.dumps(prim_stored)}; in a bf16 storage: "
          f"{json.dumps(prim_stored_bf16)}; bench us/step " + ", ".join(
              f"{label} {res['us_per_step']:.2f}"
              for label, res in prim_storage_res.items())
          + f" (f32 in phases 10 and 12: rk {dyn_res['us_per_step']:.2f}, "
          f"prim {prim_res['us_per_step']:.2f}, prim limit q{QSIZE_TALL} "
          f"{tall_lim_res['us_per_step']:.2f})")
    for name in ("caar_t4_cuda", "tracer_euler_cuda", "tracer_limit_cuda",
                 "dss_fixup_cuda", "dss_sweep_cuda", "vlap_cuda"):
        if prim_stored[name] <= 0:
            raise AssertionError(f"{name} was not launched on phase 30's "
                                 "path")
    for name in ("caar_t4_cuda", "tracer_euler_cuda", "tracer_limit_cuda",
                 "dss_sweep_cuda"):
        if prim_stored_bf16[name] <= 0:
            raise AssertionError(f"{name} was not launched with a bf16 "
                                 "operand on phase 30's path")
        rows[name]["prim_storage_launches"] = prim_stored_bf16[name]
    if row_asm_res["kernel_launches"]["caar_packed"] <= 0:
        raise AssertionError("bench --layout row --ne: no row CAAR launch")
    if single_launches <= 0:
        raise AssertionError("the CAAR stage mode was not launched on the "
                             "dynamics path")
    if slab_launches <= 0:
        raise AssertionError("the CAAR slab mode was not launched on the "
                             "assembled path")
    rows["caar_t4_cuda"]["slab_launches"] = slab_launches
    rows["caar_t4_cuda"]["single_launches"] = single_launches
    kernels = []
    for name in wrappers:
        r = dict(rows[name])
        r.pop("name", None)
        kernels.append({
            "name": name, "route": r.pop("route"), "source": r.pop("source"),
            "replaces": r.pop("replaces"),
            "launches": raw[name] + asm[name] + dyn[name] + prim[name]
            + row[name] + ring[name] + multi[name] + probe[name]
            + cadence[name] + tiers[name] + big[name] + traced[name]
            + swept[name] + longs[name] + equiv[name] + tools[name]
            + stored[name] + prim_stored[name],
            "max_abs_err": r.pop("max_abs_err"), "ms": r.pop("ms"),
            "plain_ms": r.pop("plain_ms"), "bound_ms": r.pop("bound_ms"),
            "bound_by": r.pop("bound_by"), "library_ms": r.pop("library_ms"),
            **r})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
