#!/usr/bin/env python3
"""Time other launch plans of the kernels redesigned for the H100 (the
structured DSS sweep, the level-chunked CAAR kernel, the DSS fixup, the
remap kernel and the tracer stages)
beside the plans the port uses, at the main path's shapes. An experiment,
not part of the port: the port keeps one plan per kernel, and this script is
how the hypotheses about them were tested.

    python3 experiments/kernel_variants.py [sweep] [caar] [fixup] [remap]
        [tracer] [row] [ring] [banded] [tracer_ring] [rsplit0] [storage]
        [tracer_bf16] [row_tracer] [extract] [remap_parent]

from the repository root: the named groups (default all fourteen), in that
order.

  1. the sweep: the port's kernel (``dss_sweep_cuda``: one row a thread, 40
     registers, 6 blocks an SM) and the variants of ``sweep_variants.cu``
     (built here into ``build/experiments/``), each with 1, 2 or 4 rows a
     thread, with the tables and the partner offsets read once a thread or
     once a row ("reread"), all at 80 registers and pinned to 3 blocks an
     SM by their dynamic shared memory. At fixed warps an SM, the reread
     variants do the one-row kernel's work per element with 1, 2 or 4 rows
     of loads in flight a thread (H3: bytes in flight), and each pair at 2
     or 4 rows differs only in reading the tables and decoding once or per
     row (H1 with H2). Each is checked bit for bit against
     ``dss_sweep_plain`` (with and without mix) at 288 rows and timed from
     CUDA graphs on ne30 at 72, 288 and 2,520 rows, without and with mix;
  2. the CAAR kernel under other (chunks, stash) plans of 32-column tiles
     (``caar_plan`` replaced for the run), each held per field within 5e-5
     of ``caar_t4_plain`` at 1024 x 72 and timed from CUDA graphs in the
     pair form at 1024 x 72, the pair form with the slab and the stage mode
     with the slab, with and without phi, at ne30 x 72;
  3. the fixup: the port's kernel (``dss_fixup_cuda``) and the variants of
     ``fixup_variants.cu`` (flat with u fastest, the kernel before the tile;
     flat with the row fastest; tiles of 32 fix lanes x 32 or 64 rows), each
     checked bit for bit against ``dss_fixup_plain`` and timed from CUDA
     graphs on ne30 at 72, 288 and 2,520 rows;
  4. the remap kernel's pass breakdown (``remaps``): the port's
     ``csrc/remap.cu`` and the kernel before its redesign
     (``remap_parent.cu``), each built whole and cut down by
     ``REMAP_VARIANT`` (no field passes; the chains; the chains and the
     geometry, the parent's also as one pass of one warp; loads and stores
     only; the port's also without the reconstruction, without the target
     pass, and the geometry without its t sums or its walk), the port's
     also with per-phase clocks (``REMAP_CLOCKS``) and other register caps
     (``REMAP_MIN_BLOCKS``), all built in parallel; each timed from CUDA
     graphs on phase 21's input (the cadence after rsplit steps) at ne30 x
     72, f32, plm, qsize 1 and 35, every whole build held to phase 21's
     gates and timed for pcm and ppm, in the float64 level form (ne4 x 8
     and ne30 x 72) and on L2-resident against cold input;
  5. the tracer stages (the Euler stage, the limited stage without and with
     the Shu-Osher mix) at ne30 x 72, qsize 1 and 35: the port's quad
     layout through its wrappers (with the slab, as the main path); its
     kernel built from ``csrc/tracer.cu`` as the port builds it and with
     both stages in blocks of 4 or 8 warps (``TRACER_WARPS``) holding 2 or
     1 levels a warp at once (``TRACER_GROUP``), their registers uncapped
     or capped (``TRACER_MIN_BLOCKS``), all with the slab, and as the port
     without
     it; the variants of ``tracer_variants.cu``: half-warp elements as
     before the quad layout, the same with 2 rows in flight, the same with
     the limiter's butterflies merged (no slab), an element a thread with
     and without the slab, and capped for 3 blocks an SM. Each is checked
     per tracer block against its plain version at 5e-5 at a long dt (the
     slab bit for bit the output at the fix lanes) and timed from CUDA
     graphs, with ptxas's registers and cudaOccupancy's blocks an SM of
     every instance;
  6. the row-layout CAAR kernel beyond its shared-memory planes
     (``caar_packed`` above 197 levels, ``caar_packed_rsplit0`` above 161):
     ``csrc/caar.cu`` built as the port builds it (windows of 8 levels) and
     with ``CAAR_ROW_WINDOW`` 0 (every field read and written in place, the
     design the windows replaced) and 4, and the port's window and the
     in-place kernel with ``CAAR_ROW_CARVEOUT`` 0 (the preferred carveout
     that leaves the SM the most L1), all built in parallel. Each at 1024 x
     400 and 1024 x 198, and at 1024 x 150 with the windowed plan in place
     of the staged one (the port's build also staged), both rsplit modes on
     the bench case of ``chip_smoke.r0_cases``: held per field within 5e-5
     of the plain version in f64, compared bit for bit with the port's
     build, timed from CUDA graphs, with ptxas's registers and spills of
     the row kernel's instances.

  7. the CAAR ring kernel (``caar_ring_packed_t4``) at ne30 x 72, in the
     pair form with the slab and the stage mode without phi with mix:
     ``csrc/caar.cu`` built as the port builds it and with the parts of
     its design changed one or two at a time (``RING_BUILDS``: the tile,
     the sweep, the rows in flight, the L1 reads, the L2 hints, the
     discard; the producer alone, with its wait, without s1 stores, and
     discarding its own tile; the sweep's stores alone and with the
     group's loads; the design before), all built in parallel, some at
     each lag of ``RING_LAGS``. Each is held bit for bit against the two
     launches it fuses (``caar_t4_cuda`` with the slab, then
     ``dss_sweep_nomerge_cuda``; the builds without the whole sweep on
     everything but w) and timed by events and from CUDA graphs, with its
     plan, cudaOccupancy's blocks an SM and ptxas's registers; the two
     launches and each alone are timed first;
  8. the banded sweep over the shards of ne30 (m 2, N 12) at 288 and 2,520
     rows and of ne32 (m 4, N 6) at 288: the port's float4 kernel against
     the lane-a-thread kernel it replaced (``banded_variants.cu``), bit for
     bit on every shard, merged and merge-free, both timed from CUDA graphs
     over all the shards (one launch a shard) beside one shard alone and
     the single-device sweep of the same sphere;
  9. the tracer ring kernel (``tracer_ring_packed_t``) at ne30 x 72, qsize
     1 and 35, without and with mix: ``csrc/tracer.cu`` built as the port
     builds it and with one or two parts of its design changed
     (``TRACER_RING_BUILDS``: the sweep's reads through L2 alone, no
     discard, no L2 hints, 2 rows of loads in flight a thread; the producer
     alone, with its wait, without hints; the lane-a-thread sweep of the
     design before), all built in parallel, some at each lag of
     ``TRACER_RING_LAGS``, the port's also with items of each size of
     ``TRACER_RING_ROWS`` (``ring_fused.TRACER_RING_ITEM_ROWS`` replaced
     for the run). Each is held bit for bit against the two
     launches it fuses (``tracer_euler_cuda`` with the slab, then
     ``dss_sweep_nomerge_cuda``; the builds without the sweep on the slab)
     and timed by events and from CUDA graphs, with ptxas's registers and
     cudaOccupancy's blocks an SM; the two launches and each alone first;
 10. the t-layout rsplit=0 CAAR kernel (``caar_packed_rsplit0_t``) on the
     bench case of ``chip_smoke.r0_cases`` at 1024 x 72, ne30 x 72 and 1024
     x 400 under each plan of ``R0_PLANS`` (``caar_plan`` replaced for the
     run): with the stash at 2 blocks an SM (128 registers) and at 3 (80,
     the instance ``caar_plan`` takes from R0_WAVES waves), and without
     the stash; each held per field within 5e-5 of the plain version in f64
     and bit for bit the row rsplit=0 kernel on the transposed problem,
     timed from CUDA graphs beside the row kernel and the t pair form, with
     ptxas's registers of each instance;
 11. the row CAAR kernel's bf16 storage (``caar_packed`` and
     ``caar_packed_rsplit0`` with bf16 qdp and pecnd, and with bf16 nm1
     fields too: ``kernels.caar_t.STORAGE``) at 1024 x 72 and ne30 x 72 on
     the bench case of ``chip_smoke.r0_cases``: ``csrc/caar.cu`` built as
     the port builds it (qdp and pecnd in the cp.async groups that overlap
     passes 1 and 2: f32, or bf16 as raw pairs upcast after their group's
     wait) and with ``CAAR_ROW_SYNC_AUX`` (``STORAGE_BUILDS``: qdp and
     pecnd staged by plain loads before pass 1 in every mode, the bf16
     staging before the raw pairs and, in f32, the control that shows what
     the overlap is worth), with ``CAAR_ROW_EPI_RAW=0`` (the epilogue's
     bf16 nm1 fields upcast as loaded, not at their use) and with
     ``CAAR_ROW_QDP_GROUP=1`` (a bf16 qdp's raw pairs sent with dp, not
     with u, v and T, and upcast before pass 1), built in parallel. Each build in f32,
     bf16_aux and bf16_ro, held bit for bit against the port's build and,
     in a bf16 mode, against the f32 mode on the operands upcast, timed
     from CUDA graphs, with ptxas's registers of the row kernel's storage
     instances.
 12. the tracer stages' bf16 q (the tracer group's bf16 case): the limited
     stage with an f32 q and a bf16 q and the Euler stage with both, at
     ne30 x 72, qsize 1 and 35, through the port's wrappers on builds of
     ``csrc/tracer.cu`` (``TRACER_BF16_BUILDS``): the port's at iters 0, 1
     and 2, the loads and stores alone (``TRACER_CUT=1``), the body
     without the limiter (``TRACER_CUT=2``) and the limited stage's bf16 q
     prefetched as before (``TRACER_BF_AHEAD``) and the limiter's empty
     passes skipped by no limited instance (``TRACER_SKIP=0``; the port's
     build skips them in every one), built in parallel; each
     case also on the f32 instance with the bf16 q upcast (its data
     through the f32 code). Each bf16 instance bit for bit its f32
     instance on the upcast q, each cut build bit for bit what it
     computes; timed from CUDA graphs, then split by
     differences into the loads, the advection, the bounds with the mass
     and the residual pass, and each limiter pass, beside ptxas's
     registers and spills and cudaOccupancy's blocks an SM.
 13. the row-layout tracer Euler kernel (``euler_packed``) at ne30 x 72,
     qsize 1 and 35, and ne30 x 26 (scalar columns) at qsize 35: the port
     through its wrapper; ``csrc/tracer.cu`` built as the port builds it
     and with ``ROW_TRACER_BUILDS``' flags (registers uncapped or capped
     for 5 blocks an SM, the next tracer loaded after the store, other
     quads a block), each at every tracers-a-block of
     ``ROW_TRACER_CHUNKS``, with scalar columns at nlev 26; the
     kernel before its redesign (``row_tracer_variants.cu``, the control);
     the t form on the transposed problem. Each within 5e-5 per tracer
     block of ``euler_packed_plain`` at a long dt, whether it is bit for
     bit the t form printed, timed from CUDA graphs beside its bound, with
     ptxas's registers and cudaOccupancy's blocks an SM;
 14. the DSS extract (``dss_extract_cuda``) on ne30 at 72, 288 and 2,520
     rows and on ne120 at 288: the port, the variants of
     ``extract_variants.cu`` (the kernel before its redesign the control;
     more rows of loads a thread, L2-only loads, a grid of one wave) and
     the library call, each bit for bit ``dss_extract_plain``, timed from
     CUDA graphs beside the byte bound and the sector floor.

Every line is one JSON object and names the card and its power limit.
Without a card the script raises.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (CAAR_TOL, caar_cases, caar_field_errs,  # noqa: E402
                        card_line, cuda_ms, graph_ms)

# (rows a thread, reread) of the variants; the dynamic shared memory that
# pins every variant to 3 blocks an SM (4 x (64 KiB + the 1 KiB reserved
# a block) exceed the SM's 228 KiB, 3 fit)
SWEEP_VARIANTS = ((1, False), (2, True), (4, True), (2, False), (4, False))
SWEEP_SMEM = 65536
SWEEP_PINNED_BLOCKS = 3
# (chunks, stash) of the CAAR kernel, the port's plan first
CAAR_VARIANTS = ((8, True), (8, False), (6, True), (6, False), (4, True))


CSRC = os.path.join(ROOT, "tinman_sandbox_tpu_torch", "csrc")


def _compile(name, source=None, flags=()):
    """Build experiments/<name>.cu, or ``source`` with extra nvcc
    ``flags``, (nvcc, sm_90a) into build/experiments/<name>.so; returns (its
    path, ptxas's report)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(ROOT, "build", "experiments")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"{name}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    done = subprocess.run(
        [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", *flags, "-I", CSRC,
         "-o", lib, source or os.path.join(here, f"{name}.cu")],
        capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stderr[-6000:]}")
    return lib, done.stderr


def _sweep_library():
    """Build sweep_variants.cu and return the library and the registers and
    spill bytes of each instance that ptxas reports."""
    lib, report = _compile("sweep_variants")
    regs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores.*?(\d+) bytes spill loads",
                      line)
        if m and name:
            regs.setdefault(name, {})["spills"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
    so = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.sweep_variant_launch.argtypes = [I, I, P, P, I, P, I, P, P, F, F, P,
                                        I, I, I, I, P]
    so.sweep_variant_blocks_per_sm.argtypes = [I, I, I, I]
    return so, regs


def _instance_regs(regs, rows, reread, mix):
    """ptxas's registers and spills of the instance sweep_variant<rows,
    reread, mix> (its mangled name carries the three template values)."""
    want = f"ILi{rows}ELb{int(reread)}ELb{int(mix)}E"
    hits = [v for k, v in regs.items() if want in k]
    return hits[0] if hits else None


def sweeps(dev, card, fix, rsp):
    from tinman_sandbox_tpu_torch.kernels.dss import (dss_sweep_cuda,
                                                      dss_sweep_plain)

    so, regs = _sweep_library()
    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    fields = {rows: (rnd(rows, fix.e16), rnd(rows, fix.nfix),
                     rnd(rows, fix.e16)) for rows in (72, 288, 2520)}
    ca, cb = float(np.float32(1 / 3)), float(np.float32(2 / 3))

    def launcher(rows_a_thread, reread):
        def run(x, vd, out, mx):
            err = so.sweep_variant_launch(
                rows_a_thread, int(reread), x.data_ptr(), rsp.data_ptr(),
                rsp.shape[0], vd.data_ptr(), fix.nfix,
                fix.fix_col.data_ptr(), 0 if mx is None else mx.data_ptr(),
                ca, cb, out.data_ptr(), x.shape[0], fix.e16, fix.ne,
                SWEEP_SMEM, torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"sweep variant launch failed: {err}")
            return out
        return run

    def port(x, vd, out, mx):
        return dss_sweep_cuda(x, rsp, vd, fix,
                              None if mx is None else (mx, ca, cb))

    plans = [("port", None, None)] + [
        ("variant", r, rr) for r, rr in SWEEP_VARIANTS]
    for kind, rows_a_thread, reread in plans:
        line = dict(card=card, kernel="dss_sweep", kind=kind)
        if kind == "port":
            run = port
            line.update(rows_a_thread=1, blocks_per_sm=6, registers_cap=40)
        else:
            run = launcher(rows_a_thread, reread)
            occ = [so.sweep_variant_blocks_per_sm(rows_a_thread, int(reread),
                                                  mix, SWEEP_SMEM)
                   for mix in (0, 1)]
            if occ != [SWEEP_PINNED_BLOCKS] * 2:
                raise AssertionError(f"sweep variant {rows_a_thread} rows, "
                                     f"reread {reread}: {occ} blocks an SM")
            line.update(rows_a_thread=rows_a_thread, reread=reread,
                        blocks_per_sm=occ[0], registers_cap=80,
                        ptxas={name: _instance_regs(regs, rows_a_thread,
                                                    reread, mix)
                               for name, mix in (("plain", False),
                                                 ("mix", True))})
        x, vd, mx = fields[288]
        for mixed in (False, True):
            got = run(x, vd, torch.zeros_like(x), mx if mixed else None)
            want = dss_sweep_plain(x, rsp, vd, fix,
                                   (mx, ca, cb) if mixed else None)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"sweep {line}: not bit for bit "
                                     f"(mix {mixed})")
        line["bitwise_288"] = True
        for rows, (x, vd, mx) in fields.items():
            out = torch.empty_like(x)
            reps = 30 if rows < 1000 else 10
            line[f"graph_ms_{rows}"] = graph_ms(
                lambda: run(x, vd, out, None), reps)
            line[f"mix_graph_ms_{rows}"] = graph_ms(
                lambda: run(x, vd, out, mx), reps)
        print(json.dumps(line), flush=True)


def caars(dev, card, fix, assembled, raw):
    import importlib

    caar_t = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc = assembled
    const, racc = raw
    r_scal, r_meta, r_s0, r_sm1, r_qdp, r_pecnd, r_dvv = const
    nlev = qdp.shape[0]
    port_plan = caar_t.caar_plan
    try:
        for chunks, stash in CAAR_VARIANTS:
            levels = -(-nlev // chunks)
            caar_t.caar_plan = lambda ncol, nl, r0=False: caar_t.CaarPlan(
                ncol, nl, caar_t.TILE, -(-nl // levels), levels, stash)
            p = caar_t.caar_plan(qdp.shape[1], nlev)
            line = dict(card=card, kernel="caar_chunk", chunks=p.chunks,
                        levels=levels, stash=stash, tile=p.tile,
                        blocks_per_sm=p.blocks_per_sm)
            errs = 0.0
            for _, args in caar_cases(const, racc):
                want = caar_t.caar_t4_plain(*args)
                kacc = [a.clone() for a in args[6:9]]
                got = caar_t.caar_t4_cuda(*args[:6], *kacc, args[9])
                torch.cuda.synchronize()
                errs = max(errs, *caar_field_errs(got, want, nlev).values())
            if errs > CAAR_TOL:
                raise AssertionError(f"caar {line}: {errs} > {CAAR_TOL}")
            line["max_scaled_err"] = errs
            ra = [a.clone() for a in racc]
            line["pair_1024_graph_ms"] = graph_ms(
                lambda: caar_t.caar_t4_cuda(r_scal, r_meta, r_s0, r_sm1,
                                            r_qdp, r_pecnd, *ra, r_dvv), 30)
            ka = [a.clone() for a in acc]
            line["pair_slab_ne30_graph_ms"] = graph_ms(
                lambda: caar_t.caar_t4_cuda(scal, meta, s0, sm1, qdp, pecnd,
                                            *ka, dvv, fix=fix), 20)
            for emit_phi in (True, False):
                line[f"stage_slab_ne30_phi{int(emit_phi)}_graph_ms"] = \
                    graph_ms(lambda: caar_t.caar_t4_cuda(
                        scal, meta, s0, None, qdp, pecnd, *ka, dvv, fix=fix,
                        single=True, emit_phi=emit_phi), 20)
            print(json.dumps(line), flush=True)
    finally:
        caar_t.caar_plan = port_plan


# the fixup's variants in fixup_variants.cu: (index, name)
FIXUP_VARIANTS = ((0, "flat_u_fastest"), (1, "flat_row_fastest"),
                  (2, "tiled_32x32"), (3, "tiled_32x64"))


def fixups(dev, card, fix, rsp):
    from tinman_sandbox_tpu_torch.kernels.dss import (dss_fixup_cuda,
                                                      dss_fixup_plain)

    lib, _ = _compile("fixup_variants")
    so = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.fixup_variant_launch.argtypes = [I, P, P, P, P, I, I, P, I, I, P]
    gen = torch.Generator(device=dev).manual_seed(5)
    slabs = {rows: torch.randn(fix.nsrc, rows, generator=gen, device=dev)
             for rows in (72, 288, 2520)}

    def launcher(variant):
        def run(slab, vd):
            err = so.fixup_variant_launch(
                variant, slab.data_ptr(), fix.fix_src.data_ptr(),
                fix.fix_lanes.data_ptr(), rsp.data_ptr(), rsp.shape[0],
                fix.e16, vd.data_ptr(), fix.nfix, slab.shape[1],
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"fixup variant launch failed: {err}")
            return vd
        return run

    port = lambda slab, vd: dss_fixup_cuda(slab, fix, rsp)
    for kind, run in [("port", port)] + [
            (name, launcher(v)) for v, name in FIXUP_VARIANTS]:
        line = dict(card=card, kernel="dss_fixup", kind=kind)
        for rows, slab in slabs.items():
            vd = torch.empty(rows, fix.nfix, device=dev)
            got = run(slab, vd)
            torch.cuda.synchronize()
            if not torch.equal(got, dss_fixup_plain(slab, fix, rsp)):
                raise AssertionError(f"fixup {kind} at {rows} rows: not bit "
                                     "for bit")
            line[f"graph_ms_{rows}"] = graph_ms(lambda: run(slab, vd),
                                                100 if rows < 1000 else 30)
        line["bitwise"] = True
        print(json.dumps(line), flush=True)


# the remap kernel's pass breakdown: builds of the port's csrc/remap.cu and
# of the kernel before its redesign (experiments/remap_parent.cu), each with
# REMAP_VARIANT (value, name): what a launch does (the sources' notes)
REMAP_VARIANTS = ((0, "full"), (1, "no_fields"), (2, "chains"),
                  (3, "geometry"), (4, "geometry_one_pass"),
                  (5, "loads_stores"))
# the port's further cuts: no reconstruction, no target pass, the geometry
# without its sums of t, without its walk
REMAP_PORT_VARIANTS = ((6, "no_reconstruction"), (7, "no_target_pass"),
                       (8, "geometry_no_sums"), (9, "geometry_no_walk"))
# the flags every build of the port's kernel in the breakdown takes
REMAP_PORT_FLAGS = []
# other builds of the port's kernel, full: (name, nvcc flags): with its
# per-phase clocks (REMAP_CLOCKS), its registers capped for other blocks an
# SM (REMAP_MIN_BLOCKS, the port's 5)
REMAP_OTHER = (("clocks", ["-DREMAP_CLOCKS"]),

               ("uncapped", ["-DREMAP_MIN_BLOCKS=1"]),
               ("min6", ["-DREMAP_MIN_BLOCKS=6"]))
REMAP_QSIZES = (1, 35)
# the L2 test: the first columns of phase 21's input at qsize 1 (one wave
# of 4 blocks an SM on 132 SMs; 24.3 MB read, under the 50 MB L2), launched
# on one copy ("hot") or on REMAP_COPIES copies in turn ("cold")
REMAP_L2_COLS = 132 * 4 * 32
REMAP_COPIES = 8


def _compile_all(builds):
    """``_compile`` of every (name, source, flags) at once, one nvcc each;
    returns {name: (library path, ptxas report)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(builds)) as ex:
        done = {name: ex.submit(_compile, name, src, flags)
                for name, src, flags in builds}
    return {name: f.result() for name, f in done.items()}


def _remap_registers(report):
    """ptxas's registers, stack frame and spill bytes of the f32 plm packed
    instance without the fixer (remap_kernel<float, 1, true>, and
    <float, 1, true, 0> where the kernel has the fixer's modes) in a
    build's report."""
    name, regs = None, {}
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            regs.setdefault(name, {}).update(
                stack=int(m.group(1)),
                spills=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, {})["registers"] = int(m.group(1))
    hits = [v for k, v in regs.items()
            if re.search(r"remap_kernelIfLi1ELb1E(Li0E)?E", k)]
    return hits[0] if hits else None


def remaps(dev, card, trees=("parent", "port")):
    """The remap group (``remap_parent``: the parent's builds alone): the
    pass breakdown of the port's kernel and of the kernel before its
    redesign (suspects S1-S4 of PERF.md), on phase 21's
    input (``chip_smoke.cadence_input``: the cadence after rsplit steps) at
    ne30 x 72, f32, plm, qsize 1 and 35, from CUDA graphs; every full build
    held to phase 21's gates (dp rows bit for bit the plain float32 code's,
    fields no further off the plain float64 remap than the plain float32
    code, column totals) and timed for pcm and ppm too, in the float64 level
    form at the drift tool's ne4 x 8 and at ne30 x 72 (within 1e-12 of the
    plain code), and on L2-resident input against cold input of the same
    shape. Registers from ptxas, blocks an SM from the library, achieved
    bandwidth = bytes read and written once over the time."""
    from chip_smoke import (REMAP_F64_TOL, REMAP_TOTAL_TOL, cadence_input,
                            column_total_err, scaled_err)
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.remap import (SCHEMES,
                                                        remap_packed_plain)
    from tinman_sandbox_tpu_torch.ops.remap import remap_levels_plain

    here = os.path.dirname(os.path.abspath(__file__))
    flags = _build.SOURCE_FLAGS["remap"]
    builds = []
    for tree, src in (("parent", os.path.join(here, "remap_parent.cu")),
                      ("port", os.path.join(CSRC, "remap.cu"))):
        if tree not in trees:
            continue
        extra = REMAP_PORT_FLAGS if tree == "port" else []
        more = REMAP_PORT_VARIANTS if tree == "port" else ()
        for v, vname in REMAP_VARIANTS + more:
            if tree == "port" and v == 4:   # its geometry is one pass a warp
                continue
            builds.append((f"remap_{tree}_{vname}", src,
                           flags + extra + [f"-DREMAP_VARIANT={v}"]))
    for name, extra in REMAP_OTHER if "port" in trees else ():
        builds.append((f"remap_port_{name}", os.path.join(CSRC, "remap.cu"),
                       flags + extra))
    libs = _compile_all(builds)
    k = 72
    inputs = {}
    for qsize in REMAP_QSIZES:
        prob, s, q = cadence_input(dev, qsize)
        hv = prob["hv"]
        ref = {}
        for scheme in SCHEMES:
            if qsize > 1 and scheme != "plm":
                continue
            p32 = remap_packed_plain(s, q, hv, k, qsize, scheme)
            p64 = remap_packed_plain(s.double(), q.double(), hv, k, qsize,
                                     scheme)
            ref[scheme] = (p32, p64)
        inputs[qsize] = (s, q, hv, ref)
        del prob
    torch.cuda.empty_cache()

    def launcher(so, s, q, hv, qsize, scheme, s_out, q_out):
        def run():
            err = so.remap_packed_launch(
                0, SCHEMES.index(scheme), s.data_ptr(), q.data_ptr(),
                hv.hyai.data_ptr(), hv.hybi.data_ptr(), float(hv.ps0),
                s_out.data_ptr(), q_out.data_ptr(), k, qsize, s.shape[1],
                torch.cuda.current_stream(dev).cuda_stream, dev.index)
            if err:
                raise RuntimeError(f"remap variant launch failed: {err}")
        return run

    def gates(tag, s, q, got, ref, qsize):
        p32, p64 = ref
        if not torch.equal(got[0][3 * k:], p32[0][3 * k:]):
            raise AssertionError(f"{tag}: dp rows not the plain code's")
        blocks = lambda x, y: list(x[:3 * k].split(k)) + list(y.split(k))
        dp = s[3 * k:]
        worst = {}
        for i, (a, b, c, x) in enumerate(zip(blocks(*got), blocks(*p32),
                                             blocks(*p64), blocks(s, q))):
            kern, plain = scaled_err(a, c), scaled_err(b, c)
            tot = column_total_err(x, dp, a, got[0][3 * k:], i >= 3)
            if kern > plain or tot > REMAP_TOTAL_TOL:
                raise AssertionError(f"{tag} block {i}: {kern} off the "
                                     f"float64 remap (plain float32 {plain}),"
                                     f" column totals {tot}")
            worst[i] = kern
        return max(worst.values())

    for name, _, bflags in builds:
        path, report = libs[name]
        so = ctypes.CDLL(path)
        for fn, argtypes in _build._SIGNATURES["remap"].items():
            if hasattr(so, fn):     # the parent's kernel has no fixer mode
                getattr(so, fn).argtypes = argtypes
        full = "REMAP_VARIANT=0" in " ".join(bflags) or "VARIANT" not in \
            " ".join(bflags)
        line = dict(card=card, kernel="remap_packed", build=name,
                    flags=bflags[len(flags):],
                    registers=_remap_registers(report),
                    blocks_per_sm=so.remap_blocks_per_sm(0, 1, 1, k,
                                                         dev.index),
                    smem=so.remap_smem_bytes(k, 4, 1))
        for qsize, (s, q, hv, ref) in inputs.items():
            for scheme in (SCHEMES if full and qsize == 1 else ("plm",)):
                s_out, q_out = torch.empty_like(s), torch.empty_like(q)
                run = launcher(so, s, q, hv, qsize, scheme, s_out, q_out)
                run()
                torch.cuda.synchronize()
                if full:
                    line[f"q{qsize}_{scheme}_scaled_err"] = gates(
                        f"{name} qsize {qsize} {scheme}", s, q,
                        (s_out, q_out), ref[scheme], qsize)
                ms = graph_ms(run, 20)
                line[f"q{qsize}_{scheme}_graph_ms"] = ms
                if scheme == "plm":
                    nbytes = 2 * (4 + qsize) * k * s.shape[1] * 4
                    line[f"q{qsize}_gb_s"] = nbytes / ms / 1e6
                del s_out, q_out
        if hasattr(so, "remap_clocks"):
            line.update(_remap_clocks(so, inputs, launcher))
        if full:
            line.update(_remap_levels_f64(so, dev, REMAP_F64_TOL, scaled_err,
                                          remap_levels_plain))
            line.update(_remap_l2(so, dev, inputs[1][:3], launcher))
        print(json.dumps(line), flush=True)


# the per-phase clock slots of csrc/remap.cu (REMAP_CLOCKS)
REMAP_PHASES = ("staging", "double_chain", "geometry_w0", "geometry_w1",
                "float_chain", "field0_reconstruction", "to_fields",
                "fields", "block")


def _remap_clocks(so, inputs, launcher):
    """A clocks build's cycles a block in each phase, one launch at each
    qsize (plm)."""
    so.remap_clocks.argtypes = [ctypes.c_void_p]
    out = {}
    for qsize, (s, q, hv, _) in inputs.items():
        s_out, q_out = torch.empty_like(s), torch.empty_like(q)
        run = launcher(so, s, q, hv, qsize, "plm", s_out, q_out)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        so.remap_clocks(buf)
        run()
        torch.cuda.synchronize()
        so.remap_clocks(buf)
        blocks = max(buf[9], 1)
        out[f"q{qsize}_cycles_a_block"] = {
            n: buf[i] / blocks for i, n in enumerate(REMAP_PHASES)}
    return out


def _remap_levels_f64(so, dev, tol, scaled_err, remap_levels_plain):
    """A build's float64 level form (plm, one field) at the drift tool's ne4
    x 8 and at ne30 x 72 on phase 21's random layers, held within ``tol`` of
    the plain code and timed from CUDA graphs."""
    out = {}
    for tag, ncol, nl in (("ne4x8", 96 * 16, 8), ("ne30x72", 5400 * 16, 72)):
        gen = torch.Generator(device=dev).manual_seed(13)
        f64 = torch.float64
        dps = torch.rand(nl, ncol, generator=gen, device=dev, dtype=f64) + 0.5
        w = torch.rand(nl, ncol, generator=gen, device=dev, dtype=f64) + 0.5
        dpt = w / w.sum(0) * dps.sum(0)
        x = torch.randn(nl, ncol, generator=gen, device=dev, dtype=f64)
        got = torch.empty_like(x)

        def run():
            err = so.remap_levels_launch(
                1, 1, x.data_ptr(), dps.data_ptr(), dpt.data_ptr(),
                got.data_ptr(), nl, 1, ncol,
                torch.cuda.current_stream(dev).cuda_stream, dev.index)
            if err:
                raise RuntimeError(f"remap level launch failed: {err}")

        run()
        err = scaled_err(got, remap_levels_plain(x, dps, dpt))
        if err > tol:
            raise AssertionError(f"remap level form {tag}: {err} > {tol}")
        out[f"f64_levels_{tag}_graph_ms"] = graph_ms(run, 20)
        out[f"f64_levels_{tag}_scaled_err"] = err
    return out


def _remap_l2(so, dev, inp, launcher):
    """A build at qsize 1, plm, on the first REMAP_L2_COLS columns of phase
    21's input: one copy launched again and again (its input stays in L2)
    and REMAP_COPIES copies in turn (each read from device memory), ms a
    launch from CUDA graphs."""
    s, q, hv = inp
    n = REMAP_L2_COLS
    copies = [(s[:, :n].contiguous(), q[:, :n].contiguous())
              for _ in range(REMAP_COPIES)]
    outs = [(torch.empty_like(a), torch.empty_like(b)) for a, b in copies]
    runs = [launcher(so, a, b, hv, 1, "plm", *o)
            for (a, b), o in zip(copies, outs)]
    hot = lambda: [runs[0]() for _ in runs]
    cold = lambda: [r() for r in runs]
    return dict(l2_cols=n, l2_hot_ms=graph_ms(hot, 10) / len(runs),
                l2_cold_ms=graph_ms(cold, 10) / len(runs))


# the tracer variants of tracer_variants.cu: (index, name, with the slab)
TRACER_VARIANTS = ((0, "half", False), (1, "half_ahead", False),
                   (2, "half_once", False), (3, "element", True),
                   (3, "element_noslab", False), (4, "element_3", True))
# builds of the port's quad kernel (csrc/tracer.cu): (name, nvcc flags, with
# the slab). The port's own build runs the Euler stage in blocks of 4 warps
# holding 2 levels each at once, uncapped, and the limited stage in blocks
# of 8 warps of 1 level with its registers capped for 4 blocks an SM; the
# others give both stages w warps a block (TRACER_WARPS) holding g levels
# at once (TRACER_GROUP), capped for b blocks an SM (TRACER_MIN_BLOCKS)
TRACER_BUILDS = (("quad", [], True),) + tuple(
    (f"quad_w{w}_g{g}_b{b}", [f"-DTRACER_WARPS={w}", f"-DTRACER_GROUP={g}",
                              f"-DTRACER_MIN_BLOCKS={b}"], True)
    for w, g, b in ((4, 2, 1), (4, 1, 8), (4, 2, 6), (8, 1, 4), (8, 1, 3))
) + (("quad_noslab", [], False),)
# the three instances timed: (name, limit, mix)
TRACER_CASES = (("euler", 0, False), ("limit", 1, False),
                ("limit_mix", 1, True))


def _tracer_regs(report, tag):
    """{instance: [registers, spill bytes]} of the kernel ``tag`` in
    ptxas's report, the instance named by its mangled template arguments."""
    regs, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if tag in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores.*?(\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            args = re.match(r"I(?:L[^E]+E)+E", name.split(tag, 1)[1])
            regs[args.group(0) if args else name] = [int(m.group(1)), spill]
    return regs


def tracers(dev, card):
    """The tracer stages at ne30 x 72, qsize 1 and 35: the port (the quad
    layout, through its wrappers as the main path calls them, with the
    slab), the port's kernel built with other TRACER_LEVELS (with it) and
    the variants of tracer_variants.cu (the elements with the slab, the
    half-warp ones without), each instance checked per tracer block against
    its plain version at 5e-5 at a long dt (the slab bit for bit the output
    at the fix lanes) and timed from CUDA graphs at the run's dt (0.1)."""
    from chip_smoke import DYN_DT, scaled_err
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.constants import CONSTANTS
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (
        tracer_euler_cuda, tracer_euler_plain, tracer_limit_cuda,
        tracer_limit_plain)

    lib, report = _compile("tracer_variants")
    so = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.tracer_variant_launch.argtypes = [I, I] + [P] * 9 + [I] * 6 + [F] * 4 \
        + [P]
    so.tracer_variant_blocks_per_sm.argtypes = [I, I, I]
    hregs = _tracer_regs(report, "half_kernel")
    eregs = _tracer_regs(report, "element_kernel")
    # the instances of each variant: <limit, mix, rows ahead, merged>
    vregs = {0: {i: r for i, r in hregs.items() if "Li0ELb0E" in i},
             1: {i: r for i, r in hregs.items() if "Li2ELb0E" in i},
             2: {i: r for i, r in hregs.items() if "Li0ELb1E" in i},
             3: {i: r for i, r in eregs.items() if i.endswith("Li1EE")},
             4: {i: r for i, r in eregs.items() if i.endswith("Li3EE")}}
    ports = {}
    for name, flags, with_slab in TRACER_BUILDS:
        plib, preport = _compile(
            f"tracer_{name}", os.path.join(CSRC, "tracer.cu"),
            _build.SOURCE_FLAGS["tracer"] + flags)
        pso = ctypes.CDLL(plib)
        for fn, argtypes in _build._SIGNATURES["tracer"].items():
            getattr(pso, fn).argtypes = argtypes
        ports[name] = (pso, _tracer_regs(preport, "tracer_kernel"),
                       dict(flags=flags, slab=with_slab))

    const, s0, _, _, plan, _ = bench.make_prim_problem(30, 72, dev, DYN_DT, 1)
    meta, dvv = const[1], const[3]
    fix = fix_tables(plan, dev)
    lanes = fix.read_lanes.long()
    k, e16 = 72, meta.shape[1]
    ca, cb = float(np.float32(1 / 3)), float(np.float32(2 / 3))
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    lines = {}

    def record(name, **info):
        lines.setdefault(name, dict(card=card, kernel="tracer", kind=name,
                                    **info))
        return lines[name]

    for qsize in (1, 35):
        q = bench.make_prim_problem(30, k, dev, DYN_DT, qsize)[2]
        mx = torch.rand(q.shape, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        div = q - tracer_euler_plain(meta, s0, s0, q, dvv, 1.0, k,
                                     fold_sph=False, wind_rows=(0, 1))
        dt_long = 0.5 * float(q.abs().max()) / float(div.abs().max())
        del div
        out = torch.empty_like(q)
        slab = torch.empty(fix.nfix, q.shape[0], device=dev)
        rank = fix.fix_rank.data_ptr()
        reps = 30 if qsize == 1 else 5

        def variant(v, with_slab):
            sl = (rank, slab.data_ptr()) if with_slab else (None, None)

            def run(limit, mixed, dt):
                err = so.tracer_variant_launch(
                    v, limit, meta.data_ptr(), dvv.data_ptr(), s0.data_ptr(),
                    s0.data_ptr(), q.data_ptr(),
                    mx.data_ptr() if mixed else None, out.data_ptr(), *sl,
                    k, qsize, e16, 0, 1, 2, dt, ca, cb, CONSTANTS.rrearth,
                    stream())
                if err:
                    raise RuntimeError(f"tracer variant {v}: error {err}")
                return out
            return run

        def port_build(name):
            pso, _, info = ports[name]
            sl = (rank, slab.data_ptr()) if info["slab"] else (None, None)

            def run(limit, mixed, dt):
                if limit:
                    err = pso.tracer_limit_launch(
                        meta.data_ptr(), dvv.data_ptr(), s0.data_ptr(),
                        s0.data_ptr(), q.data_ptr(),
                        mx.data_ptr() if mixed else None, out.data_ptr(),
                        *sl, k, qsize, e16, e16, 0, 1, 2, 0, dt, ca, cb,
                        CONSTANTS.rrearth, stream(), dev.index)
                else:
                    err = pso.tracer_euler_launch(
                        meta.data_ptr(), dvv.data_ptr(), s0.data_ptr(),
                        s0.data_ptr(), q.data_ptr(), out.data_ptr(), *sl, k,
                        qsize, e16, e16, 0, 1, 1, 0, dt, CONSTANTS.rrearth,
                        stream(), dev.index)
                if err:
                    raise RuntimeError(f"tracer {name}: error {err}")
                return out
            return run

        def port(limit, mixed, dt):
            kw = dict(wind_rows=(0, 1), fix=fix)
            if limit:
                return tracer_limit_cuda(meta, s0, s0, q, dvv, dt, k,
                                         mix=(mx, ca, cb) if mixed else None,
                                         **kw)[0]
            return tracer_euler_cuda(meta, s0, s0, q, dvv, dt, k, **kw)[0]

        wants = {}
        for name, limit, mixed in TRACER_CASES:
            kw = dict(wind_rows=(0, 1))
            wants[name] = (tracer_limit_plain(
                meta, s0, s0, q, dvv, dt_long, k,
                mix=(mx, ca, cb) if mixed else None, **kw) if limit else
                tracer_euler_plain(meta, s0, s0, q, dvv, dt_long, k, **kw))
        runs = [("port", port, {})]
        runs += [(name, port_build(name), dict(registers=regs, **info))
                 for name, (_, regs, info) in ports.items()]
        runs += [(name, variant(v, sl), dict(registers=vregs[v], slab=sl))
                 for v, name, sl in TRACER_VARIANTS]
        for name, run, info in runs:
            line = record(name, **info)
            for case, limit, mixed in TRACER_CASES:
                if name == "half_once" and not limit:
                    continue        # the variant changes the limiter only
                got = run(limit, mixed, dt_long)
                torch.cuda.synchronize()
                err = max(scaled_err(a, b) for a, b in zip(
                    got.split(k), wants[case].split(k)))
                if not err <= 5e-5:
                    raise AssertionError(f"tracer {name} {case} qsize "
                                         f"{qsize}: {err} > 5e-5")
                if info.get("slab") and not torch.equal(slab,
                                                        got[:, lanes].T):
                    raise AssertionError(f"tracer {name} {case} qsize "
                                         f"{qsize}: the slab is not the "
                                         "output at the fix lanes")
                line.setdefault("max_scaled_err", {})[f"{case}_q{qsize}"] = \
                    err
                line.setdefault("graph_ms", {})[f"{case}_q{qsize}"] = \
                    graph_ms(lambda: run(limit, mixed, DYN_DT), reps)
        del q, mx, out, slab, wants
        torch.cuda.empty_cache()
    for v, name, _ in TRACER_VARIANTS:
        lines[name]["blocks_per_sm"] = {
            case: so.tracer_variant_blocks_per_sm(v, limit, int(mixed))
            for case, limit, mixed in TRACER_CASES}
    for name, (pso, _, _) in ports.items():
        lines[name]["blocks_per_sm"] = {
            case: pso.tracer_blocks_per_sm(kind, dev.index)
            for case, kind in (("euler", 0), ("limit", 3),
                               ("limit_mix", 2))}
    for line in lines.values():
        print(json.dumps(line), flush=True)


# builds of csrc/tracer.cu for the stages' parts (group tracer_bf16): (name,
# nvcc flags), the port's first
TRACER_BF16_BUILDS = (("port", []), ("loads", ["-DTRACER_CUT=1"]),
                      ("advect", ["-DTRACER_CUT=2"]),
                      ("ahead0", ["-DTRACER_BF_AHEAD=0"]),
                      ("ahead1", ["-DTRACER_BF_AHEAD=1"]),
                      ("skip0", ["-DTRACER_SKIP=0"]))
# its cases: (name, limited, q: "f32", "bf16" or "up" (the f32 instance on
# the bf16 q upcast: the bf16 case's data through the f32 code),
# tracer_blocks_per_sm kind)
TRACER_BF16_CASES = (("limit_f32", True, "f32", 3),
                     ("limit_bf16", True, "bf16", 5),
                     ("limit_up", True, "up", 3),
                     ("euler_f32", False, "f32", 0),
                     ("euler_bf16", False, "bf16", 4))
TRACER_BF16_ITERS = (0, 1, 2)


def _short_regs(regs, tag):
    """{mangled template arguments: registers and spills} of ``regs``
    (``_caar_libraries``' {kernel name: ...}) for the kernel ``tag``."""
    out = {}
    for name, r in regs.items():
        m = re.match(r"I(?:L[^E]+E)+E", name.split(tag, 1)[-1])
        out[m.group(0) if m else name] = r
    return out


def tracer_bf16(dev, card):
    """The tracer stages' bf16 q case: the limited stage with an f32 q, a
    bf16 q and the f32 q upcast from it, and the Euler stage with an f32
    and a bf16 q, at ne30 x 72, qsize 1 and 35, on the prim bench's
    tracers with the slab, through the port's wrappers on builds of
    csrc/tracer.cu (TRACER_BF16_BUILDS, all at once): the port's at iters
    0, 1 and 2 (the limited stage), the loads and stores alone
    (TRACER_CUT=1), the body without the limiter (TRACER_CUT=2) and the
    limited stage's bf16 q prefetched otherwise (TRACER_BF_AHEAD 0: one
    tracer ahead, upcast as loaded; 1: one ahead, raw) and its empty
    limiter passes skipped by no instance (TRACER_SKIP=0; the port's build
    skips them in every limited instance). Each bf16 instance
    held bit for bit against its f32 instance on the upcast q, the cut
    builds against what they compute (sph*q; the Euler stage's output),
    timed from CUDA graphs at the run's dt; then, by differences, the
    loads, the advection, the bounds with the mass and the residual pass,
    and each limiter pass, beside ptxas's registers and spills and
    cudaOccupancy's blocks an SM of each instance."""
    from chip_smoke import DYN_DT
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables
    from tinman_sandbox_tpu_torch.kernels.layout import META_COLS
    from tinman_sandbox_tpu_torch.kernels.tracer_t import (tracer_euler_cuda,
                                                           tracer_limit_cuda)

    libs = _caar_libraries(TRACER_BF16_BUILDS, "bf16", "tracer_kernel",
                           source="tracer")
    for name, (so, regs) in libs.items():
        print(json.dumps(dict(
            card=card, kernel="tracer_bf16", build=name,
            flags=dict(TRACER_BF16_BUILDS)[name],
            registers=_short_regs(regs, "tracer_kernel"),
            blocks_per_sm={case: so.tracer_blocks_per_sm(kind, dev.index)
                           for case, _, _, kind in TRACER_BF16_CASES})),
              flush=True)
    const, s0, _, _, plan, _ = bench.make_prim_problem(30, 72, dev, DYN_DT, 1)
    meta, dvv = const[1], const[3]
    sph = meta[META_COLS.index("spheremp")]
    fix = fix_tables(plan, dev)
    k = 72
    kw = dict(wind_rows=(0, 1), fix=fix)
    port_library = _build.library
    use = lambda so: (lambda n: so if n == "tracer" else port_library(n))
    try:
        for qsize in (1, 35):
            q = bench.make_prim_problem(30, k, dev, DYN_DT, qsize)[2]
            qb = q.to(torch.bfloat16)
            ops = {"f32": q, "bf16": qb, "up": qb.float()}
            reps = 30 if qsize == 1 else 10
            times = {}
            for name, (so, _) in libs.items():
                _build.library = use(so)
                for case, limited, qk, _ in TRACER_BF16_CASES:
                    if name.startswith("ahead") and qk != "bf16" or \
                            name.startswith("skip") and not limited:
                        continue        # the builds differ there only
                    iters = TRACER_BF16_ITERS if limited and name == "port" \
                        else (2,)
                    for it in iters:
                        def run(x, it=it, limited=limited):
                            if limited:
                                return tracer_limit_cuda(
                                    meta, s0, s0, x, dvv, DYN_DT, k,
                                    iters=it, **kw)[0]
                            return tracer_euler_cuda(meta, s0, s0, x, dvv,
                                                     DYN_DT, k, **kw)[0]
                        x = ops[qk]
                        got = run(x)
                        xf = x.float()
                        if name == "loads":
                            want = xf * sph
                        elif name == "advect" and limited:
                            _build.library = port_library
                            want = tracer_euler_cuda(meta, s0, s0, xf, dvv,
                                                     DYN_DT, k, **kw)[0]
                            _build.library = use(so)
                        else:
                            want = run(xf)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"tracer_bf16 {name} {case} qsize {qsize} "
                                f"iters {it}: not the bits it computes")
                        ms = graph_ms(lambda: run(x), reps)
                        times[(name, case, it)] = ms
                        print(json.dumps(dict(
                            card=card, kernel="tracer_bf16", build=name,
                            case=case, qsize=qsize, iters=it, graph_ms=ms,
                            bits="held")), flush=True)
                        del got, want, xf
            for case, limited, _, _ in TRACER_BF16_CASES:
                t = lambda name, it=2: times[(name, case, it)]
                split = dict(loads=t("loads"))
                if limited:
                    split.update(
                        advection=t("advect") - t("loads"),
                        bounds_and_residual=t("port", 0) - t("advect"),
                        pass_1=t("port", 1) - t("port", 0),
                        pass_2=t("port", 2) - t("port", 1))
                else:
                    split.update(body=t("port") - t("loads"))
                split["whole"] = t("port")
                print(json.dumps(dict(card=card, kernel="tracer_bf16",
                                      split=case, qsize=qsize,
                                      graph_ms=split)), flush=True)
            del q, qb, ops
            torch.cuda.empty_cache()
    finally:
        _build.library = port_library


# builds of csrc/caar.cu for the row kernel beyond its planes: (name, nvcc
# flags), the port's first
ROW_BUILDS = (("w8", []), ("inplace", ["-DCAAR_ROW_WINDOW=0"]),
              ("w4", ["-DCAAR_ROW_WINDOW=4"]),
              ("w8_maxl1", ["-DCAAR_ROW_CARVEOUT=0"]),
              ("inplace_maxl1", ["-DCAAR_ROW_WINDOW=0",
                                 "-DCAAR_ROW_CARVEOUT=0"]))
# (nlev, the windowed plan forced where the port stages)
ROW_SHAPES = ((400, False), (198, False), (150, False), (150, True))


def _caar_libraries(builds, tag, instance, source="caar"):
    """Build every (name, nvcc flags) of ``builds`` from csrc/<source>.cu
    (caar.cu by default) at once (one nvcc each) into
    build/experiments/<source>_<tag>_<name>.so; returns {name: (the loaded
    library, {instance: registers, spills})} for the kernels whose names
    contain ``instance``."""
    from tinman_sandbox_tpu_torch.kernels import _build

    out = os.path.join(ROOT, "build", "experiments")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, flags in builds:
        lib = os.path.join(out, f"{source}_{tag}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build._flags(source), *flags, "-o", lib,
             os.path.join(CSRC, _build.SOURCES[source])],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"{source} {tag} build {name}: "
                               f"{report[-2000:]}")
        so = ctypes.CDLL(lib)
        for fn, argtypes in _build._SIGNATURES[source].items():
            f = getattr(so, fn)
            f.argtypes = argtypes
            f.restype = (ctypes.c_char_p if fn.endswith("_error_string")
                         else ctypes.c_int)
        regs, inst = {}, None
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                inst = m.group(1) if instance in m.group(1) else None
            m = re.search(r"(\d+) bytes spill stores.*?(\d+) bytes spill "
                          r"loads", line)
            if m and inst:
                regs.setdefault(inst, {})["spills"] = int(m.group(1)) + int(
                    m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and inst:
                regs.setdefault(inst, {})["registers"] = int(m.group(1))
        libs[name] = (so, regs)
    return libs


def _row_libraries():
    return _caar_libraries(ROW_BUILDS, "row", "caar_row_kernel")


def rows(dev, card):
    import dataclasses
    import importlib

    from chip_smoke import r0_cases, row_modes, run_mode, scaled_err
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build

    caar_t = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")
    libs = _row_libraries()
    for name, (_, regs) in libs.items():
        print(json.dumps(dict(card=card, kernel="caar_row", build=name,
                              registers=regs)), flush=True)
    modes = {n: m for n, m in row_modes().items()
             if n != "caar_packed_rsplit0_t"}
    port_library, port_plan = _build.library, caar_t.caar_row_plan
    try:
        for nlev, windowed in ROW_SHAPES:
            const, acc = bench.make_problem(1024, nlev, dev, seed=7)
            targs = dict(r0_cases(const, acc))["bench"]
            for mode, (kern, plain, conv, names) in modes.items():
                args = conv(targs)
                nacc = 4 if len(names) == 9 else 3
                want64 = plain(*(x.double() for x in args))
                r0 = mode == "caar_packed_rsplit0"
                if windowed:
                    caar_t.caar_row_plan = lambda ncol, nl, r0=False: \
                        dataclasses.replace(port_plan(ncol, nl, r0),
                                            stash=False)
                plan = caar_t.caar_row_plan(1024 * 16, nlev, r0)
                first = None
                for name, (so, _) in libs.items():
                    _build.library = (lambda n, so=so: so if n == "caar"
                                      else port_library(n))
                    kacc = [x.clone() for x in args[-1 - nacc:-1]]
                    got = kern(*args[:-1 - nacc], *kacc, args[-1])
                    torch.cuda.synchronize()
                    e64 = max(scaled_err(g, w) for g, w in zip(got, want64))
                    if e64 > CAAR_TOL:
                        raise AssertionError(f"caar row {name} {mode} {nlev}"
                                             f": {e64} > {CAAR_TOL}")
                    # the accumulators are updated in place: keep copies
                    first = first or tuple(g.clone() for g in got)
                    line = dict(card=card, kernel=mode, build=name,
                                nlev=nlev, ncol=1024 * 16,
                                plan="staged" if plan.stash else "windowed",
                                max_scaled_err_f64=e64,
                                bitwise_port_build=all(
                                    torch.equal(g, f)
                                    for g, f in zip(got, first)))
                    del got
                    line["graph_ms"] = graph_ms(
                        lambda: kern(*args[:-1 - nacc], *kacc, args[-1]), 10)
                    print(json.dumps(line), flush=True)
                _build.library = port_library
                caar_t.caar_row_plan = port_plan
                del want64, first
            del const, acc, targs
            torch.cuda.empty_cache()
    finally:
        _build.library, caar_t.caar_row_plan = port_library, port_plan


# builds of csrc/caar.cu for the CAAR ring kernel: (name, nvcc flags, tile),
# the port's first (32-column tiles, the float4 sweep with 3 rows of loads
# in flight reading s1 through L1, s1 stored evict-last and w evict-first
# in L2, s1 discarded from L2 once read); then one or two of those
# changed: the sweep's reads through L2 alone (CAAR_RING_L1), the L2 hints
# (CAAR_RING_KEEP), the discard (CAAR_RING_DISCARD), the rows in flight
# (CAAR_RING_UNROLL), the sweep (CAAR_RING_SWEEP: 0 none and no wait, the
# producer alone; 3 the wait alone; 2 a lane a thread, as before), the tile
# (CAAR_RING_TILE); "tile128_lane_keep" is the design before; the producer
# alone without s1 stores (CAAR_RING_KEEP=2), and discarding its own tile
# as soon as it is stored (CAAR_RING_SWEEP=4), plain or evict-last. The
# port's and three other builds run at each lag of RING_LAGS, the others
# at the port's; the builds that leave s1 evict-last in L2 undiscarded run
# last.
_PLAIN = ["-DCAAR_RING_KEEP=0", "-DCAAR_RING_DISCARD=0"]
RING_BUILDS = (
    ("port", [], 32),
    ("l2_reads", ["-DCAAR_RING_L1=0"], 32),
    ("no_hint", ["-DCAAR_RING_KEEP=0"], 32),
    ("no_discard_no_hint", _PLAIN, 32),
    ("l2_reads_no_discard_no_hint", ["-DCAAR_RING_L1=0", *_PLAIN], 32),
    ("unroll3", ["-DCAAR_RING_UNROLL=3"], 32),
    ("producer", ["-DCAAR_RING_SWEEP=0", *_PLAIN], 32),
    ("producer_wait", ["-DCAAR_RING_SWEEP=3", *_PLAIN], 32),
    ("lane_sweep", ["-DCAAR_RING_SWEEP=2", *_PLAIN], 32),
    ("tile64", ["-DCAAR_RING_TILE=64", *_PLAIN], 64),
    ("tile128", ["-DCAAR_RING_TILE=128", *_PLAIN], 128),
    ("tile128_producer", ["-DCAAR_RING_TILE=128", "-DCAAR_RING_SWEEP=0",
                          *_PLAIN], 128),
    ("tile128_lane_keep", ["-DCAAR_RING_TILE=128", "-DCAAR_RING_SWEEP=2",
                           *_PLAIN], 128),
    ("producer_no_s1", ["-DCAAR_RING_SWEEP=0", "-DCAAR_RING_KEEP=2",
                        "-DCAAR_RING_DISCARD=0"], 32),
    ("producer_discards", ["-DCAAR_RING_SWEEP=4", "-DCAAR_RING_KEEP=0"], 32),
    ("producer_hint_discards", ["-DCAAR_RING_SWEEP=4"], 32),
    ("sweep_stores", ["-DCAAR_RING_SWEEP=5"], 32),
    ("sweep_group_loads", ["-DCAAR_RING_SWEEP=6"], 32),
    ("no_discard", ["-DCAAR_RING_DISCARD=0"], 32),
    ("producer_hint", ["-DCAAR_RING_SWEEP=0", "-DCAAR_RING_DISCARD=0"], 32))
RING_LAGS = (0, 16, 48, 128, 256)
_LAGGED = ("port", "l2_reads", "no_hint", "producer_wait", "sweep_stores",
           "sweep_group_loads")


def ring(dev, card, fix, assembled, rsp):
    from tinman_sandbox_tpu_torch.kernels import _build, ring_fused
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda
    from tinman_sandbox_tpu_torch.kernels.dss import dss_sweep_nomerge_cuda

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc = assembled
    k = qdp.shape[0]
    mx = torch.randn(s0.shape, generator=torch.Generator(
        device=dev).manual_seed(15), device=dev)
    ca, cb = float(np.float32(1 / 3)), float(np.float32(2 / 3))
    modes = {"pair_slab": dict(sm1=sm1, kw={}),
             "stage_mix": dict(sm1=None, kw=dict(
                 single=True, emit_phi=False, mix=(mx, ca, cb)))}
    # the two launches the ring fuses, and each alone, on the port's build
    ref = {}
    for mode, m in modes.items():
        kw = dict(m["kw"])
        mix = kw.pop("mix", None)
        tacc = [a.clone() for a in acc]
        two = caar_t4_cuda(scal, meta, s0, m["sm1"], qdp, pecnd, *tacc, dvv,
                           fix=fix, **kw)
        ref[mode] = (dss_sweep_nomerge_cuda(two[0], rsp, fix, mix), two[1],
                     tacc, two[5])
        ka = [a.clone() for a in acc]
        caar = lambda: caar_t4_cuda(scal, meta, s0, m["sm1"], qdp, pecnd,
                                    *ka, dvv, fix=fix, **kw)
        s1 = caar()[0]
        sweep = lambda: dss_sweep_nomerge_cuda(s1, rsp, fix, mix)
        two = lambda: dss_sweep_nomerge_cuda(caar()[0], rsp, fix, mix)
        print(json.dumps(dict(
            card=card, kernel="caar_ring_reference", mode=mode,
            two_launch_graph_ms=graph_ms(two, 20),
            two_launch_ms=cuda_ms(two, 20), caar_graph_ms=graph_ms(caar, 20),
            sweep_graph_ms=graph_ms(sweep, 20))), flush=True)
        del s1
    libs = _caar_libraries([(n, f) for n, f, _ in RING_BUILDS], "ring",
                           "caar_ring_kernel")
    port_library, port_plan = _build.library, ring_fused.ring_plan
    runs = [(name, tile, lag) for name, _, tile in RING_BUILDS
            for lag in (RING_LAGS if name in _LAGGED
                        else (ring_fused.RING_LAG,))]
    try:
        for name, tile, lag in runs:
            so, regs = libs[name]
            _build.library = (lambda n, so=so: so if n == "caar"
                              else port_library(n))
            ring_fused.ring_plan = (lambda ncol, nl, ne, t=tile, g=lag:
                                    port_plan(ncol, nl, ne, tile=t, lag=g))
            plan = ring_fused.ring_plan(s0.shape[1], k, fix.ne)
            line = dict(card=card, kernel="caar_ring", build=name,
                        tile=tile, lag=lag, threads=plan.caar.threads,
                        stash=plan.caar.stash, halo=plan.geo.halo,
                        blocks=plan.tickets,
                        blocks_per_sm=so.caar_blocks_per_sm(
                            1, k, plan.caar.chunks, int(plan.caar.stash), 0,
                            dev.index),
                        registers=regs)
            for mode, m in modes.items():
                kacc = [a.clone() for a in acc]
                run = lambda: ring_fused.caar_ring_packed_t4(
                    scal, meta, s0, m["sm1"], qdp, pecnd, *kacc, dvv, rsp,
                    fix, **m["kw"])
                got = run()
                torch.cuda.synchronize()
                w, phi, tacc, slab = ref[mode]
                same = [torch.equal(got[5], slab)] + [
                    torch.equal(a, b) for a, b in zip(kacc, tacc)]
                if phi is not None:
                    same.append(torch.equal(got[1], phi))
                swept = "producer" not in name and "sweep_" not in name
                if swept:
                    same.append(torch.equal(got[0], w))
                if not all(same):
                    raise AssertionError(f"caar ring {name} {mode}: not the "
                                         f"two launches' bits: {same}")
                line[f"{mode}_bitwise"] = "all" if swept else "no sweep"
                del got
                line[f"{mode}_graph_ms"] = graph_ms(run, 20)
                line[f"{mode}_ms"] = cuda_ms(run, 20)
            print(json.dumps(line), flush=True)
            _build.library, ring_fused.ring_plan = port_library, port_plan
    finally:
        _build.library, ring_fused.ring_plan = port_library, port_plan


def banded(dev, card):
    from tinman_sandbox_tpu_torch.dist import (
        LocalMesh, build_cubed_sphere, make_structured_plan, rsp_lanes_2f,
        shard_packed_t4)
    from tinman_sandbox_tpu_torch.dist.banded_t4 import (_band_shard,
                                                         _banded_tables,
                                                         band_extend)
    from tinman_sandbox_tpu_torch.dist.sharded_t4 import PLAIN
    from tinman_sandbox_tpu_torch.kernels.dss import (
        dss_extract_cuda, dss_fixup_cuda, dss_sweep_banded_cuda,
        dss_sweep_banded_nomerge_cuda, dss_sweep_cuda, fix_tables)

    lib, _ = _compile("banded_variants")
    so = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.banded_lane_launch.argtypes = [P, P, I, P, I, P, P, P, F, F, P, I, I,
                                      I, I, I, P]
    gen = torch.Generator(device=dev).manual_seed(18)

    def lane(x_ext, r, vd, bt):
        out = x_ext.new_empty(x_ext.shape[0], bt.nchunks * bt.bl)
        err = so.banded_lane_launch(
            x_ext.data_ptr(), r.data_ptr(), r.shape[0],
            0 if vd is None else vd.data_ptr(), bt.fix.nfix,
            bt.fix.fix_col.data_ptr(), bt.flags.data_ptr(), None, 0.0, 0.0,
            out.data_ptr(), x_ext.shape[0], bt.nchunks * bt.bl, bt.bl,
            bt.nchunks, bt.fix.ne, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"banded lane launch failed: {err}")
        return out

    for ne, m, N, heights in ((30, 2, 12, (288, 2520)), (32, 4, 6, (288,))):
        grid = build_cubed_sphere(ne, dtype=torch.float32, device=dev)
        e16 = grid.nelem * 16
        plan = make_structured_plan(grid.gdof, ne)
        rsp = torch.from_numpy(rsp_lanes_2f(grid.geometry.spheremp, grid.gdof,
                                            grid.ndof)).to(dev)
        mesh = LocalMesh(N, dev)
        T = _banded_tables(plan, m, N)
        bts = [_band_shard(plan, m, N, s, str(dev)).band for s in range(N)]
        (rsps,) = shard_packed_t4(mesh, rsp)
        fix = fix_tables(plan, dev)
        for rk in heights:
            x = torch.randn(rk, e16, generator=gen, device=dev)
            xe = band_extend(mesh, plan, m, shard_packed_t4(mesh, x)[0])
            vds = [torch.randn(rk, bt.fix.nfix, generator=gen, device=dev)
                   for bt in bts]
            for s, bt in enumerate(bts):
                for vd in (vds[s], None):
                    port = (dss_sweep_banded_cuda(xe[s], rsps[s], vd, bt)
                            if vd is not None else
                            dss_sweep_banded_nomerge_cuda(xe[s], rsps[s], bt))
                    if not torch.equal(port, lane(xe[s], rsps[s], vd, bt)):
                        raise AssertionError(f"banded ne{ne} shard {s}: the "
                                             "two designs differ")
            want = PLAIN.banded(xe[0], rsps[0], vds[0], bts[0])
            if not torch.equal(dss_sweep_banded_cuda(xe[0], rsps[0], vds[0],
                                                     bts[0]), want):
                raise AssertionError(f"banded ne{ne}: port differs from plain")
            vd1 = dss_fixup_cuda(dss_extract_cuda(x, fix), fix, rsp)
            reps = 10 if rk > 1000 else 30
            args = list(zip(xe, rsps, vds, bts))
            line = dict(card=card, kernel="dss_sweep_banded", ne=ne, m=m,
                        N=N, rows=rk, bitwise="port = lane design = plain",
                        port_graph_ms=graph_ms(lambda: [
                            dss_sweep_banded_cuda(*a) for a in args], reps),
                        port_nomerge_graph_ms=graph_ms(lambda: [
                            dss_sweep_banded_nomerge_cuda(a[0], a[1], a[3])
                            for a in args], reps),
                        lane_graph_ms=graph_ms(lambda: [
                            lane(*a) for a in args], reps),
                        lane_nomerge_graph_ms=graph_ms(lambda: [
                            lane(a[0], a[1], None, a[3]) for a in args],
                            reps),
                        one_shard_port_graph_ms=graph_ms(
                            lambda: dss_sweep_banded_cuda(*args[0]), reps),
                        single_device_sweep_graph_ms=graph_ms(
                            lambda: dss_sweep_cuda(x, rsp, vd1, fix), reps))
            print(json.dumps(line), flush=True)
            del x, xe, vds, vd1, args
            torch.cuda.empty_cache()


# builds of csrc/tracer.cu for the tracer ring kernel: (name, nvcc flags),
# the port's first (float4 sweep through L1 with a row of loads in flight, s1
# evict-last and w evict-first in L2, s1 discarded by its last reader,
# registers capped for 5 blocks an SM); then one or two parts changed: the
# reads through L2 alone (TRACER_RING_L1), the discard (TRACER_RING_DISCARD),
# the hints (TRACER_RING_KEEP), the rows in flight (TRACER_RING_UNROLL), the
# register cap (TRACER_RING_BLOCKS), the sweep (TRACER_RING_SWEEP: 0 none
# and no wait, the producer alone; 3 the wait alone; 2 a lane a thread
# through L2, the design before's sweep). The builds of TRACER_RING_LAGGED
# run at each lag of TRACER_RING_LAGS, the others at the port's.
_TPLAIN = ["-DTRACER_RING_KEEP=0", "-DTRACER_RING_DISCARD=0"]
TRACER_RING_BUILDS = (
    ("port", []),
    ("l2_reads", ["-DTRACER_RING_L1=0"]),
    ("no_discard", ["-DTRACER_RING_DISCARD=0"]),
    ("no_discard_no_hint", _TPLAIN),
    ("unroll2", ["-DTRACER_RING_UNROLL=2"]),
    ("unroll4", ["-DTRACER_RING_UNROLL=4"]),
    ("uncapped", ["-DTRACER_RING_BLOCKS=0"]),
    ("blocks6", ["-DTRACER_RING_BLOCKS=6"]),
    ("producer", ["-DTRACER_RING_SWEEP=0", *_TPLAIN]),
    ("producer_hint", ["-DTRACER_RING_SWEEP=0", "-DTRACER_RING_DISCARD=0"]),
    ("producer_wait", ["-DTRACER_RING_SWEEP=3", *_TPLAIN]),
    ("lane_sweep", ["-DTRACER_RING_SWEEP=2", *_TPLAIN]))
TRACER_RING_LAGS = (0, 16, 48, 128, 256)
TRACER_RING_LAGGED = ("port", "no_discard_no_hint", "producer_wait")
# item sizes (ring_fused.TRACER_RING_ITEM_ROWS: the rows chunks of every
# tracer are grouped up to, the rows a chunk of every tracer is split over
# tracer groups above) the port's build also runs at: (8, 8) a chunk of one
# tracer; (8, 1000) a chunk of every tracer (the first design's items);
# others between
TRACER_RING_ROWS = ((8, 8), (8, 1000), (16, 72), (48, 72), (72, 72),
                    (24, 48), (24, 144))


def tracer_ring(dev, card, fix, rsp):
    from chip_smoke import DYN_DT, QSIZE_TALL
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build, ring_fused
    from tinman_sandbox_tpu_torch.kernels.dss import dss_sweep_nomerge_cuda
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    const, ps0, q_tall, _, _, _ = bench.make_prim_problem(
        30, 72, dev, DYN_DT, QSIZE_TALL)
    meta, dvv = const[1], const[3]
    k = 72
    ca, cb = float(np.float32(1 / 3)), float(np.float32(2 / 3))
    kw = dict(wind_rows=(0, 1))
    cases = {}
    for qsize in (1, QSIZE_TALL):
        q = q_tall[:qsize * k].contiguous()
        mx = torch.rand(q.shape, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        reps = 30 if qsize == 1 else 5
        for mixed in (False, True):
            mix = (mx, ca, cb) if mixed else None
            e, slab = tracer_euler_cuda(meta, ps0, ps0, q, dvv, DYN_DT, k,
                                        fix=fix, **kw)
            cases[(qsize, mixed)] = (q, mix, reps, dss_sweep_nomerge_cuda(
                e, rsp, fix, mix), slab)
            euler = lambda: tracer_euler_cuda(meta, ps0, ps0, q, dvv, DYN_DT,
                                              k, fix=fix, **kw)
            sweep = lambda: dss_sweep_nomerge_cuda(e, rsp, fix, mix)
            two = lambda: dss_sweep_nomerge_cuda(euler()[0], rsp, fix, mix)
            print(json.dumps(dict(
                card=card, kernel="tracer_ring_reference", qsize=qsize,
                mix=mixed, two_launch_graph_ms=graph_ms(two, reps),
                two_launch_ms=cuda_ms(two, reps),
                euler_graph_ms=graph_ms(euler, reps),
                sweep_graph_ms=graph_ms(sweep, reps))), flush=True)
            del e
    libs = _caar_libraries(TRACER_RING_BUILDS, "ring", "tracer_ring_kernel",
                           source="tracer")
    port_library, port_plan = _build.library, ring_fused.tracer_ring_plan
    port_rows = ring_fused.TRACER_RING_ITEM_ROWS
    runs = [(name, lag, port_rows) for name, _ in TRACER_RING_BUILDS
            for lag in (TRACER_RING_LAGS if name in TRACER_RING_LAGGED
                        else (ring_fused.TRACER_RING_LAG,))]
    runs += [("port", ring_fused.TRACER_RING_LAG, rows)
             for rows in TRACER_RING_ROWS]
    try:
        for name, lag, rows in runs:
            so, regs = libs[name]
            _build.library = (lambda n, so=so: so if n == "tracer"
                              else port_library(n))
            ring_fused.tracer_ring_plan = (
                lambda ncol, nl, ne, qs=1, g=lag: port_plan(ncol, nl, ne, qs,
                                                            lag=g))
            ring_fused.TRACER_RING_ITEM_ROWS = rows
            line = dict(card=card, kernel="tracer_ring", build=name, lag=lag,
                        item_rows=rows, registers=regs,
                        blocks_per_sm=so.tracer_blocks_per_sm(1, dev.index))
            swept = "producer" not in name
            for (qsize, mixed), (q, mix, reps, w, slab) in cases.items():
                tag = f"q{qsize}{'_mix' if mixed else ''}"
                run = lambda: ring_fused.tracer_ring_packed_t(
                    meta, ps0, ps0, q, dvv, DYN_DT, k, rsp, fix, mix=mix,
                    **kw)
                got = run()
                torch.cuda.synchronize()
                if not (torch.equal(got[1], slab)
                        and (not swept or torch.equal(got[0], w))):
                    raise AssertionError(f"tracer ring {name} lag {lag} "
                                         f"{tag}: not the two launches' bits")
                p = ring_fused.tracer_ring_plan(q.shape[1], k, fix.ne,
                                                q.shape[0] // k)
                line[f"{tag}_item"] = [p.group, p.tracers, p.items]
                line[f"{tag}_bitwise"] = "all" if swept else "slab"
                line[f"{tag}_graph_ms"] = graph_ms(run, reps)
                line[f"{tag}_ms"] = cuda_ms(run, reps)
                del got
            print(json.dumps(line), flush=True)
            _build.library = port_library
            ring_fused.tracer_ring_plan = port_plan
            ring_fused.TRACER_RING_ITEM_ROWS = port_rows
    finally:
        _build.library, ring_fused.tracer_ring_plan = port_library, port_plan
        ring_fused.TRACER_RING_ITEM_ROWS = port_rows


# the t-layout rsplit=0 kernel's plans: (stash, blocks an SM)
R0_PLANS = ((True, 2), (True, 3), (False, 2))


def rsplit0(dev, card):
    import dataclasses
    import importlib

    from chip_smoke import (ptxas_report, r0_cases, row_modes, run_mode,
                            same_as_row_r0, scaled_err)
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build
    from tinman_sandbox_tpu_torch.kernels.caar_t import caar_t4_cuda

    caar_t = importlib.import_module("tinman_sandbox_tpu_torch.kernels.caar_t")
    _build.library("caar")
    print(json.dumps(dict(card=card, kernel="caar_r0", registers=dict(
        ptxas_report("caar", "caar_r0_kernel")))), flush=True)
    modes = row_modes()
    t_mode, row_mode = modes["caar_packed_rsplit0_t"], \
        modes["caar_packed_rsplit0"]
    port_plan = caar_t.caar_plan
    problems = (("1024x72", lambda: bench.make_problem(1024, 72, dev,
                                                       seed=7)),
                ("ne30x72", lambda: _assembled_const(dev)),
                ("1024x400", lambda: bench.make_problem(1024, 400, dev,
                                                        seed=7)))
    try:
        for tag, make in problems:
            const, acc = make()
            targs = dict(r0_cases(const, acc))["bench"]
            nlev, ncol = targs[3].shape
            _, _, want64 = run_mode(t_mode, targs)
            rargs = row_mode[2](targs)
            racc = [x.clone() for x in rargs[-5:-1]]
            row_ms = graph_ms(lambda: row_mode[0](*rargs[:-5], *racc,
                                                  rargs[-1]), 10)
            tacc = [x.clone() for x in targs[13:16]]
            s0, sm1 = torch.cat(targs[3:7]), torch.cat(targs[7:11])
            pair_ms = graph_ms(lambda: caar_t4_cuda(
                targs[0], targs[2], s0, sm1, targs[11], targs[12], *tacc,
                targs[17]), 10)
            port = port_plan(ncol, nlev, r0=True)
            for stash, blocks in R0_PLANS:
                if stash and not caar_t.caar_plan(ncol, nlev).stash:
                    continue
                plan = dataclasses.replace(
                    port, stash=stash,
                    cap=caar_t.CHUNK_REGS if blocks == 3 else 0)
                if plan.blocks_per_sm != blocks:
                    continue        # three do not fit
                caar_t.caar_plan = lambda ncol, nl, r0=False, p=plan: p
                kacc = [x.clone() for x in targs[13:17]]
                run = lambda: t_mode[0](*targs[:13], *kacc, targs[17])
                got = run()
                torch.cuda.synchronize()
                e64 = max(scaled_err(g, w) for g, w in zip(got, want64))
                if e64 > CAAR_TOL or not same_as_row_r0(got, targs):
                    raise AssertionError(f"caar r0 {plan} {tag}: {e64} or "
                                         "not the row kernel's bits")
                del got
                print(json.dumps(dict(
                    card=card, kernel="caar_packed_rsplit0_t", shape=tag,
                    stash=stash, blocks_per_sm=blocks,
                    port_plan=(port.stash, port.blocks_per_sm) == (stash,
                                                                   blocks),
                    waves=plan.waves, max_scaled_err_f64=e64,
                    bitwise_row_rsplit0="yes", graph_ms=graph_ms(run, 10),
                    ms=cuda_ms(run, 10), row_rsplit0_graph_ms=row_ms,
                    t_pair_graph_ms=pair_ms)), flush=True)
                caar_t.caar_plan = port_plan
            del const, acc, targs, want64, rargs, racc
            torch.cuda.empty_cache()
    finally:
        caar_t.caar_plan = port_plan


# builds of csrc/caar.cu for the row kernel's bf16 staging: (name, nvcc
# flags), the port's first
STORAGE_BUILDS = (("port", []), ("sync", ["-DCAAR_ROW_SYNC_AUX=1"]),
                  ("epi_load", ["-DCAAR_ROW_EPI_RAW=0"]),
                  ("qdp_dp", ["-DCAAR_ROW_RAW_EARLY=1"]),
                  ("raw_dp", ["-DCAAR_ROW_RAW_EARLY=2"]))


def storage(dev, card):
    from chip_smoke import (STORAGE_MODES, r0_cases, row_modes, storage_args,
                            upcast)
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels import _build

    libs = _caar_libraries(STORAGE_BUILDS, "storage", "caar_row_kernel")
    for name, (_, regs) in libs.items():
        print(json.dumps(dict(card=card, kernel="caar_row", build=name,
                              registers=regs)),
              flush=True)
    modes = {n: m for n, m in row_modes().items()
             if n != "caar_packed_rsplit0_t"}
    port_library = _build.library
    problems = (("1024x72", lambda: bench.make_problem(1024, 72, dev,
                                                       seed=7)),
                ("ne30x72", lambda: _assembled_const(dev)))
    try:
        for tag, make in problems:
            const, acc = make()
            targs = dict(r0_cases(const, acc))["bench"]
            for mode, (kern, _, conv, names) in modes.items():
                nacc = 4 if len(names) == 9 else 3
                for st in ("f32", *STORAGE_MODES):
                    args = conv(storage_args(targs, st))
                    first = None
                    for name, (so, _) in libs.items():
                        _build.library = (lambda n, so=so: so if n == "caar"
                                          else port_library(n))
                        run = lambda a: kern(*a[:-1 - nacc], *(
                            x.clone() for x in a[-1 - nacc:-1]), a[-1])
                        got = run(args)
                        up = run(upcast(args))
                        torch.cuda.synchronize()
                        first = first or tuple(g.clone() for g in got)
                        bits = all(torch.equal(g, f)
                                   for g, f in zip(got, first))
                        bits_up = all(torch.equal(g, u)
                                      for g, u in zip(got, up))
                        if not (bits and bits_up):
                            raise AssertionError(
                                f"storage {name} {mode} {tag} {st}: port "
                                f"bits {bits}, upcast bits {bits_up}")
                        kacc = [x.clone() for x in args[-1 - nacc:-1]]
                        print(json.dumps(dict(
                            card=card, kernel=mode, build=name, shape=tag,
                            storage=st, bitwise_port_build=bits,
                            bitwise_f32_on_upcast=bits_up,
                            graph_ms=graph_ms(lambda: kern(
                                *args[:-1 - nacc], *kacc, args[-1]), 20))),
                            flush=True)
                        del got, up
                    _build.library = port_library
            del const, acc, targs
            torch.cuda.empty_cache()
    finally:
        _build.library = port_library


# builds of csrc/tracer.cu for the row kernel (group row_tracer): (name, nvcc
# flags), the port's first (float4 columns in blocks of 32 quads capped at
# 128 registers for 4 blocks an SM, narrower columns in blocks of 64, the
# next tracer's q loaded before this one's arithmetic): uncapped
# (TRACER_ROW_MIN_BLOCKS=1; 158 registers, 3 blocks an SM), capped for 5
# (96 registers and spills), the next q loaded after the store
# (TRACER_ROW_AHEAD=0), 64 quads a block with float4 columns and 32 with
# scalar ones (TRACER_ROW_QUADS, _NARROW)
ROW_TRACER_BUILDS = (("port", []), ("uncapped", ["-DTRACER_ROW_MIN_BLOCKS=1"]),
                     ("min5", ["-DTRACER_ROW_MIN_BLOCKS=5"]),
                     ("ahead0", ["-DTRACER_ROW_AHEAD=0"]),
                     ("quads64", ["-DTRACER_ROW_QUADS=64"]),
                     ("narrow32", ["-DTRACER_ROW_QUADS_NARROW=32"]))
# the tracers a block walks at qsize 35 (the port's plan: 4)
ROW_TRACER_CHUNKS = (35, 9, 7, 5, 4, 1)
# (nlev, qsize) of the cases at ne30; nlev 26 runs scalar columns
ROW_TRACER_CASES = ((72, 1), (72, 35), (26, 35))
# cudaOccupancy's kind (tracer_blocks_per_sm) of each column width
ROW_TRACER_KIND = {4: 7, 1: 8}


def row_tracer(dev, card):
    """The row-layout tracer Euler kernel (``euler_packed``) at ne30 x 72,
    qsize 1 and 35, and at ne30 x 26 (scalar columns), qsize 35: the
    port
    through its wrapper as the main path calls it; ``csrc/tracer.cu`` built
    as the port builds it and with ROW_TRACER_BUILDS' flags, each with every
    tracers-a-block of ROW_TRACER_CHUNKS (launched directly); the kernel
    before the redesign (``row_tracer_variants.cu``, the control); the t
    form (``tracer_euler_cuda`` without spheremp) on the transposed problem.
    Each held per tracer block within 5e-5 of ``euler_packed_plain`` at a
    long dt, whether it is bit for bit the t form printed; timed from CUDA
    graphs at the run's dt with the bound (inputs once, outputs once),
    ptxas's registers and cudaOccupancy's blocks an SM."""
    from chip_smoke import (DYN_DT, TRACER_ROW_OPS_PER_POINT, bound_ms,
                            scaled_err)
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.constants import CONSTANTS
    from tinman_sandbox_tpu_torch.kernels.tracer import (
        euler_packed, euler_packed_plain, row_tracer_plan)
    from tinman_sandbox_tpu_torch.kernels.tracer_t import tracer_euler_cuda

    lib, report = _compile("row_tracer_variants")
    old = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.row_tracer_old_launch.argtypes = [P] * 6 + [I] * 3 + [F, F, P]
    old_regs = _tracer_regs(report, "tracer_row_kernel_old")
    libs = _caar_libraries(ROW_TRACER_BUILDS, "row_tracer",
                           "tracer_row_kernel", source="tracer")
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    for nlev, qsize in ROW_TRACER_CASES:
        (scal, meta_t, _, dvv), s0, _, _, _, _ = bench.make_prim_problem(
            30, nlev, dev, DYN_DT, 1)
        meta = meta_t.T.contiguous()
        vu, vv = s0[:nlev].T.contiguous(), s0[nlev:2 * nlev].T.contiguous()
        qt = bench.make_prim_problem(30, nlev, dev, DYN_DT, qsize)[2]
        q = qt.T.contiguous()
        ncol = q.shape[0]
        div = q - euler_packed_plain(meta, vu, vv, q, dvv, 1.0, nlev)
        dt_long = 0.5 * float(q.abs().max()) / float(div.abs().max())
        del div
        want = euler_packed_plain(meta, vu, vv, q, dvv, dt_long, nlev)
        t_of = lambda dt: tracer_euler_cuda(meta_t, s0, s0, qt, dvv, dt,
                                            nlev, fold_sph=False,
                                            wind_rows=(0, 1))
        t_long = t_of(dt_long).T.contiguous()
        nbytes = (2 * qsize * nlev + 2 * nlev + 6) * ncol * 4 + 16 * 4
        bnd, by = bound_ms(nbytes, TRACER_ROW_OPS_PER_POINT * qsize * nlev
                           * ncol)
        out = torch.empty_like(q)
        plan = row_tracer_plan(nlev, qsize, ncol)
        reps = 30 if qsize == 1 else 5
        case = f"ne30x{nlev}_q{qsize}"

        def check(name, got):
            torch.cuda.synchronize()
            err = max(scaled_err(a, b) for a, b in zip(got.split(nlev, 1),
                                                       want.split(nlev, 1)))
            if not err <= 5e-5:
                raise AssertionError(f"row_tracer {name} {case}: {err} > "
                                     "5e-5")
            return err, bool(torch.equal(got, t_long))

        def emit(kind, err, same, ms, **info):
            print(json.dumps(dict(
                card=card, kernel="tracer_row", kind=kind, case=case,
                max_scaled_err=err, bitwise_t_form=same, graph_ms=ms,
                bound_ms=bnd, bound_by=by, bound_share=bnd / ms, **info)),
                flush=True)

        got = euler_packed(meta, vu, vv, q, dvv, dt_long, nlev)
        err, same = check("port", got)
        emit("port_wrapper", err, same, graph_ms(
            lambda: euler_packed(meta, vu, vv, q, dvv, DYN_DT, nlev), reps),
            plan=plan._asdict())
        err, same = check("t_form", t_long)
        emit("t_form", err, same, graph_ms(lambda: t_of(DYN_DT), reps))

        def run_old(dt):
            e = old.row_tracer_old_launch(
                meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(),
                vv.data_ptr(), q.data_ptr(), out.data_ptr(), nlev,
                q.shape[1], ncol, dt, CONSTANTS.rrearth, stream())
            if e:
                raise RuntimeError(f"row tracer old: error {e}")
            return out
        err, same = check("old", run_old(dt_long).clone())
        emit("old", err, same, graph_ms(lambda: run_old(DYN_DT), reps),
             registers=old_regs,
             blocks_per_sm=old.row_tracer_old_blocks_per_sm())
        chunks = (1,) if qsize == 1 else ROW_TRACER_CHUNKS
        for (name, (so, regs)), tracers in itertools.product(libs.items(),
                                                             chunks):
            def run(dt):
                e = so.tracer_row_launch(
                    meta.data_ptr(), dvv.data_ptr(), vu.data_ptr(),
                    vv.data_ptr(), q.data_ptr(), out.data_ptr(), nlev, qsize,
                    ncol, plan.vec, tracers, dt, CONSTANTS.rrearth, stream(),
                    dev.index)
                if e:
                    raise RuntimeError(f"row tracer {name}: error {e}")
                return out
            err, same = check(name, run(dt_long).clone())
            emit(name, err, same, graph_ms(lambda: run(DYN_DT), reps),
                 vec=plan.vec, tracers=tracers,
                 registers=_short_regs(regs, "tracer_row_kernel"),
                 blocks_per_sm=so.tracer_blocks_per_sm(
                     ROW_TRACER_KIND[plan.vec], dev.index))
        del q, qt, out, want, t_long, s0, meta, meta_t, vu, vv
        torch.cuda.empty_cache()


# the extract's variants in extract_variants.cu: (index, name)
EXTRACT_VARIANTS = ((0, "old_32x32"), (7, "fixed_32x32"), (1, "rows64"),
                    (2, "threads128"), (3, "l2_only"), (4, "one_wave"),
                    (5, "rows128"), (6, "one_wave_rows64"))
EXTRACT_ROWS = (72, 288, 2520)
# L2 fetch granularities (bytes) the port and the kernel before are timed
# under, after the context's default
EXTRACT_FETCH = (32, 64, 128)


def extracts(dev, card, fix):
    """The DSS extract (``dss_extract_cuda``) on ne30 at 72, 288 and 2,520
    rows and on ne120 at 288: the port through its wrapper, the variants of
    ``extract_variants.cu`` (the kernel before its redesign the control) and
    the library call ``x[:, lanes].T.contiguous()``, each bit for bit
    ``dss_extract_plain`` and timed from CUDA graphs beside the byte bound
    and the sector floor (``chip_smoke.extract_floor_ms``) and the same
    floor counted in 64-byte granules. Then the port and the kernel before
    under each L2 fetch granularity of EXTRACT_FETCH (the context's
    ``cudaLimitMaxL2FetchGranularity``, set for the run and put back)."""
    from chip_smoke import HBM_BYTES_PER_S, bound_ms, extract_floor_ms
    from tinman_sandbox_tpu_torch.dist import (build_cubed_sphere,
                                               make_structured_plan)
    from tinman_sandbox_tpu_torch.kernels.dss import (dss_extract_cuda,
                                                      dss_extract_plain,
                                                      fix_tables)

    lib, _ = _compile("extract_variants")
    so = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    so.extract_variant_launch.argtypes = [I, P, P, P, I, I, I, P]
    so.extract_l2_fetch.argtypes = [I]
    cs120 = build_cubed_sphere(120, dtype=torch.float32, device=dev)
    fix120 = fix_tables(make_structured_plan(cs120.gdof, 120), dev)
    del cs120
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(f"ne30_{rows}", fix, rows) for rows in EXTRACT_ROWS]
    cases.append(("ne120_288", fix120, 288))
    for case, t, rows in cases:
        x = torch.randn(rows, t.e16, generator=gen, device=dev)
        n = t.nfix
        slab = torch.empty(n, rows, device=dev)
        want = dss_extract_plain(x, t)
        lanes = t.read_lanes.long()
        bnd = bound_ms(2 * n * rows * 4 + n * 4, 0)[0]
        floor = extract_floor_ms(t.read_lanes, rows, t.e16)
        granules = torch.unique(lanes // 16).numel()
        floor64 = (rows * (granules * 64 + n * 4) + n * 4) / HBM_BYTES_PER_S \
            * 1e3
        reps = 100 if rows < 1000 else 30

        def launcher(v):
            def run():
                e = so.extract_variant_launch(
                    v, x.data_ptr(), t.read_lanes.data_ptr(),
                    slab.data_ptr(), n, rows, t.e16,
                    torch.cuda.current_stream(dev).cuda_stream)
                if e:
                    raise RuntimeError(f"extract variant {v}: error {e}")
                return slab
            return run

        runs = [("port", lambda: dss_extract_cuda(x, t)),
                ("library", lambda: x[:, lanes].T.contiguous())]
        runs += [(name, launcher(v)) for v, name in EXTRACT_VARIANTS]
        default = so.extract_l2_fetch(0)
        fetches = [(None, runs)] + [(b, runs[:1] + runs[2:3])
                                    for b in EXTRACT_FETCH]
        try:
            for fetch, group in fetches:
                got_fetch = default if fetch is None else \
                    so.extract_l2_fetch(fetch)
                for name, run in group:
                    got = run()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"extract {name} {case}: not "
                                             "bit for bit")
                    ms = graph_ms(run, reps)
                    print(json.dumps(dict(
                        card=card, kernel="dss_extract", kind=name,
                        case=case, nfix=n, rows=rows, l2_fetch=got_fetch,
                        bitwise=True, graph_ms=ms, bound_ms=bnd,
                        sector_floor_ms=floor, floor64_ms=floor64,
                        bound_share=bnd / ms, floor_share=floor / ms,
                        floor64_share=floor64 / ms)), flush=True)
        finally:
            so.extract_l2_fetch(default)
        del x, slab, want
        torch.cuda.empty_cache()


def _assembled_const(dev):
    """The ne30 x 72 assembled bench problem in ``bench.make_problem``'s
    form: (const, acc)."""
    from tinman_sandbox_tpu_torch import bench

    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, _, _ = \
        bench.make_assembled_problem(30, 72, dev)
    return (scal, meta, s0, sm1, qdp, pecnd, dvv), acc


def main(argv=None) -> int:
    every = ["sweep", "caar", "fixup", "remap", "tracer", "row", "ring",
             "banded", "tracer_ring", "rsplit0", "storage", "tracer_bf16",
             "row_tracer", "extract"]
    extra = ["remap_parent"]
    groups = (argv if argv is not None else sys.argv[1:]) or every
    if set(groups) - set(every) - set(extra):
        raise SystemExit(f"kernel_variants: unknown group in {groups}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants: needs a CUDA card")
    from tinman_sandbox_tpu_torch import bench
    from tinman_sandbox_tpu_torch.kernels.dss import fix_tables

    dev = torch.device("cuda", 0)
    card = card_line()
    (scal, meta, qdp, pecnd, dvv), (s0, sm1), acc, plan, rsp = \
        bench.make_assembled_problem(30, 72, dev)
    fix = fix_tables(plan, dev)
    if "sweep" in groups:
        sweeps(dev, card, fix, rsp)
    if "caar" in groups:
        caars(dev, card, fix,
              ((scal, meta, qdp, pecnd, dvv), (s0, sm1), acc),
              bench.make_problem(1024, 72, dev, seed=7))
    if "fixup" in groups:
        fixups(dev, card, fix, rsp)
    if "remap" in groups:
        remaps(dev, card)
    if "remap_parent" in groups:
        remaps(dev, card, ("parent",))
    if "tracer" in groups:
        tracers(dev, card)
    if "row" in groups:
        rows(dev, card)
    if "ring" in groups:
        ring(dev, card, fix, ((scal, meta, qdp, pecnd, dvv), (s0, sm1), acc),
             rsp)
    if "banded" in groups:
        banded(dev, card)
    if "tracer_ring" in groups:
        tracer_ring(dev, card, fix, rsp)
    if "rsplit0" in groups:
        rsplit0(dev, card)
    if "storage" in groups:
        storage(dev, card)
    if "tracer_bf16" in groups:
        tracer_bf16(dev, card)
    if "row_tracer" in groups:
        row_tracer(dev, card)
    if "extract" in groups:
        extracts(dev, card, fix)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
