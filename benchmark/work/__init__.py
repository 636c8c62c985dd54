"""The work one step of a layer must do, one file a layer: ``work(shape)``
returns the bytes it must read and write (each input once, each output
once, float32; intermediates such as the DSS's fix-lane slab are not
counted) and the operations it must compute, counted by hand from the
reference's arithmetic (``reference/step.py``) per point, level, tracer
and stage. ``shape`` has nelem, nlev, qsize, qsplit, rsplit, subcycle
(hyperviscosity subcycles, 0 without hyperviscosity). A derivative
contraction over the 4 points of a line counts 8 operations a point.

The byte counts split ``tinman_sandbox_tpu_torch.bench``'s
``dynamics_bytes_per_step`` and ``prim_bytes_per_step`` (frozen here) by
layer, without the slab.
"""
ROW = 4                                  # bytes an element of a row
