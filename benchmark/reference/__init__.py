"""The plain reference that decides ``correct``: plain PyTorch and NumPy
in field form [nelem, nlev, np, np], written from the equations of HOMME's
rsplit > 0 step. It imports nothing of the program under test and takes
nothing the program made: the grid, the projection, the step and the
remap are worked out here again from the benchmark's raw inputs.
"""
