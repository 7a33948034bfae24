"""The plain reference the benchmark judges the program against.

Plain PyTorch and NumPy. It imports neither ``jax`` nor the JAX package
nor anything of the program (``openmmgridforce_tpu_torch``), and takes
nothing the program made: from the complex and the window's inputs
(starting states, noise, receptor conformations) it works out again the
grids, their interpolation, the ligand's force field and the Langevin
update. It reads the program's outputs (states, packed tables) only to
judge them.
"""
