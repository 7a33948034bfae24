"""Physical constants and unit conventions (a copy of the JAX package's).

OpenMM-style MD units throughout: length nm, energy kJ/mol, charge e,
mass amu, time ps, temperature K.
"""

# kJ*nm/(mol*e^2)  (1/(4*pi*eps0) in MD units)
COULOMB_CONST = 138.935456

# Boltzmann constant in kJ/(mol*K)
BOLTZ = 0.00831446261815324

# Default grid value cap U_max in kJ/mol
DEFAULT_GRID_CAP = 41840.0

# Default out-of-bounds harmonic restraint k in kJ/mol/nm^2
DEFAULT_OOB_K = 10000.0

# 2^(1/6): Rmin = 2^(1/6) * sigma (AMBER convention)
TWO_POW_ONE_SIXTH = 2.0 ** (1.0 / 6.0)

# kcal/mol -> kJ/mol
KCAL_TO_KJ = 4.184

# Angstrom -> nm
ANGSTROM_TO_NM = 0.1
