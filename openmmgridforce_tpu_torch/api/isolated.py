"""Stateful ``IsolatedNonbondedForce`` mirroring the reference API
(openmmapi/include/IsolatedNonbondedForce.h:47-202): a template ligand's
all-pairs Coulomb+LJ interactions with exclusions and 1-4 exceptions,
mapped into the System by particle indices — evaluated by the dense masked
pair term (ops/pairwise.py). The port of the JAX package's
``api/isolated.py``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops.pairwise import build_pair_table
from .gridforce import Force


class IsolatedNonbondedForce(Force):
    def __init__(self):
        super().__init__()
        self._num_atoms = 0
        self._particles: List[int] = []
        self._charges: List[float] = []
        self._sigmas: List[float] = []
        self._epsilons: List[float] = []
        self._exclusions: List[Tuple[int, int]] = []
        self._exceptions: List[Tuple[int, int, float, float, float]] = []

    def setNumAtoms(self, n):
        self._num_atoms = int(n)
        self._charges = [0.0] * n
        self._sigmas = [0.0] * n
        self._epsilons = [0.0] * n

    def getNumAtoms(self):
        return self._num_atoms

    def setParticles(self, particles):
        self._particles = [int(p) for p in particles]

    def getParticles(self):
        return list(self._particles)

    def setAtomParameters(self, index, charge, sigma, epsilon):
        self._charges[index] = float(charge)
        self._sigmas[index] = float(sigma)
        self._epsilons[index] = float(epsilon)

    def getAtomParameters(self, index):
        return (self._charges[index], self._sigmas[index],
                self._epsilons[index])

    def addExclusion(self, atom1, atom2):
        self._exclusions.append((int(atom1), int(atom2)))

    def getNumExclusions(self):
        return len(self._exclusions)

    def getExclusion(self, index):
        return self._exclusions[index]

    def addException(self, atom1, atom2, charge_prod, sigma, epsilon):
        self._exceptions.append((int(atom1), int(atom2), float(charge_prod),
                                 float(sigma), float(epsilon)))
        return len(self._exceptions) - 1

    def getNumExceptions(self):
        return len(self._exceptions)

    def getExceptionParameters(self, index):
        return self._exceptions[index]

    def updateParametersInContext(self, context):
        context._rebind_force(self)

    # --- materialization --------------------------------------------------
    def _build(self, dtype=torch.float64, device=None):
        """Returns (PairTable, particle indices [n] int64), both on
        ``device`` (the CUDA card unless ``device="cpu"``)."""
        table = build_pair_table(self._charges, self._sigmas,
                                 self._epsilons, self._exclusions,
                                 self._exceptions, dtype=dtype,
                                 device=device)
        particles = torch.as_tensor(np.asarray(
            self._particles if self._particles
            else range(self._num_atoms), dtype=np.int64),
            device=table.qq.device)
        return table, particles
