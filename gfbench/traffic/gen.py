"""Generation traffic: one receptor conformation after another, from host
coordinates to the configuration's fused table on the card (ensemble
docking over receptor snapshots). MD is bypassed.

Set-up builds the complex from the seed and runs the mix's warm-up
receptors, which build and load every kernel a conformation uses. Each
conformation of the window is the receptor with every atom displaced by a
Gaussian drawn from the seed and the conformation's index; its three grids
are generated and packed into one table, and the conformation ends when
the card has finished.

The check reads the tables of the window's first and last conformations
at points sampled in the box and compares their values and gradients with
the plain reference's grids of the same conformations.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gfbench import complex as cx
from gfbench import program, seeds
from gfbench.reference.follow import (grid_gaps, reference_at_points,
                                      table_at_points)


class Session:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.kept = {}
        self.window = None
        self.traced = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _coords(self, index):
        """Receptor coordinates [A, 3] of conformation ``index`` (warm-up
        conformations are negative)."""
        rng = np.random.default_rng(seeds.derive(self.seed, "conformation",
                                                 index))
        rec = self.receptor.coords
        return rec + self.mix["displacement_sd_nm"] * rng.standard_normal(
            rec.shape)

    def _receptor(self, index):
        grids = program.generate(self.config, self.box, self._coords(index),
                                 self.receptor, self.device)
        return program.pack(grids)

    def setup(self):
        g = self.config["grids"]
        self.ligand, self.receptor = cx.from_config(self.config, self.seed)
        counts = tuple(g["counts"])
        self.box = (counts, cx.grid_box(self.ligand.coords, counts,
                                        g["spacing_nm"]),
                    (g["spacing_nm"],) * 3)
        for k in range(self.mix["warmup_receptors"]):
            self._receptor(-1 - k)
        self._sync()

    def run_window(self, seconds):
        durations, index = [], 0
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            table = self._receptor(index)
            self._sync()
            durations.append(time.perf_counter() - t1)
            if index == 0:
                self.kept["first"] = (index, table)
            self.kept["last"] = (index, table)
            del table
            index += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.window = {"seconds": wall, "items": index, "failed": 0,
                       "durations": durations, "units": index}

    def run_traced(self, spans, window):
        """The mix's traced conformations, after the window and inside
        ``window``, with a synchronised span around generation and one
        around packing."""
        first = self.window["items"]
        with window:
            for k in range(self.mix["trace_receptors"]):
                with spans("generate", sync=True):
                    grids = program.generate(self.config, self.box,
                                             self._coords(first + k),
                                             self.receptor, self.device)
                with spans("pack", sync=True):
                    program.pack(grids)
                del grids
        g = self.config["grids"]
        self.traced = {"receptors": self.mix["trace_receptors"],
                       "counts": self.box[0], "grid_types": g["types"],
                       "receptor_atoms": self.receptor.natom}

    def release(self):
        """Nothing of the program's is left but the tables the check
        reads."""

    def _points(self):
        counts, origin, spacing = self.box
        rng = np.random.default_rng(seeds.derive(self.seed, "points", 0))
        u = rng.random((self.mix["check_points"], 3))
        extent = np.asarray(spacing) * (np.asarray(counts) - 1)
        return torch.as_tensor(np.asarray(origin) + u * extent,
                               dtype=torch.float64, device=self.device)

    def readings(self, control=None):
        """The numbers compared: the widest gap of a grid's value and of
        its gradient at the sampled points, each measured against that
        grid's widest reference value or gradient there, over the checked
        conformations, between the program's table (or, with ``control``,
        the control's own interpolation) and the float64 reference."""
        from gfbench.reference.precision import Arith

        g = self.config["grids"]
        kind = "values" if g["method"] == "bspline" else "derivatives"
        points = self._points()
        rec = self.receptor
        gaps = []
        for label in self.mix["check_receptors"]:
            index, table = self.kept[label]
            receptor = (self._coords(index), rec.charges, rec.sigmas,
                        rec.epsilons)
            want = reference_at_points(kind, points, self.box, g["types"],
                                       receptor, g["cap"], Arith("float64"))
            if control is None:
                got = table_at_points(table, points, self.box)
            else:
                got = reference_at_points(kind, points, self.box,
                                          g["types"], receptor, g["cap"],
                                          Arith(control))
            gaps.append(grid_gaps(got, want))
        return {"value_gap": max(x[0] for x in gaps),
                "gradient_gap": max(x[1] for x in gaps)}
