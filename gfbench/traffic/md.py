"""MD traffic: replicas of the ligand in closed-loop Langevin segments on
the configuration's fused grid table.

Set-up builds the complex from the seed, generates and packs the grids
(the configuration's kernel, chain rules and pack), builds the ligand's
System, draws Maxwell-Boltzmann velocities on the card and runs the warm-up
steps, which record the segment's CUDA graph. The window runs segments of
the mix's length back to back, in jobs of ``job_segments`` that each start
every replica from the ligand's pose with fresh velocities (bench.py's
1000-replica, 1000-step job); each segment draws its noise on the card
from the seed and its index, hands it to the program's runner, and ends
with the host check (the replicas' temperatures read back; a segment in
which any replica's state is not finite, or hotter than the mix's limit,
failed), as a sampler checks a segment before it decides anything.

The check follows a sample of the replicas through the window's first and
last segments with the plain reference, from the states the program
started them in and with the same noise, and measures how far the
program's states at each segment's end lie from the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gfbench import complex as cx
from gfbench import program, seeds
from gfbench.reference import fields, ligand as ref_ligand
from gfbench.reference.follow import follow, replica_gaps as state_gaps

BOLTZ = ref_ligand.BOLTZ


class Session:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.kept = {}
        self.models = {}          # the reference's, by arithmetic
        self.window = None
        self.traced = None

    # ------------------------------------------------------------------
    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _noise(self, index):
        """The noise [steps, R, N, 3] of segment ``index`` (the warm-up is
        -1), drawn on the device from the seed."""
        steps = (self.mix["warmup_steps"] if index < 0
                 else self.mix["segment_steps"])
        self.gen.manual_seed(seeds.derive(self.seed, "noise", index))
        return self.noise[:steps].normal_(generator=self.gen)

    def setup(self):
        c, g, md = self.config, self.config["grids"], self.config["md"]
        dev = self.device
        self.ligand, self.receptor = cx.from_config(c, self.seed)
        lig = self.ligand
        counts = tuple(g["counts"])
        spacing = (g["spacing_nm"],) * 3
        self.box = (counts, cx.grid_box(lig.coords, counts, g["spacing_nm"]),
                    spacing)
        grids = program.generate(c, self.box, self.receptor.coords,
                                 self.receptor, dev)
        self.table = program.pack(grids)
        del grids
        self.scaling = np.stack([fields.scalings(gt, lig.charges, lig.sigmas,
                                                 lig.epsilons)
                                 for gt in g["types"]])
        self.binding = program.binding(self.table, self.scaling, dev)
        self.system = program.system(lig, c, dev)

        R, N = self.mix["replicas"], lig.natom
        self.masses = torch.as_tensor(ref_ligand.repartitioned_masses(
            lig, md["hydrogen_mass"]), dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seeds.derive(self.seed, "velocities", 0))
        self.pose = torch.as_tensor(lig.coords, dtype=torch.float32,
                                    device=dev)
        x = self.pose.expand(R, N, 3).clone()
        self.v_sd = torch.sqrt(BOLTZ * md["temperature_K"]
                               / self.masses)[:, None]
        v = self.v_sd * torch.randn((R, N, 3), generator=self.gen, device=dev)
        steps = max(self.mix["segment_steps"], self.mix["warmup_steps"])
        self.noise = torch.empty((steps, R, N, 3), dtype=torch.float32,
                                 device=dev)
        self.temps = md["temperature_K"]
        warm = program.md_runner(self.mix["warmup_steps"], c, dev)
        self.state = warm(program.state(x, v), self.system, [self.binding],
                          self.temps, noise=self._noise(-1))
        self.run = program.md_runner(self.mix["segment_steps"], c, dev)
        self._sync()

    # ------------------------------------------------------------------
    def _segment(self, index):
        """One segment and its host check: (seconds, passed). The check
        reads every replica's temperature back (NaN where its state is not
        finite); the segment passed if every replica is finite and no
        hotter than the mix's ``fail_above_K``."""
        t0 = time.perf_counter()
        if index and index % self.mix["job_segments"] == 0:
            self._new_job(index)
        start = self.state
        end = self.run(start, self.system, [self.binding], self.temps,
                       noise=self._noise(index))
        x, v = end.positions, end.velocities
        ke = 0.5 * (self.masses[:, None] * v * v).sum((-2, -1))
        t = 2.0 * ke / (3 * x.shape[-2] * BOLTZ)
        finite = torch.isfinite(x).all((-2, -1)) & torch.isfinite(v).all(
            (-2, -1))
        host = torch.where(finite, t, torch.full_like(t, float("nan"))).cpu()
        passed = bool((host <= self.mix["fail_above_K"]).all())
        self.state = end
        self.last = (index, start, end)
        return time.perf_counter() - t0, passed

    def _new_job(self, index):
        """Every replica from the ligand's pose with fresh Maxwell-Boltzmann
        velocities drawn from the seed."""
        R = self.mix["replicas"]
        self.gen.manual_seed(seeds.derive(self.seed, "job", index))
        v = self.v_sd * torch.randn((R,) + tuple(self.pose.shape),
                                    generator=self.gen, device=self.device)
        self.state = program.state(self.pose.expand(R, -1, -1).clone(), v)

    def run_window(self, seconds):
        durations, failed, index = [], 0, 0
        t0 = time.perf_counter()
        while True:
            dt, passed = self._segment(index)
            if index == 0:
                self.kept["first"] = self.last
            durations.append(dt)
            failed += not passed
            index += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.kept["last"] = self.last
        steps = self.mix["segment_steps"]
        self.window = {"seconds": wall, "items": index, "failed": failed,
                       "durations": durations,
                       "units": index * steps * self.mix["replicas"]}

    def run_traced(self, spans, window):
        """One whole job after the window: its first segment, from the
        ligand's pose, untraced, then the mix's traced segments inside
        ``window``, keeping every traced segment's starting positions and
        the last one's end for K3's bound (replicas spread from the pose,
        where they all share their cells, as in the measured window)."""
        job = self.mix["job_segments"]
        first = -(-self.window["items"] // job) * job
        self._segment(first)
        positions = []
        with window:
            for index in range(first + 1,
                               first + 1 + self.mix["trace_segments"]):
                with spans("segment"):
                    self._segment(index)
                positions.append(self.last[1].positions)
        positions.append(self.state.positions)
        self.traced = {
            "steps": self.mix["trace_segments"] * self.mix["segment_steps"],
            "positions": positions,
            "table": {"counts": self.table.counts,
                      "origin": self.box[1], "spacing": self.box[2],
                      "degree": self.table.degree,
                      "n_grids": self.table.n_grids,
                      "itemsize": self.table.coeffs.element_size()}}

    def release(self):
        """Drop the program's state; keep the states the check reads."""
        self.table = self.binding = self.system = self.run = None
        self.state = self.noise = self.last = None

    # ------------------------------------------------------------------
    def _reference_run(self, ar, label, rows):
        g, md = self.config["grids"], self.config["md"]
        index, start, _ = self.kept[label]
        noise = self._check_noise(index)[:, rows]
        if ar.name not in self.models:
            rec = self.receptor
            self.models[ar.name] = (
                ref_ligand.LigandModel(self.ligand, md["hydrogen_mass"], ar,
                                       self.device),
                ref_ligand.GridField(
                    "values" if g["method"] == "bspline" else "derivatives",
                    self.box[0], self.box[1], self.box[2], g["types"],
                    (rec.coords, rec.charges, rec.sigmas, rec.epsilons),
                    g["cap"], g["oob_k"], self.scaling, ar, self.device))
        model, field = self.models[ar.name]
        return follow(model, field, start.positions[rows],
                      start.velocities[rows], noise, md["dt_ps"],
                      md["friction_per_ps"], md["temperature_K"])

    def _check_noise(self, index):
        R, N = self.mix["replicas"], self.ligand.natom
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, "noise", index))
        return torch.empty((self.mix["segment_steps"], R, N, 3),
                           dtype=torch.float32,
                           device=self.device).normal_(generator=gen)

    def _rows(self, label):
        rng = np.random.default_rng(seeds.derive(self.seed, "check", label))
        rows = rng.choice(self.mix["replicas"], self.mix["check_replicas"],
                          replace=False)
        return torch.as_tensor(np.sort(rows), device=self.device)

    def replica_gaps(self, label, control=None):
        """Per sampled replica, the widest atom gap [M] of positions and of
        velocities between the program's state at the end of the checked
        segment (or, with ``control``, the control's) and the float64
        reference's."""
        from gfbench.reference.precision import Arith

        rows = self._rows(label)
        xr, vr = self._reference_run(Arith("float64"), label, rows)
        if control is None:
            end = self.kept[label][2]
            x, v = end.positions[rows], end.velocities[rows]
        else:
            x, v = self._reference_run(Arith(control), label, rows)
        return state_gaps(x, v, xr, vr)

    def readings(self, control=None):
        """The numbers compared: the widest atom gap of positions and of
        velocities over the sampled replicas of every checked segment."""
        gaps = [self.replica_gaps(label, control)
                for label in self.mix["check_segments"]]
        return {name: max(float(g[i].max()) for g in gaps)
                for i, name in enumerate(("x_gap_nm", "v_gap_nm_per_ps"))}
