"""BPMF ladder traffic: one ligand's temperature ladder, trials of replica
exchange, genetic Monte Carlo and constrained Langevin MD through the
program's sampler, as AlGDock runs them between its segments.

Set-up builds the complex from the seed, generates and packs the grids as
the MD kind does, builds the constrained System and the program's sampler
(``program.sampler``), equilibrates the ladder in drain rounds (an MD
segment, then fresh velocities for any rung hotter than the drain factor
times its temperature) and runs the mix's warm-up trials, which record
the segment's blocks and load every kernel a trial launches. The window
runs trials back to back in ``Sampler.run``'s order: an exchange sweep, a
genetic sweep, an MD segment, then the host check (every rung's
temperature read back; a trial in which a rung is not finite, or hotter
than the drain factor times its temperature, failed). Jobs of
``job_trials`` trials each start every rung from the ladder set-up
equilibrated, with the sampler's generator seeded anew. Each trial's MD
takes Maxwell-Boltzmann velocities and noise drawn on the card from the
seed (``run_md``'s ``velocities`` and ``noise``).

The check reads what the sampler did in the window's first and last
trials: its energies, draws and decisions (``Sampler.last_exchange``,
``last_gmc``: a kind that runs on a program without them stops at set-up
with an error), the ladder between the stages and the MD's ends. The
plain reference (``reference/constrained.py``, ``reference/ladder.py``)
works out again the energies, the genetic candidates and the MD from the
same states and draws, and decides every move again; where its decision
differs from the program's by more than the energies' limit allows, the
decision flipped.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from gfbench import complex as cx
from gfbench import program, seeds
from gfbench.reference import constrained, fields, ladder
from gfbench.reference import ligand as ref_ligand

BOLTZ = ref_ligand.BOLTZ


def _no_span(name):
    return contextlib.nullcontext()


def _worst(a, b):
    """The larger of a number and a 0-d tensor, infinite where the tensor
    is not a number (a state that is not finite reads as infinitely far)."""
    b = float(b)
    return max(a, b) if not math.isnan(b) else math.inf


class Session:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.kept = {}
        self.models = {}          # the reference's, by arithmetic
        self.window = None
        self.traced = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    # ------------------------------------------------------------------
    def setup(self):
        c, g, lad = self.config, self.config["grids"], self.config["ladder"]
        dev = self.device
        self.ligand, self.receptor = cx.from_config(c, self.seed)
        lig = self.ligand
        counts = tuple(g["counts"])
        self.box = (counts, cx.grid_box(lig.coords, counts, g["spacing_nm"]),
                    (g["spacing_nm"],) * 3)
        grids = program.generate(c, self.box, self.receptor.coords,
                                 self.receptor, dev)
        self.table = program.pack(grids)
        del grids
        self.scaling = np.stack([fields.scalings(gt, lig.charges, lig.sigmas,
                                                 lig.epsilons)
                                 for gt in g["types"]])
        self.binding = program.binding(self.table, self.scaling, dev)
        self.system = program.system(lig, c, dev)
        # the sampler's seeds are below 2**63
        self.sampler = s = program.sampler(
            lig, self.system, [self.binding], c,
            seeds.derive(self.seed, "sampler", 0) >> 1, dev)
        if not all(hasattr(s, k) for k in ("last_exchange", "last_gmc")):
            raise RuntimeError("the program's Sampler keeps no record of "
                               "its sweeps (last_exchange, last_gmc), which "
                               "this kind's check reads")

        R, N = lad["states"], lig.natom
        self.rung_K = ladder.temperatures(lad["t_min_K"], lad["t_high_K"], R)
        self.masses = torch.as_tensor(ref_ligand.repartitioned_masses(
            lig, c["md"]["hydrogen_mass"]), dtype=torch.float32, device=dev)
        temps = torch.as_tensor(self.rung_K, dtype=torch.float32, device=dev)
        self.v_sd = torch.sqrt(BOLTZ * temps[:, None]
                               / self.masses[None, :])[..., None]
        self.hot_K = (lad["drain_factor"] * temps).cpu()
        self.noise = torch.empty((lad["nstep_md"], R, N, 3),
                                 dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)

        rounds = c["equilibration_drain_rounds"]
        for _ in range(rounds):
            s.run_md(c["equilibration_steps"] // rounds)
            s.drain_trapped(lad["drain_factor"])
        self.equilibrated = s.states
        for w in range(self.mix["warmup_trials"]):
            self._trial(-1 - w)
        self._sync()

    # ------------------------------------------------------------------
    def _inputs(self, index):
        """The MD's starting velocities [R, N, 3] and noise [S, R, N, 3] of
        trial ``index``, drawn on the device from the seed."""
        self.gen.manual_seed(seeds.derive(self.seed, "velocities", index))
        v = self.v_sd * torch.randn(self.noise.shape[1:], generator=self.gen,
                                    device=self.device)
        self.gen.manual_seed(seeds.derive(self.seed, "noise", index))
        return v, self.noise.normal_(generator=self.gen)

    def _new_job(self, index):
        """Every rung from the equilibrated ladder, the sampler's
        generator seeded for the job."""
        s = self.sampler
        s.states = self.equilibrated._replace(
            positions=self.equilibrated.positions.clone(),
            velocities=self.equilibrated.velocities.clone())
        s.generator.manual_seed(seeds.derive(self.seed, "job", index))

    def _trial(self, index, span=_no_span):
        """One trial and its host check: (seconds, passed). The check reads
        every rung's temperature back (NaN where its state is not finite);
        the trial passed if every rung is finite and no hotter than the
        drain factor times its temperature."""
        lad = self.config["ladder"]
        s = self.sampler
        t0 = time.perf_counter()
        if index >= 0 and index % self.mix["job_trials"] == 0:
            self._new_job(index)
        x0 = s.states.positions
        with span("exchange"):
            s.replica_exchange_sweep(lad["exchange_attempts"])
        exchange, x1 = s.last_exchange, s.states.positions
        with span("gmc"):
            s.genetic_sweep(lad["gmc_pairs"])
        gmc, x2 = s.last_gmc, s.states.positions
        with span("md"):
            v0, noise = self._inputs(index)
            s.run_md(lad["nstep_md"], velocities=v0, noise=noise)
        end = s.states
        x, v = end.positions, end.velocities
        ke = 0.5 * (self.masses[:, None] * v * v).sum((-2, -1))
        t = 2.0 * ke / (3 * x.shape[-2] * BOLTZ)
        finite = torch.isfinite(x).all((-2, -1)) & torch.isfinite(v).all(
            (-2, -1))
        host = torch.where(finite, t, torch.full_like(t, float("nan"))).cpu()
        passed = bool((host <= self.hot_K).all())
        self.last = {"index": index, "x0": x0, "exchange": exchange,
                     "x1": x1, "gmc": gmc, "x2": x2, "v0": v0, "x3": x,
                     "v3": v}
        return time.perf_counter() - t0, passed

    def run_window(self, seconds):
        durations, failed, index = [], 0, 0
        t0 = time.perf_counter()
        while True:
            dt, passed = self._trial(index)
            if index == 0:
                self.kept["first"] = self.last
            durations.append(dt)
            failed += not passed
            index += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.kept["last"] = self.last
        lad = self.config["ladder"]
        self.window = {"seconds": wall, "items": index, "failed": failed,
                       "durations": durations,
                       "units": index * lad["states"] * lad["nstep_md"]}

    def run_traced(self, spans, window):
        """A fresh job after the window: its first trial untraced, then the
        mix's traced trials inside ``window``, each stage inside its span
        (``exchange``, ``gmc``, ``md``) and the host check outside them;
        the constraint solvers' sweep counts over the traced trials."""
        job = self.mix["job_trials"]
        first = -(-self.window["items"] // job) * job
        self._trial(first)
        n = self.mix["trace_trials"]
        program.reset_constraint_sweeps()
        with window:
            for index in range(first + 1, first + 1 + n):
                self._trial(index, spans)
        self.traced = {"trials": n, "sweeps": program.constraint_sweeps()}

    def release(self):
        """Drop the program's state; keep what the check reads."""
        self.table = self.binding = self.system = self.sampler = None
        self.equilibrated = self.noise = self.last = None

    # ------------------------------------------------------------------
    def _check_noise(self, index):
        lad = self.config["ladder"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, "noise", index))
        return torch.empty((lad["nstep_md"], lad["states"],
                            self.ligand.natom, 3), dtype=torch.float32,
                           device=self.device).normal_(generator=gen)

    def _model(self, name):
        """The reference in arithmetic ``name``: (ligand model without the
        constrained bonds, grid field, constraints, z-matrix)."""
        from gfbench.reference.precision import Arith

        if name not in self.models:
            ar = Arith(name)
            g, md = self.config["grids"], self.config["md"]
            rec = self.receptor
            model = constrained.without_constrained_bonds(
                ref_ligand.LigandModel(self.ligand, md["hydrogen_mass"], ar,
                                       self.device), self.ligand)
            field = ref_ligand.GridField(
                "values" if g["method"] == "bspline" else "derivatives",
                self.box[0], self.box[1], self.box[2], g["types"],
                (rec.coords, rec.charges, rec.sigmas, rec.epsilons),
                g["cap"], g["oob_k"], self.scaling, ar, self.device)
            pairs, lengths = constrained.hbond_constraints(self.ligand)
            cons = constrained.Constraints(
                pairs, lengths, ref_ligand.repartitioned_masses(
                    self.ligand, md["hydrogen_mass"]), ar, self.device)
            rows, primary = ladder.zmatrix(self.ligand, md["hydrogen_mass"])
            self.models[name] = (model, field, cons, (rows, primary))
        return self.models[name]

    def _energies(self, name, x):
        model, field, _, _ = self._model(name)
        x = x.to(model.ar.dtype)
        with torch.no_grad():
            return (model.bonded_and_pairs(x) + field.energy(x)).double()

    def _candidate(self, name, x_low, x_high, splice, icut):
        model, _, _, (rows, primary) = self._model(name)
        dt = model.ar.dtype
        return ladder.genetic_candidate(x_low.to(dt), x_high.to(dt), splice,
                                        icut, rows, primary, model.ar)

    def _compared_rungs(self, x_ref, x_stored):
        """The rungs whose MD the positions and velocities are compared
        on [R] (bool): those whose float64 trajectory moves by at most
        the mix's ``check_stored_nm`` when its state is only stored in
        float32 between steps, and at least the ``check_min_rungs`` that
        move least. Over 200 steps some rungs' trajectories amplify a
        float32 rounding a thousandfold (a wall or a well of the capped
        grids): there the gap measures chaos, not the program."""
        moved = (x_stored - x_ref).norm(dim=-1).amax(-1)
        rungs = moved <= self.mix["check_stored_nm"]
        rungs[moved.argsort()[:self.mix["check_min_rungs"]]] = True
        return rungs

    def trial_readings(self, label, control=None):
        """The numbers of one checked trial: the program's (or, with
        ``control``, the control's) against the float64 reference."""
        lad = self.config["ladder"]
        k = self.kept[label]
        beta = ladder.betas(lad["t_min_K"], lad["t_high_K"], lad["states"])
        margin_kj = 2.0 * self.mix["energy_gap_allowed_kj"]
        out = {"energy_gap_kj": 0.0, "candidate_gap_nm": 0.0,
               "decisions_flipped": 0}

        def energies(x):
            """(this side's, the reference's) energies of x [B, N, 3]."""
            ref = self._energies("float64", x)
            return (self._energies(control, x) if control else None), ref

        def gap(e, ref):
            out["energy_gap_kj"] = _worst(
                out["energy_gap_kj"],
                (e.double().cpu() - ref.double().cpu()).abs().max())

        # the exchange, on the ladder at the trial's start
        ex = k["exchange"]
        e_side, e_ref = energies(k["x0"])
        gap(ex["energies"] if control is None else e_side, e_ref)
        i, j, u = (ex[n].tolist() for n in ("i", "j", "u"))
        # the program's decisions: Metropolis on its own float32 energies
        # (their differences taken in float32, as the sweep takes them),
        # which must give the permutation it applied
        perm, accepted = ladder.exchange_perm(
            ex["energies"].float().cpu().numpy(), beta, i, j, u)
        if perm != ex["perm"].tolist() or not torch.equal(
                k["x1"], k["x0"][ex["perm"]]):
            out["decisions_flipped"] += 1
        e_ref = e_ref.cpu().numpy()
        if control is not None:
            e_side = e_side.cpu().numpy()
        R, order = lad["states"], list(range(lad["states"]))
        for a, b, uk, acc in zip(i, j, u, accepted):
            b = ladder.exchange_partner(a, b, R)
            pa, pb = order[a], order[b]
            want = ladder.robust((beta[a] - beta[b]) * (e_ref[pa] - e_ref[pb]),
                                 uk, abs(beta[a] - beta[b]) * margin_kj)
            got = acc if control is None else ladder.decide(
                (beta[a] - beta[b]) * (e_side[pa] - e_side[pb]), uk)
            out["decisions_flipped"] += want is not None and want != got
            if acc:
                order[a], order[b] = pb, pa

        # the genetic sweep, move by move from the ladder as it stood
        gmc = k["gmc"]
        rung = k["x1"].clone()
        e0_side, e0_ref = energies(rung)
        gap(torch.as_tensor(gmc["energies"]) if control is None else e0_side,
            e0_ref)
        e_now_ref = e0_ref.cpu().numpy().copy()
        e_now_side = (gmc["energies"].copy() if control is None
                      else e0_side.cpu().numpy().copy())
        proposals = gmc["proposals"]
        for move, lr_prog, uk, acc in gmc["decisions"]:
            splice, low, high, icut = gmc["moves"][move]
            first, cands, e_new = max(
                (p for p in proposals if p[0] <= move), key=lambda p: p[0])
            cand = cands[move]
            want_x = self._candidate("float64", rung[low], rung[high],
                                     splice, icut)
            got_x = (cand if control is None else self._candidate(
                control, rung[low], rung[high], splice, icut))
            out["candidate_gap_nm"] = _worst(
                out["candidate_gap_nm"],
                (got_x.double() - want_x).norm(dim=-1).max())
            c_side, c_ref = energies(cand[None])
            c_side = (torch.as_tensor([float(e_new[move])]) if control is None
                      else c_side.cpu())
            window = ladder.GMC_WINDOW[bool(splice)]
            lr_ref = -beta[low] * (float(c_ref[0]) - e_now_ref[low])
            if abs(lr_ref) <= self.mix["check_reach_log_ratio"]:
                gap(c_side, c_ref)
            want = ladder.robust(lr_ref, uk, beta[low] * margin_kj, window)
            got = acc if control is None else ladder.decide(
                -beta[low] * (float(c_side[0]) - e_now_side[low]), uk, window)
            out["decisions_flipped"] += want is not None and want != got
            if acc:
                rung[low] = cand
                e_now_ref[low] = float(c_ref[0])
                e_now_side[low] = float(c_side[0])
        if not torch.equal(rung, k["x2"]):
            out["decisions_flipped"] += 1

        # the MD, from the ladder the genetic sweep left
        noise = self._check_noise(k["index"])
        md = self.config["md"]

        def run(name, stored=None):
            model, field, cons, _ = self._model(name)
            return constrained.follow(model, field, cons, k["x2"], k["v0"],
                                      noise, md["dt_ps"],
                                      md["friction_per_ps"], self.rung_K,
                                      stored)

        xr, vr = run("float64")
        rungs = self._compared_rungs(xr, run("float64", torch.float32)[0])
        x, v = (k["x3"], k["v3"]) if control is None else run(control)
        out["x_gap_nm"] = _worst(0.0, (x.double() - xr).norm(dim=-1).amax(
            -1)[rungs].max())
        out["v_gap_nm_per_ps"] = _worst(0.0, (v.double() - vr).norm(
            dim=-1).amax(-1)[rungs].max())
        out["constraint_gap"] = _worst(
            0.0, self._model("float64")[2].violation(x).max())
        return out

    def readings(self, control=None):
        """The numbers compared, the widest over the checked trials; with
        ``control`` the control's (the reference in that arithmetic in the
        program's place)."""
        per = [self.trial_readings(label, control)
               for label in self.mix["check_trials"]]
        return {name: max(r[name] for r in per) for name in per[0]}
