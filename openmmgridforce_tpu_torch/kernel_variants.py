"""Time build-time variants of the port's kernels on the card.

The kernels' design choices are constants at the top of their sources
(points per thread, threads per block, atoms per partial, unroll depth,
K3's launch order and staging) and a few lines of arithmetic. This script
compiles copies of a source with some of them replaced, runs every copy on
the full-size synthetic complex of ``chip_smoke.py`` and prints one JSON
line per variant: registers, milliseconds per grid type, and the error
against the plain twin (float32 over the whole grid for the values kernel,
float64 over slabs of x-planes for the derivative kernel). The ``*_f64``
lists vary the float64 bodies' constants (``k*64``: launch shape, tile,
Newton steps, clamp form) and lines, and time them with float64 atoms
against the float64 twins. The first variant of each list is the source
as it stands. It changes nothing in the package: it is how the shipped
constants were chosen, and how to choose them again on another card.

``packed_eval`` times K3 (``csrc/packed_eval.cu``) on the bench packs of
``chip_smoke.py``'s ``main_path`` (B-spline, d = 4) and ``deriv_path``
(triquintic Chebyshev, d = 6) at the poses of a 1000-replica segment:
each variant's recorded and eager ms a call, its share of the bound, and
its error against the twin in float32 and float64. A variant may name
another source (the first design, ``csrc/variants/packed_eval_gather.cu``)
or wrapper settings (``TILE_ATOMS``). Every variant is timed twice, the
list forwards and then backwards, so that neighbours in time compare, and
says whether its results equal the first design's bit for bit (the
second entry of the list).

    python -m openmmgridforce_tpu_torch.kernel_variants [values] [derivs]
        [values_f64] [derivs_f64] [packed_eval]

(from the repository root, which holds ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys

from . import cuda_build

# (label, {constant: value}, [(old text, new text), ...]) per kernel
# timed calls a K3 figure
VARIANT_REPS = 200

VARIANTS = {
    "gridgen_values": [
        ("as shipped", {}, []),
        ("1 point per thread", {"kPoints": 1}, []),
        ("2 points per thread", {"kPoints": 2}, []),
        ("8 points per thread", {"kPoints": 8, "kMinBlocks": 8}, []),
        ("64 threads per block", {"kThreads": 64, "kMinBlocks": 20}, []),
        ("256 threads per block", {"kThreads": 256, "kMinBlocks": 5}, []),
        ("atom loop not unrolled", {"kUnroll": 1}, []),
        ("atom loop unrolled by 2", {"kUnroll": 2}, []),
        ("no room asked of the register allocator", {"kMinBlocks": 1}, []),
        ("partials of 32 atoms", {"kAtomBlock": 32}, []),
        ("tiles and partials of 512 atoms",
         {"kTile": 512, "kAtomBlock": 512}, []),
        # 1/r^2 by squaring an rsqrt instead of one reciprocal: a multiply
        # more for the two Lennard-Jones types
        ("1/r^2 from the rsqrt", {}, [
            ("const T inv_r2 = R::rcp(r2);",
             "const T inv_r = R::rsqrt(r2);\n"
             "            const T inv_r2 = inv_r * inv_r;")]),
    ],
    "gridgen_derivs": [
        ("as shipped", {}, []),
        ("partials of 8 atoms", {"kAtomBlock": 8}, []),
        ("partials of 128 atoms", {"kAtomBlock": 128}, []),
        ("atom loop not unrolled", {"kUnroll": 1}, []),
        ("atom loop unrolled by 4", {"kUnroll": 4}, []),
        ("at least 4 blocks per SM", {}, [
            ("__launch_bounds__(Real<T>::threads)\ngridgen_derivs_kernel",
             "__launch_bounds__(Real<T>::threads, 4)\n"
             "gridgen_derivs_kernel")]),
    ],
    "gridgen_values_f64": [
        ("as shipped", {}, []),
        ("two Newton steps", {"kNewton64": 2}, []),
        ("clamp on every pair, no vote", {"kClampEvery64": 1}, []),
        # the float64 loop as it was before its own design, in this body
        ("libdevice rsqrt() and __drcp_rn, clamp on every pair",
         {"kClampEvery64": 1}, [
             ("  double y = rsqrt_seed(x);\n",
              "  return ::rsqrt(x);\n  double y = rsqrt_seed(x);\n"),
             ("  double y = rcp_seed(x);\n",
              "  return __drcp_rn(x);\n  double y = rcp_seed(x);\n")]),
        ("1/r^2 from the rsqrt", {}, [
            ("const double inv_r2 = rcp64(r2);",
             "const double inv_r = rsqrt64(r2);\n"
             "          const double inv_r2 = inv_r * inv_r;")]),
        # the z-column tile of the design's first form
        ("4 z-points a thread, groups of 4 atoms, room for 4 blocks",
         {"kRows64": 1, "kPoints64": 4, "kUnroll64": 4, "kMinBlocks64": 4},
         []),
        ("y x z tile of 2 x 4 points, groups of 2, room for 4 blocks",
         {"kRows64": 2, "kPoints64": 4, "kUnroll64": 2, "kMinBlocks64": 4},
         []),
        ("y x z tile of 2 x 8 points, groups of 2",
         {"kRows64": 2, "kUnroll64": 2}, []),
        ("y x z tile of 3 x 4 points, groups of 2, room for 3 blocks",
         {"kRows64": 3, "kPoints64": 4, "kUnroll64": 2, "kMinBlocks64": 3},
         []),
        ("y x z tile of 4 x 4 points, groups of 2",
         {"kPoints64": 4, "kUnroll64": 2}, []),
        ("y x z tile of 4 x 4 points, groups of 2, 64 threads, room for 4",
         {"kPoints64": 4, "kUnroll64": 2, "kThreads64": 64,
          "kMinBlocks64": 4}, []),
        ("y x z tile of 8 x 4 points", {"kRows64": 8, "kPoints64": 4}, []),
        ("groups of 2 atoms", {"kUnroll64": 2}, []),
        ("64 threads per block, room for 4 blocks",
         {"kThreads64": 64, "kMinBlocks64": 4}, []),
        ("256 threads per block, room for 1 block",
         {"kThreads64": 256, "kTile64": 256, "kMinBlocks64": 1}, []),
        ("room for 3 blocks per SM", {"kMinBlocks64": 3}, []),
    ],
    "gridgen_derivs_f64": [
        ("as shipped", {}, []),
        ("atom loop not unrolled", {"kUnroll64": 1}, []),
        ("64 threads per block", {"kThreads64": 64}, []),
    ],
    # a fourth item: another source under csrc/ ("source") and wrapper
    # settings of ops/cuda_packed_eval.py for the variant's calls
    "packed_eval": [
        ("as shipped: rows staged by bulk copies, [B, N] order", {}, []),
        ("first design: rows gathered by the lanes, [B, N] order, every "
         "lane's tail, grid loop not unrolled", {}, [],
         {"source": "variants/packed_eval_gather.cu", "TILE_ATOMS": 32}),
        ("atom order alone: rows gathered by the lanes, atom-major",
         {"kStaged": 0, "kAtomMajor": 1}, [], {"TILE_ATOMS": 32}),
        ("atom order and staging: rows staged, atom-major",
         {"kAtomMajor": 1}, []),
        ("neither: rows gathered by the lanes, [B, N] order",
         {"kStaged": 0}, [], {"TILE_ATOMS": 32}),
        ("every lane's tail", {"kSplitTail": 0}, []),
        ("grid loop not unrolled", {"kUnrollGrids": 0}, []),
        ("tiles of 8 atoms", {}, [], {"TILE_ATOMS": 8}),
        ("tiles of 24 atoms", {}, [], {"TILE_ATOMS": 24}),
        ("tiles of 32 atoms", {}, [], {"TILE_ATOMS": 32}),
    ],
}


def library(name: str) -> str:
    """The library a variant list edits: the float64 lists edit the same
    source as the float32 ones."""
    return name.removesuffix("_f64")


def variant_source(name: str, constants: dict, edits: list,
                   source: str | None = None) -> str:
    """The kernel's source (or ``source`` under csrc/) with the named
    constants and texts replaced; raises if a replacement does not apply
    exactly once."""
    (src,) = cuda_build.LIBRARIES[library(name)]
    text = (cuda_build.CSRC / (source or src)).read_text()
    for const, value in constants.items():
        text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                          rf"\g<1>{int(value)};", text)
        if n != 1:
            raise ValueError(f"{name}: constant {const} found {n} times")
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} found {text.count(old)} "
                             "times")
        text = text.replace(old, new)
    return text


def _build_all(name: str):
    """Compiles every variant of the kernel, all nvcc processes started
    together. Returns [(label, library path, build log)]."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for label, constants, edits, *settings in VARIANTS[name]:
        source = settings[0].get("source") if settings else None
        text = variant_source(name, constants, edits, source)
        stem = f"{name}-{hashlib.sha256(text.encode()).hexdigest()[:12]}"
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        proc = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        jobs.append((label, so, proc))
    built = []
    for label, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} [{label}]: nvcc failed:\n{log}")
        built.append((label, so, log))
    return built


def _registers(log: str, f64: bool) -> list:
    """Registers of the instantiations of one scalar type, in log order."""
    out, entry = [], ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and f"E{'d' if f64 else 'f'}EEv" in entry:
            out.append(int(found.group(1)))
    return out


def _bench_packs(torch, cs):
    """chip_smoke.py's main_path and deriv_path packs on the synthetic
    complex, with each path's scalings and the poses of a warm-up and a
    1000-replica, 1000-step recorded segment on it (as chip_smoke's
    packed_eval_check takes them): {"d4 bspline": (table, scaling,
    poses), "d6 chebyshev": ...}."""
    import numpy as np

    from .grid import InterpolationMethod
    from .mm import GridBinding, make_md_runner, system_from_amber
    from .ops import gridgen
    from .ops.packed import combine_packed_grids, pack_grid
    from .parallel import init_replica_states

    lig, lig_crd, rec, rec_crd = cs.synthetic_complex(0)
    counts, origin = cs.grid_box(lig_crd)
    system = system_from_amber(lig, dtype=torch.float32, hydrogen_mass=4.0,
                               device="cuda")
    scaling = torch.as_tensor(np.stack([gridgen.auto_scaling_factors(
        gt, lig.charges, lig.sigmas, lig.epsilons) for gt in cs.GRID_TYPES]),
        dtype=torch.float32, device="cuda")
    temps = torch.full((cs.N_REPLICAS,), 300.0, device="cuda")
    out = {}
    for key, derivatives, method in (
            ("d4 bspline", False, InterpolationMethod.BSPLINE),
            ("d6 chebyshev", True, InterpolationMethod.TRIQUINTIC)):
        grids = [gridgen.generate_grid(
            counts, (cs.SPACING,) * 3, origin, gt, rec_crd, rec.charges,
            rec.sigmas, rec.epsilons, grid_cap=cs.GRID_CAP,
            compute_derivatives=derivatives, interp_method=method,
            device="cuda") for gt in cs.GRID_TYPES]
        table = combine_packed_grids([pack_grid(g) for g in grids])
        del grids
        binding = GridBinding(grid=table, scaling=scaling)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        states = init_replica_states(
            gen, torch.as_tensor(lig_crd, dtype=torch.float32),
            system.masses, 300.0, cs.N_REPLICAS, device="cuda")
        for n in (cs.N_WARMUP, cs.N_STEPS):
            states = make_md_runner(n, dt=0.001, friction=5.0,
                                    device="cuda")(states, system,
                                                   [binding], temps)
        out[key] = (table, scaling,
                    cs.packed_eval_poses(torch, table, states.positions))
    torch.cuda.synchronize()
    return out


def packed_eval_variants(torch, cs):
    """K3's variants on the bench packs: one JSON line per variant and
    pack (see the module's docstring)."""
    import dataclasses

    from .ops import cuda_packed_eval as k3

    packs = _bench_packs(torch, cs)
    refs, bounds = {}, {}
    for key, (table, scaling, x) in packs.items():
        bounds[key] = cs.packed_eval_bound(torch, table, x, scaling)
        wide = dataclasses.replace(table, coeffs=table.coeffs.double(),
                                   spacing=table.spacing.double(),
                                   origin=table.origin.double())
        packs[key] = (table, scaling, x, wide)
        refs[key] = (k3.packed_eval_plain(table, x, scaling),
                     k3.packed_eval_plain(wide, x.double(),
                                          scaling.double()))
    built = _build_all("packed_eval")
    settings = [dict(v[3]) if len(v) > 3 else {}
                for v in VARIANTS["packed_eval"]]
    shipped = {k: getattr(k3, k) for s in settings for k in s
               if k != "source"}
    results = {label: {"kernel": "packed_eval", "variant": label,
                       "registers": {}, "spill_bytes": sum(
                           int(b) for b in re.findall(r"(\d+) bytes spill",
                                                      log)),
                       "settings": s}
               for (label, _, log), s in zip(built, settings)}
    for label, _, log in built:
        entry = ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '([^']+)'", line)
            if found:
                entry = found.group(1)
            found = re.search(r"Used (\d+) registers", line)
            name = cs.packed_eval_instance(entry) if found else None
            if name:
                results[label]["registers"][name] = int(found.group(1))
    order = list(zip(built, settings))
    package_library = k3._library
    outputs = {}
    for turn, sequence in enumerate((order, order[::-1])):
        for (label, so, _), s in sequence:
            lib = k3._declare(ctypes.CDLL(str(so)))
            k3._library = lambda lib=lib: lib
            for k, v in shipped.items():
                setattr(k3, k, s.get(k, v))
            line = results[label]
            for key, (table, scaling, x, wide) in packs.items():
                fig = line.setdefault(key, {"graph_ms": [], "ms": []})
                if turn == 0:
                    errs = {}
                    for dtype, args, ref in (
                            ("float32", (table, x, scaling), refs[key][0]),
                            ("float64", (wide, x.double(),
                                         scaling.double()), refs[key][1])):
                        got = k3.packed_eval(*args)
                        errs[dtype] = cs.packed_eval_errors(got, ref)
                        outputs[label, key, dtype] = got
                    fig["errors"] = errs
                    fig["plan"] = dataclasses.asdict(k3.launch_plan(
                        table.degree, table.n_grids, table.coeffs.dtype))
                args = (table, x, scaling)
                fig["graph_ms"].append(cs._graph_ms(
                    torch, lambda: k3.packed_eval(*args), VARIANT_REPS))
                fig["ms"].append(cs._cuda_ms(
                    torch, lambda: k3.packed_eval(*args), VARIANT_REPS))
                fig["bound_ms"] = bounds[key]["bound_ms"]
                fig["bound_share"] = (bounds[key]["bound_ms"]
                                      / min(fig["graph_ms"]))
    for k, v in shipped.items():
        setattr(k3, k, v)
    k3._library = package_library
    # whether each variant's results equal the first design's bit for bit
    first = built[1][0]
    for label, _, _ in built:
        for key in packs:
            results[label][key]["equal_to_first_design"] = {
                dtype: all(torch.equal(a, b) for a, b in zip(
                    outputs[label, key, dtype], outputs[first, key, dtype]))
                for dtype in ("float32", "float64")}
    for key, b in bounds.items():
        print(json.dumps({"kernel": "packed_eval", "pack": key, **b}),
              flush=True)
    for line in results.values():
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from .ops import cuda_gridgen, cuda_gridgen_derivs
    from .ops.gridgen import receptor_atoms

    wanted = [a if a == "packed_eval" else f"gridgen_{a}"
              for a in (argv or sys.argv[1:])] or list(VARIANTS)
    f64 = torch.float64
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi, _ = cs.phase_device(torch)
    if "packed_eval" in wanted:
        wanted.remove("packed_eval")
        packed_eval_variants(torch, cs)
        if not wanted:
            print(smi, flush=True)
            return 0
    _, lig_crd, rec, rec_crd = cs.synthetic_complex(0)
    counts, origin = cs.grid_box(lig_crd)
    spacing = (cs.SPACING,) * 3
    nyz = counts[1] * counts[2]
    slabs = [(x0 * nyz, (x0 + 2) * nyz)
             for x0 in (0, counts[0] // 2, counts[0] - 2)]
    rows = torch.cat([torch.arange(a, b, device="cuda") for a, b in slabs])
    modules = {"gridgen_values": cuda_gridgen,
               "gridgen_derivs": cuda_gridgen_derivs}
    for name in wanted:
        module = modules[library(name)]
        dtype = f64 if name.endswith("_f64") else torch.float32
        atoms = {gt: receptor_atoms(gt, rec_crd, rec.charges, rec.sigmas,
                                    rec.epsilons, dtype=dtype,
                                    device="cuda")
                 for gt in cs.GRID_TYPES}
        if library(name) == "gridgen_values":
            refs = {gt: module.gridgen_values_plain(
                atoms[gt], counts, spacing, origin, gt, cs.GRID_CAP)
                for gt in cs.GRID_TYPES}
        else:
            refs = {gt: torch.cat([module.gridgen_derivs_plain(
                atoms[gt].to(f64), counts, spacing, origin, gt, start=a,
                stop=b) for a, b in slabs]) for gt in cs.GRID_TYPES}
        for label, so, log in _build_all(name):
            # the wrapper calls whatever library its module's _library gives
            lib = module._declare(ctypes.CDLL(str(so)))
            module._library = lambda lib=lib: lib
            line = {"kernel": name, "variant": label,
                    "registers": _registers(log, dtype == f64),
                    "spill_bytes": sum(int(b) for b in re.findall(
                        r"(\d+) bytes spill", log)),
                    "ms": {}, "rel_err": {}, "shape": {}}
            for gt in cs.GRID_TYPES:
                if library(name) == "gridgen_values":
                    args = (atoms[gt], counts, spacing, origin, gt,
                            cs.GRID_CAP)
                    got = module.gridgen_values(*args)
                    err = float((got - refs[gt]).abs().max()
                                / refs[gt].abs().max())
                    call = lambda: module.gridgen_values(*args)  # noqa: E731
                else:
                    args = (atoms[gt], counts, spacing, origin, gt)
                    got = module.gridgen_derivs(*args).reshape(-1, 27)
                    err = float(cs._slot_err(got[rows], refs[gt]).max())
                    call = lambda: module.gridgen_derivs(*args)  # noqa: E731
                line["rel_err"][gt] = err
                line["ms"][gt] = cs._cuda_ms(torch, call, 3)
                line["shape"][gt] = module.launch_shape(counts, gt,
                                                        dtype=dtype)
                del got
            print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
