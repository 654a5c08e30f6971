"""chip_smoke.py at tiny sizes on the CPU: every phase function runs and
checks what it claims, the float64 host reference agrees with the dense
oracle, and main() refuses to run without a GPU.  The full-size run is
`python chip_smoke.py` on the card."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from fustpu.mesh.box import build_box_mesh  # noqa: E402
from fustpu.mesh.unstructured import from_box  # noqa: E402
from fustpu.ops import precompute as pre  # noqa: E402
from fustpu.oracle import assemble as oracle  # noqa: E402


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


@pytest.mark.parametrize("kind", ["box", "unstructured"])
def test_reference_stiffness_matches_oracle(kind):
    mesh = build_box_mesh((3, 2, 2), 3, hi=(1.0, 0.8, 1.3), perturb=0.15,
                          seed=3)
    if kind == "unstructured":
        mesh = from_box(mesh, shuffle_seed=9)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(mesh.ndofs)
    c = rng.uniform(0.5, 2.0, mesh.num_cells)
    y = chip_smoke.reference_stiffness(G, mesh.dofmap,
                                       mesh.element.deriv_1d, mesh.ndofs,
                                       x, c)
    want = oracle.apply_elementwise(oracle.element_stiffness_matrices(mesh),
                                    np.asarray(mesh.dofmap), c, x,
                                    mesh.ndofs)
    assert chip_smoke.rel_l2(y, want) < 1e-12


@pytest.mark.parametrize("case", [
    ("box", dict(nc=(3, 2, 2), degree=2)),
    ("piston", dict(refine=1, degree=2)),
    ("bodyfit", dict(elements=12, degree=2)),
], ids=["box", "piston", "bodyfit"])
def test_phase_operators(case, tmp_path):
    errs = chip_smoke.phase_operators([case], mesh_dir=str(tmp_path),
                                      reps=1)
    assert len(errs) == 2                      # uniform and pair
    path = {"box": "mm", "piston": "extruded", "bodyfit": "indexed"}
    assert all(f" {path[case[0]]} " in k for k in errs)
    assert all(e <= chip_smoke.TOL_OPERATOR for e in errs.values())


def test_phase_anchor_band(tmp_path):
    """The anchor runs to t_final and returns the focal pressure; a band
    that excludes it raises."""
    p = chip_smoke.phase_anchor(elements=12, degree=2, periods=0.2,
                                band=(-np.inf, np.inf),
                                mesh_dir=str(tmp_path))
    assert np.isfinite(p) and p != 0.0
    with pytest.raises(RuntimeError, match="outside"):
        chip_smoke.phase_anchor(elements=12, degree=2, periods=0.2,
                                band=(abs(p) + 1.0, abs(p) + 2.0),
                                mesh_dir=str(tmp_path))


def test_phase_imported(tmp_path):
    out = chip_smoke.phase_imported(elements=12, degree=2, steps=2,
                                    trace_steps=40, mesh_dir=str(tmp_path))
    assert out["trace_rel_l2"] <= chip_smoke.TOL_IMPORTED
    assert {"conformal", "unstructured", "bodyfit"} <= set(out)


def test_phase_two_layer(tmp_path):
    out = chip_smoke.phase_two_layer(elements=12, degree=2, steps=2,
                                     mesh_dir=str(tmp_path))
    assert set(out) == {"conformal", "bodyfit"}


def test_phase_flagship(tmp_path):
    out = chip_smoke.phase_flagship(elements=12, degree=2, steps=2,
                                    mesh_dir=str(tmp_path))
    assert out["ndofs"] == 25 * 17 * 17 and out["ms_per_step"] > 0


def test_phase_four_cards_on_virtual_devices(tmp_path):
    """The four-card phase on 4 of the suite's virtual CPU devices (the
    rehearsal __graft_entry__.dryrun_multichip runs)."""
    out = chip_smoke.phase_four_cards(elements=12, degree=2, steps=2,
                                      grid=(2, 2, 1),
                                      mesh_dir=str(tmp_path))
    for geometry in ("conformal", "unstructured"):
        assert out[geometry]["rel_l2"] <= chip_smoke.TOL_SHARDED


def test_build_bowl_flagship_cells():
    """The demo's defaults are the reference flagship's 118x72x72 cells
    (132,929,701 DOF at P=6) — checked without building it."""
    from demos.demo_nonlinear_bowl import bowl_cells

    nc = bowl_cells(0)
    assert nc == (118, 72, 72)
    assert np.prod([c * 6 + 1 for c in nc]) == 132_929_701
    assert bowl_cells(64) == (64, 40, 40)


@pytest.mark.gpu
def test_phase_operators_on_gpu(gpu, tmp_path):
    """Phase 1 on the card at moderate widths: each path compiled for the
    GPU against the float64 host reference."""
    errs = chip_smoke.phase_operators(
        [("box", dict(nc=(16, 16, 16), degree=4)),
         ("piston", dict(refine=1, degree=4)),
         ("bodyfit", dict(elements=16, degree=3))],
        mesh_dir=str(tmp_path), reps=3)
    assert len(errs) == 6


def test_main_path_imports_stay_light():
    """chip_smoke.py and the main path import nothing beyond JAX, numpy
    and scipy: orbax (checkpoints) and h5py (XDMF) stay lazy."""
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    code = ("import sys; import chip_smoke, fustpu, "
            "demos.demo_nonlinear_bowl, fustpu.parallel.extruded; "
            "print(sorted(m for m in ('orbax', 'h5py', 'torch', 'triton') "
            "if m in sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
