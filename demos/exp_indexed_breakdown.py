"""Where does the explicit-dofmap (unstructured) stiffness apply spend its
time on the card?  Ablation: gather only / +contractions / +scatter, with
sum-factorised per-cell contractions at HIGHEST (f32) and DEFAULT
precision (TF32 on Hopper).  Informs the indexed-path optimisation
direction."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from fustpu.mesh import msh_io, shapes
from fustpu.ops import precompute as pre
from fustpu.ops.gather_scatter import gather_dofs, scatter_add_dofs
from fustpu.utils import benchmarks as B

_HI = jax.lax.Precision.HIGHEST
_DEF = jax.lax.Precision.DEFAULT


def variants(G, coeff, dofmap, D, ndofs, n):
    cells = dofmap.shape[0]
    Gr = G.reshape(cells, n, n, n, 6)

    def gather_only(p, x):
        u = gather_dofs(x, dofmap)
        return x.at[:u.shape[0]].add(u.sum(axis=1) * 0.0) + x * 0.999

    def contract(u, precision):
        u = u.reshape(cells, n, n, n)
        wx = jnp.einsum("qi,cijk->cqjk", D, u, precision=precision)
        wy = jnp.einsum("qj,cijk->ciqk", D, u, precision=precision)
        wz = jnp.einsum("qk,cijk->cijq", D, u, precision=precision)
        c = coeff[:, None, None, None]
        f0 = c * (Gr[..., 0] * wx + Gr[..., 1] * wy + Gr[..., 2] * wz)
        f1 = c * (Gr[..., 1] * wx + Gr[..., 3] * wy + Gr[..., 4] * wz)
        f2 = c * (Gr[..., 2] * wx + Gr[..., 4] * wy + Gr[..., 5] * wz)
        y = jnp.einsum("qi,cqjk->cijk", D, f0, precision=precision)
        y = y + jnp.einsum("qj,ciqk->cijk", D, f1, precision=precision)
        y = y + jnp.einsum("qk,cijq->cijk", D, f2, precision=precision)
        return y.reshape(cells, -1)

    def full(p, x, precision=_HI):
        u = gather_dofs(x, dofmap)
        return scatter_add_dofs(contract(u, precision), dofmap, ndofs)

    def no_scatter(p, x, precision=_HI):
        u = gather_dofs(x, dofmap)
        y = contract(u, precision)
        # fold back to a vector without indexed scatter (sum-reduce)
        return x * 0.999 + jnp.zeros(ndofs, x.dtype).at[0].add(y.sum())

    return [
        ("gather only", gather_only),
        ("gather+contract(HI)", lambda p, x: no_scatter(p, x, _HI)),
        ("gather+contract(DEFAULT)", lambda p, x: no_scatter(p, x, _DEF)),
        ("full indexed (HI)", lambda p, x: full(p, x, _HI)),
        ("full indexed (DEFAULT)", lambda p, x: full(p, x, _DEF)),
    ]


def main():
    degree = 4
    verts, cells_, tagged = shapes.cylinder_mesh(
        0.015, 0.03, 0.01, m=8, mr=4, nr_ann=4, nz=30)
    path = msh_io.write_msh("/tmp/idx_cyl", verts, cells_, tagged)
    mesh = msh_io.read_msh(path, degree=degree)
    print(f"{mesh.num_cells} cells, {mesh.ndofs} dofs")
    _, G = pre.cell_geometry_factors(mesh)
    dtype = jnp.float32
    n = degree + 1
    G = jnp.asarray(G, dtype)
    D = jnp.asarray(mesh.element.deriv_1d, dtype)
    dofmap = jnp.asarray(mesh.dofmap)
    coeff = jnp.asarray(np.ones(mesh.num_cells), dtype)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(mesh.ndofs),
                    dtype)
    dev = B.require_gpu()
    print(f"device: {dev.device_kind} ({B.card_info()})", flush=True)
    for name, fn in variants(G, coeff, dofmap, D, mesh.ndofs, n):
        try:
            t, _ = B.time_apply(fn, None, x, chain=20, reps=5)
            print(f"{name:<24} {t*1e3:8.3f} ms  "
                  f"{mesh.ndofs/t/1e9:5.2f} GDOF/s", flush=True)
        except Exception as e:
            print(f"{name:<24} FAILED {type(e).__name__}: {str(e)[:200]}")


if __name__ == "__main__":
    main()
