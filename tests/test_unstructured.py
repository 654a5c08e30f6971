"""Unstructured hex meshes + Gmsh .msh I/O: dofmap continuity, operator
correctness vs the dense oracle, cross-validation against the structured
fast path, and file-format round trips."""

import jax.numpy as jnp
import numpy as np
import pytest

from fustpu.config import Material, Source
from fustpu.mesh import msh_io
from fustpu.mesh.box import build_box_mesh
from fustpu.mesh.unstructured import UnstructuredHexMesh, from_box
from fustpu.models.linear import LinearWaveModel
from fustpu.models.westervelt import WesterveltModel
from fustpu.ops import operators as ops
from fustpu.ops import precompute as pre
from fustpu.oracle import assemble as oracle


def _shuffled_box_umesh(nc=(3, 2, 2), P=3, perturb=0.12, seed=9):
    mesh = build_box_mesh(nc, P, hi=(1.0, 0.7, 0.9), perturb=perturb,
                          seed=seed)
    return mesh, from_box(mesh, shuffle_seed=11)


def test_dofmap_continuity_and_count():
    """Coordinate-dedup numbering must reproduce the structured DOF count
    (shared faces merged exactly once) regardless of cell order and
    orientation."""
    mesh, umesh = _shuffled_box_umesh()
    assert umesh.ndofs == mesh.ndofs
    # every cell's dofs are distinct
    for c in range(umesh.num_cells):
        assert np.unique(umesh.dofmap[c]).size == umesh.dofmap.shape[1]


def test_unstructured_stiffness_vs_oracle():
    """Indexed operators on the shuffled/rotated mesh vs the dense oracle
    assembled on the SAME mesh object — 1e-12 (the reference's gate)."""
    mesh, umesh = _shuffled_box_umesh()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(umesh.ndofs)
    coeff = rng.uniform(0.5, 2.0, umesh.num_cells)

    _, G = pre.cell_geometry_factors(umesh)
    G = np.moveaxis(G, 2, 0)                   # component-major layout
    D = umesh.element.deriv_1d
    y = np.asarray(ops.stiffness_apply_indexed(
        jnp.asarray(x), jnp.asarray(G), jnp.asarray(coeff),
        jnp.asarray(umesh.dofmap), jnp.asarray(D), umesh.ndofs))

    mats = oracle.element_stiffness_matrices(umesh)
    y_ref = oracle.apply_elementwise(mats, umesh.dofmap, coeff, x,
                                     umesh.ndofs)
    err = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    assert err < 1e-12, err


@pytest.mark.parametrize("model_cls", [LinearWaveModel, WesterveltModel])
def test_unstructured_solve_matches_structured(model_cls):
    """The indexed-path model on an unstructured re-expression of a box
    (shuffled cells, rotated orientations) must reproduce the structured
    fast path: same physics, different dof numbering and code path."""
    mesh, umesh = _shuffled_box_umesh(nc=(3, 3, 3), P=2, perturb=0.0)
    mat = Material(sound_speed=1500.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.3)
    src = Source(frequency=1e6, amplitude=1e5)
    # source on x=0, absorbing everywhere (geometric selection on the
    # unstructured mesh; structured uses the plane helpers)
    ext = umesh.boundary_facets()
    cen = umesh.facet_centroids(ext)
    src_u = ext[cen[:, 0] < 1e-9]
    m_s = model_cls(mesh, mat, src, mesh.boundary_facets("x-"),
                    mesh.all_boundary_facets(), dtype=jnp.float64,
                    stiffness_impl="mm")
    m_u = model_cls(umesh, mat, src, src_u, ext, dtype=jnp.float64)
    assert m_u.impl == "indexed"
    dt, _ = m_s.cfl_dt(0.4)
    s_s, _ = m_s.solve(m_s.init_state(), dt, 6)
    s_u, _ = m_u.solve(m_u.init_state(), dt, 6)
    # compare on physical coordinates: map structured grid dofs to
    # unstructured numbering via coordinates
    u_s = np.asarray(s_s.u).reshape(-1)
    u_u = np.asarray(s_u.u)
    pts_s = mesh.node_coords.reshape(-1, 3)
    pts_u = umesh.node_coords
    # match by quantised coordinates
    key = lambda p: (np.round(p * 1e9)).astype(np.int64)
    lut = {tuple(k): i for i, k in enumerate(key(pts_u))}
    perm = np.array([lut[tuple(k)] for k in key(pts_s)])
    err = (np.linalg.norm(u_u[perm] - u_s)
           / max(np.linalg.norm(u_s), 1e-300))
    assert err < 1e-11, err


def test_msh_roundtrip(tmp_path):
    """write_msh -> read_msh preserves geometry, connectivity and facet
    tags (matched through corner sets)."""
    mesh, umesh = _shuffled_box_umesh(nc=(2, 2, 2), P=2)
    ext = umesh.boundary_facets()
    cen = umesh.facet_centroids(ext)
    src_set = ext[cen[:, 0] < 1e-9]
    other = ext[cen[:, 0] >= 1e-9]
    from fustpu.mesh.unstructured import _FACET_CORNERS

    def quads(pairs, tag):
        out = []
        for cell, lf in pairs:
            out.append((tag, [int(umesh.cells[cell][c])
                              for c in _FACET_CORNERS[lf]]))
        return out

    path = msh_io.write_msh(str(tmp_path / "box"), umesh.vertices,
                            umesh.cells,
                            quads(src_set, 1) + quads(other, 2))
    back = msh_io.read_msh(path, degree=2)
    assert back.num_cells == umesh.num_cells
    assert back.ndofs == umesh.ndofs
    # import may locality-reorder cells: compare the cell SET (corner
    # order within a cell is preserved by the format round trip)
    def ckey(m):
        k = np.round(m.vertices[m.cells].reshape(m.num_cells, -1)
                     * 1e9).astype(np.int64)
        return k[np.lexsort(k.T[::-1])]

    assert np.array_equal(ckey(back), ckey(umesh))
    got1 = back.boundary_facets(1)
    assert got1.shape == src_set.shape
    # same physical facets: compare centroid sets
    c_got = np.sort(back.facet_centroids(got1), axis=0)
    c_want = np.sort(umesh.facet_centroids(src_set), axis=0)
    assert np.allclose(c_got, c_want)


def test_unstructured_evaluate():
    """Point evaluation on the unstructured mesh: polynomial-exact inside,
    NaN outside."""
    mesh, umesh = _shuffled_box_umesh(nc=(3, 2, 2), P=3, perturb=0.1)
    xyz = umesh.node_coords
    f = xyz[:, 0] ** 3 - 2 * xyz[:, 1] ** 2 * xyz[:, 2] + 0.5 * xyz[:, 2]
    rng = np.random.default_rng(1)
    pts = rng.uniform([0, 0, 0], [1.0, 0.7, 0.9], (30, 3))
    got = umesh.evaluate(f, pts)
    want = (pts[:, 0] ** 3 - 2 * pts[:, 1] ** 2 * pts[:, 2]
            + 0.5 * pts[:, 2])
    assert np.allclose(got, want, rtol=1e-10, atol=1e-10)
    out = umesh.evaluate(f, np.array([[2.0, 0.5, 0.5]]))
    assert np.isnan(out).all()


def test_mapped_bowl_export_import_matches_structured(tmp_path):
    """The flagship workflow: a body-fitted (mapped) bowl mesh exported to
    a tagged .msh, re-imported, and solved on the indexed path must match
    the structured solve on the same geometry (curved cells + tags through
    the full import pipeline)."""
    from demos.demo_nonlinear_bowl import bowl_mapping
    from fustpu.mesh.box import build_mapped_mesh

    Lx, Lt = 0.02, 0.012
    yc = zc = Lt / 2
    mesh = build_mapped_mesh(
        (4, 3, 3), 2, bowl_mapping(0.035, 0.004, yc, zc, Lx),
        hi=(Lx, Lt, Lt))
    in_ap = lambda c: ((c[:, 1] - yc) ** 2
                       + (c[:, 2] - zc) ** 2) < 0.004**2
    cap = mesh.boundary_facets("x-", predicate=in_ap)
    rest = [mesh.boundary_facets(p) for p in
            ["x+", "y-", "y+", "z-", "z+"]]
    other = np.concatenate(
        [mesh.boundary_facets("x-", predicate=lambda c: ~in_ap(c))] + rest)
    assert len(cap) > 0
    path = msh_io.export_box_msh(mesh, {1: cap, 2: other},
                                 str(tmp_path / "bowl"))
    umesh = msh_io.read_msh(path, degree=2)
    assert umesh.ndofs == mesh.ndofs

    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1e5)
    m_s = WesterveltModel(mesh, mat, src, cap,
                          np.concatenate([cap, other]), dtype=jnp.float64,
                          stiffness_impl="mm")
    m_u = WesterveltModel(umesh, mat, src, umesh.boundary_facets(1),
                          umesh.boundary_facets(), dtype=jnp.float64)
    dt, _ = m_s.cfl_dt(0.4)
    s_s, _ = m_s.solve(m_s.init_state(), dt, 5)
    s_u, _ = m_u.solve(m_u.init_state(), dt, 5)
    key = lambda p: (np.round(p / np.linalg.norm(
        np.array(mesh.hi)) * 1e9)).astype(np.int64)
    lut = {tuple(k): i for i, k in enumerate(key(umesh.node_coords))}
    perm = np.array([lut[tuple(k)]
                     for k in key(mesh.node_coords.reshape(-1, 3))])
    u_s = np.asarray(s_s.u).reshape(-1)
    u_u = np.asarray(s_u.u)[perm]
    err = np.linalg.norm(u_u - u_s) / max(np.linalg.norm(u_s), 1e-300)
    assert err < 1e-11, err


def test_dof_merge_survives_bin_straddle():
    """Two cells sharing a face, with the second cell carrying its OWN
    roundoff-perturbed copies of the shared corners, placed so the shared
    nodes straddle a quantisation-bin boundary: the 8-offset-grid merge
    must still unify them (a single rounded grid silently splits them)."""
    diag_ref = np.sqrt(2.0**2 + 1 + 1)
    b = diag_ref * 1e-9          # bin size used by the numbering (approx)
    eps = 1e-3 * b

    def two_cell_mesh(x_face):
        verts = []
        for x in (0.0, x_face - eps, x_face + eps, 2.0):
            for y in (0.0, 1.0):
                for z in (0.0, 1.0):
                    verts.append((x, y, z))
        verts = np.asarray(verts)
        vid = lambda xi, yi, zi: xi * 4 + yi * 2 + zi
        # corner id is 4a+2b+c with a = x-bit
        cA = np.empty(8, np.int64)
        cB = np.empty(8, np.int64)
        for a in (0, 1):
            for b2 in (0, 1):
                for c in (0, 1):
                    cA[4 * a + 2 * b2 + c] = vid(a, b2, c)
                    cB[4 * a + 2 * b2 + c] = vid(2 + a, b2, c)
        cells = np.stack([cA, cB])
        return UnstructuredHexMesh(degree=2, vertices=verts, cells=cells,
                                   facet_tag_map={})

    # case 1: shared plane right AT a base-grid boundary (base splits,
    # an offset grid merges); case 2: at a half-grid boundary
    for k in (8.0, 7.5):
        mesh = two_cell_mesh(k * b)
        n = 3
        expect = 2 * n**3 - n**2         # shared face merged exactly once
        assert mesh.ndofs == expect, (k, mesh.ndofs, expect)


def test_msh_missing_sections_raise(tmp_path):
    """A .msh missing a required section must raise a clear ValueError,
    and a v4.1 file without $Entities (legal when there are no physical
    groups) must still parse (ADVICE r2: the scan index was left at EOF
    after a missed lookup, corrupting every later section() call)."""
    import pytest

    bad = tmp_path / "bad.msh"
    bad.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n"
                   "$Nodes\n1 1 1 1\n$EndNodes\n")
    # $Nodes present but malformed aside, $Elements absent entirely
    with pytest.raises(ValueError, match=r"missing \$Elements"):
        msh_io.read_msh(str(bad), degree=2)

    # v4.1 without $Entities: single untagged hex, must parse
    ok = tmp_path / "ok.msh"
    verts = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
             (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat",
             "$Nodes", "1 8 1 8", "3 1 0 8"]
    lines += [str(j + 1) for j in range(8)]
    lines += [f"{x} {y} {z}" for x, y, z in verts]
    lines += ["$EndNodes", "$Elements", "1 1 1 1", "3 1 5 1",
              "1 1 2 3 4 5 6 7 8", "$EndElements"]
    ok.write_text("\n".join(lines) + "\n")
    mesh = msh_io.read_msh(str(ok), degree=2)
    assert mesh.num_cells == 1 and mesh.ndofs == 27


def test_cylinder_mesh_conforming():
    """The O-grid cylinder must be vertex-conforming: every interior face
    shared by exactly 2 cells, rim vertices not split by float noise
    (ADVICE r2), and the tagged quads must all match hex faces."""
    from fustpu.mesh.shapes import cylinder_mesh

    # m=5 gives odd sector counts (more rim-angle float expressions)
    v, c, t = cylinder_mesh(0.015, 0.03, 0.010, m=5, mr=2, nr_ann=2, nz=4)
    from fustpu.mesh.unstructured import face_keys

    keys = face_keys(c).reshape(-1, 4)
    uniq, counts = np.unique(keys, axis=0, return_counts=True)
    assert counts.max() == 2          # conforming: no face shared 3+ ways
    n_ext = int((counts == 1).sum())
    # exterior = 2 caps + wall: (25 + 2*20 + 2*20)*2 + wall 20*4
    mesh = msh_io.read_msh(msh_io.write_msh("/tmp/_cyl_conf", v, c, t), 2)
    assert len(mesh.boundary_facets()) == n_ext
    assert set(mesh.facet_tag_map) == {1, 2}


def test_msh_binary_roundtrip(tmp_path):
    """Real Gmsh defaults to binary: the v2.2 binary writer/reader must
    round-trip geometry, connectivity and facet tags exactly like ASCII
    (VERDICT r2 item 8)."""
    from fustpu.mesh.shapes import cylinder_mesh

    v, c, t = cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1, nz=3)
    pa = msh_io.write_msh(str(tmp_path / "a"), v, c, t)
    pb = msh_io.write_msh(str(tmp_path / "b"), v, c, t, binary=True)
    ma = msh_io.read_msh(pa, 3)
    mb = msh_io.read_msh(pb, 3)
    assert ma.ndofs == mb.ndofs and ma.num_cells == mb.num_cells
    assert np.allclose(ma.vertices[ma.cells], mb.vertices[mb.cells])
    for tag in (1, 2):
        ca = np.sort(ma.facet_centroids(ma.boundary_facets(tag)), axis=0)
        cb = np.sort(mb.facet_centroids(mb.boundary_facets(tag)), axis=0)
        assert np.allclose(ca, cb)


def test_msh_binary_v41(tmp_path):
    """Hand-built v4.1 binary file (size_t counts, int32 entity metadata,
    tagged surface entity) parses with the tag attached."""
    import struct

    def sz(*vals):
        return b"".join(struct.pack("<Q", v) for v in vals)

    def i4(*vals):
        return b"".join(struct.pack("<i", v) for v in vals)

    def d8(*vals):
        return b"".join(struct.pack("<d", float(v)) for v in vals)

    verts = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
             (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    buf = b"$MeshFormat\n4.1 1 8\n" + i4(1) + b"\n$EndMeshFormat\n"
    # one tagged surface entity (id 7, physical tag 42)
    buf += b"$Entities\n" + sz(0, 0, 1, 0)
    buf += i4(7) + d8(0, 0, 0, 1, 1, 0) + sz(1) + i4(42) + sz(0)
    buf += b"\n$EndEntities\n"
    buf += b"$Nodes\n" + sz(1, 8, 1, 8)
    buf += i4(3, 1, 0) + sz(8) + sz(*range(1, 9))
    for p in verts:
        buf += d8(*p)
    buf += b"\n$EndNodes\n$Elements\n" + sz(2, 2, 1, 2)
    buf += i4(3, 1, 5) + sz(1) + sz(1, *range(1, 9))
    # bottom quad (gmsh order 1,2,3,4) on the tagged surface entity
    buf += i4(2, 7, 3) + sz(1) + sz(2, 1, 2, 3, 4)
    buf += b"\n$EndElements\n"
    p = tmp_path / "v41.msh"
    p.write_bytes(buf)
    mesh = msh_io.read_msh(str(p), 2)
    assert mesh.num_cells == 1 and mesh.ndofs == 27
    assert list(mesh.facet_tag_map) == [42]
    assert len(mesh.boundary_facets(42)) == 1


def test_reorder_cells_preserves_solve():
    """reorder_cells (the locality_order mechanism) is a pure
    relabelling: the solve on a randomly permuted-cell mesh matches the
    original through coordinate matching, and facet tags follow their
    physical facets."""
    from fustpu.mesh.unstructured import reorder_cells

    mesh, umesh = _shuffled_box_umesh(nc=(3, 2, 2), P=3, perturb=0.1)
    ext = umesh.boundary_facets()
    cen = umesh.facet_centroids(ext)
    src_set = ext[cen[:, 0] < 1e-9]
    umesh = UnstructuredHexMesh(
        degree=umesh.degree, vertices=umesh.vertices, cells=umesh.cells,
        facet_tag_map={1: src_set, 2: ext})
    _ = umesh.dofmap          # force the cluster cache (reuse path)
    perm = np.random.default_rng(5).permutation(umesh.num_cells)
    rmesh = reorder_cells(umesh, perm)
    assert rmesh.ndofs == umesh.ndofs
    assert np.allclose(
        np.sort(rmesh.facet_centroids(rmesh.boundary_facets(1)), axis=0),
        np.sort(umesh.facet_centroids(src_set), axis=0))

    mat = Material(sound_speed=1480.0, density=1000.0)
    src = Source(frequency=1.0e6, amplitude=1e5)
    outs = []
    for m in (umesh, rmesh):
        mdl = LinearWaveModel(m, mat, src, m.boundary_facets(1),
                              m.boundary_facets(2), dtype=jnp.float64)
        dt, _ = mdl.cfl_dt(0.4)
        s, _ = mdl.solve(mdl.init_state(), dt, 6)
        key = (np.round(m.node_coords * 1e9)).astype(np.int64)
        order = np.lexsort(key.T[::-1])
        outs.append(np.asarray(s.u).ravel()[order])
    err = (np.linalg.norm(outs[0] - outs[1])
           / max(np.linalg.norm(outs[0]), 1e-300))
    assert err < 1e-11, err


def test_locality_order_shrinks_windows():
    """locality_order picks the sweep that minimises the first-touch DOF
    span on a mesh whose file order fronts badly (x-major order on a
    long-z column => sweep-z wins), and never worsens the file order."""
    from fustpu.mesh.unstructured import dof_span, locality_order, \
        reorder_cells

    mesh = build_box_mesh((6, 6, 40), 3, hi=(0.01, 0.01, 0.08))
    umesh = from_box(mesh)                     # x-major cell order
    # worst-case file order: x fastest => front is a whole z column set
    worst = reorder_cells(
        umesh, np.lexsort((np.arange(umesh.num_cells),)))
    lo = locality_order(worst)
    span_before = dof_span(worst.dofmap)
    span_after = dof_span(lo.dofmap)
    assert span_after <= span_before
    assert lo.ndofs == worst.ndofs
    # idempotent-ish: applying again never increases the span
    assert dof_span(locality_order(lo).dofmap) <= span_after


@pytest.mark.parametrize("tile,want", [(4, 6), (3, 5), (100, 12)])
def test_dof_span(tile, want):
    """dof_span = the largest max-min+1 over runs of `tile` consecutive
    flat dofmap entries (a short last run is padded, not dropped)."""
    from fustpu.mesh.unstructured import dof_span

    dm = np.array([[0, 1, 2, 5], [3, 4, 6, 8], [9, 11, 10, 7]])
    assert dof_span(dm, tile) == want


def test_indexed_pair_matches_two_applies():
    """stiffness_apply_indexed_pair (single shared scatter — the
    Westervelt heterogeneous fold) == two separate applies at f64
    exactness."""
    mesh, umesh = _shuffled_box_umesh(nc=(3, 3, 2), P=3)
    rng = np.random.default_rng(2)
    x1 = jnp.asarray(rng.standard_normal(umesh.ndofs))
    x2 = jnp.asarray(rng.standard_normal(umesh.ndofs))
    c1 = jnp.asarray(rng.uniform(0.5, 2.0, umesh.num_cells))
    c2 = jnp.asarray(rng.uniform(-1.0, 1.0, umesh.num_cells))
    _, G = pre.cell_geometry_factors(umesh)
    G = jnp.asarray(np.moveaxis(G, 2, 0))      # component-major layout
    D = jnp.asarray(umesh.element.deriv_1d)
    dm = jnp.asarray(umesh.dofmap)
    want = (ops.stiffness_apply_indexed(x1, G, c1, dm, D, umesh.ndofs)
            + ops.stiffness_apply_indexed(x2, G, c2, dm, D, umesh.ndofs))
    got = ops.stiffness_apply_indexed_pair(x1, c1, x2, c2, G, dm, D,
                                           umesh.ndofs)
    err = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    assert err < 1e-13, err
