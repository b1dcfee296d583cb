"""The port's host-side API surface against saena_tpu's, on the same numpy
inputs (f64, CPU): Vector, the matrix readers and writers, the Nektar++
session reader, the scipy oracles, the Options loaders, the Matrix and AMG
methods (assemble's argument order, duplicates, file I/O, the setters,
matmat on the host and on a mesh's rings, destroy, p_order stored and
p_levels) and the generators and COO helpers
the port gained. Host arrays must agree exactly: these are the same numpy
and scipy code in both packages. Solves through a Vector rhs agree with
an array rhs bit for bit.
"""
import base64
import zlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import saena_tpu as J
from saena_tpu import oracles as joracles
from saena_tpu.core import coo as jcoo
from saena_tpu.generators import laplacian2D as jlap2, random_symm_matrix as jrsm
from saena_tpu.io import nektar as jnektar
from saena_tpu.io import readers as jreaders

import saena_tpu_torch as T
from saena_tpu_torch import generators, oracles
from saena_tpu_torch.core import coo
from saena_tpu_torch.io import nektar, readers

F64 = dict(dtype=torch.float64, device="cpu")


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("add", [False, True])
def test_vector_matches_saena_tpu(add):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 30, size=50)
    val = rng.standard_normal(50)
    vs = []
    for V in (T.Vector, J.Vector):
        v = V(add_duplicates=not add)
        v.set_dup_flag(add)
        v.set_idx_offset(2)
        v.set(idx[:20], val[:20])
        v.set(idx[20:], val[20:])
        vs.append((v.assemble(size=40), v.return_vec(np.arange(40.0))))
    for a, b in zip(*vs):
        np.testing.assert_array_equal(a, b)


def test_generators_and_coo_match_saena_tpu():
    _same_csr(generators.laplacian2D(9, 7), jlap2(9, 7))
    _same_csr(generators.random_symm_matrix(60, 0.1, seed=3),
              jrsm(60, 0.1, seed=3))
    rng = np.random.default_rng(1)
    r, c = rng.integers(0, 12, 40), rng.integers(0, 12, 40)
    v = rng.standard_normal(40)
    _same_csr(coo.coo_to_csr(r, c, v, shape=(15, 15)),
              jcoo.coo_to_csr(r, c, v, shape=(15, 15)))
    out = []
    for B in (coo.CooBuilder, jcoo.CooBuilder):
        b = B(shape=(20, 20))
        b.set_block(r[:10], c[:10], v[:10], row_offset=3, col_offset=5)
        b.set(r[10:], c[10:], v[10:])
        out.append(b.assemble())
    _same_csr(*out)


@pytest.mark.parametrize("ext", [".bin", ".mtx", ".sbin"])
def test_readers_round_trip_and_match_saena_tpu(tmp_path, ext):
    A = generators.random_symm_matrix(70, 0.08, seed=5)
    path = str(tmp_path / f"m{ext}")
    {".bin": readers.write_bin, ".mtx": readers.write_mtx,
     ".sbin": readers.write_sbin}[ext](path, A)
    B = readers.read_matrix(path)
    _same_csr(B, A)
    _same_csr(B, jreaders.read_matrix(path))
    # and a file saena_tpu wrote reads back the same in the port
    jpath = str(tmp_path / f"j{ext}")
    {".bin": jreaders.write_bin, ".mtx": jreaders.write_mtx,
     ".sbin": jreaders.write_sbin}[ext](jpath, A)
    _same_csr(readers.read_matrix(jpath), A)


def test_banner_less_mtx_and_bad_files(tmp_path):
    p = tmp_path / "plain.mtx"
    p.write_text("3 3 4\n1 1 2.0\n2 2 3.0\n3 3 4.0\n1 3 -1.0\n")
    _same_csr(readers.read_mtx(str(p)), jreaders.read_mtx(str(p)))
    bad = tmp_path / "bad.sbin"
    bad.write_bytes(b"NOTSAENA" + bytes(64))
    with pytest.raises(ValueError):
        readers.read_sbin(str(bad))
    with pytest.raises(ValueError):
        readers.read_matrix(str(tmp_path / "m.xyz"))


def test_matrix_file_io_and_assemble(tmp_path):
    A = generators.laplacian3D(6, 6, 6)
    M = T.Matrix()
    M.set_csr(A)
    M.assemble(False, False, **F64)        # saena_tpu's order: scale, use_dense
    assert M.get_internal_matrix() is not None
    for ext in (".bin", ".mtx"):
        path = str(tmp_path / f"A{ext}")
        M.writeMatrixToFile(path)
        N = T.Matrix()
        N.read_file(path)
        N.assemble(**F64)
        _same_csr(N.csr, A)
        jm = J.Matrix()
        jm.read_file(path)
        _same_csr(N.csr, jm.csr)
    N.update_values(2 * N.csr.data)
    np.testing.assert_allclose(N.matvec(np.ones(A.shape[0])),
                               2 * (A @ np.ones(A.shape[0])))


@pytest.mark.parametrize("add", [False, True])
def test_matrix_add_duplicates_matches_saena_tpu(add):
    r, c, v = [0, 1, 1, 2, 1], [0, 1, 1, 2, 0], [4.0, 2.0, 3.0, 5.0, -1.0]
    out = []
    for Mx, kw in ((T.Matrix, F64), (J.Matrix, {})):
        m = Mx()
        m.add_duplicates(add)
        m.set(r, c, v)
        m.assemble(**kw)
        out.append(m.csr)
    _same_csr(*out)


def test_p_order_is_stored_and_p_levels_take_the_p_path():
    """set_p_order(2) is stored and not read, as in saena_tpu: set_matrix
    runs the h-setup and gives saena_tpu's hierarchy. p_levels take the
    p-path in both: a modal-unit operator (kron of a 2-D Laplacian and a
    3 x 3 SPD block, order 2) coarsens p, then h, to the same levels."""
    from saena_tpu.amg.pcoarsen import modal_block_plevels as jplevels

    from saena_tpu_torch.amg.pcoarsen import modal_block_plevels

    rng = np.random.default_rng(3)
    E = rng.standard_normal((3, 6))
    modal = sp.kron(generators.laplacian2D(10, 10), E @ E.T / 3 + 2 * np.eye(3))
    cases = ((generators.laplacian2D(24, 24), None, None),
             (modal, modal_block_plevels(100, 3), jplevels(100, 3)))
    for A, tp, jp in cases:
        infos = []
        for pkg, kw, pl in ((T, F64, tp), (J, {}, jp)):
            M = pkg.Matrix()
            M.set_csr(A)
            M.assemble(**kw)
            M.set_p_order(2)
            M.set_prodim(2)
            assert (M.p_order, M.prodim) == (2, 2)
            amg = pkg.AMG(**kw).set_matrix(M, pkg.Options(), p_levels=pl)
            infos.append(amg.info)
        ti, ji = infos
        assert ti.sizes == ji.sizes and ti.coarsen_kinds == ji.coarsen_kinds
        assert ti.coarsen_kinds[0] == ("p" if tp else "h")
        for a, b in zip(ti.csr_levels, ji.csr_levels):
            _same_csr(a, b)


def test_setters_match_saena_tpu():
    calls = (("set_multigrid_max_level", (4,)), ("set_scale", (True,)),
             ("set_sample_sz_percent", (0.5,)), ("switch_to_dense", (False,)),
             ("set_dense_threshold", (0.2, 900)),
             ("set_shrink_levels", ([1, 0, 1],)),
             ("set_shrink_values", ([2, 1],)), ("switch_repart", (False,)),
             ("set_repart_thre", (0.3,)), ("set_verbose", (True,)))
    t, j = T.AMG(**F64), J.AMG()
    for name, args in calls:
        getattr(t, name)(*args)
        getattr(j, name)(*args)
    assert t.opts.to_dict() == j.opts.to_dict()
    assert t.verbose and j.verbose
    t.destroy()
    assert t.hierarchy is None and t.info is None


def test_matmat_matches_saena_tpu():
    A0, B0 = (generators.random_symm_matrix(50, 0.1, seed=s) for s in (1, 2))
    t = T.AMG(**F64)
    mats = []
    for X0 in (A0, B0):
        X = T.Matrix()
        X.set_csr(X0)
        X.assemble(**F64)
        mats.append(X)
    C = t.matmat(*mats)
    jm = []
    for X0 in (A0, B0):
        X = J.Matrix()
        X.set_csr(X0)
        X.assemble()
        jm.append(X)
    _same_csr(C.csr, J.AMG().matmat(*jm).csr)
    assert C.get_internal_matrix().device.type == "cpu"
    # on a mesh: the rings, dense and block-sparse, against saena_tpu's on
    # the conftest's 8-device JAX CPU mesh
    from saena_tpu.parallel.sharded import make_mesh
    from saena_tpu_torch.parallel.comm import Mesh

    for mode in ("dense", "sparse"):
        Cm = t.matmat(*mats, mesh=Mesh(8, "cpu"), mode=mode)
        Cj = J.AMG().matmat(*jm, mesh=make_mesh(8), mode=mode).csr
        assert Cm.get_internal_matrix().device.type == "cpu"
        assert Cm.csr.shape == Cj.shape
        assert abs(Cm.csr - Cj).max() <= 1e-12 * max(1.0, abs(Cj).max()), mode


def test_options_loaders_match_saena_tpu(tmp_path):
    o = T.Options(max_iter=7, smoother="jacobi", shrink_values=(2, 1))
    p = str(tmp_path / "opts.json")
    o.save(p)
    assert T.Options.from_file(p) == o
    assert J.Options.from_file(p).to_dict() == o.to_dict()
    assert T.Options.from_dict(o.to_dict()) == o
    assert o.replace(tol=1e-6).tol == 1e-6 and o.tol == 1e-8
    with pytest.raises(ValueError):
        T.Options.from_dict({"bogus": 1})
    x = tmp_path / "opts.xml"
    x.write_text('<SAENA><OPTIONS solver_max_iter="50" solver_tol="1e-8" '
                 'smoother="jacobi" preSmooth="2" postSmooth="2" '
                 'conn_str="0.2" max_level="20" float_level="3" '
                 'switch_to_dense="0" dense_sz_thre="5000" petsc=""/></SAENA>')
    assert T.Options.from_file(str(x)).to_dict() == \
        J.Options.from_file(str(x)).to_dict()
    bad = tmp_path / "bad.xml"
    bad.write_text('<SAENA><OPTIONS not_an_option="1"/></SAENA>')
    with pytest.raises(ValueError):
        T.Options.from_xml(str(bad))


def test_oracles_match_saena_tpu():
    A = generators.random_symm_matrix(80, 0.1, seed=3)
    rhs = A @ np.ones(80)
    np.testing.assert_array_equal(oracles.solve_scipy_direct(A, rhs),
                                  joracles.solve_scipy_direct(A, rhs))
    u, it = oracles.solve_scipy_cg(A + 10 * sp.eye(80), rhs)
    uj, itj = joracles.solve_scipy_cg(A + 10 * sp.eye(80), rhs)
    assert it == itj > 0
    np.testing.assert_array_equal(u, uj)
    B = generators.random_symm_matrix(80, 0.1, seed=4)
    C = (A @ B).tocsr()
    assert oracles.check_matmat(A, B, C) == joracles.check_matmat(A, B, C) < 1e-12
    assert oracles.check_triple_product(B, A, B, (B @ A @ B).tocsr()) < 1e-10
    assert oracles.matrix_diff(A, A) == 0.0


def _b64z(arr) -> str:
    return base64.b64encode(zlib.compress(arr.tobytes())).decode()


def _session(tmp_path):
    """A Nektar++ session of a unit square cut into two triangles, its
    geometry compressed as Nektar writes it (B64Z-LittleEndian)."""
    verts = np.zeros(4, dtype=[("id", "<u8"), ("xyz", "<f8", (3,))])
    verts["id"] = np.arange(4)
    verts["xyz"] = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]
    edges = np.array([[0, 0, 1], [1, 1, 2], [2, 2, 3], [3, 3, 0], [4, 0, 2]],
                     dtype="<u8")
    tris = np.array([[0, 0, 1, 4], [1, 4, 2, 3]], dtype="<u8")
    z = 'COMPRESSED="B64Z-LittleEndian" BITSIZE="64"'
    xml = f"""<?xml version="1.0"?>
<NEKTAR>
  <GEOMETRY DIM="2" SPACE="2">
    <VERTEX {z}>{_b64z(verts)}</VERTEX>
    <EDGE {z}>{_b64z(edges)}</EDGE>
    <ELEMENT>
      <T {z}>{_b64z(tris)}</T>
    </ELEMENT>
    <COMPOSITE>
      <C ID="0"> T[0-1] </C>
      <C ID="1"> E[0-3] </C>
    </COMPOSITE>
  </GEOMETRY>
  <EXPANSIONS>
    <E COMPOSITE="C[0]" NUMMODES="3" TYPE="MODIFIED" FIELDS="u" />
  </EXPANSIONS>
  <CONDITIONS>
    <BOUNDARYREGIONS>
      <B ID="0"> C[1] </B>
    </BOUNDARYREGIONS>
  </CONDITIONS>
</NEKTAR>
"""
    path = tmp_path / "square.xml"
    path.write_text(xml)
    return str(path)


def test_nektar_session_matches_saena_tpu(tmp_path):
    path = _session(tmp_path)
    m, jm = nektar.read_nektar(path), jnektar.read_nektar(path)
    assert (m.dim, m.nummodes, m.basis_type) == (2, 3, "MODIFIED")
    assert (len(m.vert_ids), len(m.edge_ids), len(m.tri_ids)) == (4, 5, 2)
    np.testing.assert_array_equal(m.interior_edges, [4])
    np.testing.assert_array_equal(m.boundary_edges, [0, 1, 2, 3])
    for f in ("vert_ids", "verts", "edge_ids", "edges", "tri_ids", "tris",
              "quad_ids", "quads", "boundary_edges", "interior_edges"):
        np.testing.assert_array_equal(getattr(m, f), getattr(jm, f), err_msg=f)
    assert m.boundary_composites == jm.boundary_composites
    assert {k: (c, list(v)) for k, (c, v) in m.composites.items()} == \
        {k: (c, list(v)) for k, (c, v) in jm.composites.items()}


def test_set_rhs_vector_solves_like_an_array():
    m = 8
    A = T.Matrix()
    A.set_csr(generators.laplacian3D(m, m, m))
    A.assemble(**F64)
    rhs = generators.laplacian3D_set_rhs(m, m, m)
    s = T.AMG(**F64)
    s.set_matrix(A, T.Options(remove_boundary=True))
    v = T.Vector()
    order = np.random.default_rng(4).permutation(m ** 3)
    v.set(order, rhs[order])
    v.assemble()
    u1, r1 = s.set_rhs(v).solve_pCG()
    u2, r2 = s.set_rhs(rhs).solve_pCG()
    assert r1.iters == r2.iters
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(v.return_vec(u1), u1[order])
