"""The port's problem, hierarchy and transfer layers against the JAX
package: host assembly must be bit-equal in f64 (both run the same NumPy
arithmetic), and the transfers agree to rtol 1e-14 (the same slices and
averages, summed in the same order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.assembly import dirichlet_rhs as j_dirichlet_rhs
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.fem.assembly import laplacian_const as j_laplacian_const
from gridapsolvers_tpu.fem.assembly import mass as j_mass
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_hierarchy
from gridapsolvers_tpu.multilevel import setup_transfer_operators as j_transfers
from gridapsolvers_tpu.multilevel.transfer import StructuredRestriction as JRestriction

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import (
    CartesianMesh,
    dirichlet_rhs,
    eliminate_dirichlet,
    laplacian,
    laplacian_const,
    mass,
    poisson_problem,
)
from gridapsolvers_tpu_torch.multilevel import (
    StructuredRestriction,
    cartesian_hierarchy,
    setup_transfer_operators,
)

torch.set_num_threads(1)

TRANSFER_RTOL = 1e-14


def _eq(t, a):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(a))


@pytest.mark.parametrize("ncells", [(8, 8, 8), (12, 10), (6, 5, 7)])
def test_poisson_problem_bit_equal(ncells):
    jp = j_poisson_problem(ncells)
    p = poisson_problem(ncells, device="cpu")
    assert p.mesh == CartesianMesh(tuple(ncells), jp.mesh.domain)
    for ours, theirs in ((p.A, jp.A), (p.A_full, jp.A_full), (p.M, jp.M)):
        assert ours.offsets == theirs.offsets
        assert ours.grid_shape == theirs.grid_shape
        assert ours.bands.dtype == torch.float64
        _eq(ours.bands, theirs.bands)
    _eq(p.b, jp.b)
    _eq(p.u_exact, jp.u_exact)
    np.testing.assert_array_equal(p.dirichlet_mask, jp.dirichlet_mask)


def test_poisson_problem_trig_bit_equal():
    jp = j_poisson_problem((8, 6), exact="trig")
    p = poisson_problem((8, 6), exact="trig", device="cpu")
    _eq(p.b, jp.b)
    _eq(p.u_exact, jp.u_exact)


def test_problem_errors_match_jax():
    jp = j_poisson_problem((6, 6, 6))
    p = poisson_problem((6, 6, 6), device="cpu")
    u = np.random.default_rng(0).normal(size=p.n)
    np.testing.assert_allclose(
        float(p.l2_error(torch.from_numpy(u))), float(jp.l2_error(jnp.asarray(u))),
        rtol=1e-13,
    )
    np.testing.assert_allclose(
        float(p.residual_norm(torch.from_numpy(u))),
        float(jp.residual_norm(jnp.asarray(u))),
        rtol=1e-13,
    )


@pytest.mark.parametrize("ncells", [(8, 8, 8), (12, 12)])
def test_laplacian_const_bit_equal(ncells):
    jm = JMesh(ncells, tuple(x for _ in ncells for x in (0.0, 1.0)))
    Aj = j_laplacian_const(jm)
    A = laplacian_const(CartesianMesh(jm.ncells, jm.domain), device="cpu")
    assert A.offsets == Aj.offsets and A.grid_shape == Aj.grid_shape
    _eq(A.weights, Aj.weights)
    _eq(A.free, Aj.free)


def test_laplacian_const_f32_dtype():
    A = laplacian_const(CartesianMesh((4, 4, 4), (0, 1) * 3), torch.float32, "cpu")
    assert A.weights.dtype == A.free.dtype == torch.float32


@pytest.mark.parametrize("periodic", [(True, False), (False, True, True)])
def test_periodic_assembly_and_elimination_bit_equal(periodic):
    ncells = (6, 5, 4)[: len(periodic)]
    domain = tuple(x for _ in ncells for x in (0.0, 1.0))
    jm = JMesh(ncells, domain, periodic)
    m = CartesianMesh(ncells, domain, periodic)
    for ours, theirs in ((laplacian(m, device="cpu"), j_laplacian(jm)), (mass(m, device="cpu"), j_mass(jm))):
        assert ours.periodic == theirs.periodic
        _eq(ours.bands, theirs.bands)
    mask = jm.boundary_vertex_mask()
    _eq(eliminate_dirichlet(laplacian(m, device="cpu"), mask).bands, j_eliminate(j_laplacian(jm), mask).bands)


def test_dirichlet_rhs_matches_jax():
    jm = JMesh((6, 7), (0.0, 1.0, 0.0, 2.0))
    m = CartesianMesh(jm.ncells, jm.domain)
    rng = np.random.default_rng(1)
    b, g = rng.normal(size=(2, jm.num_vertices))
    mask = jm.boundary_vertex_mask()
    ours = dirichlet_rhs(laplacian(m, device="cpu"), torch.from_numpy(b), mask, torch.from_numpy(g))
    theirs = j_dirichlet_rhs(j_laplacian(jm), jnp.asarray(b), mask, jnp.asarray(g))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-14, atol=1e-14)


def test_todense_matches_jax():
    jm = JMesh((4, 5), (0.0, 1.0, 0.0, 1.0))
    m = CartesianMesh(jm.ncells, jm.domain)
    Ab = eliminate_dirichlet(laplacian(m, device="cpu"), jm.boundary_vertex_mask())
    _eq(Ab.todense(), j_eliminate(j_laplacian(jm), jm.boundary_vertex_mask()).todense())
    _eq(laplacian_const(m, device="cpu").todense(), j_laplacian_const(jm).todense())
    jp = JMesh((4, 3), (0.0, 1.0, 0.0, 1.0), (True, False))
    _eq(laplacian(CartesianMesh(jp.ncells, jp.domain, jp.periodic), device="cpu").todense(),
        j_laplacian(jp).todense())


@pytest.mark.parametrize(
    "ncells, levels, kw",
    [((16, 16, 16), 3, {}), ((12, 8), 2, {"factor": (2, 1)}), ((8, 6), 2, {"periodic": (True, False)})],
)
def test_cartesian_hierarchy_matches_jax(ncells, levels, kw):
    jh = j_hierarchy(ncells, levels, **kw)
    h = cartesian_hierarchy(ncells, levels, **kw)
    assert h.num_levels == jh.num_levels == levels
    for ours, theirs in zip(h.meshes, jh.meshes):
        assert ours.ncells == theirs.ncells
        assert ours.vertex_shape == theirs.vertex_shape
        assert ours.periodic == theirs.periodic
        assert ours.domain == theirs.domain


@pytest.mark.parametrize(
    "ncells, kw",
    [((8, 8, 8), {}), ((12, 12), {}), ((12, 8), {"factor": (2, 1)}),
     ((8, 6), {"periodic": (True, False)})],
)
def test_transfers_match_jax(ncells, kw):
    """Prolongation and residual restriction, the port's own and the JAX
    ones carried across by convert, against the JAX matvecs."""
    jP, jR = j_transfers(j_hierarchy(ncells, 2, **kw))
    P, R = setup_transfer_operators(cartesian_hierarchy(ncells, 2, **kw), device="cpu")
    jP, jR, P, R = jP[0], jR[0], P[0], R[0]
    cP = convert.prolongation(
        jP.fine_shape, jP.coarse_shape, np.asarray(jP.mask_fine), jP.factors, jP.periodic,
        device="cpu",
    )
    cR = convert.restriction(
        jR.fine_shape, jR.coarse_shape, jR.mode, np.asarray(jR.mask_coarse),
        np.asarray(jR.mask_fine), jR.factors, jR.periodic, device="cpu",
    )
    assert P.shape == jP.shape and R.shape == jR.shape
    _eq(P.mask_fine, jP.mask_fine)
    _eq(R.mask_coarse, jR.mask_coarse)
    rng = np.random.default_rng(2)
    xc = rng.normal(size=P.shape[1])
    xf = rng.normal(size=P.shape[0])
    yP = np.asarray(jP.matvec(jnp.asarray(xc)))
    yR = np.asarray(jR.matvec(jnp.asarray(xf)))
    for op in (P, cP):
        np.testing.assert_allclose(op.matvec(torch.from_numpy(xc)).numpy(), yP,
                                   rtol=TRANSFER_RTOL, atol=TRANSFER_RTOL)
    for op in (R, cR):
        np.testing.assert_allclose(op.matvec(torch.from_numpy(xf)).numpy(), yR,
                                   rtol=TRANSFER_RTOL, atol=TRANSFER_RTOL)


def test_restriction_is_prolongation_transpose():
    P, R = setup_transfer_operators(cartesian_hierarchy((6, 4), 2), with_masks=False, device="cpu")
    eye_c = torch.eye(P[0].shape[1], dtype=torch.float64)
    eye_f = torch.eye(P[0].shape[0], dtype=torch.float64)
    Pm = torch.stack([P[0].matvec(e) for e in eye_c], dim=1)
    Rm = torch.stack([R[0].matvec(e) for e in eye_f], dim=1)
    torch.testing.assert_close(Rm, Pm.T, rtol=0, atol=0)


def test_solution_restriction_injection_matches_jax():
    jh = j_hierarchy((8, 8, 8), 2)
    fs, cs = jh[0].vertex_shape, jh[1].vertex_shape
    x = np.random.default_rng(3).normal(size=int(np.prod(fs)))
    y = StructuredRestriction(fs, cs, "solution").matvec(torch.from_numpy(x))
    _eq(y, JRestriction(fs, cs, "solution").matvec(jnp.asarray(x)))
