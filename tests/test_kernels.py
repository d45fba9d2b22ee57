"""Green's-function kernel unit tests, mirroring the reference's
reflected_kernel_test_G/W and wall_kernel_test_G/W identities."""

import numpy as np
import jax.numpy as jnp
import pytest

from bemstokes_tpu.kernels import (
    stokeslet_G,
    stresslet_W,
    hypersingular_L,
    contract_normal,
    free_surface_G,
    free_surface_W,
    no_slip_wall_G,
    no_slip_wall_W,
    image_point,
)


def rand_points(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3)


def test_stokeslet_symmetry_and_scaling():
    p = jnp.asarray(rand_points(10))
    G = stokeslet_G(p)
    assert np.allclose(G, np.swapaxes(G, -1, -2))  # G symmetric
    # scaling: G(2p) = G(p)/2 in 3D
    G2 = stokeslet_G(2.0 * p)
    assert np.allclose(G2, G / 2.0, atol=1e-14)


def test_stokeslet_2d_log_form():
    p = jnp.asarray(rand_points(5)[:, :2])
    G = stokeslet_G(p)
    R = np.linalg.norm(p, axis=-1)
    expected_diag = (p[:, 0] ** 2 / R**2 - np.log(R)) / (4 * np.pi)
    assert np.allclose(G[:, 0, 0], expected_diag, atol=1e-14)


def test_stresslet_scaling_and_symmetry():
    p = jnp.asarray(rand_points(10))
    W = stresslet_W(p)
    assert np.allclose(W, np.swapaxes(W, -1, -2))
    assert np.allclose(W, np.swapaxes(W, -3, -2))
    W2 = stresslet_W(2.0 * p)
    assert np.allclose(W2, W / 4.0, atol=1e-13)  # ~ R^-2 in 3D


def test_stresslet_against_loop():
    p_np = rand_points(4, seed=3)
    W = np.asarray(stresslet_W(jnp.asarray(p_np)))
    for b in range(4):
        R = np.linalg.norm(p_np[b])
        for i in range(3):
            for j in range(3):
                for k in range(3):
                    ref = (
                        -3.0
                        * p_np[b, i]
                        * p_np[b, j]
                        * p_np[b, k]
                        / R**5
                        / (4 * np.pi)
                    )
                    assert abs(W[b, i, j, k] - ref) < 1e-13


def test_free_surface_wall_column_vanishes():
    """Assembly convention (reference `source/bem_stokes.cc:2917-2922`): the
    image mirrors the *collocation* point x, p = y - x, p_img = y - Mx.  For
    field points y ON the wall, the wall-normal *column* of the image
    Stokeslet vanishes (and the wall-normal row vanishes identically when the
    collocation point itself sits on the wall, which is the degenerate
    identity `tests/reflected_kernel_test_G.cc` checks)."""
    wall_axis, wall_pos = 1, 0.0
    x = np.array([0.3, 0.7, -0.2])  # collocation point above the wall
    pts = rand_points(20, seed=1)
    pts[:, wall_axis] = wall_pos  # field points on the wall plane
    p = jnp.asarray(pts - x)
    x_img = np.asarray(image_point(jnp.asarray(x), wall_axis, wall_pos))
    p_img = jnp.asarray(pts - x_img)
    G = np.asarray(free_surface_G(p, p_img, wall_axis))
    assert np.max(np.abs(G[:, :, wall_axis])) < 1e-13


def test_free_surface_row_identity_at_wall_collocation():
    """Reference `tests/reflected_kernel_test_G.cc`: when the collocation
    point sits on the wall, its image coincides with it and the wall-normal
    row of G cancels exactly."""
    wall_axis, wall_pos = 0, 1.0
    x = np.array([wall_pos, 3.0, 0.0])  # on the wall
    pts = rand_points(10, seed=2)
    p = jnp.asarray(pts - x)
    x_img = np.asarray(image_point(jnp.asarray(x), wall_axis, wall_pos))
    assert np.allclose(x_img, x)
    p_img = jnp.asarray(pts - x_img)
    G = np.asarray(free_surface_G(p, p_img, wall_axis))
    W = np.asarray(free_surface_W(p, p_img, wall_axis))
    assert np.max(np.abs(G[:, wall_axis, :])) < 1e-13
    assert np.max(np.abs(W[:, wall_axis, :, :])) < 1e-13


def test_free_surface_reduces_to_sum_of_sources():
    """Away from the wall the image kernel equals Stokeslet(p) plus the
    sign-flipped Stokeslet(p_image) (reference
    `reflected_kernel_test_G_comparison.cc`)."""
    wall_axis, wall_pos = 1, 0.0
    src = np.array([0.0, 2.0, 0.0])
    pts = rand_points(10, seed=4) + np.array([0.0, 5.0, 0.0])
    p = jnp.asarray(pts - src)
    src_img = np.asarray(image_point(jnp.asarray(src), wall_axis, wall_pos))
    p_img = jnp.asarray(pts - src_img)
    G = np.asarray(free_surface_G(p, p_img, wall_axis))
    G0 = np.asarray(stokeslet_G(p))
    GI = np.asarray(stokeslet_G(p_img))
    s = np.ones(3)
    s[wall_axis] = -1.0
    assert np.allclose(G, G0 + s[:, None] * GI, atol=1e-14)


def test_no_slip_wall_zero_velocity_on_wall():
    """Blake image system: for field points ON the wall the full image
    Stokeslet vanishes entrywise — the no-slip condition (reference
    `tests/wall_kernel_test_G.cc` checks the same identity in the degenerate
    collocation-on-wall configuration)."""
    wall_axis, wall_pos = 1, 0.0
    x = np.array([0.2, 0.9, -0.1])  # collocation point above the wall
    pts = rand_points(30, seed=5)
    pts[:, wall_axis] = wall_pos
    p = jnp.asarray(pts - x)
    x_img = np.asarray(image_point(jnp.asarray(x), wall_axis, wall_pos))
    p_img = jnp.asarray(pts - x_img)
    G = np.asarray(no_slip_wall_G(p, p_img, wall_axis))
    assert np.max(np.abs(G)) < 1e-12, np.max(np.abs(G))


def test_no_slip_wall_all_axes():
    for wall_axis in range(3):
        wall_pos = 0.5
        x = np.zeros(3)
        x[wall_axis] = 2.0
        pts = rand_points(10, seed=8)
        pts[:, wall_axis] = wall_pos
        p = jnp.asarray(pts - x)
        x_img = np.asarray(image_point(jnp.asarray(x), wall_axis, wall_pos))
        p_img = jnp.asarray(pts - x_img)
        G = np.asarray(no_slip_wall_G(p, p_img, wall_axis))
        assert np.max(np.abs(G)) < 1e-12


def test_no_slip_wall_W_finite_and_reduces_far_field():
    wall_axis, wall_pos = 1, 0.0
    src = np.array([0.0, 1.0, 0.0])
    pts = rand_points(5, seed=6) + np.array([0, 40.0, 0])
    p = jnp.asarray(pts - src)
    src_img = np.asarray(image_point(jnp.asarray(src), wall_axis, wall_pos))
    p_img = jnp.asarray(pts - src_img)
    W = np.asarray(no_slip_wall_W(p, p_img, wall_axis))
    W0 = np.asarray(stresslet_W(p))
    # far from the wall relative to h0, the image corrections decay faster
    assert np.max(np.abs(W - W0)) < np.max(np.abs(W0))


def test_contract_normal():
    p = jnp.asarray(rand_points(6))
    n = jnp.asarray(rand_points(6, seed=7))
    W = stresslet_W(p)
    sk = contract_normal(W, n)
    ref = np.einsum("bijk,bk->bij", np.asarray(W), np.asarray(n))
    assert np.allclose(sk, ref, atol=1e-14)


def test_hypersingular_shape():
    p = jnp.asarray(rand_points(4))
    L = hypersingular_L(p)
    assert L.shape == (4, 3, 3, 3, 3)
    assert np.all(np.isfinite(np.asarray(L)))


def test_fused_G_Wn_matches_explicit():
    from bemstokes_tpu.kernels.stokeslet import stokeslet_G_Wn

    p = jnp.asarray(rand_points(12, seed=11))
    n = jnp.asarray(rand_points(12, seed=12))
    G, Wn = stokeslet_G_Wn(p, n)
    G_ref = stokeslet_G(p)
    Wn_ref = contract_normal(stresslet_W(p), n)
    assert np.allclose(G, G_ref, atol=1e-14)
    assert np.allclose(Wn, Wn_ref, atol=1e-14)


def test_fused_free_surface_matches_explicit():
    from bemstokes_tpu.kernels.images import free_surface_G_Wn

    w = 1
    p = jnp.asarray(rand_points(8, seed=13))
    pI = jnp.asarray(rand_points(8, seed=14))
    n = jnp.asarray(rand_points(8, seed=15))
    G, Wn = free_surface_G_Wn(p, pI, n, w)
    assert np.allclose(G, free_surface_G(p, pI, w), atol=1e-14)
    Wn_ref = contract_normal(free_surface_W(p, pI, w), n)
    assert np.allclose(Wn, Wn_ref, atol=1e-14)


def test_fused_no_slip_Wn_matches_explicit():
    from bemstokes_tpu.kernels.images import no_slip_wall_Wn

    for w in range(3):
        p = jnp.asarray(rand_points(8, seed=16))
        pI = jnp.asarray(rand_points(8, seed=17))
        n = jnp.asarray(rand_points(8, seed=18))
        Wn = no_slip_wall_Wn(p, pI, n, w)
        Wn_ref = contract_normal(no_slip_wall_W(p, pI, w), n)
        assert np.allclose(Wn, Wn_ref, atol=1e-12), np.abs(Wn - Wn_ref).max()


@pytest.mark.parametrize("w", [0, 1, 2])
def test_fused_no_slip_matches_explicit(w):
    """Both halves of the fused Blake pair body against the explicit
    kernels, on pairs built from a collocation point, its mirror image
    across the wall and panel points."""
    from bemstokes_tpu.kernels.images import no_slip_G_Wn

    rng = np.random.RandomState(19 + w)
    x = rng.randn(8, 3)
    x[:, w] = np.abs(x[:, w]) + 0.5  # collocation points above the wall
    y = rng.randn(8, 3)
    y[:, w] = np.abs(y[:, w]) + 0.2
    p = jnp.asarray(y - x)
    pI = jnp.asarray(y - np.asarray(image_point(jnp.asarray(x), w, 0.0)))
    n = jnp.asarray(rng.randn(8, 3))
    G, Wn = no_slip_G_Wn(p, pI, n, w)
    G_ref = no_slip_wall_G(p, pI, w)
    Wn_ref = contract_normal(no_slip_wall_W(p, pI, w), n)
    assert np.allclose(G, G_ref, rtol=1e-12, atol=1e-14), np.abs(G - G_ref).max()
    assert np.allclose(Wn, Wn_ref, rtol=1e-12, atol=1e-14), np.abs(Wn - Wn_ref).max()
