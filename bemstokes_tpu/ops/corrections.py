"""Operator corrections and projectors — the reference's post-assembly fixes,
as O(N^2) vectorized updates instead of element-wise loops:

- rank-1 null-space correction of V (Steinbach-style removal of the
  hydrostatic-pressure mode; reference `source/bem_stokes.cc:3017-3041`);
- solid-angle correction of the K diagonal blocks so that K . e_c = e_c in
  the exterior convention (reference `:3044-3098`);
- tangential projectors P_t v = v - n (Mn . v)/|n|^2_M (reference
  `:4133-4151`).

All vectors are component-blocked flat [d*n] arrays.
"""

from __future__ import annotations

import jax.numpy as jnp


def tangential_projector(v, normal_flat, M_normal_flat, l2norm_gamma):
    """P_t v = v - n (Mn . v) / (n . Mn).

    With the *body-only* normal this is `tangential_projector_body`; with the
    full normal it is `tangential_projector` of the reference."""
    return v - normal_flat * (jnp.dot(M_normal_flat, v) / l2norm_gamma)


def v_nullspace_correction(V, normal_pure_flat, M_normal_pure_flat, l2norm_pure):
    """V += (n - V n) (M n)^T / (n . M n), rows only (all rows; constrained
    rows are excluded upstream once hanging nodes exist).

    Returns (V_corrected, Vn_residual_before) so callers can report the
    reference's "Check on the V operator Norm (should be zero)" diagnostic."""
    Vn = V @ normal_pure_flat
    update = jnp.outer(normal_pure_flat - Vn, M_normal_pure_flat / l2norm_pure)
    return V + update, Vn


def k_solid_angle_correction(
    K,
    n_nodes,
    dim,
    use_internal_alpha=False,
    component_labels=None,
    component_alpha=None,
):
    """Replace each node's diagonal dim x dim block of K so rows of versors
    map to exactly the identity (exterior convention; with
    use_internal_alpha the identity term is dropped, interior convention).

    C_b = K e_b where e_b is the b-th versor field; then
    K[a*n+i, b*n+i] += -C_b[a*n+i] + delta_ab.
    Returns (K_corrected, check) with check[b] = ||K e_b||_inf afterwards.

    With `component_labels` [n] (per-node connected-component ids) and
    `component_alpha` [n] the row sums are restricted to each node's OWN
    component and the identity target is per-node: the constant-field
    identity c(x) + int_Gamma W.n = 1 behind the reference's full-row
    replacement (`source/bem_stokes.cc:3044-3098`) only holds on CLOSED
    boundaries, so with open walls in the mesh the full-row variant folds
    the wall's partial solid angle into the body diagonal.  Restricting to
    the (closed) own component keeps the identity exact — alpha = 1 for
    closed components, 1/2 for open flat walls (the two-sided screen jump;
    cross-component blocks are regular and stay as assembled).
    """
    n = n_nodes
    d = dim
    if component_labels is None:
        # C[:, b] = K @ e_b = sum of K's b-th column block
        C = jnp.stack(
            [K[:, b * n : (b + 1) * n].sum(axis=1) for b in range(d)], axis=-1
        )  # [d*n, d]
        alpha = 1.0
    else:
        lab = jnp.asarray(component_labels)
        same = lab[jnp.arange(d * n) % n][:, None] == lab[None, :]  # [d*n, n]
        C = jnp.stack(
            [
                (K[:, b * n : (b + 1) * n] * same).sum(axis=1)
                for b in range(d)
            ],
            axis=-1,
        )
        alpha = jnp.asarray(component_alpha, K.dtype)  # [n]
    i = jnp.arange(n)
    rows = (jnp.arange(d)[:, None, None] * n + i[None, None, :])  # [d,1,n]
    cols = (jnp.arange(d)[None, :, None] * n + i[None, None, :])  # [1,d,n]
    rows_b = jnp.broadcast_to(rows, (d, d, n))
    cols_b = jnp.broadcast_to(cols, (d, d, n))
    # vals[a, b, i] = -C[a*n+i, b] + delta_ab * alpha_i (internal convention
    # shifts the target by -1: closed -> 0, open screens -> -1/2)
    Cab = C.reshape(d, n, d)  # [a, i, b]
    vals = -Cab.transpose(0, 2, 1) + jnp.eye(d, dtype=K.dtype)[
        :, :, None
    ] * (alpha - 1.0 if use_internal_alpha else alpha)
    K = K.at[rows_b.ravel(), cols_b.ravel()].add(vals.ravel())
    if component_labels is None:
        check = jnp.stack(
            [
                jnp.max(jnp.abs(K[:, b * n : (b + 1) * n].sum(axis=1)))
                for b in range(d)
            ]
        )
    else:
        check = jnp.stack(
            [
                jnp.max(jnp.abs((K[:, b * n : (b + 1) * n] * same).sum(axis=1)))
                for b in range(d)
            ]
        )
    return K, check
