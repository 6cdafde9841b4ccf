"""Sim3 pose-graph ("essential graph") optimization, batched GN.

Replaces Optimizer::OptimizeEssentialGraph (/root/reference/src/
Optimizer.cc:2157-2408: g2o Sim3 vertices, edges = loop + spanning tree +
strong covisibility, 20 LM iterations) with a dense batched Gauss-Newton:
per-edge 7-DoF residuals and Jacobians come from vmapped forward-mode
autodiff (no hand-derived Sim3 Jacobians), the Hessian is scattered into a
[7K x 7K] dense system (K <= few hundred keyframes) and solved with Jacobi
preconditioning — small dense algebra, cheap as batched matmuls.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.sim3 import sim3_exp, sim3_log, sim3_mul, sim3_inv
from .optim import solve_preconditioned


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray   # [K,3,3]
    t: jnp.ndarray   # [K,3]
    s: jnp.ndarray   # [K]
    total_chi2: jnp.ndarray


def _edge_residual(dzi, dzj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log( S_meas_ji^-1 * (exp(dzj) S_j) * (exp(dzi) S_i)^-1 )."""
    Rdi, tdi, sdi = sim3_exp(dzi)
    Rdj, tdj, sdj = sim3_exp(dzj)
    RiN, tiN, siN = sim3_mul(Rdi, tdi, sdi, Ri, ti, si)
    RjN, tjN, sjN = sim3_mul(Rdj, tdj, sdj, Rj, tj, sj)
    Rii, tii, sii = sim3_inv(RiN, tiN, siN)
    Rji, tji, sji = sim3_mul(RjN, tjN, sjN, Rii, tii, sii)
    Rmi, tmi, smi = sim3_inv(Rm, tm, sm)
    Re, te, se = sim3_mul(Rmi, tmi, smi, Rji, tji, sji)
    return sim3_log(Re, te, se)


_res_and_jac = jax.vmap(
    lambda Ri, ti, si, Rj, tj, sj, Rm, tm, sm: (
        _edge_residual(jnp.zeros(7), jnp.zeros(7),
                       Ri, ti, si, Rj, tj, sj, Rm, tm, sm),
        jax.jacfwd(_edge_residual, argnums=0)(
            jnp.zeros(7), jnp.zeros(7), Ri, ti, si, Rj, tj, sj, Rm, tm, sm),
        jax.jacfwd(_edge_residual, argnums=1)(
            jnp.zeros(7), jnp.zeros(7), Ri, ti, si, Rj, tj, sj, Rm, tm, sm),
    ))


@functools.partial(jax.jit, static_argnames=("n_nodes", "iters"))
def optimize_pose_graph(R, t, s, edge_i, edge_j, eR, et, es, edge_w,
                        fixed, n_nodes: int, iters: int = 20,
                        damping: float = 1e-6):
    """Optimize Sim3 keyframe poses against relative-Sim3 edge constraints.

    R/t/s: [K] node Sim3 (world->cam). edge_*: [E] endpoint indices,
    measured relative Sim3 (S_ji: cam_i -> cam_j), and weights (0 = padding).
    fixed: [K] bool gauge anchors (the loop-origin KF in the reference).
    """
    K = n_nodes
    free = (~fixed).astype(jnp.float32)

    def one_iter(state, _):
        R, t, s = state
        r, Ji, Jj = _res_and_jac(R[edge_i], t[edge_i], s[edge_i],
                                 R[edge_j], t[edge_j], s[edge_j],
                                 eR, et, es)  # r [E,7], J [E,7,7]
        w = edge_w[:, None]
        H = jnp.zeros((K, 7, K, 7))
        b = jnp.zeros((K, 7))
        JiW = Ji * w[..., None]
        JjW = Jj * w[..., None]
        # scatter block contributions
        Hii = jnp.einsum("eai,eaj->eij", JiW, Ji)
        Hjj = jnp.einsum("eai,eaj->eij", JjW, Jj)
        Hij = jnp.einsum("eai,eaj->eij", JiW, Jj)
        bi = jnp.einsum("eai,ea->ei", JiW, r)
        bj = jnp.einsum("eai,ea->ei", JjW, r)
        E = edge_i.shape[0]
        flat = jnp.zeros((K * K, 7, 7))
        flat = flat.at[edge_i * K + edge_i].add(Hii)
        flat = flat.at[edge_j * K + edge_j].add(Hjj)
        flat = flat.at[edge_i * K + edge_j].add(Hij)
        flat = flat.at[edge_j * K + edge_i].add(Hij.transpose(0, 2, 1))
        H = flat.reshape(K, K, 7, 7).transpose(0, 2, 1, 3)
        b = b.at[edge_i].add(bi).at[edge_j].add(bj)

        fm = free[:, None]
        H = H * fm[:, :, None, None] * fm[None, None, :, :]
        diag = jnp.arange(K)
        H = H.at[diag, :, diag, :].add(
            jnp.eye(7)[None] * (1.0 - free)[:, None, None]
            + damping * jnp.eye(7)[None])
        b = b * fm

        d = -solve_preconditioned(H.reshape(K * 7, K * 7),
                                  b.reshape(K * 7)).reshape(K, 7) * fm
        Rd, td, sd = jax.vmap(sim3_exp)(d)
        Rn, tn, sn = jax.vmap(sim3_mul)(Rd, td, sd, R, t, s)
        chi2 = jnp.sum(r * r * edge_w[:, None])
        return (Rn, tn, sn), chi2

    (R, t, s), chis = jax.lax.scan(one_iter, (R, t, s), None, length=iters)
    return PoseGraphResult(R=R, t=t, s=s, total_chi2=chis[-1])


@functools.partial(jax.jit, static_argnames=("n_nodes", "iters", "cg_iters"))
def optimize_pose_graph_cg(R, t, s, edge_i, edge_j, eR, et, es, edge_w,
                           fixed, n_nodes: int, iters: int = 20,
                           cg_iters: int = 100, damping: float = 1e-5):
    """Matrix-free Sim3 pose-graph GN for LARGE graphs.

    Same problem as optimize_pose_graph, but the normal equations are solved
    by block-Jacobi-preconditioned conjugate gradients where H·x is evaluated
    edge-wise (gather endpoint blocks, apply the per-edge 7x7 blocks,
    scatter-add) — memory O(E·49) instead of the dense O(K²·49), so the
    essential graph scales to thousands of keyframes (lifting the round-1
    MAX_PG_NODES=256 skip; the reference's sparse CHOLMOD solve plays this
    role, src/Optimizer.cc:2157-2408)."""
    K = n_nodes
    free = (~fixed).astype(jnp.float32)
    fm = free[:, None]

    def one_iter(state, _):
        R, t, s = state
        r, Ji, Jj = _res_and_jac(R[edge_i], t[edge_i], s[edge_i],
                                 R[edge_j], t[edge_j], s[edge_j],
                                 eR, et, es)             # [E,7], [E,7,7]
        w = edge_w[:, None]
        JiW = Ji * w[..., None]
        JjW = Jj * w[..., None]
        Hii = jnp.einsum("eai,eaj->eij", JiW, Ji)
        Hjj = jnp.einsum("eai,eaj->eij", JjW, Jj)
        Hij = jnp.einsum("eai,eaj->eij", JiW, Jj)
        b = jnp.zeros((K, 7))
        b = b.at[edge_i].add(jnp.einsum("eai,ea->ei", JiW, r))
        b = b.at[edge_j].add(jnp.einsum("eai,ea->ei", JjW, r))
        b = -b * fm

        def Hx(x):
            x = x * fm
            xi = x[edge_i]
            xj = x[edge_j]
            y = jnp.zeros((K, 7))
            y = y.at[edge_i].add(jnp.einsum("eij,ej->ei", Hii, xi)
                                 + jnp.einsum("eij,ej->ei", Hij, xj))
            y = y.at[edge_j].add(jnp.einsum("eij,ej->ei",
                                            Hij.transpose(0, 2, 1), xi)
                                 + jnp.einsum("eij,ej->ei", Hjj, xj))
            return (y + damping * x) * fm

        # block-Jacobi preconditioner from the diagonal blocks
        Mdiag = jnp.zeros((K, 7, 7))
        Mdiag = Mdiag.at[edge_i].add(Hii).at[edge_j].add(Hjj)
        Mdiag = Mdiag + (damping + 1e-8) * jnp.eye(7)[None]
        Minv = jnp.linalg.inv(Mdiag)

        def prec(x):
            return jnp.einsum("kij,kj->ki", Minv, x) * fm

        # PCG
        x0 = jnp.zeros((K, 7))
        r0 = b - Hx(x0)
        z0 = prec(r0)

        def cg_body(_, st):
            x, rr, z, p = st
            Ap = Hx(p)
            rz = jnp.sum(rr * z)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
            x = x + alpha * p
            r2 = rr - alpha * Ap
            z2 = prec(r2)
            beta = jnp.sum(r2 * z2) / jnp.maximum(rz, 1e-20)
            return (x, r2, z2, z2 + beta * p)

        x, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                       (x0, r0, z0, z0))
        d = x * fm
        Rd, td, sd = jax.vmap(sim3_exp)(d)
        Rn, tn, sn = jax.vmap(sim3_mul)(Rd, td, sd, R, t, s)
        chi2 = jnp.sum(r * r * edge_w[:, None])
        return (Rn, tn, sn), chi2

    (R, t, s), chis = jax.lax.scan(one_iter, (R, t, s), None, length=iters)
    return PoseGraphResult(R=R, t=t, s=s, total_chi2=chis[-1])
