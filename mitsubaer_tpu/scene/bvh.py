"""Flattened BVH for triangle meshes, wavefront-traversed.

Array-program replacement for the reference's SAH kd-tree
(include/mitsuba/render/skdtree.h:69, gkdtree.h): pointer-chased recursive
traversal is the wrong shape for a vector machine, so the tree is flattened
depth-first with SKIP LINKS (miss pointers) and traversed stacklessly by a
batch-synchronous `lax.while_loop` — every lane carries one node cursor;
an interior hit advances to node+1 (the near subtree in memory order), a
miss jumps to the skip link. Leaves hold up to LEAF_MAX triangles packed
contiguously in ONE gather row each ([v0, e1, e2, pad]), so a leaf visit is
LEAF_MAX row-gathers + Moller-Trumbore.

Build: host-side numpy median-split on the centroid's widest axis (the
reference's exact-SAH builder, gkdtree.h min-max binning, buys ~20-30% over
median splits at many times the build cost — median is the right trade for
scene-load time here; swap the split rule to binned SAH later if traversal
depth shows up in profiles).

The brute-force chunked scan (intersect.py) stays the fast path for the
O(10-100)-triangle scenes of the target workloads; the BVH activates above
_BVH_MIN_TRIS (scene/build.py), where O(T)/ray collapses (bunny-class
meshes: 70k tris -> ~40 node steps/ray instead of 70k MT tests).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

LEAF_MAX = 4
INF = np.float32(3.0e38)


class Bvh(NamedTuple):
    nodes: jnp.ndarray    # (N, 8) f32: min3, max3, bitcast skip, bitcast
    #   (leaf ? first_packed_tri + 1 : 0) — 0 marks interior nodes
    counts: jnp.ndarray   # (N,) int32 leaf triangle count (0 = interior)
    tris: jnp.ndarray     # (T, 12) f32 packed [v0, e1, e2, pad3], leaf-order
    tri_id: jnp.ndarray   # (T,) int32 packed index -> original triangle id


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> Bvh:
    """Host-side median-split build over T triangles; returns flat arrays."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    T = v0.shape[0]
    p1 = v0 + e1
    p2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, p1), p2)
    tmax = np.maximum(np.maximum(v0, p1), p2)
    cent = 0.5 * (tmin + tmax)

    order = []           # packed triangle order
    nodes = []           # [min3, max3, skip, leaf_first (0=interior), count]
    # iterative emission (explicit stack): unbounded mesh size, no Python
    # recursion limit
    emit_iter(np.arange(T), tmin, tmax, cent, nodes, order)

    N = len(nodes)
    arr = np.asarray(nodes, np.float64)
    counts = arr[:, 8].astype(np.int32)
    skips = _subtree_spans(counts)
    nodes_f = np.zeros((N, 8), np.float32)
    nodes_f[:, :6] = arr[:, :6].astype(np.float32)
    nodes_f[:, 6] = skips.astype(np.int32).view(np.float32)
    nodes_f[:, 7] = arr[:, 7].astype(np.int32).view(np.float32)

    order = np.asarray(order, np.int32)
    tris = np.zeros((max(T, 1), 12), np.float32)
    tris[:T, 0:3] = v0[order]
    tris[:T, 3:6] = e1[order]
    tris[:T, 6:9] = e2[order]
    return Bvh(
        nodes=jnp.asarray(nodes_f), counts=jnp.asarray(counts),
        tris=jnp.asarray(tris), tri_id=jnp.asarray(order),
    )


def emit_iter(all_idx, tmin, tmax, cent, nodes, order):
    """Iterative depth-first emission (explicit stack)."""
    stack = [all_idx]
    while stack:
        idx = stack.pop()
        nid = len(nodes)
        bmin = tmin[idx].min(axis=0)
        bmax = tmax[idx].max(axis=0)
        nodes.append([*bmin, *bmax, -1, 0, len(idx) if len(idx) <= LEAF_MAX
                      else 0])
        if len(idx) <= LEAF_MAX:
            nodes[nid][7] = len(order) + 1
            order.extend(idx.tolist())
            continue
        axis = int(np.argmax(bmax - bmin))
        mid = np.argsort(cent[idx, axis], kind="stable")
        half = len(idx) // 2
        # push right first so the left child lands at nid+1 (depth-first)
        stack.append(idx[mid[half:]])
        stack.append(idx[mid[:half]])


def _subtree_spans(counts):
    """End-of-subtree index (= skip link) for each node of the depth-first
    layout: interior node i is followed by its left subtree then its right
    subtree; a leaf's span is i+1. Stack replay, O(N)."""
    N = counts.shape[0]
    spans = np.full((N,), N, np.int32)
    st = []  # (node id, children still open)
    for i in range(N):
        if counts[i] > 0:
            spans[i] = i + 1
            j = i + 1
            while st:
                node, remaining = st[-1]
                remaining -= 1
                st[-1] = (node, remaining)
                if remaining == 0:
                    spans[node] = j
                    st.pop()
                else:
                    break
        else:
            st.append((i, 2))
    return spans


def intersect_bvh(bvh: Bvh, o, d, t_min, t_max):
    """Closest hit over the BVH; returns (t, packed_prim, u, v) with t=INF
    on miss. packed_prim indexes bvh.tri_id."""
    n = o.shape[0]
    NN = bvh.nodes.shape[0]
    Tt = bvh.tris.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d >= 0, 1e-20, -1e-20), d)

    def cond(st):
        node = st[0]
        return jnp.any(node < NN)

    def body(st):
        node, t_best, prim, uu, vv = st
        nc = jnp.clip(node, 0, NN - 1)
        row = jnp.take(bvh.nodes, nc, axis=0)               # (n, 8)
        cnt = jnp.take(bvh.counts, nc, axis=0)
        skip = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        first = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32) - 1
        active = node < NN
        # slab test against [t_min, min(t_max, t_best)]
        t0 = (row[:, 0:3] - o) * inv_d
        t1 = (row[:, 3:6] - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        lim = jnp.minimum(t_max, t_best)
        hit_box = active & (tn <= tf) & (tf >= t_min) & (tn <= lim)
        is_leaf = cnt > 0
        # leaf: test up to LEAF_MAX packed triangles
        do_leaf = hit_box & is_leaf
        for i in range(LEAF_MAX):
            pi = jnp.clip(first + i, 0, Tt - 1)
            tri = jnp.take(bvh.tris, pi, axis=0)            # (n, 12)
            tv0, te1, te2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
            pvec = jnp.cross(d, te2)
            det = jnp.sum(pvec * te1, axis=-1)
            ok_det = jnp.abs(det) > 1e-12
            inv_det = jnp.where(ok_det,
                                1.0 / jnp.where(ok_det, det, 1.0), 0.0)
            tvec = o - tv0
            u = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, te1)
            v = jnp.sum(d * qvec, axis=-1) * inv_det
            t = jnp.sum(te2 * qvec, axis=-1) * inv_det
            ok = (do_leaf & (i < cnt) & ok_det & (u >= 0) & (v >= 0)
                  & (u + v <= 1.0) & (t >= t_min) & (t <= t_max)
                  & (t < t_best))
            t_best = jnp.where(ok, t, t_best)
            prim = jnp.where(ok, pi, prim)
            uu = jnp.where(ok, u, uu)
            vv = jnp.where(ok, v, vv)
        # descend on interior box hits, otherwise follow the skip link
        nxt = jnp.where(hit_box & ~is_leaf, node + 1, skip)
        node = jnp.where(active, nxt, node)
        return (node, t_best, prim, uu, vv)

    st = (jnp.zeros((n,), jnp.int32), jnp.full((n,), INF),
          jnp.zeros((n,), jnp.int32), jnp.zeros((n,)), jnp.zeros((n,)))
    node, t, prim, u, v = jax.lax.while_loop(cond, body, st)
    return t, prim, u, v
