"""Polygon-soup → triangle arrays with smooth vertex normals.

Replaces the reference's halfedge pipeline (HalfedgeMesh::build →
Vertex::computeNormal → StaticScene::Mesh flattening,
`halfEdgeMesh.cpp:29`, `halfEdgeMesh.h:487-514`, `object.cpp:16-58`).
The halfedge structure exists in the reference only to (a) compute
area-weighted vertex normals and (b) support mesh-edit operations that are
all unimplemented stubs (`meshEdit.cpp:6-104`), so this build goes
straight from indexed polygons to flat arrays.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def triangulate(polygons: Sequence[Sequence[int]]) -> np.ndarray:
    """Faces → (T,3) int index array.

    The reference emits only the FIRST THREE vertices of each face
    (`object.cpp:36-41` walks h, h->next, h->next->next), which silently
    truncates any quad; every shipped scene is pure triangles, and we keep
    that exact behavior for parity.
    """
    tris = [p[:3] for p in polygons if len(p) >= 3]
    if not tris:
        return np.zeros((0, 3), dtype=np.int64)
    return np.asarray(tris, dtype=np.int64)


def vertex_normals(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals.

    Matches Vertex::computeNormal (`halfEdgeMesh.h:487-514`): at each vertex
    sum cross(pj−pi, pk−pi) over incident faces — which for a triangle equals
    the same 2·area·n̂ regardless of which corner pi is — then normalize.
    """
    from rrt_tpu.utils import native
    nat = native.vertex_normals(vertices, tris)
    if nat is not None:
        return nat
    v0 = vertices[tris[:, 0]]
    v1 = vertices[tris[:, 1]]
    v2 = vertices[tris[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)  # 2·area · n̂, orientation from winding
    normals = np.zeros_like(vertices)
    for c in range(3):
        np.add.at(normals, tris[:, c], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens[lens == 0] = 1.0
    return normals / lens


def reference_vertex_normals(vertices: np.ndarray,
                             polygons: Sequence[Sequence[int]]) -> np.ndarray:
    """Vertex normals with the reference's EXACT semantics, including its
    boundary quirk.

    `Vertex::computeNormal` (halfEdgeMesh.h:492-515) has two branches. For
    interior vertices it sums cross(pj−pi, pk−pi) over the faces around the
    vertex — for triangle meshes that equals the winding-orientation
    area-weighted normal (the vectorized path below). For BOUNDARY vertices
    it starts from `v->halfedge()`, which after `HalfedgeMesh::build` is a
    halfedge of the *virtual boundary face* (build's final advance,
    halfEdgeMesh.cpp:330-332, lands on `twin(twinless)->next()`), and walks
    `h = h->next()->twin()`. The boundary face's `next` chain runs OPPOSITE
    to the interior winding (halfEdgeMesh.cpp:305-313), so the first term
    is the reversed-orientation cross of the boundary wedge, and the
    interior-face terms frequently degenerate (pk returns to pi). For the
    Cornell-box wall quads this yields exactly the NEGATED winding normal —
    e.g. CBspheres floor (0,+1,0) where the authored winding gives
    (0,−1,0). Every box wall in the shipped scenes is an open quad, so this
    quirk decides the shading frame of most visible geometry; it must be
    reproduced, not "fixed".
    """
    # vectorized interior result (exact for interior vertices of triangle
    # meshes; also the fallback for degenerate connectivity)
    tris = triangulate(polygons)
    base = vertex_normals(vertices, tris)

    # directed-edge map; bail out to the base result on non-manifold input
    # (the reference exit(1)s there — no shipped scene does)
    nv = len(vertices)
    src, dst, nxt, twin = [], [], [], []
    edge_map = {}
    v_he = np.full(nv, -1, dtype=np.int64)   # construction: last wins
    for poly in polygons:
        d = len(poly)
        if d < 3:
            return base
        b0 = len(src)
        for i in range(d):
            a, b = int(poly[i]), int(poly[(i + 1) % d])
            if (a, b) in edge_map:
                return base                   # inconsistent orientation
            edge_map[(a, b)] = b0 + i
            src.append(a)
            dst.append(b)
            nxt.append(b0 + (i + 1) % d)
            twin.append(-1)
            v_he[a] = b0 + i
    n_int = len(src)
    for (a, b), h in edge_map.items():
        t = edge_map.get((b, a))
        if t is not None:
            twin[h] = t

    # advance v->halfedge() to a twinless outgoing halfedge when one exists
    # (halfEdgeMesh.cpp:234-246)
    for v in range(nv):
        h0 = v_he[v]
        if h0 < 0:
            continue
        h = h0
        while True:
            if twin[h] < 0:
                v_he[v] = h
                break
            h = nxt[twin[h]]
            if h == h0:
                break

    # boundary loops: walk each one exactly like halfEdgeMesh.cpp:264-313;
    # boundary halfedge `t` = twin of interior `i`, next-wired REVERSED
    is_boundary_he = [False] * n_int
    for h in range(n_int):
        if twin[h] >= 0:
            continue
        loop = []                              # boundary twins, in cyclic order
        i = h
        while True:
            t = len(src)
            loop.append(t)
            src.append(dst[i])
            dst.append(src[i])
            nxt.append(-1)
            twin.append(i)
            is_boundary_he.append(True)
            twin[i] = t
            i = nxt[i]
            while i != h and twin[i] >= 0:
                i = nxt[twin[i]]
            if i == h:
                break
        deg = len(loop)
        for p in range(deg):
            nxt[loop[p]] = loop[(p - 1 + deg) % deg]

    # final advance: v->halfedge() = v->halfedge()->twin()->next()
    # (halfEdgeMesh.cpp:330-332) — boundary verts land on their boundary
    # halfedge
    for v in range(nv):
        if v_he[v] >= 0:
            v_he[v] = nxt[twin[v_he[v]]]

    n_he = len(src)

    def is_boundary_vertex(v):
        h0 = v_he[v]
        h = h0
        for _ in range(n_he + 1):
            if is_boundary_he[h]:
                return True
            h = nxt[twin[h]]
            if h == h0:
                return False
        return False

    out = base.copy()
    pos = np.asarray(vertices, dtype=np.float64)
    for v in range(nv):
        if v_he[v] < 0 or not is_boundary_vertex(v):
            continue
        pi = pos[v]
        n = np.zeros(3)
        h0 = v_he[v]
        h = h0
        ok = True
        for _ in range(n_he + 1):
            pj = pos[src[nxt[h]]]
            pk = pos[src[nxt[nxt[h]]]]
            n += np.cross(pj - pi, pk - pi)
            h = twin[nxt[h]]
            if h == h0:
                break
        else:
            ok = False                        # walk did not close: keep base
        if ok:
            ln = np.linalg.norm(n)
            out[v] = n / ln if ln > 0 else base[v]
    return out


def transform_vertices(transform: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Bake a node's world transform into the vertex positions, exactly as
    DynamicScene::Mesh does at construction (`dynamic_scene/mesh.cpp:25-28`)."""
    ph = np.concatenate([vertices, np.ones((len(vertices), 1))], axis=1)
    out = ph @ transform.T
    return out[:, :3] / out[:, 3:4]
