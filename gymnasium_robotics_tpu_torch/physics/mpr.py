"""Minkowski Portal Refinement for convex-hull pairs, batch-last and masked
(port of gymnasium_robotics_tpu/physics/mpr.py: ``_support_verts`` :35 and
``penetration`` :59).

The face-SAT hull formulas (collision ``_make_box_hull`` and
``_make_hull_hull``) see only vertex-face features; MPR finds the
penetration direction and depth of any convex pair from support-function
evaluations, each an argmax over a hull's padded vertex table. Every loop is
the reference's fixed-iteration masked unroll (12 discover and 16 refine
iterations), so each lane runs the same operations. Shapes: vectors
(3, k, B), poses R (3, 3, k, B), hull vertex tables (V, 3, k, Bm).

Only the penetrating case is produced (depth >= 0 with ``ok``).
"""

from __future__ import annotations

import torch

from gymnasium_robotics_tpu_torch.physics.collision import (
    _cross, _dot, _matTvec, _matvec,
)

_EPS = 1e-9


def _support_verts(hv, d_l):
    """The vertex of hv (V, 3, k, Bm) furthest along d_l (3, k, B), as the
    first-index argmax selects it -> (3, k, B)."""
    dots = torch.sum(hv * d_l[None], dim=1)                  # (V, k, B)
    i = torch.argmax(dots, dim=0)
    iota = torch.arange(dots.shape[0], device=dots.device).view(-1, 1, 1)
    onehot = (iota == i[None]).to(d_l.dtype)
    return torch.sum(onehot[:, None] * hv, dim=0)


def _where(c, a, b):
    """Select with a (k, B) mask over (3, k, B) vectors."""
    return torch.where(c[None], a, b)


def _norm3(v):
    return torch.sqrt(torch.clamp(_dot(v, v), min=0.0))


def _normz(v):
    return v / torch.clamp(_norm3(v), min=_EPS)[None]


def _unit(like, i, value=1.0):
    """A (3, k, B) vector of zeros with ``value`` in component i."""
    out = torch.zeros_like(like)
    out[i] = value
    return out


def penetration(p1, R1, hv1, p2, R2, hv2, n_discover=12, n_refine=16):
    """MPR penetration of hull1 (p1, R1, hv1) and hull2 (p2, R2, hv2) ->
    (depth (k, B), direction (3, k, B), pos (3, k, B), ok (k, B)): depth
    >= 0 and ``ok`` where the hulls interpenetrate; direction is the unit
    contact normal from hull1 into hull2, pos a point between the two
    witness supports."""

    def sup(d):
        """Support of the CSO (hull1 minus hull2) along d, with witnesses."""
        a = p1 + _matvec(R1, _support_verts(hv1, _matTvec(R1, d)))
        b = p2 + _matvec(R2, _support_verts(hv2, _matTvec(R2, -d)))
        return a - b, a, b

    # v0: an interior CSO point from the hulls' vertex centroids (padding
    # rows repeat a real vertex, so the mean stays inside)
    c1 = p1 + _matvec(R1, torch.mean(hv1, dim=0))
    c2 = p2 + _matvec(R2, torch.mean(hv2, dim=0))
    v0 = c1 - c2
    v0 = _where(_dot(v0, v0) < _EPS, _unit(v0, 0, 1e-4), v0)

    # --- discover the portal
    d1 = _normz(-v0)
    v1, a1, b1 = sup(d1)
    ok = _dot(v1, d1) >= 0.0

    d2 = _cross(v0, v1)
    # origin on the v0-v1 line: the segment answer (penetration |v1|)
    seg = _dot(d2, d2) < 1e-8 * _dot(v0, v0) * torch.clamp(_dot(v1, v1), min=_EPS)
    seg_depth = _norm3(v1)
    seg_dir = _normz(v1)
    seg_pos = 0.5 * (a1 + b1)
    alt = _cross(v1 - v0, _unit(v1, 1))
    alt2 = _cross(v1 - v0, _unit(v1, 2))
    alt = _where(_dot(alt, alt) < _EPS, alt2, alt)
    d2 = _normz(_where(seg, alt, d2))
    v2, a2, b2 = sup(d2)
    ok = ok & (_dot(v2, d2) >= 0.0)

    # apex direction: normal of the (v0, v1, v2) plane, away from v0
    d3 = _cross(v1 - v0, v2 - v0)
    flip = _dot(d3, v0) > 0.0
    v1, v2 = _where(flip, v2, v1), _where(flip, v1, v2)
    a1, a2 = _where(flip, a2, a1), _where(flip, a1, a2)
    b1, b2 = _where(flip, b2, b1), _where(flip, b1, b2)
    d3 = _normz(torch.where(flip[None], -d3, d3))

    v3, a3, b3 = sup(d3)
    ok = ok & (_dot(v3, d3) >= 0.0)
    done = torch.zeros_like(ok)
    for _ in range(n_discover):
        out_a = _dot(_cross(v1, v3), v0) < 0.0     # rotate v2 out
        out_b = _dot(_cross(v3, v2), v0) < 0.0     # rotate v1 out
        settle = ~(out_a | out_b)
        repl2 = out_a & ~done
        repl1 = out_b & ~out_a & ~done
        done = done | settle
        v2, a2, b2 = (_where(repl2, x3, x2) for x3, x2 in ((v3, v2), (a3, a2), (b3, b2)))
        v1, a1, b1 = (_where(repl1, x3, x1) for x3, x1 in ((v3, v1), (a3, a1), (b3, b1)))
        d3 = _normz(_cross(v1 - v0, v2 - v0))
        v3c, a3c, b3c = sup(d3)
        upd = ~done
        v3, a3, b3 = _where(upd, v3c, v3), _where(upd, a3c, a3), _where(upd, b3c, b3)
        ok = ok & torch.where(upd, _dot(v3, d3) >= 0.0, torch.ones_like(ok))
    ok = ok & done

    # --- refine: expand the portal toward the CSO boundary
    conv = torch.zeros_like(ok)
    for _ in range(n_refine):
        n = _normz(_cross(v2 - v1, v3 - v1))
        v4, a4, b4 = sup(n)
        dv4 = _dot(v4, n)
        dmax = torch.maximum(torch.maximum(_dot(v1, n), _dot(v2, n)), _dot(v3, n))
        conv = conv | (dv4 - dmax < 1e-7)
        upd = ~conv
        v4v0 = _cross(v4, v0)
        s1 = _dot(v1, v4v0) > 0.0
        s2 = _dot(v2, v4v0) > 0.0
        s3 = _dot(v3, v4v0) > 0.0
        r1 = upd & ((s1 & s2) | (~s1 & ~s3))       # replace v1
        r2 = upd & (~s1 & s3)                       # replace v2
        r3 = upd & (s1 & ~s2)                       # replace v3
        v1, a1, b1 = _where(r1, v4, v1), _where(r1, a4, a1), _where(r1, b4, b1)
        v2, a2, b2 = _where(r2, v4, v2), _where(r2, a4, a2), _where(r2, b4, b2)
        v3, a3, b3 = _where(r3, v4, v3), _where(r3, a4, a3), _where(r3, b4, b3)

    # --- penetration info: the origin inside the final portal's halfspace
    n = _normz(_cross(v2 - v1, v3 - v1))
    depth = _dot(v1, n)
    ok = ok & (depth >= -1e-9) & torch.isfinite(depth)

    # witness: barycentric coordinates of the origin in (v0, v1, v2, v3)
    b0 = _dot(_cross(v1, v2), v3)
    bb1 = _dot(_cross(v3, v2), v0)
    bb2 = _dot(_cross(v0, v1), v3)
    bb3 = _dot(_cross(v2, v1), v0)
    ssum = b0 + bb1 + bb2 + bb3
    scale = torch.clamp(torch.abs(ssum), min=_EPS)
    sgn_t = torch.sign(ssum)
    tol = 1e-4
    inside = ((sgn_t * b0 >= -tol * scale) & (sgn_t * bb1 >= -tol * scale)
              & (sgn_t * bb2 >= -tol * scale) & (sgn_t * bb3 >= -tol * scale))
    ok = ok & inside
    bad = torch.abs(ssum) <= _EPS
    f1 = _dot(_cross(v2, v3), n)
    f2 = _dot(_cross(v3, v1), n)
    f3 = _dot(_cross(v1, v2), n)
    fsum = f1 + f2 + f3
    zero = torch.zeros_like(b0)
    w0 = torch.where(bad, zero, b0)
    w1 = torch.where(bad, f1, bb1)
    w2 = torch.where(bad, f2, bb2)
    w3 = torch.where(bad, f3, bb3)
    wsum = torch.where(bad, fsum, ssum)
    wsum = torch.where(torch.abs(wsum) < _EPS, zero + 1.0, wsum)
    pa = (w0[None] * c1 + w1[None] * a1 + w2[None] * a2 + w3[None] * a3) / wsum[None]
    pb = (w0[None] * c2 + w1[None] * b1 + w2[None] * b2 + w3[None] * b3) / wsum[None]
    pos = 0.5 * (pa + pb)

    # segment lanes (origin on the v0-v1 line)
    seg_ok = seg & (_dot(v1, d1) >= 0.0)
    depth = torch.where(seg, seg_depth, depth)
    direction = _where(seg, seg_dir, n)
    pos = _where(seg, seg_pos, pos)
    ok = torch.where(seg, seg_ok, ok)
    return torch.clamp(depth, min=0.0), direction, pos, ok
