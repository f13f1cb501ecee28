"""Radial secondary-structure layout (VARNA-style radiate drawing).

Computes 2-D coordinates for each nucleotide of a dot-bracket structure:
loops are circles sized by their content, helices are straight ladders
— the classic "radiate" layout.

The port's own copy of rafft_tpu/viz/layout.py; only its imports differ.
"""

from __future__ import annotations

import math

import numpy as np

from rafft_tpu_torch.struct import pair_table


def layout(structure: str, helix_rise: float = 1.0, base_spacing: float = 1.0):
    """Returns coords [n, 2] for the dot-bracket string."""
    n = len(structure)
    pt = pair_table(structure)
    coords = np.zeros((n, 2))

    def loop_members(i, j):
        """direct members of the loop closed by (i,j): positions and
        child pairs, walking i+1..j-1."""
        out = []
        k = i + 1
        while k < j:
            if pt[k] > k:
                out.append((k, pt[k]))
                k = pt[k] + 1
            else:
                out.append((k, -1))
                k += 1
        return out

    def place_loop(i, j, cx, cy, ang_in):
        """place the loop closed by (i, j) (or exterior if i<0) around a
        circle centred ahead of the incoming helix direction."""
        members = loop_members(i, j) if i >= 0 else None
        if members is None:
            # exterior: straight line
            x = 0.0
            k = 0
            while k < n:
                if pt[k] > k:
                    coords[k] = (x, 0.0)
                    coords[pt[k]] = (x + base_spacing, 0.0)
                    place_helix(k, pt[k], x + base_spacing / 2, 0.0,
                                math.pi / 2)
                    x += 2 * base_spacing
                    k = pt[k] + 1
                else:
                    coords[k] = (x, 0.0)
                    x += base_spacing
                    k += 1
            return

        # circle: seats = unpaired members + 1 per child pair + closing
        seats = 1 + sum(1 for _m, p in members if p < 0) \
            + 2 * sum(1 for _m, p in members if p >= 0)
        radius = max(base_spacing * seats / (2 * math.pi), base_spacing)
        ccx = cx + radius * math.cos(ang_in)
        ccy = cy + radius * math.sin(ang_in)
        # closing pair sits at angle ang_in + pi
        ang = ang_in + math.pi
        dtheta = 2 * math.pi / seats
        ang += dtheta
        for m, p in members:
            if p < 0:
                coords[m] = (ccx + radius * math.cos(ang),
                             ccy + radius * math.sin(ang))
                ang += dtheta
            else:
                a1 = ang
                a2 = ang + dtheta
                coords[m] = (ccx + radius * math.cos(a1),
                             ccy + radius * math.sin(a1))
                coords[p] = (ccx + radius * math.cos(a2),
                             ccy + radius * math.sin(a2))
                mid_ang = (a1 + a2) / 2
                place_helix(m, p,
                            ccx + radius * math.cos(mid_ang),
                            ccy + radius * math.sin(mid_ang),
                            mid_ang)
                ang += 2 * dtheta

    def place_helix(i, j, cx, cy, ang):
        """extend the helix starting at pair (i, j) outward along ang."""
        k1, k2 = i, j
        x, y = cx, cy
        half = base_spacing / 2
        while True:
            coords[k1] = (x - half * math.sin(ang), y + half * math.cos(ang))
            coords[k2] = (x + half * math.sin(ang), y - half * math.cos(ang))
            if k1 + 1 < k2 and pt[k1 + 1] == k2 - 1:
                k1 += 1
                k2 -= 1
                x += helix_rise * math.cos(ang)
                y += helix_rise * math.sin(ang)
            else:
                break
        place_loop(k1, k2, x, y, ang)

    place_loop(-1, n, 0.0, 0.0, 0.0)
    return coords


def draw_structure(ax, sequence, structure, color="#336699", lw=1.2,
                   backbone=True, show_bases=False):
    """Draw one structure onto a matplotlib axes (equal aspect)."""
    xy = layout(structure)
    pt = pair_table(structure)
    n = len(structure)
    if backbone:
        ax.plot(xy[:, 0], xy[:, 1], color="#999999", lw=lw * 0.6, zorder=1)
    for i in range(n):
        if pt[i] > i:
            ax.plot([xy[i, 0], xy[pt[i], 0]], [xy[i, 1], xy[pt[i], 1]],
                    color=color, lw=lw, zorder=2)
    if show_bases:
        for i, c in enumerate(sequence):
            ax.text(xy[i, 0], xy[i, 1], c, fontsize=4, ha="center",
                    va="center", zorder=3)
    ax.set_aspect("equal")
    ax.axis("off")
    return xy


def structure_svg(sequence, structure, width=300, height=300):
    """Standalone SVG string of the structure drawing."""
    xy = layout(structure)
    pt = pair_table(structure)
    n = len(structure)
    mn = xy.min(axis=0) - 1
    mx = xy.max(axis=0) + 1
    span = np.maximum(mx - mn, 1e-6)
    s = max(span)

    def tx(p):
        q = (p - mn) / s
        return q[0] * width, (1 - q[1]) * height

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">']
    pts = " ".join(f"{tx(xy[i])[0]:.1f},{tx(xy[i])[1]:.1f}" for i in range(n))
    parts.append(f'<polyline points="{pts}" fill="none" stroke="#999" '
                 f'stroke-width="0.7"/>')
    for i in range(n):
        if pt[i] > i:
            x1, y1 = tx(xy[i])
            x2, y2 = tx(xy[pt[i]])
            parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
                         f'y2="{y2:.1f}" stroke="#369" stroke-width="1.2"/>')
    parts.append("</svg>")
    return "".join(parts)
