"""Energy-landscape figure: MDS embedding of base-pair distances with an
RBF-interpolated energy surface (native reimplementation of
utility/surface.py — same sklearn.manifold.MDS + scipy Rbf stack, with
the ViennaRNA bp-distance call replaced by a built-in pair-set metric).

Also parses `barriers` and `RNAsubopt` output formats like the
reference (surface.py:43-63).

CLI: python -m rafft_tpu_torch.viz.surface rafft.out -o landscape.png

The port's own copy of rafft_tpu/viz/surface.py; only its imports differ, and
matplotlib, scipy and scikit-learn load only when a figure is drawn.
"""

from __future__ import annotations

import argparse

import numpy as np

from rafft_tpu_torch.struct import parse_rafft_output, paired_positions


def bp_distance(s1: str, s2: str) -> int:
    """Base-pair distance: |pairs1 ^ pairs2| (symmetric difference)."""
    p1 = set(paired_positions(s1))
    p2 = set(paired_positions(s2))
    return len(p1 ^ p2)


def get_distance_matrix(structures):
    n = len(structures)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            d = bp_distance(structures[i], structures[j])
            D[i, j] = D[j, i] = d
    return D


def parse_barriers(path):
    """barriers output: lines '<id> <struct> <energy> ...'."""
    out = []
    with open(path) as fh:
        seq = fh.readline().strip().split()[0]
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                out.append((parts[1], float(parts[2])))
    return out, seq


def parse_subopt(path):
    """RNAsubopt output: first line 'SEQ energy', then 'struct energy'."""
    out = []
    with open(path) as fh:
        seq = fh.readline().strip().split()[0]
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], float(parts[1])))
    return out, seq


def landscape(structures, energies, out_file=None, width=7.0, height=5.0,
              random_state=42, grid=120):
    import matplotlib
    if out_file is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.interpolate import Rbf
    from sklearn import manifold

    D = get_distance_matrix(structures)
    mds = manifold.MDS(n_components=2, dissimilarity="precomputed",
                      random_state=random_state, normalized_stress="auto")
    XY = mds.fit_transform(D)

    e = np.asarray(energies, dtype=float)
    rbf = Rbf(XY[:, 0], XY[:, 1], e, function="multiquadric", smooth=0.5)
    xg = np.linspace(XY[:, 0].min() - 1, XY[:, 0].max() + 1, grid)
    yg = np.linspace(XY[:, 1].min() - 1, XY[:, 1].max() + 1, grid)
    GX, GY = np.meshgrid(xg, yg)
    GZ = rbf(GX, GY)

    fig, ax = plt.subplots(figsize=(width, height))
    cs = ax.contourf(GX, GY, GZ, levels=24, cmap="viridis")
    fig.colorbar(cs, ax=ax, label="kcal/mol")
    ax.scatter(XY[:, 0], XY[:, 1], c=e, cmap="viridis",
               edgecolors="white", s=36, zorder=3)
    for i in range(len(structures)):
        ax.annotate(str(i), XY[i], fontsize=7, zorder=4)
    ax.set_xticks([])
    ax.set_yticks([])
    if out_file:
        fig.savefig(out_file, dpi=150, bbox_inches="tight")
    else:
        plt.show()
    return XY, fig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("--out", "-o")
    ap.add_argument("--format", choices=("rafft", "barriers", "subopt"),
                    default="rafft")
    args = ap.parse_args(argv)
    if args.format == "rafft":
        fast_paths, _seq = parse_rafft_output(args.infile)
        seen = {}
        for step in fast_paths:
            for st in step:
                seen.setdefault(st.str_struct, st.energy)
        structures = list(seen)
        energies = [seen[s] for s in structures]
    elif args.format == "barriers":
        rows, _ = parse_barriers(args.infile)
        structures = [r[0] for r in rows]
        energies = [r[1] for r in rows]
    else:
        rows, _ = parse_subopt(args.infile)
        structures = [r[0] for r in rows]
        energies = [r[1] for r in rows]
    landscape(structures, energies, out_file=args.out)


if __name__ == "__main__":
    main()
