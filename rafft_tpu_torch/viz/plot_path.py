"""Fast-folding path figure: per-step structure thumbnails connected by
dE-coloured edges (native replacement for utility/plot_path.py, which
shells out to the VARNA jar per structure).

Connectivity rule matches the reference/kinetics subset rule
(plot_path.py:83-91): an edge links step-i structure S to step-(i-1)
structure P iff P's pairs are a subset of S's.

CLI: python -m rafft_tpu_torch.viz.plot_path rafft.out -o path.png
     [-he 500 -wi 900 -rv 1]

The port's own copy of rafft_tpu/viz/plot_path.py; only its imports differ, and
matplotlib load only when a figure is drawn.
"""

from __future__ import annotations

import argparse

import numpy as np

from rafft_tpu_torch.struct import parse_rafft_output
from rafft_tpu_torch.kin.kinetics import ancestors_in
from rafft_tpu_torch.viz.layout import draw_structure


def plot_path(fast_paths, seq, out_file=None, width=9.0, height=5.0,
              reverse=False, font_size=8):
    import matplotlib
    if out_file is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm, colors as mcolors

    steps = fast_paths[::-1] if reverse else fast_paths
    n_steps = len(steps)
    max_k = max(len(s) for s in steps)

    fig, ax = plt.subplots(figsize=(width, height))
    pos = {}
    energies = [st.energy for step in steps for st in step]
    de_norm = mcolors.Normalize(vmin=min(energies), vmax=max(energies))
    cmap = cm.viridis

    for si, step in enumerate(steps):
        for ki, struct in enumerate(step):
            x = si
            y = (max_k - len(step)) / 2 + ki
            pos[(si, ki)] = (x, y)

    # edges between consecutive steps (steps is already direction-
    # adjusted above, so the walk is uniform)
    for si in range(1, n_steps):
        for ki, struct in enumerate(steps[si]):
            for pj in ancestors_in(steps[si - 1], struct):
                x1, y1 = pos[(si - 1, pj)]
                x2, y2 = pos[(si, ki)]
                de = struct.energy - steps[si - 1][pj].energy
                t = np.linspace(0, 1, 20)
                xs = x1 + (x2 - x1) * t
                ys = y1 + (y2 - y1) * (3 * t**2 - 2 * t**3)
                ax.plot(xs, ys, color=cmap(de_norm(struct.energy)),
                        lw=1.0, alpha=0.7, zorder=1)

    # thumbnails
    for si, step in enumerate(steps):
        for ki, struct in enumerate(step):
            x, y = pos[(si, ki)]
            sub = ax.inset_axes([x - 0.35, y - 0.35, 0.7, 0.7],
                                transform=ax.transData)
            draw_structure(sub, seq, struct.str_struct,
                           color=cmap(de_norm(struct.energy)))
            sub.set_title(f"{struct.energy:.1f}", fontsize=font_size, pad=1)

    ax.set_xlim(-0.6, n_steps - 0.4)
    ax.set_ylim(-0.6, max_k - 0.4)
    ax.axis("off")
    if out_file:
        fig.savefig(out_file, dpi=150, bbox_inches="tight")
    else:
        import matplotlib.pyplot as plt
        plt.show()
    return fig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("rafft_out")
    ap.add_argument("--out", "-o", help="output image")
    ap.add_argument("--height", "-he", type=float, default=500)
    ap.add_argument("--width", "-wi", type=float, default=900)
    ap.add_argument("--reverse", "-rv", type=int, default=0)
    args = ap.parse_args(argv)
    fast_paths, seq = parse_rafft_output(args.rafft_out)
    plot_path(fast_paths, seq, out_file=args.out,
              width=args.width / 100.0, height=args.height / 100.0,
              reverse=bool(args.reverse))


if __name__ == "__main__":
    main()
