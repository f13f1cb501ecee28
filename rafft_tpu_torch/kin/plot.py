"""Population-trajectory figure for the kinetics CLI.

Fills the role of the reference's trajectory plot (rafft_kin.py:18-45):
log-time population curves for every structure that ever rises above the
visibility threshold, labeled by structure id.  Drawn with this
project's own styling.

The port's own copy of rafft_tpu/kin/plot.py; only its imports differ, and
matplotlib load only when a figure is drawn.
"""

from __future__ import annotations

import numpy as np


def plot_traj(trajectory, struct_list, times, font_size, width, height,
              show_thres, out_file=None):
    import matplotlib
    if out_file is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pops = np.real(np.asarray(trajectory, dtype=np.float64))
    visible = [k for k in range(len(struct_list))
               if pops[:, k].max() > show_thres]

    with plt.rc_context({"font.family": "serif", "font.size": font_size}):
        fig, ax = plt.subplots(figsize=(width, height))
        fig.subplots_adjust(left=0.10, right=0.97, bottom=0.10, top=0.97)
        for k in visible:
            ax.plot(times, pops[:, k], alpha=0.8, label=k)
        ax.set_xscale("log")
        ax.set_xlim(times[0], times[-1])
        ax.grid(True, color="grey", linestyle="--", linewidth=0.2)
        ax.legend(ncol=2, fontsize=int(font_size * 0.8))
        if out_file is not None:
            fig.savefig(out_file, dpi=300, transparent=True)
            plt.close(fig)
        else:
            plt.show()
