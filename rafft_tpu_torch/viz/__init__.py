"""Visualisation: secondary-structure drawing, fast-folding path graphs,
energy landscapes.

Native replacements for the reference's utility/ renderers: the VARNA
Java jar (utility/plot_path.py:128-140) is replaced by a built-in
radial-layout structure renderer, and the MDS landscape
(utility/surface.py) is reimplemented on the same sklearn/scipy stack.
"""
