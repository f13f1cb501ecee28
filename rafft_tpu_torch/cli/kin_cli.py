"""`rafft_kin` command — kinetic analysis of a rafft output file.

Flag surface mirrors the reference's bin/rafft_kin:15-31.  The
reference's --init_pop crashes on use (None += list); here it works as
documented (<POS>:<WEIGHT> pairs) — a deliberate fix.

The port's own copy of rafft_tpu/cli/kin_cli.py; only its imports differ.
"""

from __future__ import annotations

import argparse


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument('rafft_out', help="rafft_output")
    parser.add_argument('--out', '-o', help="output file")
    parser.add_argument('--width', '-wi', type=int, default=7, help="figure width")
    parser.add_argument('--height', '-he', type=int, default=5, help="figure height")
    parser.add_argument('--n_steps', '-ns', type=int, default=100, help="integration steps")
    parser.add_argument('--show_thres', '-st', type=float, default=0.08,
                        help="threshold population to show")
    parser.add_argument('--font_size', '-fs', type=int, default=15, help="font size")
    parser.add_argument('--init_pop', '-ip', nargs="*",
                        help="initialization of the population <POS>:<WEI>")
    parser.add_argument('--uni', action="store_true", help="uniform distribution")
    parser.add_argument('--other_rate', action="store_true", help="use the other rate")
    parser.add_argument('--max_time', '-mt', type=float, default=30,
                        help="max time (exp scale)")
    parser.add_argument('--method', choices=("eig", "expm"), default="eig",
                        help="propagator: eig (reference parity) or expm "
                             "(numerically stable at large max_time)")
    parser.add_argument('--plot', action="store_true", help="plot kinetics")
    return parser.parse_args(argv)


def main(argv=None):
    from rafft_tpu_torch.struct import parse_rafft_output
    from rafft_tpu_torch.kin.kinetics import kinetics

    args = parse_arguments(argv)
    init_population = None
    if args.init_pop is not None:
        init_population = []
        for el in args.init_pop:
            pos, wei = el.split(":")
            init_population.append((int(pos), float(wei)))

    fast_paths, _seq = parse_rafft_output(args.rafft_out)

    trajectory, times, struct_list, equi_pop = kinetics(
        fast_paths, args.max_time, args.n_steps, init_population,
        method=args.method)
    equi_pop.sort(key=lambda el: el[2])
    for st, nrj, fp, si in equi_pop:
        print("{} {:6.3f} {:5.1f} {:d}".format(st, fp, nrj, si))

    if args.plot:
        from rafft_tpu_torch.kin.plot import plot_traj
        plot_traj(trajectory, struct_list, times, args.font_size,
                  args.width, args.height, args.show_thres, args.out)


if __name__ == '__main__':
    main()
