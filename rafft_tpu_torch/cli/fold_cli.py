"""`rafft` on the PyTorch engine: fold a sequence and print structures.

    python -m rafft_tpu_torch.cli.fold_cli --device cuda -s <SEQ> [-ms 5 --traj]

The flags and the output are those of rafft_tpu/cli/fold_cli.py (the
reference CLI's surface, parsed-but-unused flags included), plus the
device to fold on.  --engine torch (the default) folds through the
package's `fold` on --device: the batched engine, with what the engine
flags or refuses answered by the sequential CPU parity engine, so the
default prints what the reference CLI's default (its CPU parity engine)
prints on every input.  --engine cpu folds with the sequential CPU
parity engine and --nono with the tree-keeping engine, neither of which
touches a device.
"""

from __future__ import annotations

import argparse
import sys

from rafft_tpu_torch.engine import fold_cpu, fold_nono, fold_torch


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument('--device', default="cuda",
                        help="torch device to fold on (default cuda; "
                             "cuda:1, cpu)")
    parser.add_argument('--sequence', '-s', help="sequence")
    parser.add_argument('--seq_file', '-sf', help="sequence file")
    parser.add_argument('--n_mode', '-n', type=int, default=100,
                        help="Number of positional lags to search for stems")
    parser.add_argument('--max_stack', '-ms', type=int, default=1,
                        help="number of stored structures (default=1)")
    parser.add_argument('--min_nrj', '-mn', type=float, default=0,
                        help="minimum loop energy to be formed")
    parser.add_argument('--min_bp', '-mb', type=int, default=1,
                        help="minimum bp number to be detectable")
    parser.add_argument('--min_hp', '-mh', type=int, default=3,
                        help="minimum unpaired positions in hairpins")
    parser.add_argument('--pad', '-p', type=float, default=1.0,
                        help="padding, a normalization constant for the autocorrelation")
    parser.add_argument('--max_branch', type=int, default=1000,
                        help="maximum branches to explor")
    parser.add_argument('--bp_only', action="store_true", help="don't use the NRJ")
    parser.add_argument('--bench', action="store_true", help="output for benchmarks")
    parser.add_argument('-tr', '--traj', action="store_true",
                        help="output full trajectories")
    parser.add_argument('--temp', type=float, default=37.0, help="temperature")
    parser.add_argument('-gc', '--gc_wei', type=float, default=3.00, help="GC weight")
    parser.add_argument('-au', '--au_wei', type=float, default=2.00, help="AU weight")
    parser.add_argument('-gu', '--gu_wei', type=float, default=1.00, help="GU weight")
    parser.add_argument('--nono', action="store_true",
                        help="Use the tree-keeping (nono) engine instead.")
    parser.add_argument('--engine', choices=("cpu", "torch"), default="torch",
                        help="fold engine: torch (batched engine on --device, "
                             "what it flags or refuses folded by the parity "
                             "oracle) or cpu (sequential parity oracle)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    if args.sequence is None and args.seq_file is None:
        sys.exit("error, the sequence is missing!")

    if args.sequence is not None:
        sequence = args.sequence
    else:
        with open(args.seq_file) as fh:
            sequence = "".join(
                l.strip() for l in fh if not l.startswith(">")
            ).replace("T", "U")
    len_seq = len(sequence)

    if args.nono or args.engine == "cpu":
        fold = fold_nono.fold if args.nono else fold_cpu.fold
        results = fold(
            sequence, args.n_mode, args.max_stack, args.max_branch,
            args.min_hp, args.min_nrj, args.traj, args.temp,
            args.gc_wei, args.au_wei, args.gu_wei)
        if args.nono:
            results, root = results
    else:
        results = fold_torch.fold(
            sequence, args.n_mode, args.max_stack, args.max_branch,
            args.min_hp, args.min_nrj, args.traj, args.temp,
            args.gc_wei, args.au_wei, args.gu_wei, device=args.device)

    if args.traj:
        final_struct, trajectory = results
    else:
        final_struct = results

    if not args.traj:
        if not args.bench:
            print(f"{sequence}")
        for struct in final_struct:
            str_struct = struct.str_struct
            nrj_pred = struct.energy
            if args.bench:
                print(sequence, len_seq, str_struct, f"{nrj_pred:6.1f}",
                      str_struct.count("("))
            else:
                print(f"{str_struct} {nrj_pred:6.1f}")
        if args.nono:
            print("====================== Full Tree ========================")
            print(root)
    else:
        print(f"{sequence}")
        for si, fold_step in enumerate(trajectory):
            print("# {:-^20}".format(si))
            for struct in fold_step:
                print(f"{struct.str_struct} {struct.energy:6.1f}")


if __name__ == '__main__':
    main()
