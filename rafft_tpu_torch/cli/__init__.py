"""Command-line entry points of the port (cli/fold_cli.py)."""
