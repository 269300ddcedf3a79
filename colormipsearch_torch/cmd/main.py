"""CLI dispatcher: `python -m colormipsearch_torch <command> ...`.

Counterpart of `colormipsearch_tpu/cmd/main.py` (cmd/Main.java:25-97):
one multi-command entry point for every command of the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    from . import (colordepthsearch_cmd, copymips_cmd, createdatainput_cmd,
                   delete_cmd, exportdata_cmd, gradientscores_cmd,
                   importppp_cmd, normalize_cmd, tag_cmd, validate_cmd)
    parser = argparse.ArgumentParser(
        prog="colormipsearch-torch",
        description="color depth MIP search tools (PyTorch/CUDA port)")
    parser.add_argument("-v", "--verbose", action="store_true")
    subparsers = parser.add_subparsers(dest="command")
    for mod in (colordepthsearch_cmd, gradientscores_cmd, normalize_cmd,
                createdatainput_cmd, importppp_cmd, exportdata_cmd,
                tag_cmd, copymips_cmd, validate_cmd, delete_cmd):
        mod.add_parser(subparsers)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    if not args.command:
        parser.print_help()
        return 1
    from .backends import close_stores
    try:
        return args.func(args)
    finally:
        close_stores()


if __name__ == "__main__":
    sys.exit(main())
