"""CLI dispatcher: `python -m colormipsearch_torch <command> ...`.

Counterpart of `colormipsearch_tpu/cmd/main.py`. The production
pipeline runs on this package: colorDepthSearch, gradientScores,
normalizeGradientScores (and its alias mormalizeGradientScores) and
exportData. The reference's other commands are not ported yet; each is
registered under its own name and refuses with a pointer to the JAX
package, which runs it (`python -m colormipsearch_tpu <command>`).
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

# the reference's commands that are not ported yet (ROADMAP.md, queue 1):
# the host commands around the production pipeline
NOT_PORTED = ("createColorDepthSearchDataInput", "importPPPResults", "tag",
              "copyToMipsStore", "validateDBData", "deleteCDMatches")


def _refused(args) -> int:
    raise SystemExit(f"{args.command} is not ported to colormipsearch_torch "
                     f"yet (see ROADMAP.md, queue 1); run it with "
                     f"`python -m colormipsearch_tpu {args.command}`")


def build_parser() -> argparse.ArgumentParser:
    from . import (colordepthsearch_cmd, exportdata_cmd, gradientscores_cmd,
                   normalize_cmd)
    parser = argparse.ArgumentParser(
        prog="colormipsearch-torch",
        description="color depth MIP search tools (PyTorch/CUDA port)")
    parser.add_argument("-v", "--verbose", action="store_true")
    subparsers = parser.add_subparsers(dest="command")
    colordepthsearch_cmd.add_parser(subparsers)
    gradientscores_cmd.add_parser(subparsers)
    normalize_cmd.add_parser(subparsers)
    exportdata_cmd.add_parser(subparsers)
    for name in NOT_PORTED:
        p = subparsers.add_parser(
            name, help="not ported yet: runs on colormipsearch_tpu only")
        p.set_defaults(func=_refused)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.command not in NOT_PORTED:  # those refuse any args
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
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
