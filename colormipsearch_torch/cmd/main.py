"""CLI dispatcher: `python -m colormipsearch_torch <command> ...`.

Counterpart of `colormipsearch_tpu/cmd/main.py`. colorDepthSearch runs on
this package; the eight commands of the reference that hold no device
code run from the reference modules unchanged; gradientScores is not
ported yet and refuses.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

# reference commands with no device code (they load no JAX)
_HOST_COMMANDS = ("normalize_cmd", "createdatainput_cmd", "importppp_cmd",
                  "exportdata_cmd", "tag_cmd", "copymips_cmd",
                  "validate_cmd", "delete_cmd")


def _gradient_scores_refused(args) -> int:
    raise SystemExit("gradientScores is not ported to colormipsearch_torch "
                     "yet (see ROADMAP.md, queue 1); run it with "
                     "`python -m colormipsearch_tpu gradientScores`")


def build_parser() -> argparse.ArgumentParser:
    import importlib

    from . import colordepthsearch_cmd
    parser = argparse.ArgumentParser(
        prog="colormipsearch-torch",
        description="color depth MIP search tools (PyTorch/CUDA port)")
    parser.add_argument("-v", "--verbose", action="store_true")
    subparsers = parser.add_subparsers(dest="command")
    colordepthsearch_cmd.add_parser(subparsers)
    g = subparsers.add_parser(
        "gradientScores",
        help="not ported yet: runs on colormipsearch_tpu only")
    g.set_defaults(func=_gradient_scores_refused)
    for name in _HOST_COMMANDS:
        importlib.import_module(
            f"colormipsearch_tpu.cmd.{name}").add_parser(subparsers)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.command != "gradientScores":  # it refuses any args
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    if not args.command:
        parser.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
