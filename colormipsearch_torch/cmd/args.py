"""Shared CLI argument infrastructure.

Copy of `colormipsearch_tpu/cmd/args.py` (the reference's JCommander arg
classes: cmd/AbstractColorDepthMatchArgs.java:18-119, cmd/CommonArgs.java,
ListArg cmd/ListArg.java), without the `@file` indirection, which the
colorDepthSearch command does not use.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

from ..imageproc.regions import label_regions_mask, no_regions_mask


@dataclass
class ListArg:
    """'<path>:<offset>:<length>' triplet (cmd/ListArg.java)."""
    input: str
    offset: int = 0
    length: int = -1

    @staticmethod
    def parse(value: str) -> "ListArg":
        parts = value.rsplit(":", 2)
        if len(parts) == 3 and parts[1].lstrip("-").isdigit() \
                and parts[2].lstrip("-").isdigit():
            return ListArg(parts[0], int(parts[1]), int(parts[2]))
        if len(parts) == 2 and parts[1].lstrip("-").isdigit():
            return ListArg(parts[0], int(parts[1]), -1)
        return ListArg(value)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="properties config file")
    p.add_argument("--cacheSize", type=int, default=100000,
                   help="MIP image cache size")
    p.add_argument("-od", "--od", "--outputDir", dest="output_dir",
                   default=None, help="output directory")
    p.add_argument("--array-cache", dest="array_cache", default=None,
                   help="packed .npy array cache dir (decode-once ingest)")


def add_cds_params(p: argparse.ArgumentParser) -> None:
    """Shared CDS scoring params, defaults as in
    AbstractColorDepthMatchArgs.java:18-43."""
    p.add_argument("--dataThreshold", type=int, default=100)
    p.add_argument("--maskThreshold", type=int, default=100)
    p.add_argument("--pixColorFluctuation", type=float, default=2.0)
    p.add_argument("--xyShift", type=int, default=0)
    p.add_argument("--negativeRadius", type=int, default=20)
    p.add_argument("--border", dest="border", type=int, default=0,
                   help="image border size with no useful information; "
                        "the gradient-gap fold skips this frame "
                        "(AbstractColorDepthMatchArgs.java:24-25, "
                        "CalculateGradientScoresCmd.java:478)")
    p.add_argument("--mirrorMask", action="store_true")
    p.add_argument("--pctPositivePixels", type=float, default=0.0)
    p.add_argument("--processingPartitionSize", "-ps", type=int, default=100)
    p.add_argument("--noLabelRegions", action="store_true",
                   help="disable excluded text-label regions")
    p.add_argument("--queryROIMaskName", default=None)
    p.add_argument("--maskBatchSize", type=int, default=4,
                   help="queries scored per device step (TPU batching)")


def check_grid(args) -> None:
    """--process-id must name one of --process-count grid processes (when
    the grid is on: a count > 0 and an id >= 0)."""
    if args.process_count > 0 and args.process_id >= args.process_count:
        raise SystemExit(f"--process-id {args.process_id} is not below "
                         f"--process-count {args.process_count}")


def excluded_regions_for(args, height: int, width: int):
    """Label-region mask (getRegionGeneratorForTextLabels,
    cmd/AbstractColorDepthMatchArgs.java:101-119)."""
    if getattr(args, "noLabelRegions", False):
        return no_regions_mask(height, width)
    return label_regions_mask(height, width)
